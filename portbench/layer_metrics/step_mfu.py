"""The model FLOPs of the requests completed in the traced run's window
after the profiler stopped, over those seconds, as a share of the H100's
dense bf16 peak (989 TFLOP/s), %."""
from portbench.roofline import PEAK_BF16_FLOPS_PER_S


def read(run):
    flops, part = run.get("flops_per_volume"), run.get("unprofiled")
    if not flops or not part or not part[0]:
        return None
    volumes, seconds = part
    return 100.0 * flops * volumes / seconds / PEAK_BF16_FLOPS_PER_S
