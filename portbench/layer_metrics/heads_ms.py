"""The request after its proposals (bbox and refinement or cascade
stages, semantic head, class-wise NMS, masks): CUDA events at the
program's mark hook, the mean over the traced run's requests."""


def read(run):
    return (run.get("stage_ms") or {}).get("heads")
