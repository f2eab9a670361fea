"""Each scale's backbone and FPN, summed per request: CUDA events at the
program's mark hook, the mean over the traced run's requests."""


def read(run):
    return (run.get("stage_ms") or {}).get("backbone_fpn")
