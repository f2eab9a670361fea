"""torch.cuda.max_memory_allocated over the window (after
reset_peak_memory_stats), GiB."""


def read(run):
    return run["memory_peak_bytes"] / 2**30 or None
