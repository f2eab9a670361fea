"""Process start to the window: imports, build, weights, the input pool,
the warm-up (the kernels' first build in a fresh checkout)."""


def read(run):
    return run["setup_s"]
