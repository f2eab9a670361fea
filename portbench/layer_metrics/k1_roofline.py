"""K1's share of its roofline: the bound of each launch's own work,
summed, over the device time of K1's kernels, in the profiled
requests."""


def read(run):
    prof = run.get("profile")
    if not prof or not prof["k1_s"] or not run.get("k1_bound_s"):
        return None
    return 100.0 * run["k1_bound_s"] / prof["k1_s"]
