"""K2's share of its roofline: the bound of each launch's own work,
summed, over the device time of K2's kernels, in the profiled
requests."""


def read(run):
    prof = run.get("profile")
    if not prof or not prof["k2_s"] or not run.get("k2_bound_s"):
        return None
    return 100.0 * run["k2_bound_s"] / prof["k2_s"]
