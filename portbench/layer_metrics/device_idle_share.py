"""The share of the profiled requests' wall time in which no operation
ran on the device, %."""


def read(run):
    prof = run.get("profile")
    if not prof or not prof["busy_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / run["traced_window_s"])
