"""Requests completed over the window's seconds (a pair is one volume)."""


def read(run):
    return run["volumes"] / run["window_s"]
