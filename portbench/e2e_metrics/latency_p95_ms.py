"""The 95th percentile of every request of the window, dispatch to
outputs on the host, in ms."""
import statistics


def read(run):
    lat = run["latency_s"]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3
