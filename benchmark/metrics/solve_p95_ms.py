"""The 95th percentile of every call's time in the window, ms (host clock,
from the call to its synchronized return)."""

import statistics


def read(run):
    times = run.call_s
    if not times:
        return None
    if len(times) == 1:
        return times[0] * 1e3
    return statistics.quantiles(times, n=100, method="inclusive")[94] * 1e3
