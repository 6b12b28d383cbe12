"""The 95th percentile of the window's request latencies (host clock;
linear between the nearest ranks)."""

import statistics


def read(r):
    if len(r.latencies) < 2:
        return None
    return statistics.quantiles(r.latencies, n=20, method="inclusive")[18] * 1e3
