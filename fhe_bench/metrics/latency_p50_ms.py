"""The median latency of the window's requests, call to synchronise (host clock)."""

import statistics


def read(r):
    return statistics.median(r.latencies) * 1e3 if r.latencies else None
