"""Requests completed in the window over the window's seconds (host clock)."""


def read(r):
    return len(r.latencies) / r.window_s if r.latencies else None
