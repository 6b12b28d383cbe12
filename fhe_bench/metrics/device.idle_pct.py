"""The share of the profiled slice in which no operation ran on the device."""


def read(r):
    s = r.slice
    if s is None or not s.device:
        return None
    return 100 * (1 - s.busy_s / s.window_s)
