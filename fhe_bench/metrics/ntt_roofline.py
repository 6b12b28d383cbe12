"""The NTT's share of its roofline: the butterfly yardstick of the
transforms one request needs (the cell's work file) over the device time
per request of the kernels in the ``ntt`` kernel-name set."""

from fhe_bench import roofline


def read(r):
    s = r.slice
    if s is None or r.work is None or not s.requests:
        return None
    busy = sum(op.end - op.start for op in s.device if r.in_set(op.name, "ntt")) / 1e6
    if busy <= 0:
        return None
    return 100 * roofline.work_bound_s(r.work) / (busy / s.requests)
