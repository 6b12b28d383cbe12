"""CUDA kernel records of the profiled slice over the requests in it."""


def read(r):
    s = r.slice
    if s is None or not s.requests:
        return None
    n = sum(op.cat == "kernel" for op in s.device)
    return n / s.requests if n else None
