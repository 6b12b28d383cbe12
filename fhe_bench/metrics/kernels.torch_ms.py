"""Device time per request, in ms, of the operations that no kernel-name
set of the port claims: PyTorch's elementwise kernels, gathers, ``cat``,
``where``, copies and fills."""


def read(r):
    s = r.slice
    if s is None or not s.requests or not s.device:
        return None
    other = [op for op in s.device if not r.in_any_set(op.name)]
    return sum(op.end - op.start for op in other) / 1e3 / s.requests if other else None
