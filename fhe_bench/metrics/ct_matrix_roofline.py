"""The plaintext-matrix kernel's share of its roofline: the yardstick of
the layers one request runs (the cell's work file's ``layers``,
``ct_matrix_roofline.py``) over the device time per request of the kernels
in the ``ct_matrix`` kernel-name set.  Nothing where the trace holds no
such kernel (a program without it) or the work file no layer."""

from fhe_bench import ct_matrix_roofline


def read(r):
    s = r.slice
    if s is None or r.work is None or "layers" not in r.work or not s.requests \
            or "ct_matrix" not in r.sets:
        return None
    busy = sum(op.end - op.start for op in s.device if r.in_set(op.name, "ct_matrix")) / 1e6
    if busy <= 0:
        return None
    return 100 * ct_matrix_roofline.work_bound_s(r.work) / (busy / s.requests)
