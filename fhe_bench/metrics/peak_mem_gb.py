"""``torch.cuda.max_memory_allocated()`` over set-up and window, in GB."""


def read(r):
    return r.memory_peak_bytes / 1e9 if r.memory_peak_bytes else None
