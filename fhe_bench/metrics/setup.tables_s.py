"""Seconds the program spent building its rings' constant tables (the
``ring.tables`` span: ring constructors, table-cache misses), all of them
in set-up.  Nothing where the program has no recorder."""

from lattigo_tpu_torch.utils import profiling


def read(r):
    if not hasattr(profiling, "aggregates"):
        return None
    got = profiling.aggregates().get("ring.tables")
    return got["total_s"] if got else None
