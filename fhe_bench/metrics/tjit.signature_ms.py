"""The host time of a program call's signature, in ms: the median of the
``tjit.signature`` span (flatten the arguments, make the signature key,
look the program up) over the calls made with no profiler session active.
Nothing where the program has no recorder."""

import statistics

from lattigo_tpu_torch.utils import profiling


def read(r):
    if not hasattr(profiling, "aggregates"):
        return None
    s = profiling.aggregates().get("tjit.signature", {}).get("recent_s")
    return statistics.median(s) * 1e3 if s else None
