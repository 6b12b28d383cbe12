"""The host time of ``graph.replay()`` (the CUDA graph's launch) a request,
in ms: the median of the program's ``tjit.replay`` span over its calls made
with no profiler session active (``utils/profiling.py``'s aggregates).
Nothing where the program has no recorder."""

import statistics

from lattigo_tpu_torch.utils import profiling


def read(r):
    if not hasattr(profiling, "aggregates"):
        return None
    s = profiling.aggregates().get("tjit.replay", {}).get("recent_s")
    return statistics.median(s) * 1e3 if s else None
