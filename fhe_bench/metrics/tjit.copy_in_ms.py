"""The device time of a program call's copy-in (every tensor argument into
its static buffer), in ms: the median of the CUDA event pairs the program
records around it while tracing, i.e. over the profiled slice's calls
(``tjit.copy_in.device``).  The pair spans the copies' transfer and the
device's waits between them for the host to queue the next: where a call
copies a few large tensors (the CKKS cells) it reads the transfer of the
bytes; where it copies many small ones (the PIR cells) it reads the pace at
which the host queues them, under the profiler.  Nothing where the program
has no recorder."""

import statistics

from lattigo_tpu_torch.utils import profiling


def read(r):
    if not hasattr(profiling, "aggregates"):
        return None
    s = profiling.aggregates().get("tjit.copy_in.device", {}).get("recent_s")
    return statistics.median(s) * 1e3 if s else None
