"""The median of the benchmark's span around the program call, with no
synchronise inside: argument copy-in, graph launch and output clones."""

import statistics


def read(r):
    return statistics.median(r.spans) * 1e3 if r.spans else None
