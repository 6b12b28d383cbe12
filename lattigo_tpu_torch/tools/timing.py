"""Kernel times on one CUDA device.

``event_ms`` times single calls between two CUDA events, so a call's time
includes the host's time to issue it whenever the device waits for the
host.  ``graph_ms`` captures many calls in one CUDA graph and replays it,
so it gives the device's time alone.
"""

from __future__ import annotations

import statistics

import torch

from lattigo_tpu_torch.tjit import capture


def event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` calls of ``fn``, each between two CUDA events,
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, count: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``count`` calls captured in one
    CUDA graph after a warm-up call, the graph replayed between two CUDA
    events, divided by ``count``; median of ``replays``.  ``fn`` must launch
    on the current stream and allocate only through PyTorch."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with capture(graph):
        for _ in range(count):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / count)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)
