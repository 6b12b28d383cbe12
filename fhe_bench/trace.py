"""One ``torch.profiler`` session over a slice of a run's window, and what it
recorded: the device's operations (kernels, copies, fills) inside the slice,
its busy time and idle gaps, and the host activity each gap falls in.

The slice is the span ``fhe_bench.slice`` that the harness records around
its requests; the session starts before it and ends after it with some idle
time on either side, because records near a session's edges were seen to
go missing.  A process opens one session: the profiler was seen to drop
records in the sessions after its first.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

SLICE = "fhe_bench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Op:
    name: str
    cat: str
    start: float  # microseconds, the trace's clock
    end: float


@dataclasses.dataclass
class Slice:
    """What one profiled slice holds."""

    requests: int
    start: float
    end: float
    device: list[Op]  # clipped to the slice, in start order
    host: list[Op]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device's operations, as disjoint intervals."""
        out: list[list[float]] = []
        for op in self.device:
            if out and op.start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], op.end)
            else:
                out.append([op.start, op.end])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def gaps(self) -> list[tuple[float, float]]:
        """The idle intervals of the device inside the slice."""
        out, t = [], self.start
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.end > t:
            out.append((t, self.end))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host activity running at ``t``."""
        live = [op for op in self.host if op.start <= t < op.end]
        return min(live, key=lambda op: op.end - op.start).name if live else "none"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the
        longest idle gaps, by the host activity they fall in; seconds."""
        by_name: dict[str, float] = {}
        for op in self.device:
            by_name[op.name] = by_name.get(op.name, 0.0) + (op.end - op.start) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return dict(device_ops=[[name, s] for name, s in ops],
                    idle_gaps=[[self.host_at((a + b) / 2), (b - a) / 1e6] for a, b in gaps])


def read(events: list[dict], requests: int) -> Slice:
    """The slice of a Chrome trace's ``traceEvents``."""
    ops = [Op(e["name"], e.get("cat", ""), float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
           for e in events if e.get("ph") == "X" and "ts" in e]
    marks = [op for op in ops if op.name == SLICE and op.cat == "user_annotation"]
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} spans {SLICE!r}, not one")
    start, end = marks[0].start, marks[0].end
    device = sorted((Op(op.name, op.cat, max(op.start, start), min(op.end, end))
                     for op in ops if op.cat in DEVICE_CATS and op.end > start and op.start < end),
                    key=lambda op: op.start)
    host = [op for op in ops if op.cat in HOST_CATS and op.end > start and op.start < end]
    return Slice(requests, start, end, device, host)


def export(prof) -> list[dict]:
    """The ``traceEvents`` of a finished profiler session, through a file in
    the temporary directory that is removed again."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)
