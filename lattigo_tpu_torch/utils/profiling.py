"""Per-op profiling: wall time and call counts of evaluator methods, and a
``torch.profiler`` trace of a region.

Counterpart of ``lattigo_tpu/utils/profiling.py``.  The reference relies
on ``go test -bench`` for per-op cost; here (a) :class:`OpProfiler` wraps an
evaluator and times every method call at the Python boundary, each ending
in a device synchronize, so a time is execution and not asynchronous
dispatch, and (b) :func:`torch_trace` captures a ``torch.profiler`` trace of
a region (device time by kernel), the twin of ``xla_trace``.  The JAX
package's digest readback (``OpProfiler._force``) works around a lazy TPU
runtime and has no twin: ``torch.cuda.synchronize`` waits for the device.

Example::

    ev = OpProfiler(ckks.Evaluator(params))
    out = ckks.evaluate_cheby_eco(ev, ct, cheby, rlk)
    print(ev.report())
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def _first_tensor(out):
    """The first tensor in ``out`` (a tensor, a ciphertext or plaintext's
    ``value``, or a tuple / list / dict of them), or None."""
    if isinstance(out, torch.Tensor):
        return out
    if hasattr(out, "value"):
        return _first_tensor(out.value)
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        for e in out:
            t = _first_tensor(e)
            if t is not None:
                return t
    return None


class OpProfiler:
    """Transparent evaluator wrapper timing every method call.

    A call made through the wrapper is timed on the host clock up to a
    ``torch.cuda.synchronize`` of the device its result lies on (none for a
    CPU result); calls the evaluator makes to itself are inside the time of
    the call that made them."""

    def __init__(self, evaluator):
        self._ev = evaluator
        self.times = defaultdict(float)
        self.calls = defaultdict(int)

    def __getattr__(self, name):
        target = getattr(self._ev, name)
        if not callable(target):
            return target

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            out = target(*args, **kwargs)
            t = _first_tensor(out)
            if t is not None and t.is_cuda:
                torch.cuda.synchronize(t.device)
            self.times[name] += time.perf_counter() - t0
            self.calls[name] += 1
            return out

        return wrapped

    def reset(self):
        self.times.clear()
        self.calls.clear()

    def report(self) -> str:
        rows = sorted(self.times.items(), key=lambda kv: -kv[1])
        total = sum(self.times.values()) or 1.0
        out = [f"{'op':<24}{'calls':>7}{'total_ms':>12}{'mean_ms':>10}{'%':>6}"]
        for name, t in rows:
            c = self.calls[name]
            out.append(f"{name:<24}{c:>7}{t * 1e3:>12.2f}{t * 1e3 / c:>10.2f}"
                       f"{100 * t / total:>6.1f}")
        return "\n".join(out)

    def as_dict(self) -> dict:
        return {
            name: {
                "calls": self.calls[name],
                "total_ms": round(t * 1e3, 3),
                "mean_ms": round(t * 1e3 / self.calls[name], 3),
            }
            for name, t in self.times.items()
        }


@contextlib.contextmanager
def torch_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed region (host
    operators, and device kernels where a GPU is present) into ``logdir``,
    in the TensorBoard format; yields the profiler, whose
    ``key_averages()`` give the times by operator and kernel."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
