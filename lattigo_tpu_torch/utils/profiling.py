"""The port's one recorder of spans and counters, the per-op profiler built
on it, and a ``torch.profiler`` trace of a region.

Counterpart of ``lattigo_tpu/utils/profiling.py``, which has the per-op
profiler and the trace; the recorder has no twin there.

**The recorder.**  The port marks its layer boundaries with spans
(``with span("tjit.replay"): ...``) and counts work with plain integer adds
(``count("ntt.rows.tile", rows)``):

* A span records its name, its start and end on
  ``time.perf_counter_ns()``, its parent span and a request id.  A span
  opened while no other is open starts a request (a ``tjit`` call made
  outside any program, a scheme call made outside any ``tjit`` call), and
  every span inside it carries its id.
* Off (the default), a span costs a check of the two switches below and two
  clock reads: its duration goes into its name's aggregate (count, total,
  the last :data:`RECENT` durations) and nothing else is kept.  Counters
  count in both states.
* Hot points use lighter forms of the same span.  A function's calls:
  :func:`timed` (a decorator: the scheme methods, the kernel wrappers) and
  :func:`run_in_span` (``Ring``'s transforms); off, they make no object.
  :class:`phases`, a span cut into consecutive child spans (``tjit``'s
  call: signature, copy-in, replay, clone): off, one object and one clock
  read a boundary, the durations put into the aggregates when these are
  read or every :data:`FOLD` blocks.
* Tracing is on while ``tracing(True)`` is set, or for as long as a
  ``torch.profiler`` session is active.  It adds the span records (a ring of
  the last :data:`RING_SIZE`), enters each span as
  ``torch.profiler.record_function(name)`` when a session is active (the
  spans land in the Chrome trace as ``user_annotation`` events, on the
  device's clock), and records a CUDA event pair around each span opened
  with ``device=True`` (``tjit``'s copy-in); the pairs are
  resolved when read, never by a synchronise on the call path, into the
  aggregate ``<name>.device``.
* A span's duration goes into its aggregate only when tracing was off at
  its start (:class:`span`, :class:`phases`: and at its end): the
  aggregates hold the program's untraced times.
* Nothing is recorded on the device, nor synchronised, while a
  ``tjit.capture`` runs (:func:`capturing`).
* ``tjit`` programs that replay a captured graph count each replay as the
  counters their capture added (:class:`Replayed`), derived when read,
  and what each call adds itself (the bytes it copied in and skipped).

Readers: :func:`spans`, :func:`aggregates`, :func:`counters` return plain
data; :func:`reset` clears them.

**Per-op profiler.**  :class:`OpProfiler` wraps an evaluator and times
every method call at the Python boundary as a span ``op.<method>``, each
ending in a device synchronize, so a time is execution and not asynchronous
dispatch.  The JAX package's digest readback (``OpProfiler._force``) works
around a lazy TPU runtime and has no twin: ``torch.cuda.synchronize`` waits
for the device.

**Trace.**  :func:`torch_trace` captures a ``torch.profiler`` trace of a
region (device time by kernel, and the port's spans), the twin of
``xla_trace``.

Example::

    ev = OpProfiler(ckks.Evaluator(params))
    out = ckks.evaluate_cheby_eco(ev, ct, cheby, rlk)
    print(ev.report())
    with tracing(True):
        out = program(ct, rlk)
    spans(), aggregates(), counters()
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import types
from collections import defaultdict, deque
from time import perf_counter_ns

import torch

RING_SIZE = 65536  # span records kept while tracing
RECENT = 4096  # durations kept a name, for medians
PENDING = 8192  # CUDA event pairs waiting to be read
FOLD = 256  # untraced phases blocks kept before they go into the aggregates

_profiler_enabled = torch.autograd._profiler_enabled
_ON = False  # tracing(True) is set
_CAPTURING = 0  # depth of tjit.capture blocks
_RECORDS: deque = deque(maxlen=RING_SIZE)
_PENDING: deque = deque()
_COUNTERS: defaultdict = defaultdict(int)
_AGG: dict = {}
_REPLAYED: set = set()
_MARKS: list = []  # untraced phases blocks: [name, t0, phase, t1, ..., None, t_end]
_IDS = itertools.count(1)
_OPEN = threading.local()  # .stack: the open traced spans of this thread


class _Agg:
    __slots__ = ("count", "total_ns", "recent")

    def __init__(self):
        self.count = 0
        self.total_ns = 0
        self.recent = deque(maxlen=RECENT)

    def add(self, ns: int) -> None:
        self.count += 1
        self.total_ns += ns
        self.recent.append(ns)

    def clear(self) -> None:
        self.count = self.total_ns = 0
        self.recent.clear()


def _agg(name: str) -> _Agg:
    a = _AGG.get(name)
    if a is None:
        a = _AGG[name] = _Agg()
    return a


def _stack() -> list:
    s = getattr(_OPEN, "stack", None)
    if s is None:
        s = _OPEN.stack = []
    return s


class tracing:
    """``tracing(True)`` turns tracing on, ``tracing(False)`` off; as a
    context manager it puts back the state it found on exit."""

    def __init__(self, on: bool = True):
        global _ON
        self.prev, _ON = _ON, bool(on)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global _ON
        _ON = self.prev


@contextlib.contextmanager
def capturing():
    """The block of a CUDA graph capture: no span records a CUDA event and
    :class:`OpProfiler` does not synchronise inside it."""
    global _CAPTURING
    _CAPTURING += 1
    try:
        yield
    finally:
        _CAPTURING -= 1


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name``."""
    _COUNTERS[name] += n


class span:
    """``with span(name[, detail], device=False):`` records the block as the
    span ``name`` (see the module doc).  ``detail``, a string, goes into the
    record and the profiler's event (a kernel route, say); ``device=True``
    also times the block on the current CUDA stream while tracing.  After
    the block, ``ns`` holds its duration."""

    __slots__ = ("name", "detail", "device", "t0", "ns", "rec", "rf", "start_event")

    def __init__(self, name: str, detail: str | None = None, device: bool = False):
        self.name, self.detail, self.device = name, detail, device

    def __enter__(self):
        if _ON or _profiler_enabled():
            self._open_traced()
        else:
            self.rec = None
        self.t0 = perf_counter_ns()
        return self

    def _open_traced(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        sid = next(_IDS)
        self.rec = dict(id=sid, name=self.name, detail=self.detail, start_ns=0, end_ns=0,
                        parent=parent["id"] if parent else None,
                        request=parent["request"] if parent else sid)
        stack.append(self.rec)
        self.rf = None
        if _profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(self.name, self.detail)
            self.rf.__enter__()
        self.start_event = None
        if self.device and not _CAPTURING:
            self.start_event = torch.cuda.Event(enable_timing=True)
            self.start_event.record()

    def __exit__(self, *exc):
        t1 = perf_counter_ns()
        self.ns = t1 - self.t0
        rec = self.rec
        if rec is None:
            if not (_ON or _profiler_enabled()):
                _agg(self.name).add(self.ns)
            return False
        if self.start_event is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            _pend(self.name + ".device", self.start_event, end)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec["start_ns"], rec["end_ns"] = self.t0, t1
        stack = _stack()
        if stack and stack[-1] is rec:
            stack.pop()
        _RECORDS.append(rec)
        return False


def run_in_span(name: str, detail: str | None, fn, *args):
    """``fn(*args)`` as the span ``name`` (``detail`` as in :class:`span`).
    Off, it costs a check of the switches and two clock reads, and makes no
    object; a call that starts off is an untraced sample."""
    if _ON or _profiler_enabled():
        with span(name, detail):
            return fn(*args)
    t0 = perf_counter_ns()
    try:
        return fn(*args)
    finally:
        _agg(name).add(perf_counter_ns() - t0)


def timed(name: str):
    """Decorator: every call of the function is the span ``name``, as in
    :func:`run_in_span`, with the aggregate held by the wrapper."""

    def wrap(fn):
        agg = _agg(name)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _ON or _profiler_enabled():
                with span(name):
                    return fn(*args, **kwargs)
            t0 = perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                ns = perf_counter_ns() - t0
                agg.count += 1
                agg.total_ns += ns
                agg.recent.append(ns)

        call._span_of = fn
        return call

    return wrap


class phases:
    """``with phases(name, first) as p:`` records the block as the span
    ``name``, cut into consecutive child spans that tile it: ``first``
    starts with the block, ``p.next(phase[, device])`` ends the running
    child and starts ``phase`` (``device`` as in :class:`span`), the
    block's end ends the last.  Traced, the children are :class:`span` s.
    Off, a block keeps its clock marks, which go into the aggregates of
    ``name`` and of each phase later (:func:`_fold`)."""

    __slots__ = ("name", "first", "marks", "open")

    def __init__(self, name: str, first: str):
        self.name, self.first = name, first

    def __enter__(self):
        if _ON or _profiler_enabled():
            self.marks = None
            self.open = [span(self.name).__enter__(), span(self.first).__enter__()]
        else:
            t = perf_counter_ns()
            self.marks = [self.name, t, self.first, t]
        return self

    def next(self, phase: str, device: bool = False) -> None:
        marks = self.marks
        if marks is not None:
            marks.append(phase)
            marks.append(perf_counter_ns())
            return
        self.open.pop().__exit__(None, None, None)
        self.open.append(span(phase, device=device).__enter__())

    def __exit__(self, *exc):
        marks = self.marks
        if marks is None:
            while self.open:
                self.open.pop().__exit__(*exc)
            return False
        marks.append(None)
        marks.append(perf_counter_ns())
        if not (_ON or _profiler_enabled()):
            _MARKS.append(marks)
            if len(_MARKS) >= FOLD:
                _fold()
        return False


def _fold() -> None:
    """Puts the untraced :class:`phases` blocks' marks into the aggregates."""
    for m in _MARKS:
        n = len(m)
        _agg(m[0]).add(m[n - 1] - m[1])
        for i in range(2, n - 2, 2):  # phase m[i] runs from m[i + 1] to m[i + 3]
            _agg(m[i]).add(m[i + 3] - m[i + 1])
    _MARKS.clear()


def _pend(name: str, start, end) -> None:
    """Keeps an event pair to be read; at :data:`PENDING` pairs the oldest
    is read if its end has passed (it was recorded thousands of calls ago)
    and dropped otherwise."""
    if len(_PENDING) >= PENDING:
        old = _PENDING.popleft()
        if old[2].query():
            _agg(old[0]).add(round(old[1].elapsed_time(old[2]) * 1e6))
        else:
            count("profiling.device_pairs_dropped")
    _PENDING.append((name, start, end))


def _resolve() -> None:
    """Reads every pending event pair (waits for the last ones)."""
    while _PENDING:
        name, start, end = _PENDING.popleft()
        end.synchronize()
        _agg(name).add(round(start.elapsed_time(end) * 1e6))


class Replayed:
    """What a captured program adds to the counters: each replay, the
    counters its capture added (``captured``), counted ``replays`` times when
    read; and the adds its calls make themselves (``added``, which varies
    from call to call).  A program holds one; when the program is freed its
    counts stay (:meth:`retire`)."""

    __slots__ = ("captured", "replays", "added")

    def __init__(self, captured: dict):
        self.captured = {k: v for k, v in captured.items() if v}
        self.replays = 0
        self.added = defaultdict(int)
        _REPLAYED.add(self)

    def counts(self) -> dict:
        """Counter -> what the program's calls counted so far."""
        out = defaultdict(int, self.added)
        for k, v in self.captured.items():
            out[k] += v * self.replays
        return out

    def retire(self) -> None:
        """Folds the calls counted so far into the counters."""
        if self in _REPLAYED:
            for k, v in self.counts().items():
                _COUNTERS[k] += v
            _REPLAYED.discard(self)


@contextlib.contextmanager
def counted():
    """Yields a dict that, after the block, holds the counters the block
    added; the block's adds are then taken out of the counters (a capture
    runs no work: its replays count it)."""
    before = dict(_COUNTERS)
    delta: dict = {}
    try:
        yield delta
    finally:
        for k, v in list(_COUNTERS.items()):
            d = v - before.get(k, 0)
            if d:
                delta[k] = d
                _COUNTERS[k] = v - d


def counters(replayed: bool = False) -> dict[str, int]:
    """The counters: plain adds and the live programs' calls (captured x
    replays, and their own adds).  ``replayed=True``: only what the
    programs' calls count (``tjit.replays``, ``tjit.copy_in_bytes``,
    ``tjit.copy_in_skipped_bytes``, and a graph's captured launches and NTT
    rows)."""
    out: dict = defaultdict(int)
    if not replayed:
        out.update(_COUNTERS)
    for r in list(_REPLAYED):
        for k, v in r.counts().items():
            out[k] += v
    return {k: v for k, v in out.items() if v}


def aggregates() -> dict[str, dict]:
    """Name -> ``count``, ``total_s`` and ``recent_s`` (the last
    :data:`RECENT` durations): host spans taken with tracing off, and the
    device times ``<name>.device`` of the traced ``device=True`` spans."""
    _fold()
    _resolve()
    return {name: dict(count=a.count, total_s=a.total_ns / 1e9,
                       recent_s=[ns / 1e9 for ns in a.recent])
            for name, a in _AGG.items() if a.count}


def spans() -> list[dict]:
    """The traced span records kept, oldest first: ``id``, ``name``,
    ``detail``, ``start_ns``, ``end_ns``, ``parent`` (an id or None),
    ``request`` (the id of the request's top span)."""
    return [dict(r) for r in _RECORDS]


def reset() -> None:
    """Clears span records, aggregates, pending event pairs and counters;
    the live programs' calls count from 0."""
    _RECORDS.clear()
    _PENDING.clear()
    _MARKS.clear()
    for a in _AGG.values():  # cleared in place: timed wrappers hold theirs
        a.clear()
    _COUNTERS.clear()
    for r in list(_REPLAYED):
        r.replays = 0
        r.added.clear()


def spanned(prefix: str):
    """Class decorator: every public method the class has (its own and
    inherited ones) runs in a span ``<prefix>.<class>.<method>``; methods
    that another decorator made (a context manager, say) are left as they
    are."""

    def wrap(cls):
        seen = set()
        for klass in cls.__mro__[:-1]:
            for attr, fn in vars(klass).items():
                if attr.startswith("_") or attr in seen or not isinstance(fn, types.FunctionType):
                    continue
                seen.add(attr)
                if hasattr(fn, "__wrapped__") and not hasattr(fn, "_span_of"):
                    continue
                setattr(cls, attr, timed(f"{prefix}.{cls.__name__}.{attr}")(
                    getattr(fn, "_span_of", fn)))
        return cls

    return wrap


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

    A call made through the wrapper is the span ``op.<method>``, which ends
    after a ``torch.cuda.synchronize`` of the device its result lies on
    (none for a CPU result, nor inside a ``tjit`` capture); ``times`` and
    ``calls`` add up the spans' durations by method.  Calls the evaluator
    makes to itself are inside the time of the call that made them."""

    def __init__(self, evaluator):
        self._ev = evaluator
        self.times = defaultdict(float)
        self.calls = defaultdict(int)

    def __getattr__(self, name):
        target = getattr(self._ev, name)
        if not callable(target):
            return target

        def wrapped(*args, **kwargs):
            with span("op." + name) as s:
                out = target(*args, **kwargs)
                t = _first_tensor(out)
                if t is not None and t.is_cuda and not _CAPTURING:
                    torch.cuda.synchronize(t.device)
            self.times[name] += s.ns / 1e9
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
    operators, the port's spans, and device kernels where a GPU is present)
    into ``logdir``, in the TensorBoard format; yields the profiler, whose
    ``key_averages()`` give the times by operator and kernel."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
