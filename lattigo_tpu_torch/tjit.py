"""Compiled programs: the counterpart of ``lattigo_tpu/tjit.py``.

``tjit(fn)`` keeps one program per argument signature, as the JAX
package's ``tjit`` keeps one XLA program per trace.  On CUDA a program is a
captured CUDA graph:

* The signature is the argument pytree's structure, each tensor leaf's
  shape, dtype and device, and every other leaf (ints, floats such as a
  CKKS ``scale``, complex constants, ``None``, strings), which is static.
* A new signature runs ``fn`` once eagerly on a side stream (the warm-up:
  it builds the ring's tables, the evaluator's constant planes and the
  kernels), then captures ``fn`` into a ``torch.cuda.CUDAGraph`` on
  static input buffers.  The warm-up's outputs, copied, are the first
  call's result.
* Every later call of that signature copies each tensor leaf into its
  static buffer, replays the graph and returns clones of the static
  outputs: callers get fresh tensors, as from a JAX program, even where
  ``fn`` returns its input or a view of it, and several results of one
  signature can be alive at once.
* A call skips the copy of a leaf that its static buffer already holds:
  the buffer keeps a weak reference to the tensor it last copied (at the
  build, the build call's argument) and that tensor's ``_version``, and a
  leaf that is the same object at the same version is not copied again (a
  server's keys, database and masks, passed unchanged on every call).  Any
  other leaf is copied: a new tensor, even of equal contents or at the
  address of a freed one, or one written in place since (PyTorch's in-place
  ops, views' included, bump the version).  A buffer that ``fn`` itself
  writes in place (its version moved during the warm-up and the capture)
  is copied on every call.  The port's six CUDA kernel wrappers (each
  launching through ``_build.launch``) write only into tensors they
  allocate, and ``tests/test_torch_kernel_outputs.py`` holds them to it.
  The one limit: a write that bypasses the version counter goes unseen,
  such as a DLPack or CuPy consumer's, or a ``ctypes`` wrapper's into a
  caller's tensor;
  such a writer must call ``torch.autograd.graph.increment_version`` on
  what it writes.  The CPU program copies every leaf.
* A graph reads every table at the address it had during the capture.
  While an entry is built, each table that ``Ring._cached`` or
  ``Ring.kernel_cache`` hands out is recorded (:func:`note_table`, the
  twin of the JAX package's record step in ``table``), and the entry keeps
  a reference to it for as long as the graph lives: a table the ring's LRU
  cache evicts stays allocated, so its memory is not reused under the
  graph.
* A function may draw from ``torch.Generator`` objects (noise).  Each
  generator a draw reports while an entry is built (:func:`note_generator`,
  called by the samplers) is registered with the graph before the capture
  (``CUDAGraph.register_generator_state``), so that every replay draws
  from where the generator stands, and advances it, as an eager call does:
  no two replays draw the same noise.  A torch without that method raises.
* A capture that fails raises; nothing falls back to the eager function.
* Python's cyclic garbage collector is paused during a capture
  (:func:`capture`): an unreachable program left in a reference cycle (an
  object holding a ``tjit`` of its own method) would otherwise be
  collected in the middle of another capture, and destroying its graph
  there invalidates that capture.
* Spans (``utils/profiling.py``): a call made outside any program is the
  span ``tjit.call``, cut into the phases ``tjit.signature`` (flatten,
  signature, cache lookup), ``tjit.copy_in`` (the static-buffer copies),
  ``tjit.replay`` (the host time of ``graph.replay()``) and ``tjit.clone``
  (the output clones), or ``tjit.signature`` and ``tjit.build`` for a new
  signature (``profiling.phases``).  While tracing, the copy-in is also
  timed on the device.
* Counters: a capture's counter adds (NTT rows) are taken out of the
  counters and kept by the program, with the capture's kernel launches by
  kernel (``_build.launch_counts()``, as ``launches.<name>``) and one
  ``tjit.replays``; each replay counts them once more
  (``profiling.Replayed``), and adds the bytes it copied in
  (``tjit.copy_in_bytes``) and those it skipped
  (``tjit.copy_in_skipped_bytes``).

On the CPU (the caller asked for it, as the tests do) the signature cache
is the same, so :meth:`trace_count` counts the same; a call runs ``fn`` on
copies of its tensor leaves and returns copies of the outputs.  A ``tjit``
call made while another one's function runs (building, or on the CPU)
runs inline, as a nested ``tjit`` inlines into the active trace in the JAX
package.  The CPU program's phases are the same spans, with ``tjit.fn`` in
place of the replay, and its copies count in ``tjit.copy_in_bytes``.

Pytrees are lists, tuples, dicts and dataclasses: the port's element and
key classes (BFV and CKKS ``Ciphertext`` / ``Plaintext``, ``SecretKey``,
``PublicKey``, ``SwitchingKey``, ``EvaluationKey``, ``RotationKeys``) are
dataclasses, flattened field by field where the JAX package's classes have
``tree_flatten`` / ``tree_unflatten`` methods.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import weakref

import torch

from lattigo_tpu_torch import _build
from lattigo_tpu_torch.utils import profiling

# id -> table handed out while an entry is built (None: no build open)
_BUILD: dict | None = None
# depth of tjit'd functions running in Python (> 0: nested calls inline)
_ACTIVE = 0
_ALL: weakref.WeakSet = weakref.WeakSet()


def note_table(value):
    """Returns ``value``; while an entry is built, the entry will keep it
    alive.  The table caches call it on every table they hand out."""
    if _BUILD is not None and value is not None:
        _BUILD[id(value)] = value
    return value


def note_generator(gen: torch.Generator) -> None:
    """While an entry is built, the entry registers ``gen`` with its graph
    (replays draw fresh values from it).  The samplers call it on every
    draw."""
    if _BUILD is not None:
        _BUILD[id(gen)] = gen


def _register_generators(graph, held) -> None:
    gens = [g for g in held if isinstance(g, torch.Generator)]
    if gens and not hasattr(graph, "register_generator_state"):
        raise RuntimeError(f"tjit: torch {torch.__version__} cannot register a generator with a "
                           "CUDA graph (no CUDAGraph.register_generator_state): its replays "
                           "would repeat the captured draws")
    for g in gens:
        graph.register_generator_state(g)


@contextlib.contextmanager
def capture(graph, pool=None):
    """``torch.cuda.graph(graph, pool=pool)`` with Python's cyclic garbage
    collector paused: a collection during the capture may destroy another,
    unreachable CUDA graph, which CUDA refuses while a stream
    captures, and the capture is then invalidated.  No span records a CUDA
    event inside it (``profiling.capturing``)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with profiling.capturing(), torch.cuda.graph(graph, pool=pool):
            yield
    finally:
        if enabled:
            gc.enable()


class TableCache(dict):
    """A dict of device tables whose reads go through :func:`note_table`."""

    def __getitem__(self, key):
        return note_table(dict.__getitem__(self, key))

    def get(self, key, default=None):
        return note_table(dict.get(self, key, default))


def tree_flatten(tree) -> tuple[list, object]:
    """``(leaves, treedef)``; the treedef is hashable (node types, their
    keys or field names and their children's treedefs; ``None`` for a
    leaf).  No reference cycle holds the leaves after it returns."""
    leaves = []
    treedef = _flatten(tree, leaves)
    return leaves, treedef


def _flatten(x, leaves: list):
    t = type(x)
    if t is list or t is tuple:
        return (t, None, tuple(_flatten(c, leaves) for c in x))
    if t is dict:
        keys = tuple(sorted(x))
        return (t, keys, tuple(_flatten(x[k], leaves) for k in keys))
    if dataclasses.is_dataclass(t):
        names = tuple(f.name for f in dataclasses.fields(t))
        return (t, names, tuple(_flatten(getattr(x, n), leaves) for n in names))
    leaves.append(x)
    return None


def tree_unflatten(treedef, leaves):
    """The tree of ``treedef`` with ``leaves`` in order (no reference cycle
    holds the leaves after it returns)."""
    return _unflatten(treedef, iter(leaves))


def _unflatten(d, it):
    if d is None:
        return next(it)
    t, aux, kids = d
    children = [_unflatten(k, it) for k in kids]
    if t is list:
        return children
    if t is tuple:
        return tuple(children)
    if t is dict:
        return dict(zip(aux, children))
    return t(**dict(zip(aux, children)))


def copy_tree(tree):
    """``tree`` with every tensor leaf cloned."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [l.clone() if isinstance(l, torch.Tensor) else l
                                    for l in leaves])


def _call(fn, args):
    """``fn(*args)`` with nested tjit calls inlined."""
    global _ACTIVE
    _ACTIVE += 1
    try:
        return fn(*args)
    finally:
        _ACTIVE -= 1


def _recording(run):
    """``(run(), the tables and generators handed out during it)``."""
    global _BUILD
    _BUILD = {}
    try:
        out = run()
        return out, list(_BUILD.values())
    finally:
        _BUILD = None


class GraphPool:
    """One CUDA graph memory pool for the programs of several ``tjit``
    functions, made at the first capture.  Safe because their graphs replay
    one at a time on one stream and each replay's outputs are cloned before
    the next: a static output that a later graph's intermediates overwrite
    is never read again."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


def _replayed(prog, captured: dict) -> profiling.Replayed:
    """``prog``'s counts a call: ``captured`` and one replay; they stay in
    the counters after ``prog`` is freed."""
    out = profiling.Replayed({**captured, "tjit.replays": 1})
    weakref.finalize(prog, out.retire)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _version(t: torch.Tensor) -> int | None:
    """``t._version``; None for an inference tensor, which has none."""
    return None if t.is_inference() else t._version


def _source(t: torch.Tensor):
    """``(weak reference to t, its version)``, or None where ``t`` has no
    version to compare."""
    v = _version(t)
    return None if v is None else (weakref.ref(t), v)


class _Eager:
    """The program of a CPU signature: ``fn`` on copies of the arguments."""

    def __init__(self, fn, rebuild, dyn):
        self.fn, self.rebuild = fn, rebuild
        self.result, self.tables = _recording(
            lambda: copy_tree(_call(fn, rebuild([t.clone() for t in dyn]))))
        self.counts = _replayed(self, {"tjit.copy_in_bytes": sum(map(_nbytes, dyn))})

    def __call__(self, dyn, p: profiling.phases):
        self.counts.replays += 1
        p.next("tjit.copy_in")
        args = self.rebuild([t.clone() for t in dyn])
        p.next("tjit.fn")
        out = _call(self.fn, args)
        p.next("tjit.clone")
        return copy_tree(out)


class _Graph:
    """The program of a CUDA signature: a captured graph on static input
    buffers, and the tables it reads.  ``held[i]``: the source of what
    buffer ``i`` holds (:func:`_source`), None where the next call copies;
    ``keep[i]``: False where ``fn`` writes buffer ``i``."""

    def __init__(self, fn, rebuild, dyn, pool: GraphPool | None):
        device = dyn[0].device
        self.static_in = [t.clone() for t in dyn]
        self.nbytes = [_nbytes(t) for t in dyn]
        held = [_source(t) for t in dyn]
        versions = [_version(b) for b in self.static_in]

        def build():
            ambient = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(ambient)
            with torch.cuda.stream(side):
                warm = _call(fn, rebuild(self.static_in))
            ambient.wait_stream(side)
            result = copy_tree(warm)
            del warm
            self.graph = torch.cuda.CUDAGraph()
            _register_generators(self.graph, _BUILD.values())
            launched = _build.launch_counts()
            with profiling.counted() as captured, capture(
                    self.graph, None if pool is None else pool.handle()):
                out = _call(fn, rebuild(self.static_in))
            captured.update((f"launches.{k}", v - launched[k])
                            for k, v in _build.launch_counts().items() if v != launched[k])
            return result, out, captured

        with torch.cuda.device(device):
            (self.result, out, captured), self.tables = _recording(build)
        self.out_leaves, self.out_def = tree_flatten(out)
        self.keep = [v is not None and _version(b) == v for b, v in zip(self.static_in, versions)]
        self.held = [h if k else None for h, k in zip(held, self.keep)]
        self.counts = _replayed(self, captured)

    def __call__(self, dyn, p: profiling.phases):
        p.next("tjit.copy_in", device=True)
        held, keep, nbytes = self.held, self.keep, self.nbytes
        copied = skipped = 0
        for i, t in enumerate(dyn):
            h = held[i]
            if h is not None and h[0]() is t and h[1] == t._version:
                skipped += nbytes[i]
                continue
            self.static_in[i].copy_(t)
            copied += nbytes[i]
            if keep[i]:
                held[i] = _source(t)
        added = self.counts.added
        added["tjit.copy_in_bytes"] += copied
        added["tjit.copy_in_skipped_bytes"] += skipped
        p.next("tjit.replay")
        self.graph.replay()
        self.counts.replays += 1
        p.next("tjit.clone")
        return tree_unflatten(self.out_def, [l.clone() if isinstance(l, torch.Tensor) else l
                                             for l in self.out_leaves])


class _TjitFn:
    """The callable :func:`tjit` returns; one program per signature."""

    def __init__(self, fn, pool: GraphPool | None):
        self._fn = fn
        self._pool = pool
        self._cache: dict = {}
        self.replays = 0  # calls served by a cached program
        functools.update_wrapper(self, fn)
        _ALL.add(self)

    def __call__(self, *args):
        if _ACTIVE:
            return self._fn(*args)
        with profiling.phases("tjit.call", "tjit.signature") as p:
            leaves, treedef = tree_flatten(args)
            dyn_idx = tuple(i for i, l in enumerate(leaves) if isinstance(l, torch.Tensor))
            dyn = [leaves[i] for i in dyn_idx]
            dyn_set = set(dyn_idx)
            statics = tuple((i, l) for i, l in enumerate(leaves) if i not in dyn_set)
            key = (treedef, tuple((tuple(t.shape), t.dtype, t.device) for t in dyn), statics)
            prog = self._cache.get(key)
            if prog is not None:
                self.replays += 1
                return prog(dyn, p)
            p.next("tjit.build")
            return self._build(key, leaves, treedef, dyn_idx, dyn, statics)

    def _build(self, key, leaves, treedef, dyn_idx, dyn, statics):
        """The program of a new signature; returns the first call's result."""
        n = len(leaves)

        def rebuild(tensors):
            full = [None] * n
            for i, l in statics:
                full[i] = l
            for i, t in zip(dyn_idx, tensors):
                full[i] = t
            return tree_unflatten(treedef, full)

        devices = {t.device for t in dyn}
        if any(d.type == "cuda" for d in devices):
            if len(devices) > 1:
                raise ValueError("tjit: tensor arguments on several devices "
                                 f"{sorted(map(str, devices))}")
            prog = _Graph(self._fn, rebuild, dyn, self._pool)
        else:
            prog = _Eager(self._fn, rebuild, dyn)
        self._cache[key] = prog
        result, prog.result = prog.result, None
        return result

    def trace_count(self) -> int:
        return len(self._cache)


def tjit(fn, pool: GraphPool | None = None) -> _TjitFn:
    """``fn`` as one program per argument signature (see the module doc).
    Tensor leaves of the arguments are dynamic, every other leaf static.
    ``pool``: share one CUDA graph memory pool with other functions (by
    default each graph has its own)."""
    return _TjitFn(fn, pool)


def clear_device_cache() -> None:
    """Drops every cached program (graphs, static buffers, the tables they
    kept alive); the next call of a signature builds it again.  The twin of
    the JAX package's ``clear_device_cache``."""
    for f in list(_ALL):
        f._cache.clear()
