"""The one seam between the port's seven kernel wrappers (``ops/``) and their
CUDA kernels: it builds ``csrc/*.cu`` into shared libraries with a plain C
interface, loads them with ``ctypes``, decides whether a call launches, and
launches, counts and records.

One ``nvcc`` per source, all started together; the libraries go into
``build/`` beside this file and are rebuilt when a source is newer than its
library.  Nothing is built at import time: the first CUDA tensor that reaches
a kernel wrapper triggers the build.

A wrapper keeps its plain version, its argument checks, its launch plan and
its C arguments.  The rest is here:

* :data:`ENTRIES`: each C entry, its source, its argument types and the name
  its launches count under; :func:`load` types a source's entries once;
* :func:`takes_kernel`, the device rule: CPU tensors take the plain version,
  int64 tensors on one CUDA device launch, anything else raises;
* :func:`launch`: the C entry on the current stream of the tensors' device,
  its error code turned into an exception, the launch counted
  (:func:`launch_counts`) and, for the modular kernels, recorded
  (:func:`record`).

A library put into :data:`LIBRARIES` stands in for a source's build: a host
build of its arithmetic (``tools/host_build``) behind the real wrappers in
the CPU tests, a variant in ``tools/*_variants``.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
from typing import NamedTuple

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "build")


class Entry(NamedTuple):
    """A C entry: ``symbol``, the name ``kernel`` its launches count under
    (and its wrapper's span, ``kernel.<kernel>``), whether it is an NTT
    (counted by direction, out of ``FORCE_PLAIN``'s reach), its argument
    types, the stream last, and its ``source`` (``csrc/<source>.cu``; None:
    the entry's own name).  Every entry returns 0 when it launched, -1 where
    no cluster of the plan fits the device, -2 where it does not take the
    plan, else a CUDA error."""

    symbol: str
    kernel: str
    ntt: bool
    argtypes: tuple
    source: str | None = None


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ENTRIES = {
    # x, out, tw, consts, limbs; rows, L, log N, rows a block, threads, shared
    # memory bytes, inverse
    "ntt_row": Entry("ntt_row_launch", "ntt_tile", True, (_P,) * 5 + (_I,) * 7 + (_P,)),
    # x, mid, out, m_rows, m_lanes, tw, consts, limbs; rows, L, n1, inverse
    "ntt_fourstep": Entry("ntt_fourstep_launch", "ntt_mxu", True, (_P,) * 8 + (_I,) * 4 + (_P,)),
    # x, out, tw, tws, consts, limbs; rows, L, log N, k, threads, shared memory
    # bytes, inverse
    "ntt_passes": Entry("ntt_passes_launch", "ntt_passes", True, (_P,) * 6 + (_I,) * 7 + (_P,)),
    # op, the [SLOTS, 4] operand table, out; B, L, N
    "modred": Entry("modred_launch", "modred", False, (_I, _P, _P) + (_LL,) * 3 + (_P,)),
    # x and its [B, ls, N] strides; tables, sel, out; B, N; ls, ld, k, centered
    "mod_up": Entry("mod_up_launch", "mod_up", False,
                    (_P,) + (_LL,) * 3 + (_P,) * 3 + (_LL,) * 2 + (_I,) * 4 + (_P,)),
    # d, its 4 strides; key0, key1, their 3 strides; q, qinv, u0; ql, idx; out;
    # B, N; L, beta
    "key_switch": Entry("key_switch_launch", "key_switch", False,
                        (_P,) * 11 + (_LL,) * 2 + (_I,) * 2 + (_P,)),
    # the key switch's decomposition, in mod_up.cu: x and its [B, L, N]
    # strides; the digit table, out; B, N; L, K, beta, most table words and
    # most source limbs of a digit
    "decompose": Entry("decompose_launch", "decompose", False,
                       (_P,) + (_LL,) * 3 + (_P,) * 2 + (_LL,) * 2 + (_I,) * 5 + (_P,),
                       source="mod_up"),
    # x0, x1, their 3 strides; the weights' digits, columns, tiles, slabs,
    # bias, constants, out; slabs, k-steps, outputs, N; L, digits, bytes,
    # tiles a slab, tiles a warp, strips a block, slabs a block, plane fold
    "ct_matrix": Entry("ct_matrix_launch", "ct_matrix", False,
                       (_P,) * 10 + (_LL,) * 4 + (_I,) * 8 + (_P,)),
}


def source_of(name: str) -> str:
    """The source (``csrc/<source>.cu``) of entry ``name``."""
    return ENTRIES[name].source or name


SOURCES = tuple(dict.fromkeys(map(source_of, ENTRIES)))

# Route the modular kernels' CUDA tensors (modred, mod_up, decompose,
# key_switch, ct_matrix) to their plain versions: chip_smoke.py's before /
# after trace.
FORCE_PLAIN = False

LIBRARIES: dict[str, ctypes.CDLL] = {}  # by source: what load() loaded, or a stand-in
_CPU = {torch.device("cpu")}
_COUNTS = {e.kernel: [0, 0, 0] for e in ENTRIES.values()}  # launches, inverse ones, copies
_RECORD: list | None = None  # the list that record() fills, while one is open


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _paths(name: str) -> tuple[str, str]:
    return os.path.join(CSRC, name + ".cu"), os.path.join(BUILD, f"lib{name}.so")


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    deps = [src, os.path.join(CSRC, "modarith.cuh")]
    return not os.path.exists(lib) or any(
        os.path.getmtime(d) > os.path.getmtime(lib) for d in deps
    )


def build(names=SOURCES, verbose: bool = False) -> dict[str, str]:
    """Compile every stale source of ``names`` for sm_90a, in parallel.
    Returns nvcc's output for each source it compiled (with ``verbose``,
    ptxas' resource report)."""
    todo = [n for n in names if _stale(n)]
    logs: dict[str, str] = {}
    if not todo:
        return logs
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        src, lib = _paths(name)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-o", tmp, src,
        ]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        logs[name] = out
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def bind(lib: ctypes.CDLL, source: str) -> ctypes.CDLL:
    """``lib`` with every C entry of ``source`` typed as :data:`ENTRIES` says
    (a build of that source, a variant or a host build of it)."""
    for name, entry in ENTRIES.items():
        if source_of(name) == source:
            fn = getattr(lib, entry.symbol)
            fn.argtypes, fn.restype = entry.argtypes, ctypes.c_int
    return lib


def load(name: str) -> ctypes.CDLL:
    """The library of entry ``name``'s source, built first if it is stale,
    its entries typed; or the library that stands in for it in
    :data:`LIBRARIES` (keyed by source)."""
    source = source_of(name)
    lib = LIBRARIES.get(source)
    if lib is None:
        build((source,))
        lib = LIBRARIES[source] = bind(ctypes.CDLL(_paths(source)[1]), source)
    return lib


def takes_kernel(name: str, *tensors: torch.Tensor) -> bool:
    """Whether a call of entry ``name``'s wrapper on ``tensors`` launches
    the kernel: all on the CPU take the plain version, int64 tensors on one
    CUDA device launch (unless ``FORCE_PLAIN`` reaches the kernel), anything
    else raises."""
    devices = {t.device for t in tensors}
    if devices == _CPU:
        return False
    entry = ENTRIES[name]
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{entry.kernel} takes tensors on one device, the cpu or a cuda "
                         f"device, got {sorted(map(str, devices))}")
    if any(t.dtype != torch.int64 for t in tensors):
        raise TypeError(f"{entry.kernel} takes int64 tensors (uint64 bit patterns), got "
                        f"{sorted({str(t.dtype) for t in tensors})}")
    return entry.ntt or not FORCE_PLAIN


def launch(name: str, device: torch.device, args: tuple, what, *, inverse: bool = False,
           copies: int = 0, record: tuple | None = None) -> None:
    """Calls C entry ``name`` with ``args`` and the current stream of
    ``device``, made the current device first where it is not; counts the
    launch (an ``inverse`` transform, ``copies`` operand copies of its plan)
    and, while :func:`record` is open, ``record``: ``(name, tensors,
    constants)``.  An error code raises; -1 and -2 name the plan the entry
    refused, ``what()`` (made only then)."""
    fn = getattr(load(name), ENTRIES[name].symbol)
    if device.type != "cuda":  # a host build stands in (the CPU tests): it takes no stream
        err = fn(*args, None)
    elif device.index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    if err:
        symbol = ENTRIES[name].symbol
        raise RuntimeError(f"{symbol}: no cluster fits {device} for {what()}" if err == -1 else
                           f"{symbol} does not take {what()}" if err == -2 else
                           f"{symbol} failed with CUDA error {err}")
    counts = _COUNTS[ENTRIES[name].kernel]
    counts[0] += 1
    counts[1] += inverse
    counts[2] += copies
    if _RECORD is not None and record is not None:
        op, tensors, constants = record
        _RECORD.append((op, tuple((tuple(t.shape), tuple(t.stride())) for t in tensors),
                        constants))


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset: the NTT kernels by
    direction (``ntt_tile_fwd``, ``ntt_tile_inv``, ``ntt_mxu_fwd``, ...),
    then the modular pass (``modred``), the basis extension (``mod_up``),
    the key switch's inner product (``key_switch``) and its decomposition
    (``decompose``), and the plaintext-matrix product (``ct_matrix``)."""
    out = {}
    for e in ENTRIES.values():
        launches, inverse, _ = _COUNTS[e.kernel]
        if e.ntt:
            out[e.kernel + "_fwd"], out[e.kernel + "_inv"] = launches - inverse, inverse
        else:
            out[e.kernel] = launches
    return out


def copy_counts() -> dict[str, int]:
    """Operand copies the modular kernels' launch plans made since the last
    reset, by kernel (``modred``, ``mod_up``, ``key_switch``, ``decompose``,
    ``ct_matrix``)."""
    return {e.kernel: _COUNTS[e.kernel][2] for e in ENTRIES.values() if not e.ntt}


def reset_launch_counts() -> None:
    for c in _COUNTS.values():
        c[:] = [0, 0, 0]


@contextlib.contextmanager
def record():
    """Yields a list that collects ``(name, layouts, constants)`` for every
    launch of the modular kernels in the block (the calls a path gives
    them): ``name`` the modular pass's op, ``mod_up``, ``decompose``,
    ``key_switch`` or ``ct_matrix``; ``layouts`` the operands' ``(shape,
    stride)``; ``constants`` the modular pass's per-limb constant operands
    (q, qinv, u0, u1) themselves (no copy: a capture may be recording),
    ``mod_up``'s ``(params, dst_sel, centered)``, ``decompose``'s
    ``(decomposer, level)``, the key switch's ``(ring, limbs, beta,
    beta_axis, index)``, or the plaintext-matrix product's ``(tables,)``."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev
