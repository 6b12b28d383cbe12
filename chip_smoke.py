#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``lattigo_tpu_torch``).

Run it from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from ``lattigo_tpu_torch/csrc``, holds each kernel
bit for bit against its plain PyTorch version at the shapes the main paths
give it (and at a grid of other shapes), times them, then drives the BFV
main path (keygen, encode, encrypt, multiply + relinearize, decrypt, decode)
at PN12QP109 and, at full width, at PN14QP438 with 16 stacked ciphertext
pairs; the small sets of the port's tests (log N = 8, BFV and CKKS) on
rings made with ``device="cuda"``; the CKKS path (keygen with a sparse secret, encode, encrypt,
multiply + relinearize + rescale, rotate by one slot, conjugate, decrypt,
decode) at PN16QP1761 with 8 stacked ciphertext pairs; and one BFV multiply
at PN15QP880, whose single-poly transforms at N = 32768 only the long-row
(cluster) kernel holds; the 3-party private information retrieval over
threshold BFV of examples/dbfv_pir.py at PN13QP218 with 8 rows (collective
public, relinearization and rotation keys, encryption, the batched cloud
step, collective key switch, decryption), with the other three threshold
protocols (public-key switch, two-round relinearization key, refresh);
BFV rotations (by 1 and 5 slots, the row swap, ``inner_sum``) at PN14QP438
with 16 stacked ciphertexts; and the 3-party encrypted two-layer sigmoid
network over threshold CKKS at PN14QP438 (collective public,
relinearization and rotation keys, each party's 8192 slots encrypted, the
degree-7 Chebyshev sigmoid, a rotation and a square, a collective refresh
back to the top level, the second sigmoid, a public-key switch to a
requester, decryption; every share through the reference byte codecs),
with the rest of dCKKS beside it (collective key switch, two-round
relinearization key, conjugation, the refresh's device recode against the
host big-integer one, ``encrypt_from_crp``, ``evaluate_poly_fast`` and
``evaluate_cheby_fast``, codec bytes of shares made on the card); the
multi-rank layer (``parallel``): ``entry.dryrun_multichip`` at PN12QP109
with 4 party ranks over gloo on the one card and with 1 rank over NCCL
(every threshold protocol on the party mesh, the cross-rank four-step NTT,
the scheme step inside ``sharded_ntt``), the 3-party PIR at PN13QP218 with
its rows sharded over the ranks (8 rows in both worlds, 64 on the gloo
ranks; a ``parallel_pir`` line), and ``weak_scaling_mul`` on the
NCCL world of one at CKKS PN16QP1761 with 8 ciphertexts and on the 4-rank
gloo world at CKKS PN12QP109; and the example twins (``examples``): ride
hailing at log N = 12 and the 3-party set intersection at PN13QP218, with
the ``OpProfiler`` table of its AND chain, the CKKS sigmoid at log N = 14
and the 3-party PIR at PN13QP218 through its compiled cloud step; the twin
of bench.py (``bench``: ``lattigo_tpu_torch.bench`` with every config but
#4, which the ``jit`` phase drives: the NTT at ``[1024, 2, 8192]`` and
``[2, 8192]``, BFV at PN13QP218, the per-op table and the 17 dBFV phases
and the 8-party pipeline at PN12QP109, CKKS at PN14QP438 and PN16QP1761,
each a captured chain; every metric present, two replays of a keyed share
program different, the stacked parties' noise distinct, and the new kernel
shapes held against the plain versions and timed); and the compiled programs
(``jit``): ``tjit(forward)`` at PN12QP109, the PIR cloud step at PN13QP218,
the PSI AND chain at PN13QP218 and bench.py's degree-31 Chebyshev at
PN15QP880 through ``JitEvaluator`` (``entry_cheby31``), each captured into
CUDA graphs and replayed bit-equal to its eager call on two
content-distinct inputs, its first result unchanged by later calls, with
eager and replayed ``ms``, ``device_ms``, ``capture_s``, ``op_traces``, the
launches each graph holds, replays and peak memory eager and captured;
the Chebyshev's graphs replayed bit-equal after its ring's LRU table cache
is flooded, and decoded against its float64 interpolant.  The ``dbfv`` and
``dckks`` phases also print the ``OpProfiler`` table of one extra, untimed
call of the PIR cloud step and of ``layer1``.  Every phase prints one JSON
line (``jit`` one a program); any failure, a failed capture included,
exits non-zero.  The last line is ``{"ok": true, "device": {...}}``.

``--phases a,b`` runs a subset (device, build, kernels, small, main_path,
full_width, ckks, bfv15, dbfv, rotate, dckks, parallel, examples, bench, jit, and
``profile``, which is not in the default run:
one traced ``forward`` per configuration, device time by kernel name and the
device's idle share); ``--batch`` sets the PN14QP438 batch; ``--verbose-build`` adds
ptxas' registers and spills of every kernel to the ``build`` line;
``--baseline-passes PATH`` builds an earlier version of
``csrc/ntt_passes.cu`` (the C entry of the two-launch kernel: rows, L,
log N, k, inverse) and ``--baseline-row PATH`` one of ``csrc/ntt_row.cu``
(the C entry of the first row kernel: separate plain and Shoup tables,
rows, L, N, inverse), and each is timed beside the current kernel, in
turns, on the same inputs wherever that kernel is timed.

Every timed shape has ``ms`` (one call between two CUDA events, the host's
time to issue it included) and ``device_ms`` (20 calls captured in one CUDA
graph, replayed between two events, divided by 20: the device's time alone).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke.py needs a CUDA device; none is available\n")
    sys.exit(1)

import numpy as np

from lattigo_tpu_torch import _build, native
from lattigo_tpu_torch import bench as port_bench
from lattigo_tpu_torch.entry import (dryrun_multichip, entry, entry_cheby31, entry_ckks,
                                     entry_dbfv_pir, entry_dckks_sigmoid, fold, rolled_variants)
from lattigo_tpu_torch.examples import bfv_riding, ckks_sigmoid, dbfv_pir, dbfv_psi
from lattigo_tpu_torch.models import bfv, ckks, dbfv, dckks
from lattigo_tpu_torch.ops import mxu_ntt, number_theory as nt, pallas_ntt, tile_ntt
from lattigo_tpu_torch.ops import ring as ring_mod
from lattigo_tpu_torch.ops import u64 as u
from lattigo_tpu_torch.ops.ring import Ring
from lattigo_tpu_torch.parallel import launch, scaling
from lattigo_tpu_torch.tjit import copy_tree, tjit, tree_flatten
from lattigo_tpu_torch.tools.timing import event_ms, graph_ms
from lattigo_tpu_torch.utils import serialization as ser
from lattigo_tpu_torch.utils.precision import precision_stats
from lattigo_tpu_torch.utils.profiling import OpProfiler

DEV = torch.device("cuda", 0)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12    # H100 SXM data sheet, dense
# 32-bit integer multiplies: 64 per SM per clock (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0), half of the 128
# float32 lanes behind the data sheet's 67 TFLOP/s float32 (132 SMs x 1.98 GHz)
INT32_MULS_PER_S = 67e12 / 4
# int32 multiplies of one 64-bit Shoup butterfly: 3 for v*w mod 2^64, 4 for
# the high word of v*w', 3 for that word times q
MULS_PER_BUTTERFLY = 10
MIN_PREC = 12.0  # median bits of a CKKS decoding (tests/test_ckks.py)
JIT_BITS = 15.0  # median bits of the degree-31 Chebyshev against its float64 interpolant
# median bits of the dCKKS checks (tests/test_dckks.py, tests/test_ckks.py)
DCKKS_BITS = dict(path=7.0, cks=11.0, rkg_naive=9.0, conjugate=10.0, refresh=10.0,
                  encrypt_from_crp=11.0, evaluate_poly_fast=10.0, evaluate_cheby_fast=7.0)
CKKS_BATCH = 8  # ciphertext pairs stacked at PN16QP1761
SIGMOID_BITS = 7.0  # median bits of examples/ckks_sigmoid.py's check
# configs of the bench twin the bench phase leaves out: the jit phase drives
# entry.Cheby31 (config #4) already
BENCH_SKIP = ("cheby31",)
REPS = 20
BASELINE = None  # the library of --baseline-passes, when given
BASELINE_ROW = None  # the library of --baseline-row, when given
# the port tests' small sets (tests/test_torch_bfv.py, tests/test_torch_ckks.py)
SMALL_BFV = dict(log_n=8, t=65537, log_qi=(46, 46), log_pi=(47,), log_qi_mul=(60, 60))
SMALL_CKKS = dict(log_n=8, log_slots=7, scale=float(1 << 32), log_qi=(45, 32, 32, 32),
                  log_pi=(45,))

KERNELS = {
    "ntt_tile": dict(
        wrapper=tile_ntt.ntt_tile, route="cuda",
        source="lattigo_tpu_torch/csrc/ntt_row.cu",
        replaces="lattigo_tpu/ops/tile_ntt.py:348",
    ),
    "ntt_mxu": dict(
        wrapper=mxu_ntt.ntt_mxu, route="cuda",
        source="lattigo_tpu_torch/csrc/ntt_fourstep.cu",
        replaces="lattigo_tpu/ops/mxu_ntt.py:465",
    ),
    "ntt_passes": dict(
        wrapper=pallas_ntt.ntt_passes, route="cuda",
        source="lattigo_tpu_torch/csrc/ntt_passes.cu",
        replaces="lattigo_tpu/ops/pallas_ntt.py:262",
    ),
}
ROUTE_KERNEL = {"tile": "ntt_tile", "mxu": "ntt_mxu", "passes": "ntt_passes"}


T0 = time.time()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``t`` is the script's seconds so far."""
    print(json.dumps({"phase": phase, "t": time.time() - T0, **fields}), flush=True)


def fail(msg: str) -> None:
    sys.stderr.write(f"chip_smoke: FAILED: {msg}\n")
    sys.exit(1)


def time_ms(fn, reps: int = REPS) -> float:
    """Median over ``reps`` launches, each between two CUDA events, after a
    warm-up.  Inputs stay warm in L2, as they are for the main path's caller,
    which has just produced them."""
    return event_ms(fn, reps)


def host_ms(fn, reps: int = 5) -> float:
    """Median host time of ``fn`` ending in a device synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_time(fn, count: int = REPS) -> float | str:
    """``graph_ms``: the device's time of one call (``count`` in a CUDA
    graph); the error's text where the call cannot be captured."""
    try:
        return graph_ms(fn, count=count)
    except RuntimeError as e:
        torch.cuda.synchronize()
        return f"not measured: {e}"


def device_turns(fns) -> list:
    """``device_time`` of ``fns`` taken in turns (a, b, b, a): the mean of
    each one's two."""
    times = [[] for _ in fns]
    order = list(range(len(fns)))
    for i in order + order[::-1]:
        times[i].append(device_time(fns[i]))
    return [statistics.mean(t) if all(isinstance(v, float) for v in t) else t[0] for t in times]


def host_us(fn, calls: int = 100) -> float:
    """The host's time to issue one call, in microseconds: ``calls`` calls
    back to back on an idle device (fewer than its launch queue holds),
    then one synchronize outside the clock; median of 5."""
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def time_turns(fns, reps: int = REPS // 2) -> list[float]:
    """Times of ``fns`` on one card taken in turns (a, b, b, a): the mean of
    each one's two medians."""
    times = [[] for _ in fns]
    order = list(range(len(fns)))
    for i in order + order[::-1]:
        times[i].append(time_ms(fns[i], reps))
    return [statistics.mean(t) for t in times]


reset_counts = ring_mod.reset_launch_counts
read_counts = ring_mod.launch_counts


def plain_of(name: str, ring, x, limbs, inverse):
    if name == "ntt_tile":
        return ring._intt_simple(x, limbs) if inverse else ring._ntt_simple(x, limbs)
    if name == "ntt_passes":
        return pallas_ntt.ntt_passes_plain(ring, x, limbs, inverse)
    return mxu_ntt.ntt_mxu_plain(ring, x, limbs, inverse)


def takes(name: str, n: int) -> bool:
    """Whether kernel ``name`` holds rows of N = n."""
    if name == "ntt_tile":
        return tile_ntt.MIN_N <= n <= tile_ntt.MAX_N
    if name == "ntt_mxu":
        return mxu_ntt.supported(n)
    return pallas_ntt.MIN_N <= n <= pallas_ntt.MAX_N


def rand_input(ring, batch, limbs, lazy_mult: int, seed: int) -> torch.Tensor:
    """Residues below lazy_mult * q per limb row, from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = np.empty((*batch, len(limbs), ring.n), dtype=np.uint64)
    for k, l in enumerate(limbs):
        x[..., k, :] = rng.integers(0, lazy_mult * ring.moduli[l], size=(*batch, ring.n),
                                    dtype=np.uint64)
    return u.from_u64(x, DEV)


def const_input(ring, batch, limbs, below_mult: int) -> torch.Tensor:
    """Every residue of limb row l equal to below_mult * q_l - 1."""
    x = np.empty((*batch, len(limbs), ring.n), dtype=np.uint64)
    for k, l in enumerate(limbs):
        x[..., k, :] = below_mult * ring.moduli[l] - 1
    return u.from_u64(x, DEV)


def check_equal(name, ring, x, limbs, inverse) -> int:
    """Kernel vs plain on the same input; returns the max abs difference."""
    got = KERNELS[name]["wrapper"](ring, x, limbs, inverse=inverse)
    want = plain_of(name, ring, x, limbs, inverse)
    torch.cuda.synchronize()
    if torch.equal(got, want):
        return 0
    diff = (u.to_u64(got).astype(object) - u.to_u64(want).astype(object))
    return int(np.abs(diff).max())


def bound_ms(name: str, ring, batch_rows: int, limbs) -> tuple[float, str]:
    """The least time the GPU could take: each input (data and the tables of
    the limbs used) read once, each output written once, over the memory
    rate; for the four-step kernel also its int8 operations over the int8
    tensor-core peak; for the row and long-row kernels also their (N/2) log N
    Shoup butterflies per row, MULS_PER_BUTTERFLY int32 multiplies each,
    over the int32 multiply rate."""
    n, L = ring.n, len(limbs)
    nl = len(set(limbs))
    data = 2 * batch_rows * L * n * 8
    if name in ("ntt_tile", "ntt_passes"):
        t_bytes = (data + nl * 2 * n * 8) / HBM_BYTES_PER_S * 1e3
        muls = batch_rows * L * (n // 2) * ring.log_n * MULS_PER_BUTTERFLY
        t_ops = muls / INT32_MULS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    n1 = n // 128
    tables = nl * ((8 * n1) ** 2 + 1024 ** 2 + 4 * (8 * n1 + 1024) + 3 * n * 8 + 8 * 8)
    t_bytes = (data + tables) / HBM_BYTES_PER_S * 1e3
    ops = batch_rows * L * (2 * (8 * n1) ** 2 * 128 + 2 * n1 * 1024 ** 2)
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def median_bits(got, want) -> float:
    return precision_stats(got, want).median_bits


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    line = port_bench.smi_line()
    emit("device", gpu=line, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return line


def ptxas_report(text: str) -> list[dict]:
    """Registers and spill bytes of every kernel in ptxas' -v output."""
    out = []
    for block in re.split(r"ptxas info\s*: Compiling entry function ", text)[1:]:
        name = block.split("'")[1]
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
        out.append(dict(kernel=name, registers=int(regs.group(1)) if regs else None,
                        spill_stores=int(spill.group(1)) if spill else None,
                        spill_loads=int(spill.group(2)) if spill else None))
    return out


def build_baseline(path: str, name: str):
    """An earlier version of ``csrc/<name>.cu`` built beside the current one,
    into the git-ignored build directory."""
    lib_path = os.path.join(_build.BUILD, "baseline", f"lib{name}_baseline.so")
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    proc = subprocess.run(
        [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-I", _build.CSRC, "-o", lib_path, path],
        capture_output=True, text=True)
    if proc.returncode:
        fail(f"nvcc failed for the baseline {path}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    entry = getattr(lib, f"{name}_launch")
    # the two-launch ntt_passes: rows, L, log N, k, inverse; the first
    # ntt_row: rows, L, N, inverse; both after 6 pointers, before the stream
    ints = 5 if name == "ntt_passes" else 4
    entry.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * ints + [ctypes.c_void_p]
    entry.restype = ctypes.c_int
    return lib


def baseline_row(ring, x, limbs, inverse) -> torch.Tensor:
    """The first row kernel's transform: one block a row, plain and Shoup
    twiddle tables apart."""
    tw, tws, consts = pallas_ntt._tables(ring, inverse)
    xc = x.contiguous()
    out = torch.empty_like(xc)
    err = BASELINE_ROW.ntt_row_launch(
        xc.data_ptr(), out.data_ptr(), tw.data_ptr(), tws.data_ptr(), consts.data_ptr(),
        ring.limb_vector(limbs).data_ptr(), xc.numel() // ring.n, len(limbs), ring.n,
        int(inverse), torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"the baseline row kernel failed to launch: CUDA error {err}")
    return out


def baseline_passes(ring, x, limbs, inverse) -> torch.Tensor:
    """The baseline's transform, at its own default split (chunks of at most
    8192 coefficients, k up to 4)."""
    n = ring.n
    tw, tws, consts = pallas_ntt._tables(ring, inverse)
    xc = x.contiguous()
    out = torch.empty_like(xc)
    err = BASELINE.ntt_passes_launch(
        xc.data_ptr(), out.data_ptr(), tw.data_ptr(), tws.data_ptr(), consts.data_ptr(),
        ring.limb_vector(limbs).data_ptr(), xc.numel() // n, len(limbs), ring.log_n,
        max(1, (n >> 13).bit_length() - 1), int(inverse), torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"the baseline kernel failed to launch: CUDA error {err}")
    return out


def phase_build(verbose: bool) -> None:
    t0 = time.time()
    logs = _build.build(verbose=verbose)
    for name in _build.SOURCES:
        _build.load(name)
    fields = dict(seconds=round(time.time() - t0, 3), sources=list(_build.SOURCES))
    if verbose:
        fields["ptxas"] = {name: ptxas_report(text) for name, text in logs.items()}
    emit("build", **fields)


def record_calls(run) -> list[tuple]:
    """The NTT calls ``run`` makes, as (ring, shape, limbs, inverse, route):
    the shapes the main path gives each kernel."""
    with ring_mod.record_transforms() as calls:
        run()
    torch.cuda.synchronize()
    return calls


_rank_rings: dict = {}


def rank_calls(transforms) -> list[tuple]:
    """Transforms that ranks reported, as (moduli, shape, limbs, inverse,
    route), as ``record_calls`` gives them, on rings of DEV; those of the
    kernels' routes only."""
    out = []
    for moduli, shape, limbs, inverse, route in transforms:
        if route not in ROUTE_KERNEL:
            continue
        if moduli not in _rank_rings:
            _rank_rings[moduli] = Ring(shape[-1], list(moduli), device=DEV)
        out.append((_rank_rings[moduli], tuple(shape), tuple(limbs), inverse, route))
    return out


def measure_shape(name, ring, shape, limbs, inverse, seed) -> dict:
    batch = shape[:-2]
    rows = int(np.prod(batch, dtype=np.int64)) if batch else 1
    lazy = 1 if inverse else 2
    x = rand_input(ring, batch, limbs, lazy, seed)
    err = check_equal(name, ring, x, limbs, inverse)
    w = KERNELS[name]["wrapper"]

    def kernel():
        return w(ring, x, limbs, inverse=inverse)

    extra = {}
    base = {"ntt_passes": (BASELINE, baseline_passes), "ntt_tile": (BASELINE_ROW, baseline_row)}
    lib, run_base = base.get(name, (None, None))
    if lib is not None:
        if not torch.equal(run_base(ring, x, limbs, inverse),
                           plain_of(name, ring, x, limbs, inverse)):
            fail(f"the baseline {name} disagrees with the plain version at {shape}")

        def baseline():
            return run_base(ring, x, limbs, inverse)

        ms, extra["baseline_ms"] = time_turns([kernel, baseline])
        device, extra["baseline_device_ms"] = device_turns([kernel, baseline])
    else:
        ms = time_ms(kernel)
        device = device_time(kernel)
    if name == "ntt_tile":
        extra["host_us"] = host_us(kernel)
    plain = time_ms(lambda: plain_of(name, ring, x, limbs, inverse), reps=5)
    b_ms, b_by = bound_ms(name, ring, rows, limbs)
    return dict(shape=list(shape), limbs=list(limbs), inverse=inverse, max_abs_err=err,
                ms=ms, device_ms=device, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, **extra)


def cross_time(name, ring, shape, limbs, inverse, seed) -> dict:
    """The OTHER kernels' times (``ms`` and ``device_ms``) on a shape the
    routing gives to ``name``, for each that holds rows of this N."""
    x = rand_input(ring, shape[:-2], limbs, 1, seed)
    want = plain_of(name, ring, x, limbs, inverse)
    out = {}
    for other, k in KERNELS.items():
        if other == name or not takes(other, ring.n):
            continue
        w = k["wrapper"]
        if not torch.equal(w(ring, x, limbs, inverse=inverse), want):
            fail(f"{other} disagrees with the plain version on {shape} limbs {limbs}")

        def call():
            return w(ring, x, limbs, inverse=inverse)

        out[other] = dict(ms=time_ms(call), device_ms=device_time(call))
    return out


MEASURED: dict = {}  # (moduli, shape, limbs, inverse, route) -> its measure_calls row


def measure_calls(calls, label: str, largest_only: bool = False) -> list[dict]:
    """Every distinct NTT call of a forward: its kernel against the plain
    version, timed, with the other kernels' times on the same shape.  A
    shape an earlier phase of this run measured on a ring of the same
    moduli is not measured again (``measured_by`` names that phase).
    ``largest_only``: time only the largest shape of each kernel and
    direction (the one ``kernel_rows`` reports); hold the others against the
    plain version untimed."""
    shapes = []
    seen = set()
    key_of = lambda c: (tuple(c[0].moduli), *c[1:])
    largest = {}
    for c in calls:
        if c[4] in ROUTE_KERNEL:
            k = (c[4], c[3])
            if k not in largest or np.prod(c[1]) > np.prod(largest[k][1]):
                largest[k] = c
    for i, call in enumerate(calls):
        ring, shape, limbs, inverse, route = call
        key = key_of(call)
        if key in seen or route not in ROUTE_KERNEL:
            continue
        seen.add(key)
        n_calls = sum(1 for c in calls if key_of(c) == key)
        if key in MEASURED:
            shapes.append(dict(MEASURED[key], calls=n_calls))
            continue
        name = ROUTE_KERNEL[route]
        if largest_only and key_of(largest[(route, inverse)]) != key:
            x = rand_input(ring, shape[:-2], limbs, 1 if inverse else 2, seed=1000 + i)
            err = check_equal(name, ring, x, limbs, inverse)
            if err != 0:
                fail(f"{label}: {name} disagrees with its plain version at {shape} limbs {limbs}")
            shapes.append(dict(kernel=name, shape=list(shape), limbs=list(limbs), inverse=inverse,
                               max_abs_err=err, calls=n_calls, measured_by=label, timed=False))
            continue
        r = measure_shape(name, ring, shape, limbs, inverse, seed=1000 + i)
        r.update(kernel=name, calls=n_calls, measured_by=label,
                 other_kernels=cross_time(name, ring, shape, limbs, inverse, seed=2000 + i))
        if r["max_abs_err"] != 0:
            fail(f"{label}: {name} disagrees with its plain version at {shape} limbs {limbs}")
        MEASURED[key] = r
        shapes.append(r)
        torch.cuda.empty_cache()
    return shapes


def check_case(results, name, ring, x, limbs, inverse, **tags) -> None:
    """One kernel-vs-plain case, appended to ``results``."""
    err = check_equal(name, ring, x, limbs, inverse)
    results.append(dict(kernel=name, n=ring.n, batch=list(x.shape[:-2]), limbs=list(limbs),
                        inverse=inverse, err=err, **tags))


def row_kernel_cases(results, seed: int) -> tuple[list, int]:
    """The row kernel at every N it takes (2^8 .. 2^14): 60-, 55-, 45- and
    39-bit primes and the plaintext ring t = 65537; batches (), 3, 5 and 17,
    and at N <= 2048 a batch of 88 * 4096 / N + 1, whose 3 limbs have the
    rows for blocks of 4096 / N rows of one limb, so the last block of a
    limb is ragged; prefix and non-prefix limbs; random inputs below 4q and
    every residue at 4q - 1; both directions.  Then its time on the
    [72, 3, N] grid (and at N <= 2048 on the large batch) beside the other
    kernels' (and the baseline's, when given).  Returns the timing rows and
    the next seed."""
    times = []
    for log_n in range(8, 15):
        n = 1 << log_n
        big = (88 * (4096 // n) + 1,) if n <= 2048 else (17,)
        for bits in (60, 55, 45, 39):
            ring = Ring(n, nt.generate_ntt_primes(bits, log_n, 3), device=DEV)
            for batch in sorted({(), (3,), (5,), (17,), big}):
                for limbs in ((0, 1, 2), (2, 0), (2,)):
                    for inverse in (False, True):
                        seed += 1
                        x = rand_input(ring, batch, limbs, 4, seed)  # lazy: below 4q
                        check_case(results, "ntt_tile", ring, x, limbs, inverse, bits=bits)
            for batch, limbs in (((), (0, 1, 2)), ((17,), (2, 0)), (big, (0, 1, 2))):
                for inverse in (False, True):
                    x = const_input(ring, batch, limbs, 4)
                    check_case(results, "ntt_tile", ring, x, limbs, inverse, bits=bits,
                               all_4q_minus_1=True)
            if bits == 60:
                for shape in sorted({(72, 3, n), (*big, 3, n)}):
                    for inverse in (False, True):
                        r = measure_shape("ntt_tile", ring, shape, (0, 1, 2), inverse, seed)
                        r["plan"] = tile_ntt.launch_plan(n, shape[0] * 3)._asdict()
                        r["other_kernels"] = cross_time("ntt_tile", ring, shape, (0, 1, 2),
                                                        inverse, seed)
                        times.append(r)
            del ring
            torch.cuda.empty_cache()
        # the plaintext ring: t = 65537, one limb (encode / decode)
        ring = Ring(n, [65537], device=DEV)
        for batch in ((), (5,)):
            for inverse in (False, True):
                seed += 1
                check_case(results, "ntt_tile", ring, rand_input(ring, batch, (0,), 4, seed),
                           (0,), inverse, bits=17)
                check_case(results, "ntt_tile", ring, const_input(ring, batch, (0,), 4),
                           (0,), inverse, bits=17, all_4q_minus_1=True)
    # what the row kernel does not hold is refused, not computed wrongly
    for n in (1 << 7, 1 << 15):
        ring = Ring(n, nt.generate_ntt_primes(60, n.bit_length() - 1, 1), device=DEV)
        try:
            tile_ntt.ntt_tile(ring, ring.new_poly(), (0,))
            fail(f"ntt_tile accepted N={n}")
        except NotImplementedError:
            pass
    return times, seed


def phase_kernels() -> None:
    """Bit-equality (tolerance 0: integers) of each kernel with its plain
    version over a grid of sizes, primes, lazy inputs, limb subsets and
    batches; and the row and long-row kernels' times beside the other
    kernels' (and the baselines', when given) on the same shapes, with
    their launch plans for every N."""
    results = []
    seed = 100
    row_times, seed = row_kernel_cases(results, seed)
    for log_n in (12, 13, 14, 15):
        n = 1 << log_n
        for bits in (60, 39):
            ring = Ring(n, nt.generate_ntt_primes(bits, log_n, 3), device=DEV)
            # batch 17 is no multiple of any block of polys; 72 fills
            # several row tiles of the four-step kernel per limb
            for batch in ((1,), (3,), (17,), (72,)):
                for limbs in ((0, 1, 2), (2, 0), (2,)):
                    for inverse in (False, True):
                        seed += 1
                        x = rand_input(ring, batch, limbs, 4, seed)  # lazy: below 4q
                        check_case(results, "ntt_mxu", ring, x, limbs, inverse, bits=bits)
            # the four-step kernel takes any input below 2^62
            for inverse in (False, True):
                seed += 1
                rng = np.random.default_rng(seed)
                x = u.from_u64(rng.integers(0, 2**62, size=(3, 2, n), dtype=np.uint64), DEV)
                check_case(results, "ntt_mxu", ring, x, (2, 0), inverse, bits=bits,
                           below=2**62)
            del ring
            torch.cuda.empty_cache()
    # the long-row kernel from N = 2^12 to 2^16, and its smallest and largest
    # N (clusters of 2, 4 and 8 blocks), every prime size of the default
    # sets, prefix and non-prefix limbs; batch 5 of 3 limbs spreads the rows
    # of one limb over clusters unevenly in the limb-major grid; every
    # residue 4q - 1 is the largest input
    passes_times = []
    for log_n in (10, 12, 13, 14, 15, 16, 17):
        n = 1 << log_n
        for bits in (60, 55, 45, 39):
            ring = Ring(n, nt.generate_ntt_primes(bits, log_n, 3), device=DEV)
            for batch in ((1,), (3,), (5,), (72,)):
                for limbs in ((0, 1, 2), (2, 0)):
                    for inverse in (False, True):
                        seed += 1
                        x = rand_input(ring, batch, limbs, 4, seed)
                        check_case(results, "ntt_passes", ring, x, limbs, inverse, bits=bits)
            for inverse in (False, True):
                x = const_input(ring, (3,), (0, 1, 2), 4)
                check_case(results, "ntt_passes", ring, x, (0, 1, 2), inverse, bits=bits,
                           all_4q_minus_1=True)
            if bits == 60 and 12 <= log_n:
                for inverse in (False, True):
                    shape = (72, 3, n)
                    r = measure_shape("ntt_passes", ring, shape, (0, 1, 2), inverse, seed)
                    r["other_kernels"] = cross_time("ntt_passes", ring, shape, (0, 1, 2),
                                                    inverse, seed)
                    passes_times.append(r)
            del ring
            torch.cuda.empty_cache()
    bad = [r for r in results if r["err"] != 0]
    if any(r["max_abs_err"] != 0 for r in row_times + passes_times):
        bad.append("timing shapes")
    emit("kernels", cases=len(results), ok=not bad, failed=bad[:10],
         cases_by_kernel={k: sum(r["kernel"] == k for r in results) for k in KERNELS},
         row_plans={1 << e: {"72x3": tile_ntt.launch_plan(1 << e, 216)._asdict(),
                             "full": tile_ntt.launch_plan(1 << e)._asdict()} for e in range(8, 15)},
         passes_plans={1 << e: pallas_ntt.launch_plan(1 << e)._asdict() for e in range(10, 18)},
         row_times=row_times, passes_times=passes_times)
    if bad:
        fail(f"{len(bad)} kernel cases disagree with the plain version")


def phase_small() -> dict:
    """The port tests' log N = 8 sets on the card, every object made with
    ``device="cuda"`` (no index): BFV encode, encrypt, ``mul``,
    ``relinearize``, decrypt, decode, exact; CKKS ``mul_relin``,
    ``rescale``, ``rotate_columns(1)``, decrypt, decode, at a median of at
    least MIN_PREC bits; both equal bit for bit to the all-plain route, and
    the row kernel's launches counted."""
    dev = "cuda"
    out = {}
    params = bfv.Parameters(**SMALL_BFV).gen_from_log_moduli()
    kgen = bfv.KeyGenerator(params, device=dev)
    sk, pk = kgen.gen_key_pair()
    rlk = kgen.gen_relin_key(sk, 1)
    enc = bfv.Encoder(params, device=dev)
    ev = bfv.Evaluator(params, device=dev)
    encryptor = bfv.Encryptor(params, pk=pk, device=dev)
    rng = np.random.default_rng(8)
    ma, mb = (rng.integers(0, params.t, params.n, dtype=np.uint64) for _ in range(2))
    ca, cb = encryptor.encrypt(enc.encode_uint(ma)), encryptor.encrypt(enc.encode_uint(mb))
    if ca.value[0].device != DEV:
        fail(f"small: a ciphertext made with device='cuda' lies on {ca.value[0].device}")
    reset_counts()
    ct = ev.relinearize(ev.mul(ca, cb), rlk)
    torch.cuda.synchronize()
    counts = read_counts()
    got = enc.decode_uint(bfv.Decryptor(params, sk, device=dev).decrypt(ct))
    if not (got == ma * mb % np.uint64(params.t)).all():
        fail("small: the BFV product does not decrypt to ma * mb mod t")
    ring_mod.FORCE_KERNEL = "plain"
    try:
        ref = ev.relinearize(ev.mul(ca, cb), rlk)
    finally:
        ring_mod.FORCE_KERNEL = None
    if not all(torch.equal(a, b) for a, b in zip(ct.value, ref.value)):
        fail("small: the BFV product differs from the all-plain route")
    out["bfv"] = dict(n=params.n, counts=counts)

    params = ckks.Parameters(**SMALL_CKKS).gen_from_log_moduli()
    kgen = ckks.KeyGenerator(params, device=dev, seed=1)
    sk, pk = kgen.gen_key_pair()
    rlk = kgen.gen_relin_key(sk)
    rot = ckks.RotationKeys()
    kgen.gen_rot("left", sk, 1, rot)
    enc = ckks.Encoder(params, device=dev)
    ev = ckks.Evaluator(params, device=dev)
    encryptor = ckks.Encryptor(params, pk=pk, device=dev, seed=2)
    va, vb = (rng.uniform(-1, 1, params.slots) + 1j * rng.uniform(-1, 1, params.slots)
              for _ in range(2))
    ca, cb = encryptor.encrypt(enc.encode(va)), encryptor.encrypt(enc.encode(vb))

    def path():
        prod = ev.rescale(ev.mul_relin(ca, cb, rlk))
        return prod, ev.rotate_columns(prod, 1, rot)

    reset_counts()
    prod, turned = path()
    torch.cuda.synchronize()
    counts = read_counts()
    dec = ckks.Decryptor(params, sk, device=dev)
    precision = {}
    for name, ct, want in (("rescale", prod, va * vb), ("rotate", turned, np.roll(va * vb, -1))):
        got = enc.decode(dec.decrypt(ct))
        if got.shape != (params.slots,) or not np.isfinite(got).all():
            fail(f"small: CKKS {name} decodes to {got.shape} with non-finite values")
        precision[name] = median_bits(got, want)
        if precision[name] < MIN_PREC:
            fail(f"small: CKKS {name} has median precision {precision[name]:.2f} < {MIN_PREC}")
    ring_mod.FORCE_KERNEL = "plain"
    try:
        refs = path()
    finally:
        ring_mod.FORCE_KERNEL = None
    for ct, ref in zip((prod, turned), refs):
        if ref.scale != ct.scale or not all(torch.equal(a, b) for a, b in zip(ct.value, ref.value)):
            fail("small: the CKKS path differs from the all-plain route")
    out["ckks"] = dict(n=params.n, counts=counts, precision_bits=precision)
    for scheme in ("bfv", "ckks"):
        c = out[scheme]["counts"]
        if c["ntt_tile_fwd"] + c["ntt_tile_inv"] == 0:
            fail(f"small: the {scheme} path never launched the row kernel")
    return out


def drive(params_idx: int, batch: tuple, label: str) -> dict:
    """One BFV run: keygen, encode, encrypt, forward, decrypt, decode, with
    the launch counts of ``forward`` and of the whole pipeline, the kernels
    held against their plain versions at every shape ``forward`` gives
    them, and ``forward`` held against the all-plain route."""
    params = bfv.default_params(params_idx)
    reset_counts()
    t0 = time.time()
    forward, (ct0, ct1, swk) = entry(device=DEV, params_idx=params_idx, batch=batch)
    torch.cuda.synchronize()
    setup_s = time.time() - t0

    t0 = time.time()
    calls = record_calls(lambda: forward(ct0, ct1, swk))  # also builds the tables
    first_forward_s = time.time() - t0
    pipeline_before = read_counts()

    reset_counts()
    out = forward(ct0, ct1, swk)
    torch.cuda.synchronize()
    counts = read_counts()

    enc = bfv.Encoder(params, device=DEV)
    dec = bfv.Decryptor(params, forward.secret_key, device=DEV)
    got = enc.decode_uint(dec.decrypt(out))
    m = np.arange(params.n, dtype=np.uint64) % params.t
    want = m * m[::-1] % np.uint64(params.t)
    if got.shape != (*batch, params.n) or not (got == want).all():
        fail(f"{label}: decrypted product differs from m * m[::-1] mod t")

    ring_mod.FORCE_KERNEL = "plain"
    try:
        ref = forward(ct0, ct1, swk)
    finally:
        ring_mod.FORCE_KERNEL = None
    if not all(torch.equal(a, b) for a, b in zip(out.value, ref.value)):
        fail(f"{label}: forward differs from the all-plain route")

    forward_ms = host_ms(lambda: forward(ct0, ct1, swk))
    return dict(label=label, n=params.n, batch=list(batch), counts=counts,
                setup_and_first_forward_counts=pipeline_before, setup_s=setup_s,
                first_forward_s=first_forward_s, forward_ms=forward_ms,
                shapes=measure_calls(calls, label))


def phase_ckks() -> dict:
    """The CKKS path at PN16QP1761 with CKKS_BATCH stacked pairs: keygen,
    encode, encrypt, forward = rescale(mul_relin), rotate by one slot,
    conjugate, decrypt and decode ct 0 and ct batch-1 after each, the
    forward held against the all-plain route, its launch counts, times and
    peak device memory, and every passes launch of it timed."""
    label = "PN16QP1761"
    batch = CKKS_BATCH
    params = ckks.default_params(ckks.PN16QP1761)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    forward, (ct0, ct1, rlk) = entry_ckks(device=DEV, batch=(batch,))
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    setup_counts = read_counts()

    t0 = time.time()
    calls = record_calls(lambda: forward(ct0, ct1, rlk))
    first_forward_s = time.time() - t0

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    out = forward(ct0, ct1, rlk)
    torch.cuda.synchronize()
    counts = read_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    want_counts = {k: 0 for k in counts}
    want_counts.update(ntt_passes_fwd=4, ntt_passes_inv=4)
    if counts != want_counts:
        fail(f"{label}: launch counts of one forward are {counts}, expected 4 + 4 ntt_passes")

    ev, rot_keys = forward.evaluator, forward.rotation_keys
    rot = ev.rotate_columns(out, 1, rot_keys)
    conj = ev.conjugate(rot, rot_keys)
    enc = ckks.Encoder(params, device=DEV)
    dec = ckks.Decryptor(params, forward.secret_key, device=DEV)
    v0, v1 = forward.values
    want = v0 * v1
    precision = {}
    for name, ct, w in (("forward", out, want), ("rotate", rot, np.roll(want, -1)),
                        ("conjugate", conj, np.conj(np.roll(want, -1)))):
        for i in (0, batch - 1):
            one = ckks.Ciphertext([p[i] for p in ct.value], ct.scale)
            got = enc.decode(dec.decrypt(one))
            if got.shape != (params.slots,) or not np.isfinite(got).all():
                fail(f"{label}: {name} ct {i} decodes to {got.shape} with non-finite values")
            bits = median_bits(got, w)
            precision[f"{name}_ct{i}"] = bits
            if bits < MIN_PREC:
                fail(f"{label}: {name} ct {i} has median precision {bits:.2f} < {MIN_PREC} bits")
    if out.level != params.max_level - 1:
        fail(f"{label}: forward left level {out.level}, expected {params.max_level - 1}")
    del rot, conj

    ring_mod.FORCE_KERNEL = "plain"
    try:
        ref = forward(ct0, ct1, rlk)
    finally:
        ring_mod.FORCE_KERNEL = None
    if ref.scale != out.scale or not all(torch.equal(a, b) for a, b in zip(out.value, ref.value)):
        fail(f"{label}: forward differs from the all-plain route")
    del ref
    torch.cuda.empty_cache()

    forward_ms = host_ms(lambda: forward(ct0, ct1, rlk))
    return dict(label=label, n=params.n, batch=[batch], counts=counts,
                setup_counts=setup_counts, setup_s=setup_s, first_forward_s=first_forward_s,
                forward_ms=forward_ms, peak_forward_bytes=peak_bytes,
                resident_bytes_before_forward=base_bytes, precision_bits=precision,
                shapes=measure_calls(calls, label))


def _sum_counts(counts: dict) -> dict:
    total = {}
    for c in counts.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def _same(a, b) -> bool:
    return len(a.value) == len(b.value) and all(torch.equal(x, y) for x, y in zip(a.value, b.value))


HEAVY_GRAPH_CALLS = 2  # calls of a whole scheme step captured in one graph


def profile_ops(holder, fn) -> dict:
    """One extra, untimed call of ``fn`` with ``holder.ev`` wrapped in an
    ``OpProfiler``: the host time of each evaluator method it calls, each
    ending in a device synchronize (``utils/profiling.py``)."""
    prof = OpProfiler(holder.ev)
    holder.ev = prof
    try:
        fn()
    finally:
        holder.ev = prof._ev
    return prof.as_dict()


def phase_dbfv() -> dict:
    """The 3-party PIR of examples/dbfv_pir.py at PN13QP218 with 8 rows,
    stage by stage through ``entry_dbfv_pir``: each stage's seconds and
    kernel launches; the cloud step timed (``ms``, ``device_ms``) and held
    against the all-plain route bit for bit; the retrieved row must equal
    the wanted row exactly.  Then the other three protocols at the same set,
    each checked by exact decryption: PCKS to a fresh public key, the
    two-round relinearization key (one product relinearized), and a refresh
    of one ciphertext.  Every kernel is held against its plain version at
    every shape any of these stages gives it."""
    label = "PN13QP218"
    pir = entry_dbfv_pir(device=DEV)
    params = pir.params
    setup_s, counts, calls = {}, {}, []

    def stage(name, fn):
        reset_counts()
        out = []
        t0 = time.time()
        calls.extend(record_calls(lambda: out.append(fn())))
        setup_s[name] = time.time() - t0
        counts[name] = read_counts()
        return out[0]

    pk = stage("ckg", pir.ckg)
    rlk = stage("rkg", pir.rkg)
    rot_keys = stage("rtg", pir.rtg)
    query, rows, masks = stage("encrypt", lambda: pir.encrypt(pk))

    def cloud():
        return pir.cloud(query, rows, masks, rlk, rot_keys)

    t0 = time.time()
    cloud()  # also builds the tables
    torch.cuda.synchronize()
    first_cloud_s = time.time() - t0
    result = stage("cloud", cloud)
    if result.degree != 1 or result.value[0].shape != (len(params.qi), params.n):
        fail(f"dbfv: the cloud step gave degree {result.degree}, shape {result.value[0].shape}")
    sk_req = stage("requester_key", pir.requester_key)
    switched = stage("cks", lambda: pir.cks(result, sk_req))
    got = stage("decrypt", lambda: pir.decrypt(switched, sk_req))
    if got.shape != (params.n,) or not (got == pir.rows[pir.wanted]).all():
        fail(f"dbfv: the retrieved row differs from row {pir.wanted}")

    ring_mod.FORCE_KERNEL = "plain"
    try:
        ref = cloud()
    finally:
        ring_mod.FORCE_KERNEL = None
    if not _same(result, ref):
        fail("dbfv: the cloud step differs from the all-plain route")
    cloud_ms = time_ms(cloud, reps=5)
    cloud_device_ms = device_time(cloud, count=HEAVY_GRAPH_CALLS)
    cks_ms = time_ms(lambda: pir.cks(result, sk_req), reps=5)
    cloud_ops = profile_ops(pir, cloud)

    # the other three protocols at the same set, under the summed key
    dec = bfv.Decryptor(params, pir.sk_col, device=DEV)
    encryptor = bfv.Encryptor(params, pk=pk, device=DEV, seed=7)
    rng = np.random.default_rng(13)
    msg = lambda: rng.integers(0, params.t, params.n, dtype=np.uint64)
    decode = lambda ct, sk=None: pir.enc.decode_uint(
        (dec if sk is None else bfv.Decryptor(params, sk, device=DEV)).decrypt(ct))
    sks = [sk.sk for sk in pir.sks]
    checks = {}

    def pcks():
        sk_t, pk_t = bfv.KeyGenerator(params, device=DEV, seed=888).gen_key_pair()
        m = msg()
        ct = encryptor.encrypt(pir.enc.encode_uint(m))
        proto = dbfv.PCKSProtocol(params, device=DEV)
        out = proto.key_switch(fold(proto, [proto.gen_share(sk, pk_t, ct) for sk in sks]), ct)
        return bool((decode(out, sk_t) == m).all())

    def rkg_naive():
        proto = dbfv.RKGProtocolNaive(params, device=DEV)
        r1 = fold(proto, [proto.gen_share_round_one(sk, pk) for sk in sks])
        r2 = fold(proto, [proto.gen_share_round_two(r1, sk, pk) for sk in sks])
        naive_rlk = proto.gen_relinearization_key(r2)
        m0, m1 = msg(), msg()
        cts = [encryptor.encrypt(pir.enc.encode_uint(m)) for m in (m0, m1)]
        prod = pir.ev.relinearize(pir.ev.mul(*cts), naive_rlk)
        return prod.degree == 1 and bool((decode(prod) == m0 * m1 % np.uint64(params.t)).all())

    def refresh():
        m = msg()
        ct = encryptor.encrypt(pir.enc.encode_uint(m))
        proto = dbfv.RefreshProtocol(params, device=DEV)
        crs = pir.crp_gen.clock_poly()
        out = proto.finalize(ct, crs, fold(proto, [proto.gen_share(sk, ct, crs) for sk in sks]))
        return bool((decode(out) == m).all())

    for name, fn in (("pcks", pcks), ("rkg_naive", rkg_naive), ("refresh", refresh)):
        checks[name] = stage(name, fn)
        if not checks[name]:
            fail(f"dbfv: {name} does not decrypt exactly")

    pir_counts = _sum_counts({k: v for k, v in counts.items() if k not in checks})
    total = _sum_counts(counts)
    for name in ("ntt_tile", "ntt_mxu"):
        if total[name + "_fwd"] + total[name + "_inv"] == 0:
            fail(f"dbfv: the path never launched {name}")
    return dict(label=label, n=params.n, parties=pir.n_parties, rows=pir.n_rows,
                crp_walk=native.walk_route(), setup_s=setup_s, first_cloud_s=first_cloud_s,
                ms=cloud_ms, device_ms=cloud_device_ms, cks_ms=cks_ms, cloud_ops=cloud_ops,
                stage_counts=counts, pir_counts=pir_counts, counts=total, exact=checks,
                shapes=measure_calls(calls, label))


def phase_rotate(batch: int) -> dict:
    """BFV rotations at PN14QP438 with ``batch`` stacked ciphertexts:
    power-of-two rotation keys, then ``rotate_columns`` by 1 (direct key)
    and by 5 (keys 4 and 1), ``rotate_rows`` and ``inner_sum``, each timed
    (``ms``, ``device_ms``), checked exactly against the rotated slots (the
    slot sum mod t for ``inner_sum``) and bit for bit against the all-plain
    route, and every kernel held against its plain version at every shape
    the key generation and the rotations give it."""
    label = "PN14QP438"
    params = bfv.default_params(bfv.PN14QP438)
    n, row, t = params.n, params.n // 2, params.t
    kgen = bfv.KeyGenerator(params, device=DEV, seed=21)
    sk = kgen.gen_secret_key()
    reset_counts()
    t0 = time.time()
    keys = []
    calls = record_calls(lambda: keys.append(kgen.gen_rotation_keys_pow2(sk)))
    rk = keys[0]
    keygen_s, keygen_counts = time.time() - t0, read_counts()
    enc = bfv.Encoder(params, device=DEV)
    ev = bfv.Evaluator(params, device=DEV)
    encryptor = bfv.Encryptor(params, sk=sk, device=DEV, seed=22)
    msgs = np.random.default_rng(23).integers(0, t, (batch, n), dtype=np.uint64)
    cts = [encryptor.encrypt(enc.encode_uint(m)) for m in msgs]
    ct = bfv.Ciphertext([torch.stack([c.value[k] for c in cts]) for k in range(2)])
    dec = bfv.Decryptor(params, sk, device=DEV)
    turned = lambda k: np.concatenate([np.roll(msgs[:, :row], -k, 1), np.roll(msgs[:, row:], -k, 1)], 1)
    total = (msgs.astype(object).sum(axis=1) % t).astype(np.uint64)
    ops = {
        "rotate_columns_1": (lambda: ev.rotate_columns(ct, 1, rk), turned(1)),
        "rotate_columns_5": (lambda: ev.rotate_columns(ct, 5, rk), turned(5)),
        "rotate_rows": (lambda: ev.rotate_rows(ct, rk),
                        np.concatenate([msgs[:, row:], msgs[:, :row]], 1)),
        "inner_sum": (lambda: ev.inner_sum(ct, rk), np.repeat(total[:, None], n, 1)),
    }
    out = {}
    for name, (fn, want) in ops.items():
        reset_counts()
        done = []
        calls += record_calls(lambda: done.append(fn()))
        res, counts = done[0], read_counts()
        got = enc.decode_uint(dec.decrypt(res))
        if got.shape != (batch, n) or not (got == want).all():
            fail(f"rotate: {name} does not decrypt to the expected slots")
        ring_mod.FORCE_KERNEL = "plain"
        try:
            ref = fn()
        finally:
            ring_mod.FORCE_KERNEL = None
        if not _same(res, ref):
            fail(f"rotate: {name} differs from the all-plain route")
        del res, ref
        out[name] = dict(counts=counts, ms=time_ms(fn, reps=5),
                         device_ms=device_time(fn, count=HEAVY_GRAPH_CALLS))
        torch.cuda.empty_cache()
    counts = _sum_counts({k: v["counts"] for k, v in out.items()})
    if counts["ntt_mxu_fwd"] + counts["ntt_mxu_inv"] == 0:
        fail("rotate: the rotations never launched the four-step kernel")
    return dict(label=label, n=n, batch=[batch], keygen_s=keygen_s, keygen_counts=keygen_counts,
                rotation_keys=dict(left=sorted(rk.left), right=sorted(rk.right), row=rk.row is not None),
                ops=out, counts=counts, shapes=measure_calls(calls, label + " rotate"))


def _ct_same(a, b) -> bool:
    return a.scale == b.scale and _same(a, b)


def _on_cpu(share):
    return tuple(x.cpu() for x in share) if isinstance(share, tuple) else share.cpu()


def _shares_equal(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def phase_dckks() -> dict:
    """The 3-party encrypted two-layer sigmoid network over threshold CKKS
    at PN14QP438, stage by stage through ``entry_dckks_sigmoid``: each
    stage's seconds and kernel launches, the refresh split into its host
    big-integer masks and its device shares and recode; ``layer1`` and
    ``layer2`` timed (``ms``, ``device_ms``) and held against the all-plain
    route bit for bit (scales too); bytes on the wire per protocol; the
    output at a median of DCKKS_BITS["path"] bits against the sigmoids, and
    its bits against the two Chebyshev interpolants in float64.  Then, at
    the same set under the parties' summed key: CKS to a requester's secret
    key, the two-round relinearization key (one product), conjugation
    through the collective key, the refresh's device recode equal to the
    host big-integer one at the refresh's level and at level 0,
    ``encrypt_from_crp``, ``evaluate_poly_fast`` and ``evaluate_cheby_fast``,
    each decrypting to its DCKKS_BITS budget; and the codec bytes of shares
    made on the card equal to those of the same shares moved to the CPU.
    Every kernel is held against its plain version at every shape any of
    these gives it."""
    label = "PN14QP438 dCKKS"
    net = entry_dckks_sigmoid(device=DEV)
    params = net.params
    top, slots = params.max_level, params.slots
    seconds, counts, calls = {}, {}, []

    def stage(name, fn):
        reset_counts()
        out = []
        t0 = time.time()
        calls.extend(record_calls(lambda: out.append(fn())))
        seconds[name] = time.time() - t0
        counts[name] = read_counts()
        return out[0]

    pk = stage("ckg", net.ckg)
    rlk = stage("rkg", net.rkg)
    rot_keys = stage("rtg", net.rtg)
    cts = stage("encrypt", lambda: net.encrypt(pk))

    def layer1():
        return net.layer1(cts, rlk, rot_keys)

    t0 = time.time()
    layer1()  # also builds the tables
    torch.cuda.synchronize()
    first_s = {"layer1": time.time() - t0}
    hidden = stage("layer1", layer1)
    if hidden.level != top - 5:
        fail(f"dckks: layer1 left level {hidden.level}, expected {top - 5}")
    refresh = dckks.RefreshProtocol(params, device=DEV)
    masks = stage("refresh_masks", lambda: net.refresh_masks(refresh, hidden.level))
    fresh = stage("refresh_shares", lambda: net.refresh_finish(refresh, hidden, masks))
    if fresh.level != top or fresh.scale != hidden.scale:
        fail(f"dckks: the refresh gave level {fresh.level}, scale {fresh.scale}")

    def layer2():
        return net.layer2(fresh, rlk)

    t0 = time.time()
    layer2()
    torch.cuda.synchronize()
    first_s["layer2"] = time.time() - t0
    out = stage("layer2", layer2)
    sk_req, pk_req = stage("requester_key", net.requester_key)
    switched = stage("pcks", lambda: net.pcks(out, pk_req))
    got = stage("decrypt", lambda: net.decrypt(switched, sk_req))
    if got.shape != (slots,) or not np.isfinite(got).all():
        fail(f"dckks: the output decodes to {got.shape} with non-finite values")
    precision = dict(vs_sigmoid=median_bits(got, net.want()),
                     vs_chebyshev_float64=median_bits(got, net.want(exact=False)))
    if precision["vs_sigmoid"] < DCKKS_BITS["path"]:
        fail(f"dckks: median precision {precision['vs_sigmoid']:.2f} < {DCKKS_BITS['path']} bits")
    path_stages = list(counts)

    ring_mod.FORCE_KERNEL = "plain"
    try:
        refs = layer1(), layer2()
    finally:
        ring_mod.FORCE_KERNEL = None
    for name, ct, ref in (("layer1", hidden, refs[0]), ("layer2", out, refs[1])):
        if not _ct_same(ct, ref):
            fail(f"dckks: {name} differs from the all-plain route")
    del refs
    layers = {name: dict(ms=time_ms(fn, reps=5), device_ms=device_time(fn, count=HEAVY_GRAPH_CALLS))
              for name, fn in (("layer1", layer1), ("layer2", layer2))}
    for name, t in layers.items():
        if not isinstance(t["device_ms"], float):
            fail(f"dckks: {name} could not be timed on the device: {t['device_ms']}")
    layer1_ops = profile_ops(net, layer1)

    # the rest of dCKKS at the same set, under the parties' summed key
    enc, ev = net.enc, net.ev
    dec = ckks.Decryptor(params, net.sk_col, device=DEV)
    decode = lambda ct, d=dec: enc.decode(d.decrypt(ct))
    enc_sk = ckks.Encryptor(params, sk=net.sk_col, device=DEV, seed=23)
    rng = np.random.default_rng(17)
    values = lambda: rng.uniform(-1, 1, slots) + 1j * rng.uniform(-1, 1, slots)
    sks = [sk.sk for sk in net.sks]
    n_q = len(params.qi)

    def cks():
        sk_t = ckks.KeyGenerator(params, device=DEV, seed=999).gen_secret_key()
        v = values()
        ct = enc_sk.encrypt(enc.encode(v))
        proto = dckks.CKSProtocol(params, device=DEV)
        zero = torch.zeros_like(sk_t.sk)
        shares = [proto.gen_share(sk, zero if i else sk_t.sk, ct) for i, sk in enumerate(sks)]
        res = proto.key_switch(fold(proto, shares), ct)
        return median_bits(decode(res, ckks.Decryptor(params, sk_t, device=DEV)), v)

    def rkg_naive():
        proto = dckks.RKGProtocolNaive(params, device=DEV)
        r1 = fold(proto, [proto.gen_share_round_one(sk, pk) for sk in sks])
        r2 = fold(proto, [proto.gen_share_round_two(r1, sk, pk) for sk in sks])
        v0, v1 = values(), values()
        prod = ev.mul_relin(*[enc_sk.encrypt(enc.encode(v)) for v in (v0, v1)],
                            proto.gen_relinearization_key(r2))
        return median_bits(decode(prod), v0 * v1)

    def conjugate():
        v = values()
        return median_bits(decode(ev.conjugate(enc_sk.encrypt(enc.encode(v)), rot_keys)), np.conj(v))

    def refresh_recode():
        """finalize against finalize_bigint, from the refresh's level and from 0."""
        bits = {}
        for lvl in (hidden.level, 0):
            v = values()
            ct = ev.drop_level(enc_sk.encrypt(enc.encode(v)), top - lvl)
            proto = dckks.RefreshProtocol(params, device=DEV)
            crs = net.crp_gen.clock_poly()[:n_q]
            comb = fold(proto, [proto.gen_shares(sk, net.n_parties, ct, crs) for sk in sks])
            res = proto.finalize(ct, crs, comb)
            if res.level != top or not _ct_same(res, proto.finalize_bigint(ct, crs, comb)):
                fail(f"dckks: the refresh's device recode from level {lvl} differs from the "
                     "host big-integer one")
            bits[lvl] = median_bits(decode(res), v)
        return min(bits.values())

    def encrypt_from_crp():
        v = values()
        crp = net.crp_gen.clock_poly()
        ct = enc_sk.encrypt_from_crp(enc.encode(v), crp)
        want_c1 = ev.ctx.basis_q_p.mod_down_split_pq(*[ev.ctx.ring_qp.intt(crp)[s] for s in
                                                      (slice(0, n_q), slice(n_q, None))])
        if not torch.equal(ct.value[1], ev.ctx.ring_q.ntt(want_c1)):
            fail("dckks: the c1 of encrypt_from_crp is not the CRP divided by P")
        return median_bits(decode(ct), v)

    def evaluate_poly_fast():
        v = rng.uniform(-0.9, 0.9, slots)
        res = ckks.evaluate_poly_fast(ev, enc_sk.encrypt(enc.encode(v)), [0, 1.0, 0, -1.0 / 6], rlk)
        return median_bits(decode(res), v - v**3 / 6)

    def evaluate_cheby_fast():
        v = rng.uniform(-0.95, 0.95, slots)
        cheby = ckks.approximate(lambda x: complex(math.exp(x.real), 0), -1, 1, 7)
        res = ckks.evaluate_cheby_fast(ev, enc_sk.encrypt(enc.encode(v)), cheby, rlk)
        return median_bits(decode(res), np.exp(v))

    checks = {}
    for name, fn in (("cks", cks), ("rkg_naive", rkg_naive), ("conjugate", conjugate),
                     ("refresh", refresh_recode), ("encrypt_from_crp", encrypt_from_crp),
                     ("evaluate_poly_fast", evaluate_poly_fast),
                     ("evaluate_cheby_fast", evaluate_cheby_fast)):
        checks[name] = stage(name, fn)
        if checks[name] < DCKKS_BITS[name]:
            fail(f"dckks: {name} has median precision {checks[name]:.2f} < {DCKKS_BITS[name]} bits")

    def codecs():
        """Shares made on the card: their bytes equal those of the same shares
        moved to the CPU, and come back from bytes on the card unchanged."""
        crp = net.crp_gen.clock_polys(params.beta())
        rkg = dckks.RKGProtocol(params, device=DEV)
        made = {
            "ckg": (dckks.CKGProtocol(params, device=DEV).gen_share(sks[0], crp[0]),),
            "rkg_round1": (rkg.gen_share_round_one(rkg.new_ephemeral_key(), sks[0], crp),),
            "rtg": (1, ser.ROTATION_LEFT, dckks.RTGProtocol(params, device=DEV).gen_share(
                "left", 1, sks[0], crp)),
            "pcks": (dckks.PCKSProtocol(params, device=DEV).gen_share(sks[0], pk_req, out),),
            "refresh": (refresh.gen_shares(sks[0], net.n_parties, hidden, crp[0][:n_q]),),
        }
        sizes = {}
        for codec, args in made.items():
            to_bytes = getattr(ser, codec + "_share_to_bytes")
            data = to_bytes(*args)
            if data != to_bytes(*args[:-1], _on_cpu(args[-1])):
                fail(f"dckks: the {codec} share's bytes differ between the card and the CPU")
            back = getattr(ser, codec + "_share_from_bytes")(data, DEV)
            if not _shares_equal(back[-1] if codec == "rtg" else back, args[-1]):
                fail(f"dckks: the {codec} share does not come back from its bytes")
            sizes[codec] = len(data)
        return sizes

    codec_bytes = stage("codecs", codecs)
    path_counts = _sum_counts({k: counts[k] for k in path_stages})
    for name in ("ntt_tile", "ntt_mxu"):
        if path_counts[name + "_fwd"] + path_counts[name + "_inv"] == 0:
            fail(f"dckks: the path never launched {name}")
    return dict(label=label, n=params.n, slots=slots, parties=net.n_parties,
                crp_walk=native.walk_route(), setup_s=seconds, first_s=first_s,
                refresh_host_s=seconds["refresh_masks"], refresh_device_s=seconds["refresh_shares"],
                layers=layers, layer1_ops=layer1_ops, wire_bytes=net.wire_bytes,
                precision_bits=precision, checks=checks,
                codec_bytes=codec_bytes, stage_counts=counts, counts=path_counts,
                all_counts=_sum_counts(counts), shapes=measure_calls(calls, label))


# (ranks, backend, CKKS set of weak_scaling_mul, its name, ciphertexts a
# rank, timed steps, rows of each sharded PIR at PN13QP218)
WORLDS = ((4, "gloo", ckks.PN12QP109, "PN12QP109", 4, 10, (8, 64)),
          (1, "nccl", ckks.PN16QP1761, "PN16QP1761", 8, 5, (8,)))
PIR_CALLS = 4  # sharded cloud calls on each rank; the first captures its program


def pir_inputs(n_rows: int) -> dict:
    """The 3-party PIR at PN13QP218 with ``n_rows`` rows up to the cloud
    step (keys, encrypted rows and query, masks) on DEV, and the unsharded
    compiled cloud on them: the result a sharded cloud must equal, and its
    replayed ``ms``."""
    pir = entry_dbfv_pir(device=DEV, n_rows=n_rows)
    pk, rlk, rot_keys = pir.ckg(), pir.rkg(), pir.rtg()
    args = (*pir.encrypt(pk), rlk, rot_keys)
    want = pir.compiled_cloud(*args)
    ms = event_ms(lambda: pir.compiled_cloud(*args), reps=5, warmup=1)
    return dict(pir=pir, args=args, want=[u.to_u64(p) for p in want.value], unsharded_ms=ms)


def sharded_pir(world, inputs: dict, label: str) -> tuple[dict, list, list]:
    """``DbfvPir.sharded_cloud`` on ``world``, PIR_CALLS calls a rank: every
    rank's result bit-equal to the unsharded compiled cloud on the same
    inputs, the result switched to the requester's key (CKS) decrypting to
    the wanted row, ntt_tile and ntt_mxu launched on every rank.  Returns
    its record (by rank: the replayed ``ms`` of the partial program, the
    fold across the ranks and the relinearization, medians of the calls
    after the first; the first call's seconds, capture included; peak
    memory; launches by kernel and stage of the first call; its distinct
    transforms and their routes), each rank's launches and transforms."""
    pir = inputs["pir"]
    t0 = time.time()
    r = pir.sharded_cloud(world, *inputs["args"], calls=PIR_CALLS)
    seconds = time.time() - t0
    for rank, out in enumerate(r["ranks"]):
        if not all(np.array_equal(a, b) for a, b in zip(out["result"], inputs["want"])):
            fail(f"{label}: rank {rank}'s sharded cloud differs from the unsharded compiled cloud")
    sk_req = pir.requester_key()
    if not (pir.decrypt(pir.cks(r["result"], sk_req), sk_req) == pir.rows[pir.wanted]).all():
        fail(f"{label}: the sharded cloud does not retrieve row {pir.wanted}")
    ms = lambda xs: statistics.median(xs) * 1e3
    ranks = []
    for rank, out in enumerate(r["ranks"]):
        s = out["seconds"]
        c = _sum_counts(out["counts"])
        for name in ("ntt_tile", "ntt_mxu"):
            if c[name + "_fwd"] + c[name + "_inv"] == 0:
                fail(f"{label}: rank {rank} never launched {name}: {out['counts']}")
        ranks.append(dict(
            rows=out["rows"], partial_ms=ms(s["partial"][1:]), fold_ms=ms(s["fold"][1:]),
            relinearize_ms=ms(s["relinearize"][1:]),
            cloud_ms=ms([sum(v[i] for v in s.values()) for i in range(1, PIR_CALLS)]),
            first_call_s={k: v[0] for k, v in s.items()}, peak_bytes=out["peak_bytes"],
            counts=c, stage_counts=out["counts"],
            transforms=[[list(shape), list(limbs), inverse, route]
                        for _, shape, limbs, inverse, route in out["transforms"]]))
    return (dict(rows=pir.n_rows, ranks=len(ranks), calls=PIR_CALLS, sharded_cloud_s=seconds,
                 unsharded_compiled_ms=inputs["unsharded_ms"], by_rank=ranks),
            [x["counts"] for x in ranks], [out["transforms"] for out in r["ranks"]])


def phase_parallel() -> dict:
    """The multi-rank layer on the card, in two worlds: 4 party ranks over
    gloo on the one card (every rank on cuda:0, gloo staging tensors
    through the host) and 1 rank over NCCL.  In each, ``dryrun_multichip``
    at PN12QP109 with its own checks (exact decryption of every stage, the
    cross-rank NTT against ``ring_q.ntt`` / ``intt``, the step inside
    ``sharded_ntt`` equal to the unsharded one with no kernel launched,
    every rank's keys and ciphertexts equal), seconds and launches by rank
    and stage; then ``weak_scaling_mul``: at CKKS PN12QP109 on the 4 gloo
    ranks (one card: its throughput, not a scaling number), at CKKS
    PN16QP1761 with 8 ciphertexts on the NCCL rank (the long-row kernel's
    shapes); and between them the 3-party PIR at PN13QP218 with its rows
    sharded over the world's ranks (``sharded_pir``: 8 rows in both worlds,
    64 on the gloo ranks), against the unsharded compiled cloud made in this
    process beforehand.  Every kernel is held against its plain version at
    every shape a rank gave it."""
    label = "parallel"
    worlds, scaling_runs, counts, transforms, pir_runs = {}, {}, [], set(), {}
    pirs = {n_rows: pir_inputs(n_rows) for n_rows in sorted({r for w in WORLDS for r in w[6]})}
    for n, backend, idx, name, batch, iters, pir_rows in WORLDS:
        t0 = time.time()
        with launch.World(n, backend, "cuda") as world:
            spawn_s = time.time() - t0
            t0 = time.time()
            r = dryrun_multichip(n, device=DEV, backend=backend, world=world)
            dryrun_s = time.time() - t0
            per_rank = [_sum_counts(c) for c in r["counts"]]
            for rank, c in enumerate(per_rank):
                if not (c["ntt_tile_fwd"] + c["ntt_tile_inv"]) or not (c["ntt_mxu_fwd"] + c["ntt_mxu_inv"]):
                    fail(f"parallel: rank {rank} of the {backend} world launched {c}")
            counts += per_rank
            for ts in r["transforms"]:
                transforms.update(ts)
            worlds[f"{backend}_{n}"] = dict(
                ok=r["ok"], spawn_s=spawn_s, dryrun_s=dryrun_s, stage_seconds=r["seconds"],
                stage_counts=r["counts"], rank_counts=per_rank, digests=r["digests"])
            for n_rows in pir_rows:
                key = f"{n_rows}_rows_{backend}_{n}"
                rec, per_rank, ts = sharded_pir(world, pirs[n_rows], f"parallel_pir {key}")
                if n > 1:
                    rec["note"] = (f"{n} ranks share one card, gloo staging the fold through the "
                                   "host: its throughput, not a scaling number")
                pir_runs[key] = rec
                counts += per_rank
                for t in ts:
                    transforms.update(t)
            t0 = time.time()
            outs = world.run(launch.traced, scaling.weak_scaling_mul, ckks.default_params(idx),
                             None, batch, iters)
        rates = outs[0][0]
        if any(not (math.isfinite(v) and v > 0) for v in rates.values()):
            fail(f"parallel: weak_scaling_mul at {name} gave {rates}")
        per_rank = [o[1] for o in outs]
        counts += per_rank
        for o in outs:
            transforms.update(o[2])
        scaling_runs[f"{name}_{backend}_{n}"] = dict(
            ct_mults_per_s={str(k): v for k, v in rates.items()}, ranks=n, backend=backend,
            batch_per_rank=batch, iters=iters, seconds=time.time() - t0, rank_counts=per_rank,
            note=f"{n} ranks share one card: its throughput, not a scaling number" if n > 1 else None)
    total = _sum_counts(dict(enumerate(counts)))  # over ranks
    if total["ntt_passes_fwd"] + total["ntt_passes_inv"] == 0:
        fail("parallel: weak_scaling_mul at PN16QP1761 never launched the long-row kernel")
    del pirs
    return dict(label=label, worlds=worlds, scaling=scaling_runs, counts=total,
                shapes=measure_calls(rank_calls(sorted(transforms)), label),
                pir=dict(label="PN13QP218", parties=3, runs=pir_runs))


def phase_examples() -> dict:
    """The example twins on the card: ride hailing at log N = 12 (2048
    taxis), every distance exact; the CKKS sigmoid at log N = 14 (8192
    slots) above SIGMOID_BITS median bits; the 3-party PIR at PN13QP218
    through ``examples.dbfv_pir`` (its cloud step one compiled program), the
    row exact; the 3-party set intersection at PN13QP218 stage by stage
    (keygen, encrypt, AND chain, PCKS, decrypt), the intersection exact,
    and the ``OpProfiler`` table of one extra, untimed AND chain.  Seconds
    and launches of each; every kernel held against its plain version at
    every shape they give it."""
    label = "examples"
    calls = []
    reset_counts()
    out = []
    calls += record_calls(lambda: out.append(bfv_riding.ride(12, DEV)))
    ride = out[0]
    ride["counts"] = read_counts()
    if not ride["ok"] or ride["n_taxis"] != 2048:
        fail(f"examples: ride hailing at log N = 12 is not exact ({ride['n_taxis']} taxis)")
    reset_counts()
    calls += record_calls(lambda: out.append(ckks_sigmoid.sigmoid(14, DEV)))
    sig = {k: v for k, v in out[-1].items() if k not in ("values", "got")}
    sig["counts"] = read_counts()
    if not sig["bits"] > SIGMOID_BITS or sig["slots"] != 8192:
        fail(f"examples: the CKKS sigmoid at log N = 14 has {sig['bits']:.2f} median bits")
    reset_counts()
    calls += record_calls(lambda: out.append(dbfv_pir.retrieve(3, 13, DEV)))
    pir = out[-1]
    pir["counts"] = read_counts()
    if not pir["ok"] or pir["n"] != 8192 or pir["compiled_programs"] != 1 or pir["ranks"] != 1:
        fail(f"examples: the PIR at PN13QP218 is not exact through its compiled cloud {pir}")

    psi = dbfv_psi.Psi(3, 13, DEV)
    seconds, stage_counts = {}, {}

    def stage(name, fn):
        reset_counts()
        res = []
        t0 = time.time()
        calls.extend(record_calls(lambda: res.append(fn())))
        seconds[name] = time.time() - t0
        stage_counts[name] = read_counts()
        return res[0]

    pk, rlk = stage("keygen", psi.keygen)
    cts = stage("encrypt", lambda: psi.encrypt(pk))
    acc = stage("and_chain", lambda: psi.and_chain(cts, rlk))
    switched, sk_out = stage("pcks", lambda: psi.pcks(acc))
    got = stage("decrypt", lambda: psi.decrypt(switched, sk_out))
    want = psi.want()
    if got.shape != (psi.params.n,) or not (got == want).all():
        fail("examples: the set intersection at PN13QP218 is not exact")
    and_ops = profile_ops(psi, lambda: psi.and_chain(cts, rlk))
    counts = _sum_counts({"ride": ride["counts"], "sigmoid": sig["counts"], "pir": pir["counts"],
                          **stage_counts})
    for name in ("ntt_tile", "ntt_mxu"):
        if counts[name + "_fwd"] + counts[name + "_inv"] == 0:
            fail(f"examples: the examples never launched {name}")
    return dict(label=label, ride=ride, sigmoid=sig, pir=pir,
                psi=dict(n=psi.params.n, parties=3, elements=int(want.sum()), setup_s=seconds,
                         stage_counts=stage_counts, and_chain_ops=and_ops),
                counts=counts, shapes=measure_calls(calls, label))


def _leaves(tree) -> list:
    return tree_flatten(tree)[0]


def _trees_equal(a, b) -> bool:
    """Equal structure, equal static leaves, tensors equal bit for bit."""
    (la, da), (lb, db) = tree_flatten(a), tree_flatten(b)
    return da == db and len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


def run_jit(label: str, eager, compiled, args_a: tuple, args_b: tuple, reps: int = 5) -> dict:
    """One compiled program against its eager function: the first call
    (warm-up + capture) timed as ``capture_s``, with the launches it made
    (each graph holds half: the warm-up made the other half) and the
    transforms it gave each kernel; a replay on the content-distinct
    ``args_b`` (no launch may reach a wrapper); both results and a second
    replay on ``args_a`` equal to the eager calls bit for bit, and the first
    result unchanged by the later calls.  Peak device memory of the eager
    call, of the first call and of a replay (above what was allocated
    before each); ``ms`` (one call between CUDA events) eager and replayed,
    ``device_ms`` of the eager call (CUDA graph); ``copy_in_ms``: the time
    to copy every tensor of ``args_a`` into buffers, which a call of one
    program does before its replay."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = []
    calls = record_calls(lambda: out.append(compiled(*args_a)))
    capture_s = time.perf_counter() - t0
    first = read_counts()
    peak_capture = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    out_a = out[0]
    snap = copy_tree(out_a)
    if any(v % 2 for v in first.values()):
        fail(f"jit {label}: the first call made an odd number of launches {first}")
    captured = {k: v // 2 for k, v in first.items()}

    reset_counts()
    out_b = compiled(*args_b)
    torch.cuda.synchronize()
    if sum(read_counts().values()):
        fail(f"jit {label}: a replay reached a kernel wrapper: {read_counts()}")

    torch.cuda.reset_peak_memory_stats()
    base_e = torch.cuda.memory_allocated()
    reset_counts()
    eager_a = eager(*args_a)
    torch.cuda.synchronize()
    eager_counts = read_counts()
    peak_eager = torch.cuda.max_memory_allocated() - base_e
    eager_b = eager(*args_b)
    torch.cuda.reset_peak_memory_stats()
    base_r = torch.cuda.memory_allocated()
    out_a2 = compiled(*args_a)
    torch.cuda.synchronize()
    peak_replay = torch.cuda.max_memory_allocated() - base_r
    for name, got, want in (("first call", out_a, eager_a), ("replay on other inputs", out_b,
                            eager_b), ("second replay", out_a2, eager_a)):
        if not _trees_equal(got, want):
            fail(f"jit {label}: the {name} differs from the eager call")
    if not _trees_equal(out_a, snap):
        fail(f"jit {label}: a later call changed the first call's result")
    if any(x is y for x, y in zip(_leaves(out_a), _leaves(out_a2)) if isinstance(x, torch.Tensor)):
        fail(f"jit {label}: two calls returned the same tensor")
    del eager_b, out_b, out_a2, snap
    ms_eager = event_ms(lambda: eager(*args_a), reps=reps, warmup=1)
    ms_replay = event_ms(lambda: compiled(*args_a), reps=reps, warmup=1)
    tensors = [t for t in _leaves(args_a) if isinstance(t, torch.Tensor)]
    bufs = [torch.empty_like(t) for t in tensors]
    copy_in_ms = event_ms(lambda: [b.copy_(t) for b, t in zip(bufs, tensors)], reps=reps)
    del bufs
    fields = dict(label=label, capture_s=capture_s, ms_eager=ms_eager, ms=ms_replay,
                  copy_in_ms=copy_in_ms, copy_in_bytes=sum(t.numel() * 8 for t in tensors),
                  device_ms=device_time(lambda: eager(*args_a), count=HEAVY_GRAPH_CALLS),
                  first_call_counts=first, counts=captured, eager_counts=eager_counts,
                  peak_eager_bytes=peak_eager, peak_capture_bytes=peak_capture,
                  peak_replay_bytes=peak_replay, held_after_capture_bytes=held)
    return fields, calls, out_a


def phase_jit():
    """``tjit`` programs (captured CUDA graphs) against their eager calls:
    ``tjit(forward)`` at PN12QP109, the PIR cloud step at PN13QP218 x 8
    rows, the PSI AND chain at PN13QP218 (3 parties), and bench.py's
    degree-31 Chebyshev at PN15QP880 through ``JitEvaluator``
    (``entry_cheby31``), each through ``run_jit`` and decrypted: the
    product and the retrieved row exact, the intersection exact, the
    Chebyshev at JIT_BITS median bits or more against its float64
    interpolant.  For the Chebyshev also evaluations per second over
    content-distinct ciphertexts, the ring's LRU cache flooded with
    OP_CACHE_SIZE + 16 new scalar columns after a fresh evaluator's
    capture, then its replay equal to eager (the programs keep the tables
    they read alive), the programs
    (``op_traces``) and replays, and the time to copy its relinearization
    key into a ``mul_relin`` program's buffer.  Every
    kernel held against its plain version at every shape the first calls
    gave it (timed: the largest of each kernel and direction).  Yields one
    result a program, as it is done."""

    def finish(fields, calls, kernels, **more) -> dict:
        for name in kernels:
            if fields["counts"][name + "_fwd"] + fields["counts"][name + "_inv"] == 0:
                fail(f"jit {fields['label']}: no graph holds a launch of {name}")
        torch.cuda.synchronize()
        return dict(fields, kernels=kernels, shapes=measure_calls(
            calls, fields["label"], largest_only=True), **more)

    forward, (ct0, ct1, swk) = entry(device=DEV)
    params = bfv.default_params(bfv.PN12QP109)
    compiled = tjit(forward)
    r, calls, res = run_jit("PN12QP109 forward", forward, compiled, (ct0, ct1, swk),
                            (ct1, ct0, swk))
    enc = bfv.Encoder(params, device=DEV)
    m = np.arange(params.n, dtype=np.uint64) % params.t
    got = enc.decode_uint(bfv.Decryptor(params, forward.secret_key, device=DEV).decrypt(res))
    if not (got == m * m[::-1] % np.uint64(params.t)).all():
        fail("jit: the replayed forward does not decrypt to m * m[::-1] mod t")
    yield finish(r, calls, ("ntt_tile", "ntt_mxu"), op_traces=compiled.trace_count(),
                 replays=compiled.replays)

    pir = entry_dbfv_pir(device=DEV)
    pk, rlk, rot_keys = pir.ckg(), pir.rkg(), pir.rtg()
    query, rows, masks = pir.encrypt(pk)
    rolled = bfv.Ciphertext([torch.roll(p, 1, 0) for p in rows.value])
    r, calls, res = run_jit("PN13QP218 PIR cloud", pir.cloud, pir.compiled_cloud,
                            (query, rows, masks, rlk, rot_keys),
                            (query, rolled, masks, rlk, rot_keys))
    sk_req = pir.requester_key()
    if not (pir.decrypt(pir.cks(res, sk_req), sk_req) == pir.rows[pir.wanted]).all():
        fail(f"jit: the replayed PIR cloud does not retrieve row {pir.wanted}")
    yield finish(r, calls, ("ntt_tile", "ntt_mxu"), op_traces=pir.compiled_cloud.trace_count(),
                 replays=pir.compiled_cloud.replays)
    del pir, pk, rlk, rot_keys, query, rows, masks, rolled

    psi = dbfv_psi.Psi(3, 13, DEV)
    pk, rlk = psi.keygen()
    cts = psi.encrypt(pk)
    r, calls, res = run_jit("PN13QP218 PSI AND chain", psi.and_chain, psi.compiled_and_chain,
                            (cts, rlk), (cts[::-1], rlk))
    if not (psi.decrypt(*psi.pcks(res)) == psi.want()).all():
        fail("jit: the replayed AND chain does not decrypt to the intersection")
    yield finish(r, calls, ("ntt_tile", "ntt_mxu"),
                 op_traces=psi.compiled_and_chain.trace_count(),
                 replays=psi.compiled_and_chain.replays)
    del psi, pk, rlk, cts

    ch = entry_cheby31(device=DEV)
    sk, pk, rlk = ch.keygen()
    cts = rolled_variants(ch.encrypt(pk), 4)
    eager_ev = ckks.Evaluator(ch.params, device=DEV)
    ring = ch.ctx.ring_q
    r, calls, res = run_jit("PN15QP880 Chebyshev", lambda c: ch.evaluate(c, rlk, ev=eager_ev),
                            lambda c: ch.evaluate(c, rlk), (cts[0],), (cts[1],), reps=3)
    jops = ch.ev._jops
    got = ch.decrypt(res, sk)
    if got.shape != (ch.params.slots,) or not np.isfinite(got).all():
        fail(f"jit: the Chebyshev decodes to {got.shape} with non-finite values")
    bits = dict(vs_chebyshev_float64=median_bits(got, ch.want(exact=False)),
                vs_sigmoid=median_bits(got, ch.want()))
    if bits["vs_chebyshev_float64"] < JIT_BITS:
        fail(f"jit: the Chebyshev has {bits['vs_chebyshev_float64']:.2f} median bits against "
             f"its interpolant, < {JIT_BITS}")
    replays0 = {k: f.replays for k, f in jops.items()}  # a replay: one op call
    t0 = time.perf_counter()
    for c in cts[1:]:
        ch.evaluate(c, rlk)
    torch.cuda.synchronize()
    per_eval = (time.perf_counter() - t0) / (len(cts) - 1)
    k0, k1 = rlk.evakey.key0, rlk.evakey.key1
    b0, b1 = torch.empty_like(k0), torch.empty_like(k1)
    key_copy_ms = event_ms(lambda: (b0.copy_(k0), b1.copy_(k1)), reps=20)
    del b0, b1

    # The flood: programs must keep alive the tables they read.  The
    # warm-ups above ran on side streams, whose freed blocks the caching
    # allocator hands to no allocation on this stream; so an eager
    # evaluation builds the tables again on this stream, a fresh
    # evaluator's programs capture them, and the flood evicts them.
    ring._op_cache.clear()
    want = ch.evaluate(cts[0], rlk, ev=eager_ev)
    fresh = ckks.JitEvaluator(ch.params, device=DEV)
    ch.evaluate(cts[0], rlk, ev=fresh)
    held = {id(t) for f in fresh._jops.values() for p in f._cache.values() for t in p.tables}
    before = {id(v) for v in ring._op_cache.values()}
    for i in range(ring_mod.OP_CACHE_SIZE + 16):
        ring.mul_scalar(cts[0].value[0], 10**9 + i)
    after = {id(v) for v in ring._op_cache.values()}
    evicted = sum(1 for k in held if k in before and k not in after)
    if evicted == 0:
        fail("jit: the flood evicted no table a program reads")
    if not _trees_equal(ch.evaluate(cts[0], rlk, ev=fresh), want):
        fail("jit: after the LRU flood the replayed Chebyshev differs from eager")
    del fresh, want
    yield finish(
        r, calls, ("ntt_mxu", "ntt_passes"), op_traces=ch.op_traces(),
        programs={k: f.trace_count() for k, f in jops.items()},
        replays=sum(f.replays for f in jops.values()),
        replays_an_evaluation={k: (f.replays - replays0[k]) // (len(cts) - 1)
                               for k, f in jops.items()},
        evals_per_s=1 / per_eval, slots_per_s=ch.params.slots / per_eval, level=res.level,
        precision_bits=bits, key_bytes=2 * k0.numel() * 8, key_copy_ms=key_copy_ms,
        flood=dict(keys=ring_mod.OP_CACHE_SIZE + 16, held_tables=len(held),
                   evicted_held_tables=evicted))


def _find_call(calls, moduli, shape, inverse, route):
    for c in calls:
        if (tuple(c[0].moduli), c[1], c[3], c[4]) == (tuple(moduli), tuple(shape), inverse, route):
            return c
    fail(f"bench: no {route} transform of {list(shape)} (inverse {inverse}) was made")


def phase_bench() -> dict:
    """The twin of bench.py (``lattigo_tpu_torch.bench``) on the card with
    every config but BENCH_SKIP: each config must emit its metrics (bench.py's
    names) as finite positive numbers; its own checks ran (the headline bit
    for bit against the plain schedule and through its inverse; BFV exact;
    CKKS at 12 median bits; two replays of a keyed CKG share program differ
    and still decrypt exactly; the 8-party stacked shares' noise differs
    party by party, its PCKS and Refresh exact).  Every kernel held against
    its plain version at every shape the run gave it (the largest of each
    kernel and direction timed), and the new shapes timed for the kernels
    line: the headline ``[1024, 2, 8192]`` (four-step, both directions), the
    single-ciphertext ``[2, 8192]`` (row) and the largest PN16QP1761
    single-ciphertext transforms (long-row)."""
    label = "bench"
    recs = []
    torch.cuda.synchronize()
    t0 = time.time()
    reset_counts()
    with contextlib.redirect_stdout(sys.stderr):  # the headline's bare line
        calls = record_calls(lambda: recs.extend(port_bench.run(DEV, skip=BENCH_SKIP)))
    run_s = time.time() - t0
    counts = read_counts()
    want = [m for k, ms in port_bench.METRICS.items() if k not in BENCH_SKIP for m in ms]
    got = [r["metric"] for r in recs]
    if got != want:  # each value was checked finite and positive by the run
        fail(f"bench: the configs emitted {got}, not {want}")
    by = {r["metric"]: r for r in recs}
    fresh = by["dbfv_ckg_gen_pn12qp109"]["fresh_noise"]
    if not (fresh["replays_differ"] and fresh["replayed_key_decrypts"]):
        fail(f"bench: keyed replays {fresh}")
    party = by["dbfv_8party_ckg_pcks_refresh_pn12qp109"]
    if party["party_noise_distinct_pairs"] != 28 or not party["pcks_and_refresh_exact"]:
        fail(f"bench: the 8-party shares {party}")
    for name in KERNELS:
        if counts[name + "_fwd"] == 0:
            fail(f"bench: the bench never launched {name}")
    shapes = measure_calls(calls, label, largest_only=True)
    pn16 = ckks.default_params(ckks.PN16QP1761)
    passes = [c for c in calls if c[4] == "passes" and c[0].n == pn16.n]
    named = [_find_call(calls, port_bench.GOLDEN_60, (1024, 2, 8192), False, "mxu"),
             _find_call(calls, port_bench.GOLDEN_60, (1024, 2, 8192), True, "mxu"),
             _find_call(calls, port_bench.GOLDEN_60, (2, 8192), False, "tile")]
    for inverse in (False, True):
        mine = [c for c in passes if c[3] == inverse]
        if not mine:
            fail(f"bench: no PN16QP1761 transform on the long-row kernel (inverse {inverse})")
        named.append(max(mine, key=lambda c: int(np.prod(c[1]))))
    rows = []
    for i, (ring, shape, limbs, inverse, route) in enumerate(named):
        name = ROUTE_KERNEL[route]
        key = (tuple(ring.moduli), shape, limbs, inverse, route)
        if key not in MEASURED:
            r = measure_shape(name, ring, shape, limbs, inverse, seed=3000 + i)
            if r["max_abs_err"] != 0:
                fail(f"bench: {name} disagrees with its plain version at {shape}")
            r.update(kernel=name, measured_by=label,
                     other_kernels=cross_time(name, ring, shape, limbs, inverse, seed=4000 + i))
            MEASURED[key] = r
            torch.cuda.empty_cache()
        rows.append(dict(MEASURED[key], calls=sum(1 for c in calls if c[0] is ring
                                                   and c[1:] == (shape, limbs, inverse, route))))
    return dict(label=label, run_s=run_s, skipped=list(BENCH_SKIP), records=recs,
                counts=counts, shapes=shapes, named_shapes=rows)


def phase_profile(make, label: str) -> None:
    """One ``forward`` under torch.profiler: wall time, the device's busy
    time (sum of kernel self times), its idle share, and the kernels that
    take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    forward, args = make()
    for _ in range(2):
        forward(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forward(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        fail("torch.profiler recorded no device time")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    emit("profile", label=label, traced_forward_ms=wall_ms,
         device_busy_ms=busy_ms, device_idle_share=max(0.0, 1 - busy_ms / wall_ms),
         kernel_launches=sum(e.count for e in kernels),
         top=[dict(name=e.key[:60], ms=e.self_device_time_total / 1e3, count=e.count) for e in top])


def kernel_rows(res: dict, names) -> list[dict]:
    """The summary rows of kernels ``names`` from one path's run: for each
    kernel and direction the largest shape the run gave it, with the
    launches of that path's forward."""
    out = []
    for name in names:
        k = KERNELS[name]
        for inverse, tag in ((False, "_fwd"), (True, "_inv")):
            mine = [s for s in res["shapes"] if s["kernel"] == name and s["inverse"] == inverse]
            if not mine:
                continue
            s = max(mine, key=lambda s: int(np.prod(s["shape"])))
            out.append(dict(
                name=name + tag, route=k["route"], source=k["source"], replaces=k["replaces"],
                launches=res["counts"][name + tag], max_abs_err=max(m["max_abs_err"] for m in mine),
                ms=s["ms"], plain_ms=s["plain_ms"], bound_ms=s["bound_ms"], bound_by=s["bound_by"],
                library_ms=None, path=res["label"], shape=s["shape"], limbs=s["limbs"],
                device_ms=s["device_ms"], other_kernels=s["other_kernels"],
                **{k: s[k] for k in ("baseline_ms", "baseline_device_ms", "host_us") if k in s},
            ))
    return out


def main() -> None:
    global BASELINE, BASELINE_ROW
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="device,build,kernels,small,main_path,full_width,ckks,bfv15,dbfv,"
                            "rotate,dckks,parallel,examples,bench,jit")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--verbose-build", action="store_true")
    ap.add_argument("--baseline-passes", default=None)
    ap.add_argument("--baseline-row", default=None)
    args = ap.parse_args()
    phases = args.phases.split(",")
    torch.cuda.set_device(DEV)

    gpu = phase_device()
    if "build" in phases:
        phase_build(args.verbose_build)
    if args.baseline_passes:
        BASELINE = build_baseline(args.baseline_passes, "ntt_passes")
        emit("baseline", source=args.baseline_passes)
    if args.baseline_row:
        BASELINE_ROW = build_baseline(args.baseline_row, "ntt_row")
        emit("baseline", source=args.baseline_row)
    if "kernels" in phases:
        phase_kernels()
    if "small" in phases:
        emit("small", **phase_small())
    summary = []
    if "main_path" in phases:
        res = drive(bfv.PN12QP109, (), "PN12QP109")
        emit("main_path", **res)
        if res["counts"] != {"ntt_tile_fwd": 1, "ntt_tile_inv": 2, "ntt_mxu_fwd": 6,
                             "ntt_mxu_inv": 2, "ntt_passes_fwd": 0, "ntt_passes_inv": 0}:
            fail(f"launch counts of one forward are {res['counts']}, expected 8 four-step and 3 row")
        summary += kernel_rows(res, ("ntt_tile", "ntt_mxu"))
    if "full_width" in phases:
        res = drive(bfv.PN14QP438, (args.batch,), "PN14QP438")
        emit("full_width", **res)
        if sum(res["counts"].values()) == 0:
            fail("the full-width forward launched no kernel")
        if "main_path" not in phases:
            summary += kernel_rows(res, ("ntt_tile", "ntt_mxu"))
    if "ckks" in phases:
        res = phase_ckks()
        emit("ckks", **res)
        summary += kernel_rows(res, ("ntt_passes",))
        torch.cuda.empty_cache()
    if "bfv15" in phases:
        res = drive(bfv.PN15QP880, (), "PN15QP880")
        emit("bfv15", **res)
        passes = res["counts"]["ntt_passes_fwd"] + res["counts"]["ntt_passes_inv"]
        setup = res["setup_and_first_forward_counts"]
        if passes + setup["ntt_passes_fwd"] + setup["ntt_passes_inv"] == 0:
            fail("PN15QP880: the long-row kernel was never launched")
    if "dbfv" in phases:
        res = phase_dbfv()
        emit("dbfv", **res)
        summary += kernel_rows(res, ("ntt_tile", "ntt_mxu"))
        torch.cuda.empty_cache()
    if "rotate" in phases:
        res = phase_rotate(args.batch)
        emit("rotate", **res)
        summary += kernel_rows(res, ("ntt_mxu",))
        torch.cuda.empty_cache()
    if "dckks" in phases:
        res = phase_dckks()
        emit("dckks", **res)
        summary += kernel_rows(res, ("ntt_tile", "ntt_mxu"))
        torch.cuda.empty_cache()
    if "parallel" in phases:
        res = phase_parallel()
        pir = res.pop("pir")
        emit("parallel", **res)
        emit("parallel_pir", **pir)
        summary += kernel_rows(res, ("ntt_tile", "ntt_mxu", "ntt_passes"))
        torch.cuda.empty_cache()
    if "examples" in phases:
        res = phase_examples()
        emit("examples", **res)
        summary += kernel_rows(res, ("ntt_tile", "ntt_mxu"))
        torch.cuda.empty_cache()
    if "bench" in phases:
        res = phase_bench()
        emit("bench", **{k: v for k, v in res.items() if k != "named_shapes"})
        summary += kernel_rows(dict(res, shapes=res["named_shapes"]), tuple(KERNELS))
        torch.cuda.empty_cache()
    if "jit" in phases:
        for res in phase_jit():
            emit("jit", **{k: v for k, v in res.items() if k != "kernels"})
            summary += kernel_rows(res, res["kernels"])
        torch.cuda.empty_cache()
    if "profile" in phases:
        phase_profile(lambda: entry(device=DEV), "PN12QP109")
        phase_profile(lambda: entry(device=DEV, params_idx=bfv.PN14QP438, batch=(args.batch,)),
                      f"PN14QP438 x {args.batch}")
        phase_profile(lambda: entry_ckks(device=DEV, batch=(CKKS_BATCH,)),
                      f"PN16QP1761 x {CKKS_BATCH}")
    if summary:
        for k in summary:
            if k["launches"] < 1:
                fail(f"the main path never launched {k['name']}")
        if {"main_path", "ckks"} <= set(phases):
            named = {k["name"].rsplit("_", 1)[0] for k in summary}
            if named != set(KERNELS):
                fail(f"the kernels line names {sorted(named)}, not every kernel")
        print(json.dumps({"kernels": summary}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
