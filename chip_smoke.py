#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``lattigo_tpu_torch``).

Run it from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from ``lattigo_tpu_torch/csrc``, holds each kernel
bit for bit against its plain PyTorch version at the shapes the main path
gives it (and at a grid of other shapes), times them, then drives the BFV
main path (keygen, encode, encrypt, multiply + relinearize, decrypt, decode)
at PN12QP109 and, at full width, at PN14QP438 with 16 stacked ciphertext
pairs.  Every phase prints one JSON line; any failure exits non-zero.  The
last line is ``{"ok": true, "device": {...}}``.

``--phases a,b`` runs a subset (device, build, kernels, main_path,
full_width, and ``profile``, which is not in the default run: one traced
``forward`` per configuration, device time by kernel name and the device's
idle share); ``--batch`` sets the full-width batch; ``--verbose-build``
prints ptxas' resource report.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke.py needs a CUDA device; none is available\n")
    sys.exit(1)

import numpy as np

from lattigo_tpu_torch import _build
from lattigo_tpu_torch.entry import entry
from lattigo_tpu_torch.models import bfv
from lattigo_tpu_torch.ops import mxu_ntt, number_theory as nt, tile_ntt
from lattigo_tpu_torch.ops import ring as ring_mod
from lattigo_tpu_torch.ops import u64 as u
from lattigo_tpu_torch.ops.ring import Ring

DEV = torch.device("cuda", 0)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12    # H100 SXM data sheet, dense
REPS = 20

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
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    sys.stderr.write(f"chip_smoke: FAILED: {msg}\n")
    sys.exit(1)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS) -> float:
    """Median over ``reps`` launches, each between two CUDA events, after a
    warm-up.  Inputs stay warm in L2, as they are for the main path's caller,
    which has just produced them."""
    for _ in range(3):
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


def reset_counts() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0
        k["wrapper"].inverse_launches = 0


def read_counts() -> dict:
    out = {}
    for name, k in KERNELS.items():
        w = k["wrapper"]
        out[name + "_fwd"] = w.launches - w.inverse_launches
        out[name + "_inv"] = w.inverse_launches
    return out


def plain_of(name: str, ring, x, limbs, inverse):
    if name == "ntt_tile":
        return ring._intt_simple(x, limbs) if inverse else ring._ntt_simple(x, limbs)
    return mxu_ntt.ntt_mxu_plain(ring, x, limbs, inverse)


def rand_input(ring, batch, limbs, lazy_mult: int, seed: int) -> torch.Tensor:
    """Residues below lazy_mult * q per limb row, from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = np.empty((*batch, len(limbs), ring.n), dtype=np.uint64)
    for k, l in enumerate(limbs):
        x[..., k, :] = rng.integers(0, lazy_mult * ring.moduli[l], size=(*batch, ring.n),
                                    dtype=np.uint64)
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
    tensor-core peak."""
    n, L = ring.n, len(limbs)
    nl = len(set(limbs))
    data = 2 * batch_rows * L * n * 8
    if name == "ntt_tile":
        tables = nl * (2 * n * 8 + 4 * 8)
        return (data + tables) / HBM_BYTES_PER_S * 1e3, "bytes"
    n1 = n // 128
    tables = nl * ((8 * n1) ** 2 + 1024 ** 2 + 4 * (8 * n1 + 1024) + 3 * n * 8 + 8 * 8)
    t_bytes = (data + tables) / HBM_BYTES_PER_S * 1e3
    ops = batch_rows * L * (2 * (8 * n1) ** 2 * 128 + 2 * n1 * 1024 ** 2)
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    line = smi_line()
    emit("device", gpu=line, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return line


def phase_build(verbose: bool) -> None:
    t0 = time.time()
    _build.build(verbose=verbose)
    for name in _build.SOURCES:
        _build.load(name)
    emit("build", seconds=round(time.time() - t0, 3), sources=list(_build.SOURCES))


def record_calls(run) -> list[tuple]:
    """The NTT calls ``run`` makes, as (ring, shape, limbs, inverse, route):
    the shapes the main path gives each kernel."""
    calls = []
    real = Ring._transform

    def spy(self, x, limbs, inverse):
        calls.append((self, tuple(x.shape), tuple(limbs), inverse, self._route(x)))
        return real(self, x, limbs, inverse)

    Ring._transform = spy
    try:
        run()
    finally:
        Ring._transform = real
    torch.cuda.synchronize()
    return calls


def measure_shape(name, ring, shape, limbs, inverse, seed) -> dict:
    batch = shape[:-2]
    rows = int(np.prod(batch, dtype=np.int64)) if batch else 1
    lazy = 1 if inverse else 2
    x = rand_input(ring, batch, limbs, lazy, seed)
    err = check_equal(name, ring, x, limbs, inverse)
    w = KERNELS[name]["wrapper"]
    ms = time_ms(lambda: w(ring, x, limbs, inverse=inverse))
    plain = time_ms(lambda: plain_of(name, ring, x, limbs, inverse), reps=5)
    b_ms, b_by = bound_ms(name, ring, rows, limbs)
    return dict(shape=list(shape), limbs=list(limbs), inverse=inverse, max_abs_err=err,
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)


def cross_time(name, ring, shape, limbs, inverse, seed) -> float | None:
    """The OTHER kernel's time on a shape the routing gives to ``name``."""
    other = "ntt_mxu" if name == "ntt_tile" else "ntt_tile"
    if other == "ntt_mxu" and not mxu_ntt.supported(ring.n):
        return None
    if other == "ntt_tile" and ring.n > tile_ntt.MAX_N:
        return None
    x = rand_input(ring, shape[:-2], limbs, 1, seed)
    w = KERNELS[other]["wrapper"]
    want = plain_of(name, ring, x, limbs, inverse)
    if not torch.equal(w(ring, x, limbs, inverse=inverse), want):
        fail(f"{other} disagrees with the plain version on {shape} limbs {limbs}")
    return time_ms(lambda: w(ring, x, limbs, inverse=inverse))


def phase_kernels() -> None:
    """Bit-equality (tolerance 0: integers) of each kernel with its plain
    version over a grid of sizes, primes, lazy inputs, limb subsets and
    batches."""
    results = []
    seed = 100
    for log_n in (10, 11, 12, 13, 14, 15):
        n = 1 << log_n
        for bits in (60, 39):
            ring = Ring(n, nt.generate_ntt_primes(bits, log_n, 3), device=DEV)
            for name in KERNELS:
                if name == "ntt_tile" and n > tile_ntt.MAX_N:
                    continue
                if name == "ntt_mxu" and not mxu_ntt.supported(n):
                    continue
                # batch 17 is no multiple of any block of polys
                for batch in ((1,) if name == "ntt_mxu" else (), (3,), (17,)):
                    for limbs in ((0, 1, 2), (2, 0), (2,)):
                        for inverse in (False, True):
                            seed += 1
                            x = rand_input(ring, batch, limbs, 4, seed)  # lazy: below 4q
                            err = check_equal(name, ring, x, limbs, inverse)
                            results.append(dict(kernel=name, n=n, bits=bits, batch=list(batch),
                                                limbs=list(limbs), inverse=inverse, err=err))
    # the plaintext ring: t = 65537, one limb, batch 1 (encode / decode)
    for log_n in (12, 14):
        ring = Ring(1 << log_n, [65537], device=DEV)
        for inverse in (False, True):
            seed += 1
            x = rand_input(ring, (), (0,), 4, seed)
            err = check_equal("ntt_tile", ring, x, (0,), inverse)
            results.append(dict(kernel="ntt_tile", n=ring.n, bits=17, batch=[], limbs=[0],
                                inverse=inverse, err=err))
    # what the row kernel does not hold is refused, not computed wrongly
    big = Ring(1 << 15, nt.generate_ntt_primes(60, 15, 1), device=DEV)
    try:
        tile_ntt.ntt_tile(big, big.new_poly(), (0,))
        fail("ntt_tile accepted N=32768")
    except NotImplementedError:
        pass
    bad = [r for r in results if r["err"] != 0]
    emit("kernels", cases=len(results), ok=not bad, failed=bad[:10])
    if bad:
        fail(f"{len(bad)} kernel cases disagree with the plain version")


def drive(params_idx: int, batch: tuple, label: str) -> dict:
    """One main-path run: keygen, encode, encrypt, forward, decrypt, decode,
    with the launch counts of ``forward`` and of the whole pipeline, the
    kernels held against their plain versions at every shape ``forward``
    gives them, and ``forward`` held against the all-plain route."""
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

    def run():
        forward(ct0, ct1, swk)

    fwd_times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        fwd_times.append((time.perf_counter() - t0) * 1e3)

    # every distinct call of forward: kernel vs plain, timed
    shapes = []
    seen = set()
    for i, (ring, shape, limbs, inverse, route) in enumerate(calls):
        key = (id(ring), shape, limbs, inverse, route)
        if key in seen:
            continue
        seen.add(key)
        name = "ntt_mxu" if route == "mxu" else "ntt_tile"
        r = measure_shape(name, ring, shape, limbs, inverse, seed=1000 + i)
        r.update(kernel=name, calls=sum(1 for c in calls if (id(c[0]), *c[1:]) == key),
                 other_kernel_ms=cross_time(name, ring, shape, limbs, inverse, seed=2000 + i))
        if r["max_abs_err"] != 0:
            fail(f"{label}: {name} disagrees with its plain version at {shape} limbs {limbs}")
        shapes.append(r)

    return dict(label=label, n=params.n, batch=list(batch), counts=counts,
                setup_and_first_forward_counts=pipeline_before, setup_s=setup_s,
                first_forward_s=first_forward_s,
                forward_ms=statistics.median(fwd_times), shapes=shapes)


def phase_profile(params_idx: int, batch: tuple, label: str) -> None:
    """One ``forward`` under torch.profiler: wall time, the device's busy
    time (sum of kernel self times), its idle share, and the kernels that
    take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    forward, (ct0, ct1, swk) = entry(device=DEV, params_idx=params_idx, batch=batch)
    for _ in range(2):
        forward(ct0, ct1, swk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forward(ct0, ct1, swk)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        fail("torch.profiler recorded no device time")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    emit("profile", label=label, batch=list(batch), traced_forward_ms=wall_ms,
         device_busy_ms=busy_ms, device_idle_share=max(0.0, 1 - busy_ms / wall_ms),
         kernel_launches=sum(e.count for e in kernels),
         top=[dict(name=e.key[:60], ms=e.self_device_time_total / 1e3, count=e.count) for e in top])


def kernels_line(res: dict) -> dict:
    """The per-kernel summary of a main-path run: for each kernel and
    direction the largest shape the run gave it."""
    out = []
    for name, k in KERNELS.items():
        for inverse, tag in ((False, "_fwd"), (True, "_inv")):
            mine = [s for s in res["shapes"] if s["kernel"] == name and s["inverse"] == inverse]
            if not mine:
                continue
            s = max(mine, key=lambda s: int(np.prod(s["shape"])))
            out.append(dict(
                name=name + tag, route=k["route"], source=k["source"], replaces=k["replaces"],
                launches=res["counts"][name + tag], max_abs_err=max(m["max_abs_err"] for m in mine),
                ms=s["ms"], plain_ms=s["plain_ms"], bound_ms=s["bound_ms"], bound_by=s["bound_by"],
                library_ms=None, shape=s["shape"], limbs=s["limbs"],
                other_kernel_ms=s["other_kernel_ms"],
            ))
    return {"kernels": out}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="device,build,kernels,main_path,full_width")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--verbose-build", action="store_true")
    args = ap.parse_args()
    phases = args.phases.split(",")
    torch.cuda.set_device(DEV)

    gpu = phase_device()
    if "build" in phases:
        phase_build(args.verbose_build)
    if "kernels" in phases:
        phase_kernels()
    summary = None
    if "main_path" in phases:
        res = drive(bfv.PN12QP109, (), "PN12QP109")
        emit("main_path", **res)
        if res["counts"] != {"ntt_tile_fwd": 1, "ntt_tile_inv": 2, "ntt_mxu_fwd": 6, "ntt_mxu_inv": 2}:
            fail(f"launch counts of one forward are {res['counts']}, expected 8 four-step and 3 row")
        summary = kernels_line(res)
    if "full_width" in phases:
        res = drive(bfv.PN14QP438, (args.batch,), "PN14QP438")
        emit("full_width", **res)
        if sum(res["counts"].values()) == 0:
            fail("the full-width forward launched no kernel")
        if summary is None:
            summary = kernels_line(res)
    if "profile" in phases:
        phase_profile(bfv.PN12QP109, (), "PN12QP109")
        phase_profile(bfv.PN14QP438, (args.batch,), "PN14QP438")
    if summary is not None:
        for k in summary["kernels"]:
            if k["launches"] < 1:
                fail(f"the main path never launched {k['name']}")
        print(json.dumps(summary), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
