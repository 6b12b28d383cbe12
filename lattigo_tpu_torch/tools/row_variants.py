"""Where the row kernel's time goes: diagnostic variants of
``csrc/ntt_row.cu`` timed side by side on one GPU.

    python3 -m lattigo_tpu_torch.tools.row_variants

Each variant is the kernel source with textual substitutions, built with
nvcc into a temporary directory and launched through the same C entry with
the same tables and inputs:

- ``kernel``: the source as it is;
- ``no_shoup``: the butterflies' Shoup products become an xor of the same
  operands (the twiddle reads stay);
- ``no_twiddles``: the butterflies make their twiddles from the index
  instead of reading them;
- ``round_trip``: no stages at all: the loads and stores of every round,
  the barriers and the contiguous passes;
- ``radix_2``: one stage a round (a block barrier and a shared-memory round
  trip per stage) instead of three;
- ``radix_32``: five stages a round, a thread holding 32 elements in
  registers (so 512 threads hold a row of 16384), 512 threads a block at
  most, the swizzle shifted by 5;
- ``threads_256``, ``threads_512``, ``threads_1024``: the kernel as it is
  with that many threads a block instead of the plan's.

``radix_2``, ``radix_32`` and the thread counts compute the transform too
(checked bit for bit against the plain version); the others compute
garbage and bound what the Shoup products, the twiddle reads and the
butterflies cost.  Times are device times: 20 C-entry calls captured in one
CUDA graph, replayed between two CUDA events, in turn kernel, variants,
variants reversed, kernel.  Prints one JSON line per shape and direction,
ptxas' registers and spills of every variant, and the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

from lattigo_tpu_torch import _build
from lattigo_tpu_torch.ops import number_theory as nt
from lattigo_tpu_torch.ops import tile_ntt
from lattigo_tpu_torch.ops import u64 as u
from lattigo_tpu_torch.ops.ring import Ring
from lattigo_tpu_torch.tools.timing import graph_ms

NO_SHOUP = [("Vw = mul_shoup(V, t.x, t.y, blk.q)", "Vw = V ^ t.x ^ t.y"),
            ("x[j] = mul_shoup(U + blk.two_q - V, t.x, t.y, blk.q);",
             "x[j] = (U + blk.two_q - V) ^ t.x ^ t.y;")]
NO_TWIDDLES = [("const ulonglong2 t = __ldg(wg + gg);",
                "const ulonglong2 t = make_ulonglong2(m + gg, (u64)gg << 40);")]
ROUND_TRIP = [("for (int st = 0; st < R; ++st) {", "for (int st = 0; st < 0; ++st) {")]
RADIX_2 = [("constexpr int RADIX = 3;", "constexpr int RADIX = 1;")]
RADIX_32 = [("constexpr int RADIX = 3;", "constexpr int RADIX = 5;"),
            ("constexpr int SWZ = 3;", "constexpr int SWZ = 5;"),
            ("constexpr int MAX_THREADS = 1024;", "constexpr int MAX_THREADS = 512;")]
VARIANTS = {"kernel": [], "no_shoup": NO_SHOUP, "no_twiddles": NO_TWIDDLES,
            "round_trip": ROUND_TRIP, "radix_2": RADIX_2, "radix_32": RADIX_32}
# the variants that compute the transform
EXACT = ("kernel", "radix_2", "radix_32")
THREADS = {"threads_256": 256, "threads_512": 512, "threads_1024": 1024}  # the kernel as it is
# (log N, batch shape [..., L], inverse): the 72 x 3 grid of chip_smoke.py,
# the large batch of 16-row blocks at N = 256, PN12QP109's calls and those
# of the port tests' log N = 8 BFV set
SHAPES = [(14, (72, 3), False), (14, (72, 3), True), (13, (72, 3), False),
          (12, (72, 3), False), (12, (72, 3), True), (12, (2,), False), (12, (3,), True),
          (10, (72, 3), False), (8, (72, 3), False), (8, (1409, 3), False), (8, (2,), False)]


def build(tmp: str) -> dict:
    src = open(os.path.join(_build.CSRC, "ntt_row.cu")).read()
    procs = {}
    for name, subs in VARIANTS.items():
        s = src
        for old, new in subs:
            if old not in s:
                raise RuntimeError(f"variant {name}: {old!r} not in the source")
            s = s.replace(old, new)
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(s)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC", "-I", _build.CSRC, "-o",
             os.path.join(tmp, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        print(json.dumps({"variant": name, "ptxas": [
            ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]}))
        lib = ctypes.CDLL(os.path.join(tmp, f"lib{name}.so"))
        lib.ntt_row_launch.argtypes = tile_ntt._library_argtypes()
        lib.ntt_row_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("row_variants needs a CUDA device")
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for log_n, shape, inverse in SHAPES:
            n, L = 1 << log_n, shape[-1]
            ring = Ring(n, nt.generate_ntt_primes(60, log_n, L), device=dev)
            limbs = tuple(range(L))
            rng = np.random.default_rng(log_n)
            q = np.array(ring.moduli, dtype=np.uint64)[:, None]
            x = u.from_u64(rng.integers(0, 2**62, size=(*shape, n), dtype=np.uint64)
                           % (4 * q), dev)
            out = torch.empty_like(x)
            rows = x.numel() // n
            ptrs, ints = tile_ntt._launch_args(ring, limbs, inverse, rows)
            plan = tile_ntt.launch_plan(n, rows)

            def args(threads=plan.threads):
                return (x.data_ptr(), out.data_ptr(), *ptrs, rows, *ints[:3], threads, *ints[4:])

            calls = {name: (lib, args()) for name, lib in libs.items()}
            calls["radix_32"] = (libs["radix_32"], args(max(32, min(512, plan.rows * n >> 5))))
            for name, threads in THREADS.items():
                calls[name] = (libs["kernel"], args(threads))

            def call(name):
                lib, a = calls[name]
                err = lib.ntt_row_launch(*a, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"variant {name} failed to launch: {err}")

            want = ring._intt_simple(x, limbs) if inverse else ring._ntt_simple(x, limbs)
            for name in (*EXACT, *THREADS):
                call(name)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise RuntimeError(f"{name} disagrees with the plain version at {shape}")
            del want
            order = list(calls)
            times = {name: [] for name in calls}
            for name in order + order[::-1]:
                times[name].append(graph_ms(lambda: call(name)))
            print(json.dumps({"shape": [*shape, n], "inverse": inverse,
                              "device_ms": {k: statistics.mean(v) for k, v in times.items()}}),
                  flush=True)
            del ring, x, out
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
