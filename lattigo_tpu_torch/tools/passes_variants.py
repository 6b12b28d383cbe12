"""Where the long-row kernel's time goes: diagnostic variants of
``csrc/ntt_passes.cu`` timed side by side on one GPU.

    python3 -m lattigo_tpu_torch.tools.passes_variants

Each variant is the kernel source with textual substitutions, built with
nvcc into a temporary directory and launched through the same C entry with
the same launch plan, tables and inputs:

- ``kernel``: the source as it is (checked bit for bit against the plain
  version);
- ``no_exchange``: every column value is stored to (forward) or loaded from
  (inverse) the block's own shared memory instead of the owning block's, so
  no distributed shared memory is touched (the cluster barriers stay);
- ``no_twiddles``: the chunk stages make their twiddles from the index
  instead of reading them;
- ``no_shoup``: the chunk stages' Shoup products become an xor of the same
  operands (the twiddle reads stay);
- ``no_chunk``: no chunk stages at all: the round trip through device
  memory, the column stages and the exchange;
- ``round_trip``: no chunk stages and no column stages: the loads, the
  exchange, the barriers and the stores;
- ``radix_2``: the chunk stages one a round (a block barrier and a shared
  memory round trip per stage) instead of three;
- ``scalar_twiddles``: the chunk stages read each twiddle with its own
  8-byte load instead of 16-byte loads of two;
- ``min_blocks_3``: ``__launch_bounds__`` asks for 3 blocks of 512 threads
  an SM (at most 40 registers a thread) instead of 2, as many as 64 KB
  chunks allow;
- ``threads_256``: the kernel as it is with 256 threads a block instead of
  the plan's 512.

``radix_2``, ``scalar_twiddles``, ``min_blocks_3`` and ``threads_256``
compute the transform too.

The diagnostic variants compute garbage; they bound what the exchange, the
twiddle reads, the butterflies' multiplies and the chunk stages each cost.
Times are medians of CUDA-event intervals around one C-entry call, in turn
kernel, variants, variants reversed, kernel.  Prints one JSON line per shape
and direction, and the card's name and power limit.
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
from lattigo_tpu_torch.ops import pallas_ntt
from lattigo_tpu_torch.ops import u64 as u
from lattigo_tpu_torch.ops.ring import Ring

NO_EXCHANGE = [("map_rank(at, j)", "at")]
NO_TWIDDLES = [("load_twiddles<E / 2>(w, ws, tw0, ng, W, WS);",
                "for (int p = 0; p < E / 2; ++p) { W[p] = tw0 + p; WS[p] = (u64)p << 40; }")]
SCALAR_TWIDDLES = [(
    "    if (ng == 1) {\n        W[0] = __ldg(w + tw0);\n        WS[0] = __ldg(ws + tw0);\n"
    "        return;\n    }",
    "#pragma unroll\n    for (int p = 0; p < NMAX; ++p)\n"
    "        if (p < ng) W[p] = __ldg(w + tw0 + p), WS[p] = __ldg(ws + tw0 + p);\n    return;")]
NO_SHOUP = [("Vw = mul_shoup(V, W[gg], WS[gg], q)", "Vw = V ^ W[gg] ^ WS[gg]"),
            ("x[b] = mul_shoup(U + two_q - V, W[gg], WS[gg], q);",
             "x[b] = (U + two_q - V) ^ W[gg] ^ WS[gg];")]
NO_CHUNK = [("chunk_stages<K, false>(s, log_c, log_n, c, w, ws, q, two_q);", ""),
            ("chunk_stages<K, true>(s, log_c, log_n, c, w, ws, q, two_q);", "")]
NO_COLUMN = [("for (int st = 0; st < K; ++st) {", "for (int st = 0; st < 0; ++st) {"),
             ("for (int st = K - 1; st >= 0; --st) {", "for (int st = -1; st >= 0; --st) {")]
RADIX_2 = [("chunk_round<K, 3, INVERSE>(s, e, log_c, log_n, c, w, ws, q, two_q);",
            "for (int f = 0; f < 3; ++f)\n"
            "            chunk_round<K, 1, INVERSE>(s, INVERSE ? e + f : e + 2 - f, log_c, log_n, c,\n"
            "                                       w, ws, q, two_q);")]
BOUNDS = "__launch_bounds__(MAX_THREADS, 2)"
VARIANTS = {"kernel": [], "no_exchange": NO_EXCHANGE, "no_twiddles": NO_TWIDDLES,
            "no_shoup": NO_SHOUP, "no_chunk": NO_CHUNK, "round_trip": NO_CHUNK + NO_COLUMN,
            "radix_2": RADIX_2, "scalar_twiddles": SCALAR_TWIDDLES,
            "min_blocks_3": [(BOUNDS, "__launch_bounds__(MAX_THREADS, 3)")]}
# the variants that compute the transform
EXACT = ("kernel", "radix_2", "scalar_twiddles", "min_blocks_3")
THREADS = {"threads_256": 256}  # launch variants of the kernel as it is
# (log N, batch shape [..., L], inverse): the CKKS PN16QP1761 x 8 shapes
# (decomposition, intt(c2)) and the 72 x 3 grid of chip_smoke.py
SHAPES = [(16, (8, 9, 38), False), (16, (8, 34), True), (16, (72, 3), False),
          (15, (72, 3), False), (14, (72, 3), False), (17, (72, 3), True)]
REPS = 20


def build(tmp: str) -> dict:
    src = open(os.path.join(_build.CSRC, "ntt_passes.cu")).read()
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
        if name in ("kernel", "min_blocks_3"):  # registers and spills
            print(json.dumps({"variant": name, "ptxas": [
                ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]}))
        libs[name] = _build.bind(ctypes.CDLL(os.path.join(tmp, f"lib{name}.so")), "ntt_passes")
    return libs


def time_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("passes_variants needs a CUDA device")
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
            args = list(pallas_ntt.launch_args(ring, x, out, limbs, inverse))
            stream = torch.cuda.current_stream().cuda_stream
            calls = {name: (lib, args) for name, lib in libs.items()}
            for name, threads in THREADS.items():
                calls[name] = (libs["kernel"], args[:10] + [threads] + args[11:])

            def call(name):
                lib, a = calls[name]
                err = lib.ntt_passes_launch(*a, stream)
                if err:
                    raise RuntimeError(f"variant {name} failed to launch: {err}")

            want = pallas_ntt.ntt_passes_plain(ring, x, limbs, inverse)
            for name in (*EXACT, *THREADS):
                call(name)
                if not torch.equal(out, want):
                    raise RuntimeError(f"{name} disagrees with the plain version at {shape}")
            del want
            order = list(calls)
            times = {name: [] for name in calls}
            for name in order + order[::-1]:
                times[name].append(time_ms(lambda: call(name)))
            print(json.dumps({"shape": [*shape, n], "inverse": inverse,
                              "ms": {k: statistics.mean(v) for k, v in times.items()}}),
                  flush=True)
            del ring, x, out
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
