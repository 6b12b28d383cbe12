"""Where the key switch kernel's time goes: diagnostic variants of
``csrc/key_switch.cu`` timed side by side on one GPU.

    python3 -m lattigo_tpu_torch.tools.key_switch_variants

Each variant is the kernel source with textual substitutions, built with
nvcc into a temporary directory and launched through the real wrapper
(``ops/key_switch.inner_product``) on the same inputs:

- ``kernel``: the source as it is;
- ``no_prefetch``: block i is loaded when its turn comes, not while block
  i - 1 is folded;
- ``tile_4``: a thread takes at most 4 batch entries, so the key is read
  once per 4 of them, with fewer registers;
- ``threads_128``, ``threads_512``: that many threads a block instead of
  256;
- ``min_blocks_3``: ``__launch_bounds__`` asks for three blocks an SM;
- ``no_mred``: each Montgomery product becomes an xor of its operands:
  the loads, sums, reductions and stores alone.

All but ``no_mred`` compute the inner product (checked bit for bit against
the plain version); ``no_mred`` computes garbage and bounds what the
products cost.  Shapes: the key switch's ``d`` at the paths' largest calls
(PN16QP1761 with 8 ciphertexts and with 1, the Chebyshev's PN15QP880, BFV
PN14QP438 x 16, the PIR's PN13QP218 x 8 rows, a hoisted rotation at
PN14QP438 x 8).  Times are device times: 20 calls captured in one CUDA
graph, replayed between two CUDA events, in turn kernel, variants,
variants reversed, kernel.  Prints one JSON line per shape with each
variant's ``device_ms`` and the byte bound, ptxas' registers and spills of
every variant, and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch

from lattigo_tpu_torch import _build
from lattigo_tpu_torch.ops import galois, key_switch
from lattigo_tpu_torch.ops import number_theory as nt
from lattigo_tpu_torch.ops.ring import Ring
from lattigo_tpu_torch.tools.timing import graph_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

VARIANTS = {
    "kernel": [],
    "no_prefetch": [
        ("if (i + 1 < a.beta) load_block<TILE>(a, dl, koff, i + 1, nb, kn, xn);",
         "if (i > 0) load_block<TILE>(a, dl, koff, i, nb, k, x);"),
        ("if (i + 1 < a.beta) take_block<TILE>(nb, k, x, kn, xn);", "")],
    "tile_4": [("constexpr int MAX_TILE = 8;", "constexpr int MAX_TILE = 4;")],
    "threads_128": [("constexpr int THREADS = 256;", "constexpr int THREADS = 128;")],
    "threads_512": [("constexpr int THREADS = 256;", "constexpr int THREADS = 512;")],
    "min_blocks_3": [("__launch_bounds__(THREADS)", "__launch_bounds__(THREADS, 3)")],
    "no_mred": [("mred(k[0], x[t], q, qinv)", "(k[0] ^ x[t])"),
                ("mred(k[1], x[t], q, qinv)", "(k[1] ^ x[t])")],
}
INEXACT = ("no_mred",)
# (label, N, batch, beta, L (Q + P limbs of the call), layout, Galois index)
SHAPES = [("PN16QP1761 x 8", 65536, (8,), 9, 38, "ckks", False),
          ("PN16QP1761 x 1", 65536, (), 9, 38, "ckks", False),
          ("PN15QP880 Chebyshev", 32768, (), 6, 21, "ckks", False),
          ("PN14QP438 x 16 BFV", 16384, (16,), 5, 12, "bfv", False),
          ("PN13QP218 PIR x 8", 8192, (8,), 3, 4, "bfv", False),
          ("PN14QP438 x 8 hoisted", 16384, (8,), 5, 12, "ckks", True)]


def build(tmp: str) -> dict:
    src = open(os.path.join(_build.CSRC, "key_switch.cu")).read()
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
        libs[name] = _build.bind(ctypes.CDLL(os.path.join(tmp, f"lib{name}.so")), "key_switch")
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("key_switch_variants needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for label, n, batch, beta, L, layout, index in SHAPES:
            ring = Ring(n, nt.generate_ntt_primes(60, n.bit_length() - 1, L),
                        compute_ntt_tables=False, device=dev)
            limbs = tuple(range(L))
            rand = lambda shape: torch.randint(-(1 << 63), (1 << 63) - 1, shape,
                                               dtype=torch.int64, device=dev, generator=gen)
            d = rand((*batch, beta, L, n))
            axis = -3
            if layout == "bfv":
                d, axis = d.movedim(-3, 0).contiguous(), 0
            k0, k1 = rand((beta, L, n)), rand((beta, L, n))
            idx = galois.ntt_index(5, n, dev) if index else None

            def call():
                return key_switch.inner_product(d, k0, k1, ring, limbs, beta, index=idx,
                                                beta_axis=axis)

            _build.FORCE_PLAIN = True
            try:
                want = call()
            finally:
                _build.FORCE_PLAIN = False
            times = {name: [] for name in libs}
            order = list(libs)
            for name in order:
                _build.LIBRARIES["key_switch"] = libs[name]
                if name not in INEXACT and not torch.equal(call(), want):
                    raise RuntimeError(f"{name} disagrees with the plain version at {label}")
            del want
            for name in order + order[::-1]:
                _build.LIBRARIES["key_switch"] = libs[name]
                times[name].append(graph_ms(call))
            del _build.LIBRARIES["key_switch"]
            outputs = 2 * d.numel() // beta
            n_bytes = 8 * (d.numel() + 2 * beta * L * n + outputs) + (8 * n if index else 0)
            print(json.dumps({"shape": label, "d": list(d.shape), "index": index,
                              "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
                              "device_ms": {k: statistics.mean(v) for k, v in times.items()}}),
                  flush=True)
            del ring, d, k0, k1
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
