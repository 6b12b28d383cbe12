"""Where the four-step kernel's time goes: diagnostic variants of
``csrc/ntt_fourstep.cu`` timed side by side on one GPU.

    python3 -m lattigo_tpu_torch.tools.fourstep_variants

Each variant is the kernel source with one textual substitution, built with
nvcc into a temporary directory and launched through the same C entry on the
same tables and inputs:

- ``kernel``: the source as it is (checked bit for bit against the plain
  version);
- ``no_mma``: every ``mma.sync`` replaced by one 32-bit add that takes the
  same registers, so the fragment reads stay and the tensor cores idle;
- ``no_copy``: every ``cp.async`` dropped, so nothing is read from L2 or
  device memory in the main loops (the products run on stale shared memory);
- ``no_lds``: every fragment read from shared memory replaced by values made
  in registers;
- ``no_epilogue``: the recombination, twiddle and reduction replaced by an
  xor of the planes (the store stays);
- ``mma_only``: no copy and no fragment read: the ``mma.sync`` stream from
  registers, with the loop and the epilogue around it;
- ``loop_only``: no mma, no copy, no fragment read: what is left is the
  loop, its barriers, the launch and the epilogue;
- ``stages_3``, ``stages_6``: a ring of 3 or 6 stages instead of 4 (these
  compute the transform too).

The diagnostic variants compute garbage; they bound what the tensor cores,
the copies, the fragment reads and the epilogue each cost.  Times are medians of
CUDA-event intervals around one C-entry call (both launches), in turn
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
from lattigo_tpu_torch.ops import mxu_ntt
from lattigo_tpu_torch.ops import number_theory as nt
from lattigo_tpu_torch.ops import u64 as u
from lattigo_tpu_torch.ops.ring import Ring

MMA = ('"mma.sync.aligned.m16n8k32.row.col.s32.{}.s32 {{%0, %1, %2, %3}}, "\n'
       '        "{{%4, %5, %6, %7}}, {{%8, %9}}, {{%0, %1, %2, %3}};\\n"')
# one issue slot: the other operands stay inputs of the asm, so their loads stay
ADD = '"add.s32 %0, %0, %4;\\n"'
COPY = '"cp.async.cg.shared.global [%0], [%1], 16;\\n"'
NO_MMA = [(MMA.format("s8.u8"), ADD), (MMA.format("u8.s8"), ADD)]
NO_COPY = [(COPY, '""')]
NO_LDS = [
    ("const uint4 a = *reinterpret_cast<const uint4*>(mp + e * FRAG);",
     "const uint4 a = make_uint4(e, lane, kt, kk);"),
    ("b[f][0] = *reinterpret_cast<const unsigned*>(dp + f * 64);", "b[f][0] = f + kt;"),
    ("b[f][1] = *reinterpret_cast<const unsigned*>(dp + f * 64 + 2 * R_BROW);", "b[f][1] = f ^ kk;"),
    ("ldmatrix_x4(a[m], st + L_MAT + (wm * 64 + m * 16) * L_AROW + kk * 32, L_AROW, lane);",
     "{ a[m][0] = m; a[m][1] = kt; a[m][2] = kk; a[m][3] = lane; }"),
    ("const uint4 bv = *reinterpret_cast<const uint4*>(mp + ep * FRAG);",
     "const uint4 bv = make_uint4(ep, lane, kt, kk);"),
]
NO_EPILOGUE = [(
    "    u64 v0 = combine(p0, k), v1 = combine(p1, k);\n",
    "    u64 v0 = p0[0] ^ p0[1] ^ p0[2] ^ p0[3] ^ p0[4] ^ p0[5] ^ p0[6] ^ p0[7];\n"
    "    u64 v1 = p1[0] ^ p1[1] ^ p1[2] ^ p1[3] ^ p1[4] ^ p1[5] ^ p1[6] ^ p1[7];\n"
    "    if (v0 != 1) { *reinterpret_cast<ulonglong2*>(dst + pos) = make_ulonglong2(v0, v1); return; }\n",
)]
STAGES = "constexpr int STAGES = 4;"
VARIANTS = {"kernel": [], "no_mma": NO_MMA, "no_copy": NO_COPY, "no_lds": NO_LDS,
            "no_epilogue": NO_EPILOGUE, "mma_only": NO_COPY + NO_LDS,
            "loop_only": NO_MMA + NO_COPY + NO_LDS,
            "stages_3": [(STAGES, STAGES.replace("4", "3"))],
            "stages_6": [(STAGES, STAGES.replace("4", "6"))]}
EXACT = ("kernel", "stages_3", "stages_6")  # the variants that compute the transform
# (log N, batch shape [..., L]): the four-step shapes of the BFV main paths
SHAPES = [(14, (2, 16, 6)), (14, (3, 16, 6)), (15, (2, 12)), (15, (3, 12)), (12, (2, 2))]
REPS = 30


def build(tmp: str) -> dict:
    src = open(os.path.join(_build.CSRC, "ntt_fourstep.cu")).read()
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
             "-shared", "-Xcompiler", "-fPIC", "-I", _build.CSRC, "-o",
             os.path.join(tmp, f"lib{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        libs[name] = _build.bind(ctypes.CDLL(os.path.join(tmp, f"lib{name}.so")), "ntt_fourstep")
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
        sys.exit("fourstep_variants needs a CUDA device")
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for log_n, shape in SHAPES:
            n, L = 1 << log_n, shape[-1]
            ring = Ring(n, nt.generate_ntt_primes(60, log_n, L), device=dev)
            limbs = tuple(range(L))
            rng = np.random.default_rng(log_n)
            x = u.from_u64(rng.integers(0, 2**62, size=(*shape, n), dtype=np.uint64), dev)
            mid, out = torch.empty_like(x), torch.empty_like(x)
            for inverse in (False, True):
                t = mxu_ntt._tables(ring, limbs, inverse)
                args = (x.data_ptr(), mid.data_ptr(), out.data_ptr(), t.m_rows.data_ptr(),
                        t.m_lanes.data_ptr(), t.tw.data_ptr(), t.consts.data_ptr(),
                        ring.limb_vector(limbs).data_ptr(), x.numel() // n, L, n // 128,
                        int(inverse), torch.cuda.current_stream().cuda_stream)

                def call(name):
                    if libs[name].ntt_fourstep_launch(*args) != 0:
                        raise RuntimeError(f"variant {name} failed to launch")

                want = mxu_ntt.ntt_mxu_plain(ring, x, limbs, inverse)
                for name in EXACT:
                    call(name)
                    if not torch.equal(out, want):
                        raise RuntimeError(f"{name} disagrees with the plain version at {shape}")
                order = list(libs)
                times = {name: [] for name in libs}
                for name in order + order[::-1]:
                    times[name].append(time_ms(lambda: call(name)))
                print(json.dumps({"shape": [*shape, n], "inverse": inverse,
                                  "ms": {k: statistics.mean(v) for k, v in times.items()}}),
                      flush=True)
            del ring, x, mid, out
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
