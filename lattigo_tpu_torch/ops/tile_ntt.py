"""Row NTT: one CUDA thread block per (batch, limb) row.

Replaces the TPU kernel ``ntt_tile`` of ``lattigo_tpu/ops/tile_ntt.py`` (body
``_kernel``).  The kernel is ``csrc/ntt_row.cu``: the row sits in shared
memory as uint64, all log N radix-2 stages run in the block with a barrier
between them, butterflies use native 64-bit Shoup products, and the last
pass reduces exactly, so outputs equal the plain schedule bit for bit.

Bound on the GPU: bytes (16 N per row against 5 N log N / 2 multiplies), and
at the batch-1 calls it serves, launch and barrier latency.  The design keeps
the row on chip between stages and leaves the twiddle tables to L2.

Plain version: ``Ring._ntt_simple`` / ``Ring._intt_simple``.  A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lattigo_tpu_torch import _build
from lattigo_tpu_torch.ops import u64 as u

MIN_N = 1 << 10
MAX_N = 1 << 14  # 128 KB of shared memory; a 2^15 row (256 KB) fits no block

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("ntt_row")
        lib.ntt_row_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.ntt_row_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _tables(ring, inverse: bool):
    """Device tables of the whole ring for one direction: plain and Shoup
    twiddles [L, N] and the per-limb constants [L, 4]."""
    cache, key = ring.kernel_cache, ("row", inverse)
    if key not in cache:
        plain, shoup = ring.shoup_twiddles(inverse)
        consts = []
        for l, q in enumerate(ring.moduli):
            ninv = ring.n_inv_mont[l] * pow(1 << 64, -1, q) % q
            consts.append([q, ring.bred[l][0], ninv, (ninv << 64) // q])
        cache[key] = (
            u.from_u64(plain, ring.device),
            u.from_u64(shoup, ring.device),
            u.from_u64(np.array(consts, dtype=np.uint64), ring.device),
        )
    return cache[key]


def ntt_tile(ring, x: torch.Tensor, limbs: tuple[int, ...], inverse: bool = False) -> torch.Tensor:
    """Merged-psi (Inv)NTT of ``x`` [..., L, N] under the limb tables
    ``limbs``; forward inputs below 4q, inverse inputs below 4q, output in
    [0, q)."""
    limbs = tuple(int(l) for l in limbs)
    if x.shape[-2] != len(limbs) or x.shape[-1] != ring.n:
        raise ValueError(f"x {tuple(x.shape)} does not carry limbs {limbs} of N={ring.n}")
    if x.device.type == "cpu":
        return ring._intt_simple(x, limbs) if inverse else ring._ntt_simple(x, limbs)
    if x.device.type != "cuda" or x.dtype != torch.int64:
        raise TypeError(f"ntt_tile takes int64 tensors on cpu or cuda, got {x.dtype} on {x.device}")
    if x.device != ring.device:
        raise ValueError(f"x on {x.device}, ring tables on {ring.device}")
    n = ring.n
    if n > MAX_N:
        raise NotImplementedError(
            f"N={n}: a row of {8 * n} bytes does not fit one block's shared memory"
        )
    if n < MIN_N:
        raise NotImplementedError(f"N={n}: the row kernel starts at N={MIN_N}")
    if max(limbs) >= ring.L or min(limbs) < 0:
        raise ValueError(f"limbs {limbs} out of range for a ring of {ring.L} limbs")

    tw, tws, consts = _tables(ring, inverse)
    xc = x.contiguous()
    out = torch.empty_like(xc)
    L = len(limbs)
    with torch.cuda.device(x.device):
        err = _library().ntt_row_launch(
            xc.data_ptr(), out.data_ptr(), tw.data_ptr(), tws.data_ptr(),
            consts.data_ptr(), ring.limb_vector(limbs).data_ptr(),
            xc.numel() // n, L, n, int(inverse),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ntt_row_launch failed with CUDA error {err}")
    ntt_tile.launches += 1
    ntt_tile.inverse_launches += int(inverse)
    return out


ntt_tile.launches = 0  # transforms launched on the GPU, both directions
ntt_tile.inverse_launches = 0  # the inverse ones among them
