"""Row NTT: CUDA thread blocks that each hold whole rows of one limb.

Replaces the TPU kernel ``ntt_tile`` of ``lattigo_tpu/ops/tile_ntt.py`` (body
``_kernel``).  The kernel is ``csrc/ntt_row.cu``, for rows of N = 2^8 to
2^14:

* a block holds :func:`launch_plan`'s ``rows`` rows of the same limb in its
  shared memory: one, or at N <= 2048 up to ``4096 / N`` when the transform
  has rows enough to keep two blocks on each of the H100's 132 SMs (at
  N <= 1024 a one-row block is a warp or four, and 16 rows a block gave a
  ``[72, 3, 256]`` transform 15 blocks);
* the log N radix-2 stages run in **rounds** of up to ``RADIX`` = 3: a
  thread loads the 8 elements ``i0 + k 2^e`` of a unit into registers, runs
  the round's stages on them and stores them back, one block barrier a
  round (:func:`rounds` gives their order);
* element ``b`` of a block lives at shared-memory word :func:`smem_word`
  ``(b)``, a swizzle that keeps every warp access free of bank conflicts;
* one 16-byte load gives a twiddle and its Shoup word (:func:`_tables`:
  ``[L, N, 2]`` pairs);
* the forward's first round reads device memory and the inverse's last
  round writes it; the last group reduces exactly, so outputs equal the
  plain schedule bit for bit.

Bound on the GPU: the larger of the bytes (16 N a row plus 16 N of twiddle
pairs a limb) and the operations ((N/2) log N Shoup butterflies); bytes at
the shapes the port gives it.

Plain version: ``Ring._ntt_simple`` / ``Ring._intt_simple``, which a CPU
tensor takes (``_build.takes_kernel``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from lattigo_tpu_torch import _build
from lattigo_tpu_torch.ops import u64 as u
from lattigo_tpu_torch.utils import profiling

MIN_N = 1 << 8
MAX_N = 1 << 14  # 128 KB of shared memory; a 2^15 row (256 KB) fits no block
RADIX = 3  # stages a round (csrc/ntt_row.cu RADIX)
SWZ = 3  # swizzle shift of the shared-memory word (csrc/ntt_row.cu SWZ)
_BLOCK = 1 << 12  # coefficients a block of several rows holds at most: 32 KB
_THREADS = 512  # threads a block, at most, but at N = MAX_N (1024)
_MIN_BLOCKS = 2 * 132  # blocks a transform keeps, where it has the rows: 2 an H100 SM


class Plan(NamedTuple):
    """The launch of one transform of rows of N: each block of ``threads``
    threads holds ``rows`` rows of one limb in ``smem_bytes`` of shared
    memory."""

    rows: int
    threads: int
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def launch_plan(n: int, rows: int | None = None) -> Plan:
    """What :func:`ntt_tile` passes to the kernel for a transform of
    ``rows`` rows (batch x limbs) of ``n``; ``rows=None``: as many as fill
    the card.  A block takes the most rows of one limb (up to 4096 / N)
    that still leave ``_MIN_BLOCKS`` blocks, and one unit of a full round a
    thread (1024 threads at N = 16384, where 512 are slower)."""
    if n & (n - 1) or not MIN_N <= n <= MAX_N:
        raise ValueError(f"N={n}: the row kernel takes powers of two from {MIN_N} to {MAX_N}")
    per_block = max(1, _BLOCK // n)
    if rows is not None:
        fill = rows // _MIN_BLOCKS
        per_block = min(per_block, 1 << (fill.bit_length() - 1)) if fill else 1
    threads = 1024 if n == MAX_N else min(_THREADS, per_block * n >> RADIX)
    return Plan(per_block, threads, per_block * n * 8)


def rounds(log_n: int) -> list[tuple[int, int]]:
    """The forward's rounds in order, as (e, stages): the remainder of
    log N mod RADIX at the largest strides first, then full rounds down to
    e = 0; a remainder of one stage is merged with the next full round and
    split evenly (2 + 2).  The inverse runs them in reverse order."""
    rem = log_n % RADIX
    if RADIX > 1 and rem == 1:
        a = (RADIX + 1) // 2
        sizes = [a, RADIX + 1 - a]
    else:
        sizes = [rem] if rem else []
    sizes += [RADIX] * ((log_n - sum(sizes)) // RADIX)
    out, e = [], log_n
    for stages in sizes:
        e -= stages
        out.append((e, stages))
    return out


def unit_elements(log_n: int, e: int, stages: int, units: np.ndarray) -> np.ndarray:
    """The block elements ``[units, 2^stages]`` that the kernel's round at
    stride ``2^e`` gives each unit ``u = (row, G, j)``: ``row N + i0 + k 2^e``
    with ``i0 = G 2^(e + stages) + j``, ``j < 2^e`` (``row_round``)."""
    log_units = log_n - stages
    r, v = units >> log_units, units & ((1 << log_units) - 1)
    i0 = ((v >> e) << (e + stages)) + (v & ((1 << e) - 1))
    return ((r << log_n) + i0)[:, None] + (np.arange(1 << stages) << e)[None, :]


def smem_word(b):
    """The shared-memory word of block element ``b`` (ints or arrays)."""
    return b ^ ((b >> SWZ) & 15)


def limb_consts(ring) -> np.ndarray:
    """[L, 4] per-limb constants of the kernels: q, floor(2^128 / q) >> 64,
    N^-1 mod q and its Shoup word."""
    consts = []
    for l, q in enumerate(ring.moduli):
        ninv = ring.n_inv_mont[l] * pow(1 << 64, -1, q) % q
        consts.append([q, ring.bred[l][0], ninv, (ninv << 64) // q])
    return np.array(consts, dtype=np.uint64)


def _tables(ring, inverse: bool):
    """Device tables of the whole ring for one direction: twiddle pairs
    [L, N, 2] (plain, Shoup) and the per-limb constants [L, 4]."""
    return ring.kernel_table(("row", inverse), _build_tables, ring, inverse)


def _build_tables(ring, inverse: bool):
    plain, shoup = ring.shoup_twiddles(inverse)
    return (u.from_u64(np.stack([plain, shoup], axis=-1), ring.device),
            u.from_u64(limb_consts(ring), ring.device))


def launch_args(ring, limbs: tuple[int, ...], inverse: bool, rows: int) -> tuple[tuple, tuple]:
    """The C entry's arguments for a transform of ``rows`` rows, cached: the
    pointers (tables, limbs) that follow x and out, and the ints (L, log N,
    the plan, inverse) that follow the row count."""
    key = ("row_args", limbs, inverse, rows)
    args = ring.kernel_cache.get(key)
    if args is None:
        if max(limbs) >= ring.L or min(limbs) < 0:
            raise ValueError(f"limbs {limbs} out of range for a ring of {ring.L} limbs")
        tw, consts = _tables(ring, inverse)
        plan = launch_plan(ring.n, rows)
        args = ((tw.data_ptr(), consts.data_ptr(), ring.limb_vector(limbs).data_ptr()),
                (len(limbs), ring.log_n, plan.rows, plan.threads, plan.smem_bytes, int(inverse)))
        ring.kernel_cache[key] = args
    return args


def ntt_tile(ring, x: torch.Tensor, limbs: tuple[int, ...], inverse: bool = False) -> torch.Tensor:
    """Merged-psi (Inv)NTT of ``x`` [..., L, N] under the limb tables
    ``limbs``; forward inputs below 4q, inverse inputs below 4q, output in
    [0, q)."""
    limbs = tuple(limbs)
    n = ring.n
    if x.shape[-2] != len(limbs) or x.shape[-1] != n:
        raise ValueError(f"x {tuple(x.shape)} does not carry limbs {limbs} of N={n}")
    if not _build.takes_kernel("ntt_row", x):
        limbs = tuple(int(l) for l in limbs)
        return ring._intt_simple(x, limbs) if inverse else ring._ntt_simple(x, limbs)
    return _ntt_tile_kernel(ring, x, limbs, inverse)


@profiling.timed("kernel.ntt_tile")
def _ntt_tile_kernel(ring, x: torch.Tensor, limbs: tuple[int, ...], inverse: bool) -> torch.Tensor:
    """:func:`ntt_tile`'s launch (its host side is the span ``kernel.ntt_tile``)."""
    n = ring.n
    if x.device != ring.device:
        raise ValueError(f"x on {x.device}, ring tables on {ring.device}")
    if not MIN_N <= n <= MAX_N:
        raise NotImplementedError(f"N={n}: the row kernel takes N from {MIN_N} to {MAX_N}")
    xc = x.contiguous()
    out = torch.empty_like(xc)
    rows = xc.numel() >> ring.log_n
    if rows == 0:
        return out
    ptrs, ints = launch_args(ring, limbs, inverse, rows)
    _build.launch("ntt_row", x.device, (xc.data_ptr(), out.data_ptr(), *ptrs, rows, *ints),
                  lambda: f"the plan {launch_plan(n, rows)} for N={n}", inverse=inverse)
    return out
