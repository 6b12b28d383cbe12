"""Long-row NTT in one thread-block-cluster launch, for rows of any N from
2^10 to 2^17.

Replaces the TPU kernel ``ntt_pallas_passes`` of
``lattigo_tpu/ops/pallas_ntt.py`` (pass body ``_kernel_pass``, stage grouping
``_passes``).  The kernel is ``csrc/ntt_passes.cu``: a cluster of ``P = 2^k``
blocks transforms one row, block ``c`` holding the chunk ``c`` of
``C = N / P`` coefficients in its shared memory.

* the **column stages** are the ``k`` stages of largest stride (N/2 .. C):
  they couple only the elements ``r, r + C, r + 2C, ...`` of a row, which one
  thread holds in registers (adjacent threads on adjacent ``r``);
* the **chunk stages** are the other ``log C`` stages, inside contiguous
  chunks of ``C``, each block in its shared memory.  In stage ``m`` the
  local group ``g`` of chunk ``c`` uses the twiddle
  ``psi[m + c * (m >> k) + g]``.

Between the two, the blocks of a cluster exchange the columns through
distributed shared memory.  The forward runs the column stages first, the
inverse the chunk stages first; the last group reduces exactly, so the
output equals ``Ring._ntt_simple`` / ``Ring._intt_simple`` bit for bit.
Each coefficient is read from device memory once and written once.
:func:`launch_plan` chooses the cluster: chunks of at most 8192
coefficients (64 KB of shared memory, so several blocks share an SM) up to
N = 65536, and at most 8 blocks a cluster (the portable size), so
N = 2^17 takes chunks of 16384 (128 KB).

Bound on the GPU: bytes and 64-bit multiplies about equally (16 N bytes per
row against ~10 int32 multiplies per butterfly).

Plain version: :func:`ntt_passes_plain` runs the same split with the same
twiddle indexing and the same Shoup tables on tensors, at any ``k`` from 1
to ``MAX_SPLIT``.  A CPU tensor takes the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from lattigo_tpu_torch import _build
from lattigo_tpu_torch.ops import modred, tile_ntt
from lattigo_tpu_torch.ops import u64 as u
from lattigo_tpu_torch.utils import profiling

MIN_N = 1 << 10
MAX_N = 1 << 17
MAX_SPLIT = 4  # column stages the plain version takes (2^k values a column)
MAX_CLUSTER = 8  # blocks a cluster: the portable size, so k <= 3 in the kernel
_CHUNK = 1 << 13  # chunk up to N = 65536: 64 KB of shared memory
_THREADS = 512  # threads a block, at most


def split(n: int) -> int:
    """Column stages of the default split: at least one, chunks of at most
    8192 coefficients where a cluster of at most 8 allows it (1 at
    N <= 16384, 2 at 32768, 3 at 65536 and 131072)."""
    return min(max(1, (n // _CHUNK).bit_length() - 1), MAX_CLUSTER.bit_length() - 1)


class Plan(NamedTuple):
    """The launch of one transform of rows of N: ``k`` column stages, a
    cluster of ``2^k`` blocks of ``threads`` threads, each holding a chunk of
    ``chunk`` coefficients in ``smem_bytes`` of shared memory."""

    k: int
    cluster: int
    chunk: int
    threads: int
    smem_bytes: int


def launch_plan(n: int) -> Plan:
    """What :func:`ntt_passes` passes to the kernel for rows of ``n``."""
    k = split(n)
    chunk = n >> k
    return Plan(k, 1 << k, chunk, min(chunk // 2, _THREADS), chunk * 8)


def _check(ring, x: torch.Tensor, limbs: tuple[int, ...], k: int) -> None:
    n = ring.n
    if x.shape[-2] != len(limbs) or x.shape[-1] != n:
        raise ValueError(f"x {tuple(x.shape)} does not carry limbs {limbs} of N={n}")
    if max(limbs) >= ring.L or min(limbs) < 0:
        raise ValueError(f"limbs {limbs} out of range for a ring of {ring.L} limbs")
    if not 1 <= k <= MAX_SPLIT or (n >> k) < 2 or (n >> k) > tile_ntt.MAX_N:
        raise ValueError(f"split k={k} does not fit N={n}")


def _tables(ring, inverse: bool):
    """Device tables of the whole ring for one direction: plain and Shoup
    twiddles [L, N] and the per-limb constants [L, 4]."""
    return ring.kernel_table(("passes", inverse), _build_tables, ring, inverse)


def _build_tables(ring, inverse: bool):
    plain, shoup = ring.shoup_twiddles(inverse)
    return (u.from_u64(plain, ring.device), u.from_u64(shoup, ring.device),
            u.from_u64(tile_ntt.limb_consts(ring), ring.device))


def _fold(a, two_q):
    """a - 2q where a > 2q (2q itself stays, as in the kernels)."""
    return torch.where(u.lt(two_q, a), a - two_q, a)


def ntt_passes_plain(ring, x: torch.Tensor, limbs: tuple[int, ...], inverse: bool = False,
                     k: int | None = None) -> torch.Tensor:
    """The kernel's arithmetic on tensors: column stages and chunk stages
    with the kernel's twiddle indices and Shoup products; inputs below 4q,
    output in [0, q)."""
    limbs = tuple(int(l) for l in limbs)
    n = ring.n
    k = split(n) if k is None else k
    _check(ring, x, limbs, k)
    p, c = 1 << k, n >> k
    tw, tws, consts = _tables(ring, inverse)
    sel = list(limbs)
    w, ws, cs = tw[sel], tws[sel], consts[sel]  # [L, N], [L, N], [L, 4]
    batch, L = x.shape[:-2], len(limbs)
    q = cs[:, 0:1]
    two_q = 2 * q
    # per-limb constants against [..., L, a, b, C]-shaped views
    q5, two_q5 = q[:, :, None, None], two_q[:, :, None, None]
    chunk = torch.arange(p, device=x.device)[:, None]

    def column(y):
        y = y.reshape(*batch, L, p, c)  # y[..., c', r] = x[c' * C + r]
        stages = range(k - 1, -1, -1) if inverse else range(k)
        for s in stages:
            m, tl = 1 << s, p >> (s + 1)
            yr = y.reshape(*batch, L, m, 2, tl, c)
            uu, vv = yr[..., 0, :, :], yr[..., 1, :, :]
            f = w[:, m : 2 * m, None, None]
            fs = ws[:, m : 2 * m, None, None]
            if inverse:
                pair = [_fold(uu + vv, two_q5), modred.mul_shoup(uu + two_q5 - vv, f, fs, q5)]
            else:
                uu = _fold(uu, two_q5)
                vv = modred.mul_shoup(vv, f, fs, q5)
                pair = [uu + vv, uu + two_q5 - vv]
            y = torch.stack(pair, dim=-3)
        return y.reshape(*batch, L, n)

    def chunks(y):
        log_c = c.bit_length() - 1
        logs = range(log_c) if inverse else range(log_c - 1, -1, -1)
        for log_t in logs:
            t = 1 << log_t
            m = n >> (log_t + 1)  # stage (m groups); m >> k of them per chunk
            g = m >> k
            idx = m + chunk * g + torch.arange(g, device=x.device)[None, :]  # [P, G]
            f, fs = w[:, idx, None], ws[:, idx, None]  # [L, P, G, 1]
            yr = y.reshape(*batch, L, p, g, 2, t)
            uu, vv = yr[..., 0, :], yr[..., 1, :]
            if inverse:
                pair = [_fold(uu + vv, two_q5), modred.mul_shoup(uu + two_q5 - vv, f, fs, q5)]
            else:
                uu = _fold(uu, two_q5)
                vv = modred.mul_shoup(vv, f, fs, q5)
                pair = [uu + vv, uu + two_q5 - vv]
            y = torch.stack(pair, dim=-2)
        return y.reshape(*batch, L, n)

    if inverse:
        y = _fold(_fold(x, two_q), two_q)
        y = column(chunks(y))
        return modred.cred(modred.mul_shoup(y, cs[:, 2:3], cs[:, 3:4], q), q)
    y = chunks(column(x))
    return modred.bred_add(y, q, cs[:, 1:2])


_lib = None


def _library_argtypes() -> list:
    """x, out, tw, tws, consts, limbs; rows, L, log N, k, threads, shared
    memory bytes, inverse; the stream."""
    return [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("ntt_passes")
        lib.ntt_passes_launch.argtypes = _library_argtypes()
        lib.ntt_passes_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch_args(ring, x: torch.Tensor, out: torch.Tensor, limbs: tuple[int, ...],
                 inverse: bool) -> tuple:
    """The C entry's arguments but the stream, with :func:`launch_plan`'s
    cluster, threads and shared memory."""
    plan = launch_plan(ring.n)
    tw, tws, consts = _tables(ring, inverse)
    return (x.data_ptr(), out.data_ptr(), tw.data_ptr(), tws.data_ptr(), consts.data_ptr(),
            ring.limb_vector(limbs).data_ptr(), x.numel() // ring.n, len(limbs), ring.log_n,
            plan.k, plan.threads, plan.smem_bytes, int(inverse))


def ntt_passes(ring, x: torch.Tensor, limbs: tuple[int, ...], inverse: bool = False) -> torch.Tensor:
    """Merged-psi (Inv)NTT of ``x`` [..., L, N] under the limb tables
    ``limbs``, one cluster of :func:`launch_plan` a row; inputs below 4q,
    output in [0, q)."""
    limbs = tuple(int(l) for l in limbs)
    n = ring.n
    plan = launch_plan(n)
    if x.device.type == "cpu":
        return ntt_passes_plain(ring, x, limbs, inverse, plan.k)
    return _ntt_passes_kernel(ring, x, limbs, inverse, plan)


@profiling.timed("kernel.ntt_passes")
def _ntt_passes_kernel(ring, x: torch.Tensor, limbs: tuple[int, ...], inverse: bool,
                       plan) -> torch.Tensor:
    """:func:`ntt_passes`'s launch (its host side is the span
    ``kernel.ntt_passes``)."""
    n = ring.n
    if x.device.type != "cuda" or x.dtype != torch.int64:
        raise TypeError(f"ntt_passes takes int64 tensors on cpu or cuda, got {x.dtype} on {x.device}")
    if x.device != ring.device:
        raise ValueError(f"x on {x.device}, ring tables on {ring.device}")
    _check(ring, x, limbs, plan.k)
    if not MIN_N <= n <= MAX_N:
        raise NotImplementedError(f"N={n}: the passes kernel takes N from {MIN_N} to {MAX_N}")

    xc = x.contiguous()
    out = torch.empty_like(xc)
    with torch.cuda.device(x.device):
        err = _library().ntt_passes_launch(*_launch_args(ring, xc, out, limbs, inverse),
                                           torch.cuda.current_stream().cuda_stream)
    if err == -1:
        raise RuntimeError(f"no cluster of {plan.cluster} blocks with {plan.smem_bytes} bytes "
                           f"of shared memory fits {x.device}")
    if err == -2:
        raise RuntimeError(f"ntt_passes_launch does not take the plan {plan} for N={n}")
    if err != 0:
        raise RuntimeError(f"ntt_passes_launch failed with CUDA error {err}")
    ntt_passes.launches += 1
    ntt_passes.inverse_launches += int(inverse)
    return out


ntt_passes.launches = 0  # transforms launched on the GPU (one kernel each), both directions
ntt_passes.inverse_launches = 0  # the inverse ones among them
