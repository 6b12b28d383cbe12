"""Four-step negacyclic NTT with exact int8 tensor-core digit products.

Replaces the TPU kernel ``ntt_mxu`` of ``lattigo_tpu/ops/mxu_ntt.py`` (body
``_compute_block``, tables ``_tables_host``).  The transform of
ring/ntt.go:53-139 is evaluated as two modular matrix products
(N = n1 x 128):

    out2d[r, c] = ((MA @ x2d) * T) @ MB   (mod q),   x2d[j1, j2]

with the bit-reversed output order baked into MA's rows and MB's columns and
the psi pre-multiplication folded into MA and T.  Forward runs the rows
product first, inverse the lanes product first.  Each 60-bit modular product
is ONE s8 x s8 -> s32 product over byte digits: for every input digit d the
matrix (M * 2^{8d} mod q) is split into 8 balanced s8 digits e, stacked into
one operand, so the contraction over (j, d) yields the 8 output digit planes
of the true product, each below 2^31.  The host tables keep the JAX
package's format (data bytes as (u ^ 0x80) int8, a -128 * (row or column sum)
correction plus a positivity offset); the device takes the raw bytes u as u8
against the s8 matrix, whose plane sum(M * u) + off is the same integer, so
only the offset is left.  The planes are recombined in uint64 (one Shoup
product by 2^40 mod q), multiplied by the middle twiddle (Shoup, lazy),
digitised again, and reduced exactly once at the very end.  Any input below
2^62 is accepted.

The kernel is ``csrc/ntt_fourstep.cu``.  Polys that share a limb share its
digit matrices, so each product is one int8 GEMM per limb over all of its
polys: rows C[(e, a), (p, j2)] (matrix on the left) and lanes
C[(p, j1), (e, c)] (data on the left).  The contraction runs over (b, d) or
(j2, d), so 4 consecutive contraction indices are 4 consecutive bytes of a
little-endian u64: the data are copied as they lie in memory.  The matrices
are permuted on the host into the order their ``mma.sync.m16n8k32``
fragments read them (:func:`rows_layout`, :func:`lanes_layout`).  Both
products stream their operands through a 4-stage ``cp.async`` ring in
shared memory (a matrix strip serves 128 output columns or rows), and the
recombine / twiddle / final-reduce epilogue runs from the accumulator
registers, which hold all 8 planes of the same outputs.  Two launches per
transform, the [B, L, n1, 128] intermediate in device memory.

Bound on the GPU (``chip_smoke.bound_ms``): the larger of the int8
operations (2 (8 n1)^2 128 + 2 n1 1024^2 per limb-poly) over the int8 peak
and the bytes (16 N per limb-poly plus the tables) over the memory rate:
operations at N = 16384, bytes at N = 4096.  ``mma.sync`` reaches only part
of the int8 peak (``wgmma`` is the way to the rest), and one block of 8
warps fills an SM's registers; ``PERF.md`` has the measured times.

Plain version: :func:`ntt_mxu_plain` repeats the same arithmetic step by step
on tensors, with the digit products as float64 matmuls (exact below 2^53,
and present on both CPU and CUDA), which a CPU tensor takes
(``_build.takes_kernel``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lattigo_tpu_torch import _build
from lattigo_tpu_torch.ops import modred
from lattigo_tpu_torch.ops import u64 as u
from lattigo_tpu_torch.utils import profiling

_N2 = 128  # lane-axis transform length
_DIG = 8   # 8-bit digits per 64-bit word


def supported(n: int) -> bool:
    n1 = n // _N2
    return n % _N2 == 0 and 32 <= n1 <= 256 and n1 & (n1 - 1) == 0


def _bitrev(i: int, bits: int) -> int:
    return int(bin(i + (1 << bits))[3:][::-1], 2) if bits else 0


def _balanced_digits(m: np.ndarray) -> np.ndarray:
    """[..., a, b] int64 (< 2^60) -> [_DIG, ..., a, b] int8 balanced digits."""
    v = m.astype(np.int64).copy()
    planes = []
    for _ in range(_DIG):
        d = v & 255
        d -= 256 * (d >= 128)
        planes.append(d.astype(np.int8))
        v = (v - d) >> 8
    assert int(np.abs(v).max(initial=0)) == 0
    return np.stack(planes, axis=0)


def _offset(contraction: int) -> int:
    """The positivity offset ``_digit_matrix`` adds to every plane of a
    product over ``contraction`` byte digits."""
    return 1 << int(contraction * 128 * 255).bit_length()


def _digit_matrix(m: np.ndarray, q: int, contract_first: bool):
    """Fold the per-digit scale into a modular matrix and digit-decompose it.

    m: [a, b] object array of values mod q; the product contracts axis 0 of
    the returned operand when ``contract_first`` (lanes side, data @ M), else
    axis 1 (rows side, M @ data).  Returns (s8 operand, s32 correction for
    the (u8 - 128) data offset plus a positivity offset, the offset)."""
    a, b = m.shape
    mo = m.astype(object)
    folded = np.empty((_DIG, a, b), dtype=np.int64)
    for d in range(_DIG):
        folded[d] = ((mo * pow(1 << (8 * d), 1, q)) % q).astype(np.int64)
    dig = _balanced_digits(folded)  # [e, d, a, b]
    off = _offset(_DIG * (a if contract_first else b))
    if contract_first:
        # operand [(d, a), (e, b)]; correction per output column (e, b)
        op = dig.transpose(1, 2, 0, 3).reshape(_DIG * a, _DIG * b)
        corr = (128 * op.astype(np.int64).sum(axis=0) + off).reshape(1, _DIG * b)
    else:
        # operand [(e, a), (d, b)]; correction per output row (e, a)
        op = dig.transpose(0, 2, 1, 3).reshape(_DIG * a, _DIG * b)
        corr = (128 * op.astype(np.int64).sum(axis=1) + off).reshape(_DIG * a, 1)
    assert int(corr.max()) < 2**31 and int(corr.min()) >= 0
    return op, corr.astype(np.int32), off


@functools.lru_cache(maxsize=None)
def _limb_tables(q: int, n: int, psi_mont: int, bred_u0: int, inverse: bool):
    """Operands of one modulus and direction (host numpy):
    m_rows [8 n1, 8 n1] s8, c_rows [8 n1, 1] s32, m_lanes [1024, 1024] s8,
    c_lanes [1, 1024] s32, tw [3, n1, 128] u64 (twiddle, its Shoup word, its
    offset correction), consts [5] u64 (q, 2^40 mod q, its Shoup word, the
    final offset correction, Barrett u0)."""
    n1 = n // _N2
    b1, b2 = n1.bit_length() - 1, _N2.bit_length() - 1
    j1v = np.arange(n1, dtype=object)
    j2v = np.arange(_N2, dtype=object)
    k1 = np.array([_bitrev(r, b1) for r in range(n1)], dtype=object)[:, None]
    k2 = np.array([_bitrev(c, b2) for c in range(_N2)], dtype=object)[None, :]

    # psi power lookup (order 2N)
    psi = psi_mont * pow(1 << 64, -1, q) % q
    twon = 2 * n
    pows = np.empty(twon, dtype=object)
    cur = 1
    for i in range(twon):
        pows[i] = cur
        cur = cur * psi % q
    ix = lambda e: pows[(e % twon).astype(np.int64)]
    if not inverse:
        # MA[r, j1] = psi^{n2 j1 (2 k1 + 1)}; T[r, j2] = psi^{j2 (2 k1 + 1)}
        # MB[j2, c] = psi^{2 n1 j2 k2}
        mr = ix(_N2 * j1v[None, :] * (2 * k1 + 1))
        tw = ix(j2v[None, :] * (2 * k1 + 1))
        ml = ix(2 * n1 * j2v[:, None] * k2)  # [j2, c]
    else:
        # MG[c, j2] = psi^{-2 n1 k2 j2}; T'[r, j2] = psi^{-j2 (2 k1 + 1)}
        # MH[j1, r] = N^-1 psi^{-n2 j1 (2 k1 + 1)}
        ninv = pow(n, -1, q)
        ml = ix(-2 * n1 * k2.T * j2v[None, :])  # [c, j2]
        tw = ix(-j2v[None, :] * (2 * k1 + 1))
        mr = (ninv * ix(-_N2 * j1v[:, None] * (2 * k1.T + 1))) % q  # [j1, r]

    m_rows, c_rows, off_r = _digit_matrix(mr, q, contract_first=False)
    m_lanes, c_lanes, off_l = _digit_matrix(ml, q, contract_first=True)

    # the middle step consumes the first product's planes, the final step the
    # second product's; the inverse is mirrored
    off_mid, off_fin = (off_r, off_l) if not inverse else (off_l, off_r)
    ones = ((1 << 64) - 1) // 255  # 0x0101010101010101
    cf = (-off_fin * ones) % q
    tw = tw.astype(object)
    tsh = (tw << 64) // q
    tcorr = (-tw * (off_mid * ones)) % q
    twt = np.stack([t.astype(np.uint64) for t in (tw, tsh, tcorr)])
    c40 = pow(1 << 40, 1, q)
    consts = np.array([q, c40, (c40 << 64) // q, cf, bred_u0], dtype=np.uint64)
    return m_rows, c_rows, m_lanes, c_lanes, twt, consts


def _tables_host(ring, limbs: tuple[int, ...], inverse: bool) -> dict:
    """Operands stacked over ``limbs``, in the format of the JAX package's
    ``_tables_host``: m_rows [L, 8 n1, 8 n1] s8, c_rows [L, 8 n1, 1] s32,
    m_lanes [L, 1024, 1024] s8, c_lanes [L, 1, 1024] s32, ttab
    [L, 6, n1, 128] u32 (lo/hi planes of twiddle, Shoup word, correction),
    consts [L, 1, 16] u32 (lo/hi of q, c40, c40's Shoup word, Cf, Barrett u0)."""
    per = [
        _limb_tables(ring.moduli[l], ring.n, int(ring.psi_mont[l]), ring.bred[l][0], inverse)
        for l in limbs
    ]
    L = len(limbs)
    split = lambda a: np.stack(
        [(a & np.uint64(0xFFFFFFFF)).astype(np.uint32), (a >> np.uint64(32)).astype(np.uint32)],
        axis=-1,
    )
    ttab = np.stack([split(p[4]).transpose(0, 3, 1, 2).reshape(6, *p[4].shape[1:]) for p in per])
    consts = np.zeros((L, 1, 16), dtype=np.uint32)
    consts[:, 0, :10] = np.stack([split(p[5]).reshape(10) for p in per])
    return dict(
        m_rows=np.stack([p[0] for p in per]), c_rows=np.stack([p[1] for p in per]),
        m_lanes=np.stack([p[2] for p in per]), c_lanes=np.stack([p[3] for p in per]),
        ttab=ttab, consts=consts,
    )


# Device layout of the digit matrices.  The contraction runs over (b, d) or
# (j2, d), so 4 consecutive contraction indices are 4 consecutive bytes of one
# little-endian u64 of the data, which is what an m16n8k32 fragment register
# holds.  Each matrix is stored in the order its mma.sync fragments read it:
# one 16-byte group per lane (g = lane >> 2, t = lane & 3), a warp's 32 lanes
# contiguous (512 bytes), so a fragment load is one conflict-free 16-byte
# shared-memory read per lane, and a block's strip is a few contiguous runs.
#
# Rows matrix [(e, a), (b, d)] (the A operand, row-major 16 x 32 tiles):
#   [at = a/16][ks = k/32][e][g][t][kh][h][byte]   a = 16 at + 8 h + g,
#   k = 32 ks + 16 kh + 4 t + byte; register kh * 2 + h of lane (g, t).
# Lanes matrix [(j2, d), (e, c)] (the B operand, 32 x 8 column tiles, two
# planes e = 2 ep + elo per 16-byte group):
#   [ct = c/8][ks][ep][g][t][elo][kh][byte]   c = 8 ct + g, the same k.
_ROWS_DIMS = "e at h g ks kh t byte"
_ROWS_DEV = "at ks e g t kh h byte"
_LANES_DIMS = "ks kh t byte ep elo ct g"
_LANES_DEV = "ct ks ep g t elo kh byte"


def _reorder(m: torch.Tensor, sizes: dict, src: str, dst: str) -> torch.Tensor:
    src, dst = src.split(), dst.split()
    return m.reshape([sizes[d] for d in src]).permute([src.index(d) for d in dst]).contiguous()


def _rows_sizes(n1: int) -> dict:
    return dict(e=_DIG, at=n1 // 16, h=2, g=8, ks=n1 // 4, kh=2, t=4, byte=4)


_LANES_SIZES = dict(ks=_DIG * _N2 // 32, kh=2, t=4, byte=4, ep=_DIG // 2, elo=2, ct=_N2 // 8, g=8)


def rows_layout(op: np.ndarray) -> torch.Tensor:
    """JAX-format rows operand [(e, a), (d, b)] -> flat device layout."""
    n1 = op.shape[0] // _DIG
    m = torch.from_numpy(op).reshape(_DIG, n1, _DIG, n1).permute(0, 1, 3, 2)  # e a b d
    return _reorder(m, _rows_sizes(n1), _ROWS_DIMS, _ROWS_DEV).reshape(-1)


def rows_matrix(flat: torch.Tensor, n1: int) -> torch.Tensor:
    """Device layout -> [(e, a), (b, d)], the kernel's contraction order."""
    return _reorder(flat, _rows_sizes(n1), _ROWS_DEV, _ROWS_DIMS).reshape(_DIG * n1, _DIG * n1)


def lanes_layout(op: np.ndarray) -> torch.Tensor:
    """JAX-format lanes operand [(d, j2), (e, c)] -> flat device layout."""
    m = torch.from_numpy(op).reshape(_DIG, _N2, _DIG, _N2).permute(1, 0, 2, 3)  # j2 d e c
    return _reorder(m, _LANES_SIZES, _LANES_DIMS, _LANES_DEV).reshape(-1)


def lanes_matrix(flat: torch.Tensor) -> torch.Tensor:
    """Device layout -> [(j2, d), (e, c)], the kernel's contraction order."""
    return _reorder(flat, _LANES_SIZES, _LANES_DEV, _LANES_DIMS).reshape(_DIG * _N2, _DIG * _N2)


class _DeviceTables:
    """Device operands of a whole ring for one direction, indexed by ring
    limb; a limb's slice is filled the first time a transform names it.
    consts[l] = q, 2^40 mod q, its Shoup word, the final offset correction,
    Barrett u0, the rows and the lanes product's plane offset."""

    def __init__(self, ring, inverse: bool):
        self.ring, self.inverse = ring, inverse
        n1, Lr, dev = ring.n // _N2, ring.L, ring.device
        self.m_rows = torch.zeros((Lr, (_DIG * n1) ** 2), dtype=torch.int8, device=dev)
        self.m_lanes = torch.zeros((Lr, (_DIG * _N2) ** 2), dtype=torch.int8, device=dev)
        self.tw = torch.zeros((Lr, 3, n1, _N2), dtype=torch.int64, device=dev)
        self.consts = torch.zeros((Lr, 8), dtype=torch.int64, device=dev)
        self.ready: set[int] = set()

    def need(self, limbs) -> "_DeviceTables":
        missing = set(limbs) - self.ready
        if missing:
            from lattigo_tpu_torch.ops.ring import build_tables  # ring imports this module

            build_tables(self._fill, missing)
        return self

    def _fill(self, limbs) -> None:
        ring, dev = self.ring, self.ring.device
        n1 = ring.n // _N2
        for l in limbs:
            m_rows, _, m_lanes, _, twt, consts = _limb_tables(
                ring.moduli[l], ring.n, int(ring.psi_mont[l]), ring.bred[l][0], self.inverse
            )
            self.m_rows[l] = rows_layout(m_rows).to(dev)
            self.m_lanes[l] = lanes_layout(m_lanes).to(dev)
            self.tw[l] = u.from_u64(twt, dev)
            self.consts[l, :5] = u.from_u64(consts, dev)
            self.consts[l, 5] = _offset(_DIG * n1)
            self.consts[l, 6] = _offset(_DIG * _N2)
            self.ready.add(l)


def _tables(ring, limbs, inverse: bool) -> _DeviceTables:
    cache = ring.kernel_cache
    key = ("fourstep", inverse)
    if key not in cache:
        cache[key] = _DeviceTables(ring, inverse)
    return cache[key].need(limbs)


def _check(ring, x: torch.Tensor, limbs) -> None:
    if not supported(ring.n):
        raise ValueError(f"n={ring.n} not supported by the four-step NTT")
    if x.shape[-2] != len(limbs) or x.shape[-1] != ring.n:
        raise ValueError(f"x {tuple(x.shape)} does not carry limbs {limbs} of N={ring.n}")
    if x.dtype != torch.int64:
        raise TypeError(f"the four-step NTT takes int64 tensors, got {x.dtype}")
    if max(limbs) >= ring.L or min(limbs) < 0:
        raise ValueError(f"limbs {limbs} out of range for a ring of {ring.L} limbs")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """[..., w] -> [..., w, 8]: the raw little-endian bytes of each u64."""
    return torch.stack([u.shr(x, 8 * d) & 255 for d in range(_DIG)], dim=-1)


def ntt_mxu_plain(ring, x: torch.Tensor, limbs: tuple[int, ...], inverse: bool = False) -> torch.Tensor:
    """The four-step transform step by step on tensors, in the kernel's
    contraction order (raw data bytes against the device-layout matrices,
    plus the plane offset); bit-equal to the kernel and to the butterfly
    schedule.  The digit products are float64 matmuls, exact below 2^53."""
    limbs = tuple(int(l) for l in limbs)
    _check(ring, x, limbs)
    t = _tables(ring, limbs, inverse)
    idx = list(limbs)
    n1, L = ring.n // _N2, len(limbs)
    m_rows = torch.stack([rows_matrix(t.m_rows[l], n1) for l in idx]).to(torch.float64)
    m_lanes = torch.stack([lanes_matrix(t.m_lanes[l]) for l in idx]).to(torch.float64)
    tw, tsh, tco = t.tw[idx].unbind(1)  # [L, n1, 128] each
    q, c40, c40s, cf, u0, off_r, off_l = (t.consts[idx, k].reshape(L, 1, 1) for k in range(7))

    def rows_mm(data):
        # matrix on the left, contraction over (b, d): [.., (b, d), j2]
        op = _bytes(data).transpose(-1, -2).reshape(-1, L, _DIG * n1, _N2)
        o = torch.matmul(m_rows, op.to(torch.float64)).to(torch.int64)
        return (o.reshape(-1, L, _DIG, n1, _N2) + off_r.unsqueeze(1)).unbind(2)

    def lanes_mm(data):
        # data on the left, contraction over (j2, d): [.., j1, (j2, d)]
        op = _bytes(data).reshape(-1, L, n1, _DIG * _N2)
        o = torch.matmul(op.to(torch.float64), m_lanes).to(torch.int64)
        return (o.reshape(-1, L, n1, _DIG, _N2) + off_l.unsqueeze(2)).unbind(3)

    def combine(p):
        lo = p[0] + (p[1] << 8) + (p[2] << 16) + (p[3] << 24) + (p[4] << 32)
        hi = p[5] + (p[6] << 8) + (p[7] << 16)
        return lo + modred.mul_shoup(hi, c40, c40s, q)

    x3 = x.reshape(-1, L, n1, _N2)
    first, second = (lanes_mm, rows_mm) if inverse else (rows_mm, lanes_mm)
    y = modred.mul_shoup(combine(first(x3)), tw, tsh, q) + tco
    out = modred.bred_add(combine(second(y)) + cf, q, u0)
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


def ntt_mxu(ring, x: torch.Tensor, limbs: tuple[int, ...], inverse: bool = False) -> torch.Tensor:
    """Four-step NTT/InvNTT of ``x`` [..., L, N] under the limb tables
    ``limbs``; bit-exact vs the butterfly schedule, accepts lazily reduced
    inputs (any value < 2^62), output in [0, q)."""
    limbs = tuple(int(l) for l in limbs)
    if not _build.takes_kernel("ntt_fourstep", x):
        return ntt_mxu_plain(ring, x, limbs, inverse)
    return _ntt_mxu_kernel(ring, x, limbs, inverse)


@profiling.timed("kernel.ntt_mxu")
def _ntt_mxu_kernel(ring, x: torch.Tensor, limbs: tuple[int, ...], inverse: bool) -> torch.Tensor:
    """:func:`ntt_mxu`'s launch (its host side is the span ``kernel.ntt_mxu``)."""
    _check(ring, x, limbs)
    if x.device != ring.device:
        raise ValueError(f"x on {x.device}, ring tables on {ring.device}")
    t = _tables(ring, limbs, inverse)
    xc = x.contiguous()
    if xc.data_ptr() % 16:  # the kernel copies 16-byte groups
        xc = xc.clone()
    mid = torch.empty_like(xc)
    out = torch.empty_like(xc)
    n = ring.n
    _build.launch("ntt_fourstep", x.device, (
        xc.data_ptr(), mid.data_ptr(), out.data_ptr(),
        t.m_rows.data_ptr(), t.m_lanes.data_ptr(), t.tw.data_ptr(), t.consts.data_ptr(),
        ring.limb_vector(limbs).data_ptr(), xc.numel() // n, len(limbs), n // _N2, int(inverse),
    ), lambda: f"{xc.numel() // n} rows of N={n}", inverse=inverse)
    return out
