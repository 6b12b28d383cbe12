"""CKKS encoder: C^slots <-> R_Q via the canonical-embedding special FFT
(ckks/encoder.go).

The special FFT runs on the host in vectorised numpy complex128, copied from
the JAX package (the reference equally runs it on the CPU in Go): it is the
data boundary, not the homomorphic hot path.  Scaling to integer
coefficients is exact (arbitrary-precision round) as in ckks/utils.go:51-96.
``encode`` uploads the residues and transforms them on the device;
``decode`` brings the coefficients back for the CRT.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lattigo_tpu_torch.models.ckks.context import GALOIS_GEN, get_context
from lattigo_tpu_torch.models.ckks.elements import Plaintext
from lattigo_tpu_torch.ops import u64 as u
from lattigo_tpu_torch.ops.number_theory import bit_reverse_array


@functools.lru_cache(maxsize=None)
def _fft_tables(m: int):
    """rot_group (5^i orbit) + 2N-th roots (ckks/encoder.go:37-53)."""
    rot_group = np.empty(m >> 2, dtype=np.int64)
    five = 1
    for i in range(m >> 2):
        rot_group[i] = five
        five = five * GALOIS_GEN & (m - 1)
    angles = 2 * np.pi * np.arange(m + 1) / m
    roots = np.cos(angles) + 1j * np.sin(angles)
    roots[m] = roots[0]
    return rot_group, roots


def _bit_reverse_vec(values: np.ndarray) -> np.ndarray:
    n = values.shape[-1]
    return values[..., bit_reverse_array(np.arange(n), n.bit_length() - 1)]


def special_invfft(values: np.ndarray, m: int) -> np.ndarray:
    """Inverse special FFT over the rotGroup orbit (ckks/encoder.go:170-201),
    of each vector along the last axis."""
    values = np.ascontiguousarray(values).copy()
    n = values.shape[-1]
    rot_group, roots = _fft_tables(m)
    length = n
    while length >= 2:  # the reference's len==1 iteration is a no-op
        lenh = length >> 1
        lenq = length << 2
        gap = m // lenq
        idx = ((lenq - (rot_group[:lenh] % lenq)) * gap).astype(np.int64)
        w = roots[idx]
        v2 = values.reshape(*values.shape[:-1], -1, length)
        uu = v2[..., :lenh] + v2[..., lenh:]
        vv = (v2[..., :lenh] - v2[..., lenh:]) * w
        v2[..., :lenh] = uu
        v2[..., lenh:] = vv
        length >>= 1
    values = _bit_reverse_vec(values)
    return values / n


def special_fft(values: np.ndarray, m: int) -> np.ndarray:
    """Forward special FFT (ckks/encoder.go:204-226)."""
    values = _bit_reverse_vec(values.copy())
    n = len(values)
    rot_group, roots = _fft_tables(m)
    length = 2
    while length <= n:
        lenh = length >> 1
        lenq = length << 2
        gap = m // lenq
        idx = ((rot_group[:lenh] % lenq) * gap).astype(np.int64)
        w = roots[idx]
        v2 = values.reshape(-1, length)
        uu = v2[:, :lenh].copy()  # not a view: the first write would corrupt it
        vv = v2[:, lenh:] * w[None, :]
        v2[:, :lenh] = uu + vv
        v2[:, lenh:] = uu - vv
        length <<= 1
    return values


def scale_up_vec_exact(values: np.ndarray, scale: float, moduli: list[int],
                       device) -> torch.Tensor:
    """Exact round(scale*v) residues per modulus (ckks/utils.go:51-96) of
    each vector along the last axis, as an int64 tensor [..., len(moduli),
    n] on ``device``: the float products and roundings are the JAX
    package's; the rounded words are int64 where they fit (below 2^63),
    reduced on ``device`` by one broadcast remainder, and Python integers
    where they do not, with one big-int ufunc loop per modulus."""
    x = float(scale) * np.asarray(values, dtype=np.float64)
    a = np.abs(x) + 0.5
    neg = x < 0
    if not a.size or a.max() < 2.0**63:
        c = a.astype(np.int64)  # truncates, as int() does
        c = torch.from_numpy(np.where(neg, -c, c)).to(device)
        q = torch.tensor(list(moduli), dtype=torch.int64, device=device)[:, None]
        return c[..., None, :] % q  # % takes q's sign
    c = np.array([int(v) for v in a.ravel().tolist()], dtype=object).reshape(a.shape)
    out = np.empty((*x.shape[:-1], len(moduli), x.shape[-1]), dtype=np.uint64)
    for j, q in enumerate(moduli):
        r = c % q
        out[..., j, :] = np.where(neg, (q - r) % q, r).astype(np.uint64)
    return u.from_u64(out, device)


class Encoder:
    def __init__(self, params, device=None):
        self.ctx = get_context(params, device)
        self.params = self.ctx.params
        self.m = 2 * self.ctx.n

    def encode(self, values, slots: int | None = None, level: int | None = None,
               scale: float | None = None) -> Plaintext:
        """ckks/encoder.go:78-116.  ``values`` with leading dims encode to a
        plaintext [..., L, N], one vector each."""
        ctx = self.ctx
        slots = slots if slots is not None else self.params.slots
        level = level if level is not None else self.params.max_level
        scale = scale if scale is not None else self.params.scale
        values = np.asarray(values, dtype=np.complex128)
        batch = values.shape[:-1]
        if values.shape[-1] > slots or slots > ctx.max_slots:
            raise ValueError("too many values for the given number of slots")
        buf = np.zeros((*batch, slots), dtype=np.complex128)
        buf[..., : values.shape[-1]] = values
        buf = special_invfft(buf, self.m)

        gap = ctx.max_slots // slots
        coeffs = np.zeros((*batch, ctx.n), dtype=np.float64)
        coeffs[..., 0 : gap * slots : gap] = buf.real
        coeffs[..., ctx.max_slots :: gap][..., :slots] = buf.imag

        residues = scale_up_vec_exact(coeffs, scale, ctx.ring_q.moduli[: level + 1], ctx.device)
        return Plaintext(ctx.ring_q.ntt(residues), scale)

    def decode(self, pt: Plaintext, slots: int | None = None) -> np.ndarray:
        """ckks/encoder.go:119-168.  A plaintext with leading dims decodes to
        [..., slots]."""
        ctx = self.ctx
        slots = slots if slots is not None else self.params.slots
        coeff = ctx.ring_q.intt(pt.value)
        batch = coeff.shape[:-2]
        rows = coeff.reshape(-1, *coeff.shape[-2:])
        big_q = ctx.bigint_chain[pt.level]
        q_half = big_q >> 1
        gap = ctx.max_slots // slots
        out = []
        for row in rows:
            coeffs = ctx.ring_q.poly_to_bigint_vec(row)
            re = coeffs[0 : gap * slots : gap] % big_q
            im = coeffs[ctx.max_slots :: gap][:slots] % big_q
            re = np.where(re >= q_half, re - big_q, re).astype(np.float64)
            im = np.where(im >= q_half, im - big_q, im).astype(np.float64)
            out.append(special_fft((re + 1j * im) / pt.scale, self.m))
        return np.stack(out).reshape(*batch, slots)
