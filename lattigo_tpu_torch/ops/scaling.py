"""RNS rescaling (divide by the last modulus) and BFV t/Q scaled
reconstruction.

Counterpart of ``lattigo_tpu/ops/scaling.py`` (ring/ring_scaling.go).  The
divide-by-last-modulus functions serve CKKS's rescale; ``SimpleScaler``
serves BFV's decoding.  Its fraction is computed with exact integer
arithmetic, as in the JAX package: per-limb exact division through Montgomery
inverse words plus a 58-bit fixed-point rounding term.
"""

from __future__ import annotations

import numpy as np
import torch

from lattigo_tpu_torch.ops import modred, number_theory as nt
from lattigo_tpu_torch.ops import u64 as u

_F = 58  # fixed-point fractional bits for the rounding term


def _col(vals, device) -> torch.Tensor:
    return u.from_u64(np.array(vals, dtype=np.uint64).reshape(-1, 1), device)


def _rescale_tbl(ring, lvl: int) -> torch.Tensor:
    return ring._cached(("rescale", lvl), lambda: _col(ring.rescale_params[lvl - 1], ring.device))


def _consts(ring, lvl: int):
    """q, qinv, u0 of the limbs kept when limb ``lvl`` is dropped."""
    return ring.q_[:lvl], ring.qinv_[:lvl], ring.u0_[:lvl]


def _bcast_limb(limb: torch.Tensor, count: int) -> torch.Tensor:
    return limb.expand(*limb.shape[:-2], count, limb.shape[-1])


def div_floor_by_last_modulus(ring, x: torch.Tensor) -> torch.Tensor:
    """floor(x / q_last) per remaining limb, coefficient domain
    (ring/ring_scaling.go:37-55).  Returns one fewer limb."""
    lvl = ring.level_of(x)
    q, qinv, u0 = _consts(ring, lvl)
    last_mod_qi = modred.bred_add(x[..., -1:, :], q, u0)
    return modred.mred(x[..., :-1, :] + (q - last_mod_qi), _rescale_tbl(ring, lvl), q, qinv)


def div_floor_by_last_modulus_ntt(ring, x: torch.Tensor) -> torch.Tensor:
    """Same, NTT domain in and out: only the dropped limb leaves the NTT
    domain (ring/ring_scaling.go:9-34)."""
    lvl = ring.level_of(x)
    last_coeff = ring.intt_limbs(x[..., -1:, :], (lvl,))
    tmp = ring.ntt_limbs(_bcast_limb(last_coeff, lvl), tuple(range(lvl)))
    q, qinv, _ = _consts(ring, lvl)
    return modred.mred(x[..., :-1, :] + (q - tmp), _rescale_tbl(ring, lvl), q, qinv)


def _half_shift(ring, lvl: int):
    """(q_last - 1) / 2 and its negation mod each kept q_i: the shift that
    turns the floor into a rounding."""
    p_half = (ring.moduli[lvl] - 1) >> 1
    neg = ring._cached(("half_shift", lvl), lambda: _col(
        [qi - p_half % qi for qi in ring.moduli[:lvl]], ring.device))
    return p_half, neg


def div_round_by_last_modulus(ring, x: torch.Tensor) -> torch.Tensor:
    """round(x / q_last) (ring/ring_scaling.go:117-149)."""
    lvl = ring.level_of(x)
    p_half, p_half_neg = _half_shift(ring, lvl)
    last = modred.cred(x[..., -1:, :] + p_half, ring.q_[lvl : lvl + 1])
    q, qinv, u0 = _consts(ring, lvl)
    shifted = modred.bred_add(last + p_half_neg, q, u0)
    return modred.mred(x[..., :-1, :] + (q - shifted), _rescale_tbl(ring, lvl), q, qinv)


def div_round_by_last_modulus_ntt(ring, x: torch.Tensor) -> torch.Tensor:
    """round(x / q_last), NTT domain in and out (ring/ring_scaling.go:72-114)."""
    lvl = ring.level_of(x)
    p_half, p_half_neg = _half_shift(ring, lvl)
    last_coeff = ring.intt_limbs(x[..., -1:, :], (lvl,))
    last_coeff = modred.cred(last_coeff + p_half, ring.q_[lvl : lvl + 1])
    tmp = ring.ntt_limbs(_bcast_limb(last_coeff, lvl) + p_half_neg, tuple(range(lvl)))
    q, qinv, _ = _consts(ring, lvl)
    return modred.mred(x[..., :-1, :] + (q - tmp), _rescale_tbl(ring, lvl), q, qinv)


def div_floor_by_last_modulus_many(ring, x: torch.Tensor, nb: int) -> torch.Tensor:
    for _ in range(nb):
        x = div_floor_by_last_modulus(ring, x)
    return x


def div_round_by_last_modulus_many(ring, x: torch.Tensor, nb: int) -> torch.Tensor:
    for _ in range(nb):
        x = div_round_by_last_modulus(ring, x)
    return x


class SimpleScaler:
    """Exact CRT reconstruction scaled by t/Q, mod t (HPS'18).

    result(x) = round( t/Q * CRT(x) ) mod t, computed limb-wise as
    sum_j [ x_j*w_j + floor(x_j*c_j/q_j) ] + round(sum_j (x_j*c_j mod q_j)/q_j)
    where w_j = floor((Q/q_j)^-1 * t / q_j) and c_j = ((Q/q_j)^-1 * t) mod q_j.
    """

    def __init__(self, t: int, ring):
        self.t = int(t)
        self.ring = ring
        self.t_pow2 = (t & (t - 1)) == 0
        dev = ring.device
        ws, cs, m_lo, m_hi = [], [], [], []
        for q in ring.moduli:
            q_barre = pow(ring.modulus_bigint // q, -1, q)
            w = q_barre * t // q
            if not self.t_pow2:
                w = nt.mform(w % t, t)
            ws.append(w % (1 << 64))
            cs.append(q_barre * t % q)
            # M_j = floor(2^(64+F)/q_j), applied to r_j = (x_j*c_j mod q_j)
            m = (1 << (64 + _F)) // q
            m_lo.append(m & nt.MASK64)
            m_hi.append(m >> 64)
        self.w_ = _col(ws, dev)
        self.c_ = _col(cs, dev)
        self.m_lo_ = _col(m_lo, dev)
        self.m_hi_ = _col(m_hi, dev)
        if not self.t_pow2:
            self.t_ = _col([t], dev)
            self.t_u0_ = _col([nt.bred_params(t)[0]], dev)
            self.tinv_ = _col([nt.mred_params(t)], dev)

    def _mul_mod_t(self, a, b):
        if self.t_pow2:
            return (a * b) & (self.t - 1)
        return modred.mred(a, b, self.t_, self.tinv_)

    def _red_t(self, a):
        if self.t_pow2:
            return a & (self.t - 1)
        return modred.bred_add(a, self.t_, self.t_u0_)

    def scale(self, x: torch.Tensor, out_limbs: int) -> torch.Tensor:
        """x: [..., L, N] basis Q -> [..., out_limbs, N], every limb holding
        round(t/Q * CRT(x)) mod t."""
        ring = self.ring
        L = x.shape[-2]
        q, qinv = ring.q_[:L], ring.qinv_[:L]
        c = self.c_[:L]

        # integer parts: x_j*w_j mod t  and  d_j = floor(x_j*c_j/q_j) mod t
        a = self._mul_mod_t(self.w_[:L], x)
        r = modred.bred(x, c, q, ring.u0_[:L], ring.u1_[:L])  # (x_j*c_j) mod q_j
        d = self._red_t((x * c - r) * qinv)  # exact quotient < 2^61

        # rounding term: round(sum_j r_j / q_j) in 58-bit fixed point
        ti = u.mulhi64(r, self.m_lo_[:L]) + r * self.m_hi_[:L]
        acc_int = None
        vacc = None
        pending = 0
        for i in range(L):
            term = a[..., i : i + 1, :] + d[..., i : i + 1, :]
            acc_int = term if acc_int is None else acc_int + term
            pending += 2
            if pending >= 6:
                acc_int = self._red_t(acc_int)
                pending = 1
            tl = ti[..., i : i + 1, :]
            vacc = tl if vacc is None else vacc + tl
        v = u.shr(vacc + (1 << (_F - 1)), _F)
        out = self._red_t(acc_int + v)
        return out.expand(*out.shape[:-2], out_limbs, out.shape[-1])
