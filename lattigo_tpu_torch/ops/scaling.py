"""BFV t/Q scaled reconstruction.

Counterpart of ``SimpleScaler`` in ``lattigo_tpu/ops/scaling.py``
(ring/ring_scaling.go:168-300).  The fraction is computed with exact integer
arithmetic, as in the JAX package: per-limb exact division through Montgomery
inverse words plus a 58-bit fixed-point rounding term.  The divide-by-last-
modulus functions of that module belong to CKKS and are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from lattigo_tpu_torch.ops import modred, number_theory as nt
from lattigo_tpu_torch.ops import u64 as u

_F = 58  # fixed-point fractional bits for the rounding term


def _col(vals, device) -> torch.Tensor:
    return u.from_u64(np.array(vals, dtype=np.uint64).reshape(-1, 1), device)


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
