"""RNS basis extension (HPS'18 fast base conversion) and CRT decomposition.

Counterpart of ``lattigo_tpu/ops/basis_ext.py`` (ring/ring_basis_extension.go).
The correction multiple ``v = floor(sum_i y_i / q_i)`` is computed in 58-bit
integer fixed point through per-modulus reciprocal words
``M_i = floor(2^122 / q_i)``, exactly as the JAX package does, so both
packages agree bit for bit (the reference itself uses float64 there).

All functions broadcast over leading dims of ``[..., L, N]`` tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from lattigo_tpu_torch.ops import modred, number_theory as nt
from lattigo_tpu_torch.ops import u64 as u

_V_FRAC_BITS = 58  # fixed-point fractional bits of the correction term


def _col(vals, device) -> torch.Tensor:
    return u.from_u64(np.array(vals, dtype=np.uint64).reshape(-1, 1), device)


class ModUpParams:
    """Precomputed tables for exact base conversion src -> dst
    (ring/ring_basis_extension.go:76-145)."""

    def __init__(self, src, dst, device):
        self.src = [int(q) for q in src]
        self.dst = [int(p) for p in dst]
        big_q = 1
        for q in self.src:
            big_q *= q

        qib, m_lo, m_hi = [], [], []
        for q in self.src:
            qib.append(nt.mform(pow(big_q // q, -1, q), q))
            m = (1 << (64 + _V_FRAC_BITS)) // q
            m_lo.append(m & nt.MASK64)
            m_hi.append(m >> 64)

        self.qib_mont_ = _col(qib, device)
        self.m_lo_ = _col(m_lo, device)
        self.m_hi_ = _col(m_hi, device)
        # (Q/qi) mod pj, Montgomery form wrt pj: [ls, ld, 1]
        self.qispj_mont_ = u.from_u64(
            np.array(
                [[nt.mform((big_q // q) % p, p) for p in self.dst] for q in self.src],
                dtype=np.uint64,
            )[..., None],
            device,
        )
        # correction: (-Q) mod pj, Montgomery form wrt pj (and plain, for
        # the centered lift's conditional subtraction)
        self.negq_mont_ = _col([nt.mform((-big_q) % p, p) for p in self.dst], device)
        self.negq_plain_ = _col([(-big_q) % p for p in self.dst], device)

        self.sq_ = _col(self.src, device)
        self.sqinv_ = _col([nt.mred_params(q) for q in self.src], device)
        self.dp_ = _col(self.dst, device)
        self.dpinv_ = _col([nt.mred_params(p) for p in self.dst], device)
        self.dp_u0_ = _col([nt.bred_params(p)[0] for p in self.dst], device)


def mod_up(x: torch.Tensor, mp: ModUpParams, dst_sel=None, centered: bool = False) -> torch.Tensor:
    """Exact base conversion of ``x`` ([..., ls, N], basis src) to
    [..., len(dst_sel), N] in basis dst (ring/ring_basis_extension.go:352-393).
    ``dst_sel`` selects which destination limbs to produce (default: all).
    No selection or a ``range`` slices the tables and copies nothing from
    the host; any other selection gathers them.

    ``centered=True`` lifts the centered representative instead: the integer
    x - Q*[x >= Q/2] re-expressed mod each p_j, as the JAX package does (the
    reference centers through host big integers, dckks/public_refresh.go:
    102-151).  The fractional part of the fixed-point accumulator is x/Q,
    so its bit F-1 decides the half."""
    ls = x.shape[-2]
    assert ls == len(mp.src), (ls, len(mp.src))
    if dst_sel is None:
        sel = slice(None)
    elif isinstance(dst_sel, range) and dst_sel.step == 1:
        sel = slice(dst_sel.start, dst_sel.stop)
    else:
        sel = list(dst_sel)

    # y_i = x_i * (Q/q_i)^-1 mod q_i
    y = modred.mred(x, mp.qib_mont_, mp.sq_, mp.sqinv_)

    # v = floor(sum_i y_i / q_i) in 58-bit fixed point; the upward slack
    # 2*ls+1 covers the per-term truncation (< 2 units each)
    t = u.mulhi64(y, mp.m_lo_) + y * mp.m_hi_
    vacc = t[..., 0:1, :]
    for i in range(1, ls):
        vacc = vacc + t[..., i : i + 1, :]
    vacc = vacc + (2 * ls + 1)
    v = u.shr(vacc, _V_FRAC_BITS)

    dp, dpinv, dp_u0 = mp.dp_[sel], mp.dpinv_[sel], mp.dp_u0_[sel]
    # acc_j = sum_i y_i * (Q/q_i mod p_j), lazily reduced every 7 adds
    acc = None
    pending = 0
    for i in range(ls):
        term = modred.mred(y[..., i : i + 1, :], mp.qispj_mont_[i, sel], dp, dpinv)
        acc = term if acc is None else acc + term
        pending += 1
        if pending == 7:
            acc = modred.bred_add(acc, dp, dp_u0)
            pending = 1
    corr = modred.mred(v, mp.negq_mont_[sel], dp, dpinv)
    out = modred.bred_add(acc + corr, dp, dp_u0)
    if centered:
        upper = u.shr(vacc, _V_FRAC_BITS - 1) & 1
        out = torch.where(upper == 1, modred.cred(out + mp.negq_plain_[sel], dp), out)
    return out


class FastBasisExtender:
    """Q <-> P extension and ModDown (divide-and-round by P or Q)
    (ring/ring_basis_extension.go:9-348)."""

    def __init__(self, ring_q, ring_p):
        self.ring_q = ring_q
        self.ring_p = ring_p
        dev = ring_q.device
        self.params_qp = ModUpParams(ring_q.moduli, ring_p.moduli, dev)
        self.params_pq = ModUpParams(ring_p.moduli, ring_q.moduli, dev)
        big_p = ring_p.modulus_bigint
        big_q = ring_q.modulus_bigint
        # P^-1 mod q_i (Montgomery), Q^-1 mod p_j (Montgomery)
        self.mod_down_pq_ = _col(
            [nt.mform(pow(big_p % q, -1, q), q) for q in ring_q.moduli], dev
        )
        self.mod_down_qp_ = _col(
            [nt.mform(pow(big_q % p, -1, p), p) for p in ring_p.moduli], dev
        )
        self._qp_lvl: dict[int, ModUpParams] = {}

    def _params_qp(self, lvl_q: int) -> ModUpParams:
        if lvl_q == self.ring_q.L - 1:
            return self.params_qp
        if lvl_q not in self._qp_lvl:
            self._qp_lvl[lvl_q] = ModUpParams(
                self.ring_q.moduli[: lvl_q + 1], self.ring_p.moduli, self.ring_q.device
            )
        return self._qp_lvl[lvl_q]

    def mod_up_qp(self, x_q):
        """Extend [.., lq+1, N] (basis Q levels) to the full P basis."""
        return mod_up(x_q, self._params_qp(self.ring_q.level_of(x_q)))

    def mod_up_pq(self, x_p, lvl_q: int):
        """Extend a full-P-basis poly to Q limbs 0..lvl_q."""
        return mod_up(x_p, self.params_pq, dst_sel=range(lvl_q + 1))

    @staticmethod
    def _div(x_main, pool, inv_mont, ring):
        lvl = ring.level_of(x_main)
        q = ring.q_[: lvl + 1]
        return modred.mred(x_main + (q - pool), inv_mont[: lvl + 1], q, ring.qinv_[: lvl + 1])

    def mod_down_split_pq(self, x_q, x_p):
        """(x - [x]_P) / P in basis Q, coefficient domain
        (ring/ring_basis_extension.go:281-311)."""
        pool = self.mod_up_pq(x_p, self.ring_q.level_of(x_q))
        return self._div(x_q, pool, self.mod_down_pq_, self.ring_q)

    def mod_down_split_ntt_pq(self, x_q, x_p):
        """Same, NTT domain in and out (ring/ring_basis_extension.go:207-245)."""
        lvl = self.ring_q.level_of(x_q)
        pool = self.ring_q.ntt(self.mod_up_pq(self.ring_p.intt(x_p), lvl))
        return self._div(x_q, pool, self.mod_down_pq_, self.ring_q)

    def mod_down_split_qp(self, x_q, x_p):
        """(x - [x]_Q) / Q in basis P (ring/ring_basis_extension.go:314-348)."""
        return self._div(x_p, self.mod_up_qp(x_q), self.mod_down_qp_, self.ring_p)


class Decomposer:
    """Key-switch CRT decomposition D_beta(c) for arbitrary alpha = #P
    (ring/ring_basis_extension.go:398-601)."""

    def __init__(self, q_moduli, p_moduli, device):
        self.device = device
        self.q_moduli = [int(q) for q in q_moduli]
        self.p_moduli = [int(p) for p in p_moduli]
        self.n_q = len(self.q_moduli)
        self.n_p = len(self.p_moduli)
        self.alpha = self.n_p
        self.beta = -(-self.n_q // self.alpha)
        self.xalpha = [self.alpha] * self.beta
        if self.n_q % self.alpha != 0:
            self.xalpha[-1] = self.n_q % self.alpha
        self._params: dict[tuple[int, int, int], ModUpParams] = {}

    def _mod_up_params(self, level: int, beta_idx: int, index: int) -> ModUpParams:
        """The conversion of block ``beta_idx``'s ``index + 2`` source limbs
        to the limbs it produces at ``level``: the Q limbs 0..level outside
        the block, in order, then the P limbs."""
        key = (level, beta_idx, index)
        if key not in self._params:
            start = beta_idx * self.alpha
            nsrc = index + 2
            dst = [q for j, q in enumerate(self.q_moduli[: level + 1])
                   if not start <= j < start + nsrc]
            self._params[key] = ModUpParams(self.q_moduli[start : start + nsrc],
                                            dst + self.p_moduli, self.device)
        return self._params[key]

    def source_range(self, level: int, beta_idx: int) -> tuple[int, int]:
        """(start, count) of the source limbs block ``beta_idx`` reads at
        ``level``: the limbs whose values pass through unmodified."""
        alpha_i = self.xalpha[beta_idx]
        start = beta_idx * self.alpha
        if (start + alpha_i > level + 1 and (level + 1) % self.n_p == 1) or alpha_i == 1:
            return start, 1
        if level >= alpha_i + start:
            return start, alpha_i
        return start, (level - 1) % self.alpha + 2

    def decompose_and_split(self, level: int, beta_idx: int, x):
        """x ([..., level+1, N] basis Q, coefficient domain) -> block
        ``beta_idx`` of the decomposition, returned in basis Q[0..level] and
        basis P (ring/ring_basis_extension.go:601-713)."""
        alpha_i = self.xalpha[beta_idx]
        start = beta_idx * self.alpha
        end = start + alpha_i

        if (end > level + 1 and (level + 1) % self.n_p == 1) or alpha_i == 1:
            # single-limb block: plain replication, no reconstruction
            sl = x[..., start : start + 1, :]
            shape = lambda c: (*sl.shape[:-2], c, sl.shape[-1])
            return sl.expand(shape(level + 1)), sl.expand(shape(self.n_p))

        if level >= alpha_i + start:
            index = alpha_i - 2
        else:
            index = (level - 1) % self.alpha

        nsrc = index + 2
        src = x[..., start : start + nsrc, :]

        # destination limbs: Q limbs outside the block + the P block; limbs
        # inside the block are the source residues themselves
        conv = mod_up(src, self._mod_up_params(level, beta_idx, index))
        n_out_q = conv.shape[-2] - self.n_p
        conv_q, x_p = conv[..., :n_out_q, :], conv[..., n_out_q:, :]

        # reassemble the Q part in limb order
        x_q = torch.cat(
            [conv_q[..., :start, :], src, conv_q[..., start:, :]], dim=-2
        )
        return x_q, x_p
