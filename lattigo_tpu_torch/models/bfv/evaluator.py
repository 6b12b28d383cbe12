"""BFV homomorphic evaluator (bfv/evaluator.go).

Structure mirrors the reference's call graph (tensorAndRescale for Mul,
beta-block CRT decomposition for key switching); every inner loop is a
vectorised pass over whole [L, N] limb stacks, the per-poly and per-block
transforms are stacked on a leading axis so that each ring runs one batched
NTT, and all ops broadcast over leading dims of the ciphertext polys,
rotations and ``inner_sum`` included.
"""

from __future__ import annotations

import torch

from lattigo_tpu_torch.models.bfv.context import get_context
from lattigo_tpu_torch.models.bfv.elements import Ciphertext, polys_of
from lattigo_tpu_torch.ops import galois, key_switch


def _hamming(x: int) -> int:
    return bin(x).count("1")


class Evaluator:
    def __init__(self, params, device=None):
        self.ctx = get_context(params, device)
        self.params = self.ctx.params
        # [beta, n_q, 1]: True on the limbs of decomposition block i, whose
        # decomposed values equal the input's own (see _decompose_ntt)
        dec = self.ctx.decomposer
        mask = torch.zeros((dec.beta, dec.n_q, 1), dtype=torch.bool)
        for i in range(dec.beta):
            start = i * dec.alpha
            mask[i, start : min(start + dec.xalpha[i], dec.n_q)] = True
        self._block_mask = mask.to(self.ctx.ring_q.device)

    # ---- linear ops (bfv/evaluator.go:142-276) ---------------------------

    def _binary(self, op0, op1, fn) -> list[torch.Tensor]:
        v0, v1 = polys_of(op0), polys_of(op1)
        lo, hi = (v0, v1) if len(v0) >= len(v1) else (v1, v0)
        out = [fn(v0[i], v1[i]) for i in range(len(hi))]
        out += lo[len(hi):]
        return out

    def add(self, op0, op1) -> Ciphertext:
        return Ciphertext(self._binary(op0, op1, self.ctx.ring_q.add))

    def sub(self, op0, op1) -> Ciphertext:
        ring = self.ctx.ring_q
        out = self._binary(op0, op1, ring.sub)
        d0, d1 = len(polys_of(op0)), len(polys_of(op1))
        if d0 < d1:  # the copied tail came from op1: negate it
            out[d0:] = [ring.neg(p) for p in out[d0:]]
        return Ciphertext(out)

    def neg(self, op) -> Ciphertext:
        return Ciphertext([self.ctx.ring_q.neg(p) for p in polys_of(op)])

    def reduce(self, op) -> Ciphertext:
        return Ciphertext([self.ctx.ring_q.reduce(p) for p in polys_of(op)])

    def mul_scalar(self, op, scalar: int) -> Ciphertext:
        return Ciphertext([self.ctx.ring_q.mul_scalar(p, scalar) for p in polys_of(op)])

    # ---- multiplication (bfv/evaluator.go:278-464) -----------------------

    def mul(self, op0: Ciphertext, op1) -> Ciphertext:
        return Ciphertext(self._tensor_and_rescale(polys_of(op0), polys_of(op1)))

    def _lift(self, polys):
        """Q -> (NTT_Q, NTT_QMul) per poly (bfv/evaluator.go:298-313), one
        batched NTT per ring over the stacked polys."""
        ctx = self.ctx
        bx = ctx.basis_q_qmul
        nq = ctx.ring_q.ntt(torch.stack(polys))
        nm = ctx.ring_qmul.ntt(torch.stack([bx.mod_up_qp(p) for p in polys]))
        return list(nq.unbind(0)), list(nm.unbind(0))

    def _tensor_and_rescale(self, v0, v1):
        ctx = self.ctx
        rq, rm = ctx.ring_q, ctx.ring_qmul
        same = v0 is v1
        c0q, c0m = self._lift(v0)
        c1q, c1m = (c0q, c0m) if same else self._lift(v1)

        out_deg = len(v0) + len(v1) - 2
        accq = [None] * (out_deg + 1)
        accm = [None] * (out_deg + 1)

        def acc(ring, store, k, term):
            store[k] = term if store[k] is None else ring.add(store[k], term)

        for i in range(len(v0)):
            m0q, m0m = rq.mform(c0q[i]), rm.mform(c0m[i])
            js = range(i, len(v1)) if same else range(len(v1))
            for j in js:
                tq = rq.mul_coeffs_montgomery(m0q, c1q[j])
                tm = rm.mul_coeffs_montgomery(m0m, c1m[j])
                if same and j > i:  # cross terms count twice when squaring
                    tq = rq.add(tq, tq)
                    tm = rm.add(tm, tm)
                acc(rq, accq, i + j, tq)
                acc(rm, accm, i + j, tm)

        # InvNTT, divide by Q, recenter, extend back to Q, multiply by t
        # (bfv/evaluator.go:424-462); one batched InvNTT per ring over the
        # stacked output degrees, the divide-by-Q tail batched the same way
        bx = ctx.basis_q_qmul
        p_half = rm.modulus_bigint >> 1
        cq = rq.intt(torch.stack(accq))
        cm = rm.intt(torch.stack(accm))
        cm = bx.mod_down_split_qp(cq, cm)  # (x - [x]_Q)/Q in QMul
        cm = rm.add_scalar_bigint(cm, p_half)
        cq = bx.mod_up_pq(cm, rq.L - 1)
        cq = rq.sub_scalar_bigint(cq, p_half)
        cq = rq.mul_scalar(cq, ctx.params.t)
        return list(cq.unbind(0))

    # ---- key switching (bfv/evaluator.go:736-813) ------------------------

    def _decompose_ntt(self, cx: torch.Tensor, c2_ntt: torch.Tensor) -> torch.Tensor:
        """All beta decomposition blocks of cx, NTT domain, stacked
        [beta, ..., L_QP, N].  The blocks stack on a leading axis and run as
        one batched NTT per ring; the Q-basis call transforms all n_q limbs
        and the block limbs, whose decomposed values equal cx's own limbs,
        are then overwritten with the matching c2_ntt rows (the skip at
        bfv/evaluator.go:775-782).  The P rows live under the non-prefix
        limbs n_q.. of ring_qp."""
        ctx = self.ctx
        dec = ctx.decomposer
        rq, rqp = ctx.ring_q, ctx.ring_qp
        n_q, n_p = dec.n_q, dec.n_p
        level = rq.L - 1
        splits = [dec.decompose_and_split(level, i, cx) for i in range(dec.beta)]
        xq = torch.stack([sp[0] for sp in splits])  # [beta, ..., n_q, N]
        xp = torch.stack([sp[1] for sp in splits])  # [beta, ..., n_p, N]
        nq_ntt = rq.ntt_limbs(xq, tuple(range(n_q)))
        np_ntt = rqp.ntt_limbs(xp, tuple(range(n_q, n_q + n_p)))

        mask = self._block_mask.view(dec.beta, *([1] * (c2_ntt.ndim - 2)), n_q, 1)
        return torch.cat([torch.where(mask, c2_ntt, nq_ntt), np_ntt], dim=-2)

    def _switch_keys_core(self, cx: torch.Tensor, swk):
        """p0, p1 = sum_beta key_i (.) D_i(cx), divided by P
        (bfv/evaluator.go:736-813).  cx in coefficient domain, basis Q."""
        ctx = self.ctx
        rqp = ctx.ring_qp
        c2_ntt = ctx.ring_q.ntt(cx)
        d = self._decompose_ntt(cx, c2_ntt)  # [beta, ..., L_QP, N]

        limbs = tuple(range(rqp.L))
        p = key_switch.inner_product(d, swk.key0, swk.key1, rqp, limbs, ctx.decomposer.beta,
                                     beta_axis=0)
        p0, p1 = rqp.intt(p[0]), rqp.intt(p[1])
        nq = ctx.ring_q.L
        bx = ctx.basis_q_p
        p0 = bx.mod_down_split_pq(p0[..., :nq, :], p0[..., nq:, :])
        p1 = bx.mod_down_split_pq(p1[..., :nq, :], p1[..., nq:, :])
        return p0, p1

    def relinearize(self, ct: Ciphertext, evk) -> Ciphertext:
        """Degree d -> 1 (bfv/evaluator.go:480-536)."""
        if ct.degree < 2:
            return ct.copy()
        ring = self.ctx.ring_q
        c0, c1 = ct.value[0], ct.value[1]
        for deg in range(ct.degree, 1, -1):
            p0, p1 = self._switch_keys_core(ct.value[deg], evk.evakey[deg - 2])
            c0 = ring.add(c0, p0)
            c1 = ring.add(c1, p1)
        return Ciphertext([c0, c1])

    def switch_keys(self, ct: Ciphertext, swk) -> Ciphertext:
        assert ct.degree == 1
        p0, p1 = self._switch_keys_core(ct.value[1], swk)
        return Ciphertext([self.ctx.ring_q.add(ct.value[0], p0), p1])

    # ---- rotations (bfv/evaluator.go:565-733) ----------------------------

    def _permute(self, ct: Ciphertext, gal_el: int, swk) -> Ciphertext:
        ring = self.ctx.ring_q
        e0 = galois.permute(ring, ct.value[0], gal_el)
        e1 = galois.permute(ring, ct.value[1], gal_el)
        p0, p1 = self._switch_keys_core(e1, swk)
        return Ciphertext([ring.add(e0, p0), p1])

    def rotate_columns(self, ct: Ciphertext, k: int, rot_keys) -> Ciphertext:
        """Slots of each row rotated left by ``k``: with the key of ``k``
        when there is one, else as power-of-two rotations on the side
        (left by k or right by N/2 - k) of lower Hamming weight."""
        ctx = self.ctx
        n = ctx.n
        k &= (n >> 1) - 1
        if k == 0:
            return ct.copy()
        if k in rot_keys.left:
            return self._permute(ct, ctx.gal_el_rot_col_left[k], rot_keys.left[k])
        if _hamming(k) <= _hamming((n >> 1) - k):
            return self._rotate_pow2(ct, 5, k, rot_keys.left)
        return self._rotate_pow2(ct, pow(5, 2 * n - 1, 2 * n), (n >> 1) - k, rot_keys.right)

    def _rotate_pow2(self, ct: Ciphertext, gen: int, k: int, keys) -> Ciphertext:
        mask = (self.ctx.n << 1) - 1
        out = ct.copy()
        idx = 1
        while k > 0:
            if k & 1:
                if idx not in keys:
                    raise ValueError(f"missing pow2 rotation key {idx}")
                out = self._permute(out, gen, keys[idx])
            gen = gen * gen & mask
            idx <<= 1
            k >>= 1
        return out

    def rotate_rows(self, ct: Ciphertext, rot_keys) -> Ciphertext:
        """Swaps the two rows of slots."""
        if rot_keys.row is None:
            raise ValueError("row rotation key not generated")
        return self._permute(ct, self.ctx.gal_el_rot_row, rot_keys.row)

    def inner_sum(self, ct: Ciphertext, rot_keys) -> Ciphertext:
        """Log-rotations and adds: every slot holds the sum of all slots
        (bfv/evaluator.go:691-708)."""
        out = ct.copy()
        i = 1
        while i < self.ctx.n >> 1:
            out = self.add(self.rotate_columns(out, i, rot_keys), out)
            i <<= 1
        return self.add(self.rotate_rows(out, rot_keys), out)
