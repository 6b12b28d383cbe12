"""CKKS homomorphic evaluator (ckks/evaluator.go).

All ciphertexts are NTT-domain; levels are shape-encoded (limb count) and
scales are Python floats.  Every method broadcasts over leading batch dims
of the ciphertext polys.

NTT-domain constant operations use psi^(N/2) (the reference's "psi_qi^2"
trick, ckks/evaluator.go:407-443): a complex constant a+bi maps to
a + b*psi^(N/2) on the first N/2 coefficients and a - b*psi^(N/2) on the
rest.

The key switch decomposes into all beta blocks at once and transforms them
in ONE batched NTT of shape [..., beta, (lvl+1)+n_p, N], as the JAX package
does; at PN16QP1761 with 8 stacked ciphertexts that is 72 rows of 38 limbs.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from lattigo_tpu_torch.models.ckks.context import get_context
from lattigo_tpu_torch.models.ckks.elements import Ciphertext, drop_to_level, polys_of
from lattigo_tpu_torch.ops import ct_matrix, galois, key_switch, number_theory as nt, scaling
from lattigo_tpu_torch.ops import modred_kernel as mk
from lattigo_tpu_torch.ops import u64 as u
from lattigo_tpu_torch.tjit import GraphPool, tjit
from lattigo_tpu_torch.utils import profiling


# Rows a stacked ModDown of hoisted rotations gives its forward NTT.  On the
# H100 grid of PERF.md §6 ("Routing grid") the long-row kernel at N = 16384
# takes the same time for 64 rows as for 2, and from 256 rows on 0.25-0.30 us
# a row: a smaller chunk pays the launch again, a larger one only holds more
# rotations' Q + P products in memory at once.
HOISTED_MOD_DOWN_ROWS = 256


def _hamming(x: int) -> int:
    return bin(x).count("1")


def _chunks(ks: list[int], size: int) -> list[tuple[int, int]]:
    """The [start, stop) runs of consecutive nonzero rotations in ``ks``,
    each at most ``size`` long."""
    runs: list[tuple[int, int]] = []
    for i, k in enumerate(ks):
        if not k:
            continue
        if runs and runs[-1][1] == i and i - runs[-1][0] < size:
            runs[-1] = (runs[-1][0], i + 1)
        else:
            runs.append((i, i + 1))
    return runs


def _relinearized(c2: torch.Tensor) -> None:
    """Counts the ciphertexts of a relinearization (``ckks.relinearized``:
    the stack of ``c2``, in Python, so that a captured program counts its
    capture's once a replay)."""
    profiling.count("ckks.relinearized", math.prod(c2.shape[:-2]))


def _scale_up_exact(value: float, n: float, q: int) -> int:
    """round(n*value) mod q with sign handling (ckks/utils.go:22-48)."""
    x = float(n) * float(value)
    c = int(abs(x) + 0.5)
    r = c % q
    return (q - r) % q if x < 0 else r


@profiling.spanned("ckks")
class Evaluator:
    def __init__(self, params, device=None):
        self.ctx = get_context(params, device)
        self.params = self.ctx.params
        self._planes: dict = {}

    # ---- scale-matched linear ops (ckks/evaluator.go:227-342) ------------

    def _mul_int(self, polys, c: int):
        return [self.ctx.ring_q.mul_scalar(p, c) for p in polys]

    def _prep_pair(self, op0, op1):
        """Common level + matched scales; returns (polys0, polys1, lvl, scale)."""
        lvl = min(op0.level, op1.level)
        v0 = [drop_to_level(p, lvl) for p in polys_of(op0)]
        v1 = [drop_to_level(p, lvl) for p in polys_of(op1)]
        s0, s1 = op0.scale, op1.scale
        if s0 > s1 and int(s0 / s1) != 0:
            v1 = self._mul_int(v1, int(s0 / s1))
        elif s1 > s0 and int(s1 / s0) != 0:
            v0 = self._mul_int(v0, int(s1 / s0))
        return v0, v1, lvl, max(s0, s1)

    def add(self, op0, op1) -> Ciphertext:
        ring = self.ctx.ring_q
        v0, v1, _, sc = self._prep_pair(op0, op1)
        lo, hi = (v0, v1) if len(v0) >= len(v1) else (v1, v0)
        out = [ring.add(v0[i], v1[i]) for i in range(len(hi))]
        return Ciphertext(out + list(lo[len(hi):]), sc)

    def sub(self, op0, op1) -> Ciphertext:
        ring = self.ctx.ring_q
        v0, v1, _, sc = self._prep_pair(op0, op1)
        mn = min(len(v0), len(v1))
        out = [ring.sub(v0[i], v1[i]) for i in range(mn)]
        out += [ring.neg(p) for p in v1[mn:]]
        return Ciphertext(out + list(v0[mn:]), sc)

    def neg(self, ct) -> Ciphertext:
        return Ciphertext([self.ctx.ring_q.neg(p) for p in polys_of(ct)], ct.scale)

    def reduce(self, ct) -> Ciphertext:
        return Ciphertext([self.ctx.ring_q.reduce(p) for p in polys_of(ct)], ct.scale)

    def drop_level(self, ct: Ciphertext, levels: int) -> Ciphertext:
        lvl = ct.level - levels
        return Ciphertext([drop_to_level(p, lvl) for p in ct.value], ct.scale, ct.is_ntt)

    # ---- NTT-domain constants (ckks/evaluator.go:375-831) ----------------

    def _const_planes(self, c_real, c_imag, scale: float, lvl: int, mont: bool) -> torch.Tensor:
        """[lvl+1, N] constant with the +-psi^(N/2) half split, built on the
        host once per (constant, scale, level) and kept on the device."""
        key = (c_real, c_imag, scale, lvl, mont)
        if key not in self._planes:
            ctx = self.ctx
            n = ctx.n
            rows = np.empty((lvl + 1, n), dtype=np.uint64)
            for i, q in enumerate(ctx.ring_q.moduli[: lvl + 1]):
                re = _scale_up_exact(c_real, scale, q) if c_real else 0
                if c_imag:
                    psi_half = nt.inv_mform(int(ctx.ring_q.ntt_psi_host[i][1]), q)
                    im = _scale_up_exact(c_imag, scale, q) * psi_half % q
                else:
                    im = 0
                first, second = (re + im) % q, (re - im) % q
                if mont:
                    first, second = nt.mform(first, q), nt.mform(second, q)
                rows[i, : n // 2] = first
                rows[i, n // 2 :] = second
            self._planes[key] = u.from_u64(rows, ctx.device)
        return self._planes[key]

    @staticmethod
    def _split_const(constant):
        if isinstance(constant, complex):
            return constant.real, constant.imag
        return float(constant), 0.0

    def _needs_scale(self, c_real, c_imag) -> float:
        need = (c_real and c_real != int(c_real)) or (c_imag and c_imag != int(c_imag))
        return self.ctx.scale if need else 1.0

    def add_const(self, ct: Ciphertext, constant) -> Ciphertext:
        """ckks/evaluator.go:375-443."""
        c_real, c_imag = self._split_const(constant)
        lvl = ct.level
        plane = self._const_planes(c_real, c_imag, ct.scale, lvl, mont=False)
        q = self.ctx.ring_q.q_[: lvl + 1]
        return Ciphertext([mk.add(ct.value[0], plane, q)] + list(ct.value[1:]), ct.scale)

    def mult_by_const(self, ct: Ciphertext, constant) -> Ciphertext:
        """ckks/evaluator.go:560-680."""
        c_real, c_imag = self._split_const(constant)
        scale = self._needs_scale(c_real, c_imag)
        plane = self._const_planes(c_real, c_imag, scale, ct.level, mont=True)
        ring = self.ctx.ring_q
        return Ciphertext([ring.mul_coeffs_montgomery(p, plane) for p in ct.value], ct.scale * scale)

    def new_zero_ciphertext(self, lvl: int, scale: float, degree: int = 1) -> Ciphertext:
        z = self.ctx.ring_q.new_poly(lvl)
        return Ciphertext([z] * (degree + 1), scale)

    def mult_by_const_and_add(self, ct: Ciphertext, constant, acc: Ciphertext) -> Ciphertext:
        """acc + ct*constant with the reference's scale equalization
        (ckks/evaluator.go:446-607)."""
        c_real, c_imag = self._split_const(constant)
        lvl = min(ct.level, acc.level)
        ct = self.drop_level(ct, ct.level - lvl) if ct.level > lvl else ct
        acc = self.drop_level(acc, acc.level - lvl) if acc.level > lvl else acc
        scale = self._needs_scale(c_real, c_imag)
        if scale != 1.0:
            if acc.scale < ct.scale * scale:
                ratio = int((scale * ct.scale) / acc.scale)
                if ratio:
                    acc = Ciphertext(self._mul_int(acc.value, ratio), scale * ct.scale)
            elif acc.scale > ct.scale * scale:
                scale = acc.scale / ct.scale
        else:
            if acc.scale > ct.scale:
                scale = acc.scale / ct.scale
            elif ct.scale > acc.scale:
                ratio = int(ct.scale / acc.scale)
                if ratio:
                    acc = Ciphertext(self._mul_int(acc.value, ratio), ct.scale)
        plane = self._const_planes(c_real, c_imag, scale, lvl, mont=True)
        ring = self.ctx.ring_q
        out = [
            ring.mul_coeffs_montgomery_and_add(plane, ct.value[i], acc.value[i])
            if i < len(ct.value) else acc.value[i]
            for i in range(len(acc.value))
        ]
        return Ciphertext(out, acc.scale)

    def mul_plain_matrix(self, ct: Ciphertext, matrix) -> Ciphertext:
        """A plaintext matrix applied to a stack of ciphertexts: output j is
        ``sum_k w[j, k] ct[k] + b[j]`` over the nonzero taps of row j of
        ``matrix`` (a ``PlainMatrix``), ``ct``'s polys being ``[n_in, lvl +
        1, N]``; the result's are ``[n_out, lvl + 1, N]`` at the scale
        ``ct.scale`` times the default scale.  Lattigo's loop of
        ``MultByConstAndAdd`` and ``AddConst`` (ckks/evaluator.go:375-607,
        scale rules in ``plain_matrix``) as one launch of
        ``csrc/ct_matrix.cu``; the tables are made at the first call of a
        level.

        Recorder: the span ``ckks.ct_matrix`` and the counter
        ``ckks.ct_matrix.products`` (the nonzero taps), counted in Python,
        so that a captured program counts its capture's once a replay."""
        if ct.degree != 1 or ct.value[0].ndim != 3 or ct.value[0].shape[0] != matrix.n_in:
            raise ValueError(f"a {matrix.n_out} x {matrix.n_in} matrix on a stack "
                             f"{[tuple(p.shape) for p in ct.value]}")
        lvl = ct.level
        scale = ct.scale * self.ctx.scale
        with profiling.span("ckks.ct_matrix"):
            profiling.count("ckks.ct_matrix.products", matrix.products)
            tab = matrix.tables(self.ctx.ring_q.moduli[: lvl + 1], self.ctx.scale, scale,
                                self.ctx.device)
            y = ct_matrix.ct_matrix(ct.value[0], ct.value[1], tab)
        return Ciphertext([y[0], y[1]], scale)

    def mult_by_i(self, ct: Ciphertext) -> Ciphertext:
        return self.mult_by_const(ct, 1j)

    def div_by_i(self, ct: Ciphertext) -> Ciphertext:
        return self.mult_by_const(ct, -1j)

    def scale_up(self, ct: Ciphertext, scale: float) -> Ciphertext:
        out = self.mult_by_const(ct, int(scale))
        return Ciphertext(out.value, ct.scale * scale)

    def mul_by_pow2(self, ct: Ciphertext, pow2: int) -> Ciphertext:
        return Ciphertext([self.ctx.ring_q.mul_scalar(p, 1 << pow2) for p in ct.value], ct.scale)

    # ---- rescaling (ckks/evaluator.go:901-995) ---------------------------

    def rescale(self, ct: Ciphertext, threshold: float | None = None) -> Ciphertext:
        """Divide by the last moduli while the scale stays above
        ``threshold`` * q / 2; all polys go through one stacked call per
        dropped limb.  At level 0 it returns ``ct`` (the reference's error
        there is ignored by its own polynomial evaluators)."""
        threshold = threshold if threshold is not None else self.ctx.scale
        ring = self.ctx.ring_q
        if ct.level == 0:
            return ct
        scale = ct.scale
        value = torch.stack(ct.value)
        lvl = ct.level
        while scale >= (threshold * ring.moduli[lvl]) / 2 and lvl != 0:
            scale /= float(ring.moduli[lvl])
            value = scaling.div_round_by_last_modulus_ntt(ring, value)
            lvl -= 1
        return Ciphertext(list(value.unbind(0)), scale)

    def rescale_many(self, ct: Ciphertext, nb: int) -> Ciphertext:
        ring = self.ctx.ring_q
        scale = ct.scale
        for i in range(nb):
            scale /= float(ring.moduli[ct.level - i])
        st = ring.intt(torch.stack(ct.value))
        st = ring.ntt(scaling.div_round_by_last_modulus_many(ring, st, nb))
        return Ciphertext(list(st.unbind(0)), scale)

    # ---- multiplication (ckks/evaluator.go:1016-1133) --------------------

    def mul_relin(self, op0, op1, rlk=None) -> Ciphertext:
        assert op0.degree <= 1 and op1.degree <= 1
        ring = self.ctx.ring_q
        lvl = min(op0.level, op1.level)
        v0 = [drop_to_level(p, lvl) for p in polys_of(op0)]
        v1 = [drop_to_level(p, lvl) for p in polys_of(op1)]
        out_scale = op0.scale * op1.scale

        if len(v0) + len(v1) == 4:  # ct x ct
            c00 = ring.mform(v0[0])
            c01 = ring.mform(v0[1])
            c0 = ring.mul_coeffs_montgomery(c00, v1[0])
            c1 = ring.add(ring.mul_coeffs_montgomery(c00, v1[1]),
                          ring.mul_coeffs_montgomery(c01, v1[0]))
            c2 = ring.mul_coeffs_montgomery(c01, v1[1])
            if rlk is None:
                return Ciphertext([c0, c1, c2], out_scale)
            _relinearized(c2)
            p0, p1 = self._switch_keys_core(lvl, c2, rlk.evakey)
            return Ciphertext([ring.add(c0, p0), ring.add(c1, p1)], out_scale)

        # pt x ct (or ct x pt)
        big, small = (v0, v1) if len(v0) == 2 else (v1, v0)
        c00 = ring.mform(small[0])
        return Ciphertext([ring.mul_coeffs_montgomery(c00, p) for p in big], out_scale)

    def relinearize(self, ct: Ciphertext, rlk) -> Ciphertext:
        assert ct.degree == 2
        ring = self.ctx.ring_q
        _relinearized(ct.value[2])
        p0, p1 = self._switch_keys_core(ct.level, ct.value[2], rlk.evakey)
        return Ciphertext([ring.add(ct.value[0], p0), ring.add(ct.value[1], p1)], ct.scale)

    def switch_keys(self, ct: Ciphertext, swk) -> Ciphertext:
        assert ct.degree == 1
        p0, p1 = self._switch_keys_core(ct.level, ct.value[1], swk)
        return Ciphertext([self.ctx.ring_q.add(ct.value[0], p0), p1], ct.scale)

    # ---- key switching core (ckks/evaluator.go:1475-1591) ----------------

    def _decompose_stacked(self, lvl: int, c2_coeff: torch.Tensor):
        """All beta(lvl) decomposition blocks, NTT domain, stacked into one
        [..., beta, (lvl+1)+n_p, N] tensor transformed by a single batched
        NTT (decomposeAndSplitNTT, ckks/evaluator.go:1561-1591, without the
        reference's per-block skip of limbs already in the NTT domain: the
        same values mod q, in one transform).  The stack is written once, by
        ``Decomposer.decompose`` (one launch on the card).  Returns (planes,
        limbs), the limbs being ring_qp table indices of the stacked limb
        axis."""
        dec = self.ctx.decomposer
        d = dec.decompose(lvl, c2_coeff)
        limbs = tuple(range(lvl + 1)) + tuple(range(dec.n_q, dec.n_q + dec.n_p))
        return self.ctx.ring_qp.ntt_limbs(d, limbs), limbs

    def _mod_down(self, lvl: int, a: torch.Tensor) -> torch.Tensor:
        nqs = lvl + 1
        return self.ctx.basis_q_p.mod_down_split_ntt_pq(a[..., :nqs, :], a[..., nqs:, :])

    def _switch_keys_core(self, lvl: int, cx_ntt: torch.Tensor, swk):
        c2_coeff = self.ctx.ring_q.intt(cx_ntt)
        d, limbs = self._decompose_stacked(lvl, c2_coeff)
        # sum_i key_i (.) d_i, both key halves, with the reference's lazy
        # reduction (every 7 accumulated products: ckks/evaluator.go:1536)
        a = key_switch.inner_product(d, swk.key0, swk.key1, self.ctx.ring_qp, limbs,
                                     self.params.beta(lvl))
        del d
        return self._mod_down(lvl, a[0]), self._mod_down(lvl, a[1])

    # ---- rotations (ckks/evaluator.go:1201-1473) -------------------------

    def _permute(self, ct: Ciphertext, gal_el: int, swk) -> Ciphertext:
        ring = self.ctx.ring_q
        e0 = galois.permute_ntt(ct.value[0], gal_el)
        e1 = galois.permute_ntt(ct.value[1], gal_el)
        p0, p1 = self._switch_keys_core(ct.level, e1, swk)
        return Ciphertext([ring.add(e0, p0), p1], ct.scale)

    def rotate_columns(self, ct: Ciphertext, k: int, rot_keys) -> Ciphertext:
        ctx = self.ctx
        n = ctx.n
        k &= (n >> 1) - 1
        if k == 0:
            return ct.copy()
        if k in rot_keys.left:
            return self._permute(ct, ctx.gal_el_rot_col_left[k], rot_keys.left[k])
        if _hamming(k) <= _hamming((n >> 1) - k):
            return self._rotate_pow2(ct, ctx.gal_el_rot_col_left, k, rot_keys.left)
        return self._rotate_pow2(ct, ctx.gal_el_rot_col_right, (n >> 1) - k, rot_keys.right)

    def _rotate_pow2(self, ct: Ciphertext, gal_tbl, k: int, keys) -> Ciphertext:
        out = ct.copy()
        idx = 1
        while k > 0:
            if k & 1:
                if idx not in keys:
                    raise ValueError(f"missing pow2 rotation key {idx}")
                out = self._permute(out, gal_tbl[idx], keys[idx])
            idx <<= 1
            k >>= 1
        return out

    def conjugate(self, ct: Ciphertext, rot_keys) -> Ciphertext:
        assert rot_keys.conjugate is not None, "conjugation key not generated"
        return self._permute(ct, self.ctx.gal_el_conjugate, rot_keys.conjugate)

    def rotate_hoisted(self, ct: Ciphertext, rotations, rot_keys) -> dict[int, Ciphertext]:
        """:meth:`rotate_hoisted_stack` by rotation (``k mod N/2``), each
        ciphertext a view of the stack."""
        st = self.rotate_hoisted_stack(ct, rotations, rot_keys)
        half = (self.ctx.n >> 1) - 1
        return {k & half: Ciphertext([st[0, i], st[1, i]], ct.scale)
                for i, k in enumerate(rotations)}

    def rotate_hoisted_stack(self, ct: Ciphertext, rotations, rot_keys) -> torch.Tensor:
        """The left rotation ``rotations[r]`` of ``ct`` at ``[:, r]`` of one
        [2, R, ..., lvl+1, N] stack: c1 decomposed once, then per rotation
        only its inner product, which reads the decomposition through the
        permutation (ckks/evaluator.go:1252-1392).  The rest of each
        rotation (the ModDown of both key halves, the permuted c0 and the
        add) runs once over a chunk of consecutive rotations, as many as
        give the forward ModDown NTT ``HOISTED_MOD_DOWN_ROWS`` rows; the
        same modular operations on the same rows as one rotation at a time.
        Rotation 0 is a copy.

        Recorder, counted in Python (a captured program counts its
        capture's once a replay): ``ckks.hoisted.mod_downs``, one a chunk,
        and ``ckks.hoisted.rotations``, the rotations in them."""
        ctx = self.ctx
        rq = ctx.ring_q
        lvl = ct.level
        ks = [k & ((ctx.n >> 1) - 1) for k in rotations]
        missing = sorted({k for k in ks if k and k not in rot_keys.left})
        if missing:
            raise ValueError(f"missing rotation keys {missing}")
        c0, c1 = ct.value[0], ct.value[1]
        shape = torch.broadcast_shapes(c0.shape, c1.shape)
        out = torch.empty((2, len(ks), *shape), dtype=c1.dtype, device=c1.device)
        for i, k in enumerate(ks):
            if not k:
                out[0, i], out[1, i] = c0, c1
        chunks = _chunks(ks, -(-HOISTED_MOD_DOWN_ROWS // (2 * math.prod(shape[:-1]))))
        if not chunks:
            return out
        beta = self.params.beta(lvl)
        d, limbs = self._decompose_stacked(lvl, rq.intt(c1))
        for start, stop in chunks:
            gal_els = [ctx.gal_el_rot_col_left[k] for k in ks[start:stop]]
            a = torch.empty((stop - start, 2, *d.shape[:-3], *d.shape[-2:]), dtype=d.dtype,
                            device=d.device)
            for j, (k, gal_el) in enumerate(zip(ks[start:stop], gal_els)):
                swk = rot_keys.left[k]  # d read through the permutation, not permuted
                key_switch.inner_product(d, swk.key0, swk.key1, ctx.ring_qp, limbs, beta,
                                         index=galois.ntt_index(gal_el, ctx.n, d.device),
                                         out=a[j])
            down = self._mod_down(lvl, a)
            del a
            out[0, start:stop] = rq.add(galois.permute_ntt_stack(c0, gal_els), down[:, 0])
            out[1, start:stop] = down[:, 1]
            profiling.count("ckks.hoisted.mod_downs")
            profiling.count("ckks.hoisted.rotations", stop - start)
        return out


class JitEvaluator(Evaluator):
    """Per-op compiled evaluator: every primitive runs as its own ``tjit``
    program (on CUDA a captured graph), cached per (level, scale, shape)
    signature; the twin of ``lattigo_tpu/models/ckks/evaluator.py``'s
    ``JitEvaluator``.  A deep circuit (a degree-31 Chebyshev, bench.py's
    config #4) replays one program per distinct (op, level, scale)
    combination instead of issuing every launch of every op from the host.
    The programs of one evaluator share one CUDA graph memory pool: they
    replay one at a time on one stream, and each replay's outputs are
    cloned before the next (``tjit.GraphPool``).
    """

    _JIT_OPS = (
        "add", "sub", "neg", "reduce", "add_const", "mult_by_const",
        "mult_by_const_and_add", "scale_up", "mul_by_pow2", "rescale",
        "rescale_many", "mul_relin", "relinearize", "switch_keys",
        "rotate_columns", "conjugate",
    )

    def __init__(self, params, device=None):
        super().__init__(params, device)
        self._jops: dict = {}
        self._pool = GraphPool()

    def __getattribute__(self, name):
        if name in JitEvaluator._JIT_OPS:
            jops = object.__getattribute__(self, "_jops")
            fn = jops.get(name)
            if fn is None:
                base = functools.partial(getattr(Evaluator, name), self)
                fn = tjit(base, pool=object.__getattribute__(self, "_pool"))
                jops[name] = fn
            return fn
        return object.__getattribute__(self, name)
