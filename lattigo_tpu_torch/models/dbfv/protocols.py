"""Distributed (threshold) BFV protocols (dbfv/).

Counterpart of ``lattigo_tpu/models/dbfv/protocols.py``.  Every protocol
has the reference's shape: party-local ``gen_share*``, an associative
``aggregate`` (a modular add), then a deterministic finishing step.  A share
is one int64 tensor, a ``[beta, L_QP, N]`` tensor where the JAX package
stacks a pair of planes per block, or a tuple of two such tensors.  Common
randomness comes from the blake2b CRP stream
(:mod:`lattigo_tpu_torch.utils.prng`), as dbfv/dbfv.go:70-73.

A secret key may carry leading batch axes (``[parties, L_QP, N]``: several
parties' shares in one call, as bench.py ``vmap``s share generation over a
stacked axis); every noise draw then has that batch, one draw a party.

Each protocol draws its noise from one ``torch.Generator`` on its device,
seeded with ``seed`` (default ``1000 + label``); run over a party group
(``lattigo_tpu_torch.parallel.protocols``), each party draws from its own
generator instead (``using_generator``).  ``torch`` cannot reproduce
``jax.random`` bits, so shares agree with the JAX package's in distribution,
and every deterministic step agrees bit for bit.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from lattigo_tpu_torch.models import bfv
from lattigo_tpu_torch.models.bfv.keygen import (
    EvaluationKey,
    PublicKey,
    RotationKeys,
    SwitchingKey,
)
from lattigo_tpu_torch.ops import galois, modred, samplers
from lattigo_tpu_torch.ops import u64 as u


def _batch(sk: torch.Tensor) -> tuple:
    """The leading batch axes of a secret key (or of a poly made from one)."""
    return tuple(sk.shape[:-2])


class _Protocol:
    scheme = bfv  # the scheme whose context the protocol runs on
    seed_base = 1000  # the noise seed is seed_base + label unless given

    def __init__(self, params, device=None, seed: int | None = None, label: int = 0):
        self.ctx = self.scheme.get_context(params, device)
        self.params = self.ctx.params
        self.beta = -(-len(self.params.qi) // self.params.alpha)  # blocks at the top level
        self.seed = self.seed_base + label if seed is None else seed
        self.gen = samplers.make_generator(self.ctx.device, self.seed)
        # runs over a party group so far: the index that, with the seed and
        # the party, seeds each party's stream (parallel/protocols.py)
        self.party_runs = 0

    @contextlib.contextmanager
    def using_generator(self, gen: torch.Generator):
        """Draws the protocol's noise from ``gen`` inside the block (the
        hook a party runner uses to give each party its own stream)."""
        old = self.gen
        self.gen = gen
        try:
            yield
        finally:
            self.gen = old

    def _gauss_qp_ntt(self, sigma: float | None = None, batch=()) -> torch.Tensor:
        ring = self.ctx.ring_qp
        sigma = self.params.sigma if sigma is None else sigma
        return ring.ntt(samplers.gaussian_poly(self.gen, ring, sigma, batch=batch))

    def _ternary_qp_ntt(self, p: float, batch=()) -> torch.Tensor:
        ring = self.ctx.ring_qp
        return ring.ntt(samplers.ternary_poly(self.gen, ring, p, montgomery=True, batch=batch))

    def _mod_down(self, x: torch.Tensor) -> torch.Tensor:
        """(x - [x]_P) / P in basis Q for a QP poly ``x``."""
        nq = self.ctx.ring_q.L
        return self.ctx.basis_q_p.mod_down_split_pq(x[..., :nq, :], x[..., nq:, :])

    def _add_block_q(self, e: torch.Tensor, sk_scaled: torch.Tensor, block: int) -> torch.Tensor:
        """Adds ``sk_scaled`` onto the Q limbs of decomposition block ``block``."""
        ring = self.ctx.ring_qp
        n_q = len(self.params.qi)
        start = block * self.params.alpha
        mask = torch.zeros((ring.L, 1), dtype=torch.bool, device=e.device)
        mask[start : min(start + self.params.alpha, n_q)] = True
        return torch.where(mask, ring.add(e, sk_scaled), e)

    def _sk_pool(self, sk: torch.Tensor) -> torch.Tensor:
        """P * sk out of Montgomery form."""
        ring = self.ctx.ring_qp
        return ring.inv_mform(ring.mul_scalar_bigint(sk, self.ctx.ring_p.modulus_bigint))

    def _add_pairs(self, ring, s1, s2):
        return ring.add(s1[0], s2[0]), ring.add(s1[1], s2[1])


class CKGProtocol(_Protocol):
    """Collective public key generation (dbfv/publickey_gen.go)."""

    def gen_share(self, sk: torch.Tensor, crp: torch.Tensor) -> torch.Tensor:
        """share_i = e_i - sk_i * crp, in QP, NTT domain."""
        return self.ctx.ring_qp.mul_coeffs_montgomery_and_sub(
            sk, crp, self._gauss_qp_ntt(batch=_batch(sk)))

    def aggregate(self, s1, s2):
        return self.ctx.ring_qp.add(s1, s2)

    def gen_public_key(self, combined: torch.Tensor, crp: torch.Tensor) -> PublicKey:
        return PublicKey((combined, crp))


class CKSProtocol(_Protocol):
    """Collective key switch sk_in -> sk_out (dbfv/keyswitching.go)."""

    def __init__(self, params, sigma_smudging: float = 6.36, **kw):
        # the reference tests' smudging noise (dbfv/dbfv_test.go:355,409)
        super().__init__(params, **kw)
        self.sigma_smudging = sigma_smudging

    def gen_share(self, sk_in: torch.Tensor, sk_out: torch.Tensor, ct: bfv.Ciphertext) -> torch.Tensor:
        ctx = self.ctx
        rq = ctx.ring_q
        nq = rq.L
        delta = rq.sub(sk_in[..., :nq, :], sk_out[..., :nq, :])
        share = rq.mul_coeffs_montgomery(rq.ntt(ct.value[1]), delta)
        share = rq.intt(rq.mul_scalar_bigint(share, ctx.ring_p.modulus_bigint))
        e = samplers.gaussian_poly(self.gen, ctx.ring_qp, self.sigma_smudging,
                                   batch=_batch(delta))
        share = rq.add(share, e[..., :nq, :])
        return ctx.basis_q_p.mod_down_split_pq(share, e[..., nq:, :])

    def aggregate(self, s1, s2):
        return self.ctx.ring_q.add(s1, s2)

    def key_switch(self, combined: torch.Tensor, ct: bfv.Ciphertext) -> bfv.Ciphertext:
        return bfv.Ciphertext([self.ctx.ring_q.add(ct.value[0], combined), ct.value[1]])


class PCKSProtocol(_Protocol):
    """Public-key collective key switch sk -> pk (dbfv/public_keyswitching.go)."""

    def __init__(self, params, sigma_smudging: float = 6.36, **kw):
        super().__init__(params, **kw)
        self.sigma_smudging = sigma_smudging

    def gen_share(self, sk: torch.Tensor, pk: PublicKey, ct: bfv.Ciphertext):
        ctx = self.ctx
        rqp, rq = ctx.ring_qp, ctx.ring_q
        batch = _batch(sk)
        uu = self._ternary_qp_ntt(0.5, batch)
        h0 = rqp.intt(rqp.mul_coeffs_montgomery(uu, pk.pk[0]))
        h1 = rqp.intt(rqp.mul_coeffs_montgomery(uu, pk.pk[1]))
        h0 = rqp.add(h0, samplers.gaussian_poly(self.gen, rqp, self.sigma_smudging, batch=batch))
        h1 = rqp.add(h1, samplers.gaussian_poly(self.gen, rqp, self.params.sigma, batch=batch))
        s0, s1 = self._mod_down(h0), self._mod_down(h1)
        tmp = rq.intt(rq.mul_coeffs_montgomery(rq.ntt(ct.value[1]), sk[..., : rq.L, :]))
        return rq.add(s0, tmp), s1

    def aggregate(self, s1, s2):
        return self._add_pairs(self.ctx.ring_q, s1, s2)

    def key_switch(self, combined, ct: bfv.Ciphertext) -> bfv.Ciphertext:
        return bfv.Ciphertext([self.ctx.ring_q.add(ct.value[0], combined[0]), combined[1]])


class RKGProtocol(_Protocol):
    """Three-round collective relinearization key (dbfv/relinkey_gen.go).
    ``crp`` is one [beta, L_QP, N] tensor (``CRPGenerator.clock_polys``)."""

    def new_ephemeral_key(self, p: float = 1.0 / 3.0) -> torch.Tensor:
        return self._ternary_qp_ntt(p)

    def gen_share_round_one(self, u_eph: torch.Tensor, sk: torch.Tensor, crp: torch.Tensor) -> torch.Tensor:
        """share_i = -u*crp + P*sk*1_block + e (relinkey_gen.go:212-258)."""
        ring = self.ctx.ring_qp
        pool = self._sk_pool(sk)
        out = []
        for i in range(self.beta):
            e = self._add_block_q(self._gauss_qp_ntt(batch=_batch(sk)), pool, i)
            out.append(ring.mul_coeffs_montgomery_and_sub(u_eph, crp[i], e))
        return torch.stack(out)

    def gen_share_round_two(self, round1: torch.Tensor, sk: torch.Tensor, crp: torch.Tensor):
        """(s_i*round1 + e, s_i*crp + e') (relinkey_gen.go:267-291)."""
        ring = self.ctx.ring_qp
        o0, o1 = [], []
        batch = _batch(sk)
        for i in range(self.beta):
            t0 = ring.mul_coeffs_montgomery(round1[i], sk)
            o0.append(ring.add(t0, self._gauss_qp_ntt(batch=batch)))
            o1.append(ring.mul_coeffs_montgomery_and_add(sk, crp[i], self._gauss_qp_ntt(batch=batch)))
        return torch.stack(o0), torch.stack(o1)

    def gen_share_round_three(self, round2, u_eph: torch.Tensor, sk: torch.Tensor) -> torch.Tensor:
        """(u_i - s_i) * round2[1] + e (relinkey_gen.go:310-325)."""
        ring = self.ctx.ring_qp
        diff = ring.sub(u_eph, sk)
        return torch.stack([
            ring.mul_coeffs_montgomery_and_add(diff, round2[1][i],
                                               self._gauss_qp_ntt(batch=_batch(diff)))
            for i in range(self.beta)
        ])

    def aggregate(self, s1, s2):
        ring = self.ctx.ring_qp
        if isinstance(s1, tuple):
            return self._add_pairs(ring, s1, s2)
        return ring.add(s1, s2)

    def gen_relinearization_key(self, round2, round3: torch.Tensor) -> EvaluationKey:
        """key = (MForm(round2[0] + round3), MForm(round2[1]))
        (relinkey_gen.go:333-348)."""
        ring = self.ctx.ring_qp
        k0 = ring.mform(ring.add(round2[0], round3))
        return EvaluationKey([SwitchingKey(k0, ring.mform(round2[1]))])


class RKGProtocolNaive(_Protocol):
    """Two-round relinearization key through pseudo-encryptions under the
    collective public key (dbfv/relinkey_gen_naive.go)."""

    def gen_share_round_one(self, sk: torch.Tensor, pk: PublicKey):
        """(cpk0*u + P*sk*1_block + e0, cpk1*u + e1) per block.  As in the
        JAX package, e0 and e1 go into their own halves (the reference's
        round one samples e1 over the e0 slot and leaves h1 noiseless)."""
        ring = self.ctx.ring_qp
        pool = self._sk_pool(sk)
        batch = _batch(sk)
        o0, o1 = [], []
        for i in range(self.beta):
            e0 = self._add_block_q(self._gauss_qp_ntt(batch=batch), pool, i)
            e1 = self._gauss_qp_ntt(batch=batch)
            uu = self._ternary_qp_ntt(0.5, batch)
            o0.append(ring.mul_coeffs_montgomery_and_add(pk.pk[0], uu, e0))
            o1.append(ring.mul_coeffs_montgomery_and_add(pk.pk[1], uu, e1))
        return torch.stack(o0), torch.stack(o1)

    def gen_share_round_two(self, round1, sk: torch.Tensor, pk: PublicKey):
        """(sk*r1[0] + cpk0*v + e2, sk*r1[1] + cpk1*v + e3) per block."""
        ring = self.ctx.ring_qp
        batch = _batch(sk)
        o0, o1 = [], []
        for i in range(self.beta):
            h0 = ring.mul_coeffs_montgomery(round1[0][i], sk)
            h1 = ring.mul_coeffs_montgomery(round1[1][i], sk)
            vv = self._ternary_qp_ntt(0.5, batch)
            h0 = ring.mul_coeffs_montgomery_and_add(pk.pk[0], vv, h0)
            h1 = ring.mul_coeffs_montgomery_and_add(pk.pk[1], vv, h1)
            o0.append(ring.add(h0, self._gauss_qp_ntt(batch=batch)))
            o1.append(ring.add(h1, self._gauss_qp_ntt(batch=batch)))
        return torch.stack(o0), torch.stack(o1)

    def aggregate(self, s1, s2):
        return self._add_pairs(self.ctx.ring_qp, s1, s2)

    def gen_relinearization_key(self, round2) -> EvaluationKey:
        ring = self.ctx.ring_qp
        return EvaluationKey([SwitchingKey(ring.mform(round2[0]), ring.mform(round2[1]))])


class RTGProtocol(_Protocol):
    """Collective rotation-key generation (dbfv/rotkey_gen.go).  ``crp`` is
    one [beta, L_QP, N] tensor."""

    def gen_share(self, rot_type: str, k: int, sk: torch.Tensor, crp: torch.Tensor) -> torch.Tensor:
        ctx = self.ctx
        k &= (ctx.n >> 1) - 1
        if rot_type == "left":
            gal_el = ctx.gal_el_rot_col_left[k]
        elif rot_type == "right":
            gal_el = ctx.gal_el_rot_col_right[k]
        elif rot_type == "row":
            gal_el = ctx.gal_el_rot_row
        else:
            raise ValueError(rot_type)
        return self._gen_share(sk, gal_el, crp)

    def _gen_share(self, sk: torch.Tensor, gal_el: int, crp: torch.Tensor) -> torch.Tensor:
        """MForm(P*pi(sk)*1_block - crp*sk + e) per block
        (rotkey_gen.go:143-190)."""
        ring = self.ctx.ring_qp
        pool = self._sk_pool(galois.permute_ntt(sk, gal_el))
        out = []
        for i in range(self.beta):
            e = self._add_block_q(self._gauss_qp_ntt(batch=_batch(sk)), pool, i)
            out.append(ring.mform(ring.mul_coeffs_montgomery_and_sub(crp[i], sk, e)))
        return torch.stack(out)

    def aggregate(self, s1, s2):
        return self.ctx.ring_qp.add(s1, s2)

    def finalize(self, rot_type: str, k: int, combined: torch.Tensor, crp: torch.Tensor,
                 rot_keys: RotationKeys) -> None:
        """Writes the key into ``rot_keys`` (rotkey_gen.go:203-213)."""
        swk = SwitchingKey(combined, self.ctx.ring_qp.mform(crp))
        k &= (self.ctx.n >> 1) - 1
        if rot_type == "left":
            rot_keys.left[k] = swk
        elif rot_type == "right":
            rot_keys.right[k] = swk
        else:
            rot_keys.row = swk


class RefreshProtocol(_Protocol):
    """Collective bootstrap: masked decryption, recode, re-encryption
    (dbfv/public_refresh.go)."""

    def gen_share(self, sk: torch.Tensor, ct: bfv.Ciphertext, crs: torch.Tensor):
        ctx = self.ctx
        rq, rqp = ctx.ring_q, ctx.ring_qp
        nq = rq.L
        batch = _batch(sk)
        # h0 = (P*s*c1 + e)/P + Delta*mask
        h0 = rq.intt(rq.mul_coeffs_montgomery(sk[..., :nq, :], rq.ntt(ct.value[1])))
        h0 = rq.mul_scalar_bigint(h0, ctx.ring_p.modulus_bigint)
        e = samplers.gaussian_poly(self.gen, rqp, 3.19, bound=19, batch=batch)
        h0 = ctx.basis_q_p.mod_down_split_pq(rq.add(h0, e[..., :nq, :]), e[..., nq:, :])
        # h1 = (-s*crs + e')/P - Delta*mask
        h1 = rqp.intt(rqp.neg(rqp.mul_coeffs_montgomery(sk, rqp.ntt(crs))))
        h1 = self._mod_down(rqp.add(h1, samplers.gaussian_poly(self.gen, rqp, 3.19, bound=19,
                                                               batch=batch)))
        mask = self._lift(samplers.uniform_poly(self.gen, ctx.ring_t, batch=batch))
        return rq.add(h0, mask), rq.sub(h1, mask)

    def __init__(self, params, **kw):
        super().__init__(params, **kw)
        delta = np.array(self.ctx.delta_mont, dtype=np.uint64).reshape(-1, 1)
        self._delta_mont = u.from_u64(delta, self.ctx.device)

    def _lift(self, p_t: torch.Tensor) -> torch.Tensor:
        """A poly mod t ([..., 1, N]) times floor(Q/t) in every limb
        (dbfv/public_refresh.go:198-205)."""
        rq = self.ctx.ring_q
        rep = p_t.expand(*p_t.shape[:-2], rq.L, self.ctx.n)
        return modred.mred(rep, self._delta_mont, rq.q_, rq.qinv_)

    def aggregate(self, s1, s2):
        return self._add_pairs(self.ctx.ring_q, s1, s2)

    def finalize(self, ct: bfv.Ciphertext, crs: torch.Tensor, combined) -> bfv.Ciphertext:
        """Decrypt, recode (scale by t/Q and lift again), re-encrypt
        (dbfv/public_refresh.go:170-196)."""
        ctx = self.ctx
        rq = ctx.ring_q
        h0, h1 = combined
        recoded = ctx.scaler_t.scale(rq.add(ct.value[0], h0), 1)
        c0 = rq.add(self._lift(recoded), h1)
        return bfv.Ciphertext([c0, self._mod_down(crs)])
