"""Distributed (threshold) CKKS protocols (dckks/).

Counterpart of ``lattigo_tpu/models/dckks/protocols.py``.  The protocols
have dBFV's shapes (party-local ``gen_share*``, an associative
``aggregate``, a deterministic finishing step) but are level-aware and work
on NTT-domain ciphertexts, and the collective refresh restores the level as
well as the noise budget (dckks/public_refresh.go:109-140).

The collective public, relinearization and rotation keys compute exactly
what their dBFV twins compute on the same Q·P keys, so those protocols are
the dBFV classes run on the CKKS context; they differ only in the key
objects they return and in the conjugation key.  Each protocol draws its
noise from one ``torch.Generator`` seeded with ``seed`` (default
``2000 + label``, as the JAX package's key); torch cannot reproduce
``jax.random`` bits, so shares agree with the JAX package's in
distribution, and every deterministic step agrees bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from lattigo_tpu_torch.models import ckks
from lattigo_tpu_torch.models.ckks.elements import drop_to_level
from lattigo_tpu_torch.models.ckks.keygen import EvaluationKey, PublicKey, RotationKeys, SwitchingKey
from lattigo_tpu_torch.models.dbfv import protocols as dbfv
from lattigo_tpu_torch.ops import basis_ext, samplers


class _Protocol(dbfv._Protocol):
    scheme = ckks
    seed_base = 2000

    def _mod_down_ntt(self, x: torch.Tensor, lvl: int) -> torch.Tensor:
        """(x - [x]_P) / P in basis Q[0..lvl] for a QP poly ``x``, NTT domain
        in and out: the Q limbs above ``lvl`` are dropped."""
        return self.ctx.basis_q_p.mod_down_split_ntt_pq(
            x[..., : lvl + 1, :], x[..., self.ctx.ring_q.L :, :])


class CKGProtocol(_Protocol, dbfv.CKGProtocol):
    """Collective public key (dckks/publickey_gen.go)."""


class CKSProtocol(_Protocol):
    """Collective key switch sk_in -> sk_out at the ciphertext's level
    (dckks/keyswitching.go)."""

    def __init__(self, params, sigma_smudging: float = 6.36, **kw):
        # the reference tests' smudging noise (dbfv/dbfv_test.go:355,409)
        super().__init__(params, **kw)
        self.sigma_smudging = sigma_smudging

    def gen_share(self, sk_in: torch.Tensor, sk_out: torch.Tensor, ct: ckks.Ciphertext) -> torch.Tensor:
        """((sk_in - sk_out) * c1 * P + e) / P at the level of ``ct``."""
        ctx = self.ctx
        rq = ctx.ring_q
        lvl = ct.level
        delta = rq.sub(drop_to_level(sk_in, lvl), drop_to_level(sk_out, lvl))
        share = rq.mul_coeffs_montgomery(ct.value[1], delta)
        share = rq.mul_scalar_bigint(share, ctx.ring_p.modulus_bigint)
        e = self._gauss_qp_ntt(self.sigma_smudging)
        share = rq.add(share, e[..., : lvl + 1, :])
        return ctx.basis_q_p.mod_down_split_ntt_pq(share, e[..., rq.L :, :])

    def aggregate(self, s1, s2):
        return self.ctx.ring_q.add(s1, s2)

    def key_switch(self, combined: torch.Tensor, ct: ckks.Ciphertext) -> ckks.Ciphertext:
        return ckks.Ciphertext([self.ctx.ring_q.add(ct.value[0], combined), ct.value[1]], ct.scale)


class PCKSProtocol(_Protocol):
    """Public-key collective key switch sk -> pk at the ciphertext's level
    (dckks/public_keyswitching.go)."""

    def __init__(self, params, sigma_smudging: float = 6.36, **kw):
        super().__init__(params, **kw)
        self.sigma_smudging = sigma_smudging

    def gen_share(self, sk: torch.Tensor, pk: PublicKey, ct: ckks.Ciphertext):
        """((u*pk0 + e0) / P + sk*c1, (u*pk1 + e1) / P) at the level of ``ct``."""
        rqp, rq = self.ctx.ring_qp, self.ctx.ring_q
        lvl = ct.level
        uu = self._ternary_qp_ntt(0.5)
        h0 = rqp.mul_coeffs_montgomery(uu, pk.pk[0])
        h1 = rqp.mul_coeffs_montgomery(uu, pk.pk[1])
        h0 = rqp.add(h0, self._gauss_qp_ntt(self.sigma_smudging))
        h1 = rqp.add(h1, self._gauss_qp_ntt())
        s0, s1 = self._mod_down_ntt(h0, lvl), self._mod_down_ntt(h1, lvl)
        return rq.add(s0, rq.mul_coeffs_montgomery(ct.value[1], drop_to_level(sk, lvl))), s1

    def aggregate(self, s1, s2):
        return self._add_pairs(self.ctx.ring_q, s1, s2)

    def key_switch(self, combined, ct: ckks.Ciphertext) -> ckks.Ciphertext:
        return ckks.Ciphertext([self.ctx.ring_q.add(ct.value[0], combined[0]), combined[1]], ct.scale)


class RKGProtocol(_Protocol, dbfv.RKGProtocol):
    """Three-round collective relinearization key (dckks/relinkey_gen.go).
    ``crp`` is one [beta, L_QP, N] tensor (``CRPGenerator.clock_polys``)."""

    def gen_relinearization_key(self, round2, round3: torch.Tensor) -> EvaluationKey:
        return EvaluationKey(super().gen_relinearization_key(round2, round3).evakey[0])


class RKGProtocolNaive(_Protocol, dbfv.RKGProtocolNaive):
    """Two-round relinearization key through pseudo-encryptions under the
    collective public key (dckks/relinkey_gen_naive.go)."""

    def gen_relinearization_key(self, round2) -> EvaluationKey:
        return EvaluationKey(super().gen_relinearization_key(round2).evakey[0])


class RTGProtocol(_Protocol, dbfv.RTGProtocol):
    """Collective rotation keys and the conjugation key
    (dckks/rotkey_gen.go).  ``crp`` is one [beta, L_QP, N] tensor."""

    def gen_share(self, rot_type: str, k: int, sk: torch.Tensor, crp: torch.Tensor) -> torch.Tensor:
        ctx = self.ctx
        k &= (ctx.n >> 1) - 1
        if rot_type == "left":
            gal_el = ctx.gal_el_rot_col_left[k]
        elif rot_type == "right":
            gal_el = ctx.gal_el_rot_col_right[k]
        elif rot_type == "conjugate":
            gal_el = ctx.gal_el_conjugate
        else:
            raise ValueError(rot_type)
        return self._gen_share(sk, gal_el, crp)

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
            rot_keys.conjugate = swk


class RefreshProtocol(_Protocol):
    """Collective bootstrap: masked decryption at the ciphertext's level,
    recode to the top level, re-encryption (dckks/public_refresh.go).

    A share is ``(h0, h1)``: h0 at the ciphertext's level, h1 at the top
    level.  ``gen_shares`` is ``gen_mask_planes`` (host big integers) then
    ``gen_share_masked`` (device)."""

    def __init__(self, params, **kw):
        super().__init__(params, **kw)
        self._recode: dict[int, basis_ext.ModUpParams] = {}

    def _uniform_bigint_vec(self, bound: int) -> np.ndarray:
        """N uniform big integers in [0, bound) from 32-bit words drawn from
        the protocol's generator, 64 bits more than the bound needs."""
        n_words = (bound.bit_length() + 64 + 31) // 32
        gen = self.gen
        words = torch.randint(0, 1 << 32, (n_words, self.ctx.n), generator=gen,
                              device=gen.device, dtype=torch.int64).cpu().numpy()
        acc = np.zeros(self.ctx.n, dtype=object)
        for w in range(n_words):
            acc += words[w].astype(object) << (32 * w)
        return acc % bound

    def gen_mask_planes(self, n_parties: int, lvl: int) -> tuple[torch.Tensor, torch.Tensor]:
        """One party's smudging mask, uniform in [-B/2, B/2) with
        B = Q_lvl / (2 n_parties) (dckks/public_refresh.go:49-64), as RNS
        planes at level ``lvl`` and at the top level.  Host work: N big
        integers of about log2(Q_lvl) bits."""
        rq = self.ctx.ring_q
        bound = 1
        for q in rq.moduli[: lvl + 1]:
            bound *= q
        bound //= 2 * n_parties
        r = self._uniform_bigint_vec(bound)
        mask = np.where(r >= bound >> 1, r - bound, r)
        return rq.set_coeffs_bigint(mask, lvl), rq.set_coeffs_bigint(mask)

    def gen_share_masked(self, sk: torch.Tensor, ct_c1: torch.Tensor, crs: torch.Tensor,
                         mask_lvl: torch.Tensor, mask_full: torch.Tensor):
        """The device part of a share (dckks/public_refresh.go:66-96):
        h0 = mask + sk*c1 + e0 at the mask's level,
        h1 = -(mask + sk*crs + e1) at the top level."""
        rq = self.ctx.ring_q
        lvl = rq.level_of(mask_lvl)
        h0 = rq.add(rq.ntt(mask_lvl), rq.mul_coeffs_montgomery(drop_to_level(sk, lvl), ct_c1))
        h1 = rq.add(rq.ntt(mask_full), rq.mul_coeffs_montgomery(drop_to_level(sk, rq.L - 1), crs))
        h0 = rq.add(h0, rq.ntt(samplers.gaussian_poly(self.gen, rq, 3.19, lvl=lvl)))
        h1 = rq.neg(rq.add(h1, rq.ntt(samplers.gaussian_poly(self.gen, rq, 3.19))))
        return h0, h1

    def gen_shares(self, sk: torch.Tensor, n_parties: int, ct: ckks.Ciphertext, crs: torch.Tensor):
        """(h0 at the level of ``ct``, h1 at the top level)."""
        mask_lvl, mask_full = self.gen_mask_planes(n_parties, ct.level)
        return self.gen_share_masked(sk, ct.value[1], crs, mask_lvl, mask_full)

    def aggregate(self, s1, s2):
        return self._add_pairs(self.ctx.ring_q, s1, s2)

    def recode_params(self, lvl: int) -> basis_ext.ModUpParams:
        """The tables of the centered Q[0..lvl] -> Q[lvl+1..] extension,
        built once per level."""
        if lvl not in self._recode:
            moduli = self.ctx.ring_q.moduli
            self._recode[lvl] = basis_ext.ModUpParams(moduli[: lvl + 1], moduli[lvl + 1 :],
                                                      self.ctx.device)
        return self._recode[lvl]

    def finalize(self, ct: ckks.Ciphertext, crs: torch.Tensor, combined) -> ckks.Ciphertext:
        """Decrypt, recode at the top level, re-encrypt
        (dckks/public_refresh.go:102-151).  The recode lifts the centered
        representative of the level-``lvl`` coefficients to the upper limbs
        with one device basis extension (``mod_up(centered=True)``); the
        limbs up to ``lvl`` keep their residues."""
        rq = self.ctx.ring_q
        h0, h1 = combined
        lvl = ct.level
        masked = rq.intt(rq.add(ct.value[0], h0))
        if lvl + 1 < rq.L:
            upper = basis_ext.mod_up(masked, self.recode_params(lvl), centered=True)
            masked = torch.cat([masked, upper], dim=-2)
        return ckks.Ciphertext([rq.add(rq.ntt(masked), h1), crs], ct.scale)

    def finalize_bigint(self, ct: ckks.Ciphertext, crs: torch.Tensor, combined) -> ckks.Ciphertext:
        """The host big-integer twin of :meth:`finalize` (the reference's
        exact path), the oracle of its device recode."""
        rq = self.ctx.ring_q
        h0, h1 = combined
        lvl = ct.level
        coeffs = rq.poly_to_bigint_vec(rq.intt(rq.add(ct.value[0], h0)))
        q_lvl = 1
        for q in rq.moduli[: lvl + 1]:
            q_lvl *= q
        centered = np.where(coeffs >= q_lvl >> 1, coeffs - q_lvl, coeffs)
        c0 = rq.add(rq.ntt(rq.set_coeffs_bigint(centered)), h1)
        return ckks.Ciphertext([c0, crs], ct.scale)
