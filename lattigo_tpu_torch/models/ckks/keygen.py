"""CKKS key generation (ckks/keygen.go).

The same stacked-key layout as the BFV generator (the secret, public and
switching keys are the BFV classes: [L_QP, N] NTT-domain polys, switching
keys [beta, L_QP, N]); adds sparse secret keys and rotation and conjugation
keys.  Switching-key blocks are restricted to Q limbs (ckks/keygen.go:282-333).
"""

from __future__ import annotations

import dataclasses

import torch

from lattigo_tpu_torch.models.bfv.keygen import PublicKey, SecretKey, SwitchingKey
from lattigo_tpu_torch.models.ckks.context import get_context
from lattigo_tpu_torch.ops import galois, samplers
from lattigo_tpu_torch.utils import profiling


@dataclasses.dataclass
class EvaluationKey:
    evakey: SwitchingKey  # relinearization s^2 -> s


@dataclasses.dataclass
class RotationKeys:
    left: dict[int, SwitchingKey] = dataclasses.field(default_factory=dict)
    right: dict[int, SwitchingKey] = dataclasses.field(default_factory=dict)
    conjugate: SwitchingKey | None = None


@profiling.spanned("ckks")
class KeyGenerator:
    """ckks/keygen.go; every draw comes from one explicit ``torch.Generator``
    on the context's device, seeded with ``seed``."""

    def __init__(self, params, device=None, seed: int = 0):
        self.ctx = get_context(params, device)
        self.params = self.ctx.params
        self.gen = samplers.make_generator(self.ctx.device, seed)

    def gen_secret_key(self, p: float = 1.0 / 3.0) -> SecretKey:
        ring = self.ctx.ring_qp
        return SecretKey(ring.ntt(samplers.ternary_poly(self.gen, ring, p=p, montgomery=True)))

    def gen_secret_key_sparse(self, hw: int) -> SecretKey:
        """hw nonzero +-1 coefficients (ckks/keygen.go:110-114)."""
        ring = self.ctx.ring_qp
        return SecretKey(ring.ntt(samplers.ternary_sparse_poly(self.gen, ring, hw, montgomery=True)))

    def gen_public_key(self, sk: SecretKey) -> PublicKey:
        """pk = (-(a*s + e), a) in QP, NTT domain."""
        ring = self.ctx.ring_qp
        e = ring.ntt(samplers.gaussian_poly(self.gen, ring, self.params.sigma))
        a = samplers.uniform_poly(self.gen, ring)
        pk0 = ring.neg(ring.mul_coeffs_montgomery_and_add(sk.sk, a, e))
        return PublicKey((pk0, a))

    def gen_key_pair(self) -> tuple[SecretKey, PublicKey]:
        sk = self.gen_secret_key()
        return sk, self.gen_public_key(sk)

    def gen_key_pair_sparse(self, hw: int) -> tuple[SecretKey, PublicKey]:
        sk = self.gen_secret_key_sparse(hw)
        return sk, self.gen_public_key(sk)

    def gen_relin_key(self, sk: SecretKey) -> EvaluationKey:
        ring = self.ctx.ring_qp
        sk2 = ring.mul_coeffs_montgomery(sk.sk, sk.sk)
        return EvaluationKey(self._new_switching_key(sk2, sk.sk))

    def gen_switching_key(self, sk_in: SecretKey, sk_out: SecretKey) -> SwitchingKey:
        return self._new_switching_key(sk_in.sk, sk_out.sk)

    def _new_switching_key(self, sk_in: torch.Tensor, sk_out: torch.Tensor) -> SwitchingKey:
        """evakey_i = 2^64*(e + P*skIn*1_block - a*skOut)
        (ckks/keygen.go:282-333; blocks limited to Q limbs)."""
        ring = self.ctx.ring_qp
        params = self.params
        sk_in_scaled = ring.mul_scalar_bigint(sk_in, self.ctx.ring_p.modulus_bigint)
        n_q = len(params.qi)
        k0s, k1s = [], []
        for i in range(params.beta()):
            e = ring.mform(ring.ntt(samplers.gaussian_poly(self.gen, ring, params.sigma)))
            a = samplers.uniform_poly(self.gen, ring)
            start = i * params.alpha
            mask = torch.zeros((ring.L, 1), dtype=torch.bool, device=e.device)
            mask[start : min(start + params.alpha, n_q)] = True
            e = torch.where(mask, ring.add(e, sk_in_scaled), e)
            k0s.append(ring.mul_coeffs_montgomery_and_sub(a, sk_out, e))
            k1s.append(a)
        return SwitchingKey(torch.stack(k0s), torch.stack(k1s))

    def gen_rot(self, rot_type: str, sk: SecretKey, k: int, rot_keys: RotationKeys) -> None:
        """Adds the key of one rotation ("left" or "right" by k, or
        "conjugate") to ``rot_keys``."""
        ctx = self.ctx
        k &= (ctx.n >> 1) - 1
        if rot_type == "left":
            if k != 0 and k not in rot_keys.left:
                rot_keys.left[k] = self._gen_rot_key(sk, ctx.gal_el_rot_col_left[k])
        elif rot_type == "right":
            if k != 0 and k not in rot_keys.right:
                rot_keys.right[k] = self._gen_rot_key(sk, ctx.gal_el_rot_col_right[k])
        elif rot_type == "conjugate":
            rot_keys.conjugate = self._gen_rot_key(sk, ctx.gal_el_conjugate)
        else:
            raise ValueError(rot_type)

    def gen_rotation_keys_pow2(self, sk: SecretKey, conjugate: bool = True) -> RotationKeys:
        rk = RotationKeys()
        ctx = self.ctx
        i = 1
        while i < ctx.n >> 1:
            rk.left[i] = self._gen_rot_key(sk, ctx.gal_el_rot_col_left[i])
            rk.right[i] = self._gen_rot_key(sk, ctx.gal_el_rot_col_right[i])
            i <<= 1
        if conjugate:
            rk.conjugate = self._gen_rot_key(sk, ctx.gal_el_conjugate)
        return rk

    def _gen_rot_key(self, sk: SecretKey, gal_el: int) -> SwitchingKey:
        return self._new_switching_key(galois.permute_ntt(sk.sk, gal_el), sk.sk)
