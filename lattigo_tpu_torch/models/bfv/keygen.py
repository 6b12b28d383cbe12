"""BFV key generation (bfv/keygen.go).

Key material lives in the QP basis, NTT domain; the secret key and switching
keys follow the reference's implicit-Montgomery convention: the uniform "a"
polynomials are read as the Montgomery form of the actual CRS, so switching
keys satisfy  evakey0 = 2^64*(e + P*skIn*1_block - a*skOut)  limb-wise
(bfv/keygen.go:285-333).  Switching keys are stored stacked as
[beta, L_QP, N] tensors.  Rotation keys hold the column rotations to the
left and right and the row swap (CKKS's have the conjugation instead).
"""

from __future__ import annotations

import dataclasses

import torch

from lattigo_tpu_torch.models.bfv.context import get_context
from lattigo_tpu_torch.ops import galois, samplers
from lattigo_tpu_torch.utils import profiling


@dataclasses.dataclass
class SecretKey:
    sk: torch.Tensor  # [L_QP, N], NTT + Montgomery


@dataclasses.dataclass
class PublicKey:
    pk: tuple[torch.Tensor, torch.Tensor]  # ([L_QP, N], [L_QP, N]), NTT domain


@dataclasses.dataclass
class SwitchingKey:
    key0: torch.Tensor  # [beta, L_QP, N]
    key1: torch.Tensor  # [beta, L_QP, N]


@dataclasses.dataclass
class EvaluationKey:
    evakey: list[SwitchingKey]  # one per relinearized degree


@dataclasses.dataclass
class RotationKeys:
    left: dict[int, SwitchingKey] = dataclasses.field(default_factory=dict)
    right: dict[int, SwitchingKey] = dataclasses.field(default_factory=dict)
    row: SwitchingKey | None = None


@profiling.spanned("bfv")
class KeyGenerator:
    """bfv/keygen.go:8-17; every draw comes from one explicit
    ``torch.Generator`` on the context's device, seeded with ``seed``."""

    def __init__(self, params, device=None, seed: int = 0):
        self.ctx = get_context(params, device)
        self.params = self.ctx.params
        self.gen = samplers.make_generator(self.ctx.device, seed)

    def gen_secret_key(self, p: float = 1.0 / 3.0) -> SecretKey:
        ring = self.ctx.ring_qp
        return SecretKey(ring.ntt(samplers.ternary_poly(self.gen, ring, p=p, montgomery=True)))

    def gen_secret_key_sparse(self, hw: int) -> SecretKey:
        """``hw`` nonzero +-1 coefficients."""
        ring = self.ctx.ring_qp
        return SecretKey(ring.ntt(samplers.ternary_sparse_poly(self.gen, ring, hw, montgomery=True)))

    def gen_public_key(self, sk: SecretKey) -> PublicKey:
        """pk = (-(a*s + e), a) in QP, NTT domain (bfv/keygen.go:121-136)."""
        ring = self.ctx.ring_qp
        e = ring.ntt(samplers.gaussian_poly(self.gen, ring, self.params.sigma))
        a = samplers.uniform_poly(self.gen, ring)
        pk0 = ring.neg(ring.mul_coeffs_montgomery_and_add(sk.sk, a, e))
        return PublicKey((pk0, a))

    def gen_key_pair(self) -> tuple[SecretKey, PublicKey]:
        sk = self.gen_secret_key()
        return sk, self.gen_public_key(sk)

    def gen_relin_key(self, sk: SecretKey, max_degree: int = 1) -> EvaluationKey:
        """Keys for s^2..s^(maxDegree+1) -> s (bfv/keygen.go:172-196)."""
        ring = self.ctx.ring_qp
        assert self.ctx.ring_p is not None, "modulus P is empty"
        pool = ring.mul_scalar_bigint(sk.sk, self.ctx.ring_p.modulus_bigint)
        keys = []
        for _ in range(max_degree):
            pool = ring.mul_coeffs_montgomery(pool, sk.sk)
            keys.append(self._new_switching_key(pool, sk.sk))
        return EvaluationKey(keys)

    def gen_switching_key(self, sk_in: SecretKey, sk_out: SecretKey) -> SwitchingKey:
        ring = self.ctx.ring_qp
        pool = ring.mul_scalar_bigint(sk_in.sk, self.ctx.ring_p.modulus_bigint)
        return self._new_switching_key(pool, sk_out.sk)

    def _new_switching_key(self, sk_in_scaled: torch.Tensor, sk_out: torch.Tensor) -> SwitchingKey:
        """bfv/keygen.go:285-333.  sk_in_scaled = P * skIn (Montgomery, NTT).
        Blocks are always restricted to Q limbs (as in the JAX package)."""
        ring = self.ctx.ring_qp
        params = self.params
        n_q = len(params.qi)
        k0_planes, k1_planes = [], []
        for i in range(params.beta):
            e = ring.mform(ring.ntt(samplers.gaussian_poly(self.gen, ring, params.sigma)))
            a = samplers.uniform_poly(self.gen, ring)
            # add P*skIn on the block's Q limbs only
            start = i * params.alpha
            end = min(start + params.alpha, n_q)
            mask = torch.zeros((ring.L, 1), dtype=torch.bool, device=e.device)
            mask[start:end] = True
            e = torch.where(mask, ring.add(e, sk_in_scaled), e)
            k0_planes.append(ring.mul_coeffs_montgomery_and_sub(a, sk_out, e))
            k1_planes.append(a)
        return SwitchingKey(torch.stack(k0_planes), torch.stack(k1_planes))

    def gen_rot(self, rot_type: str, sk: SecretKey, k: int, rot_keys: RotationKeys) -> None:
        """Adds the key of one rotation ("left" or "right" by k, or the
        "row" swap) to ``rot_keys`` (bfv/keygen.go:342-369)."""
        ctx = self.ctx
        k &= (ctx.n >> 1) - 1
        if rot_type == "left":
            if k != 0 and k not in rot_keys.left:
                rot_keys.left[k] = self._gen_rot_key(sk, ctx.gal_el_rot_col_left[k])
        elif rot_type == "right":
            if k != 0 and k not in rot_keys.right:
                rot_keys.right[k] = self._gen_rot_key(sk, ctx.gal_el_rot_col_right[k])
        elif rot_type == "row":
            rot_keys.row = self._gen_rot_key(sk, ctx.gal_el_rot_row)
        else:
            raise ValueError(rot_type)

    def gen_rotation_keys_pow2(self, sk: SecretKey) -> RotationKeys:
        """Every power-of-two rotation to the left and right, and the row
        swap (bfv/keygen.go:372-388)."""
        rk = RotationKeys()
        ctx = self.ctx
        i = 1
        while i < ctx.n >> 1:
            rk.left[i] = self._gen_rot_key(sk, ctx.gal_el_rot_col_left[i])
            rk.right[i] = self._gen_rot_key(sk, ctx.gal_el_rot_col_right[i])
            i <<= 1
        rk.row = self._gen_rot_key(sk, ctx.gal_el_rot_row)
        return rk

    def _gen_rot_key(self, sk: SecretKey, gal_el: int) -> SwitchingKey:
        """genrotkey (bfv/keygen.go:429-441): skIn = pi_galois(sk)."""
        ring = self.ctx.ring_qp
        permuted = galois.permute_ntt(sk.sk, gal_el)
        pool = ring.mul_scalar_bigint(permuted, self.ctx.ring_p.modulus_bigint)
        return self._new_switching_key(pool, sk.sk)
