"""BFV encryption/decryption (bfv/encryptor.go, bfv/decryptor.go)."""

from __future__ import annotations

import torch

from lattigo_tpu_torch.models.bfv.context import get_context
from lattigo_tpu_torch.models.bfv.elements import Ciphertext, Plaintext
from lattigo_tpu_torch.ops import samplers


class Encryptor:
    """pk path: ct = (pk0*u + e0 + m, pk1*u + e1), sampled in QP then divided
    by P via ModDown (bfv/encryptor.go:169-223); the fast path samples in Q.
    sk path: ct = (-a*s + e + m, a) (bfv/encryptor.go:306-345)."""

    def __init__(self, params, pk=None, sk=None, device=None, seed: int = 42):
        assert (pk is None) != (sk is None), "provide exactly one of pk/sk"
        self.ctx = get_context(params, device)
        self.params = self.ctx.params
        self.pk = pk
        self.sk = sk
        self.gen = samplers.make_generator(self.ctx.device, seed)

    def encrypt(self, pt: Plaintext, fast: bool = False) -> Ciphertext:
        if self.pk is not None:
            return self._encrypt_pk(pt, fast)
        return self._encrypt_sk(pt, fast)

    def _mod_down(self, x: torch.Tensor) -> torch.Tensor:
        nq = self.ctx.ring_q.L
        return self.ctx.basis_q_p.mod_down_split_pq(x[:nq], x[nq:])

    def _encrypt_pk(self, pt: Plaintext, fast: bool) -> Ciphertext:
        ctx = self.ctx
        ring = ctx.ring_q if fast else ctx.ring_qp
        pk0, pk1 = self.pk.pk
        if fast:
            pk0, pk1 = pk0[: ring.L], pk1[: ring.L]
        sigma = self.params.sigma
        uu = ring.ntt(samplers.ternary_poly(self.gen, ring, p=0.5, montgomery=True))
        c0 = ring.intt(ring.mul_coeffs_montgomery(uu, pk0))
        c1 = ring.intt(ring.mul_coeffs_montgomery(uu, pk1))
        c0 = ring.add(c0, samplers.gaussian_poly(self.gen, ring, sigma))
        c1 = ring.add(c1, samplers.gaussian_poly(self.gen, ring, sigma))
        if not fast:
            c0, c1 = self._mod_down(c0), self._mod_down(c1)
        return Ciphertext([ctx.ring_q.add(c0, pt.value), c1])

    def _encrypt_sk(self, pt: Plaintext, fast: bool) -> Ciphertext:
        ctx = self.ctx
        ring = ctx.ring_q if fast else ctx.ring_qp
        a = samplers.uniform_poly(self.gen, ring)
        sk = self.sk.sk[: ring.L]
        c0 = ring.intt(ring.neg(ring.mul_coeffs_montgomery(a, sk)))
        a_coeff = ring.intt(a)
        c0 = ring.add(c0, samplers.gaussian_poly(self.gen, ring, self.params.sigma))
        if not fast:
            c0, a_coeff = self._mod_down(c0), self._mod_down(a_coeff)
        return Ciphertext([ctx.ring_q.add(c0, pt.value), a_coeff])


class Decryptor:
    """NTT-domain Horner over the ciphertext degree (bfv/decryptor.go:55-73)."""

    def __init__(self, params, sk, device=None):
        self.ctx = get_context(params, device)
        self.sk = sk

    def decrypt(self, ct: Ciphertext) -> Plaintext:
        ring = self.ctx.ring_q
        sk = self.sk.sk[: ring.L]
        acc = ring.ntt(ct.value[ct.degree])
        for i in range(ct.degree, 0, -1):
            acc = ring.mul_coeffs_montgomery(acc, sk)
            acc = ring.add(acc, ring.ntt(ct.value[i - 1]))
        return Plaintext(ring.intt(ring.reduce(acc)))
