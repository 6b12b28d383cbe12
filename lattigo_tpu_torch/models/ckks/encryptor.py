"""CKKS encryption/decryption (ckks/encryptor.go, ckks/decryptor.go).
Ciphertexts live in the NTT domain."""

from __future__ import annotations

from lattigo_tpu_torch.models.ckks.context import get_context
from lattigo_tpu_torch.models.ckks.elements import Ciphertext, Plaintext, drop_to_level
from lattigo_tpu_torch.ops import samplers
from lattigo_tpu_torch.utils import profiling


@profiling.spanned("ckks")
class Encryptor:
    """pk path: ct = (pk0*u + e0 + m, pk1*u + e1), sampled in QP and divided
    by P (ckks/encryptor.go:179-237); the fast path samples in Q.  sk path:
    ct = (-a*s + e + m, a).  Every draw comes from one ``torch.Generator``
    seeded with ``seed``."""

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
        return self._encrypt_sk(pt, None, fast)

    def encrypt_from_crp(self, pt: Plaintext, crp, fast: bool = False) -> Ciphertext:
        """The sk path with a given uniform NTT-domain polynomial (a common
        reference polynomial of the threshold protocols) in place of a fresh
        one."""
        if self.sk is None:
            raise ValueError("CRP encryption requires a secret key")
        return self._encrypt_sk(pt, crp, fast)

    def _mod_down_ntt(self, x, lvl: int):
        """QP coefficient-domain poly -> basis Q[0..lvl], NTT domain."""
        ctx = self.ctx
        nq = ctx.ring_q.L
        return ctx.ring_q.ntt(ctx.basis_q_p.mod_down_split_pq(x[..., : lvl + 1, :], x[..., nq:, :]))

    def _encrypt_pk(self, pt: Plaintext, fast: bool) -> Ciphertext:
        ctx = self.ctx
        lvl = pt.level
        sigma = self.params.sigma
        gen = self.gen
        if fast:
            ring = ctx.ring_q
            pk0, pk1 = (drop_to_level(p, ring.L - 1) for p in self.pk.pk)
            uu = ring.ntt(samplers.ternary_poly(gen, ring, 0.5, montgomery=True))
            c0 = ring.mul_coeffs_montgomery(uu, pk0)
            c1 = ring.mul_coeffs_montgomery(uu, pk1)
            c0 = ring.add(c0, ring.ntt(samplers.gaussian_poly(gen, ring, sigma)))
            c1 = ring.add(c1, ring.ntt(samplers.gaussian_poly(gen, ring, sigma)))
            c0, c1 = drop_to_level(c0, lvl), drop_to_level(c1, lvl)
        else:
            ring = ctx.ring_qp
            uu = ring.ntt(samplers.ternary_poly(gen, ring, 0.5, montgomery=True))
            c0 = ring.intt(ring.mul_coeffs_montgomery(uu, self.pk.pk[0]))
            c1 = ring.intt(ring.mul_coeffs_montgomery(uu, self.pk.pk[1]))
            c0 = ring.add(c0, samplers.gaussian_poly(gen, ring, sigma))
            c1 = ring.add(c1, samplers.gaussian_poly(gen, ring, sigma))
            c0, c1 = self._mod_down_ntt(c0, lvl), self._mod_down_ntt(c1, lvl)
        return Ciphertext([ctx.ring_q.add(c0, pt.value), c1], pt.scale)

    def _encrypt_sk(self, pt: Plaintext, crp, fast: bool) -> Ciphertext:
        ctx = self.ctx
        lvl = pt.level
        sigma = self.params.sigma
        ring = ctx.ring_q if fast else ctx.ring_qp
        a = samplers.uniform_poly(self.gen, ring) if crp is None else crp
        sk = drop_to_level(self.sk.sk, ring.L - 1)
        c0 = ring.neg(ring.mul_coeffs_montgomery(a, sk))
        if fast:
            c0 = ring.add(c0, ring.ntt(samplers.gaussian_poly(self.gen, ring, sigma)))
            c0, c1 = drop_to_level(c0, lvl), drop_to_level(a, lvl)
        else:
            c0 = ring.add(ring.intt(c0), samplers.gaussian_poly(self.gen, ring, sigma))
            c0, c1 = self._mod_down_ntt(c0, lvl), self._mod_down_ntt(ring.intt(a), lvl)
        return Ciphertext([ctx.ring_q.add(c0, pt.value), c1], pt.scale)


@profiling.spanned("ckks")
class Decryptor:
    """NTT-domain Horner over the ciphertext degree (ckks/decryptor.go:53-79)."""

    def __init__(self, params, sk, device=None):
        self.ctx = get_context(params, device)
        self.sk = sk

    def decrypt(self, ct: Ciphertext) -> Plaintext:
        ring = self.ctx.ring_q
        sk = drop_to_level(self.sk.sk, ct.level)
        acc = ct.value[ct.degree]
        for i in range(ct.degree, 0, -1):
            acc = ring.mul_coeffs_montgomery(acc, sk)
            acc = ring.add(acc, ct.value[i - 1])
        return Plaintext(ring.reduce(acc), ct.scale)
