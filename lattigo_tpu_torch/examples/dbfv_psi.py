"""N-party private set intersection over threshold BFV
(examples/dbfv/psi/psi.go): CKG -> two-round relinearization key ->
encrypt binary set vectors -> slot-wise AND (multiplication chain) -> PCKS
to an output key -> decrypt.

The twin of ``examples/dbfv_psi.py``.  Defaults: 3 parties at the
reference's PN13QP218 (N = 8192); below log N = 13 the small test set.  On
CUDA the AND chain runs as one ``tjit`` program (a captured graph), as the
JAX example compiles it on an accelerator; on the CPU it runs eagerly, as
the JAX example does there.  Run (on the GPU; ``cpu`` as a third argument
runs it on the CPU):

    python -m lattigo_tpu_torch.examples.dbfv_psi [n_parties] [log_n] [cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from lattigo_tpu_torch.entry import fold
from lattigo_tpu_torch.models import bfv, dbfv
from lattigo_tpu_torch.tjit import tjit
from lattigo_tpu_torch.utils.prng import CRPGenerator


class Psi:
    """The example's stages; :meth:`run` drives them in order:
    ``keygen`` -> ``encrypt`` -> ``and_chain`` -> ``pcks`` -> ``decrypt``.
    ``ev`` is the evaluator the AND chain calls (wrap it to profile it);
    ``compiled_and_chain`` is ``and_chain`` as one ``tjit`` program, which
    :meth:`run` calls on CUDA."""

    def __init__(self, n_parties: int = 3, log_n: int = 13, device=None):
        if log_n >= 13:
            params = bfv.default_params(bfv.PN13QP218)
        else:
            params = bfv.Parameters(
                log_n=log_n, t=65537, log_qi=(46, 46), log_pi=(47,), log_qi_mul=(60, 60)
            ).gen_from_log_moduli()
        self.params = params
        self.ctx = ctx = bfv.get_context(params, device)
        self.device = device = ctx.device
        self.sks = [bfv.KeyGenerator(params, device=device, seed=i).gen_secret_key()
                    for i in range(n_parties)]
        self.crp_gen = CRPGenerator(b"psi", ctx.ring_qp)
        self.crp_gen.seed(b"seed")
        self.enc = bfv.Encoder(params, device=device)
        self.ev = bfv.Evaluator(params, device=device)
        rng = np.random.default_rng(7)  # each party's set as a binary slot vector
        self.sets = [rng.integers(0, 2, params.n).astype(np.uint64) for _ in range(n_parties)]
        self.compiled_and_chain = tjit(self.and_chain)

    def keygen(self) -> tuple[bfv.PublicKey, bfv.EvaluationKey]:
        """The collective public key, then the two-round relinearization key."""
        ckg = dbfv.CKGProtocol(self.params, device=self.device)
        crp = self.crp_gen.clock_poly()
        pk = ckg.gen_public_key(fold(ckg, [ckg.gen_share(sk.sk, crp) for sk in self.sks]), crp)
        rkg = dbfv.RKGProtocolNaive(self.params, device=self.device)
        r1 = fold(rkg, [rkg.gen_share_round_one(sk.sk, pk) for sk in self.sks])
        r2 = fold(rkg, [rkg.gen_share_round_two(r1, sk.sk, pk) for sk in self.sks])
        return pk, rkg.gen_relinearization_key(r2)

    def encrypt(self, pk: bfv.PublicKey) -> list[bfv.Ciphertext]:
        encryptor = bfv.Encryptor(self.params, pk=pk, device=self.device)
        return [encryptor.encrypt(self.enc.encode_uint(s)) for s in self.sets]

    def and_chain(self, cts: list[bfv.Ciphertext], rlk: bfv.EvaluationKey) -> bfv.Ciphertext:
        """Slot-wise AND: the product of every party's binary vector."""
        acc = cts[0]
        for ct in cts[1:]:
            acc = self.ev.relinearize(self.ev.mul(acc, ct), rlk)
        return acc

    def pcks(self, acc: bfv.Ciphertext) -> tuple[bfv.Ciphertext, bfv.SecretKey]:
        """``acc`` switched to a fresh output key; returns it and the key."""
        sk_out, pk_out = bfv.KeyGenerator(self.params, device=self.device, seed=999).gen_key_pair()
        pcks = dbfv.PCKSProtocol(self.params, device=self.device)
        shares = [pcks.gen_share(sk.sk, pk_out, acc) for sk in self.sks]
        return pcks.key_switch(fold(pcks, shares), acc), sk_out

    def decrypt(self, ct: bfv.Ciphertext, sk_out: bfv.SecretKey) -> np.ndarray:
        return self.enc.decode_uint(bfv.Decryptor(self.params, sk_out, device=self.device).decrypt(ct))

    def want(self) -> np.ndarray:
        out = self.sets[0]
        for s in self.sets[1:]:
            out = out & s
        return out

    def run(self) -> np.ndarray:
        """Every stage in order; returns the decrypted intersection vector."""
        pk, rlk = self.keygen()
        and_chain = self.compiled_and_chain if self.device.type == "cuda" else self.and_chain
        return self.decrypt(*self.pcks(and_chain(self.encrypt(pk), rlk)))


def main(n_parties: int = 3, log_n: int = 13, device=None) -> bool:
    t0 = time.perf_counter()
    psi = Psi(n_parties, log_n, device)
    print(f"[setup]   N={psi.params.n}, device={psi.device}")
    pk, rlk = psi.keygen()
    print(f"[keygen]  {n_parties} parties, {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    and_chain = psi.compiled_and_chain if psi.device.type == "cuda" else psi.and_chain
    acc = and_chain(psi.encrypt(pk), rlk)
    print(f"[AND]     {n_parties} sets intersected, {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    got = psi.decrypt(*psi.pcks(acc))
    want = psi.want()
    ok = bool((got == want).all())
    print(f"[PCKS+decrypt] {time.perf_counter() - t0:.1f}s; intersection of "
          f"{int(want.sum())} elements correct: {ok}")
    return ok


if __name__ == "__main__":
    if not main(int(sys.argv[1]) if len(sys.argv) > 1 else 3,
                int(sys.argv[2]) if len(sys.argv) > 2 else 13,
                sys.argv[3] if len(sys.argv) > 3 else None):
        sys.exit(1)
