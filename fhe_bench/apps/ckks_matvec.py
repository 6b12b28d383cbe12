"""Request kind ``ckks_matvec``: one dense layer of encrypted inference, an
m x n real matrix times one CKKS ciphertext of n = N/2 real slots, by the
hybrid diagonal method with hoisted baby steps (``ckks.mul_matrix_hybrid``
on the plain ``ckks.Evaluator``: ``rotate_hoisted``, the key switch's fold
over the diagonals, ``rotate_columns``, ``rescale``), the whole layer as
one ``tjit`` program.

The benchmark draws from the seed the sparse ternary secret, the weights
and, for each pool entry, the input slots (``reference/matvec.py``).  It
encodes the inputs itself (the reference's canonical embedding at the
configuration's scale); the port generates the public key and one left
rotation key for each rotation the layer makes from that secret, encodes
the weights' diagonals (``ckks.encode_diagonals``: they stay on the device,
in the program), takes the inputs to its NTT domain, encrypts them and
captures the program, whose arguments are the ciphertext and the rotation
keys (a server holds a client's keys and receives its ciphertexts).  A
request is one call of the program on one pool entry.

The reference decrypts each sampled answer with the secret, decodes it at
the level and scale Lattigo's rules leave and holds it against ``W x`` in
float64, tiled over the slots.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fhe_bench.apps.ckks_mul_relin_rescale import parameters
from fhe_bench.reference import cheby as ref_cheby
from fhe_bench.reference import ckks as ref
from fhe_bench.reference import matvec as ref_matvec
from lattigo_tpu_torch.models import ckks
from lattigo_tpu_torch.models.bfv import SecretKey
from lattigo_tpu_torch.tjit import tjit


def result_form(cfg: dict) -> tuple[float, int, list[int]]:
    """The answer's scale and level, and the levels its rescale divides
    from: a ciphertext at the set's scale and top level times diagonals
    at the set's scale."""
    scheme = ref.Scheme(cfg)
    return ref_matvec.output(scheme.qs, scheme.scale, scheme.scale, scheme.scale,
                             len(scheme.qs) - 1)


class App:
    """The cell's program, its inputs and what the reference needs."""

    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        params = parameters(cfg)
        want = ref.moduli(cfg)
        if (list(params.qi), list(params.pi)) != (want["q"], want["p"]):
            raise RuntimeError("the port's moduli differ from Lattigo's for this configuration")
        self.cfg, self.device = cfg, device
        ctx = ckks.get_context(params, device)
        rq, rqp = ctx.ring_q, ctx.ring_qp
        self.secret, self.w, self.values = ref_matvec.draw(cfg, wl["pool"], seed)
        seeds = np.random.SeedSequence(seed).generate_state(2, dtype=np.uint64) >> np.uint64(1)

        res = torch.tensor(np.stack([self.secret % q for q in rqp.moduli]), dtype=torch.int64,
                           device=device)
        sk = SecretKey(rqp.ntt(rqp.mform(res)))
        kgen = ckks.KeyGenerator(params, device=device, seed=int(seeds[0]))
        n1 = cfg["baby_steps"]
        self.rot_keys = ckks.RotationKeys()
        for steps in ckks.linear_transform.rotations(cfg["rows"], n1, params.slots):
            for k in steps:
                kgen.gen_rot("left", sk, k, self.rot_keys)
        encryptor = ckks.Encryptor(params, pk=kgen.gen_public_key(sk), device=device,
                                   seed=int(seeds[1]))
        q_col = torch.tensor(list(rq.moduli), dtype=torch.int64, device=device)[:, None]
        self.coeffs = ref.Scheme(cfg).encode(self.values.astype(np.complex128))
        self.cts = [encryptor.encrypt(ckks.Plaintext(
            rq.ntt(torch.from_numpy(row).to(device)[None, :] % q_col), params.scale))
            for row in self.coeffs]
        self.diags = ckks.encode_diagonals(params, self.w, n1, device=device)
        ev = ckks.Evaluator(params, device=device)
        diags = self.diags

        def forward(ct, rot_keys):
            return ckks.mul_matrix_hybrid(ev, ct, diags, rot_keys)

        self.program = tjit(forward)
        self.pool = wl["pool"]

    def call(self, k: int) -> ckks.Ciphertext:
        """One request: the layer on pool entry ``k``."""
        return self.program(self.cts[k], self.rot_keys)

    def release(self) -> None:
        """Frees the program, its keys, diagonals and inputs; what the
        reference needs stays."""
        del self.program, self.cts, self.rot_keys, self.diags

    def judge(self, answers: dict[int, ckks.Ciphertext]) -> dict:
        """The numbers compared, over the sampled answers (pool index ->
        answer): ``bad_form`` (answers not of degree 1 at the level and
        scale of :func:`result_form`), ``limb_mismatch`` (as
        ``reference.cheby.decrypt`` counts it: the message is decrypted
        through two limbs), ``max_err`` (the largest
        |slot - (W x) tiled|) and ``out_of_range`` (words outside [0, q_i))."""
        scheme = ref.Scheme(self.cfg)
        scale, level, _ = result_form(self.cfg)
        want = ref_matvec.expected(self.w, self.values)
        secret = torch.from_numpy(self.secret).to(self.device)
        out = dict(bad_form=0, limb_mismatch=0, max_err=0.0, out_of_range=0)
        for k, ans in sorted(answers.items()):
            ct = torch.stack(ans.value) if len(ans.value) == 2 else None
            if ct is None or tuple(ct.shape) != (2, level + 1, scheme.n) or not math.isclose(
                    ans.scale, scale, rel_tol=1e-12):
                out["bad_form"] += 1
                continue
            coeffs, mismatch = ref_cheby.decrypt(scheme.qs[: level + 1], scheme.n, ct, secret)
            out["limb_mismatch"] += mismatch
            out["max_err"] = max(out["max_err"],
                                 float(np.abs(scheme.decode(coeffs, scale) - want[k]).max()))
            q = torch.tensor(scheme.qs[: level + 1], dtype=torch.int64, device=ct.device)[:, None]
            out["out_of_range"] += int(((ct < 0) | (ct >= q)).sum())
        return out


def control_config(cfg: dict) -> dict:
    """The control: the same deployment at the scale 2^30, the precision
    below the 2^34 its configuration states (2^60 stays below 2^30 q_9 / 2,
    so the layer ends unrescaled at level 9, which ``judge`` reads through
    two limbs)."""
    return dict(cfg, scale=1 << 30)
