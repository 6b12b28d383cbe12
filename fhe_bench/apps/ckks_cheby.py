"""Request kind ``ckks_cheby``: a Chebyshev interpolant of a real function
evaluated on one CKKS ciphertext by ``EvaluateChebyFast`` (Lattigo v1.3.1
examples/ckks/examples_ckks.go, the sigmoid; ckks/chebyshev_evaluation.go),
the whole circuit as one ``tjit`` program on the plain ``ckks.Evaluator``.

The benchmark draws from the seed the sparse ternary secret (``hw`` nonzero
coefficients) and, for each pool entry, the real slots, uniform on the
configuration's interval.  It encodes them itself (the reference's canonical
embedding at the configuration's scale); the port generates the public and
relinearization keys from that secret, takes the plaintexts to its NTT
domain, encrypts them and captures the program.  A request is one call of
the program on one pool entry.

The reference decrypts each sampled answer with the secret and holds it
against the circuit's noiseless result (``reference/cheby.py``): the same
interpolant, products, constants and rescales on what the ciphertext
encrypts, with Lattigo's scale rules, so that the output's level and scale
and the slots' distance to that result are all checked.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fhe_bench.apps.ckks_mul_relin_rescale import parameters
from fhe_bench.reference import cheby as ref_cheby
from fhe_bench.reference import ckks as ref
from lattigo_tpu_torch.models import ckks
from lattigo_tpu_torch.models.bfv import SecretKey
from lattigo_tpu_torch.tjit import tjit

FUNCTIONS = {"logistic": lambda x: 1 / (math.exp(-x) + 1)}


def draw(cfg: dict, wl: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The benchmark's inputs at ``seed``: the secret's coefficients [N]
    and the real slots [pool, N/2]."""
    n, slots = 1 << cfg["log_n"], 1 << cfg["log_slots"]
    rng = np.random.default_rng(np.random.SeedSequence(seed))
    hw = cfg["secret_hamming_weight"]
    secret = np.zeros(n, dtype=np.int64)
    secret[rng.choice(n, hw, replace=False)] = rng.choice([-1, 1], hw)
    a, b = cfg["interval"]
    return secret, rng.uniform(a, b, (wl["pool"], slots))


def coefficients(cfg: dict) -> list[float]:
    """The reference's interpolant of the configuration's function."""
    a, b = cfg["interval"]
    return ref_cheby.approximate(FUNCTIONS[cfg["function"]], a, b, cfg["degree"])


def expected(cfg: dict, coeffs: np.ndarray) -> tuple[ref_cheby.Ct, ref_cheby.Model]:
    """The circuit's noiseless result on plaintexts of integer coefficients
    ``coeffs`` ([..., N]), and the model that computed it (its events)."""
    scheme = ref.Scheme(cfg)
    model = ref_cheby.Model(scheme.qs, scheme.scale)
    x = ref_cheby.Ct(scheme.decode(coeffs.astype(np.float64), 1.0), scheme.scale, len(scheme.qs) - 1)
    a, b = cfg["interval"]
    return ref_cheby.evaluate_cheby_fast(model, x, coefficients(cfg), a, b), model


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
        self.secret, self.values = draw(cfg, wl, seed)
        seeds = np.random.SeedSequence(seed).generate_state(2, dtype=np.uint64) >> np.uint64(1)

        res = torch.tensor(np.stack([self.secret % q for q in rqp.moduli]), dtype=torch.int64,
                           device=device)
        sk = SecretKey(rqp.ntt(rqp.mform(res)))
        kgen = ckks.KeyGenerator(params, device=device, seed=int(seeds[0]))
        self.rlk = kgen.gen_relin_key(sk)
        encryptor = ckks.Encryptor(params, pk=kgen.gen_public_key(sk), device=device,
                                   seed=int(seeds[1]))
        q_col = torch.tensor(list(rq.moduli), dtype=torch.int64, device=device)[:, None]
        self.coeffs = ref.Scheme(cfg).encode(self.values.astype(np.complex128))
        self.cts = [encryptor.encrypt(ckks.Plaintext(
            rq.ntt(torch.from_numpy(row).to(device)[None, :] % q_col), params.scale))
            for row in self.coeffs]
        ev = ckks.Evaluator(params, device=device)
        a, b = cfg["interval"]
        fn = FUNCTIONS[cfg["function"]]
        cheby = ckks.approximate(lambda x: fn(x.real), a, b, cfg["degree"])

        def forward(ct, rlk):
            return ckks.evaluate_cheby_fast(ev, ct, cheby, rlk)

        self.program = tjit(forward)
        self.pool = wl["pool"]

    def call(self, k: int) -> ckks.Ciphertext:
        """One request: the interpolant at pool entry ``k``."""
        return self.program(self.cts[k], self.rlk)

    def release(self) -> None:
        """Frees the program and its inputs; what the reference needs stays."""
        del self.program, self.cts, self.rlk

    def judge(self, answers: dict[int, ckks.Ciphertext]) -> dict:
        """The numbers compared, over the sampled answers (pool index ->
        answer): ``bad_form`` (answers not of degree 1 at the level and
        scale of the circuit's noiseless result), ``limb_mismatch`` (as
        ``reference.cheby.decrypt`` counts it), ``max_err`` (the largest
        |slot - the noiseless result's slot|) and ``out_of_range`` (words
        outside [0, q_i))."""
        scheme = ref.Scheme(self.cfg)
        secret = torch.from_numpy(self.secret).to(self.device)
        out = dict(bad_form=0, limb_mismatch=0, max_err=0.0, out_of_range=0)
        for k, ans in sorted(answers.items()):
            want, _ = expected(self.cfg, self.coeffs[k])
            ct = torch.stack(ans.value) if len(ans.value) == 2 else None
            if ct is None or tuple(ct.shape) != (2, want.level + 1, scheme.n) or not math.isclose(
                    ans.scale, want.scale, rel_tol=1e-12):
                out["bad_form"] += 1
                continue
            coeffs, mismatch = ref_cheby.decrypt(scheme.qs[: want.level + 1], scheme.n, ct, secret)
            err = np.abs(scheme.decode(coeffs, want.scale) - want.m / want.scale).max()
            out["limb_mismatch"] += mismatch
            out["max_err"] = max(out["max_err"], float(err))
            q = torch.tensor(scheme.qs[: want.level + 1], dtype=torch.int64, device=ct.device)[:, None]
            out["out_of_range"] += int(((ct < 0) | (ct >= q)).sum())
        return out


def control_config(cfg: dict) -> dict:
    """The control: the same deployment at the scale 2^30, the precision
    below the 2^40 its configuration states."""
    return dict(cfg, scale=1 << 30)
