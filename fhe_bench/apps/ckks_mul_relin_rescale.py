"""Request kind ``ckks_mul_relin_rescale``: ``rescale(mul_relin(a, b, rlk))``
on a stack of ``batch`` CKKS ciphertext pairs (Lattigo v1.3.1
ckks/ckks_benchmarks_test.go MulRelin and Rescale; the port's
``entry.entry_ckks`` forward), as one ``tjit`` program.

The benchmark draws from the seed the sparse ternary secret (``hw``
nonzero coefficients), and for each pool entry and each ciphertext of the
stack two vectors of complex slots, uniform in [-1, 1] + i [-1, 1].  It
encodes them itself (the reference's canonical embedding at the
configuration's scale); the port generates the public and relinearization
keys from that secret, takes the plaintexts to its NTT domain, encrypts
them and captures the program.  A request is one call of the program on one
pool entry.

The reference decrypts each sampled answer with the secret, decodes it at
the scale and level Lattigo's rescale leaves, and holds it against the
slot-wise products a * b in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fhe_bench.reference import ckks as ref
from lattigo_tpu_torch.models import ckks
from lattigo_tpu_torch.models.bfv import SecretKey
from lattigo_tpu_torch.tjit import tjit


def parameters(cfg: dict) -> ckks.Parameters:
    return ckks.Parameters(log_n=cfg["log_n"], log_slots=cfg["log_slots"],
                           scale=float(cfg["scale"]), log_qi=tuple(cfg["log_qi"]),
                           log_pi=tuple(cfg["log_pi"]), sigma=cfg["sigma"]).gen_from_log_moduli()


def draw(cfg: dict, wl: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The benchmark's inputs at ``seed``: the secret's coefficients [N]
    and the slots [pool, 2, *batch, N/2]."""
    n, slots = 1 << cfg["log_n"], 1 << cfg["log_slots"]
    rng = np.random.default_rng(np.random.SeedSequence(seed))
    hw = cfg["secret_hamming_weight"]
    secret = np.zeros(n, dtype=np.int64)
    secret[rng.choice(n, hw, replace=False)] = rng.choice([-1, 1], hw)
    shape = (wl["pool"], 2, *wl["batch"], slots)
    values = rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
    return secret, values


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
        coeffs = torch.from_numpy(ref.Scheme(cfg).encode(self.values)).to(device)
        batch = tuple(wl["batch"])

        def encrypt(c: torch.Tensor) -> ckks.Ciphertext:
            flat = c.reshape(-1, c.shape[-1])
            cts = [encryptor.encrypt(ckks.Plaintext(rq.ntt(row[None, :] % q_col), params.scale))
                   for row in flat]
            value = [torch.stack([ct.value[i] for ct in cts]).reshape(*batch, *cts[0].value[i].shape)
                     for i in range(2)]
            return ckks.Ciphertext(value, params.scale)

        self.pairs = [(encrypt(coeffs[k, 0]), encrypt(coeffs[k, 1])) for k in range(wl["pool"])]
        ev = ckks.Evaluator(params, device=device)

        def forward(a, b, rlk):
            return ev.rescale(ev.mul_relin(a, b, rlk))

        self.program = tjit(forward)
        self.pool = wl["pool"]

    def call(self, k: int) -> ckks.Ciphertext:
        """One request: the product of pool entry ``k``'s pair."""
        a, b = self.pairs[k]
        return self.program(a, b, self.rlk)

    def release(self) -> None:
        """Frees the program and its inputs; what the reference needs stays."""
        del self.program, self.pairs, self.rlk

    def judge(self, answers: dict[int, ckks.Ciphertext]) -> dict:
        """The numbers compared, over the sampled answers (pool index ->
        answer): ``bad_form`` (answers not of degree 1 at the level and
        scale Lattigo's rescale leaves), ``limb_mismatch``, ``max_err`` (as
        ``reference.ckks.Scheme.judge`` defines them) and ``out_of_range``
        (words outside [0, q_i))."""
        scheme = ref.Scheme(self.cfg)
        scale, level = scheme.mul_rescale(scheme.scale, len(scheme.qs) - 1)
        shape = (2, *self.values.shape[2:-1], level + 1, scheme.n)
        secret = torch.from_numpy(self.secret).to(self.device)
        out = dict(bad_form=0, limb_mismatch=0, max_err=0.0, out_of_range=0)
        for k, ans in sorted(answers.items()):
            ct = torch.stack(ans.value) if len(ans.value) == 2 else None
            if ct is None or tuple(ct.shape) != shape or not math.isclose(ans.scale, scale,
                                                                          rel_tol=1e-12):
                out["bad_form"] += 1
                continue
            a, b = self.values[k]
            got = scheme.judge(ct, secret, a * b, scale, level)
            out["limb_mismatch"] += got["limb_mismatch"]
            out["max_err"] = max(out["max_err"], got["max_err"])
            q = torch.tensor(scheme.qs[: level + 1], dtype=torch.int64, device=ct.device)[:, None]
            out["out_of_range"] += int(((ct < 0) | (ct >= q)).sum())
        return out


def control_readings(cfg: dict, wl: dict, seed: int) -> dict:
    """The control's ``max_err``: the pool's products computed in
    complex64, the precision below the configuration's float64 slots."""
    _, values = draw(cfg, wl, seed)
    return dict(max_err=max(ref.control_err(a, b) for a, b in values))
