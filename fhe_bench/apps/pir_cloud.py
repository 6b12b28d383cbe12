"""Request kind ``pir_cloud``: one query of the threshold-BFV private
information retrieval (Lattigo v1.3.1 examples/dbfv/pir/pir.go), answered by
the cloud's compiled program over the encrypted database.

The benchmark draws from the seed the parties' ternary secrets, the
database (``rows`` rows of N entries of ``entry_bits`` bits) and, for each
query of the pool, the row it asks for (one from each of ``pool`` equal
blocks of the database, so the pool spans it).  The port then runs the
threshold protocols (CKG, RKG's three rounds, RTG for the left
power-of-two rotations and the row swap) with those secrets, encrypts the
rows and the one-hot queries under the collective key, and captures the
cloud step, ``relinearize(entry.cloud_partial(...))``, as one ``tjit``
program: select, ``inner_sum``, multiply with the rows, tree sum over the
rows, relinearize.  A request is one call of that program.

The reference decrypts each sampled answer with the sum of the secrets and
holds it against the database row the query asked for.
"""

from __future__ import annotations

import numpy as np
import torch

from fhe_bench.reference import bfv as ref
from lattigo_tpu_torch.entry import cloud_partial, fold
from lattigo_tpu_torch.models import bfv, dbfv
from lattigo_tpu_torch.tjit import tjit
from lattigo_tpu_torch.utils.prng import CRPGenerator


def parameters(cfg: dict) -> bfv.Parameters:
    return bfv.Parameters(log_n=cfg["log_n"], t=cfg["t"], log_qi=tuple(cfg["log_qi"]),
                          log_pi=tuple(cfg["log_pi"]), log_qi_mul=tuple(cfg["log_qi_mul"]),
                          sigma=cfg["sigma"]).gen_from_log_moduli()


def port_secret(ring, coeffs: np.ndarray) -> bfv.SecretKey:
    """The port's secret key (NTT and Montgomery form over Q and P) of the
    integer coefficients ``coeffs``."""
    res = torch.tensor(np.stack([coeffs % q for q in ring.moduli]), dtype=torch.int64,
                       device=ring.device)
    return bfv.SecretKey(ring.ntt(ring.mform(res)))


class App:
    """The cell's program, its inputs and what the reference needs."""

    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        params = parameters(cfg)
        want = ref.moduli(cfg)
        if (list(params.qi), list(params.pi), list(params.qi_mul)) != (want["q"], want["p"], want["qmul"]):
            raise RuntimeError("the port's moduli differ from Lattigo's for this configuration")
        self.cfg, self.device = cfg, device
        ctx = bfv.get_context(params, device)
        n, rows, pool = params.n, wl["rows"], wl["pool"]
        seeds = np.random.SeedSequence(seed)
        rng = np.random.default_rng(seeds)
        torch_seed = iter(int(s) for s in seeds.generate_state(8, dtype=np.uint64) >> np.uint64(1))

        # the benchmark's inputs: uniform ternary secrets (Lattigo's
        # GenSecretKey, P(0) = 1/3), the database, the rows the pool asks for
        self.secrets = rng.integers(-1, 2, (cfg["parties"], n))
        self.db = rng.integers(0, 1 << cfg["entry_bits"], (rows, n))
        block = rows // pool
        self.wanted = np.arange(pool) * block + rng.integers(0, block, pool)

        sks = [port_secret(ctx.ring_qp, s).sk for s in self.secrets]
        crp_gen = CRPGenerator(b"pir", ctx.ring_qp)
        crp_gen.seed(int(seed).to_bytes(16, "little", signed=True))
        ckg = dbfv.CKGProtocol(params, device=device, seed=next(torch_seed))
        crp = crp_gen.clock_poly()
        pk = ckg.gen_public_key(fold(ckg, [ckg.gen_share(s, crp) for s in sks]), crp)

        rkg = dbfv.RKGProtocol(params, device=device, seed=next(torch_seed))
        crp = crp_gen.clock_polys(params.beta)
        ephs = [rkg.new_ephemeral_key() for _ in sks]
        r1 = fold(rkg, [rkg.gen_share_round_one(e, s, crp) for e, s in zip(ephs, sks)])
        r2 = fold(rkg, [rkg.gen_share_round_two(r1, s, crp) for s in sks])
        r3 = fold(rkg, [rkg.gen_share_round_three(r2, e, s) for e, s in zip(ephs, sks)])
        self.rlk = rkg.gen_relinearization_key(r2, r3)

        rtg = dbfv.RTGProtocol(params, device=device, seed=next(torch_seed))
        self.rot_keys = bfv.RotationKeys()
        for rot, k in [("left", 1 << i) for i in range(params.log_n - 1)] + [("row", 0)]:
            crp = crp_gen.clock_polys(params.beta)
            rtg.finalize(rot, k, fold(rtg, [rtg.gen_share(rot, k, s, crp) for s in sks]), crp,
                         self.rot_keys)

        enc = bfv.Encoder(params, device=device)
        encryptor = bfv.Encryptor(params, pk=pk, device=device, seed=next(torch_seed))
        one_hot = lambda i: np.eye(1, n, i, dtype=np.uint64)[0]
        cts = [encryptor.encrypt(enc.encode_uint(r.astype(np.uint64))) for r in self.db]
        self.rows = bfv.Ciphertext([torch.stack([c.value[k] for c in cts]) for k in range(2)])
        self.masks = torch.stack([enc.encode_uint(one_hot(r)).value for r in range(rows)])
        self.queries = [encryptor.encrypt(enc.encode_uint(one_hot(int(w)))) for w in self.wanted]

        ev = bfv.Evaluator(params, device=device)

        def cloud(query, rows_ct, masks, rlk, rot_keys):
            return ev.relinearize(cloud_partial(ev, query, rows_ct, masks, rot_keys), rlk)

        self.program = tjit(cloud)
        self.pool = pool

    def call(self, k: int) -> bfv.Ciphertext:
        """One request: the answer to query ``k`` of the pool."""
        return self.program(self.queries[k], self.rows, self.masks, self.rlk, self.rot_keys)

    def release(self) -> None:
        """Frees the program and its inputs; what the reference needs stays."""
        del self.program, self.queries, self.rows, self.masks, self.rlk, self.rot_keys

    def judge(self, answers: dict[int, bfv.Ciphertext]) -> dict:
        """The numbers compared, over the sampled answers (pool index ->
        answer): ``bad_form`` (answers not of degree 1 over Q), ``wrong_slots``,
        ``noise`` (the largest, as ``reference.bfv.Scheme.judge`` defines
        it) and ``out_of_range`` (words outside [0, q_i))."""
        scheme = ref.Scheme(self.cfg, self.device)
        shape = (2, len(scheme.qs), scheme.n)
        secret = torch.tensor(self.secrets.sum(axis=0), dtype=torch.int64, device=self.device)
        out = dict(bad_form=0, wrong_slots=0, noise=0.0, out_of_range=0)
        for k, ans in sorted(answers.items()):
            ct = torch.stack(ans.value) if len(ans.value) == 2 else None
            if ct is None or tuple(ct.shape) != shape:
                out["bad_form"] += 1
                continue
            got = scheme.judge(ct, secret, torch.tensor(self.db[self.wanted[k]], device=self.device))
            out["wrong_slots"] += got["wrong_slots"]
            out["noise"] = max(out["noise"], got["noise"])
            out["out_of_range"] += scheme.ntt_q.out_of_range(ct)
        return out


def control_config(cfg: dict) -> dict:
    """The control: the same deployment one modulus of Q lower, the precision
    below the one the configuration states."""
    return dict(cfg, log_qi=cfg["log_qi"][:-1])
