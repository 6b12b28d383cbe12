"""The port's twin of bench.py (``lattigo_tpu_torch.bench``) on the CPU, at
the log N = 8 sets of the other port tests, with chain 2 and calls 1.

Held against the JAX package on the same numpy-seeded inputs: the
headline's plain schedule equals ``Ring._ntt_simple`` bit for bit (the
golden 60-bit pair), and config #3's step equals the JAX ``Evaluator``'s
``rotate_hoisted(rescale(mul_relin(c, c)), [1])[1]`` bit for bit on keys
carried across by ``convert``.  The party-stacked shares of the 8-party
pipeline equal a loop over the unstacked parties bit for bit once the
noise draws are the same (the samplers' outputs recorded from the stacked
call and handed party by party to the loop), in every deterministic step;
without that, the 8 parties' noise differs pairwise; CKG -> encrypt ->
PCKS decrypts exactly under the target key and Refresh exactly under the
parties' summed key.  Two calls of a keyed ``tjit`` program give different
shares.  Every config runs and emits bench.py's metric names; a raising
config or a spent budget ends the run with an error.  Tolerance: none
(integers), CKKS decodings at 12 median bits."""

import contextlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from lattigo_tpu.models import ckks as jckks
from lattigo_tpu.ops import ring as jring
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu_torch import bench, convert
from lattigo_tpu_torch.entry import fold, fold_stacked
from lattigo_tpu_torch.models import bfv, ckks, dbfv
from lattigo_tpu_torch.ops import samplers
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.ops.ring import Ring
from lattigo_tpu_torch.tjit import tjit
from lattigo_tpu_torch.utils.precision import precision_stats
from lattigo_tpu_torch.utils.prng import CRPGenerator

torch.set_num_threads(1)

CPU = "cpu"
SMALL_BFV = bfv.Parameters(log_n=8, t=65537, log_qi=(46, 46), log_pi=(47,),
                           log_qi_mul=(60, 60)).gen_from_log_moduli()
CKKS_SPEC = dict(log_n=8, log_slots=7, scale=float(1 << 32), log_qi=(45, 32, 32, 32),
                 log_pi=(45,))
SMALL_CKKS = ckks.Parameters(**CKKS_SPEC).gen_from_log_moduli()
CHEBY_CKKS = ckks.Parameters(log_n=8, log_slots=7, scale=float(1 << 30),
                             log_qi=(45,) + (30,) * 7, log_pi=(45,)).gen_from_log_moduli()
SMALL = dict(
    ntt_headline=dict(n=256, batch=4, chain=2, calls=1),
    ntt_single_ct=dict(n=256, chain=2, calls=1),
    bfv_mul_relin=dict(params=SMALL_BFV, chain=2, calls=1),
    per_op_table=dict(params=SMALL_BFV, chain=2, calls=1),
    threshold_steady=dict(params=SMALL_BFV, chain=2, calls=1),
    threshold_8party=dict(params=SMALL_BFV, chain=2, calls=1, phase_chains=(2, 2, 2, 2),
                          phase_calls=1),
    ckks_mul_rescale_rotate=dict(params=SMALL_CKKS, n_variants=3, n_batch_variants=2),
    ckks_pn16=dict(params=SMALL_CKKS, n_variants=2),
    cheby31=dict(params=CHEBY_CKKS, n_variants=2),
)

# bench.py's metric names, in its order (bench.py:180-842)
BENCH_PY_NAMES = (
    ["ntt_per_sec_n8192_60bit", "ntt_single_ct_n8192_60bit", "bfv_mul_relin_pn13qp218"]
    + [f"bfv_{op}_pn12qp109" for op in
       ("encrypt", "decrypt", "add", "mul", "mul_relin", "rotate_cols")]
    + [f"dbfv_{phase}_pn12qp109" for phase in
       ("ckg_gen", "ckg_agg", "cks_gen", "cks_agg", "cks_finalize", "pcks_gen", "pcks_agg",
        "pcks_finalize", "rkg_round1_gen", "rkg_round2_gen", "rkg_round3_gen", "rkg_finalize",
        "rtg_gen", "rtg_agg", "refresh_gen", "refresh_agg", "refresh_finalize")]
    + ["dbfv_8party_ckg_pcks_refresh_pn12qp109"]
    + [f"dbfv_8party_phase_{phase}_pn12qp109" for phase in ("ckg", "encrypt", "pcks", "refresh")]
    + ["ckks_mul_rescale_pn14qp438", "ckks_mul_rescale_pn14qp438_batch8",
       "ckks_mul_relin_rescale_pn16qp1761", "ckks_cheby31_pn15qp880"]
)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench") / "records.json"
    return bench.run(CPU, out=str(out), overrides=SMALL), out


def test_every_config_emits_bench_py_names(records):
    recs, _ = records
    small_ntt = {"ntt_per_sec_n8192_60bit": "ntt_per_sec_n256_60bit",
                 "ntt_single_ct_n8192_60bit": "ntt_single_ct_n256_60bit"}
    assert [r["metric"] for r in recs] == [small_ntt.get(m, m) for m in BENCH_PY_NAMES]
    assert [m for ms in bench.METRICS.values() for m in ms] == BENCH_PY_NAMES
    for r in recs:
        assert np.isfinite(r["value"]) and r["value"] > 0
        assert r["vs_baseline"] is None and r["gpu"] is None
        assert not [k for k in r if k.startswith("residual_floor")]
        assert r["ms"] > 0 and r["calls"] >= 1 and r["chain"] >= 1 and r["capture_s"] >= 0
    assert all(r["log_n"] == 8 for r in recs[2:])


def test_records_written_to_out_only(records):
    recs, out = records
    assert json.loads(out.read_text()) == json.loads(json.dumps(recs))
    assert bench.DEFAULT_OUT.endswith("chiprun_out/bench_torch.json")


def test_checks_recorded(records):
    recs, _ = records
    by = {r["metric"]: r for r in recs}
    assert by["ntt_per_sec_n256_60bit"]["bit_exact_on_device"] is True
    assert by["dbfv_ckg_gen_pn12qp109"]["fresh_noise"]["replays_differ"] is True
    party = by["dbfv_8party_ckg_pcks_refresh_pn12qp109"]
    assert party["party_noise_distinct_pairs"] == 28 and party["pcks_and_refresh_exact"]
    assert by["ckks_mul_relin_rescale_pn16qp1761"]["precision_bits"] >= bench.CKKS_BITS
    assert by["ckks_cheby31_pn15qp880"]["bits_vs_chebyshev"] >= bench.CHEBY_BITS


def test_headline_plain_schedule_equals_the_jax_ntt_simple():
    moduli = list(bench.GOLDEN_60)
    x = np.random.default_rng(0).integers(0, moduli[0], size=(4, 2, 256), dtype=np.uint64)
    x %= np.array(moduli, dtype=np.uint64)[None, :, None]
    want = ju.to_u64(jax.jit(lambda a: jring.Ring(256, moduli)._ntt_simple(a, (0, 1)))(
        ju.from_u64(x)))
    ring = Ring(256, moduli, device=CPU)
    X = tu.from_u64(x, CPU)
    np.testing.assert_array_equal(tu.to_u64(ring._ntt_simple(X, (0, 1))), want)
    np.testing.assert_array_equal(tu.to_u64(ring.ntt(X)), want)
    assert torch.equal(ring.intt(ring.ntt(X)), X)


def test_config3_step_equals_the_jax_evaluator():
    kgen = ckks.KeyGenerator(SMALL_CKKS, device=CPU, seed=2)
    sk, pk = kgen.gen_key_pair_sparse(hw=128)
    rlk = kgen.gen_relin_key(sk)
    rot = ckks.RotationKeys()
    kgen.gen_rot("left", sk, 1, rot)
    enc = ckks.Encoder(SMALL_CKKS, device=CPU)
    v = np.random.default_rng(2).uniform(-1, 1, SMALL_CKKS.slots).astype(np.complex128)
    ct = ckks.Encryptor(SMALL_CKKS, pk=pk, device=CPU, seed=2).encrypt(enc.encode(v))
    got = bench.mul_rescale_rotate(ckks.Evaluator(SMALL_CKKS, device=CPU), ct, rlk, rot)

    jp = jckks.Parameters(**CKKS_SPEC).gen_from_log_moduli()
    swk = lambda k: jckks.SwitchingKey(*(ju.from_u64(a) for a in convert.switching_key_to_numpy(k)))
    polys, scale = convert.ckks_ciphertext_to_numpy(ct)
    jct = jckks.Ciphertext([ju.from_u64(p) for p in polys], scale)
    jev = jckks.Evaluator(jp)
    want = jax.jit(lambda c, k, r: jev.rotate_hoisted(jev.rescale(jev.mul_relin(c, c, k)), [1],
                                                      r)[1])(
        jct, jckks.EvaluationKey(swk(rlk.evakey)), jckks.RotationKeys({1: swk(rot.left[1])}))
    assert got.scale == want.scale and got.level == want.level
    for a, b in zip(convert.ckks_ciphertext_to_numpy(got)[0], want.value):
        np.testing.assert_array_equal(a, ju.to_u64(jax.tree.map(np.asarray, b)))
    dec = ckks.Decryptor(SMALL_CKKS, sk, device=CPU)
    assert precision_stats(enc.decode(dec.decrypt(got)), np.roll(v * v, -1)).median_bits >= 12


# -- the party-stacked protocols ------------------------------------------------

N_PARTIES = bench.N_PARTIES


@pytest.fixture(scope="module")
def parties():
    ctx = bfv.get_context(SMALL_BFV, CPU)
    sks = [bfv.KeyGenerator(SMALL_BFV, device=CPU, seed=10 + i).gen_secret_key().sk
           for i in range(N_PARTIES)]
    crpg = CRPGenerator(b"bench", ctx.ring_qp)
    crpg.seed(b"seed")
    enc = bfv.Encoder(SMALL_BFV, device=CPU)
    m = np.random.default_rng(5).integers(0, SMALL_BFV.t, SMALL_BFV.n, dtype=np.uint64)
    sk_out, pk_out = bfv.KeyGenerator(SMALL_BFV, device=CPU, seed=90).gen_key_pair()
    return dict(ctx=ctx, sks=sks, st=torch.stack(sks), crp=crpg.clock_poly(),
                crs=crpg.clock_poly(), enc=enc, m=m, pt=enc.encode_uint(m), sk_out=sk_out,
                pk_out=pk_out, sk_sum=bfv.SecretKey(fold(dbfv.CKGProtocol(SMALL_BFV, device=CPU),
                                                         sks)))


@contextlib.contextmanager
def same_draws(monkeypatch):
    """Inside the block the samplers record what a party-stacked call
    draws; ``as_party(p)`` then makes an unstacked call draw party ``p``'s
    slices of those records, in the same order."""
    recorded, state = [], dict(party=None, k=0)

    def wrap(real):
        def sampler(*args, **kw):
            if state["party"] is None:
                recorded.append(real(*args, **kw))
                return recorded[-1]
            out = recorded[state["k"]][state["party"]]
            state["k"] += 1
            return out
        return sampler

    def as_party(p):
        state.update(party=p, k=0)

    with monkeypatch.context() as mp:
        for name in ("gaussian_poly", "ternary_poly", "uniform_poly"):
            mp.setattr(samplers, name, wrap(getattr(samplers, name)))
        yield as_party


def _parts(share, p):
    return tuple(s[p] for s in share) if isinstance(share, tuple) else share[p]


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _stacked_equals_loop(monkeypatch, proto, gen):
    with same_draws(monkeypatch) as as_party:
        stacked = gen(None)
        loop = []
        for p in range(N_PARTIES):
            as_party(p)
            loop.append(gen(p))
    for p in range(N_PARTIES):
        assert _equal(_parts(stacked, p), loop[p])
    combined = fold_stacked(proto, stacked)
    assert _equal(combined, fold(proto, loop))
    return combined


def test_stacked_ckg_equals_a_loop_over_parties(monkeypatch, parties):
    w = parties
    ckg = dbfv.CKGProtocol(SMALL_BFV, device=CPU, seed=1)
    gen = lambda p: ckg.gen_share(w["st"] if p is None else w["sks"][p], w["crp"])
    combined = _stacked_equals_loop(monkeypatch, ckg, gen)
    pk = ckg.gen_public_key(combined, w["crp"])
    assert torch.equal(pk.pk[0], combined) and torch.equal(pk.pk[1], w["crp"])


def test_stacked_pcks_and_refresh_equal_a_loop_over_parties(monkeypatch, parties):
    w = parties
    ckg = dbfv.CKGProtocol(SMALL_BFV, device=CPU, seed=1)
    pk = ckg.gen_public_key(fold_stacked(ckg, ckg.gen_share(w["st"], w["crp"])), w["crp"])
    ct = bfv.Encryptor(SMALL_BFV, pk=pk, device=CPU, seed=3).encrypt(w["pt"])
    decode = lambda c, sk: w["enc"].decode_uint(bfv.Decryptor(SMALL_BFV, sk, device=CPU).decrypt(c))

    pcks = dbfv.PCKSProtocol(SMALL_BFV, device=CPU, seed=2)
    gen = lambda p: pcks.gen_share(w["st"] if p is None else w["sks"][p], w["pk_out"], ct)
    combined = _stacked_equals_loop(monkeypatch, pcks, gen)
    switched = pcks.key_switch(combined, ct)
    assert (decode(switched, w["sk_out"]) == w["m"]).all()

    refresh = dbfv.RefreshProtocol(SMALL_BFV, device=CPU, seed=4)
    gen = lambda p: refresh.gen_share(w["st"] if p is None else w["sks"][p], ct, w["crs"])
    combined = _stacked_equals_loop(monkeypatch, refresh, gen)
    out = refresh.finalize(ct, w["crs"], combined)
    assert (decode(out, w["sk_sum"]) == w["m"]).all()


def test_stacked_noise_differs_party_by_party(parties):
    """T2: one secret for all 8 parties, so only the noise tells the
    shares apart."""
    w = parties
    same = w["sks"][0].expand(N_PARTIES, *w["sks"][0].shape)
    ckg = dbfv.CKGProtocol(SMALL_BFV, device=CPU, seed=1)
    assert bench.check_party_noise(ckg, same, w["crp"], ckg.gen_share(same, w["crp"])) == 28
    for proto, gen in (
            (dbfv.PCKSProtocol(SMALL_BFV, device=CPU, seed=2),
             lambda pr: pr.gen_share(same, w["pk_out"], bfv.Ciphertext([w["pt"].value] * 2))),
            (dbfv.RefreshProtocol(SMALL_BFV, device=CPU, seed=4),
             lambda pr: pr.gen_share(same, bfv.Ciphertext([w["pt"].value] * 2), w["crs"]))):
        share = gen(proto)
        for i in range(N_PARTIES):
            for j in range(i):
                assert not torch.equal(share[0][i], share[0][j])
                assert not torch.equal(share[1][i], share[1][j])


def test_a_keyed_program_draws_fresh_shares(parties):
    """T1 on the CPU: a tjit program of a share generator, called twice,
    gives two shares, which still aggregate into a key that decrypts."""
    w = parties
    ckg = dbfv.CKGProtocol(SMALL_BFV, device=CPU, seed=1)
    prog = tjit(lambda sk, crp: ckg.gen_share(sk, crp))
    a, b = prog(w["sks"][0], w["crp"]), prog(w["sks"][0], w["crp"])
    assert not torch.equal(a, b) and prog.trace_count() == 1
    r = bench.check_fresh_noise(SMALL_BFV, CPU, w["sks"][:2], w["crp"])
    assert r["replays_differ"] and r["replayed_key_decrypts"]


# -- failures end the run -------------------------------------------------------


def test_a_raising_config_ends_the_run(monkeypatch):
    def broken(h, **kw):
        raise RuntimeError("broken config")

    monkeypatch.setitem(bench.CONFIGS, "bfv_mul_relin", broken)
    with pytest.raises(RuntimeError, match="broken config"):
        bench.run(CPU, skip=("per_op_table", "threshold_steady", "threshold_8party",
                             "ckks_mul_rescale_rotate", "ckks_pn16", "cheby31"),
                  overrides=SMALL)


def test_a_config_missing_a_metric_ends_the_run(monkeypatch):
    monkeypatch.setitem(bench.CONFIGS, "bfv_mul_relin", lambda h, **kw: None)
    with pytest.raises(RuntimeError, match="emitted"):
        bench.run(CPU, skip=tuple(k for k in bench.CONFIGS if k != "bfv_mul_relin"),
                  overrides=SMALL)


def test_a_spent_budget_ends_the_run(monkeypatch, tmp_path):
    with pytest.raises(SystemExit) as e:
        bench.run(CPU, skip=tuple(bench.CONFIGS), budget_s=1e-9, overrides=SMALL)
    assert e.value.code not in (0, None)
    with pytest.raises(ValueError, match="unknown"):
        bench.run(CPU, skip=("no_such_config",))
    proc = subprocess.run([sys.executable, "-m", "lattigo_tpu_torch.bench", "--device", "cpu",
                           "--out", str(tmp_path / "r.json")], capture_output=True, text=True,
                          env={**os.environ, "BENCH_BUDGET": "0"}, timeout=120)
    assert proc.returncode != 0 and "budget" in proc.stderr
    assert not (tmp_path / "r.json").exists()


def test_no_device_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.Bench()
