"""The port's twin of ``bench.py``: every config of the JAX system's own
benchmark, at its parameter sets, on one CUDA device.

Run from the repository root on a machine with a GPU:

    python -m lattigo_tpu_torch.bench [--skip cheby31,...] [--out PATH]

Config #1 (the headline, the one bare JSON line on standard output): the
forward NTT of ``[1024, 2, 8192]`` residues under the golden 60-bit pair,
held bit for bit against the plain schedule (row 0) and through its inverse
(the whole batch) before it is timed; beside it the single-ciphertext
``[2, 8192]`` transform.  Every other record is a ``CONFIG {...}`` line on
standard error, as bench.py prints them:

  #2 BFV multiply + relinearize at PN13QP218,
  #6 the BFV per-op table at PN12QP109 (encrypt, decrypt, add, mul,
     mul_relin, rotate_cols),
  #5 the 17 dBFV steady-state phases at PN12QP109, and the 8-party
     CKG -> encrypt -> PCKS -> Refresh pipeline with its four phases, the
     parties' shares drawn as one party-stacked batch,
  #3 CKKS mul_relin + rescale + hoisted rotation at PN14QP438, on one
     ciphertext and on a stack of 8,
  #3b CKKS mul_relin + rescale at PN16QP1761,
  #4 the degree-31 Chebyshev at PN15QP880 (``entry.Cheby31``).

Each timed region is one ``tjit`` program (a captured CUDA graph on the
card): ``chain_time`` captures ``chain`` applications of a step, the output
fed back as the input, and replays it ``calls`` times, each replay starting
from the last one's output; ``variant_time`` replays one program on
content-distinct ciphertexts.  A step that draws noise draws it afresh on
every replay (``tjit.note_generator``).  ``ms`` is the replayed time per
step between CUDA events, the copy of the arguments into the program
included; ``capture_s`` the first call (warm-up and capture, the twin of
bench.py's ``compile_s``).  Every record carries the card's name and power
limit, the set's N, ``chain``, ``calls`` and the peak of device memory
above what was allocated before its program; ``vs_baseline`` is null (the
JAX bench's is a TPU target).

Records go to ``--out`` (default ``chiprun_out/bench_torch.json`` under the
repository root) after every config.  Nothing is caught: a config that
raises, a check that fails, or ``BENCH_BUDGET`` seconds (default 1500) spent
before a config ends ends the run with a non-zero exit code.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from lattigo_tpu_torch import device as _device
from lattigo_tpu_torch.entry import entry_cheby31, fold, fold_stacked, rolled_variants
from lattigo_tpu_torch.models import bfv, ckks, dbfv
from lattigo_tpu_torch.ops import u64 as u
from lattigo_tpu_torch.ops.ring import Ring
from lattigo_tpu_torch.tjit import tjit
from lattigo_tpu_torch.utils.precision import precision_stats
from lattigo_tpu_torch.utils.prng import CRPGenerator

GOLDEN_60 = (576460752303439873, 576460752303702017)  # the golden-vector pair
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "chiprun_out", "bench_torch.json")
CKKS_BITS = 12.0  # median bits of a CKKS decoding (bench.py's config #3b)
CHEBY_BITS = 15.0  # median bits of the Chebyshev against its float64 interpolant


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


class Bench:
    """The records of one run on ``device`` (None: the GPU), written to
    ``out`` (None: nowhere) after each."""

    def __init__(self, device=None, out: str | None = None):
        self.device = _device.resolve(device)
        self.cuda = self.device.type == "cuda"
        self.gpu = smi_line() if self.cuda else None
        self.out = out
        self.records: list[dict] = []

    def emit(self, metric: str, value: float, unit: str, **extra) -> dict:
        rec = dict(metric=metric, value=float(value), unit=unit, vs_baseline=None,
                   gpu=self.gpu, **extra)
        self.records.append(rec)
        print("CONFIG " + json.dumps(rec), file=sys.stderr, flush=True)
        if self.out:
            os.makedirs(os.path.dirname(os.path.abspath(self.out)), exist_ok=True)
            with open(self.out, "w") as f:
                json.dump(self.records, f, indent=1)
        return rec

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def elapsed_ms(self, run) -> float:
        """Milliseconds of ``run()``: between CUDA events on the card, by
        the host's clock on the CPU."""
        if not self.cuda:
            t0 = time.perf_counter()
            run()
            return (time.perf_counter() - t0) * 1e3
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        self.sync()
        a.record()
        run()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def mem_start(self) -> int:
        if not self.cuda:
            return 0
        self.sync()
        torch.cuda.reset_peak_memory_stats(self.device)
        return torch.cuda.memory_allocated(self.device)

    def peak_bytes(self, base: int) -> int | None:
        return torch.cuda.max_memory_allocated(self.device) - base if self.cuda else None

    def release(self) -> None:
        if self.cuda:
            self.sync()
            torch.cuda.empty_cache()


def chain_time(h: Bench, fn, z0, chain: int, calls: int, fixed=()) -> tuple[dict, object]:
    """One ``tjit`` program of ``chain`` applications of ``fn(z, *fixed)``,
    the output fed back as ``z`` (the twin of bench.py's ``digest_time``):
    its first call (warm-up + capture) timed as ``capture_s``, then
    ``calls`` replays, each from the last one's output.  Returns the numbers
    (``ms`` per application) and the last output."""

    def chained(z, *fx):
        for _ in range(chain):
            z = fn(z, *fx)
        return z

    prog = tjit(chained)
    base = h.mem_start()
    t0 = time.perf_counter()
    z = prog(z0, *fixed)
    h.sync()
    capture_s = time.perf_counter() - t0
    box = [z]

    def replays():
        for _ in range(calls):
            box[0] = prog(box[0], *fixed)

    total = h.elapsed_ms(replays)
    stats = dict(ms=total / (chain * calls), chain=chain, calls=calls, capture_s=capture_s,
                 peak_bytes=h.peak_bytes(base), programs=prog.trace_count())
    return stats, box[0]


def variant_time(h: Bench, prog, variants: list) -> tuple[dict, object]:
    """``prog`` called on each argument tuple of ``variants`` (content
    distinct, one signature; the twin of bench.py's ``variant_time``): the
    first call timed as ``capture_s``, the others between two events.
    Returns the numbers (``ms`` per call) and the first call's output."""
    base = h.mem_start()
    t0 = time.perf_counter()
    first = prog(*variants[0])
    h.sync()
    capture_s = time.perf_counter() - t0
    total = h.elapsed_ms(lambda: [prog(*v) for v in variants[1:]])
    calls = len(variants) - 1
    return dict(ms=total / calls, chain=1, calls=calls, capture_s=capture_s,
                peak_bytes=h.peak_bytes(base), programs=prog.trace_count()), first


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"bench: {what}")


def _set(p) -> dict:
    return dict(n=p.n, log_n=p.log_n)


# ---------------------------------------------------------------------------
# config #1: the forward NTT, batched and single-ciphertext
# ---------------------------------------------------------------------------


def ntt_headline(h: Bench, n: int = 8192, batch: int = 1024, chain: int = 200,
                 calls: int = 3) -> dict:
    """``[batch, 2, n]`` residues under the golden 60-bit pair: the forward
    of row 0 against the plain schedule and the inverse of the whole batch
    on the device, bit for bit, then ``chain`` forward transforms a replay.
    Returns the record (bench.py's headline)."""
    ring = Ring(n, list(GOLDEN_60), device=h.device)
    rng = np.random.default_rng(0)
    x = rng.integers(0, GOLDEN_60[0], size=(batch, 2, n), dtype=np.uint64)
    x %= np.array(GOLDEN_60, dtype=np.uint64)[None, :, None]
    X = u.from_u64(x, h.device)
    y = ring.ntt(X)
    _check(torch.equal(y[:1], ring._ntt_simple(X[:1], (0, 1))),
           "the forward NTT differs from the plain schedule on the device")
    _check(torch.equal(ring.intt(y), X), "the inverse NTT does not return the batch")
    del y
    stats, _ = chain_time(h, ring.ntt, X, chain, calls)
    h.release()
    return h.emit(f"ntt_per_sec_n{n}_60bit", batch * 2 / (stats["ms"] / 1e3), "NTT/s/chip",
                  shape=[batch, 2, n], bit_exact_on_device=True, n=n, **stats)


def ntt_single_ct(h: Bench, n: int = 8192, chain: int = 400, calls: int = 2) -> None:
    """The ``[2, n]`` transform of one ciphertext's limbs (the row kernel's
    shape): forward against the plain schedule, then timed."""
    ring = Ring(n, list(GOLDEN_60), device=h.device)
    rng = np.random.default_rng(1)
    x = rng.integers(0, GOLDEN_60[0], size=(2, n), dtype=np.uint64)
    x %= np.array(GOLDEN_60, dtype=np.uint64)[:, None]
    X = u.from_u64(x, h.device)
    _check(torch.equal(ring.ntt(X), ring._ntt_simple(X, (0, 1))),
           "the single-ciphertext NTT differs from the plain schedule")
    stats, _ = chain_time(h, ring.ntt, X, chain, calls)
    h.release()
    h.emit(f"ntt_single_ct_n{n}_60bit", 2 / (stats["ms"] / 1e3), "NTT/s/chip",
           note="batch=1 [L,N] row-kernel path", shape=[2, n], n=n, **stats)


# ---------------------------------------------------------------------------
# config #2: BFV multiply + relinearize at PN13QP218
# ---------------------------------------------------------------------------


def bfv_mul_relin(h: Bench, params=None, chain: int = 12, calls: int = 2) -> None:
    params = params or bfv.default_params(bfv.PN13QP218)
    kgen = bfv.KeyGenerator(params, device=h.device, seed=1)
    sk, pk = kgen.gen_key_pair()
    rlk = kgen.gen_relin_key(sk)
    enc = bfv.Encoder(params, device=h.device)
    ev = bfv.Evaluator(params, device=h.device)
    m = np.random.default_rng(1).integers(0, params.t, params.n, dtype=np.uint64)
    ct = bfv.Encryptor(params, pk=pk, device=h.device, seed=1).encrypt(enc.encode_uint(m))
    step = lambda c, k: ev.relinearize(ev.mul(c, c), k)
    sq = enc.decode_uint(bfv.Decryptor(params, sk, device=h.device).decrypt(step(ct, rlk)))
    _check((sq == m * m % np.uint64(params.t)).all(), "BFV mul + relinearize is not exact")
    stats, _ = chain_time(h, step, ct, chain, calls, fixed=(rlk,))
    h.release()
    h.emit("bfv_mul_relin_pn13qp218", 1e3 / stats["ms"], "op/s/chip", params="PN13QP218",
           anchor="bfv/bfv_benchmark_test.go:11", **_set(params), **stats)


# ---------------------------------------------------------------------------
# config #6: the BFV per-op table at PN12QP109
# ---------------------------------------------------------------------------

PER_OP_CHAINS = dict(encrypt=48, decrypt=64, add=512, mul=32, mul_relin=24, rotate_cols=32)


def per_op_table(h: Bench, params=None, chain: int | None = None, calls: int = 2) -> None:
    """Each op as a chain feeding its output back (bench.py's
    ``bench_per_op_table``); ``chain`` overrides every op's chain.  The
    encryption draws fresh noise at every application of every replay."""
    params = params or bfv.default_params(bfv.PN12QP109)
    dev = h.device
    kgen = bfv.KeyGenerator(params, device=dev, seed=7)
    sk, pk = kgen.gen_key_pair()
    rlk = kgen.gen_relin_key(sk)
    rot = bfv.RotationKeys()
    kgen.gen_rot("left", sk, 1, rot)
    enc = bfv.Encoder(params, device=dev)
    encryptor = bfv.Encryptor(params, pk=pk, device=dev, seed=7)
    dec = bfv.Decryptor(params, sk, device=dev)
    ev = bfv.Evaluator(params, device=dev)
    m = np.random.default_rng(7).integers(0, params.t, params.n, dtype=np.uint64)
    pt = enc.encode_uint(m)
    ct = encryptor.encrypt(pt)
    decode = lambda c: enc.decode_uint(dec.decrypt(c))
    half = params.n >> 1
    _check((decode(ct) == m).all(), "BFV encryption does not decrypt exactly")
    _check((decode(ev.rotate_columns(ct, 1, rot)) == np.concatenate(
        [np.roll(m[:half], -1), np.roll(m[half:], -1)])).all(),
        "BFV rotate_columns(1) is not exact")

    steps = dict(
        encrypt=(lambda p: bfv.Plaintext(encryptor.encrypt(p).value[0]), pt, ()),
        decrypt=(lambda c: bfv.Ciphertext([dec.decrypt(c).value, c.value[1]]), ct, ()),
        add=(lambda c, c2: ev.add(c, c2), ct, (ct,)),
        mul=(lambda c, c2: bfv.Ciphertext(ev.mul(c, c2).value[:2]), ct, (ct,)),
        mul_relin=(lambda c, c2, k: ev.relinearize(ev.mul(c, c2), k), ct, (ct, rlk)),
        rotate_cols=(lambda c, r: ev.rotate_columns(c, 1, r), ct, (rot,)),
    )
    for label, (fn, z0, fixed) in steps.items():
        stats, _ = chain_time(h, fn, z0, chain or PER_OP_CHAINS[label], calls, fixed)
        h.release()
        h.emit(f"bfv_{label}_pn12qp109", stats["ms"] * 1e3, "us/op",
               anchor="bfv/bfv_benchmark_test.go:11", **_set(params), **stats)


# ---------------------------------------------------------------------------
# config #5: dBFV steady state and the 8-party pipeline at PN12QP109
# ---------------------------------------------------------------------------


def check_fresh_noise(params, device, sks, crp) -> dict:
    """One compiled CKG share program (a graph on the card) replayed for
    the same party twice: the shares must differ; the parties' shares from
    replays must aggregate to a public key whose encryption decrypts
    exactly under the parties' summed key."""
    ckg = dbfv.CKGProtocol(params, device=device, seed=80)
    prog = tjit(lambda sk, crp_: ckg.gen_share(sk, crp_))
    prog(sks[0], crp)  # warm-up and capture
    a, b = prog(sks[0], crp), prog(sks[0], crp)
    _check(not torch.equal(a, b), "two replays of a keyed share program return the same share")
    pk = ckg.gen_public_key(fold(ckg, [prog(s, crp) for s in sks]), crp)
    ctx = bfv.get_context(params, device)
    sk_sum = sks[0]
    for s in sks[1:]:
        sk_sum = ctx.ring_qp.add(sk_sum, s)
    enc = bfv.Encoder(params, device=device)
    m = np.arange(params.n, dtype=np.uint64) % np.uint64(params.t)
    ct = bfv.Encryptor(params, pk=pk, device=device, seed=81).encrypt(enc.encode_uint(m))
    got = enc.decode_uint(bfv.Decryptor(params, bfv.SecretKey(sk_sum), device=device).decrypt(ct))
    _check((got == m).all(), "a key from replayed shares does not decrypt exactly")
    return dict(replays_differ=True, replayed_key_decrypts=True, replays=prog.replays)


STEADY_CHAINS = dict(ckg_gen=48, ckg_agg=256, cks_gen=48, cks_agg=256, cks_finalize=64,
                     pcks_gen=32, pcks_agg=256, pcks_finalize=64, rkg_round1_gen=16,
                     rkg_round2_gen=16, rkg_round3_gen=16, rkg_finalize=16, rtg_gen=16,
                     rtg_agg=128, refresh_gen=32, refresh_agg=256, refresh_finalize=32)


def threshold_steady(h: Bench, params=None, chain: int | None = None, calls: int = 2) -> None:
    """The 17 phases of bench.py's ``bench_threshold_steady``, each a chain
    (``chain`` overrides every phase's).  A share generator ignores its
    input and draws fresh noise at every application; aggregation and the
    finishing steps feed their output back."""
    params = params or bfv.default_params(bfv.PN12QP109)
    dev = h.device
    ctx = bfv.get_context(params, dev)
    sk0, _ = bfv.KeyGenerator(params, device=dev, seed=40).gen_key_pair()
    sk1, pk1 = bfv.KeyGenerator(params, device=dev, seed=41).gen_key_pair()
    crpg = CRPGenerator(b"bench", ctx.ring_qp)
    crpg.seed(b"steady")
    crp = crpg.clock_poly()
    enc = bfv.Encoder(params, device=dev)
    m = np.random.default_rng(9).integers(0, params.t, params.n, dtype=np.uint64)
    ct = bfv.Encryptor(params, pk=pk1, device=dev, seed=9).encrypt(enc.encode_uint(m))
    fresh = check_fresh_noise(params, dev, [sk0.sk, sk1.sk], crp)

    def timed(label, step, z0, fixed=(), **extra):
        stats, _ = chain_time(h, step, z0, chain or STEADY_CHAINS[label], calls, fixed)
        h.release()
        h.emit(f"dbfv_{label}_pn12qp109", stats["ms"] * 1e3, "us/op",
               anchor="dbfv/dbfv_benchmark_test.go:9", **_set(params), **stats, **extra)

    ckg = dbfv.CKGProtocol(params, device=dev, seed=70)
    s_ckg = ckg.gen_share(sk0.sk, crp)
    timed("ckg_gen", lambda _: ckg.gen_share(sk0.sk, crp), s_ckg, fresh_noise=fresh)
    timed("ckg_agg", ckg.aggregate, s_ckg, (s_ckg,))

    cks = dbfv.CKSProtocol(params, device=dev, seed=71)
    s_cks = cks.gen_share(sk0.sk, sk1.sk, ct)
    timed("cks_gen", lambda _: cks.gen_share(sk0.sk, sk1.sk, ct), s_cks)
    timed("cks_agg", cks.aggregate, s_cks, (s_cks,))
    timed("cks_finalize", lambda c, sh: cks.key_switch(sh, c), ct, (s_cks,))

    pcks = dbfv.PCKSProtocol(params, device=dev, seed=72)
    s_pcks = pcks.gen_share(sk0.sk, pk1, ct)
    timed("pcks_gen", lambda _: pcks.gen_share(sk0.sk, pk1, ct), s_pcks)
    timed("pcks_agg", pcks.aggregate, s_pcks, (s_pcks,))
    timed("pcks_finalize", lambda c, sh: pcks.key_switch(sh, c), ct, (s_pcks,))

    rkg = dbfv.RKGProtocol(params, device=dev, seed=73)
    u_eph = rkg.new_ephemeral_key()
    crp_b = crpg.clock_polys(params.beta)
    r1 = rkg.gen_share_round_one(u_eph, sk0.sk, crp_b)
    r2 = rkg.gen_share_round_two(r1, sk0.sk, crp_b)
    r3 = rkg.gen_share_round_three(r2, u_eph, sk0.sk)
    timed("rkg_round1_gen", lambda _: rkg.gen_share_round_one(u_eph, sk0.sk, crp_b), r1)
    timed("rkg_round2_gen", lambda _: rkg.gen_share_round_two(r1, sk0.sk, crp_b), r2)
    timed("rkg_round3_gen", lambda _: rkg.gen_share_round_three(r2, u_eph, sk0.sk), r3)
    # the key's first half, [beta, L_QP, N] as round three is, fed back
    timed("rkg_finalize", lambda r3c, r2c: rkg.gen_relinearization_key(r2c, r3c).evakey[0].key0,
          r3, (r2,))

    rtg = dbfv.RTGProtocol(params, device=dev, seed=74)
    s_rtg = rtg.gen_share("left", 1, sk0.sk, crp_b)
    timed("rtg_gen", lambda _: rtg.gen_share("left", 1, sk0.sk, crp_b), s_rtg)
    timed("rtg_agg", rtg.aggregate, s_rtg, (s_rtg,))

    refresh = dbfv.RefreshProtocol(params, device=dev, seed=75)
    s_ref = refresh.gen_share(sk0.sk, ct, crp)
    timed("refresh_gen", lambda _: refresh.gen_share(sk0.sk, ct, crp), s_ref)
    timed("refresh_agg", refresh.aggregate, s_ref, (s_ref,))
    timed("refresh_finalize", lambda c, cr, sh: refresh.finalize(c, cr, sh), ct, (crp, s_ref))


N_PARTIES = 8


def check_party_noise(ckg, sks_st: torch.Tensor, crp: torch.Tensor, shares: torch.Tensor) -> int:
    """The noise of party-stacked CKG shares (share + sk * crp) must differ
    between every two parties; returns the pairs checked."""
    noise = ckg.ctx.ring_qp.add(shares, ckg.ctx.ring_qp.mul_coeffs_montgomery(sks_st, crp))
    pairs = 0
    for i in range(noise.shape[0]):
        for j in range(i):
            _check(not torch.equal(noise[i], noise[j]),
                   f"parties {j} and {i} drew the same noise in one stacked share")
            pairs += 1
    return pairs


def threshold_8party(h: Bench, params=None, chain: int = 4, calls: int = 3,
                     phase_chains=(8, 16, 8, 8), phase_calls: int = 2) -> None:
    """bench.py's ``bench_threshold_8party``: CKG -> encrypt -> PCKS ->
    Refresh with 8 parties, each phase one program in which the parties'
    shares are one party-stacked call (``[8, L_QP, N]`` secrets, batch-8
    transforms) folded by ``aggregate``; the chained pipeline, then each
    phase on its own.  Checked first through the compiled phases' replays:
    the stacked shares' noise differs party by party, PCKS decrypts exactly
    under the target key, Refresh of a ciphertext under the collective key
    decrypts exactly under the parties' summed key."""
    params = params or bfv.default_params(bfv.PN12QP109)
    dev = h.device
    ctx = bfv.get_context(params, dev)
    sks = [bfv.KeyGenerator(params, device=dev, seed=10 + i).gen_secret_key()
           for i in range(N_PARTIES)]
    sks_st = torch.stack([s.sk for s in sks])
    crpg = CRPGenerator(b"bench", ctx.ring_qp)
    crpg.seed(b"seed")
    crp, crs = crpg.clock_poly(), crpg.clock_poly()
    enc = bfv.Encoder(params, device=dev)
    m = np.random.default_rng(5).integers(0, params.t, params.n, dtype=np.uint64)
    pt = enc.encode_uint(m)
    ckg = dbfv.CKGProtocol(params, device=dev, seed=60)
    pcks = dbfv.PCKSProtocol(params, device=dev, seed=61)
    refresh = dbfv.RefreshProtocol(params, device=dev, seed=62)
    sk_out, pk_out = bfv.KeyGenerator(params, device=dev, seed=90).gen_key_pair()
    encryptor = bfv.Encryptor(params, pk=pk_out, device=dev, seed=63)  # pk set per call

    def ckg_phase(sks_, crp_):
        return ckg.gen_public_key(fold_stacked(ckg, ckg.gen_share(sks_, crp_)), crp_)

    def enc_phase(pk, pt_):
        encryptor.pk = pk
        return encryptor.encrypt(pt_)

    def pcks_phase(sks_, pk_o, ct_):
        return pcks.key_switch(fold_stacked(pcks, pcks.gen_share(sks_, pk_o, ct_)), ct_)

    def refresh_phase(sks_, ct_, crs_):
        return refresh.finalize(ct_, crs_, fold_stacked(refresh, refresh.gen_share(sks_, ct_, crs_)))

    def pipeline(pt_, sks_, crp_, crs_, pk_o):
        ct_ = enc_phase(ckg_phase(sks_, crp_), pt_)
        out = refresh_phase(sks_, pcks_phase(sks_, pk_o, ct_), crs_)
        return bfv.Plaintext(out.value[0])

    # the checks, on each phase program's replay (its second call)
    pairs = check_party_noise(ckg, sks_st, crp, ckg.gen_share(sks_st, crp))
    progs = [tjit(f) for f in (ckg_phase, enc_phase, pcks_phase, refresh_phase)]
    twice = lambda prog, *a: (prog(*a), prog(*a))[1]
    pk_c = twice(progs[0], sks_st, crp)
    ct_c = twice(progs[1], pk_c, pt)
    ct2_c = twice(progs[2], sks_st, pk_out, ct_c)
    ct3_c = twice(progs[3], sks_st, ct_c, crs)
    sk_sum = fold(ckg, [s.sk for s in sks])
    decode = lambda c, sk: enc.decode_uint(bfv.Decryptor(params, sk, device=dev).decrypt(c))
    _check((decode(ct2_c, sk_out) == m).all(), "8-party PCKS does not decrypt under the target key")
    _check((decode(ct3_c, bfv.SecretKey(sk_sum)) == m).all(), "8-party Refresh is not exact")
    del progs
    h.release()

    stats, _ = chain_time(h, pipeline, pt, chain, calls, (sks_st, crp, crs, pk_out))
    h.release()
    h.emit("dbfv_8party_ckg_pcks_refresh_pn12qp109", stats["ms"], "ms/pipeline",
           parties=N_PARTIES, anchor="dbfv/dbfv_benchmark_test.go:9",
           party_noise_distinct_pairs=pairs, pcks_and_refresh_exact=True, **_set(params), **stats)
    phases = (("ckg", lambda z, s, c: ckg_phase(s, c), pk_c, (sks_st, crp)),
              ("encrypt", lambda z, pk, p: enc_phase(pk, p), ct_c, (pk_c, pt)),
              ("pcks", lambda z, s, pk, c: pcks_phase(s, pk, c), ct2_c, (sks_st, pk_out, ct_c)),
              ("refresh", lambda z, s, c, cr: refresh_phase(s, c, cr), ct2_c, (sks_st, ct_c, crs)))
    for (label, fn, z0, fixed), ch in zip(phases, phase_chains):
        stats, _ = chain_time(h, fn, z0, ch, phase_calls, fixed)
        h.release()
        h.emit(f"dbfv_8party_phase_{label}_pn12qp109", stats["ms"], "ms/phase",
               parties=N_PARTIES, **_set(params), **stats)


# ---------------------------------------------------------------------------
# config #3 and #3b: CKKS at PN14QP438 and PN16QP1761
# ---------------------------------------------------------------------------


def _ckks_setup(params, device, seed: int, hw: int):
    kgen = ckks.KeyGenerator(params, device=device, seed=seed)
    sk, pk = kgen.gen_key_pair_sparse(hw=hw)
    enc = ckks.Encoder(params, device=device)
    v = np.random.default_rng(seed).uniform(-1, 1, params.slots).astype(np.complex128)
    ct = ckks.Encryptor(params, pk=pk, device=device, seed=seed).encrypt(enc.encode(v))
    bits = lambda c, want: precision_stats(
        enc.decode(ckks.Decryptor(params, sk, device=device).decrypt(c)), want).median_bits
    return kgen, sk, ct, v, bits


def mul_rescale_rotate(ev, c, rlk, rot):
    """Config #3's step: ``rotate_hoisted(rescale(mul_relin(c, c)), [1])[1]``."""
    return ev.rotate_hoisted(ev.rescale(ev.mul_relin(c, c, rlk)), [1], rot)[1]


def ckks_mul_rescale_rotate(h: Bench, params=None, n_variants: int = 13,
                            n_batch_variants: int = 7) -> None:
    """``rotate_hoisted(rescale(mul_relin(c, c)), [1])[1]`` as one program,
    on ``n_variants`` rolled ciphertexts, then on 8-ciphertext stacks."""
    params = params or ckks.default_params(ckks.PN14QP438)
    dev = h.device
    kgen, sk, ct, v, bits = _ckks_setup(params, dev, 2, 128)
    rlk = kgen.gen_relin_key(sk)
    rot = ckks.RotationKeys()
    kgen.gen_rot("left", sk, 1, rot)
    ev = ckks.Evaluator(params, device=dev)
    pipeline = tjit(functools.partial(mul_rescale_rotate, ev))
    stats, first = variant_time(h, pipeline, [(c, rlk, rot) for c in rolled_variants(ct, n_variants)])
    b = bits(first, np.roll(v * v, -1))
    _check(b >= CKKS_BITS, f"CKKS mul + rescale + rotate: {b:.2f} median bits < {CKKS_BITS}")
    h.release()
    h.emit("ckks_mul_rescale_pn14qp438", 1e3 / stats["ms"], "mul+rescale+hrot/s/chip",
           params="PN14QP438", anchor="ckks/ckks_benchmarks_test.go:8", precision_bits=b,
           **_set(params), **stats)

    B = 8
    stack = lambda k: ckks.Ciphertext(
        [torch.stack([torch.roll(p, k + i, -1) for i in range(B)]) for p in ct.value], ct.scale)
    stats, _ = variant_time(h, pipeline, [(stack(100 * i), rlk, rot)
                                          for i in range(n_batch_variants)])
    h.release()
    h.emit("ckks_mul_rescale_pn14qp438_batch8", B * 1e3 / stats["ms"], "mul+rescale+hrot/s/chip",
           params="PN14QP438 batch=8", anchor="ckks/ckks_benchmarks_test.go:8",
           per_ct_ms=stats["ms"] / B, **_set(params), **stats)


def ckks_pn16(h: Bench, params=None, n_variants: int = 5) -> None:
    """mul_relin + rescale of one ciphertext at PN16QP1761 (sparse secret,
    hw = 192), held at CKKS_BITS median bits against v * v before it is
    timed on rolled ciphertexts."""
    params = params or ckks.default_params(ckks.PN16QP1761)
    dev = h.device
    kgen, sk, ct, v, bits = _ckks_setup(params, dev, 3, 192)
    rlk = kgen.gen_relin_key(sk)
    ev = ckks.Evaluator(params, device=dev)
    pipeline = tjit(lambda c, k: ev.rescale(ev.mul_relin(c, c, k)))
    b = bits(pipeline(ct, rlk), v * v)
    _check(b >= CKKS_BITS, f"PN16QP1761 mul + relin + rescale: {b:.2f} median bits < {CKKS_BITS}")
    stats, _ = variant_time(h, pipeline, [(c, rlk) for c in rolled_variants(ct, n_variants)])
    h.release()
    h.emit("ckks_mul_relin_rescale_pn16qp1761", 1e3 / stats["ms"], "op/s/chip",
           params="PN16QP1761", anchor="ckks/params.go:35", precision_bits=b,
           **_set(params), **stats)


# ---------------------------------------------------------------------------
# config #4: the degree-31 Chebyshev at PN15QP880
# ---------------------------------------------------------------------------


def cheby31(h: Bench, params=None, n_variants: int = 4) -> None:
    """``entry.Cheby31.run()`` (bench.py's config #4, without its PN14QP438
    fallback: a failure here is a failure)."""
    ch = entry_cheby31(device=h.device, params_idx=params or ckks.PN15QP880)
    base = h.mem_start()
    r = ch.run(n_variants)
    _check(r["bits_vs_chebyshev"] >= CHEBY_BITS,
           f"the Chebyshev has {r['bits_vs_chebyshev']:.2f} median bits < {CHEBY_BITS}")
    peak, p = h.peak_bytes(base), ch.params
    del ch
    h.release()
    h.emit("ckks_cheby31_pn15qp880", r["evals_per_s"], "eval/s/chip", params="PN15QP880 deg=31",
           anchor="examples/ckks/examples_ckks.go:22", ms=1e3 / r["evals_per_s"], chain=1,
           calls=n_variants - 1, peak_bytes=peak, **_set(p), **r)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

# the metrics each config emits: bench.py's names, letter for letter (the
# two NTT names carry the ring's N, 8192 by default)
METRICS = {
    "ntt_headline": ["ntt_per_sec_n8192_60bit"],
    "ntt_single_ct": ["ntt_single_ct_n8192_60bit"],
    "bfv_mul_relin": ["bfv_mul_relin_pn13qp218"],
    "per_op_table": [f"bfv_{op}_pn12qp109" for op in PER_OP_CHAINS],
    "threshold_steady": [f"dbfv_{phase}_pn12qp109" for phase in STEADY_CHAINS],
    "threshold_8party": ["dbfv_8party_ckg_pcks_refresh_pn12qp109"] + [
        f"dbfv_8party_phase_{phase}_pn12qp109" for phase in ("ckg", "encrypt", "pcks", "refresh")],
    "ckks_mul_rescale_rotate": ["ckks_mul_rescale_pn14qp438", "ckks_mul_rescale_pn14qp438_batch8"],
    "ckks_pn16": ["ckks_mul_relin_rescale_pn16qp1761"],
    "cheby31": ["ckks_cheby31_pn15qp880"],
}


def _emitted(h: Bench, name: str, start: int) -> None:
    """Config ``name`` must have emitted exactly its metrics, each a finite
    positive number."""
    recs = h.records[start:]
    got = [re.sub(r"_n\d+_60bit$", "_n8192_60bit", r["metric"]) for r in recs]
    _check(got == METRICS[name], f"{name} emitted {got}, not {METRICS[name]}")
    for r in recs:
        _check(math.isfinite(r["value"]) and r["value"] > 0, f"{r['metric']} = {r['value']}")


# cheapest first after the headline, as bench.py orders them
CONFIGS = {
    "ntt_single_ct": ntt_single_ct,
    "bfv_mul_relin": bfv_mul_relin,
    "per_op_table": per_op_table,
    "threshold_steady": threshold_steady,
    "threshold_8party": threshold_8party,
    "ckks_mul_rescale_rotate": ckks_mul_rescale_rotate,
    "ckks_pn16": ckks_pn16,
    "cheby31": cheby31,
}


def run(device=None, skip=(), out: str | None = None, budget_s: float | None = None,
        overrides: dict | None = None) -> list[dict]:
    """The headline, then every config not in ``skip``; returns the
    records.  ``overrides`` maps a config name (or ``"ntt_headline"``) to
    keyword arguments of its function (smaller sets, chains).  Raises when
    a config raises or ``budget_s`` seconds have gone by at the end of a
    config (``SystemExit``)."""
    unknown = set(skip) - set(CONFIGS)
    if unknown:
        raise ValueError(f"unknown configs {sorted(unknown)}; known: {list(CONFIGS)}")
    overrides = overrides or {}
    t0 = time.perf_counter()
    if budget_s is not None and budget_s <= 0:
        raise SystemExit(f"bench: a budget of {budget_s} s leaves no time for the headline")
    h = Bench(device, out)
    print(f"device: {h.gpu or h.device}  budget: {budget_s}s", file=sys.stderr, flush=True)
    head = ntt_headline(h, **overrides.get("ntt_headline", {}))
    _emitted(h, "ntt_headline", 0)
    print(json.dumps(head), flush=True)
    for name, fn in CONFIGS.items():
        spent = time.perf_counter() - t0
        if budget_s is not None and spent > budget_s:
            raise SystemExit(f"bench: the budget of {budget_s} s ran out before {name} "
                             f"({spent:.1f} s spent)")
        if name in skip:
            continue
        print(f"-- {name} ({spent:.1f} s)", file=sys.stderr, flush=True)
        start = len(h.records)
        fn(h, **overrides.get(name, {}))
        _emitted(h, name, start)
    spent = time.perf_counter() - t0
    if budget_s is not None and spent > budget_s:
        raise SystemExit(f"bench: the budget of {budget_s} s ran out ({spent:.1f} s spent)")
    print(f"wrote {out}" if out else "done", file=sys.stderr, flush=True)
    return h.records


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip", default="", help="configs to leave out, comma-separated: "
                    + ",".join(CONFIGS))
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None, help="default: the GPU (cpu runs on the CPU)")
    args = ap.parse_args(argv)
    skip = tuple(s for s in args.skip.split(",") if s)
    budget = float(os.environ.get("BENCH_BUDGET", "1500"))
    return run(args.device, skip, args.out, budget)


if __name__ == "__main__":
    main()
