"""The port's threshold-BFV protocols against the JAX package's.

Three parties at the log N = 8 set of tests/test_dbfv.py.

* Deterministic steps (``aggregate``, ``gen_public_key``,
  ``gen_relinearization_key``, ``finalize``, ``key_switch``, ``_lift``, the
  ``c1`` of ``encrypt_from_crp``) are fed the JAX package's shares, carried
  across as uint64 arrays, and must equal its outputs bit for bit
  (integers, tolerance 0).
* Share generators draw fresh Gaussian noise from ``torch.Generator``s,
  which cannot reproduce ``jax.random`` bits.  Given the same secret shares,
  CRP and, where a share draws a ternary or uniform polynomial too, that
  same polynomial (recomputed from the JAX protocol's key schedule and
  substituted for the port's draw), the port's share minus the JAX share,
  taken back to the coefficient domain and centred, is at most TOL: the
  sum of the two Gaussian samplers' bounds (each draws |e| <= 18).
* Each protocol run through the port alone decrypts exactly under the
  parties' summed key, as tests/test_dbfv.py checks the JAX package.
"""

import jax
import numpy as np
import pytest
import torch

from lattigo_tpu.models import bfv as jbfv
from lattigo_tpu.models import dbfv as jdbfv
from lattigo_tpu.ops import samplers as jsamplers
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu.utils.prng import CRPGenerator as JCRP
from lattigo_tpu_torch import convert
from lattigo_tpu_torch.entry import entry_dbfv_pir
from lattigo_tpu_torch.models import bfv as tbfv
from lattigo_tpu_torch.models import dbfv as tdbfv
from lattigo_tpu_torch.ops import samplers as tsamplers
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.utils.prng import CRPGenerator as TCRP

torch.set_num_threads(1)

SPEC = dict(log_n=8, t=65537, log_qi=(46, 46), log_pi=(47,), log_qi_mul=(60, 60))
JP = jbfv.Parameters(**SPEC).gen_from_log_moduli()
TP = tbfv.Parameters(**SPEC).gen_from_log_moduli()
N_PARTIES = 3
N, T_MOD = JP.n, JP.t
TOL = 2 * 18  # two Gaussian draws, each |e| <= 18 (the samplers' bound 19 is exclusive)
CPU = "cpu"


def fold(proto, shares):
    acc = shares[0]
    for s in shares[1:]:
        acc = proto.aggregate(acc, s)
    return acc


def to_np(x):
    """A JAX U64 (a (lo, hi) pair of arrays) or a pair of them -> uint64 arrays."""
    if isinstance(x[0], tuple):
        return tuple(to_np(e) for e in x)
    return ju.to_u64(x)


def carry(x):
    return convert.share_from_numpy(to_np(x), CPU)


def assert_same(t, j):
    """A port share/poly (or pair) equals a JAX one bit for bit."""
    got, want = convert.share_to_numpy(t), to_np(j)
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(got, want)


def centred_max(ring, x: torch.Tensor) -> int:
    """max |x| over a coefficient-domain poly read as centred residues."""
    arr = tu.to_u64(x).astype(np.int64)  # residues < 2^61
    q = np.array(ring.moduli[: x.shape[-2]], dtype=np.int64)[:, None]
    return int(np.abs(np.where(arr > q // 2, arr - q, arr)).max())


def noise_gap(t_share, j_share, ring, ntt=False, mont=False) -> int:
    """The centred coefficient-domain gap between two shares (or pairs)."""
    if isinstance(t_share, tuple):
        return max(noise_gap(a, b, ring, ntt, mont) for a, b in zip(t_share, j_share))
    d = ring.sub(t_share, carry(j_share))
    if mont:
        d = ring.inv_mform(d)
    if ntt:
        d = ring.intt(d)
    return centred_max(ring, d)


@pytest.fixture(scope="module")
def w():
    """Parties' keys and a CRP stream in the JAX package, and their twins."""
    jctx = jbfv.get_context(JP)
    jsks = [jbfv.KeyGenerator(JP, rng_key=jax.random.key(100 + i)).gen_secret_key()
            for i in range(N_PARTIES)]
    acc = jsks[0].sk
    for s in jsks[1:]:
        acc = jctx.ring_qp.add(acc, s.sk)
    jcrp = JCRP(b"test", jctx.ring_qp)
    jcrp.seed(b"seed")
    tctx = tbfv.get_context(TP, CPU)
    return dict(
        jctx=jctx, jsks=[s.sk for s in jsks], jsk_col=jbfv.SecretKey(acc), jcrp=jcrp,
        tctx=tctx, tsks=[carry(s.sk) for s in jsks], tsk_col=tbfv.SecretKey(carry(acc)),
        enc=jbfv.Encoder(JP), tenc=tbfv.Encoder(TP, device=CPU),
        rng=np.random.default_rng(3))


def jax_stacked_crp(w):
    polys = [w["jcrp"].clock_poly() for _ in range(JP.beta)]
    return tuple(np.stack([np.asarray(p[h]) for p in polys]) for h in range(2))


def jax_ct(w, m=None):
    m = w["rng"].integers(0, T_MOD, N, dtype=np.uint64) if m is None else m
    ct = jbfv.Encryptor(JP, sk=w["jsk_col"]).encrypt(w["enc"].encode_uint(m))
    return m, ct, convert.ciphertext_from_numpy([ju.to_u64(p) for p in ct.value], CPU)


def draws(proto, offsets, make):
    """The JAX protocol's next draws at ``offsets`` of its key schedule
    (``_next_key`` is ``fold_in(key, n)``), made by ``make(key)``, carried."""
    return [carry(make(jax.random.fold_in(proto._key, proto._n_used + k))) for k in offsets]


def substitute(monkeypatch, name, polys, ring):
    """The port's ``samplers.<name>`` on ``ring`` returns ``polys`` in turn."""
    real = getattr(tsamplers, name)
    queue = list(polys)

    def fake(gen, r, *args, **kw):
        if r is ring:
            return queue.pop(0)
        return real(gen, r, *args, **kw)

    monkeypatch.setattr(tsamplers, name, fake)
    return queue


# -- CKG -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckg(w):
    crp = w["jcrp"].clock_poly()
    proto = jdbfv.CKGProtocol(JP)
    shares = [proto.gen_share(sk, crp) for sk in w["jsks"]]
    comb = fold(proto, shares)
    return dict(crp=crp, shares=shares, comb=comb, pk=proto.gen_public_key(comb, crp))


def test_ckg_deterministic_steps(ckg):
    t = tdbfv.CKGProtocol(TP, device=CPU)
    comb = fold(t, [carry(s) for s in ckg["shares"]])
    assert_same(comb, ckg["comb"])
    pk = t.gen_public_key(comb, carry(ckg["crp"]))
    assert_same(pk.pk, ckg["pk"].pk)


def test_ckg_share_noise(w, ckg):
    t = tdbfv.CKGProtocol(TP, device=CPU)
    ring = w["tctx"].ring_qp
    for sk, share in zip(w["tsks"], ckg["shares"]):
        assert noise_gap(t.gen_share(sk, carry(ckg["crp"])), share, ring, ntt=True) <= TOL


# -- RKG (three rounds) --------------------------------------------------------


@pytest.fixture(scope="module")
def rkg(w):
    crp = jax_stacked_crp(w)
    proto = jdbfv.RKGProtocol(JP)
    ephs = [proto.new_ephemeral_key() for _ in range(N_PARTIES)]
    s1 = [proto.gen_share_round_one(e, sk, crp) for e, sk in zip(ephs, w["jsks"])]
    r1 = fold(proto, s1)
    s2 = [proto.gen_share_round_two(r1, sk, crp) for sk in w["jsks"]]
    r2 = fold(proto, s2)
    s3 = [proto.gen_share_round_three(r2, e, sk) for e, sk in zip(ephs, w["jsks"])]
    r3 = fold(proto, s3)
    return dict(crp=crp, ephs=ephs, s1=s1, r1=r1, s2=s2, r2=r2, s3=s3, r3=r3,
                rlk=proto.gen_relinearization_key(r2, r3))


def test_rkg_deterministic_steps(rkg):
    t = tdbfv.RKGProtocol(TP, device=CPU)
    for shares, comb in (("s1", "r1"), ("s2", "r2"), ("s3", "r3")):
        assert_same(fold(t, [carry(s) for s in rkg[shares]]), rkg[comb])
    rlk = t.gen_relinearization_key(carry(rkg["r2"]), carry(rkg["r3"]))
    swk, want = rlk.evakey[0], rkg["rlk"].evakey[0]
    assert_same((swk.key0, swk.key1), (want.key0, want.key1))


def test_rkg_share_noise(w, rkg):
    t = tdbfv.RKGProtocol(TP, device=CPU)
    ring = w["tctx"].ring_qp
    crp = carry(rkg["crp"])
    for i, sk in enumerate(w["tsks"]):
        eph = carry(rkg["ephs"][i])
        s1 = t.gen_share_round_one(eph, sk, crp)
        assert s1.shape == (JP.beta, ring.L, N)
        assert noise_gap(s1, rkg["s1"][i], ring, ntt=True) <= TOL
        s2 = t.gen_share_round_two(carry(rkg["r1"]), sk, crp)
        assert noise_gap(s2, rkg["s2"][i], ring, ntt=True) <= TOL
        s3 = t.gen_share_round_three(carry(rkg["r2"]), eph, sk)
        assert noise_gap(s3, rkg["s3"][i], ring, ntt=True) <= TOL
    # the ephemeral key is a ternary secret in Montgomery and NTT form
    u = ring.intt(ring.inv_mform(t.new_ephemeral_key()))
    assert centred_max(ring, u) == 1


# -- RKG (naive, two rounds) ---------------------------------------------------


@pytest.fixture(scope="module")
def rkg_naive(w, ckg):
    proto = jdbfv.RKGProtocolNaive(JP)
    pk = ckg["pk"]
    rq = w["jctx"].ring_qp
    tern = lambda key: jsamplers.ternary_poly(key, rq, 0.5, montgomery=True)
    us, s1 = [], []
    for sk in w["jsks"]:  # draws per block: e0, e1, u
        us.append(draws(proto, [3 * i + 3 for i in range(JP.beta)], tern))
        s1.append(proto.gen_share_round_one(sk, pk))
    r1 = fold(proto, s1)
    vs, s2 = [], []
    for sk in w["jsks"]:  # draws per block: v, e2, e3
        vs.append(draws(proto, [3 * i + 1 for i in range(JP.beta)], tern))
        s2.append(proto.gen_share_round_two(r1, sk, pk))
    r2 = fold(proto, s2)
    return dict(us=us, s1=s1, r1=r1, vs=vs, s2=s2, r2=r2,
                rlk=proto.gen_relinearization_key(r2))


def test_rkg_naive_deterministic_steps(rkg_naive):
    t = tdbfv.RKGProtocolNaive(TP, device=CPU)
    for shares, comb in (("s1", "r1"), ("s2", "r2")):
        assert_same(fold(t, [carry(s) for s in rkg_naive[shares]]), rkg_naive[comb])
    swk, want = t.gen_relinearization_key(carry(rkg_naive["r2"])).evakey[0], rkg_naive["rlk"].evakey[0]
    assert_same((swk.key0, swk.key1), (want.key0, want.key1))


def test_rkg_naive_share_noise(w, ckg, rkg_naive, monkeypatch):
    t = tdbfv.RKGProtocolNaive(TP, device=CPU)
    ring = w["tctx"].ring_qp
    pk = tbfv.PublicKey(carry(ckg["pk"].pk))
    for i, sk in enumerate(w["tsks"]):
        left = substitute(monkeypatch, "ternary_poly", rkg_naive["us"][i], ring)
        s1 = t.gen_share_round_one(sk, pk)
        assert not left
        monkeypatch.undo()
        left = substitute(monkeypatch, "ternary_poly", rkg_naive["vs"][i], ring)
        s2 = t.gen_share_round_two(carry(rkg_naive["r1"]), sk, pk)
        assert not left
        monkeypatch.undo()
        assert noise_gap(s1, rkg_naive["s1"][i], ring, ntt=True) <= TOL
        assert noise_gap(s2, rkg_naive["s2"][i], ring, ntt=True) <= TOL


# -- RTG -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def rtg(w):
    out = {}
    proto = jdbfv.RTGProtocol(JP)
    for rot_type, k in (("left", 3), ("right", 2), ("row", 0)):
        crp = jax_stacked_crp(w)
        shares = [proto.gen_share(rot_type, k, sk, crp) for sk in w["jsks"]]
        rk = jbfv.RotationKeys()
        comb = fold(proto, shares)
        proto.finalize(rot_type, k, comb, crp, rk)
        out[rot_type] = dict(k=k, crp=crp, shares=shares, comb=comb, rk=rk)
    return out


def test_rtg_deterministic_steps(rtg):
    t = tdbfv.RTGProtocol(TP, device=CPU)
    rk = tbfv.RotationKeys()
    for rot_type, r in rtg.items():
        comb = fold(t, [carry(s) for s in r["shares"]])
        assert_same(comb, r["comb"])
        t.finalize(rot_type, r["k"], comb, carry(r["crp"]), rk)
    left, right, row = convert.bfv_rotation_keys_to_numpy(rk)
    want = lambda swk: (ju.to_u64(swk.key0), ju.to_u64(swk.key1))
    for got, ref in ((left[3], want(rtg["left"]["rk"].left[3])),
                     (right[2], want(rtg["right"]["rk"].right[2])),
                     (row, want(rtg["row"]["rk"].row))):
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


def test_rtg_share_noise(w, rtg):
    t = tdbfv.RTGProtocol(TP, device=CPU)
    ring = w["tctx"].ring_qp
    for rot_type, r in rtg.items():
        for sk, share in zip(w["tsks"], r["shares"]):
            got = t.gen_share(rot_type, r["k"], sk, carry(r["crp"]))
            assert noise_gap(got, share, ring, ntt=True, mont=True) <= TOL


# -- CKS and PCKS --------------------------------------------------------------


@pytest.fixture(scope="module")
def cks(w):
    jsks_out = [jbfv.KeyGenerator(JP, rng_key=jax.random.key(777 + i)).gen_secret_key().sk
                for i in range(N_PARTIES)]
    m, ct, tct = jax_ct(w)
    proto = jdbfv.CKSProtocol(JP)
    shares = [proto.gen_share(si, so, ct) for si, so in zip(w["jsks"], jsks_out)]
    comb = fold(proto, shares)
    return dict(sks_out=jsks_out, ct=ct, tct=tct, shares=shares, comb=comb,
                out=proto.key_switch(comb, ct))


def test_cks_deterministic_steps(cks):
    t = tdbfv.CKSProtocol(TP, device=CPU)
    comb = fold(t, [carry(s) for s in cks["shares"]])
    assert_same(comb, cks["comb"])
    assert_same(tuple(t.key_switch(comb, cks["tct"]).value), tuple(cks["out"].value))


def test_cks_share_noise(w, cks):
    t = tdbfv.CKSProtocol(TP, device=CPU)
    ring = w["tctx"].ring_q
    for sk, so, share in zip(w["tsks"], cks["sks_out"], cks["shares"]):
        assert noise_gap(t.gen_share(sk, carry(so), cks["tct"]), share, ring) <= TOL


@pytest.fixture(scope="module")
def pcks(w):
    _, jpk = jbfv.KeyGenerator(JP, rng_key=jax.random.key(888)).gen_key_pair()
    m, ct, tct = jax_ct(w)
    proto = jdbfv.PCKSProtocol(JP)
    rq = w["jctx"].ring_qp
    us, shares = [], []
    for sk in w["jsks"]:  # draws: u, e0, e1
        us.append(draws(proto, [1], lambda k: jsamplers.ternary_poly(k, rq, 0.5, montgomery=True)))
        shares.append(proto.gen_share(sk, jpk, ct))
    comb = fold(proto, shares)
    return dict(pk=jpk, ct=ct, tct=tct, us=us, shares=shares, comb=comb,
                out=proto.key_switch(comb, ct))


def test_pcks_deterministic_steps(pcks):
    t = tdbfv.PCKSProtocol(TP, device=CPU)
    comb = fold(t, [carry(s) for s in pcks["shares"]])
    assert_same(comb, pcks["comb"])
    assert_same(tuple(t.key_switch(comb, pcks["tct"]).value), tuple(pcks["out"].value))


def test_pcks_share_noise(w, pcks, monkeypatch):
    t = tdbfv.PCKSProtocol(TP, device=CPU)
    pk = tbfv.PublicKey(carry(pcks["pk"].pk))
    for i, sk in enumerate(w["tsks"]):
        left = substitute(monkeypatch, "ternary_poly", pcks["us"][i], w["tctx"].ring_qp)
        got = t.gen_share(sk, pk, pcks["tct"])
        assert not left
        monkeypatch.undo()
        assert noise_gap(got, pcks["shares"][i], w["tctx"].ring_q) <= TOL


# -- Refresh and encrypt_from_crp ----------------------------------------------


@pytest.fixture(scope="module")
def refresh(w):
    m, ct, tct = jax_ct(w)
    crs = w["jcrp"].clock_poly()
    proto = jdbfv.RefreshProtocol(JP)
    rt = w["jctx"].ring_t
    masks, shares = [], []
    for sk in w["jsks"]:  # draws: e, e', mask
        masks.append(draws(proto, [3], lambda k: jsamplers.uniform_poly(k, rt)))
        shares.append(proto.gen_share(sk, ct, crs))
    comb = fold(proto, shares)
    mask_t = jsamplers.uniform_poly(jax.random.key(5), rt)
    return dict(m=m, ct=ct, tct=tct, crs=crs, masks=masks, shares=shares, comb=comb,
                out=proto.finalize(ct, crs, comb), mask_t=mask_t, lifted=proto._lift(mask_t))


def test_refresh_deterministic_steps(refresh):
    t = tdbfv.RefreshProtocol(TP, device=CPU)
    assert_same(t._lift(carry(refresh["mask_t"])), refresh["lifted"])
    comb = fold(t, [carry(s) for s in refresh["shares"]])
    assert_same(comb, refresh["comb"])
    out = t.finalize(refresh["tct"], carry(refresh["crs"]), comb)
    assert_same(tuple(out.value), tuple(refresh["out"].value))


def test_refresh_share_noise(w, refresh, monkeypatch):
    t = tdbfv.RefreshProtocol(TP, device=CPU)
    for i, sk in enumerate(w["tsks"]):
        left = substitute(monkeypatch, "uniform_poly", refresh["masks"][i], w["tctx"].ring_t)
        got = t.gen_share(sk, refresh["tct"], carry(refresh["crs"]))
        assert not left
        monkeypatch.undo()
        assert noise_gap(got, refresh["shares"][i], w["tctx"].ring_q) <= TOL


def test_encrypt_from_crp(w):
    """c1 is the CRP itself in basis Q, bit for bit; c0 decrypts."""
    m = w["rng"].integers(0, T_MOD, N, dtype=np.uint64)
    crp = w["jcrp"].clock_poly()
    jct = jbfv.Encryptor(JP, sk=w["jsk_col"]).encrypt_from_crp(w["enc"].encode_uint(m), crp)
    tenc = w["tenc"]
    tct = tbfv.Encryptor(TP, sk=w["tsk_col"], device=CPU).encrypt_from_crp(
        tenc.encode_uint(m), carry(crp))
    assert_same(tct.value[1], jct.value[1])
    dec = tbfv.Decryptor(TP, w["tsk_col"], device=CPU)
    np.testing.assert_array_equal(tenc.decode_uint(dec.decrypt(tct)), m)
    with pytest.raises(ValueError):
        tbfv.Encryptor(TP, pk=object(), device=CPU).encrypt_from_crp(None, carry(crp))


# -- each protocol through the port alone --------------------------------------


@pytest.fixture(scope="module")
def port():
    ctx = tbfv.get_context(TP, CPU)
    sks = [tbfv.KeyGenerator(TP, device=CPU, seed=100 + i).gen_secret_key() for i in range(N_PARTIES)]
    acc = sks[0].sk
    for s in sks[1:]:
        acc = ctx.ring_qp.add(acc, s.sk)
    crp = TCRP(b"test", ctx.ring_qp)
    crp.seed(b"seed")
    enc = tbfv.Encoder(TP, device=CPU)
    sk_col = tbfv.SecretKey(acc)
    return dict(ctx=ctx, sks=[s.sk for s in sks], sk_col=sk_col, crp=crp, enc=enc,
                dec=tbfv.Decryptor(TP, sk_col, device=CPU), ev=tbfv.Evaluator(TP, device=CPU),
                rng=np.random.default_rng(4))


def slots(p):
    return p["rng"].integers(0, T_MOD, N, dtype=np.uint64)


def port_pk(p):
    proto = tdbfv.CKGProtocol(TP, device=CPU)
    crp = p["crp"].clock_poly()
    return proto.gen_public_key(fold(proto, [proto.gen_share(sk, crp) for sk in p["sks"]]), crp)


def sk_encrypt(p, m):
    return tbfv.Encryptor(TP, sk=p["sk_col"], device=CPU).encrypt(p["enc"].encode_uint(m))


def test_port_ckg(port):
    m = slots(port)
    ct = tbfv.Encryptor(TP, pk=port_pk(port), device=CPU).encrypt(port["enc"].encode_uint(m))
    np.testing.assert_array_equal(port["enc"].decode_uint(port["dec"].decrypt(ct)), m)


def test_port_cks(port):
    ctx = port["ctx"]
    outs = [tbfv.KeyGenerator(TP, device=CPU, seed=777 + i).gen_secret_key().sk
            for i in range(N_PARTIES)]
    acc = outs[0]
    for s in outs[1:]:
        acc = ctx.ring_qp.add(acc, s)
    m = slots(port)
    ct = sk_encrypt(port, m)
    proto = tdbfv.CKSProtocol(TP, sigma_smudging=3.2, device=CPU)
    ct2 = proto.key_switch(fold(proto, [proto.gen_share(si, so, ct)
                                         for si, so in zip(port["sks"], outs)]), ct)
    dec = tbfv.Decryptor(TP, tbfv.SecretKey(acc), device=CPU)
    np.testing.assert_array_equal(port["enc"].decode_uint(dec.decrypt(ct2)), m)


def test_port_pcks(port):
    sk_t, pk_t = tbfv.KeyGenerator(TP, device=CPU, seed=888).gen_key_pair()
    m = slots(port)
    ct = sk_encrypt(port, m)
    proto = tdbfv.PCKSProtocol(TP, sigma_smudging=3.2, device=CPU)
    ct2 = proto.key_switch(fold(proto, [proto.gen_share(sk, pk_t, ct) for sk in port["sks"]]), ct)
    dec = tbfv.Decryptor(TP, sk_t, device=CPU)
    np.testing.assert_array_equal(port["enc"].decode_uint(dec.decrypt(ct2)), m)


def test_port_rkg(port):
    proto = tdbfv.RKGProtocol(TP, device=CPU)
    crp = port["crp"].clock_polys(TP.beta)
    sks = port["sks"]
    ephs = [proto.new_ephemeral_key() for _ in sks]
    r1 = fold(proto, [proto.gen_share_round_one(e, s, crp) for e, s in zip(ephs, sks)])
    r2 = fold(proto, [proto.gen_share_round_two(r1, s, crp) for s in sks])
    r3 = fold(proto, [proto.gen_share_round_three(r2, e, s) for e, s in zip(ephs, sks)])
    rlk = proto.gen_relinearization_key(r2, r3)
    m0, m1 = slots(port), slots(port)
    prod = port["ev"].relinearize(port["ev"].mul(sk_encrypt(port, m0), sk_encrypt(port, m1)), rlk)
    assert prod.degree == 1
    np.testing.assert_array_equal(port["enc"].decode_uint(port["dec"].decrypt(prod)),
                                  m0 * m1 % np.uint64(T_MOD))


def test_port_rkg_naive(port):
    pk = port_pk(port)
    proto = tdbfv.RKGProtocolNaive(TP, device=CPU)
    r1 = fold(proto, [proto.gen_share_round_one(sk, pk) for sk in port["sks"]])
    r2 = fold(proto, [proto.gen_share_round_two(r1, sk, pk) for sk in port["sks"]])
    rlk = proto.gen_relinearization_key(r2)
    m0, m1 = slots(port), slots(port)
    encryptor = tbfv.Encryptor(TP, pk=pk, device=CPU)
    cts = [encryptor.encrypt(port["enc"].encode_uint(m)) for m in (m0, m1)]
    prod = port["ev"].relinearize(port["ev"].mul(*cts), rlk)
    np.testing.assert_array_equal(port["enc"].decode_uint(port["dec"].decrypt(prod)),
                                  m0 * m1 % np.uint64(T_MOD))


def test_port_rtg(port):
    proto = tdbfv.RTGProtocol(TP, device=CPU)
    rk = tbfv.RotationKeys()
    for rot_type, k in (("left", 3), ("row", 0)):
        crp = port["crp"].clock_polys(TP.beta)
        shares = [proto.gen_share(rot_type, k, sk, crp) for sk in port["sks"]]
        proto.finalize(rot_type, k, fold(proto, shares), crp, rk)
    with pytest.raises(ValueError):
        proto.gen_share("diagonal", 1, port["sks"][0], crp)
    m = slots(port)
    ct = sk_encrypt(port, m)
    row = N // 2
    got = port["enc"].decode_uint(port["dec"].decrypt(port["ev"].rotate_columns(ct, 3, rk)))
    np.testing.assert_array_equal(got, np.concatenate([np.roll(m[:row], -3), np.roll(m[row:], -3)]))
    got = port["enc"].decode_uint(port["dec"].decrypt(port["ev"].rotate_rows(ct, rk)))
    np.testing.assert_array_equal(got, np.concatenate([m[row:], m[:row]]))


def test_port_refresh(port):
    m = slots(port)
    ct = sk_encrypt(port, m)
    proto = tdbfv.RefreshProtocol(TP, device=CPU)
    crs = port["crp"].clock_poly()
    ct2 = proto.finalize(ct, crs, fold(proto, [proto.gen_share(sk, ct, crs) for sk in port["sks"]]))
    np.testing.assert_array_equal(port["enc"].decode_uint(port["dec"].decrypt(ct2)), m)


def test_using_generator_swaps_the_noise_stream(port):
    proto = tdbfv.CKGProtocol(TP, device=CPU)
    crp = port["crp"].clock_poly()
    sk = port["sks"][0]
    with proto.using_generator(tsamplers.make_generator(torch.device(CPU), 9)):
        a = proto.gen_share(sk, crp)
    b = proto.gen_share(sk, crp)  # the protocol's own stream, untouched by the block
    c = tdbfv.CKGProtocol(TP, device=CPU, seed=9).gen_share(sk, crp)
    assert torch.equal(a, c) and not torch.equal(a, b)
    assert torch.equal(b, tdbfv.CKGProtocol(TP, device=CPU).gen_share(sk, crp))


# -- the slice as a whole ------------------------------------------------------


def test_entry_dbfv_pir_retrieves_the_row():
    """examples/dbfv_pir.py's pipeline in the port at log N = 8: three
    parties, eight rows, one-hot query; the requester decrypts row 2."""
    pir = entry_dbfv_pir(device=CPU, params_idx=TP)
    got = pir.run()
    assert got.shape == (N,)
    np.testing.assert_array_equal(got, pir.rows[pir.wanted])


def test_dbfv_entry_points_default_to_cuda():
    """device=None means the GPU: without one every new entry point raises."""
    makers = [lambda cls=cls: cls(TP) for cls in (
        tdbfv.CKGProtocol, tdbfv.CKSProtocol, tdbfv.PCKSProtocol, tdbfv.RKGProtocol,
        tdbfv.RKGProtocolNaive, tdbfv.RTGProtocol, tdbfv.RefreshProtocol)]
    makers.append(lambda: entry_dbfv_pir(params_idx=TP))
    for make in makers:
        if torch.cuda.is_available():
            make()
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
