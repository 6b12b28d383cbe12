"""The port's threshold-CKKS protocols against the JAX package's.

Three parties at the log N = 8 set of tests/test_dckks.py.  The parties'
secret keys and the ciphertexts are made by the port and carried across.

* Deterministic steps (``aggregate``, ``gen_public_key``, ``key_switch``,
  ``gen_relinearization_key``, the RTG ``finalize``, the refresh's
  ``finalize`` and ``finalize_bigint``, the ``c1`` of ``encrypt_from_crp``)
  are fed the JAX package's shares and must equal its outputs bit for bit
  (integers, tolerance 0).
* Share generators draw fresh Gaussian noise from ``torch.Generator``s,
  which cannot reproduce ``jax.random`` bits.  Given the same secret keys,
  CRP and, where a share draws a ternary polynomial or a smudging mask too,
  that same draw (the ternary polynomials recomputed from the JAX
  protocol's ``fold_in`` key schedule and substituted for the port's; the
  refresh's mask planes, the output of the JAX ``gen_mask_planes``, fed to
  ``gen_share_masked``), the port's share minus the JAX share, taken back
  to the coefficient domain and centred, is at most TOL: the sum of the two
  Gaussian samplers' bounds (each draws |e| <= 18).
* Each protocol run through the port alone decrypts under the parties'
  summed key at tests/test_dckks.py's budgets (median bits: 11; 10 for
  rotations, conjugation, the three-round key and refresh; 9 for the
  two-round key).
"""

import jax
import numpy as np
import pytest
import torch

from lattigo_tpu.models import ckks as jckks
from lattigo_tpu.models import dckks as jdckks
from lattigo_tpu.ops import samplers as jsamplers
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu.utils.prng import CRPGenerator as JCRP
from lattigo_tpu_torch import convert
from lattigo_tpu_torch.entry import entry_dckks_sigmoid
from lattigo_tpu_torch.models import ckks as tckks
from lattigo_tpu_torch.models import dckks as tdckks
from lattigo_tpu_torch.ops import samplers as tsamplers
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.utils.precision import precision_stats
from lattigo_tpu_torch.utils.prng import CRPGenerator as TCRP

torch.set_num_threads(1)

SPEC = dict(log_n=8, log_slots=7, scale=float(1 << 32), log_qi=(45, 32, 32, 32), log_pi=(45,))
JP = jckks.Parameters(**SPEC).gen_from_log_moduli()
TP = tckks.Parameters(**SPEC).gen_from_log_moduli()
N_PARTIES = 3
N, SLOTS, TOP = TP.n, TP.slots, TP.max_level
TOL = 2 * 18  # two Gaussian draws, each |e| <= 18 (the samplers' bound 19 is exclusive)
CPU = "cpu"
# examples/ckks_sigmoid.py's set: five levels below the top
SIGMOID_SPEC = dict(log_n=8, log_slots=7, scale=float(1 << 30),
                    log_qi=(45, 30, 30, 30, 30, 30), log_pi=(45,))


def fold(proto, shares):
    acc = shares[0]
    for s in shares[1:]:
        acc = proto.aggregate(acc, s)
    return acc


def to_np(x):
    """A JAX U64 (a pair of uint32 planes) or a pair of them -> uint64 arrays."""
    if isinstance(x[0], tuple):
        return tuple(to_np(e) for e in x)
    return ju.to_u64(jax.tree.map(np.asarray, x))


def carry(x):
    return convert.share_from_numpy(to_np(x), CPU)


def to_jax(t: torch.Tensor):
    return ju.from_u64(tu.to_u64(t))


def jax_ct(ct: tckks.Ciphertext) -> jckks.Ciphertext:
    return jckks.Ciphertext([to_jax(p) for p in ct.value], ct.scale)


def assert_same(t, j):
    """A port share/poly (or pair) equals a JAX one bit for bit."""
    got, want = convert.share_to_numpy(t), to_np(j)
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(got, want)


def assert_ct_same(t: tckks.Ciphertext, j: jckks.Ciphertext):
    assert t.scale == j.scale and t.level == j.level
    assert_same(tuple(t.value), tuple(j.value))


def centred_max(ring, x: torch.Tensor) -> int:
    """max |x| over a coefficient-domain poly read as centred residues."""
    arr = tu.to_u64(x).astype(np.int64)  # residues < 2^61
    q = np.array(ring.moduli[: x.shape[-2]], dtype=np.int64)[:, None]
    return int(np.abs(np.where(arr > q // 2, arr - q, arr)).max())


def noise_gap(t_share, j_share, ring, mont=False) -> int:
    """The centred coefficient-domain gap between two NTT-domain shares (or
    pairs)."""
    if isinstance(t_share, tuple):
        return max(noise_gap(a, b, ring, mont) for a, b in zip(t_share, j_share))
    d = ring.sub(t_share, carry(j_share))
    if mont:
        d = ring.inv_mform(d)
    return centred_max(ring, ring.intt(d))


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


def median_bits(got, want) -> float:
    return precision_stats(got, want).median_bits


@pytest.fixture(scope="module")
def w():
    """The parties' keys (made by the port), their JAX twins, a CRP stream
    in the JAX package, and the port's encoder and tools."""
    tctx = tckks.get_context(TP, CPU)
    tsks = [tckks.KeyGenerator(TP, device=CPU, seed=300 + i).gen_secret_key().sk
            for i in range(N_PARTIES)]
    acc = tsks[0]
    for s in tsks[1:]:
        acc = tctx.ring_qp.add(acc, s)
    sk_col = tckks.SecretKey(acc)
    jcrp = JCRP(b"ck", jckks.get_context(JP).ring_qp)
    jcrp.seed(b"seed")
    return dict(
        tctx=tctx, tsks=tsks, sk_col=sk_col, jsks=[to_jax(s) for s in tsks], jcrp=jcrp,
        jpk_ctx=jckks.get_context(JP), enc=tckks.Encoder(TP, device=CPU),
        dec=tckks.Decryptor(TP, sk_col, device=CPU), ev=tckks.Evaluator(TP, device=CPU),
        enc_sk=tckks.Encryptor(TP, sk=sk_col, device=CPU, seed=5), rng=np.random.default_rng(4))


def rand_values(w):
    return w["rng"].uniform(-1, 1, SLOTS) + 1j * w["rng"].uniform(-1, 1, SLOTS)


def encrypt(w, level=TOP):
    """Random slots and their encryption under the summed key at ``level``."""
    v = rand_values(w)
    ct = w["enc_sk"].encrypt(w["enc"].encode(v))
    return v, w["ev"].drop_level(ct, TOP - level) if level < TOP else ct


def decode(w, ct, dec=None):
    return w["enc"].decode((dec or w["dec"]).decrypt(ct))


def jax_stacked_crp(w):
    polys = [w["jcrp"].clock_poly() for _ in range(JP.beta())]
    return tuple(np.stack([np.asarray(p[h]) for p in polys]) for h in range(2))


# -- CKG -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckg(w):
    crp = w["jcrp"].clock_poly()
    proto = jdckks.CKGProtocol(JP)
    shares = [proto.gen_share(sk, crp) for sk in w["jsks"]]
    comb = fold(proto, shares)
    return dict(crp=crp, shares=shares, comb=comb, pk=proto.gen_public_key(comb, crp))


def test_ckg_deterministic_steps(ckg):
    t = tdckks.CKGProtocol(TP, device=CPU)
    comb = fold(t, [carry(s) for s in ckg["shares"]])
    assert_same(comb, ckg["comb"])
    assert_same(t.gen_public_key(comb, carry(ckg["crp"])).pk, ckg["pk"].pk)


def test_ckg_share_noise(w, ckg):
    t = tdckks.CKGProtocol(TP, device=CPU)
    for sk, share in zip(w["tsks"], ckg["shares"]):
        assert noise_gap(t.gen_share(sk, carry(ckg["crp"])), share, w["tctx"].ring_qp) <= TOL


# -- RKG (three rounds) --------------------------------------------------------


@pytest.fixture(scope="module")
def rkg(w):
    crp = jax_stacked_crp(w)
    proto = jdckks.RKGProtocol(JP)
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
    t = tdckks.RKGProtocol(TP, device=CPU)
    for shares, comb in (("s1", "r1"), ("s2", "r2"), ("s3", "r3")):
        assert_same(fold(t, [carry(s) for s in rkg[shares]]), rkg[comb])
    swk, want = t.gen_relinearization_key(carry(rkg["r2"]), carry(rkg["r3"])).evakey, rkg["rlk"].evakey
    assert isinstance(swk, tckks.SwitchingKey)
    assert_same((swk.key0, swk.key1), (want.key0, want.key1))


def test_rkg_share_noise(w, rkg):
    t = tdckks.RKGProtocol(TP, device=CPU)
    ring = w["tctx"].ring_qp
    crp = carry(rkg["crp"])
    for i, sk in enumerate(w["tsks"]):
        eph = carry(rkg["ephs"][i])
        s1 = t.gen_share_round_one(eph, sk, crp)
        assert s1.shape == (TP.beta(), ring.L, N)
        assert noise_gap(s1, rkg["s1"][i], ring) <= TOL
        assert noise_gap(t.gen_share_round_two(carry(rkg["r1"]), sk, crp), rkg["s2"][i], ring) <= TOL
        assert noise_gap(t.gen_share_round_three(carry(rkg["r2"]), eph, sk), rkg["s3"][i], ring) <= TOL
    # the ephemeral key is a ternary secret in Montgomery and NTT form
    assert centred_max(ring, ring.intt(ring.inv_mform(t.new_ephemeral_key()))) == 1


# -- RKG (naive, two rounds) ---------------------------------------------------


@pytest.fixture(scope="module")
def rkg_naive(w, ckg):
    proto = jdckks.RKGProtocolNaive(JP)
    pk = ckg["pk"]
    rq = w["jpk_ctx"].ring_qp
    tern = lambda key: jsamplers.ternary_poly(key, rq, 0.5, montgomery=True)
    us, s1 = [], []
    for sk in w["jsks"]:  # draws per block: e0, e1, u
        us.append(draws(proto, [3 * i + 3 for i in range(JP.beta())], tern))
        s1.append(proto.gen_share_round_one(sk, pk))
    r1 = fold(proto, s1)
    vs, s2 = [], []
    for sk in w["jsks"]:  # draws per block: v, e2, e3
        vs.append(draws(proto, [3 * i + 1 for i in range(JP.beta())], tern))
        s2.append(proto.gen_share_round_two(r1, sk, pk))
    r2 = fold(proto, s2)
    return dict(us=us, s1=s1, r1=r1, vs=vs, s2=s2, r2=r2, rlk=proto.gen_relinearization_key(r2))


def test_rkg_naive_deterministic_steps(rkg_naive):
    t = tdckks.RKGProtocolNaive(TP, device=CPU)
    for shares, comb in (("s1", "r1"), ("s2", "r2")):
        assert_same(fold(t, [carry(s) for s in rkg_naive[shares]]), rkg_naive[comb])
    swk, want = t.gen_relinearization_key(carry(rkg_naive["r2"])).evakey, rkg_naive["rlk"].evakey
    assert_same((swk.key0, swk.key1), (want.key0, want.key1))


def test_rkg_naive_share_noise(w, ckg, rkg_naive, monkeypatch):
    t = tdckks.RKGProtocolNaive(TP, device=CPU)
    ring = w["tctx"].ring_qp
    pk = tckks.PublicKey(carry(ckg["pk"].pk))
    for i, sk in enumerate(w["tsks"]):
        left = substitute(monkeypatch, "ternary_poly", rkg_naive["us"][i], ring)
        s1 = t.gen_share_round_one(sk, pk)
        assert not left
        monkeypatch.undo()
        left = substitute(monkeypatch, "ternary_poly", rkg_naive["vs"][i], ring)
        s2 = t.gen_share_round_two(carry(rkg_naive["r1"]), sk, pk)
        assert not left
        monkeypatch.undo()
        assert noise_gap(s1, rkg_naive["s1"][i], ring) <= TOL
        assert noise_gap(s2, rkg_naive["s2"][i], ring) <= TOL


# -- RTG -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def rtg(w):
    out = {}
    proto = jdckks.RTGProtocol(JP)
    for rot_type, k in (("left", 3), ("right", 2), ("conjugate", 0)):
        crp = jax_stacked_crp(w)
        shares = [proto.gen_share(rot_type, k, sk, crp) for sk in w["jsks"]]
        rk = jckks.RotationKeys()
        comb = fold(proto, shares)
        proto.finalize(rot_type, k, comb, crp, rk)
        out[rot_type] = dict(k=k, crp=crp, shares=shares, comb=comb, rk=rk)
    return out


def test_rtg_deterministic_steps(rtg):
    t = tdckks.RTGProtocol(TP, device=CPU)
    rk = tckks.RotationKeys()
    for rot_type, r in rtg.items():
        comb = fold(t, [carry(s) for s in r["shares"]])
        assert_same(comb, r["comb"])
        t.finalize(rot_type, r["k"], comb, carry(r["crp"]), rk)
    left, right, conj = convert.rotation_keys_to_numpy(rk)
    want = lambda swk: (to_np(swk.key0), to_np(swk.key1))
    for got, ref in ((left[3], want(rtg["left"]["rk"].left[3])),
                     (right[2], want(rtg["right"]["rk"].right[2])),
                     (conj, want(rtg["conjugate"]["rk"].conjugate))):
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


def test_rtg_share_noise(w, rtg):
    t = tdckks.RTGProtocol(TP, device=CPU)
    for rot_type, r in rtg.items():
        for sk, share in zip(w["tsks"], r["shares"]):
            got = t.gen_share(rot_type, r["k"], sk, carry(r["crp"]))
            assert noise_gap(got, share, w["tctx"].ring_qp, mont=True) <= TOL
    with pytest.raises(ValueError):
        t.gen_share("row", 0, w["tsks"][0], carry(r["crp"]))


# -- CKS and PCKS, at the top level and below it -------------------------------


@pytest.fixture(scope="module", params=[TOP, TOP - 1], ids=["top", "lower"])
def cks(w, request):
    sks_out = [to_jax(tckks.KeyGenerator(TP, device=CPU, seed=777 + i).gen_secret_key().sk)
               for i in range(N_PARTIES)]
    _, ct = encrypt(w, request.param)
    proto = jdckks.CKSProtocol(JP)
    shares = [proto.gen_share(si, so, jax_ct(ct)) for si, so in zip(w["jsks"], sks_out)]
    comb = fold(proto, shares)
    return dict(sks_out=sks_out, ct=ct, shares=shares, comb=comb,
                out=proto.key_switch(comb, jax_ct(ct)))


def test_cks_deterministic_steps(cks):
    t = tdckks.CKSProtocol(TP, device=CPU)
    comb = fold(t, [carry(s) for s in cks["shares"]])
    assert_same(comb, cks["comb"])
    assert_ct_same(t.key_switch(comb, cks["ct"]), cks["out"])


def test_cks_share_noise(w, cks):
    t = tdckks.CKSProtocol(TP, device=CPU)
    for sk, so, share in zip(w["tsks"], cks["sks_out"], cks["shares"]):
        got = t.gen_share(sk, carry(so), cks["ct"])
        assert got.shape == (cks["ct"].level + 1, N)
        assert noise_gap(got, share, w["tctx"].ring_q) <= TOL


@pytest.fixture(scope="module", params=[TOP, TOP - 1], ids=["top", "lower"])
def pcks(w, request):
    _, tpk = tckks.KeyGenerator(TP, device=CPU, seed=888).gen_key_pair()
    jpk = jckks.PublicKey(tuple(to_jax(p) for p in tpk.pk))
    _, ct = encrypt(w, request.param)
    proto = jdckks.PCKSProtocol(JP)
    rq = w["jpk_ctx"].ring_qp
    us, shares = [], []
    for sk in w["jsks"]:  # draws: u, e0, e1
        us.append(draws(proto, [1], lambda k: jsamplers.ternary_poly(k, rq, 0.5, montgomery=True)))
        shares.append(proto.gen_share(sk, jpk, jax_ct(ct)))
    comb = fold(proto, shares)
    return dict(pk=tpk, ct=ct, us=us, shares=shares, comb=comb,
                out=proto.key_switch(comb, jax_ct(ct)))


def test_pcks_deterministic_steps(pcks):
    t = tdckks.PCKSProtocol(TP, device=CPU)
    comb = fold(t, [carry(s) for s in pcks["shares"]])
    assert_same(comb, pcks["comb"])
    assert_ct_same(t.key_switch(comb, pcks["ct"]), pcks["out"])


def test_pcks_share_noise(w, pcks, monkeypatch):
    t = tdckks.PCKSProtocol(TP, device=CPU)
    for i, sk in enumerate(w["tsks"]):
        left = substitute(monkeypatch, "ternary_poly", pcks["us"][i], w["tctx"].ring_qp)
        got = t.gen_share(sk, pcks["pk"], pcks["ct"])
        assert not left
        monkeypatch.undo()
        assert noise_gap(got, pcks["shares"][i], w["tctx"].ring_q) <= TOL


# -- Refresh -------------------------------------------------------------------


@pytest.fixture(scope="module")
def refresh(w):
    """A ciphertext two levels down refreshed by the JAX package, with each
    party's mask planes kept."""
    v, ct = encrypt(w, TOP - 2)
    crs = jsamplers.uniform_poly(jax.random.key(31337), w["jpk_ctx"].ring_q)
    proto = jdckks.RefreshProtocol(JP)
    masks, shares = [], []
    for sk in w["jsks"]:
        m = proto.gen_mask_planes(N_PARTIES, ct.level)
        masks.append(m)
        shares.append(proto.gen_share_masked(sk, to_jax(ct.value[1]), crs, *m))
    comb = fold(proto, shares)
    return dict(v=v, ct=ct, crs=crs, masks=masks, shares=shares, comb=comb,
                out=proto.finalize(jax_ct(ct), crs, comb),
                out_big=proto.finalize_bigint(jax_ct(ct), crs, comb))


def test_refresh_deterministic_steps(w, refresh):
    t = tdckks.RefreshProtocol(TP, device=CPU)
    comb = fold(t, [carry(s) for s in refresh["shares"]])
    assert_same(comb, refresh["comb"])
    assert comb[0].shape[-2] == TOP - 1 and comb[1].shape[-2] == TOP + 1
    crs = carry(refresh["crs"])
    out = t.finalize(refresh["ct"], crs, comb)
    assert_ct_same(out, refresh["out"])
    assert_ct_same(t.finalize_bigint(refresh["ct"], crs, comb), refresh["out_big"])
    assert out.level == TOP
    assert median_bits(decode(w, out), refresh["v"]) >= 10


def test_refresh_share_noise(w, refresh):
    t = tdckks.RefreshProtocol(TP, device=CPU)
    for sk, m, share in zip(w["tsks"], refresh["masks"], refresh["shares"]):
        got = t.gen_share_masked(sk, refresh["ct"].value[1], carry(refresh["crs"]),
                                 carry(m[0]), carry(m[1]))
        assert noise_gap(got, share, w["tctx"].ring_q) <= TOL


def test_refresh_mask_planes(w):
    """The port's mask: the same integers at the ciphertext's level and at
    the top level, centred, below Q_lvl / (4 n_parties) in magnitude."""
    t = tdckks.RefreshProtocol(TP, device=CPU)
    rq = w["tctx"].ring_q
    for lvl in range(TOP + 1):
        at_lvl, full = t.gen_mask_planes(N_PARTIES, lvl)
        assert torch.equal(at_lvl, full[: lvl + 1])
        q_all, q_lvl = rq.modulus_bigint, int(np.prod([int(q) for q in rq.moduli[: lvl + 1]], dtype=object))
        big = rq.poly_to_bigint_vec(full)
        mask = np.where(big > q_all // 2, big - q_all, big)
        bound = q_lvl // (2 * N_PARTIES)
        assert max(abs(int(x)) for x in mask) <= bound // 2
        assert len(set(mask.tolist())) > N // 2  # not constant


@pytest.mark.parametrize("level", list(range(TOP, -1, -1)))
def test_port_refresh_at_every_level(w, level):
    """Refresh through the port alone from every level: the level comes back
    to the top, the device recode equals the host big-integer one bit for
    bit, and the slots decrypt."""
    v, ct = encrypt(w, level)
    crs = tsamplers.uniform_poly(tsamplers.make_generator(torch.device(CPU), level), w["tctx"].ring_q)
    t = tdckks.RefreshProtocol(TP, device=CPU)
    comb = fold(t, [t.gen_shares(sk, N_PARTIES, ct, crs) for sk in w["tsks"]])
    out = t.finalize(ct, crs, comb)
    assert out.level == TOP and out.scale == ct.scale
    assert all(torch.equal(a, b) for a, b in zip(out.value, t.finalize_bigint(ct, crs, comb).value))
    assert median_bits(decode(w, out), v) >= 10


# -- encrypt_from_crp ----------------------------------------------------------


def test_encrypt_from_crp(w):
    """c1 is the CRP itself, divided by P into basis Q, bit for bit; the
    ciphertext decrypts; without a secret key the call raises."""
    crp = w["jcrp"].clock_poly()
    v = rand_values(w)
    pt = w["enc"].encode(v)
    jpt = jckks.Plaintext(to_jax(pt.value), pt.scale)
    jct = jckks.Encryptor(JP, sk=jckks.SecretKey(to_jax(w["sk_col"].sk))).encrypt_from_crp(jpt, crp)
    tct = w["enc_sk"].encrypt_from_crp(pt, carry(crp))
    assert_same(tct.value[1], jct.value[1])
    assert median_bits(decode(w, tct), v) >= 11
    with pytest.raises(ValueError):
        tckks.Encryptor(TP, pk=object(), device=CPU).encrypt_from_crp(pt, carry(crp))


# -- each protocol through the port alone --------------------------------------


@pytest.fixture(scope="module")
def port(w):
    crp = TCRP(b"ck", w["tctx"].ring_qp)
    crp.seed(b"seed")
    ckg = tdckks.CKGProtocol(TP, device=CPU)
    c = crp.clock_poly()
    pk = ckg.gen_public_key(fold(ckg, [ckg.gen_share(sk, c) for sk in w["tsks"]]), c)
    return dict(crp=crp, pk=pk)


def test_port_ckg(w, port):
    v = rand_values(w)
    ct = tckks.Encryptor(TP, pk=port["pk"], device=CPU, seed=9).encrypt(w["enc"].encode(v))
    assert median_bits(decode(w, ct), v) >= 11


@pytest.mark.parametrize("level", [TOP, TOP - 1])
def test_port_cks(w, level):
    outs = [tckks.KeyGenerator(TP, device=CPU, seed=777 + i).gen_secret_key().sk
            for i in range(N_PARTIES)]
    acc = outs[0]
    for s in outs[1:]:
        acc = w["tctx"].ring_qp.add(acc, s)
    v, ct = encrypt(w, level)
    proto = tdckks.CKSProtocol(TP, device=CPU)
    ct2 = proto.key_switch(fold(proto, [proto.gen_share(si, so, ct)
                                         for si, so in zip(w["tsks"], outs)]), ct)
    assert ct2.level == level
    dec = tckks.Decryptor(TP, tckks.SecretKey(acc), device=CPU)
    assert median_bits(decode(w, ct2, dec), v) >= 11


@pytest.mark.parametrize("level", [TOP, TOP - 2])
def test_port_pcks(w, level):
    sk_t, pk_t = tckks.KeyGenerator(TP, device=CPU, seed=444).gen_key_pair()
    v, ct = encrypt(w, level)
    proto = tdckks.PCKSProtocol(TP, device=CPU)
    ct2 = proto.key_switch(fold(proto, [proto.gen_share(sk, pk_t, ct) for sk in w["tsks"]]), ct)
    assert ct2.level == level
    assert median_bits(decode(w, ct2, tckks.Decryptor(TP, sk_t, device=CPU)), v) >= 11


def product_bits(w, rlk, pk=None):
    """Median bits of a relinearized product of two fresh encryptions."""
    v0, v1 = rand_values(w), rand_values(w)
    encryptor = w["enc_sk"] if pk is None else tckks.Encryptor(TP, pk=pk, device=CPU, seed=8)
    cts = [encryptor.encrypt(w["enc"].encode(v)) for v in (v0, v1)]
    prod = w["ev"].mul_relin(*cts, rlk)
    assert prod.degree == 1
    return median_bits(decode(w, prod), v0 * v1)


def test_port_rkg(w, port):
    proto = tdckks.RKGProtocol(TP, device=CPU)
    crp = port["crp"].clock_polys(TP.beta())
    sks = w["tsks"]
    ephs = [proto.new_ephemeral_key() for _ in sks]
    r1 = fold(proto, [proto.gen_share_round_one(e, s, crp) for e, s in zip(ephs, sks)])
    r2 = fold(proto, [proto.gen_share_round_two(r1, s, crp) for s in sks])
    r3 = fold(proto, [proto.gen_share_round_three(r2, e, s) for e, s in zip(ephs, sks)])
    assert product_bits(w, proto.gen_relinearization_key(r2, r3)) >= 10


def test_port_rkg_naive(w, port):
    proto = tdckks.RKGProtocolNaive(TP, device=CPU)
    r1 = fold(proto, [proto.gen_share_round_one(sk, port["pk"]) for sk in w["tsks"]])
    r2 = fold(proto, [proto.gen_share_round_two(r1, sk, port["pk"]) for sk in w["tsks"]])
    assert product_bits(w, proto.gen_relinearization_key(r2), port["pk"]) >= 9


def test_port_rtg(w, port):
    proto = tdckks.RTGProtocol(TP, device=CPU)
    rk = tckks.RotationKeys()
    for rot_type, k in (("left", 2), ("right", 1), ("conjugate", 0)):
        crp = port["crp"].clock_polys(TP.beta())
        shares = [proto.gen_share(rot_type, k, sk, crp) for sk in w["tsks"]]
        proto.finalize(rot_type, k, fold(proto, shares), crp, rk)
    v, ct = encrypt(w)
    ev = w["ev"]
    assert median_bits(decode(w, ev.rotate_columns(ct, 2, rk)), np.roll(v, -2)) >= 10
    assert median_bits(decode(w, ev.rotate_columns(ct, SLOTS - 1, rk)), np.roll(v, 1)) >= 10
    assert median_bits(decode(w, ev.conjugate(ct, rk)), np.conj(v)) >= 10


def test_using_generator_swaps_the_noise_stream(w, port):
    proto = tdckks.CKGProtocol(TP, device=CPU)
    crp = port["crp"].clock_poly()
    sk = w["tsks"][0]
    with proto.using_generator(tsamplers.make_generator(torch.device(CPU), 9)):
        a = proto.gen_share(sk, crp)
    b = proto.gen_share(sk, crp)  # the protocol's own stream, untouched by the block
    assert torch.equal(a, tdckks.CKGProtocol(TP, device=CPU, seed=9).gen_share(sk, crp))
    assert not torch.equal(a, b)
    assert torch.equal(b, tdckks.CKGProtocol(TP, device=CPU, seed=2000).gen_share(sk, crp))


# -- the slice as a whole ------------------------------------------------------


def test_entry_dckks_sigmoid_meets_the_bar():
    """The 3-party sigmoid network at log N = 8: every stage in turn, the
    levels each layer leaves, and the output at examples/ckks_sigmoid.py's
    7-bit bar against the sigmoids and closer still against the two
    Chebyshev interpolants in float64."""
    params = tckks.Parameters(**SIGMOID_SPEC).gen_from_log_moduli()
    net = entry_dckks_sigmoid(device=CPU, params_idx=params)
    pk, rlk, rot_keys = net.ckg(), net.rkg(), net.rtg()
    assert sorted(rot_keys.left) == [1] and rot_keys.conjugate is not None
    cts = net.encrypt(pk)
    hidden = net.layer1(cts, rlk, rot_keys)
    assert hidden.level == params.max_level - 5
    fresh = net.refresh(hidden)
    assert fresh.level == params.max_level and fresh.scale == hidden.scale
    out = net.layer2(fresh, rlk)
    assert out.level == params.max_level - 4
    sk_req, pk_req = net.requester_key()
    got = net.decrypt(net.pcks(out, pk_req), sk_req)
    assert got.shape == (params.slots,) and np.isfinite(got).all()
    assert median_bits(got, net.want()) >= 7
    assert median_bits(got, net.want(exact=False)) > median_bits(got, net.want())
    # every share crossed as the reference's bytes
    assert set(net.wire_bytes) == {"ckg", "rkg", "rtg", "refresh", "pcks"}
    poly = 2 + 8 * N * (len(params.qi) + len(params.pi))
    assert net.wire_bytes["ckg"] == N_PARTIES * poly
    assert net.wire_bytes["rkg"] == N_PARTIES * (3 + 4 * params.beta() * poly)


def test_dckks_entry_points_default_to_cuda():
    """device=None means the GPU: without one every new entry point raises."""
    makers = [lambda cls=cls: cls(TP) for cls in (
        tdckks.CKGProtocol, tdckks.CKSProtocol, tdckks.PCKSProtocol, tdckks.RKGProtocol,
        tdckks.RKGProtocolNaive, tdckks.RTGProtocol, tdckks.RefreshProtocol)]
    makers.append(lambda: entry_dckks_sigmoid(params_idx=TP))
    for make in makers:
        if torch.cuda.is_available():
            make()
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
