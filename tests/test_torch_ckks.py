"""The CKKS slice of the port against the JAX package.

Keys and ciphertexts are made by the port, carried across as uint64 arrays
(lattigo_tpu_torch.convert) and the same deterministic op runs in both
packages: outputs are equal bit for bit (integers, tolerance 0).  Key
generation and encryption draw torch bits, which jax.random cannot
reproduce, so they are held by decryption at the JAX tests' precision
budget (median >= 12 bits, tests/test_ckks.py).  The parameter set is the
JAX tests' small one (log N = 8)."""

import jax
import numpy as np
import pytest
import torch

from lattigo_tpu.models import ckks as jckks
from lattigo_tpu.ops import galois as jgalois
from lattigo_tpu.ops import scaling as jscaling
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu_torch import convert
from lattigo_tpu_torch.entry import entry_ckks, entry_dckks_sigmoid
from lattigo_tpu_torch.models import ckks as tckks
from lattigo_tpu_torch.ops import galois as tgalois
from lattigo_tpu_torch.ops import ring as tring_mod
from lattigo_tpu_torch.ops import samplers
from lattigo_tpu_torch.ops import scaling as tscaling
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.utils import profiling
from lattigo_tpu_torch.utils.precision import precision_stats

torch.set_num_threads(1)

SPEC = dict(log_n=8, log_slots=7, scale=float(1 << 32), log_qi=(45, 32, 32, 32), log_pi=(45,))
JP = jckks.Parameters(**SPEC).gen_from_log_moduli()
TP = tckks.Parameters(**SPEC).gen_from_log_moduli()
N, SLOTS = JP.n, JP.slots
MIN_PREC = 12.0


def rand_values(rng):
    return rng.uniform(-1, 1, SLOTS) + 1j * rng.uniform(-1, 1, SLOTS)


def jnp_out(x):
    return ju.to_u64(jax.tree.map(np.asarray, x))


def to_jax_ct(ct):
    polys, scale = convert.ckks_ciphertext_to_numpy(ct)
    return jckks.Ciphertext([ju.from_u64(p) for p in polys], scale)


def to_jax_swk(swk):
    k0, k1 = convert.switching_key_to_numpy(swk)
    return jckks.SwitchingKey(ju.from_u64(k0), ju.from_u64(k1))


def assert_ct_equal(tct, jct):
    assert tct.scale == jct.scale
    assert len(tct.value) == len(jct.value)
    polys, _ = convert.ckks_ciphertext_to_numpy(tct)
    for a, b in zip(polys, jct.value):
        np.testing.assert_array_equal(a, jnp_out(b))


def median_bits(got, want):
    return precision_stats(got, want).median_bits


@pytest.fixture(scope="module")
def world():
    """Port-made keys and ciphertexts, and their carried-across twins."""
    kgen = tckks.KeyGenerator(TP, device="cpu", seed=1)
    sk, pk = kgen.gen_key_pair()
    rlk = kgen.gen_relin_key(sk)
    rot = tckks.RotationKeys()
    for k in (1, 2):
        kgen.gen_rot("left", sk, k, rot)
    kgen.gen_rot("right", sk, 1, rot)
    kgen.gen_rot("conjugate", sk, 0, rot)
    sk2 = kgen.gen_secret_key()
    swk = kgen.gen_switching_key(sk, sk2)
    enc = tckks.Encoder(TP, device="cpu")
    encryptor = tckks.Encryptor(TP, pk=pk, device="cpu", seed=2)
    rng = np.random.default_rng(1)
    va, vb = rand_values(rng), rand_values(rng)
    ca, cb = encryptor.encrypt(enc.encode(va)), encryptor.encrypt(enc.encode(vb))
    t = dict(sk=sk, rlk=rlk, rot=rot, swk=swk, ca=ca, cb=cb, enc=enc,
             ev=tckks.Evaluator(TP, device="cpu"), dec=tckks.Decryptor(TP, sk, device="cpu"),
             dec2=tckks.Decryptor(TP, sk2, device="cpu"))
    left, right, conj = convert.rotation_keys_to_numpy(rot)
    carry = lambda k: jckks.SwitchingKey(ju.from_u64(k[0]), ju.from_u64(k[1]))
    j = dict(
        rlk=jckks.EvaluationKey(to_jax_swk(rlk.evakey)),
        rot=jckks.RotationKeys({r: carry(k) for r, k in left.items()},
                               {r: carry(k) for r, k in right.items()}, carry(conj)),
        swk=to_jax_swk(swk), ca=to_jax_ct(ca), cb=to_jax_ct(cb),
        enc=jckks.Encoder(JP), ev=jckks.Evaluator(JP),
    )
    return dict(t=t, j=j, va=va, vb=vb)


def roundtrip(t, ct, dec="dec"):
    return t["enc"].decode(t[dec].decrypt(ct))


# -- parameters, conversion ----------------------------------------------------


def test_parameters_agree():
    assert (TP.qi, TP.pi, TP.beta()) == (JP.qi, JP.pi, JP.beta())
    for idx in range(5):
        a, b = tckks.default_params(idx), jckks.default_params(idx)
        assert (a.n, a.slots, a.scale, a.qi, a.pi, a.beta()) == (b.n, b.slots, b.scale, b.qi, b.pi, b.beta())


def test_convert_roundtrip(world):
    t = world["t"]
    polys, scale = convert.ckks_ciphertext_to_numpy(t["ca"])
    back = convert.ckks_ciphertext_from_numpy(polys, scale, "cpu")
    assert back.scale == t["ca"].scale and back.level == t["ca"].level
    assert all(torch.equal(a, b) for a, b in zip(back.value, t["ca"].value))
    pt = t["enc"].encode(world["va"])
    p, s = convert.ckks_plaintext_to_numpy(pt)
    assert torch.equal(convert.ckks_plaintext_from_numpy(p, s, "cpu").value, pt.value)
    rk = convert.rotation_keys_from_numpy(*convert.rotation_keys_to_numpy(t["rot"]), "cpu")
    assert sorted(rk.left) == [1, 2] and sorted(rk.right) == [1]
    assert torch.equal(rk.conjugate.key1, t["rot"].conjugate.key1)


# -- ops modules ---------------------------------------------------------------


@pytest.mark.parametrize("which", ["left1", "right3", "conjugate"])
def test_galois_permutes_equal(world, which):
    ctx = world["t"]["ev"].ctx
    gal_el = {"left1": ctx.gal_el_rot_col_left[1], "right3": ctx.gal_el_rot_col_right[3],
              "conjugate": ctx.gal_el_conjugate}[which]
    np.testing.assert_array_equal(tgalois.permute_ntt_index(gal_el, N),
                                  jgalois.permute_ntt_index(gal_el, N))
    for got, want in zip(tgalois._permute_tables(gal_el, N), jgalois._permute_tables(gal_el, N)):
        np.testing.assert_array_equal(got, want)
    x = world["t"]["ca"].value[0]
    np.testing.assert_array_equal(tu.to_u64(tgalois.permute_ntt(x, gal_el)),
                                  jnp_out(jgalois.permute_ntt(ju.from_u64(tu.to_u64(x)), gal_el)))
    jring = world["j"]["ev"].ctx.ring_q
    xc = ctx.ring_q.intt(x)
    np.testing.assert_array_equal(
        tu.to_u64(tgalois.permute(ctx.ring_q, xc, gal_el)),
        jnp_out(jgalois.permute(jring, ju.from_u64(tu.to_u64(xc)), gal_el)))


def test_ring_methods_equal(world):
    """The Ring methods the CKKS modules reach, on non-prefix limbs too."""
    tring, jring = world["t"]["ev"].ctx.ring_qp, world["j"]["ev"].ctx.ring_qp
    rng = np.random.default_rng(8)
    limbs = (0, 1, 4)
    a = np.stack([rng.integers(0, 2 * tring.moduli[l], size=(2, N), dtype=np.uint64) for l in limbs], -2)
    b = np.stack([rng.integers(0, tring.moduli[l], size=(2, N), dtype=np.uint64) for l in limbs], -2)
    ta, tb, ja, jb = tu.from_u64(a, "cpu"), tu.from_u64(b, "cpu"), ju.from_u64(a), ju.from_u64(b)
    np.testing.assert_array_equal(tu.to_u64(tring.mul_coeffs_montgomery_limbs(ta, tb, limbs)),
                                  jnp_out(jring.mul_coeffs_montgomery_limbs(ja, jb, limbs)))
    np.testing.assert_array_equal(tu.to_u64(tring.reduce_limbs(ta, limbs)),
                                  jnp_out(jring.reduce_limbs(ja, limbs)))
    tq, jq = world["t"]["ev"].ctx.ring_q, world["j"]["ev"].ctx.ring_q
    x = world["t"]["ca"].value[1]
    jx = ju.from_u64(tu.to_u64(x))
    np.testing.assert_array_equal(tu.to_u64(tq.inv_mform(x)), jnp_out(jq.inv_mform(jx)))
    np.testing.assert_array_equal(tu.to_u64(tq.mul_scalar(x, 12345)), jnp_out(jq.mul_scalar(jx, 12345)))
    assert (tq.poly_to_bigint_vec(x) == jq.poly_to_bigint_vec(jx)).all()


DIVS = ["div_floor_by_last_modulus", "div_floor_by_last_modulus_ntt", "div_round_by_last_modulus",
        "div_round_by_last_modulus_ntt", "div_floor_by_last_modulus_many",
        "div_round_by_last_modulus_many"]


@pytest.mark.parametrize("name", DIVS)
def test_scaling_divisions_equal(world, name):
    """Both ciphertext polys stacked, as rescale calls them."""
    tring, jring = world["t"]["ev"].ctx.ring_q, world["j"]["ev"].ctx.ring_q
    x = torch.stack(world["t"]["ca"].value)
    args = (2,) if name.endswith("_many") else ()
    got = getattr(tscaling, name)(tring, x, *args)
    want = getattr(jscaling, name)(jring, ju.from_u64(tu.to_u64(x)), *args)
    assert got.shape[-2] == x.shape[-2] - (args[0] if args else 1)
    np.testing.assert_array_equal(tu.to_u64(got), jnp_out(want))


def test_mod_down_split_ntt_pq_equal(world):
    """At the key switch's shape: the Q and P parts of one QP poly."""
    tctx, jctx = world["t"]["ev"].ctx, world["j"]["ev"].ctx
    rng = np.random.default_rng(4)
    x = np.stack([rng.integers(0, q, size=N, dtype=np.uint64) for q in TP.qi + TP.pi])
    nq = len(TP.qi)
    got = tctx.basis_q_p.mod_down_split_ntt_pq(tu.from_u64(x[:nq], "cpu"), tu.from_u64(x[nq:], "cpu"))
    want = jctx.basis_q_p.mod_down_split_ntt_pq(ju.from_u64(x[:nq]), ju.from_u64(x[nq:]))
    np.testing.assert_array_equal(tu.to_u64(got), jnp_out(want))


def test_source_range_equal():
    from lattigo_tpu.ops.basis_ext import Decomposer as JDec
    from lattigo_tpu_torch.ops.basis_ext import Decomposer as TDec

    for n_q, n_p in ((34, 4), (7, 3), (4, 1), (6, 2)):
        qs, ps = list(range(n_q)), list(range(100, 100 + n_p))
        jd, td = JDec(qs, ps), TDec(qs, ps, "cpu")
        for level in range(n_q):
            for b in range(-(-(level + 1) // n_p)):
                assert td.source_range(level, b) == jd.source_range(level, b)


def test_ternary_sparse_sampler():
    ring = tckks.get_context(TP, "cpu").ring_qp
    x = tu.to_u64(samplers.ternary_sparse_poly(samplers.make_generator(torch.device("cpu"), 7),
                                               ring, 64))
    assert x.shape == (ring.L, N)
    nz = x[0] != 0
    assert nz.sum() == 64
    for i, q in enumerate(ring.moduli):  # the same +-1 in every limb
        np.testing.assert_array_equal(x[i] != 0, nz)
        assert set(np.unique(x[i][nz]).tolist()) <= {1, q - 1}


# -- encoder -------------------------------------------------------------------


def test_encode_equal(world):
    t, j = world["t"], world["j"]
    v = world["va"]
    tpt, jpt = t["enc"].encode(v), j["enc"].encode(v)
    assert tpt.scale == jpt.scale
    np.testing.assert_array_equal(tu.to_u64(tpt.value), jnp_out(jpt.value))
    tpt2 = t["enc"].encode(v[:16], slots=16, level=1, scale=float(1 << 30))
    jpt2 = j["enc"].encode(v[:16], slots=16, level=1, scale=float(1 << 30))
    np.testing.assert_array_equal(tu.to_u64(tpt2.value), jnp_out(jpt2.value))


def test_decode_equal(world):
    t, j = world["t"], world["j"]
    pt = t["dec"].decrypt(t["ca"])
    got = t["enc"].decode(pt)
    want = j["enc"].decode(jckks.Plaintext(ju.from_u64(tu.to_u64(pt.value)), pt.scale))
    np.testing.assert_array_equal(got, want)
    assert median_bits(got, world["va"]) >= MIN_PREC
    stacked = tckks.Plaintext(torch.stack([pt.value, pt.value]), pt.scale)
    np.testing.assert_array_equal(t["enc"].decode(stacked), np.stack([got, got]))


# -- evaluator -----------------------------------------------------------------


LINEAR = ["add", "sub", "neg", "reduce", "drop_level", "add_plain", "plain_minus_ct",
          "add_other_scale"]


@pytest.mark.parametrize("op", LINEAR)
def test_linear_ops_equal(world, op):
    t, j = world["t"], world["j"]
    tev, jev = t["ev"], j["ev"]
    if op in ("add", "sub"):
        pair = getattr(tev, op)(t["ca"], t["cb"]), getattr(jev, op)(j["ca"], j["cb"])
    elif op in ("neg", "reduce"):
        pair = getattr(tev, op)(t["ca"]), getattr(jev, op)(j["ca"])
    elif op == "drop_level":
        pair = tev.drop_level(t["ca"], 2), jev.drop_level(j["ca"], 2)
    elif op == "add_plain":
        pair = (tev.add(t["ca"], t["enc"].encode(world["vb"])),
                jev.add(j["ca"], j["enc"].encode(world["vb"])))
    elif op == "plain_minus_ct":
        pair = (tev.sub(t["enc"].encode(world["vb"]), t["ca"]),
                jev.sub(j["enc"].encode(world["vb"]), j["ca"]))
    else:  # scales differ by an integer ratio: the smaller side is multiplied up
        pt_t = t["enc"].encode(world["vb"], scale=float(1 << 30))
        pt_j = j["enc"].encode(world["vb"], scale=float(1 << 30))
        pair = tev.add(pt_t, t["ca"]), jev.add(pt_j, j["ca"])
    assert_ct_equal(*pair)


CONST = [("add_const", 0.25), ("add_const", 1.5 - 0.5j), ("mult_by_const", 3),
         ("mult_by_const", 0.5), ("mult_by_const", 0.5 + 2j), ("mult_by_i", None),
         ("div_by_i", None), ("scale_up", float(1 << 10)), ("mul_by_pow2", 5),
         ("mult_by_const_and_add", 0.75j)]


@pytest.mark.parametrize("op,arg", CONST)
def test_constant_ops_equal(world, op, arg):
    t, j = world["t"], world["j"]
    if op == "mult_by_const_and_add":
        tct = t["ev"].mult_by_const_and_add(t["ca"], arg, t["cb"])
        jct = j["ev"].mult_by_const_and_add(j["ca"], arg, j["cb"])
    else:
        args = () if arg is None else (arg,)
        tct, jct = getattr(t["ev"], op)(t["ca"], *args), getattr(j["ev"], op)(j["ca"], *args)
    assert_ct_equal(tct, jct)


def test_mult_by_const_decrypts(world):
    t = world["t"]
    out = t["ev"].rescale(t["ev"].mult_by_const(t["ca"], 0.5 + 2j))
    assert median_bits(roundtrip(t, out), world["va"] * (0.5 + 2j)) >= MIN_PREC


@pytest.fixture(scope="module")
def products(world):
    t, j = world["t"], world["j"]
    return dict(t=t["ev"].mul_relin(t["ca"], t["cb"]), j=j["ev"].mul_relin(j["ca"], j["cb"]))


def test_mul_relin_degree2_and_relinearize_equal(world, products):
    t, j = world["t"], world["j"]
    assert products["t"].degree == 2
    assert_ct_equal(products["t"], products["j"])
    rel = t["ev"].relinearize(products["t"], t["rlk"])
    assert_ct_equal(rel, j["ev"].relinearize(products["j"], j["rlk"]))
    want = world["va"] * world["vb"]
    assert median_bits(roundtrip(t, t["ev"].rescale(rel)), want) >= MIN_PREC
    # a degree-2 ciphertext decrypts too (Horner over the degree)
    assert median_bits(roundtrip(t, t["ev"].rescale(products["t"])), want) >= MIN_PREC


def test_mul_plain_equal(world):
    t, j = world["t"], world["j"]
    tct = t["ev"].mul_relin(t["ca"], t["enc"].encode(world["vb"]))
    assert_ct_equal(tct, j["ev"].mul_relin(j["ca"], j["enc"].encode(world["vb"])))
    assert median_bits(roundtrip(t, t["ev"].rescale(tct)), world["va"] * world["vb"]) >= MIN_PREC


def test_rescale_many_equal(world):
    t, j = world["t"], world["j"]
    assert_ct_equal(t["ev"].rescale_many(t["ca"], 2), j["ev"].rescale_many(j["ca"], 2))


def test_switch_keys_equal_and_decrypts(world):
    t, j = world["t"], world["j"]
    tsw = t["ev"].switch_keys(t["ca"], t["swk"])
    assert_ct_equal(tsw, j["ev"].switch_keys(j["ca"], j["swk"]))
    assert median_bits(roundtrip(t, tsw, "dec2"), world["va"]) >= MIN_PREC


@pytest.mark.parametrize("k", [1, 3, SLOTS - 1])
def test_rotate_columns_equal_and_decrypts(world, k):
    """k = 1: its own key; 3: left keys 1 + 2; SLOTS - 1: the right key 1."""
    t, j = world["t"], world["j"]
    tct = t["ev"].rotate_columns(t["ca"], k, t["rot"])
    assert_ct_equal(tct, j["ev"].rotate_columns(j["ca"], k, j["rot"]))
    assert median_bits(roundtrip(t, tct), np.roll(world["va"], -k)) >= MIN_PREC


def test_conjugate_equal_and_decrypts(world):
    t, j = world["t"], world["j"]
    tct = t["ev"].conjugate(t["ca"], t["rot"])
    assert_ct_equal(tct, j["ev"].conjugate(j["ca"], j["rot"]))
    assert median_bits(roundtrip(t, tct), np.conj(world["va"])) >= MIN_PREC


@pytest.fixture(scope="module")
def eight_rotations(world):
    """Left keys 1..7 in both packages (the world's 1 and 2, and 3..7 made
    here) and the JAX package's ``rotate_hoisted`` of ``ca`` by 0..7."""
    t, j = world["t"], world["j"]
    rot = tckks.RotationKeys(left=dict(t["rot"].left))
    kgen = tckks.KeyGenerator(TP, device="cpu", seed=3)
    for k in range(3, 8):
        kgen.gen_rot("left", t["sk"], k, rot)
    left, _, _ = convert.rotation_keys_to_numpy(rot)
    jrot = jckks.RotationKeys({r: jckks.SwitchingKey(ju.from_u64(k0), ju.from_u64(k1))
                               for r, (k0, k1) in left.items()}, {}, None)
    return rot, j["ev"].rotate_hoisted(j["ca"], list(range(8)), jrot)


@pytest.mark.parametrize("rotations,rows,chunks", [
    ([0, 1, 2], None, 1),
    (list(range(8)), 24, 3),  # 8 rows a rotation: 3 rotations a ModDown
    (list(range(8)), None, 1),
], ids=["0-2", "0-7_three_chunks", "0-7_one_chunk"])
def test_rotate_hoisted_equal(world, request, monkeypatch, rotations, rows, chunks):
    """Bit for bit against the JAX package's ``rotate_hoisted``, however
    many stacked ModDowns the rotations take."""
    t, j = world["t"], world["j"]
    if len(rotations) == 3:
        rot = t["rot"]
        jout = j["ev"].rotate_hoisted(j["ca"], rotations, j["rot"])
    else:
        rot, jout = request.getfixturevalue("eight_rotations")
    if rows is not None:
        monkeypatch.setattr(tckks.evaluator, "HOISTED_MOD_DOWN_ROWS", rows)
    before = profiling.counters()
    tout = t["ev"].rotate_hoisted(t["ca"], rotations, rot)
    after = profiling.counters()
    assert sorted(tout) == sorted(jout) == rotations
    for k in tout:
        assert_ct_equal(tout[k], jout[k])
    for name, want in (("ckks.hoisted.mod_downs", chunks),
                       ("ckks.hoisted.rotations", len(rotations) - 1)):
        assert after.get(name, 0) - before.get(name, 0) == want, name
    assert median_bits(roundtrip(t, tout[2]), np.roll(world["va"], -2)) >= MIN_PREC


# -- the slice as a whole ------------------------------------------------------


@pytest.fixture(scope="module")
def jax_slice(world):
    j = world["j"]
    ev = j["ev"]
    out = ev.rescale(ev.mul_relin(j["ca"], j["cb"], j["rlk"]))
    rot = ev.rotate_columns(out, 1, j["rot"])
    return out, rot, ev.conjugate(rot, j["rot"])


@pytest.mark.parametrize("force", [None, "passes"])
def test_slice_equal_and_decrypts(world, jax_slice, force, monkeypatch):
    """rescale(mul_relin) -> rotate_columns(1) -> conjugate, bit for bit;
    with FORCE_KERNEL = "passes" every transform goes through the long-row
    kernel's plain version."""
    monkeypatch.setattr(tring_mod, "FORCE_KERNEL", force)
    t = world["t"]
    ev = t["ev"]
    out = ev.rescale(ev.mul_relin(t["ca"], t["cb"], t["rlk"]))
    rot = ev.rotate_columns(out, 1, t["rot"])
    conj = ev.conjugate(rot, t["rot"])
    for tct, jct in zip((out, rot, conj), jax_slice):
        assert_ct_equal(tct, jct)
    want = world["va"] * world["vb"]
    assert out.level == TP.max_level - 1
    assert median_bits(roundtrip(t, out), want) >= MIN_PREC
    assert median_bits(roundtrip(t, rot), np.roll(want, -1)) >= MIN_PREC
    assert median_bits(roundtrip(t, conj), np.conj(np.roll(want, -1))) >= MIN_PREC


@pytest.mark.parametrize("path", ["pk", "sk", "pk_fast", "sk_fast", "sparse"])
def test_port_keys_and_encryption_decrypt(path):
    """Keys, encryption and evaluation all by the port, at a set whose key
    switch decomposes blocks of two limbs (alpha = 2)."""
    params = tckks.Parameters(log_n=8, log_slots=7, scale=float(1 << 32),
                              log_qi=(45, 32, 32, 32), log_pi=(45, 45)).gen_from_log_moduli()
    kgen = tckks.KeyGenerator(params, device="cpu", seed=5)
    sk, pk = kgen.gen_key_pair_sparse(16) if path == "sparse" else kgen.gen_key_pair()
    enc, ev = tckks.Encoder(params, device="cpu"), tckks.Evaluator(params, device="cpu")
    key = dict(sk=sk) if path.startswith("sk") else dict(pk=pk)
    encryptor = tckks.Encryptor(params, device="cpu", seed=6, **key)
    dec = tckks.Decryptor(params, sk, device="cpu")
    rng = np.random.default_rng(12)
    a, b = rand_values(rng), rand_values(rng)
    fast = path.endswith("fast")
    ca, cb = (encryptor.encrypt(enc.encode(v), fast=fast) for v in (a, b))
    assert not torch.equal(ca.value[1], cb.value[1])  # fresh randomness per encryption
    assert median_bits(enc.decode(dec.decrypt(ca)), a) >= MIN_PREC
    out = ev.rescale(ev.mul_relin(ca, cb, kgen.gen_relin_key(sk)))
    assert median_bits(enc.decode(dec.decrypt(out)), a * b) >= MIN_PREC
    rk = kgen.gen_rotation_keys_pow2(sk)
    assert sorted(rk.left) == sorted(rk.right) == [1, 2, 4, 8, 16, 32, 64]
    rot = ev.rotate_columns(out, 5, rk)
    assert median_bits(enc.decode(dec.decrypt(rot)), np.roll(a * b, -5)) >= MIN_PREC


def test_entry_points_default_to_cuda():
    """device=None means the GPU: without one every entry point raises."""
    makers = [
        lambda: tckks.get_context(TP),
        lambda: tckks.KeyGenerator(TP),
        lambda: tckks.Encoder(TP),
        lambda: tckks.Encryptor(TP, sk=object()),
        lambda: tckks.Decryptor(TP, object()),
        lambda: tckks.Evaluator(TP),
        lambda: entry_ckks(params_idx=tckks.PN12QP109),
        lambda: entry_dckks_sigmoid(),
    ]
    for make in makers:
        if torch.cuda.is_available():
            make()
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make()


def test_entry_ckks_on_cpu():
    """entry_ckks end to end on the CPU at PN12QP109 with two stacked pairs:
    precision of the product, and every NTT route gives the same bits."""
    forward, (ct0, ct1, rlk) = entry_ckks(device="cpu", params_idx=tckks.PN12QP109, batch=(2,))
    out = forward(ct0, ct1, rlk)
    params = tckks.default_params(tckks.PN12QP109)
    got = tckks.Encoder(params, device="cpu").decode(
        tckks.Decryptor(params, forward.secret_key, device="cpu").decrypt(out))
    v0, v1 = forward.values
    assert got.shape == (2, params.slots)
    for row in got:
        assert median_bits(row, v0 * v1) >= MIN_PREC
    tring_mod.FORCE_KERNEL = "plain"
    try:
        ref = forward(ct0, ct1, rlk)
    finally:
        tring_mod.FORCE_KERNEL = None
    assert all(torch.equal(a, b) for a, b in zip(out.value, ref.value))
