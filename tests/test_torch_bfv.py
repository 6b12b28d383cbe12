"""The BFV slice of the port against the JAX package.

Keys and ciphertexts are made by the JAX package, carried across as uint64
arrays (lattigo_tpu_torch.convert) and the same deterministic op runs in
both packages: outputs are equal bit for bit (integers, tolerance 0).  The
samplers cannot reproduce jax.random bits, so key generation and encryption
are held by exact decryption and by distribution instead.
"""

import jax
import numpy as np
import pytest
import torch

from lattigo_tpu.models import bfv as jbfv
from lattigo_tpu.ops import number_theory as nt
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu_torch import convert
from lattigo_tpu_torch.entry import entry
from lattigo_tpu_torch.models import bfv as tbfv
from lattigo_tpu_torch.ops import samplers
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.ops.ring import Ring as TRing

torch.set_num_threads(1)

SPEC = dict(log_n=8, t=65537, log_qi=(46, 46), log_pi=(47,), log_qi_mul=(60, 60))
JP = jbfv.Parameters(**SPEC).gen_from_log_moduli()
TP = tbfv.Parameters(**SPEC).gen_from_log_moduli()
N, T_MOD = JP.n, JP.t


def np_polys(ct):
    return [ju.to_u64(p) for p in ct.value]


def assert_ct_equal(tct, jct):
    assert len(tct.value) == len(jct.value)
    for a, b in zip(convert.ciphertext_to_numpy(tct), np_polys(jct)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def world():
    """JAX-made keys and ciphertexts, and their carried-across twins."""
    kgen = jbfv.KeyGenerator(JP)
    sk, pk = kgen.gen_key_pair()
    rlk = kgen.gen_relin_key(sk, 1)
    sk2 = kgen.gen_secret_key()
    swk = kgen.gen_switching_key(sk, sk2)
    enc = jbfv.Encoder(JP)
    encryptor = jbfv.Encryptor(JP, pk=pk)
    rng = np.random.default_rng(0)
    ma = rng.integers(0, T_MOD, N, dtype=np.uint64)
    mb = rng.integers(0, T_MOD, N, dtype=np.uint64)
    ca, cb = encryptor.encrypt(enc.encode_uint(ma)), encryptor.encrypt(enc.encode_uint(mb))
    j = dict(sk=sk, sk2=sk2, rlk=rlk, swk=swk, ca=ca, cb=cb, enc=enc,
             ev=jbfv.Evaluator(JP), dec=jbfv.Decryptor(JP, sk), dec2=jbfv.Decryptor(JP, sk2))

    def carry_swk(k):
        return convert.switching_key_from_numpy(ju.to_u64(k.key0), ju.to_u64(k.key1), "cpu")

    t = dict(
        sk=convert.secret_key_from_numpy(ju.to_u64(sk.sk), "cpu"),
        sk2=convert.secret_key_from_numpy(ju.to_u64(sk2.sk), "cpu"),
        pk=convert.public_key_from_numpy(ju.to_u64(pk.pk[0]), ju.to_u64(pk.pk[1]), "cpu"),
        rlk=tbfv.EvaluationKey([carry_swk(rlk.evakey[0])]),
        swk=carry_swk(swk),
        ca=convert.ciphertext_from_numpy(np_polys(ca), "cpu"),
        cb=convert.ciphertext_from_numpy(np_polys(cb), "cpu"),
        enc=tbfv.Encoder(TP, device="cpu"),
        ev=tbfv.Evaluator(TP, device="cpu"),
    )
    t["dec"] = tbfv.Decryptor(TP, t["sk"], device="cpu")
    t["dec2"] = tbfv.Decryptor(TP, t["sk2"], device="cpu")
    return dict(j=j, t=t, ma=ma, mb=mb)


def test_parameters_agree():
    assert (TP.qi, TP.pi, TP.qi_mul) == (JP.qi, JP.pi, JP.qi_mul)
    for idx in (tbfv.PN12QP109, tbfv.PN13QP218, tbfv.PN14QP438):
        a, b = tbfv.default_params(idx), jbfv.default_params(idx)
        assert (a.n, a.t, a.qi, a.pi, a.qi_mul, a.beta) == (b.n, b.t, b.qi, b.pi, b.qi_mul, b.beta)


def test_convert_roundtrip(world):
    j, t = world["j"], world["t"]
    np.testing.assert_array_equal(convert.secret_key_to_numpy(t["sk"]), ju.to_u64(j["sk"].sk))
    k0, k1 = convert.switching_key_to_numpy(t["swk"])
    np.testing.assert_array_equal(k0, ju.to_u64(j["swk"].key0))
    np.testing.assert_array_equal(k1, ju.to_u64(j["swk"].key1))
    p0, p1 = convert.public_key_to_numpy(t["pk"])
    assert p0.dtype == np.uint64 and p0.shape == (3, N) and p1.shape == (3, N)
    assert_ct_equal(t["ca"], j["ca"])
    x = np.array([[0, 1, (1 << 63) + 7, (1 << 64) - 1]], dtype=np.uint64)
    np.testing.assert_array_equal(convert.poly_to_numpy(convert.poly_from_numpy(x, "cpu")), x)


def test_encode_equal(world):
    j, t = world["j"], world["t"]
    m = world["ma"]
    np.testing.assert_array_equal(tu.to_u64(t["enc"].encode_uint(m).value),
                                  ju.to_u64(j["enc"].encode_uint(m).value))
    ms = (m.astype(np.int64) % 1000) - 500
    np.testing.assert_array_equal(tu.to_u64(t["enc"].encode_int(ms).value),
                                  ju.to_u64(j["enc"].encode_int(ms).value))
    np.testing.assert_array_equal(t["enc"].decode_int(t["enc"].encode_int(ms)), ms)
    np.testing.assert_array_equal(t["enc"].decode_uint(t["enc"].encode_uint(m[: N // 2])),
                                  np.concatenate([m[: N // 2], np.zeros(N // 2, np.uint64)]))


def test_decrypt_decode_equal(world):
    j, t = world["j"], world["t"]
    tpt, jpt = t["dec"].decrypt(t["ca"]), j["dec"].decrypt(j["ca"])
    np.testing.assert_array_equal(tu.to_u64(tpt.value), ju.to_u64(jpt.value))
    got = t["enc"].decode_uint(tpt)
    np.testing.assert_array_equal(got, j["enc"].decode_uint(jpt))
    np.testing.assert_array_equal(got, world["ma"])


@pytest.mark.parametrize("op", ["add", "sub", "neg", "reduce", "mul_scalar", "add_plain", "sub_mixed_degree"])
def test_linear_ops_equal(world, op):
    j, t = world["j"], world["t"]
    if op in ("add", "sub"):
        tct, jct = getattr(t["ev"], op)(t["ca"], t["cb"]), getattr(j["ev"], op)(j["ca"], j["cb"])
    elif op in ("neg", "reduce"):
        tct, jct = getattr(t["ev"], op)(t["ca"]), getattr(j["ev"], op)(j["ca"])
    elif op == "mul_scalar":
        tct, jct = t["ev"].mul_scalar(t["ca"], 12345), j["ev"].mul_scalar(j["ca"], 12345)
    elif op == "add_plain":
        tct = t["ev"].add(t["ca"], t["enc"].encode_uint(world["mb"]))
        jct = j["ev"].add(j["ca"], j["enc"].encode_uint(world["mb"]))
    else:  # a plaintext minus a ciphertext: the copied tail is negated
        tct = t["ev"].sub(t["enc"].encode_uint(world["mb"]), t["ca"])
        jct = j["ev"].sub(j["enc"].encode_uint(world["mb"]), j["ca"])
    assert_ct_equal(tct, jct)


@pytest.fixture(scope="module")
def products(world):
    j, t = world["j"], world["t"]
    jmul = jax.jit(lambda a, b: j["ev"].mul(a, b))(j["ca"], j["cb"])
    return dict(jmul=jmul, tmul=t["ev"].mul(t["ca"], t["cb"]))


def test_mul_equal(world, products):
    assert products["tmul"].degree == 2
    assert_ct_equal(products["tmul"], products["jmul"])


def test_relinearize_equal_and_decrypts(world, products):
    j, t = world["j"], world["t"]
    jrel = jax.jit(lambda c, k: j["ev"].relinearize(c, k))(products["jmul"], j["rlk"])
    trel = t["ev"].relinearize(products["tmul"], t["rlk"])
    assert trel.degree == 1
    assert_ct_equal(trel, jrel)
    want = world["ma"] * world["mb"] % np.uint64(T_MOD)
    np.testing.assert_array_equal(t["enc"].decode_uint(t["dec"].decrypt(trel)), want)
    # a degree-2 ciphertext decrypts too (Horner over the degree)
    np.testing.assert_array_equal(t["enc"].decode_uint(t["dec"].decrypt(products["tmul"])), want)


def test_square_equal(world):
    j, t = world["j"], world["t"]
    jsq = jax.jit(lambda a: j["ev"].mul(a, a))(j["ca"])
    assert_ct_equal(t["ev"].mul(t["ca"], t["ca"]), jsq)


def test_switch_keys_equal_and_decrypts(world):
    j, t = world["j"], world["t"]
    jsw = jax.jit(lambda c, k: j["ev"].switch_keys(c, k))(j["ca"], j["swk"])
    tsw = t["ev"].switch_keys(t["ca"], t["swk"])
    assert_ct_equal(tsw, jsw)
    np.testing.assert_array_equal(t["enc"].decode_uint(t["dec2"].decrypt(tsw)), world["ma"])


def test_stacked_ciphertexts_broadcast(world):
    """Leading dims stack ciphertexts: the stacked forward equals the single ones."""
    t = world["t"]
    stack = lambda a, b: tbfv.Ciphertext([torch.stack([x, y]) for x, y in zip(a.value, b.value)])
    both = t["ev"].relinearize(t["ev"].mul(stack(t["ca"], t["cb"]), stack(t["cb"], t["cb"])), t["rlk"])
    one = t["ev"].relinearize(t["ev"].mul(t["ca"], t["cb"]), t["rlk"])
    two = t["ev"].relinearize(t["ev"].mul(t["cb"], t["cb"]), t["rlk"])
    for k in range(2):
        assert torch.equal(both.value[k][0], one.value[k])
        assert torch.equal(both.value[k][1], two.value[k])
    got = t["enc"].decode_uint(t["dec"].decrypt(both))
    assert got.shape == (2, N)
    np.testing.assert_array_equal(got[1], world["mb"] * world["mb"] % np.uint64(T_MOD))


@pytest.mark.parametrize("path", ["pk", "sk", "pk_fast", "sk_fast"])
def test_port_only_roundtrip(path):
    """Keys, encryption and evaluation all by the port: exact decryption."""
    kgen = tbfv.KeyGenerator(TP, device="cpu", seed=3)
    sk, pk = kgen.gen_key_pair()
    rlk = kgen.gen_relin_key(sk, 1)
    enc = tbfv.Encoder(TP, device="cpu")
    key = dict(pk=pk) if path.startswith("pk") else dict(sk=sk)
    encryptor = tbfv.Encryptor(TP, device="cpu", seed=4, **key)
    dec = tbfv.Decryptor(TP, sk, device="cpu")
    ev = tbfv.Evaluator(TP, device="cpu")
    rng = np.random.default_rng(11)
    a = rng.integers(0, T_MOD, N, dtype=np.uint64)
    b = rng.integers(0, T_MOD, N, dtype=np.uint64)
    fast = path.endswith("fast")
    ca, cb = encryptor.encrypt(enc.encode_uint(a), fast=fast), encryptor.encrypt(enc.encode_uint(b), fast=fast)
    assert not torch.equal(ca.value[1], cb.value[1])  # fresh randomness per encryption
    np.testing.assert_array_equal(enc.decode_uint(dec.decrypt(ca)), a)
    np.testing.assert_array_equal(enc.decode_uint(dec.decrypt(ev.add(ca, cb))), (a + b) % np.uint64(T_MOD))
    out = ev.relinearize(ev.mul(ca, cb), rlk)
    np.testing.assert_array_equal(enc.decode_uint(dec.decrypt(out)), a * b % np.uint64(T_MOD))
    sk2 = kgen.gen_secret_key()
    sw = ev.switch_keys(ca, kgen.gen_switching_key(sk, sk2))
    np.testing.assert_array_equal(enc.decode_uint(tbfv.Decryptor(TP, sk2, device="cpu").decrypt(sw)), a)


# -- sampler distributions (as tests/test_ring_ops.py holds the JAX package's) --


def _gen(seed):
    return samplers.make_generator(torch.device("cpu"), seed)


def test_uniform_sampler():
    ring = TRing(256, list(JP.qi) + list(JP.pi), device="cpu")
    x = tu.to_u64(samplers.uniform_poly(_gen(0), ring, batch=(4,)))
    for i, q in enumerate(ring.moduli):
        assert (x[:, i] < q).all()
        assert x[:, i].max() > q // 2  # uses the whole range
    assert len(np.unique(x)) > 256


def test_gaussian_sampler():
    big = TRing(2048, nt.generate_ntt_primes(55, 11, 2), device="cpu")
    x = tu.to_u64(samplers.gaussian_poly(_gen(1), big))
    q0, q1 = big.moduli
    signed = np.where(x[0] > q0 // 2, x[0].astype(np.int64) - q0, x[0].astype(np.int64))
    signed1 = np.where(x[1] > q1 // 2, x[1].astype(np.int64) - q1, x[1].astype(np.int64))
    np.testing.assert_array_equal(signed, signed1)  # one draw mapped into every limb
    assert (np.abs(signed) < 19).all()
    assert 2.6 < signed.std() < 3.8  # sigma = 3.2
    assert abs(signed.mean()) < 0.5


def test_ternary_sampler():
    big = TRing(2048, nt.generate_ntt_primes(55, 11, 2), device="cpu")
    x = tu.to_u64(samplers.ternary_poly(_gen(2), big, p=0.5))
    q0 = big.moduli[0]
    assert set(np.unique(x[0]).tolist()) <= {0, 1, q0 - 1}
    assert 0.4 < (x[0] == 0).mean() < 0.6
    nz = x[0][x[0] != 0]
    assert 0.4 < (nz == 1).mean() < 0.6
    xm = tu.to_u64(samplers.ternary_poly(_gen(2), big, p=0.5, montgomery=True))
    assert set(np.unique(xm[0]).tolist()) <= {0, nt.mform(1, q0), nt.mform(q0 - 1, q0)}
    third = tu.to_u64(samplers.ternary_poly(_gen(3), big, p=1.0 / 3.0))
    assert 0.27 < (third[0] == 0).mean() < 0.40


def test_samplers_are_seeded():
    ring = TRing(256, list(JP.qi), device="cpu")
    a = samplers.uniform_poly(_gen(5), ring)
    assert torch.equal(a, samplers.uniform_poly(_gen(5), ring))
    assert not torch.equal(a, samplers.uniform_poly(_gen(6), ring))


def test_entry_points_default_to_cuda():
    """device=None means the GPU: without one every entry point raises, and
    nothing carries on silently on the CPU."""
    makers = [
        lambda: tbfv.get_context(TP),
        lambda: tbfv.KeyGenerator(TP),
        lambda: tbfv.Encoder(TP),
        lambda: tbfv.Encryptor(TP, sk=object()),
        lambda: tbfv.Decryptor(TP, object()),
        lambda: tbfv.Evaluator(TP),
        lambda: entry(),
    ]
    for make in makers:
        if torch.cuda.is_available():
            make()
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make()


# -- the slice as a whole ----------------------------------------------------


def test_entry_forward_small_batch_on_cpu():
    """The port's entry() end to end on the CPU at PN12QP109, with two
    stacked pairs: exact decryption, and every NTT route gives the same bits."""
    from lattigo_tpu_torch.ops import ring as tring_mod

    forward, (ct0, ct1, swk) = entry(device="cpu", batch=(2,))
    out = forward(ct0, ct1, swk)
    params = tbfv.default_params(tbfv.PN12QP109)
    got = tbfv.Encoder(params, device="cpu").decode_uint(
        tbfv.Decryptor(params, forward.secret_key, device="cpu").decrypt(out))
    m = np.arange(params.n, dtype=np.uint64) % params.t
    np.testing.assert_array_equal(got, np.broadcast_to(m * m[::-1] % np.uint64(params.t), (2, params.n)))
    tring_mod.FORCE_KERNEL = "plain"
    try:
        ref = forward(ct0, ct1, swk)
    finally:
        tring_mod.FORCE_KERNEL = None
    assert all(torch.equal(a, b) for a, b in zip(out.value, ref.value))


@pytest.mark.slow
def test_entry_forward_equals_jax_entry_pn12qp109():
    """The slice-level hold: the JAX package's entry() inputs at PN12QP109,
    carried across, through the port's forward give the JAX forward's
    ciphertext bit for bit.  Slow: the JAX side alone takes minutes on a CPU."""
    import __graft_entry__ as graft

    jforward, (jct0, jct1, jswk) = graft.entry()
    jout = jforward(jct0, jct1, jswk)
    forward, _ = entry(device="cpu")
    out = forward(
        convert.ciphertext_from_numpy(np_polys(jct0), "cpu"),
        convert.ciphertext_from_numpy(np_polys(jct1), "cpu"),
        convert.switching_key_from_numpy(ju.to_u64(jswk.key0), ju.to_u64(jswk.key1), "cpu"),
    )
    assert_ct_equal(out, jout)
