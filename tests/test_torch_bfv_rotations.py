"""BFV rotations of the port against the JAX package's.

Keys and ciphertexts made by the JAX package are carried across
(lattigo_tpu_torch.convert); ``rotate_columns`` (a direct key, the
power-of-two path to the left and to the right), ``rotate_rows`` and
``inner_sum`` must then equal the JAX evaluator's outputs bit for bit
(integers, tolerance 0), on one ciphertext and on a stack of 4.  The port's
own rotation keys must decrypt to the rotated slots exactly.
"""

import jax
import numpy as np
import pytest
import torch

from lattigo_tpu.models import bfv as jbfv
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu_torch import convert
from lattigo_tpu_torch.models import bfv as tbfv

torch.set_num_threads(1)

SPEC = dict(log_n=8, t=65537, log_qi=(46, 46), log_pi=(47,), log_qi_mul=(60, 60))
JP = jbfv.Parameters(**SPEC).gen_from_log_moduli()
TP = tbfv.Parameters(**SPEC).gen_from_log_moduli()
N, T_MOD = JP.n, JP.t
ROW = N // 2
STACK = 4


def np_polys(ct):
    return [ju.to_u64(p) for p in ct.value]


def rotated(m, k):
    """Slots of each row rotated left by k."""
    return np.concatenate([np.roll(m[..., :ROW], -k, axis=-1), np.roll(m[..., ROW:], -k, axis=-1)],
                          axis=-1)


def swapped(m):
    return np.concatenate([m[..., ROW:], m[..., :ROW]], axis=-1)


def summed(m):
    total = np.asarray(m.astype(object).sum(axis=-1) % T_MOD, dtype=np.uint64)
    return np.broadcast_to(total[..., None], m.shape)


# rotate by k: a direct key (3), the power-of-two path to the left (5 = 4 + 1)
# and to the right (N/2 - 1 = 127: one step right with the key of 1)
OPS = {
    "direct_3": (lambda ev, ct, rk: ev.rotate_columns(ct, 3, rk), lambda m: rotated(m, 3)),
    "pow2_left_5": (lambda ev, ct, rk: ev.rotate_columns(ct, 5, rk), lambda m: rotated(m, 5)),
    "pow2_right_127": (lambda ev, ct, rk: ev.rotate_columns(ct, ROW - 1, rk),
                       lambda m: rotated(m, ROW - 1)),
    "rows": (lambda ev, ct, rk: ev.rotate_rows(ct, rk), swapped),
    "inner_sum": (lambda ev, ct, rk: ev.inner_sum(ct, rk), summed),
}


@pytest.fixture(scope="module")
def world():
    kgen = jbfv.KeyGenerator(JP, rng_key=jax.random.key(5))
    sk = kgen.gen_secret_key()
    rk = jbfv.RotationKeys()  # the keys OPS use: pow2 left, 3 left, 1 right, rows
    for k in (1, 2, 4, 8, 16, 32, 64, 3):
        kgen.gen_rot("left", sk, k, rk)
    kgen.gen_rot("right", sk, 1, rk)
    kgen.gen_rot("row", sk, 0, rk)
    enc = jbfv.Encoder(JP)
    encryptor = jbfv.Encryptor(JP, sk=sk)
    rng = np.random.default_rng(1)
    msgs = rng.integers(0, T_MOD, (STACK, N), dtype=np.uint64)
    cts = [encryptor.encrypt(enc.encode_uint(m)) for m in msgs]
    stack = [np.stack(polys) for polys in zip(*[np_polys(c) for c in cts])]
    carry = lambda k: (ju.to_u64(k.key0), ju.to_u64(k.key1))
    t_rk = convert.bfv_rotation_keys_from_numpy(
        {r: carry(k) for r, k in rk.left.items()}, {r: carry(k) for r, k in rk.right.items()},
        carry(rk.row), "cpu")
    t_sk = convert.secret_key_from_numpy(ju.to_u64(sk.sk), "cpu")
    return dict(j_ev=jbfv.Evaluator(JP), j_rk=rk, msgs=msgs, j_cts=cts,
                t_ev=tbfv.Evaluator(TP, device="cpu"), t_rk=t_rk, t_sk=t_sk,
                t_ct={"single": convert.ciphertext_from_numpy(np_polys(cts[0]), "cpu"),
                      "stack": convert.ciphertext_from_numpy(stack, "cpu")})


def test_rotation_keys_round_trip(world):
    left, right, row = convert.bfv_rotation_keys_to_numpy(world["t_rk"])
    rk = world["j_rk"]
    assert sorted(left) == sorted(rk.left) and sorted(right) == sorted(rk.right)
    np.testing.assert_array_equal(left[3][0], ju.to_u64(rk.left[3].key0))
    np.testing.assert_array_equal(row[1], ju.to_u64(rk.row.key1))


@pytest.mark.parametrize("shape", ["single", "stack"])
@pytest.mark.parametrize("op", list(OPS))
def test_rotation_matches_jax(world, op, shape):
    """The stack of 4 runs as one batched call in the port; each of its rows
    must equal the JAX evaluator's output on that ciphertext alone."""
    fn, slots = OPS[op]
    got = fn(world["t_ev"], world["t_ct"][shape], world["t_rk"])
    assert len(got.value) == 2
    got_np = convert.ciphertext_to_numpy(got)
    rows = [None] if shape == "single" else range(STACK)
    for i in rows:
        want = np_polys(fn(world["j_ev"], world["j_cts"][i or 0], world["j_rk"]))
        for a, b in zip(got_np, want):
            np.testing.assert_array_equal(a if i is None else a[i], b)
    # and the slots moved as they should
    enc, dec = tbfv.Encoder(TP, device="cpu"), tbfv.Decryptor(TP, world["t_sk"], device="cpu")
    m = world["msgs"][0] if shape == "single" else world["msgs"]
    np.testing.assert_array_equal(enc.decode_uint(dec.decrypt(got)), slots(m))


@pytest.fixture(scope="module")
def own_keys():
    """Keys, rotation keys and a stack of 2 ciphertexts made by the port."""
    kgen = tbfv.KeyGenerator(TP, device="cpu", seed=11)
    sk = kgen.gen_secret_key()
    rk = kgen.gen_rotation_keys_pow2(sk)
    kgen.gen_rot("left", sk, 3, rk)
    kgen.gen_rot("left", sk, 0, rk)  # no key for a rotation by 0
    enc = tbfv.Encoder(TP, device="cpu")
    encryptor = tbfv.Encryptor(TP, sk=sk, device="cpu", seed=12)
    msgs = np.random.default_rng(2).integers(0, T_MOD, (2, N), dtype=np.uint64)
    cts = [encryptor.encrypt(enc.encode_uint(m)) for m in msgs]
    ct = tbfv.Ciphertext([torch.stack([c.value[k] for c in cts]) for k in range(2)])
    return dict(sk=sk, rk=rk, ct=ct, msgs=msgs, enc=enc,
                ev=tbfv.Evaluator(TP, device="cpu"), dec=tbfv.Decryptor(TP, sk, device="cpu"))


@pytest.mark.parametrize("op", list(OPS))
def test_own_rotation_keys_decrypt_exactly(own_keys, op):
    fn, slots = OPS[op]
    w = own_keys
    assert 0 not in w["rk"].left and len(w["rk"].left) == 8 and len(w["rk"].right) == 7
    got = w["enc"].decode_uint(w["dec"].decrypt(fn(w["ev"], w["ct"], w["rk"])))
    np.testing.assert_array_equal(got, slots(w["msgs"]))


def test_gen_rot_each_kind(own_keys):
    """gen_rot adds one key of each kind; a missing power-of-two key is named."""
    w = own_keys
    kgen = tbfv.KeyGenerator(TP, device="cpu", seed=13)
    rk = tbfv.RotationKeys()
    kgen.gen_rot("right", w["sk"], 2, rk)
    kgen.gen_rot("row", w["sk"], 0, rk)
    assert list(rk.right) == [2] and rk.row is not None and not rk.left
    got = w["enc"].decode_uint(w["dec"].decrypt(w["ev"].rotate_rows(w["ct"], rk)))
    np.testing.assert_array_equal(got, swapped(w["msgs"]))
    with pytest.raises(ValueError, match="pow2 rotation key 1"):
        w["ev"].rotate_columns(w["ct"], 5, rk)
    with pytest.raises(ValueError):
        kgen.gen_rot("diagonal", w["sk"], 1, rk)


def test_sparse_secret_key():
    kgen = tbfv.KeyGenerator(TP, device="cpu", seed=14)
    sk = kgen.gen_secret_key_sparse(hw=16)
    ring = kgen.ctx.ring_qp
    coeffs = np.array(ring.poly_to_bigint(ring.intt(ring.inv_mform(sk.sk))), dtype=object)
    big_q = ring.modulus_bigint
    centred = np.where(coeffs > big_q // 2, coeffs - big_q, coeffs)
    assert set(centred.tolist()) <= {-1, 0, 1} and int((centred != 0).sum()) == 16
