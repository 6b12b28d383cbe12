"""The port's byte codecs against the JAX package's.

Every codec of ``lattigo_tpu_torch.utils.serialization`` gets the same
object as its JAX twin (numpy-seeded uint64 arrays, carried across as int64
tensors) and must give the same bytes; its ``*_from_bytes`` must give back
the carried tensors from the JAX package's bytes; and round trips hold on
the share shapes of the dCKKS protocols (a refresh share with h0 below the
top level, β-stacked relinearization shares, PCKS pairs).
"""

import struct

import numpy as np
import pytest
import torch

from lattigo_tpu.models import bfv as jbfv
from lattigo_tpu.models import ckks as jckks
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu.utils import serialization as jser
from lattigo_tpu_torch.models import bfv as tbfv
from lattigo_tpu_torch.models import ckks as tckks
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.utils import serialization as tser

torch.set_num_threads(1)

LOG_N = 5
N = 1 << LOG_N
MODULI = [0x1FFFFFFFFFE00001, 0xFFFFFFF00001, 97, 2**61 - 1, 113]
CPU = "cpu"


def arr(seed, shape):
    """uint64 residues [..., L, N] below the first L moduli."""
    rng = np.random.default_rng(seed)
    L = shape[-2]
    out = np.empty(shape, dtype=np.uint64)
    for i in range(L):
        out[..., i, :] = rng.integers(0, MODULI[i], size=(*shape[:-2], N), dtype=np.uint64)
    return out


def pair(a):
    """The same residues as a port tensor and a JAX U64."""
    return tu.from_u64(a, CPU), ju.from_u64(a)


def same(t, a):
    """A port tensor holds exactly the uint64 array ``a``."""
    assert t.dtype == torch.int64 and t.device.type == CPU
    np.testing.assert_array_equal(tu.to_u64(t), a)


# -- polys, ciphertexts, keys, parameters --------------------------------------


@pytest.mark.parametrize("limbs", [1, 3, 5])
def test_poly(limbs):
    a = arr(limbs, (limbs, N))
    t, j = pair(a)
    data = tser.poly_to_bytes(t)
    assert data == jser.poly_to_bytes(j)
    assert data[:2] == bytes([LOG_N, limbs]) and len(data) == 2 + 8 * limbs * N
    back, used = tser.poly_from_bytes(jser.poly_to_bytes(j), CPU)
    same(back, a)
    assert used == len(data)
    with pytest.raises(ValueError):
        tser.poly_to_bytes(tu.from_u64(arr(0, (2, limbs, N)), CPU))


@pytest.mark.parametrize("degree", [1, 2])
def test_bfv_ciphertext(degree):
    arrays = [arr(10 + k, (3, N)) for k in range(degree + 1)]
    tct = tbfv.Ciphertext([tu.from_u64(a, CPU) for a in arrays])
    jct = jbfv.Ciphertext([ju.from_u64(a) for a in arrays])
    data = tser.bfv_ciphertext_to_bytes(tct)
    assert data == jser.bfv_ciphertext_to_bytes(jct)
    back = tser.bfv_ciphertext_from_bytes(data, CPU)
    assert back.is_ntt is False and len(back.value) == degree + 1
    for p, a in zip(back.value, arrays):
        same(p, a)


@pytest.mark.parametrize("level", [0, 2, 4])
def test_ckks_ciphertext(level):
    arrays = [arr(20 + k, (level + 1, N)) for k in range(2)]
    scale = 2.0**34 * 1.000123
    tct = tckks.Ciphertext([tu.from_u64(a, CPU) for a in arrays], scale)
    jct = jckks.Ciphertext([ju.from_u64(a) for a in arrays], scale)
    data = tser.ckks_ciphertext_to_bytes(tct)
    assert data == jser.ckks_ciphertext_to_bytes(jct)
    back = tser.ckks_ciphertext_from_bytes(jser.ckks_ciphertext_to_bytes(jct), CPU)
    assert back.scale == scale and back.is_ntt and back.level == level
    for p, a in zip(back.value, arrays):
        same(p, a)


def test_secret_and_public_keys():
    s, p0, p1 = arr(30, (5, N)), arr(31, (5, N)), arr(32, (5, N))
    data = tser.secret_key_to_bytes(tckks.SecretKey(tu.from_u64(s, CPU)))
    assert data == jser.secret_key_to_bytes(jckks.SecretKey(ju.from_u64(s)))
    same(tser.secret_key_from_bytes(data, tckks.SecretKey, CPU).sk, s)
    tpk = tckks.PublicKey((tu.from_u64(p0, CPU), tu.from_u64(p1, CPU)))
    data = tser.public_key_to_bytes(tpk)
    assert data == jser.public_key_to_bytes(jckks.PublicKey((ju.from_u64(p0), ju.from_u64(p1))))
    back = tser.public_key_from_bytes(data, tckks.PublicKey, CPU)
    same(back.pk[0], p0)
    same(back.pk[1], p1)


def swk_pair(seed, beta=3, limbs=4):
    k0, k1 = arr(seed, (beta, limbs, N)), arr(seed + 1, (beta, limbs, N))
    return (tckks.SwitchingKey(tu.from_u64(k0, CPU), tu.from_u64(k1, CPU)),
            jckks.SwitchingKey(ju.from_u64(k0), ju.from_u64(k1)), k0, k1)


@pytest.mark.parametrize("beta", [1, 3])
def test_switching_key(beta):
    tswk, jswk, k0, k1 = swk_pair(40, beta)
    data = tser.switching_key_to_bytes(tswk)
    assert data == jser.switching_key_to_bytes(jswk)
    back, used = tser.switching_key_from_bytes(data + b"tail", tckks.SwitchingKey, CPU)
    assert used == len(data)
    same(back.key0, k0)
    same(back.key1, k1)


@pytest.mark.parametrize("scheme", ["bfv", "ckks"])
def test_evaluation_key(scheme):
    """BFV keys hold a list of switching keys (one per degree), CKKS one."""
    keys = [swk_pair(50 + 2 * i) for i in range(2 if scheme == "bfv" else 1)]
    if scheme == "bfv":
        tevk = tbfv.EvaluationKey([k[0] for k in keys])
        jevk = jbfv.EvaluationKey([k[1] for k in keys])
        back = tser.evaluation_key_from_bytes(tser.evaluation_key_to_bytes(tevk),
                                              tbfv.EvaluationKey, tbfv.SwitchingKey, device=CPU)
        got = back.evakey
    else:
        tevk, jevk = tckks.EvaluationKey(keys[0][0]), jckks.EvaluationKey(keys[0][1])
        back = tser.evaluation_key_from_bytes(tser.evaluation_key_to_bytes(tevk), tckks.EvaluationKey,
                                              tckks.SwitchingKey, single=True, device=CPU)
        got = [back.evakey]
    assert tser.evaluation_key_to_bytes(tevk) == jser.evaluation_key_to_bytes(jevk)
    for swk, (_, _, k0, k1) in zip(got, keys):
        same(swk.key0, k0)
        same(swk.key1, k1)


@pytest.mark.parametrize("scheme", ["bfv", "ckks"])
def test_rotation_keys(scheme):
    """Left, right and the row swap (BFV) or conjugation (CKKS) records."""
    left = {1: swk_pair(60), 4: swk_pair(62)}
    right = {2: swk_pair(64)}
    extra = swk_pair(66)
    tmod, jmod, name = (tbfv, jbfv, "row") if scheme == "bfv" else (tckks, jckks, "conjugate")
    trk = tmod.RotationKeys({k: v[0] for k, v in left.items()}, {k: v[0] for k, v in right.items()})
    jrk = jmod.RotationKeys({k: v[1] for k, v in left.items()}, {k: v[1] for k, v in right.items()})
    setattr(trk, name, extra[0])
    setattr(jrk, name, extra[1])
    data = tser.rotation_keys_to_bytes(trk)
    assert data == jser.rotation_keys_to_bytes(jrk)
    back = tser.rotation_keys_from_bytes(data, tmod.RotationKeys, tmod.SwitchingKey, CPU)
    assert sorted(back.left) == [1, 4] and sorted(back.right) == [2]
    same(back.left[4].key1, left[4][3])
    same(back.right[2].key0, right[2][2])
    same(getattr(back, name).key1, extra[3])
    with pytest.raises(ValueError):
        tser.rotation_keys_from_bytes(bytes([7, 0, 0, 1]) + data[4:], tmod.RotationKeys,
                                      tmod.SwitchingKey, CPU)


@pytest.mark.parametrize("idx", [0, 2, 3])
def test_parameters(idx):
    tp, jp = tckks.default_params(idx), jckks.default_params(idx)
    data = tser.ckks_parameters_to_bytes(tp)
    assert data == jser.ckks_parameters_to_bytes(jp)
    back = tser.ckks_parameters_from_bytes(data)
    assert (back.log_n, back.log_slots, back.scale, back.sigma, back.qi, back.pi) == \
        (tp.log_n, tp.log_slots, tp.scale, tp.sigma, tp.qi, tp.pi)
    tb, jb = tbfv.default_params(idx), jbfv.default_params(idx)
    data = tser.bfv_parameters_to_bytes(tb)
    assert data == jser.bfv_parameters_to_bytes(jb)
    back = tser.bfv_parameters_from_bytes(data)
    assert (back.log_n, back.t, back.sigma, back.qi, back.pi, back.qi_mul) == \
        (tb.log_n, tb.t, tb.sigma, tb.qi, tb.pi, tb.qi_mul)


# -- protocol shares -----------------------------------------------------------

# the share of each codec: "poly" [L, N], "stacked" [beta, L, N], or a pair
SHARES = {
    "ckg": "poly", "cks": "poly", "pcks": ("poly", "poly"), "rkg_round1": "stacked",
    "rkg_round2": ("stacked", "stacked"), "rkg_round3": "stacked", "refresh": ("low", "poly"),
}
SHAPES = {"poly": (5, N), "low": (2, N), "stacked": (3, 5, N)}


def make_share(kind, seed):
    """(port share, JAX share, uint64 arrays) of a share kind."""
    if isinstance(kind, tuple):
        parts = [make_share(k, seed + i) for i, k in enumerate(kind)]
        return tuple(p[0] for p in parts), tuple(p[1] for p in parts), [p[2] for p in parts]
    a = arr(seed, SHAPES[kind])
    return tu.from_u64(a, CPU), ju.from_u64(a), a


def check_back(got, arrays):
    if isinstance(got, tuple):
        assert len(got) == len(arrays)
        for g, a in zip(got, arrays):
            same(g, a)
    else:
        same(got, arrays)


@pytest.mark.parametrize("codec", list(SHARES))
def test_share_codecs(codec):
    t, j, arrays = make_share(SHARES[codec], seed=70)
    data = getattr(tser, codec + "_share_to_bytes")(t)
    assert data == getattr(jser, codec + "_share_to_bytes")(j)
    check_back(getattr(tser, codec + "_share_from_bytes")(data, CPU), arrays)


def test_rtg_share():
    t, j, a = make_share("stacked", seed=80)
    data = tser.rtg_share_to_bytes(5, tser.ROTATION_LEFT, t)
    assert data == jser.rtg_share_to_bytes(5, jser.ROTATION_LEFT, j)
    assert struct.unpack(">QQQ", data[:24]) == (5, 2, 2 + 8 * 5 * N)
    k, rot_type, back = tser.rtg_share_from_bytes(data, CPU)
    assert (k, rot_type) == (5, tser.ROTATION_LEFT)
    same(back, a)
    with pytest.raises(ValueError):
        tser.rtg_share_from_bytes(data[:-8], CPU)


@pytest.mark.parametrize("kind", ["poly", "stacked", ("poly", "low"), ("stacked", "stacked")])
def test_kind_tagged_share(kind):
    """``share_to_bytes``: a poly (kind 0), a stacked share (kind 1), a pair
    (kind 2); the port tells a pair by its tuple, the JAX package by ndim."""
    t, j, arrays = make_share(kind, seed=90)
    data = tser.share_to_bytes(t)
    assert data == jser.share_to_bytes(j)
    assert data[0] == (2 if isinstance(kind, tuple) else {"poly": 0, "stacked": 1}[kind])
    check_back(tser.share_from_bytes(data, CPU), arrays)
    with pytest.raises(ValueError):
        tser.share_from_bytes(bytes([3]) + data[1:], CPU)


def test_from_bytes_defaults_to_cuda():
    """``device=None`` means the GPU, as everywhere in the port."""
    data = tser.ckg_share_to_bytes(make_share("poly", 1)[0])
    if torch.cuda.is_available():
        assert tser.ckg_share_from_bytes(data).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tser.ckg_share_from_bytes(data)


def test_dckks_shares_round_trip():
    """Shares the port's dCKKS protocols make at log N = 6, through their
    codecs and back, bit for bit: PCKS and refresh below the top level,
    the β-stacked rounds of the relinearization key."""
    from lattigo_tpu_torch.models import dckks

    params = tckks.Parameters(log_n=6, log_slots=5, scale=float(1 << 30),
                              log_qi=(45, 30, 30), log_pi=(45,)).gen_from_log_moduli()
    kgen = tckks.KeyGenerator(params, device=CPU, seed=1)
    sk, pk = kgen.gen_key_pair()
    enc = tckks.Encoder(params, device=CPU)
    ct = tckks.Encryptor(params, sk=sk, device=CPU).encrypt(enc.encode(np.ones(params.slots)))
    ct = tckks.Evaluator(params, device=CPU).drop_level(ct, 1)
    ctx = tckks.get_context(params, CPU)
    crp = torch.stack([tckks.KeyGenerator(params, device=CPU, seed=s).gen_public_key(sk).pk[1]
                       for s in range(params.beta())])
    rkg = dckks.RKGProtocol(params, device=CPU)
    r1 = rkg.gen_share_round_one(rkg.new_ephemeral_key(), sk.sk, crp)
    refresh = dckks.RefreshProtocol(params, device=CPU)
    shares = {
        "pcks": dckks.PCKSProtocol(params, device=CPU).gen_share(sk.sk, pk, ct),
        "cks": dckks.CKSProtocol(params, device=CPU).gen_share(sk.sk, sk.sk, ct),
        "rkg_round1": r1,
        "rkg_round2": rkg.gen_share_round_two(r1, sk.sk, crp),
        "refresh": refresh.gen_shares(sk.sk, 2, ct, ctx.ring_q.new_poly()),
    }
    assert shares["refresh"][0].shape[-2] == 2 and shares["refresh"][1].shape[-2] == 3
    for codec, share in shares.items():
        data = getattr(tser, codec + "_share_to_bytes")(share)
        for back in (getattr(tser, codec + "_share_from_bytes")(data, CPU),
                     tser.share_from_bytes(tser.share_to_bytes(share), CPU)):
            pairs = zip(back, share) if isinstance(share, tuple) else [(back, share)]
            for a, b in pairs:
                assert torch.equal(a, b)
