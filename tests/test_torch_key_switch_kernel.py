"""The key switch's inner product (``ops/key_switch.py`` ->
``csrc/key_switch.cu``) on the CPU, where the kernel cannot run.  Integers:
tolerance 0.

* The kernel's own source, built with the host C++ compiler by
  ``tools/host_build`` behind the real wrapper, equals the plain version
  :func:`inner_product_plain` for beta = 1, 2, 6, 7, 8, 9 (across the
  7-product reduction) and 64 (the dense layer's inner sums, 11
  reductions a fold) with moduli just below 2^61, in both layouts (BFV
  ``[beta, B, L, N]``, CKKS ``[B, beta, L, N]``), with a non-prefix limb
  map (ring table and key rows), the key broadcast over B = 1, 3 and 8, with and without a
  Galois index: on random 64-bit words with the edge words 0, 1, q - 1,
  q, 2^63 and 2^64 - 1 in every pairing of a key word with a d word, and
  on words whose every product is q - 1, where a sum of 9 unreduced
  products overflows 64 bits.
* BFV ``relinearize`` / ``rotate_columns`` and CKKS ``mul_relin`` /
  ``switch_keys`` / ``rotate_hoisted`` at log N = 8 through that source
  equal the JAX package's outputs bit for bit (port-made keys carried
  across by ``convert``, numpy-seeded ciphertext words), with no ring
  product, reduction, concatenation or gather left on the keys and no
  permuted copy of the decomposition.
* No fallback: a launcher that returns an error raises, and so does a set
  of tensors not on one CUDA device (or all on the CPU).
"""

import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from lattigo_tpu.models import bfv as jbfv
from lattigo_tpu.models import ckks as jckks
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu_torch import _build, convert
from lattigo_tpu_torch.models import bfv as tbfv
from lattigo_tpu_torch.models import ckks as tckks
from lattigo_tpu_torch.ops import galois, key_switch as ks
from lattigo_tpu_torch.ops import number_theory as nt
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.ops.ring import Ring
from lattigo_tpu_torch.tools import host_build

torch.set_num_threads(1)

N = 256
R64 = 1 << 64


def primes_below_2_61(count: int) -> list[int]:
    """Primes == 1 mod 2N just below 2^61: nine products of q - 1 exceed
    2^64, so a fold that skips its reduction overflows."""
    out, x = [], (1 << 61) - 2 * N + 1
    while len(out) < count:
        if nt.is_prime(x):
            out.append(x)
        x -= 2 * N
    return out


RING = Ring(N, primes_below_2_61(6), compute_ntt_tables=False, device="cpu")
QL = (5, 0, 3, 1)  # output limb -> ring table row and key row


@pytest.fixture(scope="module")
def host_lib():
    """csrc/key_switch.cu built for the host (``tools/host_build``)."""
    return host_build.load("key_switch")


def on_host(monkeypatch, lib) -> None:
    """CPU tensors down the key switch's kernel path, launched by ``lib``
    (the host build of its source) behind the seam."""
    monkeypatch.setattr(_build, "takes_kernel", lambda name, *tensors: name == "key_switch")
    monkeypatch.setitem(_build.LIBRARIES, "key_switch", lib)


def ks_launches() -> int:
    return _build.launch_counts()["key_switch"]


def words(rng, shape) -> np.ndarray:
    return rng.integers(0, R64, size=shape, dtype=np.uint64)


def edge_words(q: int) -> list[int]:
    return [0, 1, q - 1, q, 1 << 63, R64 - 1]


def operands(rng, layout: str, beta: int, batch: tuple, fill: str):
    """(d, key0, key1, beta_axis): d in ``layout`` over ``batch``, keys of
    beta + 1 blocks of the ring's limbs.  ``fill``: ``random`` (the edge words
    of each limb's modulus paired in coefficients 0..35 of every block) or
    ``max_products`` (every product q - 1)."""
    L = len(QL)
    d = words(rng, (*batch, beta, L, N))
    keys = [words(rng, (beta + 1, RING.L, N)) for _ in range(2)]
    for l, r in enumerate(QL):
        q = RING.moduli[r]
        edge = np.array(edge_words(q), dtype=np.uint64)
        if fill == "max_products":  # mred(q - 1, 2^64 mod q) = q - 1
            d[..., l, :] = R64 % q
            for k in keys:
                k[:, r, :] = q - 1
        else:
            d[..., l, :36] = np.repeat(edge, 6)
            for h, k in enumerate(keys):
                k[:, r, :36] = np.tile(np.roll(edge, h), 6)
    d = tu.from_u64(d, "cpu")
    if layout == "bfv":  # [beta, *batch, L, N], contiguous
        d = d.movedim(-3, 0).contiguous()
        return d, *(tu.from_u64(k, "cpu") for k in keys), 0
    if layout == "offset":  # coefficients at an odd word offset
        wide = torch.zeros((*d.shape[:-1], N + 1), dtype=torch.int64)
        wide[..., 1:] = d
        d = wide[..., 1:]
    elif layout == "perm" and len(batch) == 2:  # batch dims that do not collapse
        d = d.transpose(0, 1).contiguous().transpose(0, 1)
    return d, *(tu.from_u64(k, "cpu") for k in keys), -3


BATCHES = {1: (), 3: (3,), 8: (2, 4)}


def check(monkeypatch, lib, layout, beta, b, index, fill, seed) -> None:
    rng = np.random.default_rng(seed)
    d, k0, k1, axis = operands(rng, layout, beta, BATCHES[b], fill)
    idx = galois.ntt_index(5, N, "cpu") if index else None
    want = ks.inner_product_plain(d, k0, k1, RING, QL, beta, idx, axis)
    on_host(monkeypatch, lib)
    before = ks_launches()
    got = ks.inner_product(d, k0, k1, RING, QL, beta, index=idx, beta_axis=axis)
    assert ks_launches() == before + 1
    assert got.shape == want.shape == (2, *BATCHES[b], len(QL), N)
    assert torch.equal(got, want)


@pytest.mark.parametrize("index", [False, True])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("layout", ["bfv", "ckks"])
@pytest.mark.parametrize("beta", [1, 2, 6, 7, 8, 9, 64])
def test_source_equals_plain(monkeypatch, host_lib, beta, layout, b, index):
    check(monkeypatch, host_lib, layout, beta, b, index, "random", seed=beta * 100 + b)


@pytest.mark.parametrize("layout", ["bfv", "ckks"])
@pytest.mark.parametrize("beta", [1, 2, 6, 7, 8, 9, 64])
def test_source_equals_plain_on_largest_products(monkeypatch, host_lib, beta, layout):
    check(monkeypatch, host_lib, layout, beta, 3, False, "max_products", seed=beta)


@pytest.mark.parametrize("layout,copies", [("offset", 0), ("perm", 1)])
def test_source_equals_plain_on_other_layouts(monkeypatch, host_lib, layout, copies):
    """An odd coefficient offset and batch dims that do not collapse (one
    counted copy)."""
    before = _build.copy_counts()["key_switch"]
    check(monkeypatch, host_lib, layout, 9, 8, False, "random", seed=7)
    assert _build.copy_counts()["key_switch"] == before + copies


def test_max_products_overflow_without_the_reduction():
    """The test data is strong enough: nine products of q - 1 wrap 64 bits,
    so the unreduced sum differs from the folded one."""
    for q in RING.moduli:
        assert 9 * (q - 1) >= R64 and 7 * (q - 1) < R64


def test_d_plan_layouts():
    """Block and batch strides of both layouts, read back through
    ``as_strided``, give the blocks of d."""
    rng = np.random.default_rng(3)
    for layout, batch in (("bfv", (2, 4)), ("ckks", (2, 4)), ("ckks", ()), ("perm", (2, 4))):
        d, _, _, axis = operands(rng, layout, 3, batch, "random")
        dv, (sb, si, sl, sn), shape, copies = ks.d_plan(d, axis)
        assert shape == batch and copies == (layout == "perm")
        B = int(np.prod(batch)) if batch else 1
        view = torch.as_strided(dv, (B, 3, len(QL), N), (sb, si, sl, sn), dv.storage_offset())
        assert torch.equal(view, d.movedim(axis, -3).reshape(B, 3, len(QL), N))


# -- the schemes' key switches against the JAX package ------------------------

BFV_SPEC = dict(log_n=8, t=65537, log_qi=(46, 46), log_pi=(47,), log_qi_mul=(60, 60))
CKKS_SPEC = dict(log_n=8, log_slots=7, scale=float(1 << 32), log_qi=(45, 32, 32, 32),
                 log_pi=(45,))


def residues(rng, moduli, count: int) -> list[np.ndarray]:
    """``count`` polys of numpy-seeded residues below each limb's modulus."""
    q = np.array(moduli, dtype=np.uint64)[:, None]
    return [rng.integers(0, q, size=(len(moduli), N), dtype=np.uint64) for _ in range(count)]


def key_spy(monkeypatch, keys) -> list:
    """Records every ring product or reduction on the key-switch fold's
    path, every concatenation or gather of a key, and every gather of a
    stack of decomposition blocks (more than two dims)."""
    stray = []
    ptrs = {k.untyped_storage().data_ptr() for k in keys}

    def tensors(args):
        for a in args:
            if isinstance(a, torch.Tensor):
                yield a
            elif isinstance(a, (list, tuple)):
                yield from tensors(a)

    def spy(owner, name, flag):
        fn = getattr(owner, name)

        def wrapped(*args, **kw):
            if flag(list(tensors(args))):
                stray.append(f"{name} from {sys._getframe(1).f_code.co_name}")
            return fn(*args, **kw)

        monkeypatch.setattr(owner, name, wrapped)

    on_key = lambda ts: any(t.untyped_storage().data_ptr() in ptrs for t in ts)
    for name in ("mul_coeffs_montgomery_limbs", "reduce_limbs"):
        spy(Ring, name, lambda ts: True)
    for name in ("mul_coeffs_montgomery", "reduce"):
        spy(Ring, name, on_key)
    spy(torch, "cat", on_key)
    spy(torch, "index_select", lambda ts: on_key(ts) or ts[0].ndim > 2)
    return stray


def jnp_polys(polys) -> list[np.ndarray]:
    return [ju.to_u64(jax.tree.map(np.asarray, p)) for p in polys]


@pytest.fixture(scope="module")
def bfv_world():
    tp = tbfv.Parameters(**BFV_SPEC).gen_from_log_moduli()
    jp = jbfv.Parameters(**BFV_SPEC).gen_from_log_moduli()
    kgen = tbfv.KeyGenerator(tp, device="cpu", seed=15)
    sk = kgen.gen_secret_key()
    rlk = kgen.gen_relin_key(sk, 1)
    rot = tbfv.RotationKeys()
    kgen.gen_rot("left", sk, 3, rot)
    carry = lambda swk: jbfv.SwitchingKey(*(ju.from_u64(k)
                                            for k in convert.switching_key_to_numpy(swk)))
    rng = np.random.default_rng(15)
    c3 = residues(rng, tp.qi, 3)
    return dict(t_ev=tbfv.Evaluator(tp, device="cpu"), j_ev=jbfv.Evaluator(jp), rlk=rlk, rot=rot,
                j_rlk=jbfv.EvaluationKey([carry(rlk.evakey[0])]),
                j_rot=jbfv.RotationKeys({3: carry(rot.left[3])}), c3=c3)


@pytest.mark.parametrize("op", ["relinearize", "rotate_columns"])
def test_bfv_key_switch_equals_jax(monkeypatch, host_lib, bfv_world, op):
    w = bfv_world
    polys = w["c3"] if op == "relinearize" else w["c3"][:2]
    jct = jbfv.Ciphertext([ju.from_u64(p) for p in polys])
    if op == "relinearize":
        want, key = w["j_ev"].relinearize(jct, w["j_rlk"]), w["rlk"].evakey[0]
        run = lambda ev, ct: ev.relinearize(ct, w["rlk"])
    else:
        want, key = w["j_ev"].rotate_columns(jct, 3, w["j_rot"]), w["rot"].left[3]
        run = lambda ev, ct: ev.rotate_columns(ct, 3, w["rot"])
    on_host(monkeypatch, host_lib)
    stray = key_spy(monkeypatch, (key.key0, key.key1))
    before = ks_launches()
    got = run(w["t_ev"], convert.ciphertext_from_numpy(polys, "cpu"))
    assert ks_launches() == before + 1
    assert stray == []
    for a, b in zip(convert.ciphertext_to_numpy(got), jnp_polys(want.value), strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def ckks_world():
    tp = tckks.Parameters(**CKKS_SPEC).gen_from_log_moduli()
    jp = jckks.Parameters(**CKKS_SPEC).gen_from_log_moduli()
    kgen = tckks.KeyGenerator(tp, device="cpu", seed=15)
    sk, sk2 = kgen.gen_secret_key(), kgen.gen_secret_key()
    rlk, swk = kgen.gen_relin_key(sk), kgen.gen_switching_key(sk, sk2)
    rot = tckks.RotationKeys()
    for k in (1, 2):
        kgen.gen_rot("left", sk, k, rot)
    carry = lambda key: jckks.SwitchingKey(*(ju.from_u64(k)
                                             for k in convert.switching_key_to_numpy(key)))
    rng = np.random.default_rng(16)
    return dict(t_ev=tckks.Evaluator(tp, device="cpu"), j_ev=jckks.Evaluator(jp), rlk=rlk,
                swk=swk, rot=rot, j_rlk=jckks.EvaluationKey(carry(rlk.evakey)), j_swk=carry(swk),
                j_rot=jckks.RotationKeys({k: carry(v) for k, v in rot.left.items()}, {}, None),
                ca=residues(rng, tp.qi, 2), cb=residues(rng, tp.qi, 2), scale=tp.scale)


@pytest.mark.parametrize("op", ["mul_relin", "switch_keys", "rotate_hoisted"])
def test_ckks_key_switch_equals_jax(monkeypatch, host_lib, ckks_world, op):
    w = ckks_world
    jct = lambda polys: jckks.Ciphertext([ju.from_u64(p) for p in polys], w["scale"])
    tct = lambda polys: convert.ckks_ciphertext_from_numpy(polys, w["scale"], "cpu")
    ev, jev = w["t_ev"], w["j_ev"]
    if op == "mul_relin":
        keys, launches = [w["rlk"].evakey], 1
        want = {0: jev.mul_relin(jct(w["ca"]), jct(w["cb"]), w["j_rlk"])}
        run = lambda: {0: ev.mul_relin(tct(w["ca"]), tct(w["cb"]), w["rlk"])}
    elif op == "switch_keys":
        keys, launches = [w["swk"]], 1
        want = {0: jev.switch_keys(jct(w["ca"]), w["j_swk"])}
        run = lambda: {0: ev.switch_keys(tct(w["ca"]), w["swk"])}
    else:
        keys, launches = list(w["rot"].left.values()), 2
        want = jev.rotate_hoisted(jct(w["ca"]), [0, 1, 2], w["j_rot"])
        run = lambda: ev.rotate_hoisted(tct(w["ca"]), [0, 1, 2], w["rot"])
    on_host(monkeypatch, host_lib)
    stray = key_spy(monkeypatch, [k for swk in keys for k in (swk.key0, swk.key1)])
    before = ks_launches()
    got = run()
    assert ks_launches() == before + launches
    assert stray == []
    assert sorted(got) == sorted(want)
    for k in got:
        polys, scale = convert.ckks_ciphertext_to_numpy(got[k])
        assert scale == want[k].scale
        for a, b in zip(polys, jnp_polys(want[k].value), strict=True):
            np.testing.assert_array_equal(a, b)


def test_spy_catches_the_plain_fold(monkeypatch, bfv_world):
    """The routing check itself: the plain fold on the CPU is seen."""
    w = bfv_world
    key = w["rlk"].evakey[0]
    stray = key_spy(monkeypatch, (key.key0, key.key1))
    w["t_ev"].relinearize(convert.ciphertext_from_numpy(w["c3"], "cpu"), w["rlk"])
    assert any(s.startswith("mul_coeffs_montgomery_limbs") for s in stray)


# -- no fallback ---------------------------------------------------------------


class _FailingLib:
    def __init__(self, err):
        self.err = err

    def key_switch_launch(self, *args):
        return self.err


@pytest.mark.parametrize("err", [700, -2])
def test_a_failed_launch_raises(monkeypatch, err):
    """A call on the kernel path whose launcher reports an error raises; it
    never falls back to the plain version."""
    d, k0, k1, axis = operands(np.random.default_rng(1), "ckks", 2, (), "random")
    on_host(monkeypatch, _FailingLib(err))
    before = ks_launches()
    with pytest.raises(RuntimeError, match="key_switch_launch"):
        ks.inner_product(d, k0, k1, RING, QL, 2, beta_axis=axis)
    assert ks_launches() == before


def test_other_devices_raise():
    """Not one device, or not the CPU or a card: no plain fallback."""
    d, k0, k1, axis = operands(np.random.default_rng(1), "ckks", 2, (), "random")
    with pytest.raises(ValueError, match="one device"):
        ks.inner_product(d.to("meta"), k0, k1, RING, QL, 2, beta_axis=axis)
    meta = SimpleNamespace(q_=RING.q_.to("meta"))
    with pytest.raises(ValueError, match="one device"):
        ks.inner_product(d.to("meta"), k0.to("meta"), k1.to("meta"), meta, QL, 2,
                         beta_axis=axis)


def test_cpu_takes_the_plain_version(monkeypatch):
    """On CPU tensors the wrapper is its plain version, and launches
    nothing."""
    d, k0, k1, axis = operands(np.random.default_rng(2), "bfv", 3, (3,), "random")
    before = ks_launches()
    got = ks.inner_product(d, k0, k1, RING, QL, 3, beta_axis=axis)
    assert ks_launches() == before
    assert torch.equal(got, ks.inner_product_plain(d, k0, k1, RING, QL, 3, beta_axis=axis))


def test_variants_apply_to_the_kernel_source():
    """Every diagnostic variant of lattigo_tpu_torch/tools/key_switch_variants.py
    still finds the text it replaces in csrc/key_switch.cu."""
    from lattigo_tpu_torch.tools import key_switch_variants as kv

    src = open(f"{_build.CSRC}/key_switch.cu").read()
    assert kv.VARIANTS["kernel"] == [] and "key_switch" in _build.SOURCES
    for name, subs in kv.VARIANTS.items():
        for old, new in subs:
            assert src.count(old) >= 1 and old != new, (name, old)
