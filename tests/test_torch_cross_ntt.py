"""The port's cross-rank four-step NTT against the port's ``Ring`` and the
JAX package's ``ntt_four_step``, bit for bit (integers, tolerance 0).

One world of 4 gloo ranks on the CPU for the whole module; a 2-rank split
runs on its two subgroups ({0, 1} and {2, 3}).  The JAX side runs on the
8-device virtual CPU mesh of tests/conftest.py with the same split on its
``data`` axis.  Cases follow tests/test_cross_ntt.py: log N = 12 and 16,
1/3/4 limbs, a batch with the limb subset (2, 0), the split factors, and
the scheme-level ``sharded_ntt`` dispatch up to a BFV multiply +
relinearize, which must equal the unsharded one."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lattigo_tpu.ops import number_theory as jnt
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu.ops.ring import Ring as JRing
from lattigo_tpu.parallel.cross_ntt import ntt_four_step as jax_four_step
from lattigo_tpu.parallel.mesh import make_mesh as jax_mesh
from lattigo_tpu_torch.models import bfv
from lattigo_tpu_torch.ops import ring as ring_mod
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.ops.ring import Ring
from lattigo_tpu_torch.parallel import cross_ntt
from lattigo_tpu_torch.parallel.launch import World

torch.set_num_threads(1)

RANKS = 4
_groups: dict = {}


def _group(d: int):
    """This rank's group of ``d`` consecutive ranks (made once a process)."""
    if d == dist.get_world_size():
        return None
    if d not in _groups:
        groups = [dist.new_group(list(range(s, s + d))) for s in range(0, dist.get_world_size(), d)]
        _groups[d] = groups[dist.get_rank() // d]
    return _groups[d]


def _four_step_rank(n, moduli, x, limbs, d, n2):
    """Forward on ``x``, inverse on the forward, on this rank's group of d;
    the op cache before and after, to show the tables stay out of it."""
    ring = Ring(n, moduli, device="cpu")
    ring.mul_scalar(tu.from_u64(x, "cpu"), 3)  # an op-cache entry, as a scheme step makes
    before = list(ring._op_cache)
    assert before
    X = tu.from_u64(x, "cpu")
    fwd = cross_ntt.ntt_four_step(ring, X, _group(d), n2=n2, limbs=limbs)
    back = cross_ntt.ntt_four_step(ring, fwd, _group(d), n2=n2, limbs=limbs, inverse=True)
    return tu.to_u64(fwd), tu.to_u64(back), before == list(ring._op_cache)


def _inverse_lazy_rank(n, moduli, x):
    """The inverse of inputs below 4q (the port's intt domain)."""
    ring = Ring(n, moduli, device="cpu")
    return tu.to_u64(cross_ntt.ntt_four_step(ring, tu.from_u64(x, "cpu"), None, inverse=True))


def _sharded_bfv_rank():
    """BFV mul + relinearize at PN12QP109 unsharded and inside sharded_ntt
    (every transform cross-rank), decrypted; the routes taken."""
    params = bfv.default_params(bfv.PN12QP109)
    kg = bfv.KeyGenerator(params, device="cpu", seed=4)
    sk, pk = kg.gen_key_pair()
    rlk = kg.gen_relin_key(sk)
    enc = bfv.Encoder(params, device="cpu")
    encryptor = bfv.Encryptor(params, pk=pk, device="cpu")
    ev = bfv.Evaluator(params, device="cpu")
    rng = np.random.default_rng(10)
    a, b = (rng.integers(0, params.t, params.n, dtype=np.uint64) for _ in range(2))
    ca, cb = encryptor.encrypt(enc.encode_uint(a)), encryptor.encrypt(enc.encode_uint(b))
    plain = ev.relinearize(ev.mul(ca, cb), rlk)
    with ring_mod.record_transforms() as calls, cross_ntt.sharded_ntt(None, min_n=params.n):
        sharded = ev.relinearize(ev.mul(ca, cb), rlk)
        got = enc.decode_uint(bfv.Decryptor(params, sk, device="cpu").decrypt(sharded))
    return ([tu.to_u64(p) for p in plain.value], [tu.to_u64(p) for p in sharded.value],
            got, a * b % np.uint64(params.t), sorted({c[4] for c in calls}))


@pytest.fixture(scope="module")
def world():
    with World(RANKS, device_type="cpu") as w:
        yield w


# per log N: the limbs and batch of the one input transformed on the JAX
# side; every case takes a part of it (limbs are independent, so a prefix of
# the rows of the 4-limb transform is the transform on the smaller ring)
REFERENCE = {12: (4, (3,)), 13: (2, ()), 16: (2, ())}
_jax_out: dict = {}


def _moduli(log_n, n_limbs, bits=59):
    """tests/test_cross_ntt.py's rings (at log N = 12 each a prefix of the
    next: the generator's primes come in one order)."""
    if log_n <= 13 and n_limbs == 2:
        return [576460752303439873, 576460752303702017]
    return jnt.generate_ntt_primes(bits, log_n, n_limbs)


def _reference(log_n):
    """The JAX ``ntt_four_step`` of the reference input on the virtual
    mesh's 4-device ``data`` axis: (input, output), uint64.  A compile takes
    about 5 s on this CPU, so each log N has one."""
    if log_n not in _jax_out:
        n_limbs, batch = REFERENCE[log_n]
        n, moduli = 1 << log_n, _moduli(log_n, n_limbs)
        x = _rand(moduli, n, batch, log_n)
        out = jax_four_step(JRing(n, moduli), ju.from_u64(x), jax_mesh(8, party=2), axis="data")
        _jax_out[log_n] = x, ju.to_u64(out)
    return _jax_out[log_n]


def _rand(moduli, n, batch, seed, mult=1):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 60, size=(*batch, len(moduli), n), dtype=np.uint64)
    return x % (mult * np.array(moduli, dtype=np.uint64))[:, None]


def _check(world, log_n, n_limbs, batched, limbs, d=RANKS, n2=None):
    """The port's transform on ``d`` ranks of a part of the reference input
    (the first ``n_limbs`` limbs, or the rows ``limbs``; the whole batch or
    its first element) against the port's ring and the JAX transform."""
    x_ref, jax_ref = _reference(log_n) if log_n in REFERENCE else (None, None)
    rows = list(limbs) if limbs is not None else list(range(n_limbs))
    n, moduli = 1 << log_n, _moduli(log_n, max(rows) + 1 if limbs is None else n_limbs)
    if x_ref is None:
        x, want_jax = _rand(moduli, n, (2,), log_n)[..., rows, :], None
    else:
        pick = (lambda a: a[..., rows, :]) if batched else (lambda a: a[(0,) * (a.ndim - 2)][rows])
        x, want_jax = pick(x_ref), pick(jax_ref)
    outs = world.run(_four_step_rank, n, moduli, x, limbs, d, n2)
    want = tu.to_u64(Ring(n, moduli, device="cpu").ntt_limbs(tu.from_u64(x, "cpu"), tuple(rows)))
    if want_jax is not None:
        np.testing.assert_array_equal(want_jax, want)
    for fwd, back, cache_kept in outs:
        np.testing.assert_array_equal(fwd, want)
        np.testing.assert_array_equal(back, x)
        assert cache_kept


@pytest.mark.parametrize("log_n", [12, 16])
def test_four_step_forward_inverse_bitexact(world, log_n):
    _check(world, log_n, 2, False, None)


@pytest.mark.parametrize("n_limbs", [1, 3, 4])
def test_limb_sweep(world, n_limbs):
    _check(world, 12, n_limbs, False, None)


def test_batched_and_limb_subset(world):
    _check(world, 12, 4, True, (2, 0))


@pytest.mark.parametrize("d,n2", [(4, None), (2, None), (4, 256), (2, 512)])
def test_split_factors(world, d, n2):
    """Groups of 4 and of 2 ranks, the default n2 and overrides."""
    _check(world, 13, 2, False, None, d, n2)


def test_inverse_takes_lazy_inputs(world):
    """Inputs below 4q, as Ring.intt_limbs takes them: equal to the port's
    plain inverse (the JAX four-step inverse assumes inputs below 2q)."""
    moduli = _moduli(12, 3)
    x = _rand(moduli, 1 << 12, (2,), 9, mult=4)
    want = tu.to_u64(Ring(1 << 12, moduli, device="cpu").intt(tu.from_u64(x, "cpu")))
    for got in world.run(_inverse_lazy_rank, 1 << 12, moduli, x):
        np.testing.assert_array_equal(got, want)


def test_default_split_of_a_small_ring(world):
    """At N = 256 the JAX default n2 = max(128, D) leaves 2 rows for 4
    ranks; the port's default takes n2 = N / D = 64 (held against the
    port's ring only)."""
    _check(world, 8, 2, True, None)


def test_sharded_bfv_mul_relin_equals_unsharded(world):
    """A BFV multiply + relinearize at N = 4096 with every transform routed
    over the 4 ranks equals the unsharded one bit for bit, and decrypts."""
    for plain, sharded, got, want, routes in world.run(_sharded_bfv_rank):
        for a, b in zip(plain, sharded):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got, want)
        assert routes == ["cross"]
