"""The port's ring layer against the JAX package's, bit for bit: host number
theory, NTT / InvNTT (prefix and non-prefix limbs, lazy inputs) and every
coefficient op the slice calls, at N = 16..1024, L = 1..3, batch (), (2,),
(3, 2).  Inputs come from numpy seeds; integers, tolerance 0."""

import jax
import numpy as np
import pytest
import torch

from lattigo_tpu.ops import number_theory as jnt
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu.ops.ring import Ring as JRing
from lattigo_tpu_torch.ops import number_theory as tnt
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.ops.default_params import default_pi, default_qi
from lattigo_tpu_torch.ops.ring import Ring as TRing

torch.set_num_threads(1)

# (log_n, limbs, batch, modulus bits)
CONFIGS = [
    (4, 1, (), 60),
    (6, 2, (2,), 55),
    (8, 3, (3, 2), 46),
    (10, 2, (), 60),
    (10, 3, (2,), 39),
]
IDS = [f"n{1 << c[0]}-L{c[1]}-b{'x'.join(map(str, c[2])) or '1'}" for c in CONFIGS]
_rings: dict = {}


def rings(log_n, L, bits):
    key = (log_n, L, bits)
    if key not in _rings:
        qs = jnt.generate_ntt_primes(bits, log_n, L)
        _rings[key] = (JRing(1 << log_n, qs), TRing(1 << log_n, qs, device="cpu"))
    return _rings[key]


def rand(moduli, n, batch, seed, mult=1):
    rng = np.random.default_rng(seed)
    x = np.empty((*batch, len(moduli), n), dtype=np.uint64)
    for i, q in enumerate(moduli):
        x[..., i, :] = rng.integers(0, mult * q, size=(*batch, n), dtype=np.uint64)
    return x


def eq(got, want):
    np.testing.assert_array_equal(tu.to_u64(got), ju.to_u64(want))


def T(a):
    return tu.from_u64(a, "cpu")


def jitted(fn, x, *static):
    """The JAX side of a transform as one compiled program (op-by-op
    dispatch compiles every stage's shapes separately and is far slower)."""
    return jax.jit(lambda a: fn(a, *static))(ju.from_u64(x))


def test_number_theory_copies_agree():
    for bits, log_n, cnt in ((60, 12, 3), (39, 12, 2), (30, 12, 1), (55, 8, 4)):
        assert tnt.generate_ntt_primes(bits, log_n, cnt) == jnt.generate_ntt_primes(bits, log_n, cnt)
    for q, n in ((jnt.generate_ntt_primes(60, 10, 1)[0], 1024), (65537, 256)):
        assert tnt.psi_tables(q, n) == jnt.psi_tables(q, n)
        assert tnt.primitive_root(q) == jnt.primitive_root(q)
        assert tnt.bred_params(q) == jnt.bred_params(q)
        assert tnt.mred_params(q) == jnt.mred_params(q)
    assert default_qi(10, 2) == tuple(jnt.generate_ntt_primes(60, 10, 2))
    assert default_pi(10, 1) == tuple(jnt.generate_ntt_primes(60, 10, 9)[8:9])


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_tables_agree(cfg):
    log_n, L, _, bits = cfg
    jr, tr = rings(log_n, L, bits)
    np.testing.assert_array_equal(tr.ntt_psi_host, jr.ntt_psi_host)
    np.testing.assert_array_equal(tr.ntt_psi_inv_host, jr.ntt_psi_inv_host)
    for name in ("q_", "two_q_", "u0_", "u1_", "qinv_", "n_inv_"):
        eq(getattr(tr, name), getattr(jr, name))
    for inverse in (False, True):
        for a, b in zip(tr.shoup_twiddles(inverse), jr.shoup_twiddles(inverse)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_ntt_intt(cfg):
    log_n, L, batch, bits = cfg
    jr, tr = rings(log_n, L, bits)
    x = rand(jr.moduli, jr.n, batch, seed=log_n)
    fwd = tr.ntt(T(x))
    eq(fwd, jitted(jr.ntt, x))
    eq(tr.intt(T(x)), jitted(jr.intt, x))
    np.testing.assert_array_equal(tu.to_u64(tr.intt(fwd)), x)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_ntt_limbs_nonprefix_and_lazy(cfg):
    log_n, L, batch, bits = cfg
    jr, tr = rings(log_n, L, bits)
    limbs = tuple(range(L))[::-1][: max(1, L - 1)]  # e.g. (2, 1) of 3 limbs
    mods = [jr.moduli[l] for l in limbs]
    # forward accepts < 4q; the inverse is held on the reference's lazy domain < 2q
    x4 = rand(mods, jr.n, batch, seed=10 + log_n, mult=4)
    eq(tr.ntt_limbs(T(x4), limbs), jitted(jr.ntt_limbs, x4, limbs))
    x2 = rand(mods, jr.n, batch, seed=20 + log_n, mult=2)
    eq(tr.intt_limbs(T(x2), limbs), jitted(jr.intt_limbs, x2, limbs))
    # below 4q the port's inverse folds first: same residues as from x mod q
    x1 = x4 % np.array(mods, dtype=np.uint64)[:, None]
    np.testing.assert_array_equal(
        tu.to_u64(tr.intt_limbs(T(x4), limbs)), tu.to_u64(tr.intt_limbs(T(x1), limbs))
    )


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_coefficient_ops(cfg):
    log_n, L, batch, bits = cfg
    jr, tr = rings(log_n, L, bits)
    a = rand(jr.moduli, jr.n, batch, seed=30 + log_n)
    b = rand(jr.moduli, jr.n, batch, seed=40 + log_n)
    c = rand(jr.moduli, jr.n, (), seed=50 + log_n)  # broadcasts over the batch
    raw = np.random.default_rng(60 + log_n).integers(
        0, 1 << 64, size=a.shape, dtype=np.uint64)
    ja, jb, jc, jraw = (ju.from_u64(v) for v in (a, b, c, raw))
    ta, tb, tc, traw = (T(v) for v in (a, b, c, raw))
    eq(tr.add(ta, tb), jr.add(ja, jb))
    eq(tr.sub(ta, tb), jr.sub(ja, jb))
    eq(tr.neg(ta), jr.neg(ja))
    eq(tr.reduce(traw), jr.reduce(jraw))
    eq(tr.mform(ta), jr.mform(ja))
    eq(tr.mul_coeffs_montgomery(ta, tb), jr.mul_coeffs_montgomery(ja, jb))
    eq(tr.mul_coeffs_montgomery(ta, tc), jr.mul_coeffs_montgomery(ja, jc))
    eq(tr.mul_coeffs_montgomery_and_add(ta, tb, tc), jr.mul_coeffs_montgomery_and_add(ja, jb, jc))
    eq(tr.mul_coeffs_montgomery_and_sub(ta, tb, tc), jr.mul_coeffs_montgomery_and_sub(ja, jb, jc))
    big = (1 << 200) + 12345678901234567
    eq(tr.mul_scalar(ta, 65537), jr.mul_scalar(ja, 65537))
    eq(tr.mul_scalar_bigint(ta, big), jr.mul_scalar_bigint(ja, big))
    eq(tr.add_scalar_bigint(ta, big), jr.add_scalar_bigint(ja, big))
    eq(tr.sub_scalar_bigint(ta, big), jr.sub_scalar_bigint(ja, big))


def test_bigint_roundtrip_and_negacyclic_product():
    jr, tr = rings(4, 1, 60)
    rng = np.random.default_rng(7)
    ca = [int(v) for v in rng.integers(0, 1 << 40, 16)]
    cb = [int(v) for v in rng.integers(0, 1 << 40, 16)]
    A, B = tr.set_coeffs_bigint(ca), tr.set_coeffs_bigint(cb)
    assert tr.poly_to_bigint(A) == ca
    prod = tr.intt(tr.mul_coeffs_montgomery(tr.mform(tr.ntt(A)), tr.ntt(B)))
    q = tr.moduli[0]
    want = [0] * 16
    for i in range(16):
        for j in range(16):
            k, s = (i + j) % 16, -1 if i + j >= 16 else 1
            want[k] = (want[k] + s * ca[i] * cb[j]) % q
    assert tr.poly_to_bigint(prod) == want


def test_device_none_means_cuda_or_raises():
    qs = jnt.generate_ntt_primes(60, 4, 1)
    if torch.cuda.is_available():
        assert TRing(16, qs).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            TRing(16, qs)
