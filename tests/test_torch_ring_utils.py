"""The port's coefficient-wise Ring utilities against the JAX package's.

Every method is fed the same numpy-seeded residues in both packages at
log N = 4 and 8 with two 55-bit limbs; outputs are integers and must be
equal bit for bit (tolerance 0).  ``mul_poly`` is also held against the
schoolbook ``mul_poly_naive``.
"""

import numpy as np
import pytest
import torch

from lattigo_tpu.ops import u64 as ju
from lattigo_tpu.ops.ring import Ring as JRing
from lattigo_tpu_torch.ops import number_theory as nt
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.ops.ring import OP_CACHE_SIZE, Ring as TRing

torch.set_num_threads(1)

LOG_NS = (4, 8)
_rings: dict = {}


def rings(log_n: int):
    if log_n not in _rings:
        qs = nt.generate_ntt_primes(55, log_n, 2)
        _rings[log_n] = (JRing(1 << log_n, qs), TRing(1 << log_n, qs, device="cpu"))
    return _rings[log_n]


def residues(ring, seed: int, below_mult: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, below_mult * q, ring.n, dtype=np.uint64) for q in ring.moduli])


def run_both(log_n: int, call, *arrays):
    """``call(ring, *polys)`` in both packages; returns the two outputs as
    numpy uint64 arrays (or Python values where the method returns one)."""
    jr, tr = rings(log_n)
    jout = call(jr, *[ju.from_u64(a) for a in arrays])
    tout = call(tr, *[tu.from_u64(a, "cpu") for a in arrays])
    if isinstance(tout, torch.Tensor):
        return ju.to_u64(jout), tu.to_u64(tout)
    return jout, tout


BIG = (1 << 70) + 12345  # arbitrary-precision scalar
MASK = 0xF0F0F0F0F0F0F0F5  # high bit set: the int64 carrier's sign bit
CASES = {
    "add_nomod": (lambda r, a, b, c: r.add_nomod(a, b), 1),
    "sub_nomod": (lambda r, a, b, c: r.sub_nomod(a, b), 1),
    "mul_coeffs_montgomery_constant": (lambda r, a, b, c: r.mul_coeffs_montgomery_constant(a, b), 1),
    "mul_coeffs_montgomery_and_add_nomod":
        (lambda r, a, b, c: r.mul_coeffs_montgomery_and_add_nomod(a, b, c), 1),
    "mul_coeffs": (lambda r, a, b, c: r.mul_coeffs(a, b), 1),
    "mul_scalar": (lambda r, a, b, c: r.mul_scalar(a, BIG), 1),
    "mod_scalar": (lambda r, a, b, c: r.mod_scalar(a, (1 << 41) + 27), 4),
    "and_scalar": (lambda r, a, b, c: r.and_scalar(a, MASK), 4),
    "or_scalar": (lambda r, a, b, c: r.or_scalar(a, MASK), 4),
    "xor_scalar": (lambda r, a, b, c: r.xor_scalar(a, MASK), 4),
    "add_scalar": (lambda r, a, b, c: r.add_scalar(a, BIG), 1),
    "sub_scalar": (lambda r, a, b, c: r.sub_scalar(a, BIG), 1),
    "shift": (lambda r, a, b, c: r.shift(a, 3), 1),
    "mul_by_pow2": (lambda r, a, b, c: r.mul_by_pow2(a, 37), 1),
    "bit_reverse": (lambda r, a, b, c: r.bit_reverse(a), 1),
    "rotate": (lambda r, a, b, c: r.rotate(a, 5), 1),
    "mul_poly": (lambda r, a, b, c: r.mul_poly(a, b), 1),
    "mul_poly_naive": (lambda r, a, b, c: r.mul_poly_naive(a, b), 1),
}


@pytest.mark.parametrize("log_n", LOG_NS)
@pytest.mark.parametrize("name", list(CASES))
def test_ring_utility_matches_jax(name, log_n):
    call, below = CASES[name]
    jr, _ = rings(log_n)
    a, b, c = (residues(jr, 10 * log_n + k, below) for k in range(3))
    want, got = run_both(log_n, call, a, b, c)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("log_n", LOG_NS)
def test_mult_by_monomial_matches_jax(log_n):
    """Every branch: no shift, a shift below N, exactly N (a negation), above
    N, and the last degree 2N - 1; zeros stay zero when they wrap."""
    jr, _ = rings(log_n)
    n = jr.n
    a = residues(jr, 7)
    a[:, :: 3] = 0
    for degree in (0, 3, n, n + 5, 2 * n - 1, 2 * n + 1, -1):
        want, got = run_both(log_n, lambda r, x: r.mult_by_monomial(x, degree), a)
        np.testing.assert_array_equal(got, want, err_msg=f"degree {degree}")


@pytest.mark.parametrize("log_n", LOG_NS)
def test_mul_by_vector_montgomery_matches_jax(log_n):
    jr, _ = rings(log_n)
    a = residues(jr, 8)
    vec = np.random.default_rng(9).integers(0, min(jr.moduli), jr.n, dtype=np.uint64)
    want, got = run_both(log_n, lambda r, x: r.mul_by_vector_montgomery(x, vec), a)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("log_n", LOG_NS)
def test_exp_matches_jax(log_n):
    jr, _ = rings(log_n)
    a = residues(jr, 11)
    for e in (0, 1, 5, 12):
        want, got = run_both(log_n, lambda r, x: r.exp(x, e), a)
        np.testing.assert_array_equal(got, want, err_msg=f"e = {e}")


@pytest.mark.parametrize("log_n", LOG_NS)
def test_equal_matches_jax(log_n):
    jr, _ = rings(log_n)
    a = residues(jr, 12)
    b = a.copy()
    b[1, -1] = (int(b[1, -1]) + 1) % jr.moduli[1]
    lazy = a + np.array(jr.moduli, dtype=np.uint64)[:, None]  # same residues, not reduced
    for other, same in ((a, True), (lazy, True), (b, False)):
        want, got = run_both(log_n, lambda r, x, y: r.equal(x, y), a, other)
        assert got is want is same


@pytest.mark.parametrize("log_n", LOG_NS)
def test_mul_poly_equals_schoolbook(log_n):
    _, tr = rings(log_n)
    a, b = (tu.from_u64(residues(tr, 20 + k), "cpu") for k in range(2))
    assert torch.equal(tr.mul_poly(a, b), tr.mul_poly_naive(a, b))
    # the rotation twist table is cached per (level, rotation)
    assert tr._rotate_rows(1, 5) is tr._rotate_rows(1, 5)


def test_scalar_tables_are_cached():
    """A repeated scalar op copies nothing new from the host."""
    tr = TRing(256, rings(8)[1].moduli, device="cpu")  # an empty cache
    a = tu.from_u64(residues(tr, 30), "cpu")
    tr.mul_scalar(a, BIG)
    count = len(tr._op_cache)
    tr.mul_scalar(a, BIG)
    tr.mul_scalar(a[..., :1, :], BIG)
    assert len(tr._op_cache) == count + 1  # one more level, nothing else


def test_op_cache_is_bounded():
    """Scalars a caller chooses cannot grow a ring's table cache past
    OP_CACHE_SIZE; an evicted table is rebuilt to the same result."""
    tr = TRing(256, rings(8)[1].moduli, device="cpu")
    a = tu.from_u64(residues(tr, 31), "cpu")
    first = tr.mul_scalar(a, BIG)
    for k in range(OP_CACHE_SIZE + 8):
        tr.add_scalar(a, 1000 + k)
    assert len(tr._op_cache) == OP_CACHE_SIZE
    assert ("mul", BIG, 1) not in tr._op_cache  # the least recently used went first
    assert torch.equal(tr.mul_scalar(a, BIG), first)
