"""The port's CRP stream against the JAX package's, byte for byte.

Same key, same seed, several polynomials in a row and after ``set_clock``:
the port's ``CRPGenerator`` must give the JAX package's polynomials and
clock exactly (integers, tolerance 0); its vectorised walk must equal the
literal one-word-at-a-time loop, and the C walk the NumPy walk, also when
the word stream runs dry.
"""

import numpy as np
import pytest
import torch

from lattigo_tpu.models import bfv as jbfv
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu.ops.ring import Ring as JRing
from lattigo_tpu.utils import prng as jprng
from lattigo_tpu_torch import native
from lattigo_tpu_torch.models import bfv as tbfv
from lattigo_tpu_torch.ops import number_theory as nt
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.ops.ring import Ring as TRing
from lattigo_tpu_torch.utils import prng as tprng

torch.set_num_threads(1)

SPEC = dict(log_n=8, t=65537, log_qi=(46, 46), log_pi=(47,), log_qi_mul=(60, 60))


def mixed_moduli():
    """One modulus just below and one just above a power of two: low and
    about 50 % rejection rates, both regimes of the walk."""
    return nt.generate_ntt_primes(59, 8, 2) + nt.generate_ntt_primes(60, 8, 1)


def ring_pair(kind: str):
    if kind == "mixed":
        qs = mixed_moduli()
    else:  # the QP ring of the dBFV tests' set
        p = jbfv.Parameters(**SPEC).gen_from_log_moduli()
        qs = list(p.qi) + list(p.pi)
    return JRing(256, qs, compute_ntt_tables=False), TRing(256, qs, compute_ntt_tables=False, device="cpu")


def test_prng_digests_match_jax():
    a, b = jprng.PRNG(b"key"), tprng.PRNG(b"key")
    for g in (a, b):
        g.seed(b"seed")
    assert [a.clock() for _ in range(5)] == [b.clock() for _ in range(5)]
    a.set_clock(9)
    b.set_clock(9)
    assert a.clock() == b.clock() and a.clock_cycle == b.clock_cycle == 10
    assert a.get_seed() == b.get_seed() == b"seed"
    with pytest.raises(ValueError):
        b.set_clock(3)


@pytest.mark.parametrize("kind", ["mixed", "bfv_qp"])
def test_crp_stream_matches_jax(kind):
    """Several polynomials in a row, then a jump of the clock, then more."""
    jr, tr = ring_pair(kind)
    j, t = jprng.CRPGenerator(b"key", jr), tprng.CRPGenerator(b"key", tr)
    for g in (j, t):
        g.seed(b"seed")
    for step in range(5):
        if step == 3:
            target = j.get_clock() + 17
            j.set_clock(target)
            t.set_clock(target)
        want, got = ju.to_u64(j.clock_poly()), tu.to_u64(t.clock_poly())
        assert got.shape == (tr.L, tr.n)
        np.testing.assert_array_equal(got, want, err_msg=f"polynomial {step}")
        assert t.get_clock() == j.get_clock()
    assert (got < np.array(tr.moduli, dtype=np.uint64)[:, None]).all()


def test_clock_poly_matches_scalar_loop():
    _, tr = ring_pair("mixed")
    a, b = tprng.CRPGenerator(b"key", tr), tprng.CRPGenerator(b"key", tr)
    for g in (a, b):
        g.seed(b"seed")
    for _ in range(3):
        assert torch.equal(a.clock_poly(), b.clock_poly_scalar())
        assert a.get_clock() == b.get_clock()


def test_clock_polys_stacks_consecutive_polynomials():
    """The beta-stacked CRP is the next ``count`` polynomials of the stream."""
    _, tr = ring_pair("bfv_qp")
    a, b = tprng.CRPGenerator(b"k", tr), tprng.CRPGenerator(b"k", tr)
    for g in (a, b):
        g.seed(b"s")
    stacked = a.clock_polys(3)
    assert stacked.shape == (3, tr.L, tr.n) and stacked.device == tr.device
    assert torch.equal(stacked, torch.stack([b.clock_poly() for _ in range(3)]))
    assert a.get_clock() == b.get_clock()


def _walk_inputs(seed: int, count: int):
    _, tr = ring_pair("mixed")
    masks = np.array(tr.mask, dtype=np.uint64)
    qs = np.array(tr.moduli, dtype=np.uint64)
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 63, size=count, dtype=np.uint64) * np.uint64(2)
    words += rng.integers(0, 2, count).astype(np.uint64)
    return tr, words, masks, qs


def test_c_walk_matches_numpy_walk():
    tr, words, masks, qs = _walk_inputs(0, 4096)
    out_np = np.zeros((tr.L, tr.n), dtype=np.uint64)
    k_np = tprng._walk_numpy(words, masks, qs, tr.L, tr.n, out_np)
    assert k_np > 0
    if native.crp_walk_lib() is None:
        pytest.fail("no C compiler: the C walk was not built")
    out_c = np.zeros((tr.L, tr.n), dtype=np.uint64)
    assert tprng._walk(words, masks, qs, tr.L, tr.n, out_c) == k_np
    np.testing.assert_array_equal(out_np, out_c)
    # and the JAX package's NumPy walk gives the same words
    out_j = np.zeros((tr.L, tr.n), dtype=np.uint64)
    assert jprng._walk_numpy(words, masks, qs, tr.L, tr.n, out_j) == k_np
    np.testing.assert_array_equal(out_j, out_c)


def test_walks_report_a_dry_stream():
    """A stream too short gives -1 on both walks, at the start and part way."""
    tr, words, masks, qs = _walk_inputs(1, 300)
    for w in (np.zeros(10, dtype=np.uint64), words):
        for walk in (tprng._walk_numpy, tprng._walk):
            out = np.zeros((tr.L, tr.n), dtype=np.uint64)
            assert walk(w, masks, qs, tr.L, tr.n, out) == -1


def test_clock_poly_grows_a_dry_stream(monkeypatch):
    """When the first batch of digests runs dry, clock_poly fetches more and
    still commits exactly the consumed digests to the chain."""
    _, tr = ring_pair("mixed")
    real = tprng._walk
    calls = []

    def dry_once(words, *args):
        calls.append(len(words))
        return -1 if len(calls) == 1 else real(words, *args)

    a, b = tprng.CRPGenerator(b"key", tr), tprng.CRPGenerator(b"key", tr)
    for g in (a, b):
        g.seed(b"seed")
    monkeypatch.setattr(tprng, "_walk", dry_once)
    first = a.clock_poly()
    monkeypatch.setattr(tprng, "_walk", real)
    assert len(calls) == 2 and calls[1] > calls[0]
    assert torch.equal(first, b.clock_poly_scalar())
    assert torch.equal(a.clock_poly(), b.clock_poly_scalar())


def test_numpy_walk_serves_without_a_compiler(monkeypatch):
    jr, tr = ring_pair("bfv_qp")
    monkeypatch.setattr(native, "crp_walk_lib", lambda: None)
    assert native.walk_route() == "numpy"
    j, t = jprng.CRPGenerator(b"key", jr), tprng.CRPGenerator(b"key", tr)
    for g in (j, t):
        g.seed(b"seed")
    np.testing.assert_array_equal(tu.to_u64(t.clock_poly()), ju.to_u64(j.clock_poly()))


def test_crp_lands_on_the_ring_device():
    params = tbfv.Parameters(**SPEC).gen_from_log_moduli()
    ring = tbfv.get_context(params, "cpu").ring_qp
    g = tprng.CRPGenerator(b"k", ring)
    g.seed(b"s")
    x = g.clock_poly()
    assert x.dtype == torch.int64 and x.device == ring.device and x.shape == (ring.L, ring.n)
