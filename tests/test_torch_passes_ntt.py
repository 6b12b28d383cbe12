"""The plain version of the port's long-row NTT kernel (``csrc/ntt_passes.cu``,
one thread-block cluster a row) against the TPU kernel it replaces, run as
the JAX package's own tests run it on the CPU (Pallas interpret mode), and
against the JAX package's butterfly schedule under ``jax.jit``, over every
column/chunk split; the launch plan the wrapper passes to the kernel; and
the routing that sends transforms to it.  The CUDA kernel itself is held
against this plain version on the GPU by chip_smoke.py.  Integers,
tolerance 0."""

import jax
import numpy as np
import pytest
import torch

from lattigo_tpu.ops import number_theory as nt
from lattigo_tpu.ops import pallas_ntt as jpallas
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu.ops.ring import Ring as JRing
from lattigo_tpu_torch.ops import mxu_ntt as tmxu
from lattigo_tpu_torch.ops import pallas_ntt as tpallas
from lattigo_tpu_torch.ops import ring as tring_mod
from lattigo_tpu_torch.ops import tile_ntt as ttile
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.ops.ring import Ring as TRing

torch.set_num_threads(1)


def rand(moduli, limbs, batch, n, seed, mult):
    """Residues below mult * q of each limb row, from a numpy seed."""
    rng = np.random.default_rng(seed)
    x = np.empty((*batch, len(limbs), n), dtype=np.uint64)
    for k, l in enumerate(limbs):
        x[..., k, :] = rng.integers(0, mult * moduli[l], size=(*batch, n), dtype=np.uint64)
    return x


def T(a):
    return tu.from_u64(a, "cpu")


def jax_out(y):
    return ju.to_u64(jax.tree.map(np.asarray, y))


@pytest.fixture(scope="module")
def rings_1024():
    moduli = nt.generate_ntt_primes(60, 10, 2)
    return moduli, JRing(1024, moduli), TRing(1024, moduli, device="cpu")


@pytest.mark.parametrize("inverse", [False, True])
def test_plain_matches_pallas_passes_kernel(rings_1024, inverse):
    """The TPU kernel in interpret mode, 128 lanes, row blocks of 1024."""
    moduli, jr, tr = rings_1024
    limbs = (0, 1)
    x = rand(moduli, limbs, (3,), 1024, seed=5 + inverse, mult=4)
    want = jax_out(jpallas.ntt_pallas_passes(jr, ju.from_u64(x), limbs, inverse=inverse,
                                             interpret=True, lanes=128, min_rows=1024))
    got = tpallas.ntt_passes_plain(tr, T(x), limbs, inverse)
    np.testing.assert_array_equal(tu.to_u64(got), want)
    # the wrapper takes the plain version for a CPU tensor, and launches nothing
    np.testing.assert_array_equal(tu.to_u64(tpallas.ntt_passes(tr, T(x), limbs, inverse)), want)
    assert tpallas.ntt_passes.launches == 0


# (log N, prime bits, limbs, batch): every N from 2^10 to 2^13, 39/45/55/60-bit
# primes, prefix and non-prefix limbs, batch 1 and 3
SIMPLE_CASES = [
    (10, 60, (0, 1), (3,)),
    (11, 39, (2, 0), (1,)),
    (12, 45, (1,), (3,)),
    (13, 55, (0, 1, 2), (1,)),
]


@pytest.mark.parametrize("log_n,bits,limbs,batch", SIMPLE_CASES)
def test_plain_matches_butterfly_schedule_every_split(log_n, bits, limbs, batch):
    """Forward (inputs below 4q) and inverse (below 2q, the JAX schedule's
    domain at 60 bits) at every split k = 1..4."""
    n = 1 << log_n
    moduli = nt.generate_ntt_primes(bits, log_n, 3)
    jr, tr = JRing(n, moduli), TRing(n, moduli, device="cpu")
    xf = rand(moduli, limbs, batch, n, seed=log_n, mult=4)
    xi = rand(moduli, limbs, batch, n, seed=log_n + 1, mult=2)
    want_f = jax_out(jax.jit(lambda a: jr._ntt_simple(a, limbs))(ju.from_u64(xf)))
    want_i = jax_out(jax.jit(lambda a: jr._intt_simple(a, limbs))(ju.from_u64(xi)))
    for k in range(1, tpallas.MAX_SPLIT + 1):
        got_f = tpallas.ntt_passes_plain(tr, T(xf), limbs, False, k)
        got_i = tpallas.ntt_passes_plain(tr, T(xi), limbs, True, k)
        np.testing.assert_array_equal(tu.to_u64(got_f), want_f, err_msg=f"forward k={k}")
        np.testing.assert_array_equal(tu.to_u64(got_i), want_i, err_msg=f"inverse k={k}")


def test_default_split():
    """Chunks of at most 8192 coefficients (64 KB of shared memory) up to
    N = 65536; at N = 2^17 a cluster of 8 (the portable most) holds chunks of
    16384."""
    assert [tpallas.split(1 << e) for e in range(10, 18)] == [1, 1, 1, 1, 1, 2, 3, 3]


@pytest.mark.parametrize("log_n", range(10, 18))
def test_launch_plan(log_n):
    """The plan the wrapper passes to the kernel for every N it takes: a
    cluster of 2^k blocks holds one row, within the portable cluster size
    and a block's shared memory, and the columns split evenly over a
    block's threads."""
    n = 1 << log_n
    plan = tpallas.launch_plan(n)
    assert plan.cluster == 1 << plan.k and plan.k == tpallas.split(n)
    assert plan.cluster * plan.chunk == n
    assert 2 <= plan.cluster <= tpallas.MAX_CLUSTER == 8  # no non-portable cluster size
    assert plan.smem_bytes == 8 * plan.chunk <= 227 * 1024  # a block's most on the H100
    assert plan.chunk <= 8192 or n > 65536
    assert 32 <= plan.threads <= min(512, plan.chunk // 2) and plan.threads % 32 == 0
    assert (plan.chunk // plan.cluster) % plan.threads == 0  # columns per thread
    ring = TRing(n, nt.generate_ntt_primes(60, log_n, 2), device="cpu")
    x = torch.zeros((3, 2, n), dtype=torch.int64)
    args = tpallas._launch_args(ring, x, x, (1, 0), inverse=True)
    assert args[6:] == (3 * 2, 2, log_n, plan.k, plan.threads, plan.smem_bytes, 1)
    assert len(args) + 1 == len(tpallas._library_argtypes())


@pytest.mark.parametrize("log_n", [15, 16, 17])
def test_plain_default_split_matches_butterflies_long_rows(log_n):
    """Clusters of 4 and 8 (the default split at N = 2^15 .. 2^17), both
    directions, 60-bit primes, against the JAX butterflies."""
    n = 1 << log_n
    moduli = nt.generate_ntt_primes(60, log_n, 2)
    jr, tr = JRing(n, moduli), TRing(n, moduli, device="cpu")
    limbs = (1,)
    xf = rand(moduli, limbs, (1,), n, seed=log_n, mult=4)
    xi = rand(moduli, limbs, (1,), n, seed=log_n + 1, mult=2)
    want_f = jax_out(jax.jit(lambda a: jr._ntt_simple(a, limbs))(ju.from_u64(xf)))
    want_i = jax_out(jax.jit(lambda a: jr._intt_simple(a, limbs))(ju.from_u64(xi)))
    np.testing.assert_array_equal(tu.to_u64(tpallas.ntt_passes(tr, T(xf), limbs)), want_f)
    np.testing.assert_array_equal(tu.to_u64(tpallas.ntt_passes(tr, T(xi), limbs, True)), want_i)


@pytest.mark.parametrize("n,batch,route", [
    (32768, (), "passes"), (32768, (1,), "passes"), (65536, (), "passes"),
    (65536, (72,), "passes"), (65536, (8, 9), "passes"), (131072, (3,), "passes"),
    (32768, (2,), "mxu"), (32768, (8, 9), "mxu"),
    (16384, (), "tile"), (16384, (16,), "mxu"), (4096, (), "tile"), (4096, (2,), "mxu"),
    (2048, (5,), "tile"),
])
def test_routes(n, batch, route):
    """The row kernel holds N <= 16384; above it the four-step kernel takes
    the stacked calls it supports and the long-row kernel everything else."""
    ring = TRing(n, nt.generate_ntt_primes(50, n.bit_length() - 1, 1), compute_ntt_tables=False,
                 device="cpu")
    assert ring._route(torch.empty((*batch, 1, n), dtype=torch.int64, device="meta")) == route


def test_dispatch_reaches_passes_wrapper(monkeypatch):
    """FORCE_KERNEL = "passes" sends ntt / intt to the long-row wrapper,
    whose plain version gives the butterfly schedule's bits."""
    moduli = nt.generate_ntt_primes(55, 11, 3)
    tr = TRing(2048, moduli, device="cpu")
    seen = []
    real = tpallas.ntt_passes
    monkeypatch.setattr(tpallas, "ntt_passes", lambda *a, **k: seen.append("passes") or real(*a, **k))
    monkeypatch.setattr(tring_mod, "FORCE_KERNEL", "passes")
    x = T(rand(moduli, (0, 1, 2), (2,), 2048, seed=9, mult=1))
    y = tr.ntt(x)
    assert torch.equal(tr.intt(y), x) and seen == ["passes", "passes"]
    assert torch.equal(y, tr._ntt_simple(x, (0, 1, 2)))


def test_wrapper_rejects_what_it_does_not_take():
    moduli = nt.generate_ntt_primes(50, 10, 2)
    tr = TRing(1024, moduli, device="cpu")
    x = T(rand(moduli, (0, 1), (), 1024, seed=3, mult=1))
    with pytest.raises(ValueError):
        tpallas.ntt_passes(tr, x, (0, 1, 1))  # limb count
    with pytest.raises(ValueError):
        tpallas.ntt_passes(tr, x[..., :1, :], (2,))  # no such limb
    with pytest.raises(ValueError):
        tpallas.ntt_passes_plain(tr, x, (0, 1), k=5)  # more column stages than the kernel unrolls
    assert tpallas.ntt_passes.launches == 0
    assert ttile.ntt_tile.launches == 0 and tmxu.ntt_mxu.launches == 0


def test_passes_variants_apply_to_the_kernel_source():
    """Every diagnostic variant of lattigo_tpu_torch/tools/passes_variants.py
    still finds the text it replaces in csrc/ntt_passes.cu."""
    import os

    from lattigo_tpu_torch import _build
    from lattigo_tpu_torch.tools import passes_variants as pv

    src = open(os.path.join(_build.CSRC, "ntt_passes.cu")).read()
    assert pv.VARIANTS["kernel"] == []
    for name, subs in pv.VARIANTS.items():
        for old, new in subs:
            assert src.count(old) >= 1 and old != new, (name, old)
