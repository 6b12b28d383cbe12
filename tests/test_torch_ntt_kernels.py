"""The plain versions of the port's two NTT kernels against the TPU kernels
they replace, run as the JAX package's own tests run them on the CPU
(Pallas interpret mode), bit for bit at N = 4096; the four-step plain version
at N = 8192 ... 32768 against the port's butterflies; the port's host tables
of the four-step kernel against the JAX package's, array by array, and their
device layout against the mma.sync fragment layout.  The CUDA kernels
themselves are held against these plain versions on the GPU by
chip_smoke.py.  Integers, tolerance 0."""

import jax
import numpy as np
import pytest
import torch

from lattigo_tpu.ops import mxu_ntt as jmxu
from lattigo_tpu.ops import number_theory as nt
from lattigo_tpu.ops import tile_ntt as jtile
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu.ops.ring import Ring as JRing
from lattigo_tpu_torch.ops import mxu_ntt as tmxu
from lattigo_tpu_torch.ops import ring as tring_mod
from lattigo_tpu_torch.ops import tile_ntt as ttile
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.ops.ring import Ring as TRing

torch.set_num_threads(1)

N = 4096
MODULI = nt.generate_ntt_primes(60, 12, 3)


@pytest.fixture(scope="module")
def rings():
    return JRing(N, MODULI), TRing(N, MODULI, device="cpu")


def rand(limbs, batch, seed, mult=1):
    rng = np.random.default_rng(seed)
    x = np.empty((*batch, len(limbs), N), dtype=np.uint64)
    for k, l in enumerate(limbs):
        x[..., k, :] = rng.integers(0, mult * MODULI[l], size=(*batch, N), dtype=np.uint64)
    return x


def T(a):
    return tu.from_u64(a, "cpu")


def jax_out(y):
    return ju.to_u64(jax.tree.map(np.asarray, y))


# (limbs, batch, lazy multiple, inverse)
TILE_CASES = [
    ((0, 1), (), 1, False),
    ((1, 2), (), 4, False),     # non-prefix limbs, lazily reduced below 4q
    ((0, 1), (), 2, True),      # lazily reduced inverse input
    ((1, 2), (), 1, True),
    ((0, 1), (3,), 2, False),   # batched
]


@pytest.mark.parametrize("limbs,batch,mult,inverse", TILE_CASES)
def test_row_plain_matches_tile_kernel(rings, limbs, batch, mult, inverse):
    jr, tr = rings
    x = rand(limbs, batch, seed=len(batch) + mult, mult=mult)
    want = jax_out(jtile.ntt_tile(jr, ju.from_u64(x), limbs, inverse=inverse, interpret=True))
    got = ttile.ntt_tile(tr, T(x), limbs, inverse=inverse)
    np.testing.assert_array_equal(tu.to_u64(got), want)


MXU_CASES = [
    ((0, 1), (3,), 1, False),
    ((0, 1), (3,), 1, True),
    ((0, 1), (3,), 4, False),   # lazy: x + 3q, below 2^62.1
    ((0, 1), (3,), 4, True),
    ((2, 0), (3,), 1, False),   # limb subset, out of order
    ((2,), (2,), 1, False),     # the key-switch P row
]


@pytest.mark.parametrize("limbs,batch,mult,inverse", MXU_CASES)
def test_fourstep_plain_matches_mxu_kernel(rings, limbs, batch, mult, inverse):
    jr, tr = rings
    x = rand(limbs, batch, seed=7 + mult + len(limbs))
    if mult > 1:
        x = x + np.uint64(mult - 1) * np.array([MODULI[l] for l in limbs], dtype=np.uint64)[:, None]
    want = jax_out(jmxu.ntt_mxu(jr, ju.from_u64(x), limbs, inverse=inverse, interpret=True,
                                block_polys=batch[0]))
    got = tmxu.ntt_mxu_plain(tr, T(x), limbs, inverse=inverse)
    np.testing.assert_array_equal(tu.to_u64(got), want)
    # and the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(tu.to_u64(tmxu.ntt_mxu(tr, T(x), limbs, inverse=inverse)), want)
    # the two plain versions agree with each other
    simple = tr._intt_simple(T(x), limbs) if inverse else tr._ntt_simple(T(x), limbs)
    np.testing.assert_array_equal(tu.to_u64(simple), want)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("limbs", [(0, 1), (2, 0)])
def test_fourstep_tables_equal(rings, limbs, inverse):
    jr, tr = rings
    want = jmxu._tables_host(jr, limbs, inverse)
    got = tmxu._tables_host(tr, limbs, inverse)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("kind", ["rows", "lanes"])
def test_fragment_layout_roundtrip(kind):
    """The device layout puts every entry where the m16n8k32 fragment of
    its lane reads it, and reads back to the kernel's contraction order."""
    rng = np.random.default_rng(5)
    n1 = 32
    side = 8 * (n1 if kind == "rows" else 128)
    op = rng.integers(-128, 128, size=(side, side), dtype=np.int8)  # JAX format
    if kind == "rows":  # [(e, a), (d, b)] -> [(e, a), (b, d)]
        want = op.reshape(8, n1, 8, n1).transpose(0, 1, 3, 2).reshape(side, side)
        flat = tmxu.rows_layout(op)
        back = tmxu.rows_matrix(flat, n1)
        # [at][ks][e][lane][reg = 2 kh + h][byte]: A[g + 8 h, 16 kh + 4 t + byte]
        at, ks, e, lane, reg, byte = np.indices((n1 // 16, n1 // 4, 8, 32, 4, 4))
        g, t, h, kh = lane >> 2, lane & 3, reg & 1, reg >> 1
        ref = want[e * n1 + 16 * at + g + 8 * h, 32 * ks + 16 * kh + 4 * t + byte]
    else:  # [(d, j2), (e, c)] -> [(j2, d), (e, c)]
        want = op.reshape(8, 128, 8, 128).transpose(1, 0, 2, 3).reshape(side, side)
        flat = tmxu.lanes_layout(op)
        back = tmxu.lanes_matrix(flat)
        # [ct][ks][ep][lane][elo][kh][byte]: B[16 kh + 4 t + byte, c = 8 ct + g] of plane 2 ep + elo
        ct, ks, ep, lane, elo, kh, byte = np.indices((16, 32, 4, 32, 2, 2, 4))
        g, t = lane >> 2, lane & 3
        ref = want[32 * ks + 16 * kh + 4 * t + byte, (2 * ep + elo) * 128 + 8 * ct + g]
    np.testing.assert_array_equal(flat.numpy(), ref.reshape(-1))
    np.testing.assert_array_equal(back.numpy(), want)


@pytest.mark.parametrize("log_n", [13, 14, 15])
def test_fourstep_plain_matches_butterflies_large_n(log_n):
    """n1 = 64, 128, 256 at 60-bit primes, inputs lazily reduced up to
    2^62 - 1, both directions, against the port's butterflies (held against
    the JAX package by tests/test_torch_ring.py) on the inputs mod q."""
    n = 1 << log_n
    moduli = nt.generate_ntt_primes(60, log_n, 2)
    ring = TRing(n, moduli, device="cpu")
    limbs = (1, 0)
    x = np.random.default_rng(log_n).integers(0, 2**62, size=(2, 2, n), dtype=np.uint64)
    xq = x % np.array([moduli[l] for l in limbs], dtype=np.uint64)[:, None]
    got = tmxu.ntt_mxu_plain(ring, T(x), limbs)
    np.testing.assert_array_equal(tu.to_u64(got), tu.to_u64(ring._ntt_simple(T(xq), limbs)))
    got = tmxu.ntt_mxu_plain(ring, T(x), limbs, inverse=True)
    np.testing.assert_array_equal(tu.to_u64(got), tu.to_u64(ring._intt_simple(T(xq), limbs)))


def test_fourstep_variants_apply_to_the_kernel_source():
    """Every diagnostic variant of lattigo_tpu_torch/tools/fourstep_variants.py
    still finds the text it replaces in csrc/ntt_fourstep.cu."""
    import os

    from lattigo_tpu_torch import _build
    from lattigo_tpu_torch.tools import fourstep_variants as fv

    src = open(os.path.join(_build.CSRC, "ntt_fourstep.cu")).read()
    assert fv.VARIANTS["kernel"] == []
    for name, subs in fv.VARIANTS.items():
        for old, new in subs:
            assert src.count(old) >= 1 and old != new, (name, old)


def test_supported_sizes():
    for n in (2048, 4096, 8192, 16384, 32768, 65536, 12288):
        assert tmxu.supported(n) == jmxu.supported(n)


def test_dispatch_routes(rings, monkeypatch):
    """Stacked calls go to the four-step wrapper, single polys to the row
    wrapper, and FORCE_KERNEL overrides both; every route gives the same bits."""
    _, tr = rings
    seen = []
    real_mxu, real_tile = tmxu.ntt_mxu, ttile.ntt_tile
    monkeypatch.setattr(tmxu, "ntt_mxu", lambda *a, **k: seen.append("mxu") or real_mxu(*a, **k))
    monkeypatch.setattr(ttile, "ntt_tile", lambda *a, **k: seen.append("tile") or real_tile(*a, **k))
    x1, x2 = T(rand((0, 1, 2), (), seed=1)), T(rand((0, 1, 2), (2,), seed=2))
    y1, y2 = tr.ntt(x1), tr.ntt(x2)
    assert seen == ["tile", "mxu"]
    tr.intt(y1), tr.intt(y2)
    assert seen == ["tile", "mxu", "tile", "mxu"]
    for force, want in (("tile", "tile"), ("mxu", "mxu"), ("plain", None)):
        monkeypatch.setattr(tring_mod, "FORCE_KERNEL", force)
        del seen[:]
        assert torch.equal(tr.ntt(x2), y2) and torch.equal(tr.intt(y2), x2)
        assert seen == ([want, want] if want else [])
    small = TRing(256, nt.generate_ntt_primes(46, 8, 2), device="cpu")
    monkeypatch.setattr(tring_mod, "FORCE_KERNEL", None)
    del seen[:]
    small.ntt(torch.zeros((3, 2, 256), dtype=torch.int64))
    assert seen == ["tile"]  # below N = 4096 everything is the row kernel's


def test_wrappers_reject_what_they_do_not_take(rings):
    _, tr = rings
    with pytest.raises(ValueError):
        ttile.ntt_tile(tr, T(rand((0, 1), (), seed=3)), (0, 1, 2))
    with pytest.raises(ValueError):
        tmxu.ntt_mxu(tr, T(rand((0, 1), (2,), seed=3)), (0,))
    with pytest.raises(ValueError):
        tmxu.ntt_mxu_plain(TRing(2048, nt.generate_ntt_primes(50, 11, 1), device="cpu"),
                           torch.zeros((2, 1, 2048), dtype=torch.int64), (0,))
    assert ttile.ntt_tile.launches == 0 and tmxu.ntt_mxu.launches == 0  # no GPU here: no launch
