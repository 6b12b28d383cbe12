"""The port's basis extension, key-switch decomposition and t/Q scaler
against the JAX package's, bit for bit, on numpy-seeded inputs (integers,
tolerance 0).  The 58-bit fixed-point floor of ``mod_up`` has to match
exactly or results differ by multiples of Q."""

import jax
import numpy as np
import pytest
import torch

from lattigo_tpu.ops import basis_ext as jbx
from lattigo_tpu.ops import number_theory as nt
from lattigo_tpu.ops import scaling as jsc
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu.ops.ring import Ring as JRing
from lattigo_tpu_torch.ops import basis_ext as tbx
from lattigo_tpu_torch.ops import scaling as tsc
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.ops.ring import Ring as TRing

torch.set_num_threads(1)

LOG_N = 6
N = 1 << LOG_N
_pool = nt.generate_ntt_primes(55, LOG_N, 5)
Q_MODULI, P_MODULI = _pool[:3], _pool[3:]
Q60 = nt.generate_ntt_primes(60, LOG_N, 2)


def rand(moduli, batch, seed, edge=False):
    rng = np.random.default_rng(seed)
    x = np.empty((*batch, len(moduli), N), dtype=np.uint64)
    for i, q in enumerate(moduli):
        x[..., i, :] = rng.integers(0, q, size=(*batch, N), dtype=np.uint64)
        if edge:  # residues of tiny and of near-Q values sit at 0 and q - 1
            x[..., i, :4] = [0, 1, q - 1, q - 2]
    return x


def eq(got, want):
    np.testing.assert_array_equal(tu.to_u64(got), ju.to_u64(want))


def T(a):
    return tu.from_u64(a, "cpu")


@pytest.fixture(scope="module")
def ext():
    jq, jp = JRing(N, Q_MODULI), JRing(N, P_MODULI)
    tq, tp = TRing(N, Q_MODULI, device="cpu"), TRing(N, P_MODULI, device="cpu")
    return jbx.FastBasisExtender(jq, jp), tbx.FastBasisExtender(tq, tp)


@pytest.mark.parametrize("batch", [(), (2,), (3, 2)])
@pytest.mark.parametrize("dst_sel", [None, (1,), (2, 0)])
def test_mod_up(batch, dst_sel):
    dst = P_MODULI + Q60
    jmp = jbx.ModUpParams(Q_MODULI, dst)
    tmp = tbx.ModUpParams(Q_MODULI, dst, "cpu")
    x = rand(Q_MODULI, batch, seed=len(batch), edge=True)
    eq(tbx.mod_up(T(x), tmp, dst_sel), jbx.mod_up(ju.from_u64(x), jmp, dst_sel))


def test_mod_up_many_source_limbs():
    """More than 7 source limbs: the lazy accumulator is reduced on the way."""
    src = nt.generate_ntt_primes(50, LOG_N, 9)
    jmp, tmp = jbx.ModUpParams(src, Q60), tbx.ModUpParams(src, Q60, "cpu")
    x = rand(src, (2,), seed=9, edge=True)
    eq(tbx.mod_up(T(x), tmp), jbx.mod_up(ju.from_u64(x), jmp))


@pytest.mark.parametrize("batch", [(), (2,)])
def test_extender_up_and_down(ext, batch):
    jx, tx = ext
    xq = rand(Q_MODULI, batch, seed=11, edge=True)
    xp = rand(P_MODULI, batch, seed=12, edge=True)
    jq, jp, tq, tp = ju.from_u64(xq), ju.from_u64(xp), T(xq), T(xp)
    eq(tx.mod_up_qp(tq), jx.mod_up_qp(jq))
    eq(tx.mod_up_qp(tq[..., :2, :]), jx.mod_up_qp(ju.from_u64(xq[..., :2, :])))
    eq(tx.mod_up_pq(tp, 2), jx.mod_up_pq(jp, 2))
    eq(tx.mod_up_pq(tp, 0), jx.mod_up_pq(jp, 0))
    eq(tx.mod_down_split_pq(tq, tp), jx.mod_down_split_pq(jq, jp))
    eq(tx.mod_down_split_qp(tq, tp), jx.mod_down_split_qp(jq, jp))


# (#Q, #P): alpha divides #Q, does not divide it, and alpha = 1
@pytest.mark.parametrize("n_q,n_p", [(3, 2), (4, 2), (3, 1), (2, 3)])
def test_decompose_and_split(n_q, n_p):
    pool = nt.generate_ntt_primes(52, LOG_N, n_q + n_p)
    qs, ps = pool[:n_q], pool[n_q:]
    jd, td = jbx.Decomposer(qs, ps), tbx.Decomposer(qs, ps, "cpu")
    assert (td.beta, td.xalpha) == (jd.beta, jd.xalpha)
    for level in range(n_q):
        x = rand(qs[: level + 1], (2,), seed=100 + level, edge=True)
        for beta_idx in range(td.beta):
            if beta_idx * td.alpha > level:
                continue
            tq, tp = td.decompose_and_split(level, beta_idx, T(x))
            jq, jp = jd.decompose_and_split(level, beta_idx, ju.from_u64(x))
            eq(tq, jq)
            eq(tp, jp)


@pytest.mark.parametrize("t", [65537, 1 << 16, 257])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_simple_scaler(t, batch):
    jr, tr = JRing(N, Q_MODULI), TRing(N, Q_MODULI, device="cpu")
    js, ts = jsc.SimpleScaler(t, jr), tsc.SimpleScaler(t, tr)
    x = rand(Q_MODULI, batch, seed=t % 97, edge=True)
    for out_limbs in (1, 3):
        eq(ts.scale(T(x), out_limbs), js.scale(ju.from_u64(x), out_limbs))
    # carried limbs below the ring's
    eq(ts.scale(T(x[..., :2, :]), 1), js.scale(ju.from_u64(x[..., :2, :]), 1))


def test_scaler_is_exact_rounding():
    """round(t/Q * x) mod t against Python ints."""
    t = 65537
    tr = TRing(N, Q_MODULI, device="cpu")
    ts = tsc.SimpleScaler(t, tr)
    rng = np.random.default_rng(5)
    big_q = tr.modulus_bigint
    vals = [int.from_bytes(rng.bytes(24), "little") % big_q for _ in range(N)]
    got = tu.to_u64(ts.scale(tr.set_coeffs_bigint(vals), 1))[0]
    want = [((2 * t * v + big_q) // (2 * big_q)) % t for v in vals]
    np.testing.assert_array_equal(got, np.array(want, dtype=np.uint64))
