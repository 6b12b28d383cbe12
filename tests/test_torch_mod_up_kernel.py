"""The fast basis extension kernel (``basis_ext.mod_up`` ->
``csrc/mod_up.cu``) on the CPU, where the kernel cannot run.  Integers:
tolerance 0.

* The packed tables and the index vector the kernel reads equal
  ``ModUpParams``' own tables, for no selection, a ``range`` and a list.
* The kernel's own column routine (``mod_up_column``, built with the host
  C++ compiler by ``tools/host_build``) behind the real wrapper equals
  ``mod_up_plain``: centered or not, every kind of selection, 1 to 9
  source limbs (past the reduction every 7 terms), the layouts the call
  sites give (a batch, a slice of source limbs, a limb expanded with
  stride 0), inputs up to 2^64 - 1; and at the sets of the port's tests
  through ``FastBasisExtender`` and ``Decomposer``.
* No fallback: a call whose launcher returns an error raises.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lattigo_tpu_torch import _build
from lattigo_tpu_torch.models import bfv as tbfv
from lattigo_tpu_torch.models.bfv.context import get_context
from lattigo_tpu_torch.ops import basis_ext
from lattigo_tpu_torch.ops import number_theory as nt
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.tools import host_build

torch.set_num_threads(1)

N = 16
PRIMES = nt.generate_ntt_primes(50, 4, 12) + nt.generate_ntt_primes(60, 4, 4)
SPEC = dict(log_n=8, t=65537, log_qi=(46, 46), log_pi=(47,), log_qi_mul=(60, 60))


def col(t: torch.Tensor) -> np.ndarray:
    return tu.to_u64(t).ravel()


def words(rng, shape) -> torch.Tensor:
    """Random 64-bit words, the first four 0, 2^63, 2^64 - 1 and 1."""
    x = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    x.reshape(-1)[:4] = [0, 1 << 63, (1 << 64) - 1, 1]
    return tu.from_u64(x, "cpu")


def down_the_kernel_path(monkeypatch, lib) -> None:
    """CPU tensors down ``mod_up``'s kernel path, launched by ``lib``
    behind the seam."""
    monkeypatch.setattr(_build, "takes_kernel", lambda name, *tensors: name == "mod_up")
    monkeypatch.setitem(_build.LIBRARIES, "mod_up", lib)


@pytest.fixture()
def on_host(monkeypatch):
    """The host build of csrc/mod_up.cu behind the real wrapper."""
    down_the_kernel_path(monkeypatch, host_build.load("mod_up"))


# -- the packed tables ----------------------------------------------------------------


@pytest.mark.parametrize("dst_sel", [None, range(1, 4), [4, 0, 2]])
def test_packed_tables_equal_the_params(dst_sel):
    mp = basis_ext.ModUpParams(PRIMES[:3], PRIMES[3:8], "cpu")
    ls, ld = 3, 5
    packed = tu.to_u64(mp.packed_)
    assert packed.shape == (5 * ls + 5 * ld + ls * ld,)
    src, dst, tab = np.split(packed, [5 * ls, 5 * ls + 5 * ld])
    for row, t in zip(src.reshape(5, ls), (mp.qib_mont_, mp.m_lo_, mp.m_hi_, mp.sq_, mp.sqinv_)):
        np.testing.assert_array_equal(row, col(t))
    for row, t in zip(dst.reshape(5, ld), (mp.dp_, mp.dpinv_, mp.dp_u0_, mp.negq_mont_,
                                           mp.negq_plain_)):
        np.testing.assert_array_equal(row, col(t))
    np.testing.assert_array_equal(tab.reshape(ls, ld), tu.to_u64(mp.qispj_mont_)[..., 0])
    sel = mp.sel_vector(dst_sel)
    assert sel.dtype == torch.int32
    assert sel.tolist() == list(range(ld) if dst_sel is None else dst_sel)
    assert mp.sel_vector(dst_sel) is sel  # cached: no host copy on a later call
    with pytest.raises(IndexError):
        mp.sel_vector([ld])


# -- the kernel's column routine ------------------------------------------------------


@pytest.mark.parametrize("ls", [1, 2, 7, 9])
@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("dst_sel", [None, "range", "list"])
def test_column_routine_equals_plain(on_host, ls, centered, dst_sel):
    mp = basis_ext.ModUpParams(PRIMES[:ls], PRIMES[ls : ls + 6], "cpu")
    sel = {None: None, "range": range(2, 5), "list": [5, 1, 3]}[dst_sel]
    rng = np.random.default_rng(ls * 10 + centered)
    for x in (words(rng, (ls, N)), words(rng, (2, 3, ls, N)),
              words(rng, (2, ls + 3, N))[:, 2 : 2 + ls, :],  # a slice of source limbs
              words(rng, (3, 1, N)).expand(3, ls, N)):        # stride 0 on the limb dim
        before = _build.launch_counts()["mod_up"]
        got = basis_ext.mod_up(x, mp, sel, centered=centered)
        assert _build.launch_counts()["mod_up"] == before + 1
        assert torch.equal(got, basis_ext.mod_up_plain(x, mp, sel, centered=centered))


def test_extender_and_decomposer_on_the_kernel(on_host):
    """The log N = 8 BFV set's ModUp Q -> QMul and QMul -> Q and every
    decomposition block of two or more source limbs, kernel against
    plain, on ring residues."""
    ctx = get_context(tbfv.Parameters(**SPEC).gen_from_log_moduli(), "cpu")
    rng = np.random.default_rng(5)

    def residues(ring, batch):
        return tu.from_u64(np.stack([rng.integers(0, q, size=(*batch, ring.n), dtype=np.uint64)
                                     for q in ring.moduli], axis=-2), "cpu")

    bx, rq, rm = ctx.basis_q_qmul, ctx.ring_q, ctx.ring_qmul
    xq, xm = residues(rq, (3,)), residues(rm, (3,))
    for params, x, sel in ((bx.params_qp, xq, None), (bx.params_pq, xm, range(rq.L))):
        assert torch.equal(basis_ext.mod_up(x, params, sel),
                           basis_ext.mod_up_plain(x, params, sel))
    dec = ctx.decomposer
    for beta in range(dec.beta):
        start, count = dec.source_range(rq.L - 1, beta)
        if count < 2:
            continue
        params = dec._mod_up_params(rq.L - 1, beta, count - 2)
        src = xq[..., start : start + count, :]
        assert torch.equal(basis_ext.mod_up(src, params), basis_ext.mod_up_plain(src, params))


# -- no fallback -----------------------------------------------------------------


class _FailingLib:
    def __init__(self, err):
        self.err = err

    def mod_up_launch(self, *args):
        return self.err


@pytest.mark.parametrize("err", [700, -2])
def test_a_failed_launch_raises(monkeypatch, err):
    down_the_kernel_path(monkeypatch, _FailingLib(err))
    mp = basis_ext.ModUpParams(PRIMES[:2], PRIMES[2:4], "cpu")
    before = _build.launch_counts()["mod_up"]
    with pytest.raises(RuntimeError, match="mod_up_launch"):
        basis_ext.mod_up(words(np.random.default_rng(0), (2, N)), mp)
    assert _build.launch_counts()["mod_up"] == before


def test_other_devices_raise():
    """Neither the CPU nor a card (the seam's device rule: ValueError), or
    not int64 on a card (TypeError): no plain fallback."""
    mp = basis_ext.ModUpParams(PRIMES[:2], PRIMES[2:4], "cpu")
    with pytest.raises(ValueError, match="one device"):
        basis_ext.mod_up(torch.zeros((2, N), dtype=torch.int64, device="meta"), mp)
    on_a_card = SimpleNamespace(device=torch.device("cuda", 0), dtype=torch.int32)
    with pytest.raises(TypeError, match="int64"):
        _build.takes_kernel("mod_up", on_a_card)
