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
* The key switch's decomposition (``Decomposer.decompose`` -> the digit
  kernel of the same source) equals its plain version (each digit's
  ``decompose_and_split``, concatenated, stacked) at every level of a CKKS
  set with alpha = 3 and 7 Q moduli (full, partial and single-limb
  digits), batches ``[]`` and ``[2]``; ``rotate_hoisted`` is the same on
  both; one ``mul_relin`` launches it once, and BFV's relinearization
  never (its ``mod_up`` launches stay one a digit of two or more limbs).
* No fallback: a call whose launcher returns an error raises.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lattigo_tpu_torch import _build
from lattigo_tpu_torch.models import bfv as tbfv
from lattigo_tpu_torch.models import ckks as tckks
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
    """CPU tensors down the kernel paths of ``csrc/mod_up.cu``'s entries
    (``mod_up``, ``decompose``), launched by ``lib`` behind the seam."""
    monkeypatch.setattr(_build, "takes_kernel",
                        lambda name, *tensors: _build.source_of(name) == "mod_up")
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


# -- the decomposition ------------------------------------------------------------------

# alpha = 3, 7 Q moduli: digits of 3, 3 and 1 limbs at the top; below it
# partial digits of 2 limbs and single-limb digits at levels 0 and 3
CKKS_SPEC = dict(log_n=8, log_slots=7, scale=float(1 << 30), log_qi=(45,) + (30,) * 6,
                 log_pi=(45, 45, 45))


@pytest.fixture(scope="module")
def ckks_world():
    params = tckks.Parameters(**CKKS_SPEC).gen_from_log_moduli()
    kgen = tckks.KeyGenerator(params, device="cpu", seed=3)
    sk, pk = kgen.gen_key_pair()
    rot = tckks.RotationKeys()
    for k in (1, 2, 5):
        kgen.gen_rot("left", sk, k, rot)
    encryptor = tckks.Encryptor(params, pk=pk, device="cpu", seed=4)
    enc = tckks.Encoder(params, device="cpu")
    rng = np.random.default_rng(8)
    cts = [encryptor.encrypt(enc.encode(rng.uniform(-1, 1, params.slots)
                                        + 1j * rng.uniform(-1, 1, params.slots)))
           for _ in range(2)]
    return dict(params=params, rlk=kgen.gen_relin_key(sk), rot=rot, cts=cts,
                ev=tckks.Evaluator(params, device="cpu"))


def test_digit_kinds_of_the_set(ckks_world):
    """The set gives every kind of digit the kernel takes."""
    dec = tckks.Evaluator(ckks_world["params"], device="cpu").ctx.decomposer
    counts = {level: [dec.source_range(level, j)[1] for j in range(dec.beta_at(level))]
              for level in range(dec.n_q)}
    assert counts == {0: [1], 1: [2], 2: [3], 3: [3, 1], 4: [3, 2], 5: [3, 3], 6: [3, 3, 1]}


@pytest.mark.parametrize("batch", [(), (2,)])
def test_decomposition_equals_plain(on_host, ckks_world, batch):
    dec = ckks_world["ev"].ctx.decomposer
    rng = np.random.default_rng(len(batch))
    for level in range(dec.n_q):
        x = words(rng, (*batch, level + 1, 1 << CKKS_SPEC["log_n"]))
        before = _build.launch_counts()
        got = dec.decompose(level, x)
        after = _build.launch_counts()
        assert (after["decompose"], after["mod_up"]) == (before["decompose"] + 1,
                                                         before["mod_up"])
        want = dec.decompose_plain(level, x)
        assert got.shape == (*batch, dec.beta_at(level), level + 1 + dec.n_p, x.shape[-1])
        assert torch.equal(got, want), level


def test_rotate_hoisted_equals_plain(monkeypatch, on_host, ckks_world):
    ev, rot = ckks_world["ev"], ckks_world["rot"]
    ct = ckks_world["cts"][0]
    ct = ev.drop_level(ct, 2)  # a partial digit and a single-limb one
    got = ev.rotate_hoisted(ct, [0, 1, 2, 5], rot)
    monkeypatch.setattr(_build, "takes_kernel", lambda name, *tensors: False)
    want = ev.rotate_hoisted(ct, [0, 1, 2, 5], rot)
    assert sorted(got) == sorted(want) == [0, 1, 2, 5]
    for k in want:
        assert all(torch.equal(a, b) for a, b in zip(got[k].value, want[k].value, strict=True))


def test_one_decomposition_launch_a_mul_relin(on_host, ckks_world):
    """One launch of the digit kernel for every digit of a key switch, and
    the ModDown's two basis extensions."""
    ev, (ca, cb) = ckks_world["ev"], ckks_world["cts"]
    before = _build.launch_counts()
    ev.mul_relin(ca, cb, ckks_world["rlk"])
    after = _build.launch_counts()
    assert after["decompose"] - before["decompose"] == 1
    assert after["mod_up"] - before["mod_up"] == 2


def test_bfv_relinearization_keeps_its_mod_up_launches(on_host):
    """BFV decomposes through ``decompose_and_split``: one ``mod_up`` a
    digit of two or more source limbs (one here: digits of 2 and 1 limbs)
    and one each ModDown, none of the digit kernel."""
    params = tbfv.Parameters(log_n=8, t=65537, log_qi=(46, 46, 46), log_pi=(47, 47),
                             log_qi_mul=(60, 60, 60)).gen_from_log_moduli()
    kgen = tbfv.KeyGenerator(params, device="cpu", seed=1)
    sk, pk = kgen.gen_key_pair()
    ct = tbfv.Encryptor(params, pk=pk, device="cpu", seed=2).encrypt(
        tbfv.Encoder(params, device="cpu").encode_uint(np.arange(params.n) % params.t))
    ev = tbfv.Evaluator(params, device="cpu")
    ct2 = ev.mul(ct, ct)
    before = _build.launch_counts()
    ev.relinearize(ct2, kgen.gen_relin_key(sk))
    after = _build.launch_counts()
    assert after["decompose"] == before["decompose"]
    assert after["mod_up"] - before["mod_up"] == 3


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
