"""The elementwise modular pass (``ops/modred_kernel.py`` -> ``csrc/modred.cu``)
on the CPU, where the kernel cannot run.  Integers: tolerance 0.

* The op table agrees with the source's ``enum Op`` and ``enum Slot``.
* The source's own arithmetic (``apply<OP>`` of ``csrc/modred.cu``, built
  with the host C++ compiler by ``tools/host_build``) equals the plain
  version for every op code on edge words and random 64-bit words.
* The launch plan: every operand's ``(tensor, [B, L, N] strides)``, read
  back with ``torch.as_strided`` through the plain op, equals torch's own
  broadcasting, for every layout the call sites give (hypothesis over
  shapes), with the copies counted.
* Routing: with CPU tensors sent down the kernel path (``_build``'s device
  rule set aside) and a recorder behind the seam, a library whose entries
  run the plain op on what the kernels would read (the operand table's
  pointers and strides, ``mod_up``'s packed tables), the port's ``entry``
  forward at log N = 8 equals the JAX package's forward bit for bit, and no
  ``modred.*`` or ``mod_up_plain`` call is left on that path outside the
  NTT plain versions; the same with both kernels' sources, built for the
  host, behind the real wrappers.
* No fallback: a call whose launcher returns an error raises.
"""

import ctypes
import re
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from lattigo_tpu.models import bfv as jbfv
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu_torch import _build, convert
from lattigo_tpu_torch.entry import entry
from lattigo_tpu_torch.models import bfv as tbfv
from lattigo_tpu_torch.ops import basis_ext, modred
from lattigo_tpu_torch.ops import modred_kernel as mk
from lattigo_tpu_torch.ops import number_theory as nt
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.tools import host_build

torch.set_num_threads(1)

Q = nt.generate_ntt_primes(55, 8, 1)[0]
BRED = nt.bred_params(Q)
CONSTS = dict(q=Q, qinv=nt.mred_params(Q), u0=BRED[0], u1=BRED[1])
EDGE = [0, 1, Q - 1, Q, 2 * Q - 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
NAME_OF = {code: name for name, (code, _, _) in mk.OPS.items()}


def words(rng, shape) -> torch.Tensor:
    """Random 64-bit words (above 2^63 too), as int64 bit patterns."""
    return tu.from_u64(rng.integers(0, 1 << 64, size=shape, dtype=np.uint64), "cpu")


def const_col(name: str, rows: int) -> torch.Tensor:
    return tu.from_u64(np.full((rows, 1), CONSTS[name], dtype=np.uint64), "cpu")


def emulate(name: str, plan: mk.Plan) -> torch.Tensor:
    """What the kernel computes from the plan: every operand read through
    its pointer and [B, L, N] strides, the plain op on those views."""
    views = [torch.as_strided(op.tensor, plan.dims, op.strides, op.tensor.storage_offset())
             for op in plan.operands]
    return mk.OPS[name][2](*views).reshape(plan.shape)


# -- the op table against the source ------------------------------------------


def _enum(src: str, name: str) -> dict[str, int]:
    body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
    out, nxt = {}, 0
    for item in re.sub(r"//[^\n]*", "", body).replace("\n", " ").split(","):
        item = item.strip()
        if not item:
            continue
        key, _, val = item.partition("=")
        nxt = int(val) if val.strip() else nxt
        out[key.strip()] = nxt
        nxt += 1
    return out


def test_op_table_matches_source():
    src = (Path(_build.CSRC) / "modred.cu").read_text()
    ops = _enum(src, "Op")
    assert ops.pop("N_OPS") == len(mk.OPS)
    assert sorted(ops.values()) == sorted(code for code, _, _ in mk.OPS.values())
    assert {k.lower(): v for k, v in ops.items()} == {n: c for n, (c, _, _) in mk.OPS.items()}
    slots = _enum(src, "Slot")
    assert slots.pop("SLOTS") == len(mk.SLOTS)
    assert [k.lower() for k, _ in sorted(slots.items(), key=lambda kv: kv[1])] == list(mk.SLOTS)
    assert "modred" in _build.SOURCES and "mod_up" in _build.SOURCES


# -- the source's arithmetic, built for the host ----------------------------------

@pytest.fixture(scope="module")
def host_lib():
    """csrc/modred.cu built for the host (``tools/host_build``)."""
    return host_build.load("modred")


@pytest.fixture(scope="module")
def mod_up_host_lib():
    return host_build.load("mod_up")


def on_host(monkeypatch, **libs) -> None:
    """CPU tensors of the sources ``libs`` names down their kernel path,
    launched by ``libs`` behind the seam."""
    monkeypatch.setattr(_build, "takes_kernel", lambda name, *tensors: name in libs)
    for name, lib in libs.items():
        monkeypatch.setitem(_build.LIBRARIES, name, lib)


@pytest.mark.parametrize("name", list(mk.OPS))
def test_source_arithmetic_equals_plain(host_lib, name):
    """``apply<OP>`` of csrc/modred.cu for every pair (triple) of edge words
    and 4096 random 64-bit words per slot, against the plain op."""
    code, slots, plain = mk.OPS[name]
    rng = np.random.default_rng(code)
    data = [s for s in slots if s in ("x", "y", "z")]
    edge = np.array(EDGE, dtype=np.uint64)
    grid = np.stack(np.meshgrid(*[edge] * len(data))).reshape(len(data), -1)
    rand = rng.integers(0, 1 << 64, size=(len(data), 4096), dtype=np.uint64)
    cols = np.concatenate([grid, rand], axis=1)
    n = cols.shape[1]
    arrays = {s: cols[i] for i, s in enumerate(data)}
    arrays.update({s: np.full(n, CONSTS[s], dtype=np.uint64) for s in slots if s in CONSTS})
    desc = np.zeros((len(mk.SLOTS), 4), dtype=np.int64)
    for s, a in arrays.items():
        desc[mk.SLOTS.index(s)] = (a.ctypes.data, 0, 0, 1)
    got = np.empty(n, dtype=np.uint64)
    assert host_lib.modred_launch(code, desc.ctypes.data, got.ctypes.data, 1, 1, n, None) == 0
    want = plain(*[tu.from_u64(arrays[s], "cpu") for s in slots])
    np.testing.assert_array_equal(got, tu.to_u64(want))


# -- the launch plan ----------------------------------------------------------------


def layout(kind: str, batch: tuple, L: int, N: int, rng, role: str) -> torch.Tensor:
    """An operand of the broadcast shape [*batch, L, N] laid out as a call
    site gives it."""
    if role in CONSTS:  # a per-limb column, one constant, or a column slice
        t = tu.from_u64(np.full((L + 1, 1), CONSTS[role], dtype=np.uint64), "cpu")
        return (t[:L], t[:1], t[1:])[KINDS.index(kind) % 3]
    full = (*batch, L, N)
    if kind == "full":
        return words(rng, full)
    if kind == "col":  # a [L, 1] scalar column (Ring._scalar_tbl)
        return words(rng, (L, 1))
    if kind == "row":  # a [1, N] vector (mul_by_vector_montgomery)
        return words(rng, (1, N))
    if kind == "limb":  # one limb expanded over L (scaling._bcast_limb, sl.expand)
        return words(rng, (*batch, 1, N)).expand(full)
    if kind == "limb_bcast":  # one limb broadcast by torch (x[..., -1:, :])
        return words(rng, (*batch, L + 1, N))[..., -1:, :]
    if kind == "slice":  # x[..., :-1, :] / p0[..., :nq, :]
        return words(rng, (*batch, L + 2, N))[..., 1 : L + 1, :]
    if kind == "nobatch":  # [L, N] against a batch
        return words(rng, (L, N))
    if kind == "perm":  # batch dims permuted: no single batch stride
        return words(rng, (*batch[::-1], L, N)).permute(
            *range(len(batch) - 1, -1, -1), len(batch), len(batch) + 1)
    if kind == "mid":  # [b0, 1, L, N] against [b0, b1, L, N]
        return words(rng, (*batch[:1], *[1] * (len(batch) - 1), L, N))
    if kind == "transposed":  # coefficient stride L (a transpose of [N, L])
        return words(rng, (*batch, N, L)).transpose(-1, -2)
    raise ValueError(kind)


KINDS = ("full", "col", "row", "limb", "limb_bcast", "slice", "nobatch", "perm", "mid",
         "transposed")


def check_plan(name: str, operands) -> mk.Plan:
    plan = mk.launch_plan(operands)
    want = mk.OPS[name][2](*operands)
    assert plan.shape == tuple(want.shape)
    assert torch.equal(emulate(name, plan), want)
    for op in plan.operands:  # each pointer reads inside its tensor's storage
        last = sum((d - 1) * s for d, s in zip(plan.dims, op.strides))
        assert 0 <= op.tensor.storage_offset() + last < op.tensor.untyped_storage().nbytes() // 8
    return plan


@settings(max_examples=120, deadline=None)
@given(name=st.sampled_from(sorted(mk.OPS)),
       batch=st.lists(st.integers(1, 3), min_size=0, max_size=3).map(tuple),
       L=st.integers(1, 4), N=st.sampled_from([1, 2, 5, 8]),
       kinds=st.lists(st.sampled_from(KINDS), min_size=7, max_size=7),
       seed=st.integers(0, 2**32 - 1))
def test_launch_plan_equals_broadcasting(name, batch, L, N, kinds, seed):
    rng = np.random.default_rng(seed)
    _, slots, _ = mk.OPS[name]
    kinds = ["full"] + kinds[1:]  # x carries the whole shape
    operands = [layout(k, batch, L, N, rng, s) for k, s in zip(kinds, slots)]
    plan = check_plan(name, operands)
    assert plan.dims == (int(np.prod(plan.shape[:-2])), *plan.shape[-2:])


@pytest.mark.parametrize("kinds,copies", [
    (("full", "col"), 0),          # Ring.mul_scalar: [B, L, N] x [L, 1]
    (("slice", "limb_bcast"), 0),  # rescale: x[..., :-1, :] against x[..., -1:, :]
    (("limb", "col"), 0),          # the single-limb block's expand
    (("full", "row"), 0),          # a [1, N] vector
    (("nobatch", "full"), 0),      # [L, N] against a batch
    (("perm", "full"), 1),         # no single batch stride: one copy
    (("mid", "full"), 1),
    (("transposed", "full"), 0),   # any coefficient stride
])
def test_launch_plan_layouts(kinds, copies):
    """The call sites' layouts through ``mred`` at batch (2, 3): no copy
    where the leading dims collapse, one copy of an operand where not."""
    rng = np.random.default_rng(7)
    x, y = (layout(k, (2, 3), 3, 8, rng, "x") for k in kinds)
    plan = check_plan("mred", [x, y, const_col("q", 3), const_col("qinv", 3)])
    assert plan.copies == copies
    assert plan.dims == (6, 3, 8)


# -- routing: the whole forward through the kernel path -----------------------------

SPEC = dict(log_n=8, t=65537, log_qi=(46, 46), log_pi=(47,), log_qi_mul=(60, 60))
# the plain versions of other kernels, and the recorder below, may call modred
ALLOWED = {"_ntt_simple", "_intt_simple", "ntt_mxu_plain", "ntt_passes_plain", "modred_launch",
           "mod_up_launch"}


def at(ptr: int, dims, strides) -> torch.Tensor:
    """The words a kernel reads at address ``ptr`` over ``dims`` with
    ``strides`` (in words), copied into a tensor."""
    extent = 1 + sum((d - 1) * s for d, s in zip(dims, strides))
    words = np.frombuffer((ctypes.c_uint64 * extent).from_address(ptr), dtype=np.uint64)
    view = np.lib.stride_tricks.as_strided(words, tuple(dims), tuple(8 * s for s in strides))
    return tu.from_u64(view.copy(), "cpu")


def put(ptr: int, value: torch.Tensor) -> None:
    """``value`` written contiguously at address ``ptr``."""
    out = np.frombuffer((ctypes.c_uint64 * value.numel()).from_address(ptr), dtype=np.uint64)
    out[:] = tu.to_u64(value).ravel()


class Recorder:
    """A library whose entries run the plain versions on what the kernels
    would read: the modular pass's operand table, ``mod_up``'s packed
    tables and selection."""

    def __init__(self):
        self.calls = []

    def modred_launch(self, code, desc, out, B, L, N, stream):
        table = at(desc, (len(mk.SLOTS), 4), (4, 1))
        _, slots, plain = mk.OPS[NAME_OF[code]]
        ops = [at(int(table[mk.SLOTS.index(s), 0]), (B, L, N),
                  table[mk.SLOTS.index(s), 1:].tolist()) for s in slots]
        put(out, plain(*ops))
        self.calls.append(NAME_OF[code])
        return 0

    def mod_up_launch(self, x, sb, sl, sn, tab, sel, out, B, N, ls, ld, k, centered, stream):
        packed = tu.to_u64(at(tab, (5 * ls + 5 * ld + ls * ld,), (1,)))
        src, dst, cross = np.split(packed, [5 * ls, 5 * ls + 5 * ld])
        col = lambda row: tu.from_u64(row.reshape(-1, 1).copy(), "cpu")
        mp = SimpleNamespace(
            src=[0] * ls, qispj_mont_=tu.from_u64(cross.reshape(ls, ld, 1).copy(), "cpu"),
            **dict(zip(("qib_mont_", "m_lo_", "m_hi_", "sq_", "sqinv_"),
                       map(col, src.reshape(5, ls)))),
            **dict(zip(("dp_", "dpinv_", "dp_u0_", "negq_mont_", "negq_plain_"),
                       map(col, dst.reshape(5, ld)))))
        dst_sel = np.frombuffer((ctypes.c_int32 * k).from_address(sel), dtype=np.int32).tolist()
        put(out, basis_ext.mod_up_plain(at(x, (B, ls, N), (sb, sl, sn)), mp, dst_sel,
                                        bool(centered)))
        self.calls.append("mod_up")
        return 0


def kernel_path(monkeypatch, modred_lib, mod_up_lib) -> list:
    """Send CPU tensors down both kernel paths, launched by the libraries
    given; spy on every plain modred function and on ``mod_up_plain``.
    Returns the list of calls made outside ALLOWED frames."""
    stray = []
    on_host(monkeypatch, modred=modred_lib, mod_up=mod_up_lib)

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*args, **kw):
            f = sys._getframe(1)
            while f is not None and f.f_code.co_name not in ALLOWED:
                f = f.f_back
            if f is None:
                caller = sys._getframe(1).f_code
                stray.append(f"{name} from {caller.co_name} ({Path(caller.co_filename).name})")
            return fn(*args, **kw)

        monkeypatch.setattr(module, name, wrapped)

    for name in ("cred", "mform_constant", "mform", "inv_mform_constant", "inv_mform",
                 "mred_constant", "mred", "bred_add_constant", "bred_add", "bred_constant",
                 "bred", "mul_shoup"):
        spy(modred, name)
    spy(basis_ext, "mod_up_plain")
    return stray


@pytest.fixture(scope="module")
def jax_world():
    jp = jbfv.Parameters(**SPEC).gen_from_log_moduli()
    kgen = jbfv.KeyGenerator(jp)
    sk, pk = kgen.gen_key_pair()
    swk = kgen.gen_relin_key(sk, 1).evakey[0]
    enc, encryptor = jbfv.Encoder(jp), jbfv.Encryptor(jp, pk=pk)
    rng = np.random.default_rng(14)
    ca, cb = (encryptor.encrypt(enc.encode_uint(rng.integers(0, jp.t, jp.n, dtype=np.uint64)))
              for _ in range(2))
    ev = jbfv.Evaluator(jp)
    out = jax.jit(lambda a, b, k: ev.relinearize(ev.mul(a, b), jbfv.EvaluationKey([k])))(
        ca, cb, swk)
    carry = lambda ct: convert.ciphertext_from_numpy([ju.to_u64(p) for p in ct.value], "cpu")
    args = (carry(ca), carry(cb),
            convert.switching_key_from_numpy(ju.to_u64(swk.key0), ju.to_u64(swk.key1), "cpu"))
    return args, [ju.to_u64(p) for p in out.value]


@pytest.mark.parametrize("launcher", ["recorder", "host_source"])
def test_forward_through_the_kernel_path_equals_jax(monkeypatch, jax_world, host_lib,
                                                    mod_up_host_lib, launcher):
    """``launcher``: the recorder (the plain op on what the kernels would
    read), or the kernels' own sources built for the host behind the real
    wrappers."""
    args, want = jax_world
    forward, _ = entry(device="cpu", params_idx=tbfv.Parameters(**SPEC).gen_from_log_moduli())
    plain = forward(*args)
    rec = Recorder()
    stray = kernel_path(monkeypatch, *((rec, rec) if launcher == "recorder" else
                                       (host_lib, mod_up_host_lib)))
    _build.reset_launch_counts()
    got = forward(*args)
    counts = _build.launch_counts()
    assert stray == [], stray[:10]
    for a, b, c in zip(convert.ciphertext_to_numpy(got), convert.ciphertext_to_numpy(plain), want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    assert counts["modred"] > 0 and counts["mod_up"] > 0
    if launcher == "recorder":
        assert counts["modred"] == len([c for c in rec.calls if c != "mod_up"])
        assert counts["mod_up"] == rec.calls.count("mod_up")


def test_spy_catches_a_stray_call(monkeypatch):
    """The routing check itself: a plain modred call on the path is seen."""
    stray = kernel_path(monkeypatch, Recorder(), Recorder())
    q = const_col("q", 1)
    modred.cred(q, q)
    assert stray and stray[0].startswith("cred from")


# -- no fallback -----------------------------------------------------------------


class _FailingLib:
    def __init__(self, err):
        self.err = err

    def modred_launch(self, *args):
        return self.err


@pytest.mark.parametrize("err", [700, -2])
def test_a_failed_launch_raises(monkeypatch, err):
    """A call on the kernel path whose launcher reports an error raises; it
    never falls back to the plain version."""
    on_host(monkeypatch, modred=_FailingLib(err))
    before = _build.launch_counts()["modred"]
    rng = np.random.default_rng(1)
    with pytest.raises(RuntimeError, match="modred_launch"):
        mk.mred(words(rng, (2, 8)), words(rng, (2, 8)), const_col("q", 2), const_col("qinv", 2))
    assert _build.launch_counts()["modred"] == before


def test_other_devices_raise():
    """Not one device, or not the CPU or a card: no plain fallback."""
    x = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError):
        mk.cred(torch.zeros((2, 8), dtype=torch.int64, device="meta"), const_col("q", 2))
    with pytest.raises(ValueError):
        mk.add(x, x.to("meta"), const_col("q", 2))


def test_cpu_wrappers_equal_plain():
    """On CPU tensors every wrapper is its plain version."""
    rng = np.random.default_rng(3)
    for name, (_, slots, plain) in mk.OPS.items():
        operands = [const_col(s, 3) if s in CONSTS else words(rng, (2, 3, 8)) for s in slots]
        assert torch.equal(getattr(mk, name)(*operands), plain(*operands)), name
