"""The port's recorder (``utils/profiling.py``) on the CPU: off, it keeps no
span records and still counts and aggregates; on, spans nest under one
request id with the right parents; a ``tjit`` program records its phases; a
captured program (the CUDA capture API faked) keeps the counters of its
capture alone and counts them once a replay; ``ntt.rows.<route>`` equals
the rows ``ring.record_transforms`` lists; nothing is recorded on the
device inside a capture; a profiler session traces and keeps its calls out
of the aggregates; the kernel wrappers' spans; a captured program's
kernel launches by wrapper; a program's outputs are freed without the
garbage collector; the CKKS cells' captures count no rotation, and a
captured linear layer counts its rotations, decompositions and plaintext
products once a replay."""

import contextlib
import dataclasses
import gc
import json
import weakref

import numpy as np
import pytest
import torch

from lattigo_tpu_torch import _build, tjit as T
from lattigo_tpu_torch.models import bfv, ckks
from lattigo_tpu_torch.ops import modred_kernel as mk
from lattigo_tpu_torch.ops import ring as ring_mod
from lattigo_tpu_torch.utils import profiling as P
from lattigo_tpu_torch.utils.profiling import OpProfiler

torch.set_num_threads(1)

SMALL_BFV = dict(log_n=8, t=65537, log_qi=(46, 46), log_pi=(47,), log_qi_mul=(60, 60))
CKKS_SPEC = dict(log_n=9, log_slots=8, scale=float(1 << 30), log_qi=(45, 30, 30), log_pi=(45,))
PHASES = ["tjit.signature", "tjit.copy_in", "tjit.fn", "tjit.clone"]


@pytest.fixture(scope="module")
def bfv_world():
    params = bfv.Parameters(**SMALL_BFV).gen_from_log_moduli()
    kg = bfv.KeyGenerator(params, device="cpu", seed=1)
    sk, pk = kg.gen_key_pair()
    enc = bfv.Encoder(params, device="cpu")
    ct = bfv.Encryptor(params, pk=pk, device="cpu", seed=2).encrypt(
        enc.encode_uint(np.arange(params.n, dtype=np.uint64)))
    return dict(params=params, rlk=kg.gen_relin_key(sk), ct=ct,
                ev=bfv.Evaluator(params, device="cpu"))


@pytest.fixture(autouse=True)
def fresh():
    """Every test starts from an empty recorder, with tracing off."""
    P.reset()
    with P.tracing(False):
        yield
    P.reset()


def tensors(tree) -> list:
    """The tensors in a tree of lists, tuples, dicts and dataclasses."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors(x)]
    return []


def children(records, parent) -> list[str]:
    return [r["name"] for r in records if r["parent"] == parent["id"]]


def test_off_records_no_span_and_still_counts(bfv_world):
    ev, ct = bfv_world["ev"], bfv_world["ct"]
    ev.relinearize(ev.mul(ct, ct), bfv_world["rlk"])
    assert P.spans() == []
    agg = P.aggregates()
    assert agg["bfv.Evaluator.mul"]["count"] == agg["bfv.Evaluator.relinearize"]["count"] == 1
    assert agg["ring.ntt"]["count"] >= 1 and agg["ring.ntt"]["total_s"] > 0
    assert len(agg["ring.ntt"]["recent_s"]) == agg["ring.ntt"]["count"]
    assert P.counters()["ntt.rows.tile"] > 0


def test_on_nests_spans_under_one_request(bfv_world):
    ev, ct, rlk = bfv_world["ev"], bfv_world["ct"], bfv_world["rlk"]
    with P.tracing(True):
        ev.relinearize(ev.mul(ct, ct), rlk)
    records = P.spans()
    by_id = {r["id"]: r for r in records}
    tops = [r for r in records if r["parent"] is None]
    assert [r["name"] for r in tops] == ["bfv.Evaluator.mul", "bfv.Evaluator.relinearize"]
    for r in records:
        top = r
        while top["parent"] is not None:
            parent = by_id[top["parent"]]
            assert parent["start_ns"] <= top["start_ns"] <= top["end_ns"] <= parent["end_ns"]
            top = parent
        assert r["request"] == top["id"]
    assert {r["request"] for r in records} == {t["id"] for t in tops}
    assert "ring.ntt" in {r["name"] for r in records if r["request"] == tops[0]["id"]}
    assert {r["detail"] for r in records if r["name"] in ("ring.ntt", "ring.intt")} == {"tile"}
    assert "bfv.Evaluator.mul" not in P.aggregates()  # traced calls stay out


def test_a_cpu_program_records_its_four_phases(bfv_world):
    ev, ct, rlk = bfv_world["ev"], bfv_world["ct"], bfv_world["rlk"]
    f = T.tjit(lambda a, k: ev.relinearize(ev.mul(a, a), k))
    with P.tracing(True):
        f(ct, rlk)
        f(ct, rlk)
    records = P.spans()
    calls = [r for r in records if r["name"] == "tjit.call"]
    assert len(calls) == 2 and all(c["parent"] is None for c in calls)
    assert children(records, calls[0]) == ["tjit.signature", "tjit.build"]
    build = next(r for r in records if r["name"] == "tjit.build")
    # the first call runs inside the build
    assert children(records, build) == ["bfv.Evaluator.mul", "bfv.Evaluator.relinearize"]
    assert children(records, calls[1]) == PHASES
    fn = next(r for r in records if r["name"] == "tjit.fn")
    assert children(records, fn) == ["bfv.Evaluator.mul", "bfv.Evaluator.relinearize"]
    assert all(r["request"] == calls[1]["id"] for r in records
               if r["start_ns"] >= calls[1]["start_ns"])
    nbytes = sum(t.numel() * t.element_size() for t in tensors((ct, rlk)))
    assert P.counters(replayed=True) == {"tjit.replays": 1, "tjit.copy_in_bytes": nbytes}


def test_untraced_phases_tile_the_call_and_stay_bounded():
    """Off, a call's phases share its clock reads: their totals add up to
    the call's exactly; the marks waiting to be read stay under
    ``FOLD``."""
    f = T.tjit(lambda a: a * 3 + 1)
    x = torch.arange(8)
    n = P.FOLD + 44
    for _ in range(n):
        f(x)
        assert len(P._MARKS) < P.FOLD
    agg = P.aggregates()
    assert agg["tjit.call"]["count"] == agg["tjit.signature"]["count"] == n
    assert agg["tjit.build"]["count"] == 1
    assert agg["tjit.copy_in"]["count"] == agg["tjit.fn"]["count"] == agg["tjit.clone"]["count"] \
        == n - 1
    parts = sum(agg[k]["total_s"] for k in PHASES + ["tjit.build"])
    assert parts == pytest.approx(agg["tjit.call"]["total_s"], rel=1e-12)
    assert P.spans() == []


class _FakeCuda:
    """The CUDA stream, event and graph calls of ``tjit._Graph`` faked for
    CPU tensors.  Records, for every event recorded, whether a capture was
    open."""

    def __init__(self):
        self.capturing = False
        self.events = []

    @contextlib.contextmanager
    def graph(self, graph, pool=None):
        self.capturing = True
        try:
            yield
        finally:
            self.capturing = False

    def install(self, mp):
        fake = self
        stream = type("Stream", (), {"wait_stream": lambda self, other: None})
        event = type("Event", (), {
            "__init__": lambda self, enable_timing=False: None,
            "record": lambda self: fake.events.append(fake.capturing),
            "query": lambda self: True,
            "synchronize": lambda self: None,
            "elapsed_time": lambda self, other: 0.25})
        graph = type("CUDAGraph", (), {"replay": lambda self: None})
        for name, value in (("graph", self.graph), ("CUDAGraph", graph), ("Event", event),
                            ("Stream", lambda device=None: stream()),
                            ("current_stream", lambda device=None: stream()),
                            ("stream", lambda s: contextlib.nullcontext()),
                            ("device", lambda d: contextlib.nullcontext())):
            mp.setattr(torch.cuda, name, value)


def _ring_fn(ring):
    return lambda a: ring.intt(ring.ntt(a))


def replay(prog, dyn):
    """One call of a program, as ``tjit`` makes it."""
    with P.phases("tjit.call", "tjit.signature") as p:
        return prog(dyn, p)


def test_a_graph_keeps_its_capture_counts_and_counts_them_a_replay(monkeypatch):
    """Warm-up and capture each transform 2 x 3 rows; the counters keep the
    warm-up's (the capture ran nothing), the program the capture's, and each
    replay counts them once more, with the bytes it copied in or skipped
    (the build's own argument is held, a copy of it is not); a freed
    program's counts stay."""
    fake = _FakeCuda()
    fake.install(monkeypatch)
    ring = ring_mod.Ring(256, [12289, 40961, 7681], device="cpu")
    x = torch.zeros(3, 256, dtype=torch.int64)
    prog = T._Graph(_ring_fn(ring), lambda ts: (ts[0],), [x], None)
    assert P.counters() == {"ntt.rows.tile": 6}
    assert prog.counts.captured == {"ntt.rows.tile": 6, "tjit.replays": 1}
    for arg in (x, x.clone(), x):
        replay(prog, [arg])
    assert P.counters()["ntt.rows.tile"] == 6 + 3 * 6
    assert P.counters(replayed=True) == {"ntt.rows.tile": 18, "tjit.replays": 3,
                                         "tjit.copy_in_bytes": 2 * x.numel() * 8,
                                         "tjit.copy_in_skipped_bytes": x.numel() * 8}
    del prog
    gc.collect()
    assert P.counters()["ntt.rows.tile"] == 24 and P.counters(replayed=True) == {}


def _graph(fn, dyn):
    """``fn``'s program on the tensors ``dyn`` (the capture API faked), whose
    replay does what a CUDA graph's does: runs ``fn`` on the static buffers
    into the static outputs."""
    prog = T._Graph(fn, tuple, dyn, None)

    def run():
        for out, got in zip(prog.out_leaves, T.tree_flatten(fn(*prog.static_in))[0]):
            out.copy_(got)

    prog.graph.replay = run
    return prog


def _keyed(ct, key):
    return ct * key + 1


def _key_and_cts():
    """A key of 512 bytes and three ciphertexts of 64."""
    return torch.arange(64).reshape(8, 8), [torch.full((8,), i) for i in range(3)]


def _copied() -> tuple[int, int]:
    c = P.counters(replayed=True)
    return c.get("tjit.copy_in_bytes", 0), c.get("tjit.copy_in_skipped_bytes", 0)


def test_a_replay_with_the_same_key_copies_only_the_ciphertext(monkeypatch):
    _FakeCuda().install(monkeypatch)
    key, cts = _key_and_cts()
    prog = _graph(_keyed, [cts[0], key])
    for ct in cts[1:] + cts[:1]:
        assert torch.equal(replay(prog, [ct, key]), _keyed(ct, key))
    assert _copied() == (3 * 64, 3 * 512)
    assert P.counters(replayed=True)["tjit.replays"] == 3


def test_a_key_written_in_place_is_copied_again(monkeypatch):
    """``key.add_(1)`` bumps its version: the next call copies it and
    computes with the new key; the call after that skips it again."""
    _FakeCuda().install(monkeypatch)
    key, (ct, *_) = _key_and_cts()
    prog = _graph(_keyed, [ct, key])
    replay(prog, [ct, key])
    assert _copied() == (0, 64 + 512)
    key.add_(1)
    assert torch.equal(replay(prog, [ct, key]), _keyed(ct, key))
    assert _copied() == (512, 2 * 64 + 512)
    key[0].mul_(3)  # through a view: the same version counter
    assert torch.equal(replay(prog, [ct, key]), _keyed(ct, key))
    assert _copied() == (2 * 512, 3 * 64 + 512)
    replay(prog, [ct, key])
    assert _copied() == (2 * 512, 4 * 64 + 2 * 512)


def test_another_tensor_of_equal_contents_is_copied(monkeypatch):
    _FakeCuda().install(monkeypatch)
    key, (ct, *_) = _key_and_cts()
    prog = _graph(_keyed, [ct, key])
    other = key.clone()
    for _ in range(2):  # copied, then held
        assert torch.equal(replay(prog, [ct, other]), _keyed(ct, key))
    assert _copied() == (512, 2 * 64 + 512)


def test_a_freed_source_is_copied(monkeypatch):
    """The buffer's source is held weakly: freeing it leaves a dead
    reference, and a new tensor (of equal contents, perhaps at the freed
    one's address, at version 0) is copied."""
    _FakeCuda().install(monkeypatch)
    key, (ct, *_) = _key_and_cts()
    prog = _graph(_keyed, [ct, key])
    source = prog.held[1][0]
    del key
    gc.collect()
    assert source() is None
    key, _ = _key_and_cts()
    assert key._version == 0
    assert torch.equal(replay(prog, [ct, key]), _keyed(ct, key))
    assert _copied() == (512, 64)


def test_an_argument_the_program_writes_is_copied_every_call(monkeypatch):
    """``fn`` writes its first argument in place (``x.mul_(2)``): the
    build marks that buffer to be copied every call; three calls with the
    same tensors give what the eager function gives on copies."""
    _FakeCuda().install(monkeypatch)
    key, (ct, *_) = _key_and_cts()
    ct = ct + 1
    fn = lambda x, k: x.mul_(2) + k
    prog = _graph(fn, [ct, key])
    assert prog.keep == [False, True] and prog.held[0] is None
    want = fn(ct.clone(), key)
    for _ in range(3):
        assert torch.equal(replay(prog, [ct, key]), want)
    assert torch.equal(ct, torch.full((8,), 1))
    assert _copied() == (3 * 64, 3 * 512)


def test_copy_in_mb_reads_the_bytes_copied(monkeypatch):
    """The benchmark's ``tjit.copy_in_mb`` reads the bytes a replay copied,
    the ciphertext's, not the key's it skipped."""
    from fhe_bench import run

    _FakeCuda().install(monkeypatch)
    key, cts = _key_and_cts()
    prog = _graph(_keyed, [cts[0], key])
    for ct in cts[1:] + cts[:1]:
        replay(prog, [ct, key])
    assert run.load_module("metrics", "tjit.copy_in_mb").read(None) == pytest.approx(64 / 1e6)
    del prog
    gc.collect()
    assert P.counters()["tjit.copy_in_bytes"] == 3 * 64  # a freed program's counts stay


def test_nothing_is_recorded_on_the_device_inside_a_capture(monkeypatch):
    """Tracing on: a device-timed span inside the captured function records
    events in the warm-up and none in the capture; a replay records its
    copy-in's pair, read as ``tjit.copy_in.device``, and none for the replay
    and the clones."""
    fake = _FakeCuda()
    fake.install(monkeypatch)

    def fn(a):
        with P.span("inner", device=True):
            return a + 1

    x = torch.arange(4)
    with P.tracing(True):
        prog = T._Graph(fn, lambda ts: (ts[0],), [x], None)
        assert fake.events == [False, False]  # the warm-up's pair
        replay(prog, [x])
    assert fake.events == [False] * 4
    agg = P.aggregates()
    assert agg["tjit.copy_in.device"]["recent_s"] == [0.25e-3]
    assert "tjit.replay.device" not in agg and "tjit.clone.device" not in agg
    for name in ("tjit.call", "tjit.copy_in", "tjit.replay", "tjit.clone"):
        assert name not in agg  # traced: no host sample
    assert agg["inner.device"]["count"] == 1


@pytest.mark.parametrize("scheme", ["bfv", "ckks"])
def test_ntt_rows_equal_the_recorded_transforms(scheme, bfv_world):
    if scheme == "bfv":
        ev, ct, rlk = bfv_world["ev"], bfv_world["ct"], bfv_world["rlk"]
        op = lambda: ev.relinearize(ev.mul(ct, ct), rlk)
    else:
        params = ckks.Parameters(**CKKS_SPEC).gen_from_log_moduli()
        kg = ckks.KeyGenerator(params, device="cpu", seed=3)
        sk, pk = kg.gen_key_pair()
        rlk = kg.gen_relin_key(sk)
        enc = ckks.Encoder(params, device="cpu")
        cct = ckks.Encryptor(params, pk=pk, device="cpu", seed=4).encrypt(
            enc.encode(np.linspace(-1, 1, params.slots)))
        ev = ckks.Evaluator(params, device="cpu")
        op = lambda: ev.mul_relin(cct, cct, rlk)
    P.reset()
    with ring_mod.record_transforms() as calls:
        op()
    want: dict = {}
    for _, shape, _, _, route in calls:
        want["ntt.rows." + route] = want.get("ntt.rows." + route, 0) + int(np.prod(shape[:-1]))
    got = {k: v for k, v in P.counters().items() if k.startswith("ntt.rows.")}
    assert got == want and sum(got.values()) > 0


def test_a_profiler_session_traces_and_stays_out_of_the_aggregates(tmp_path, bfv_world):
    """Calls inside a ``torch.profiler`` session land in its trace as
    ``user_annotation`` events nested in the caller's, one ``tjit.call`` a
    call, and not in the aggregates the readers take medians of."""
    ev, ct = bfv_world["ev"], bfv_world["ct"]
    f = T.tjit(lambda a: ev.add(a, a))
    for _ in range(3):
        f(ct)
    before = P.aggregates()
    assert before["tjit.signature"]["count"] == 3
    assert before["tjit.fn"]["count"] == 2  # the first call runs in the build
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.autograd.profiler.record_function("outer"):
            for _ in range(2):
                f(ct)
    after = P.aggregates()
    for name in ("tjit.call", "tjit.signature", "tjit.fn", "tjit.clone"):
        assert after[name]["count"] == before[name]["count"], name
    assert [r["name"] for r in P.spans() if r["parent"] is None] == ["tjit.call"] * 2
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    outer = next(e for e in events if e["name"] == "outer")
    calls = [e for e in events if e["name"] == "tjit.call"]
    assert len(calls) == 2
    for e in calls + [e for e in events if e["name"] in PHASES]:
        assert outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
    assert sum(e["name"] == "bfv.Evaluator.add" for e in events) == 2
    f(ct)  # the session is over: untraced again
    assert P.aggregates()["tjit.call"]["count"] == before["tjit.call"]["count"] + 1


def test_op_profiler_times_are_its_spans(bfv_world):
    ev, ct = bfv_world["ev"], bfv_world["ct"]
    prof = OpProfiler(ev)
    with P.tracing(True):
        prof.add(ct, ct)
        prof.add(ct, ct)
    records = P.spans()
    ops = [r for r in records if r["name"] == "op.add"]
    assert len(ops) == 2 and prof.calls["add"] == 2
    assert prof.times["add"] == pytest.approx(sum(r["end_ns"] - r["start_ns"] for r in ops) / 1e9)
    assert all(children(records, r) == ["bfv.Evaluator.add"] for r in ops)


class _Lib:
    """A C library whose launches all succeed (no kernel runs)."""

    def modred_launch(self, *args):
        return 0


def _fake_modred(mp):
    """``modred_kernel``'s CUDA path on CPU tensors, with no kernel run."""
    mp.setattr(_build, "takes_kernel", lambda name, *tensors: name == "modred")
    mp.setitem(_build.LIBRARIES, "modred", _Lib())


def test_a_kernel_launch_is_a_span_and_a_count(monkeypatch):
    """The wrapper's host side is the span ``kernel.modred``; the launch
    counts once, in the seam's ``launch_counts`` (no second counter)."""
    _fake_modred(monkeypatch)
    a = torch.zeros(2, 8, dtype=torch.int64)
    q = torch.full((2, 1), 17, dtype=torch.int64)
    launches = _build.launch_counts()["modred"]
    with P.tracing(True):
        mk.add(a, a, q)
    assert _build.launch_counts()["modred"] == launches + 1
    assert P.counters() == {}
    assert [r["name"] for r in P.spans()] == ["kernel.modred"]


def test_a_graph_keeps_its_capture_launches_by_wrapper(monkeypatch):
    """A captured program keeps the launches its capture made, by wrapper,
    and each replay counts them once more; the seam's counts hold the
    warm-up's and the capture's launches, as before."""
    fake = _FakeCuda()
    fake.install(monkeypatch)
    _fake_modred(monkeypatch)
    q = torch.full((2, 1), 17, dtype=torch.int64)
    launches = _build.launch_counts()["modred"]
    x = torch.zeros(2, 8, dtype=torch.int64)
    prog = T._Graph(lambda a: mk.sub(mk.add(a, a, q), a, q), lambda ts: (ts[0],), [x], None)
    assert _build.launch_counts()["modred"] == launches + 4
    assert prog.counts.captured["launches.modred"] == 2
    for _ in range(3):
        replay(prog, [x])
    assert P.counters(replayed=True)["launches.modred"] == 6
    assert _build.launch_counts()["modred"] == launches + 4


def test_ring_tables_are_one_span_a_build():
    """A ring's construction and a table-cache miss are each one
    ``ring.tables`` span (nested builds inside it); a hit is none."""
    ring = ring_mod.Ring(256, [12289, 7681], device="cpu")
    assert P.aggregates()["ring.tables"]["count"] == 1
    x = torch.zeros(2, 256, dtype=torch.int64)
    for _ in range(2):
        ring.mul_scalar(x, 3)
        ring.limb_vector((1, 0))
    assert P.aggregates()["ring.tables"]["count"] == 3


def test_a_program_output_dies_without_the_collector():
    enabled = gc.isenabled()
    gc.disable()
    try:
        leaves = [torch.zeros(3) for _ in range(3)]
        treedef = T.tree_flatten((leaves[0], [leaves[1]], {"k": leaves[2]}))[1]
        tree = T.tree_unflatten(treedef, list(leaves))
        refs = [weakref.ref(t) for t in leaves]
        del tree, leaves
        assert [r() for r in refs] == [None] * 3
        f = T.tjit(lambda a: (a + 1, [a * 2]))
        for _ in range(2):  # the build, then a call of the program
            x = torch.arange(4) + 1
            out = f(x)
            refs = [weakref.ref(out[0]), weakref.ref(out[1][0]), weakref.ref(x)]
            del out, x
            assert [r() for r in refs] == [None, None, None]
    finally:
        (gc.enable if enabled else gc.disable)()


CHEBY_SPEC = dict(log_n=8, log_slots=7, scale=float(1 << 30), log_qi=(45,) + (30,) * 7,
                  log_pi=(45,))


@pytest.fixture(scope="module")
def ckks_world():
    params = ckks.Parameters(**CHEBY_SPEC).gen_from_log_moduli()
    kg = ckks.KeyGenerator(params, device="cpu", seed=5)
    sk, pk = kg.gen_key_pair_sparse(hw=64)
    enc = ckks.Encoder(params, device="cpu")
    ct = ckks.Encryptor(params, pk=pk, device="cpu", seed=6).encrypt(
        enc.encode(np.linspace(-8, 8, params.slots)))
    cheby = ckks.approximate(lambda x: 1 / (np.exp(-x.real) + 1), -8, 8, 31)
    return dict(params=params, rlk=kg.gen_relin_key(sk), ct=ct, cheby=cheby,
                ev=ckks.Evaluator(params, device="cpu"))


def test_a_captured_chebyshev_counts_its_products_a_replay(monkeypatch, ckks_world):
    """The degree-31 Chebyshev as one captured program: the capture's 12
    ciphertext products are the program's, and one replay counts them once."""
    fake = _FakeCuda()
    fake.install(monkeypatch)
    w = ckks_world
    ev, cheby = w["ev"], w["cheby"]
    leaves, treedef = T.tree_flatten((w["ct"], w["rlk"]))
    dyn = [l for l in leaves if isinstance(l, torch.Tensor)]
    statics = [l for l in leaves if not isinstance(l, torch.Tensor)]

    def rebuild(tensors):
        it, st = iter(tensors), iter(statics)
        return T.tree_unflatten(treedef, [next(it) if isinstance(l, torch.Tensor) else next(st)
                                          for l in leaves])

    prog = T._Graph(lambda ct, rlk: ckks.evaluate_cheby_fast(ev, ct, cheby, rlk), rebuild, dyn, None)
    assert P.counters()["ckks.poly.products"] == 12  # the warm-up's; the capture ran nothing
    assert prog.counts.captured["ckks.poly.products"] == 12
    replay(prog, dyn)
    assert P.counters(replayed=True)["ckks.poly.products"] == 12
    assert P.counters(replayed=True)["tjit.replays"] == 1


def test_the_chebyshev_records_its_basis_and_tree_spans(ckks_world):
    w = ckks_world
    with P.tracing(True):
        out = ckks.evaluate_cheby_fast(w["ev"], w["ct"], w["cheby"], w["rlk"])
    assert out.level == w["ct"].level - 7
    records = P.spans()
    tops = [r for r in records if r["parent"] is None]
    assert [r["name"] for r in tops] == ["ckks.cheby.basis", "ckks.cheby.tree"]
    basis, tree = tops
    assert basis["end_ns"] <= tree["start_ns"]
    inside = lambda top: sum(r["name"] == "ckks.Evaluator.mul_relin" and r["parent"] == top["id"]
                             for r in records)
    assert (inside(basis), inside(tree)) == (5, 7)
    assert P.counters()["ckks.poly.products"] == 12
    ckks.evaluate_cheby_fast(w["ev"], w["ct"], w["cheby"], w["rlk"])  # off: aggregates
    agg = P.aggregates()
    assert agg["ckks.cheby.basis"]["count"] == agg["ckks.cheby.tree"]["count"] == 1


def test_an_existing_program_gets_no_new_counter_or_launch(monkeypatch):
    """The CKKS cells' program, ``rescale(mul_relin)``, captured with the
    modular kernel's launches counted: its capture's counters are the NTT
    rows, the launches by wrapper and the call's own, no more, and as many
    as before the polynomial evaluator had counters; a replay on new
    ciphertexts copies their bytes in."""
    fake = _FakeCuda()
    fake.install(monkeypatch)
    _fake_modred(monkeypatch)
    params = ckks.Parameters(**CKKS_SPEC).gen_from_log_moduli()
    kg = ckks.KeyGenerator(params, device="cpu", seed=3)
    sk, pk = kg.gen_key_pair()
    rlk = kg.gen_relin_key(sk)
    ct = ckks.Encryptor(params, pk=pk, device="cpu", seed=4).encrypt(
        ckks.Encoder(params, device="cpu").encode(np.linspace(-1, 1, params.slots)))
    ev = ckks.Evaluator(params, device="cpu")
    dyn = [ct.value[0], ct.value[1]]
    prog = T._Graph(lambda a, b: ev.rescale(ev.mul_relin(ckks.Ciphertext([a, b], ct.scale),
                                                         ckks.Ciphertext([a, b], ct.scale), rlk)),
                    lambda ts: tuple(ts), dyn, None)
    assert prog.counts.captured == {"ntt.rows.tile": 29, "launches.modred": 17, "tjit.replays": 1}
    replay(prog, [t.clone() for t in dyn])
    assert P.counters(replayed=True)["tjit.copy_in_bytes"] == 2 * ct.value[0].numel() * 8


LINEAR = ("ckks.rotations", "ckks.decompositions", "ckks.linear.pt_products",
          "ckks.hoisted.mod_downs", "ckks.hoisted.rotations")


def _captured(fn, args):
    """``fn``'s program on ``args`` (the capture API faked)."""
    leaves, treedef = T.tree_flatten(args)
    dyn = [l for l in leaves if isinstance(l, torch.Tensor)]
    statics = [l for l in leaves if not isinstance(l, torch.Tensor)]

    def rebuild(tensors):
        it, st = iter(tensors), iter(statics)
        return T.tree_unflatten(treedef, [next(it) if isinstance(l, torch.Tensor) else next(st)
                                          for l in leaves])

    return T._Graph(fn, rebuild, dyn, None), dyn


@pytest.mark.parametrize("cell", ["mulrelin", "cheby31"])
def test_the_ckks_cells_captures_count_no_rotation(monkeypatch, ckks_world, cell):
    """The captures of the CKKS cells' programs, ``rescale(mul_relin)`` and
    the degree-31 Chebyshev, hold none of the linear layer's counters, nor
    do the counters after a replay."""
    _FakeCuda().install(monkeypatch)
    w = ckks_world
    ev = w["ev"]
    if cell == "mulrelin":
        fn = lambda ct, rlk: ev.rescale(ev.mul_relin(ct, ct, rlk))
    else:
        fn = lambda ct, rlk: ckks.evaluate_cheby_fast(ev, ct, w["cheby"], rlk)
    prog, dyn = _captured(fn, (w["ct"], w["rlk"]))
    replay(prog, dyn)
    assert prog.counts.captured["ntt.rows.tile"] > 0
    assert not set(LINEAR) & (set(prog.counts.captured) | set(P.counters()))


def test_a_captured_linear_layer_counts_its_rotations_a_replay(monkeypatch, ckks_world):
    """An 8 x 128 layer (4 baby x 2 giant steps, 4 fold steps) as one
    captured program: the capture's 3 + 1 + 4 rotations, 1 + 1 + 4
    decompositions and 8 products are the program's, counted once a
    replay, and so are its baby steps' one stacked ModDown of 3
    rotations."""
    _FakeCuda().install(monkeypatch)
    w = ckks_world
    params, ev = w["params"], w["ev"]
    kg = ckks.KeyGenerator(params, device="cpu", seed=7)
    sk = kg.gen_secret_key()
    keys = ckks.RotationKeys()
    for steps in ckks.linear_transform.rotations(8, 4, params.slots):
        for k in steps:
            kg.gen_rot("left", sk, k, keys)
    weights = np.random.default_rng(8).uniform(-0.1, 0.1, (8, params.slots))
    diags = ckks.encode_diagonals(params, weights, 4, device="cpu")
    prog, dyn = _captured(lambda ct, rk: ckks.mul_matrix_hybrid(ev, ct, diags, rk),
                          (w["ct"], keys))
    want = {"ckks.rotations": 8, "ckks.decompositions": 6, "ckks.linear.pt_products": 8,
            "ckks.hoisted.mod_downs": 1, "ckks.hoisted.rotations": 3}
    assert {k: prog.counts.captured[k] for k in LINEAR} == want
    assert {k: P.counters()[k] for k in LINEAR} == want  # the warm-up's
    replay(prog, dyn)
    replay(prog, dyn)
    assert {k: P.counters(replayed=True)[k] for k in LINEAR} == {k: 2 * v for k, v in want.items()}
