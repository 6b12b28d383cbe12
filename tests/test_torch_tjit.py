"""The port's ``tjit`` and ``JitEvaluator`` on the CPU.

The twins of tests/test_tjit.py's cases that apply to the port (the NTT
round trip, ``ntt`` alone, ``galois.permute_ntt``, the trace cache with
static leaves, nested inlining) run the same numpy-seeded inputs through
the JAX ``tjit`` and the port's, bit for bit, with equal trace counts.
``JitEvaluator``'s elementwise and rescaling ops are held against the JAX
``JitEvaluator`` on tests/test_ckks.py's log N = 8 set, outputs, scales,
levels and per-op trace counts equal (its circuits with key switches are
in tests/test_torch_ckks_poly.py, which already compiles them in JAX);
every op of ``_JIT_OPS`` against the port's eager ``Evaluator``.  A built
entry keeps the tables it read alive through an LRU flood of the ring's
cache.  Python's garbage collector is paused while a graph is captured
(the capture API faked on the CPU).  ``OpProfiler`` wraps a
``JitEvaluator``.  The compiled twins (the
PIR cloud step, the PSI AND chain, the degree-31 Chebyshev of bench.py's
config #4) equal their eager calls.  Tolerance: none (integers)."""

import contextlib
import gc
import math

import jax
import numpy as np
import pytest
import torch

from lattigo_tpu import tjit as J
from lattigo_tpu.models import ckks as jckks
from lattigo_tpu.ops import galois as jgalois
from lattigo_tpu.ops import ring as jring
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu.ops.default_params import default_qi
from lattigo_tpu_torch import convert
from lattigo_tpu_torch import tjit as T
from lattigo_tpu_torch.entry import entry_cheby31, entry_dbfv_pir, rolled_variants
from lattigo_tpu_torch.examples import dbfv_psi
from lattigo_tpu_torch.models import bfv, ckks
from lattigo_tpu_torch.ops import galois, ring as ring_mod
from lattigo_tpu_torch.ops import u64 as tu
from lattigo_tpu_torch.tools import timing
from lattigo_tpu_torch.utils.precision import precision_stats
from lattigo_tpu_torch.utils.profiling import OpProfiler

torch.set_num_threads(1)

N = 256
CPU = "cpu"
SPEC = dict(log_n=8, log_slots=7, scale=float(1 << 32), log_qi=(45, 32, 32, 32), log_pi=(45,))
SMALL_BFV = dict(log_n=8, t=65537, log_qi=(46, 46), log_pi=(47,), log_qi_mul=(60, 60))


def _rings():
    moduli = list(default_qi(8, 3))
    return jring.Ring(N, moduli), ring_mod.Ring(N, moduli, device=CPU)


def _input(seed, moduli) -> np.ndarray:
    x = np.random.default_rng(seed).integers(0, moduli[0], size=(3, N), dtype=np.uint64)
    return x


def _same_ct(a, b) -> bool:
    return (a.scale == b.scale and len(a.value) == len(b.value)
            and all(torch.equal(x, y) for x, y in zip(a.value, b.value)))


def test_ntt_roundtrip_and_ntt_alone_equal_the_jax_tjit():
    jr, tr = _rings()
    x = _input(7, jr.moduli)
    for q_i, q in enumerate(jr.moduli):
        x[q_i] %= q
    want = ju.to_u64(J.tjit(lambda a: jr.intt(jr.ntt(a)))(ju.from_u64(x)))
    f = T.tjit(lambda a: tr.intt(tr.ntt(a)))
    np.testing.assert_array_equal(tu.to_u64(f(tu.from_u64(x, CPU))), want)
    np.testing.assert_array_equal(want, x)
    jf, tf = J.tjit(jr.ntt), T.tjit(tr.ntt)
    np.testing.assert_array_equal(tu.to_u64(tf(tu.from_u64(x, CPU))),
                                  ju.to_u64(jf(ju.from_u64(x))))
    assert tf.trace_count() == jf.trace_count() == 1


def test_galois_permute_equals_the_jax_tjit():
    jr, _ = _rings()
    x = _input(11, jr.moduli)
    gal = 5
    want = ju.to_u64(J.tjit(lambda a: jgalois.permute_ntt(a, gal))(ju.from_u64(x)))
    got = T.tjit(lambda a: galois.permute_ntt(a, gal))(tu.from_u64(x, CPU))
    np.testing.assert_array_equal(tu.to_u64(got), want)


def test_trace_cache_and_static_leaves_count_as_the_jax_tjit():
    jf = J.tjit(lambda a, k: (a[0] + np.uint32(k), a[1]))
    tf = T.tjit(lambda a, k: (a + k, a))
    x = np.arange(8, dtype=np.uint64)
    counts = []
    for k in (3, 3, 4):
        want = jf(ju.from_u64(x), k)
        got = tf(tu.from_u64(x, CPU), k)
        np.testing.assert_array_equal(tu.to_u64(got[0]), np.asarray(want[0]).astype(np.uint64))
        np.testing.assert_array_equal(tu.to_u64(got[1]), x)
        counts.append((tf.trace_count(), jf.trace_count()))
    assert counts == [(1, 1), (1, 1), (2, 2)]
    assert tf.replays == 1


def test_nested_tjit_inlines_as_in_jax():
    jr, tr = _rings()
    x = _input(5, jr.moduli)
    j_inner, t_inner = J.tjit(jr.ntt), T.tjit(tr.ntt)
    j_outer = J.tjit(lambda a: jr.intt(j_inner(a)))
    t_outer = T.tjit(lambda a: tr.intt(t_inner(a)))
    want = ju.to_u64(j_outer(ju.from_u64(x)))
    np.testing.assert_array_equal(tu.to_u64(t_outer(tu.from_u64(x, CPU))), want)
    np.testing.assert_array_equal(want, x % np.array(jr.moduli, dtype=np.uint64)[:, None])
    assert ((t_inner.trace_count(), t_outer.trace_count())
            == (j_inner.trace_count(), j_outer.trace_count()))


def test_results_are_fresh_tensors():
    """An op returning its input (``rescale`` at level 0) or a view of it
    still gives the caller new tensors, and the arguments are not written."""
    f = T.tjit(lambda a, b: (a, b[:1], a + b))
    a, b = torch.arange(4), torch.arange(4) * 10
    for _ in range(2):
        out = f(a, b)
        assert all(o.data_ptr() not in (a.data_ptr(), b.data_ptr()) for o in out)
        out[0].add_(1)
        assert torch.equal(a, torch.arange(4)) and torch.equal(out[2], a + b)


class _FakeCuda:
    """The CUDA stream, event and graph calls that ``tjit._Graph`` and
    ``timing.graph_ms`` make, faked for CPU tensors; each capture records
    whether the garbage collector was enabled inside it."""

    def __init__(self):
        self.gc_in_capture = []

    def graph(self, graph, pool=None):
        self.gc_in_capture.append(gc.isenabled())
        return contextlib.nullcontext()

    def install(self, mp):
        stream = type("Stream", (), {"wait_stream": lambda self, other: None})
        event = type("Event", (), {"__init__": lambda self, enable_timing=False: None,
                                   "record": lambda self: None,
                                   "synchronize": lambda self: None,
                                   "elapsed_time": lambda self, other: 1.0})
        graph = type("CUDAGraph", (), {"replay": lambda self: None})
        for name, value in (("graph", self.graph), ("CUDAGraph", graph), ("Event", event),
                            ("Stream", lambda device=None: stream()),
                            ("current_stream", lambda device=None: stream()),
                            ("stream", lambda s: contextlib.nullcontext()),
                            ("device", lambda d: contextlib.nullcontext()),
                            ("synchronize", lambda device=None: None),
                            ("empty_cache", lambda: None)):
            mp.setattr(torch.cuda, name, value)


@pytest.mark.parametrize("gc_was_enabled", [True, False])
def test_captures_pause_the_garbage_collector(monkeypatch, gc_was_enabled):
    """A collection inside a capture can destroy an unreachable program's
    graph (a dead reference cycle holding a tjit entry), which invalidates
    the capture: ``tjit``'s captures and ``graph_ms`` run with the
    collector paused, and leave it as they found it."""
    fake = _FakeCuda()
    fake.install(monkeypatch)
    enabled = gc.isenabled()
    (gc.enable if gc_was_enabled else gc.disable)()
    try:
        x = torch.arange(4)
        prog = T._Graph(lambda a: a + 1, lambda ts: (ts[0],), [x], None)
        assert torch.equal(prog.result, x + 1) and gc.isenabled() is gc_was_enabled
        assert timing.graph_ms(lambda: x + 1, count=2, replays=1) == 0.5
        assert gc.isenabled() is gc_was_enabled
    finally:
        (gc.enable if enabled else gc.disable)()
    assert fake.gc_in_capture == [False, False]


@pytest.fixture(scope="module")
def ckks_world():
    """Port-made keys and ciphertexts at the log N = 8 set and their JAX
    twins."""
    params = ckks.Parameters(**SPEC).gen_from_log_moduli()
    kgen = ckks.KeyGenerator(params, device=CPU, seed=21)
    sk, pk = kgen.gen_key_pair()
    rot = ckks.RotationKeys()
    kgen.gen_rot("left", sk, 1, rot)
    kgen.gen_rot("conjugate", sk, 0, rot)
    enc = ckks.Encoder(params, device=CPU)
    encryptor = ckks.Encryptor(params, pk=pk, device=CPU, seed=22)
    rng = np.random.default_rng(23)
    cts = [encryptor.encrypt(enc.encode(rng.uniform(-1, 1, params.slots))) for _ in range(2)]

    def to_jax(ct):
        polys, scale = convert.ckks_ciphertext_to_numpy(ct)
        return jckks.Ciphertext([ju.from_u64(p) for p in polys], scale)

    return dict(params=params, rlk=kgen.gen_relin_key(sk), rot=rot,
                swk=kgen.gen_switching_key(sk, kgen.gen_secret_key()), cts=cts,
                jcts=[to_jax(c) for c in cts])


# ops whose JAX programs compile in seconds on the CPU: name -> call
CHEAP_OPS = {
    "add": lambda ev, a, b: ev.add(a, b),
    "sub": lambda ev, a, b: ev.sub(a, b),
    "neg": lambda ev, a, b: ev.neg(a),
    "reduce": lambda ev, a, b: ev.reduce(a),
    "add_const": lambda ev, a, b: ev.add_const(a, 0.5 - 0.25j),
    "mult_by_const": lambda ev, a, b: ev.mult_by_const(a, 0.25),
    "mult_by_const_and_add": lambda ev, a, b: ev.mult_by_const_and_add(a, 0.3, b),
    "scale_up": lambda ev, a, b: ev.scale_up(a, 4.0),
    "mul_by_pow2": lambda ev, a, b: ev.mul_by_pow2(a, 3),
    "rescale": lambda ev, a, b: ev.rescale(ev.mult_by_const(a, 0.25)),
}


def test_jit_evaluator_ops_equal_the_jax_jit_evaluator(ckks_world):
    params, cts, jcts = ckks_world["params"], ckks_world["cts"], ckks_world["jcts"]
    tev = ckks.JitEvaluator(params, device=CPU)
    jev = jckks.JitEvaluator(jckks.Parameters(**SPEC).gen_from_log_moduli())
    for name, call in CHEAP_OPS.items():
        for (a, ja), (b, jb) in ((zip(cts, jcts)), (zip(cts[::-1], jcts[::-1]))):
            got, want = call(tev, a, b), call(jev, ja, jb)
            assert got.scale == want.scale and got.level == want.level, name
            polys, _ = convert.ckks_ciphertext_to_numpy(got)
            for p, w in zip(polys, want.value, strict=True):
                np.testing.assert_array_equal(p, ju.to_u64(jax.tree.map(np.asarray, w)),
                                              err_msg=name)
    counts = {k: f.trace_count() for k, f in tev._jops.items()}
    assert counts == {k: f.trace_count() for k, f in jev._jops.items()}


def test_every_jit_op_equals_the_eager_evaluator(ckks_world):
    params, (a, b), rlk = ckks_world["params"], ckks_world["cts"], ckks_world["rlk"]
    ev, tev = ckks.Evaluator(params, device=CPU), ckks.JitEvaluator(params, device=CPU)
    rot, swk = ckks_world["rot"], ckks_world["swk"]
    calls = dict(CHEAP_OPS)
    calls.update(
        rescale_many=lambda e, x, y: e.rescale_many(e.mult_by_const(x, 0.25), 1),
        mul_relin=lambda e, x, y: e.mul_relin(x, y, rlk),
        relinearize=lambda e, x, y: e.relinearize(e.mul_relin(x, y), rlk),
        switch_keys=lambda e, x, y: e.switch_keys(x, swk),
        rotate_columns=lambda e, x, y: e.rotate_columns(x, 1, rot),
        conjugate=lambda e, x, y: e.conjugate(x, rot),
    )
    assert set(calls) == set(ckks.JitEvaluator._JIT_OPS)
    for name, call in calls.items():
        for x, y in ((a, b), (b, a)):
            assert _same_ct(call(tev, x, y), call(ev, x, y)), name
        assert tev._jops[name].trace_count() >= 1, name


def test_entries_keep_their_tables_through_an_lru_flood(ckks_world):
    """A built entry holds the very tables it read; flooding the ring's LRU
    cache past OP_CACHE_SIZE evicts them from the cache, not from the
    entry."""
    params, ct = ckks_world["params"], ckks_world["cts"][0]
    tev = ckks.JitEvaluator(params, device=CPU)
    ring = tev.ctx.ring_q
    op = lambda: tev.rescale(tev.mult_by_const(tev.mul_by_pow2(ct, 5), 0.25))
    want = op()
    recorded = {name: [t for p in f._cache.values() for t in p.tables]
                for name, f in tev._jops.items()}
    cached = {id(v): v for v in ring._op_cache.values()}
    pinned = [t for ts in recorded.values() for t in ts if id(t) in cached]
    assert len(pinned) >= 2  # the 2^5 column, the rescale column
    for c in range(ring_mod.OP_CACHE_SIZE + 8):
        ring.mul_scalar(ct.value[0], 1000 + c)
    assert not any(id(v) in {id(t) for t in pinned} for v in ring._op_cache.values())
    for name, f in tev._jops.items():
        held = [t for p in f._cache.values() for t in p.tables]
        assert len(held) == len(recorded[name])
        assert all(a is b for a, b in zip(held, recorded[name]))
    assert _same_ct(op(), want)
    T.clear_device_cache()
    assert all(f.trace_count() == 0 for f in tev._jops.values())


def test_op_profiler_wraps_a_jit_evaluator(ckks_world):
    params, ct, rlk = ckks_world["params"], ckks_world["cts"][0], ckks_world["rlk"]
    cheby = ckks.approximate(lambda x: complex(math.exp(x.real), 0), -1, 1, 7)
    prof = OpProfiler(ckks.JitEvaluator(params, device=CPU))
    got = ckks.evaluate_cheby_fast(prof, ct, cheby, rlk)
    eager = ckks.Evaluator(params, device=CPU)
    assert _same_ct(got, ckks.evaluate_cheby_fast(eager, ct, cheby, rlk))
    table = prof.as_dict()
    assert table["mul_relin"]["calls"] >= 3 and table["rescale"]["calls"] >= 4
    assert prof._ev._jops["mul_relin"].trace_count() == 3
    assert "mul_relin" in prof.report()


def test_pir_cloud_compiled_equals_eager():
    pir = entry_dbfv_pir(device=CPU, params_idx=bfv.Parameters(**SMALL_BFV).gen_from_log_moduli(),
                         n_rows=4)
    pk, rlk, rot_keys = pir.ckg(), pir.rkg(), pir.rtg()
    query, rows, masks = pir.encrypt(pk)
    for args in ((query, rows, masks, rlk, rot_keys),
                 (query, bfv.Ciphertext([torch.roll(p, 1, 0) for p in rows.value]), masks, rlk,
                  rot_keys)):
        want = pir.cloud(*args)
        got = pir.compiled_cloud(*args)
        assert got.degree == 1 and all(torch.equal(x, y) for x, y in zip(got.value, want.value))
    assert (pir.compiled_cloud.trace_count(), pir.compiled_cloud.replays) == (1, 1)
    sk_req = pir.requester_key()
    assert (pir.decrypt(pir.cks(got, sk_req), sk_req) == pir.rows[(pir.wanted - 1) % 4]).all()


def test_psi_and_chain_compiled_equals_eager():
    psi = dbfv_psi.Psi(3, 8, device=CPU)
    _, rlk = psi.keygen()
    cts = psi.encrypt(psi.keygen()[0])
    for order in (cts, cts[::-1]):
        want = psi.and_chain(order, rlk)
        got = psi.compiled_and_chain(order, rlk)
        assert all(torch.equal(x, y) for x, y in zip(got.value, want.value))
    assert psi.compiled_and_chain.trace_count() == 1


def test_cheby31_jit_equals_eager_and_decodes():
    """bench.py's config #4 at log N = 8 with 7 levels of 30 bits, all of
    which it takes: the degree-31 sigmoid through ``JitEvaluator`` on two
    content-distinct ciphertexts equals the eager evaluator's, and decodes
    to the interpolant."""
    params = ckks.Parameters(log_n=8, log_slots=7, scale=float(1 << 30),
                             log_qi=(45,) + (30,) * 7, log_pi=(45,)).gen_from_log_moduli()
    ch = entry_cheby31(device=CPU, params_idx=params)
    sk, pk, rlk = ch.keygen()
    cts = rolled_variants(ch.encrypt(pk), 2)
    eager = ckks.Evaluator(params, device=CPU)
    outs = [ch.evaluate(c, rlk) for c in cts]
    traces = ch.op_traces()
    for c, out in zip(cts, outs):
        assert _same_ct(out, ch.evaluate(c, rlk, ev=eager))
    assert ch.op_traces() == traces and outs[0].level == 0
    got = ch.decrypt(outs[0], sk)
    assert precision_stats(got, ch.want(exact=False)).median_bits >= 10
    r = ch.run(n_variants=2)  # the same keys and slots: the same programs, replayed
    assert r["op_traces"] == traces and r["level"] == 0 and r["evals_per_s"] > 0
    assert r["bits_vs_chebyshev"] == precision_stats(got, ch.want(exact=False)).median_bits
