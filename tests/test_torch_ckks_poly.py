"""The port's CKKS polynomial evaluation and algorithms against the JAX
package's.

Keys and ciphertexts are made by the port and carried across as uint64
arrays (lattigo_tpu_torch.convert); the same function then runs in both
packages on the same ciphertext and relinearization key, and the outputs
must be equal bit for bit (integers, tolerance 0), with equal ``scale``
(compared exactly, as floats) and level; the port's ``JitEvaluator`` gives
the same outputs, with as many programs per op as the JAX one has traces.
The JAX side runs through its per-op compiled ``JitEvaluator``, which
computes what ``Evaluator`` computes and compiles each op once per level
instead of each primitive.  Decryption
meets tests/test_ckks.py's budgets (median bits: 10 for ``power`` and
``evaluate_poly``, 7 for ``evaluate_cheby``, 6 for ``inverse``).  The set
is tests/test_ckks.py's (log N = 8, Q = 45 + 3 x 32 bits)."""

import math

import jax
import numpy as np
import pytest
import torch

from lattigo_tpu.models import ckks as jckks
from lattigo_tpu.ops import u64 as ju
from lattigo_tpu_torch import convert
from lattigo_tpu_torch.models import ckks as tckks
from lattigo_tpu_torch.utils.precision import precision_stats

torch.set_num_threads(1)

SPEC = dict(log_n=8, log_slots=7, scale=float(1 << 32), log_qi=(45, 32, 32, 32), log_pi=(45,))
JP = jckks.Parameters(**SPEC).gen_from_log_moduli()
TP = tckks.Parameters(**SPEC).gen_from_log_moduli()
SLOTS = TP.slots
CPU = "cpu"


def exp_real(x):
    return complex(math.exp(x.real), 0)


def sigmoid(x):
    return 1 / (math.exp(-x.real) + 1)


CHEBY_EXP = (exp_real, -1, 1, 7)
POLY = [0, 1.0, 0, -1.0 / 6]  # x - x^3/6
POLY5 = [0.1, 1.0, 0.25, -1.0 / 6, 0.05, 0.02]
# name -> (call on a scheme module, input, median-bits budget, expected slots)
CASES = {
    "evaluate_poly_eco": (lambda m, ev, ct, rlk: m.evaluate_poly_eco(ev, ct, POLY, rlk),
                          "unit", 10, lambda v: v - v**3 / 6),
    "evaluate_poly_fast": (lambda m, ev, ct, rlk: m.evaluate_poly_fast(ev, ct, POLY5, rlk),
                           "unit", 10, lambda v: sum(c * v**i for i, c in enumerate(POLY5))),
    "evaluate_cheby_eco": (lambda m, ev, ct, rlk: m.evaluate_cheby_eco(
        ev, ct, m.approximate(*CHEBY_EXP), rlk), "unit", 7, np.exp),
    "evaluate_cheby_fast": (lambda m, ev, ct, rlk: m.evaluate_cheby_fast(
        ev, ct, m.approximate(*CHEBY_EXP), rlk), "unit", 7, np.exp),
    "power_of_2": (lambda m, ev, ct, rlk: m.algorithms.power_of_2(ev, ct, 2, rlk),
                   "unit", 10, lambda v: v**4),
    "power": (lambda m, ev, ct, rlk: m.algorithms.power(ev, ct, 3, rlk),
              "unit", 10, lambda v: v**3),
    "inverse": (lambda m, ev, ct, rlk: m.algorithms.inverse(ev, ct, 2, rlk),
                "near_one", 6, lambda v: 1 / v),
}


@pytest.fixture(scope="module")
def world():
    """Port-made keys and ciphertexts, their carried-across twins, and the
    JAX package's outputs, computed once each."""
    kgen = tckks.KeyGenerator(TP, device=CPU, seed=11)
    sk, pk = kgen.gen_key_pair()
    rlk = kgen.gen_relin_key(sk)
    enc = tckks.Encoder(TP, device=CPU)
    encryptor = tckks.Encryptor(TP, pk=pk, device=CPU, seed=12)
    rng = np.random.default_rng(13)
    values = {"unit": rng.uniform(-0.9, 0.9, SLOTS), "near_one": rng.uniform(0.7, 1.3, SLOTS)}
    cts = {k: encryptor.encrypt(enc.encode(v)) for k, v in values.items()}
    k0, k1 = convert.switching_key_to_numpy(rlk.evakey)
    jrlk = jckks.EvaluationKey(jckks.SwitchingKey(ju.from_u64(k0), ju.from_u64(k1)))

    def to_jax(ct):
        polys, scale = convert.ckks_ciphertext_to_numpy(ct)
        return jckks.Ciphertext([ju.from_u64(p) for p in polys], scale)

    return dict(rlk=rlk, jrlk=jrlk, enc=enc, ev=tckks.Evaluator(TP, device=CPU),
                jev=jckks.JitEvaluator(JP), tjev=tckks.JitEvaluator(TP, device=CPU), tjit_ran=set(),
                dec=tckks.Decryptor(TP, sk, device=CPU),
                values=values, cts=cts, jcts={k: to_jax(c) for k, c in cts.items()}, jax_out={})


def jax_result(world, name):
    if name not in world["jax_out"]:
        fn, kind = CASES[name][:2]
        world["jax_out"][name] = fn(jckks, world["jev"], world["jcts"][kind], world["jrlk"])
    return world["jax_out"][name]


def test_approximate_matches_the_jax_package():
    for args in (CHEBY_EXP, (sigmoid, -4, 4, 7), (sigmoid, 0, 4, 7), (lambda x: math.sin(x.real), -2, 3, 12),
                 (lambda x: x * x, 0.5 - 1j, 2 + 1j, 5)):
        got, want = tckks.approximate(*args), jckks.approximate(*args)
        assert (got.degree, got.a, got.b) == (want.degree, want.a, want.b)
        assert got.coeffs == want.coeffs  # the same floats, exactly
    assert tckks.ChebyshevInterpolation is not jckks.ChebyshevInterpolation


@pytest.mark.parametrize("name", list(CASES))
def test_bit_equal_to_the_jax_package(world, name):
    fn, kind, budget, expect = CASES[name]
    got = fn(tckks, world["ev"], world["cts"][kind], world["rlk"])
    want = jax_result(world, name)
    assert got.scale == want.scale
    assert got.level == want.level and len(got.value) == len(want.value)
    polys, _ = convert.ckks_ciphertext_to_numpy(got)
    for a, b in zip(polys, want.value):
        np.testing.assert_array_equal(a, ju.to_u64(jax.tree.map(np.asarray, b)))
    slots = world["enc"].decode(world["dec"].decrypt(got))
    assert precision_stats(slots, expect(world["values"][kind])).median_bits >= budget


def jit_result(world, name):
    """The circuit through the port's ``JitEvaluator``, recorded as run."""
    fn, kind = CASES[name][:2]
    world["tjit_ran"].add(name)
    return fn(tckks, world["tjev"], world["cts"][kind], world["rlk"])


@pytest.mark.parametrize("name", list(CASES))
def test_jit_evaluator_equals_the_jax_jit_evaluator(world, name):
    """The port's ``JitEvaluator`` (every op a ``tjit`` program) gives the
    JAX ``JitEvaluator``'s output bit for bit."""
    got, want = jit_result(world, name), jax_result(world, name)
    assert got.scale == want.scale and got.level == want.level
    polys, _ = convert.ckks_ciphertext_to_numpy(got)
    for a, b in zip(polys, want.value, strict=True):
        np.testing.assert_array_equal(a, ju.to_u64(jax.tree.map(np.asarray, b)))


def test_jit_evaluator_trace_counts_equal_the_jax_ones(world):
    """After every circuit through both evaluators, each op holds as many
    programs (one per signature) as the JAX op holds traces."""
    for name in CASES:
        jax_result(world, name)
        if name not in world["tjit_ran"]:
            jit_result(world, name)
    got = {k: f.trace_count() for k, f in world["tjev"]._jops.items()}
    assert got == {k: f.trace_count() for k, f in world["jev"]._jops.items()}
    assert got["mul_relin"] >= 3


@pytest.fixture(scope="module")
def deep():
    """examples/ckks_sigmoid.py's set (Q = 45 + 5 x 30 bits), its keys and
    an input in [-4, 4], all made by the port."""
    params = tckks.Parameters(log_n=8, log_slots=7, scale=float(1 << 30),
                              log_qi=(45, 30, 30, 30, 30, 30), log_pi=(45,)).gen_from_log_moduli()
    kgen = tckks.KeyGenerator(params, device=CPU, seed=3)
    sk, pk = kgen.gen_key_pair()
    enc = tckks.Encoder(params, device=CPU)
    x = np.random.default_rng(5).uniform(-4, 4, params.slots)
    ct = tckks.Encryptor(params, pk=pk, device=CPU, seed=4).encrypt(enc.encode(x))
    return dict(params=params, rlk=kgen.gen_relin_key(sk), ev=tckks.Evaluator(params, device=CPU),
                enc=enc, dec=tckks.Decryptor(params, sk, device=CPU), x=x, ct=ct)


@pytest.mark.parametrize("degree", [3, 7])
@pytest.mark.parametrize("variant", ["eco", "fast"])
def test_levels_consumed(deep, degree, variant):
    """Degree 3 and 7 polynomials take ceil(log2(d + 1)) levels in both
    variants, their Chebyshev forms one more for the change of variable:
    the degree-7 sigmoid takes the 4 levels examples/ckks_sigmoid.py
    reports, at its 7-bit bar."""
    ev, ct, rlk, top = deep["ev"], deep["ct"], deep["rlk"], deep["params"].max_level
    depth = degree.bit_length()
    poly = getattr(tckks, f"evaluate_poly_{variant}")(ev, ct, [0.1] * (degree + 1), rlk)
    assert top - poly.level == depth
    cheby = getattr(tckks, f"evaluate_cheby_{variant}")(
        ev, ct, tckks.approximate(sigmoid, -4, 4, degree), rlk)
    assert top - cheby.level == depth + 1
    if degree == 7:
        got = deep["enc"].decode(deep["dec"].decrypt(cheby))
        assert precision_stats(got, 1 / (1 + np.exp(-deep["x"]))).median_bits >= 7
