"""The benchmark's deep CKKS circuit (``fhe_bench/apps/ckks_cheby.py``, the
cell ``ckks_pn15qp880.cheby31``) on the CPU at log N = 8 with PN15QP880's
moduli sizes and scale: the plain reference's interpolation, operations and
level and scale bookkeeping (``fhe_bench/reference/cheby.py``) against the
port's; the cell's program, one ``tjit`` of ``evaluate_cheby_fast`` on the
plain ``ckks.Evaluator``, decrypting within a limit of the reference's
noiseless result and equal to the eager evaluation on two content-distinct
ciphertexts; the control (the scale 2^30) over that limit."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from fhe_bench.apps import ckks_cheby as app
from fhe_bench.reference import cheby as ref_cheby
from lattigo_tpu_torch.models import ckks
from lattigo_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = json.loads((Path(__file__).resolve().parents[1] / "fhe_bench" / "tests" / "data"
                  / "tiny_cheby.json").read_text())
# the toy's readings: sound at most 7e-10, the control 3e-8 or more
LIMITS = dict(bad_form=0, limb_mismatch=0, max_err=5e-9, out_of_range=0)
WL = dict(config="tiny_cheby", app="ckks_cheby", batch=[], pool=2, limits=LIMITS)
SEED = 2**31 + 3
CPU = torch.device("cpu")


def run(cfg):
    """An app at ``cfg``, the program's answer of each pool entry."""
    a = app.App(cfg, WL, SEED, CPU)
    return a, {k: a.call(k) for k in range(a.pool)}


def port_side(cfg):
    """The port's evaluator and interpolant as the app builds them."""
    a, b = cfg["interval"]
    return (ckks.Evaluator(app.parameters(cfg), device=CPU),
            ckks.approximate(lambda x: app.FUNCTIONS[cfg["function"]](x.real), a, b, cfg["degree"]))


@pytest.fixture(scope="module")
def sound():
    return run(CFG)


def within(got: dict) -> bool:
    return all(got[k] <= v for k, v in LIMITS.items())


def test_reference_interpolation_is_the_ports():
    _, cheby = port_side(CFG)
    got = app.coefficients(CFG)
    want = [cheby.coeffs[i] for i in range(CFG["degree"] + 1)]
    assert all(w.imag == 0 for w in want)
    assert max(abs(g - w.real) for g, w in zip(got, want)) <= 1e-12
    # the same terms fall below the evaluator's threshold on both sides
    assert ([abs(g) > ref_cheby.NEGLIGIBLE for g in got]
            == [abs(w) > ref_cheby.NEGLIGIBLE for w in want])
    x = np.linspace(-8, 8, 101)
    sigmoid = 1 / (1 + np.exp(-x))
    assert np.abs(ref_cheby.interpolant(got, -8, 8, x) - sigmoid).max() < 1e-4


class Log:
    """An evaluator whose calls are logged as (op, scale, level)."""

    def __init__(self, ev, log):
        self.ev, self.log = ev, log

    def __getattr__(self, name):
        fn = getattr(self.ev, name)

        def call(*args):
            out = fn(*args)
            if name != "new_zero_ciphertext":
                self.log.append((name, out.scale, out.level))
            return out

        return call


def test_reference_takes_the_ports_operations(sound):
    """Op for op, the reference's model gives each ciphertext the scale
    and level the port's evaluator gives it; one product of the port is
    one ``ckks.poly.products``."""
    a, _ = sound
    ev, cheby = port_side(CFG)
    port, model_log = [], []
    before = profiling.counters().get("ckks.poly.products", 0)
    ckks.evaluate_cheby_fast(Log(ev, port), a.cts[0], cheby, a.rlk)
    assert profiling.counters().get("ckks.poly.products", 0) - before == 12
    want, model = app.expected(CFG, a.coeffs[0])
    x = ref_cheby.Ct(np.zeros(1, complex), float(CFG["scale"]), len(model.qs) - 1)
    lo, hi = CFG["interval"]
    ref_cheby.evaluate_cheby_fast(Log(ref_cheby.Model(model.qs, model.scale), model_log), x,
                                  app.coefficients(CFG), lo, hi)
    assert port == model_log and len(port) == 77
    counts = {op: sum(p[0] == op for p in port) for op in {p[0] for p in port}}
    assert counts == dict(mul_relin=12, rescale=21, mult_by_const_and_add=20, add_const=10, add=12,
                          sub=1, mult_by_const=1)


def test_the_program_decrypts_within_the_limit(sound):
    a, answers = sound
    got = a.judge(answers)
    assert within(got), got
    assert got["max_err"] > 0


def test_output_level_scale_and_products_are_the_references(sound):
    a, answers = sound
    want, model = app.expected(CFG, a.coeffs[0])
    assert want.level == 10 and sum(kind == "product" for kind, _ in model.events) == 12
    assert sum(kind == "rescale" for kind, _ in model.events) == 21
    assert sorted(lvl for kind, lvl in model.events if kind == "product") == [11, 12, 12] + [13] * 5 \
        + [14, 15, 15, 16]
    for ans in answers.values():
        assert ans.level == want.level and ans.degree == 1
        assert ans.scale == want.scale
    assert math.log2(want.scale) == pytest.approx(40, abs=1e-3)


def test_calls_equal_the_eager_evaluation(sound):
    """Both pool entries (content-distinct), the program's answer against
    ``evaluate_cheby_fast`` run eagerly, bit for bit."""
    a, answers = sound
    ev, cheby = port_side(CFG)
    assert not torch.equal(a.cts[0].value[0], a.cts[1].value[0])
    for k in range(2):
        eager = ckks.evaluate_cheby_fast(ev, a.cts[k], cheby, a.rlk)
        assert eager.scale == answers[k].scale
        assert all(torch.equal(x, y) for x, y in zip(eager.value, answers[k].value))
    assert not torch.equal(answers[0].value[0], answers[1].value[0])


def test_the_control_fails_the_limit():
    a, answers = run(app.control_config(CFG))
    got = a.judge(answers)
    assert not within(got), got
    assert got["bad_form"] == 0 and got["out_of_range"] == 0
    assert got["max_err"] > 4 * LIMITS["max_err"] and got["limb_mismatch"] == 0


def test_a_context_keeps_its_own_scale():
    """Two sets that differ only in the default scale (the cell and its
    control in one process) get contexts of their own: the evaluator's
    rescale threshold and constant scale are each set's."""
    lo = ckks.get_context(app.parameters(app.control_config(CFG)), CPU)
    hi = ckks.get_context(app.parameters(CFG), CPU)
    assert (lo.scale, hi.scale) == (2.0**30, 2.0**40)
    assert ckks.Evaluator(app.parameters(app.control_config(CFG)), device=CPU).params.scale == 2.0**30
