"""The deep CKKS circuit's cell (``ckks_pn15qp880.cheby31``, request kind
``ckks_cheby``): a tiny cell at log N = 8 with PN15QP880's moduli sizes run
on the CPU through ``run.run_cell`` with the timed path broken underneath
(a limb of the answer changed, a level dropped, a wrong scale) and its
control, each of which must make ``correct`` false, and a sound run, which
must come out correct; the cell's work file against the reference's run of
the circuit; the reader of ``scheme.ct_products_per_req``; and, on a card,
the cell's program at its full size replayed bit-equal to the eager
evaluation on two content-distinct ciphertexts."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fhe_bench import run
from fhe_bench.apps import ckks_cheby as app
from fhe_bench.reference import cheby as ref_cheby
from fhe_bench.reference import ckks as ref_ckks
from lattigo_tpu_torch.models import ckks
from lattigo_tpu_torch.utils import profiling

HERE = Path(__file__).resolve().parent
CPU = torch.device("cpu")
SEED = 2**31 + 91
CELL = "tiny.cheby31"
CFG = json.loads((HERE / "data" / "tiny_cheby.json").read_text())
# the toy's readings: sound at most 7e-10, the control 3e-8 or more
WL = dict(config="tiny_cheby", app="ckks_cheby", batch=[], pool=2,
          limits=dict(bad_form=0, limb_mismatch=0, max_err=5e-9, out_of_range=0))
REAL = "ckks_pn15qp880.cheby31"


def bench() -> dict:
    real = run.load_bench()
    return dict(real, workloads=[dict(name=CELL, config="tiny_cheby", traffic="cheby31", chips=1,
                                      why="test")])


def run_tiny(factory=None, cfg=CFG):
    return run.run_cell(CELL, WL, cfg, SEED, 3.0, False, CPU, bench(), app_factory=factory)


def broken(fault: str):
    class Broken(app.App):
        def call(self, k):
            out = super().call(k)
            if fault == "altered":  # one word of one limb changed where it is made
                out.value[1][..., 3, 7] ^= 1
            elif fault == "dropped":  # one level too few
                out = ckks.Ciphertext([v[..., :-1, :] for v in out.value], out.scale)
            elif fault == "scale":  # the nominal scale, not the one the circuit leaves
                out = ckks.Ciphertext(out.value, float(self.cfg["scale"]))
            return out

    return Broken


def test_sound_run_is_correct():
    result, checks = run_tiny()
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("fault", ["altered", "dropped", "scale"])
def test_fault_makes_correct_false(fault):
    result, checks = run_tiny(broken(fault))
    assert not result["correct"], checks


def test_control_is_not_correct():
    """The deployment at the scale 2^30: the precision below."""
    result, checks = run_tiny(cfg=app.control_config(CFG))
    assert not result["correct"], checks
    assert checks["bad_form"]["value"] == 0


def test_work_file_is_the_references_run():
    cfg = run.load_json("configs", "ckks_pn15qp880")
    moduli = ref_ckks.moduli(cfg)
    want, model = app.expected(cfg, np.zeros(1 << cfg["log_n"], dtype=np.int64))
    assert want.level == 10 and len(model.events) == 12 + 21
    work = run.load_json("work", REAL)
    assert work["cell"] == REAL
    assert work["transforms"] == ref_cheby.work(moduli["q"], len(moduli["p"]), 1 << cfg["log_n"],
                                                model.events)
    assert sum(t["rows"] * t["count"] for t in work["transforms"]) == 2119


def test_products_reader(monkeypatch):
    read = run.load_module("metrics", "scheme.ct_products_per_req").read
    rec = run.Record([0.01], [0.001], 1.0, 1.0, 0, None, {}, None)
    monkeypatch.setattr(profiling, "counters", lambda replayed=False: {
        "ckks.poly.products": 36, "tjit.replays": 3})
    assert read(rec) == 12
    monkeypatch.setattr(profiling, "counters", lambda replayed=False: {"tjit.replays": 3})
    assert read(rec) is None  # the other cells' programs, and the parent's
    monkeypatch.delattr(profiling, "counters")
    assert read(rec) is None


@pytest.mark.chip
def test_the_cell_on_the_card(cuda_device):
    """The cell's program at PN15QP880: two pool entries, each replay equal
    to ``evaluate_cheby_fast`` run eagerly, bit for bit, 12 products a
    replay, and the reference's checks within the cell's limits."""
    cfg = run.load_json("configs", "ckks_pn15qp880")
    wl = dict(run.load_json("workloads", REAL), pool=2)
    a = app.App(cfg, wl, 2**31 + 5, cuda_device)
    lo, hi = cfg["interval"]
    ev = ckks.Evaluator(app.parameters(cfg), device=cuda_device)
    cheby = ckks.approximate(lambda x: app.FUNCTIONS[cfg["function"]](x.real), lo, hi, cfg["degree"])
    profiling.reset()
    answers = {}
    for k in (0, 1, 0, 1):  # the first call captures, the others replay
        answers[k] = a.call(k)
    for k in (0, 1):
        eager = ckks.evaluate_cheby_fast(ev, a.cts[k], cheby, a.rlk)
        assert eager.scale == answers[k].scale
        assert all(torch.equal(x, y) for x, y in zip(eager.value, answers[k].value))
    assert not torch.equal(answers[0].value[0], answers[1].value[0])
    c = profiling.counters(replayed=True)
    assert c["tjit.replays"] == 3 and c["ckks.poly.products"] == 36
    got = a.judge(answers)
    assert all(got[k] <= v for k, v in wl["limits"].items()), got
