"""The encrypted dense layer's cell (``ckks_pn14qp438.fc1024x8192``, request
kind ``ckks_matvec``): a tiny cell at log N = 10 with PN14QP438's moduli
sizes and a 32 x 512 layer (8 baby x 4 giant steps, 4 fold steps) run on
the CPU through ``run.run_cell``, sound and with the timed path broken
underneath (a dropped diagonal, a fold step left out, a level dropped, the
nominal scale, a word out of range), each fault and the control making
``correct`` false; the reference's own method against ``W x``; the cell's
work file against the reference's ``work()``; the readers of
``scheme.rotations_per_req`` and ``scheme.decompositions_per_req``; and, on
a card, the cell's program at its full size replayed bit-equal to the eager
layer on two content-distinct ciphertexts."""

import json
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from fhe_bench import run
from fhe_bench.apps import ckks_matvec as app
from fhe_bench.reference import ckks as ref_ckks
from fhe_bench.reference import matvec as ref_matvec
from lattigo_tpu_torch.models import ckks
from lattigo_tpu_torch.models.ckks import linear_transform
from lattigo_tpu_torch.utils import profiling

HERE = Path(__file__).resolve().parent
CPU = torch.device("cpu")
SEED = 2**31 + 93
CELL = "tiny.fc32x512"
CFG = json.loads((HERE / "data" / "tiny_matvec.json").read_text())
# the toy's readings (6 seeds, CPU): sound 2.8e-8 – 7.6e-8, the control (the scale 2^30)
# 3.4e-7 – 1.2e-6
WL = dict(config="tiny_matvec", app="ckks_matvec", batch=[], pool=2,
          limits=dict(bad_form=0, limb_mismatch=0, max_err=1.6e-7, out_of_range=0))
REAL = "ckks_pn14qp438.fc1024x8192"
ROTATIONS = linear_transform.rotations


def bench() -> dict:
    real = run.load_bench()
    return dict(real, workloads=[dict(name=CELL, config="tiny_matvec", traffic="fc32x512", chips=1,
                                      why="test")])


def run_tiny(factory=None, cfg=CFG):
    return run.run_cell(CELL, WL, cfg, SEED, 4.0, False, CPU, bench(), app_factory=factory)


def _short_fold(*args):
    baby, giant, fold = ROTATIONS(*args)
    return baby, giant, fold[:-1]


def broken(fault: str):
    class Broken(app.App):
        def __init__(self, *args):
            super().__init__(*args)
            if fault == "diagonal":  # one diagonal left out of the layer
                self.diags.value[1, 3] = 0

        def call(self, k):
            if fault == "fold":  # the last fold step left out
                with mock.patch.object(linear_transform, "rotations", _short_fold):
                    return super().call(k)
            out = super().call(k)
            if fault == "dropped":  # one level too few
                out = ckks.Ciphertext([v[..., :-1, :] for v in out.value], out.scale)
            elif fault == "scale":  # the nominal scale, not the one the rescale leaves
                out = ckks.Ciphertext(out.value, float(self.cfg["scale"]))
            elif fault == "range":  # a word q_0 above its residue: decrypts the same
                out.value[0][..., 0, 5] += ref_ckks.moduli(self.cfg)["q"][0]
            return out

    return Broken


def test_sound_run_is_correct():
    result, checks = run_tiny()
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0
    assert 0 < checks["max_err"]["value"] < WL["limits"]["max_err"]


@pytest.mark.parametrize("fault", ["diagonal", "fold", "dropped", "scale", "range"])
def test_fault_makes_correct_false(fault):
    result, checks = run_tiny(broken(fault))
    assert not result["correct"], checks
    failed = {k for k, c in checks.items() if c["value"] > c["limit"]}
    assert failed == {"diagonal": {"max_err"}, "fold": {"max_err"}, "dropped": {"bad_form"},
                      "scale": {"bad_form"}, "range": {"out_of_range"}}[fault], checks


def test_control_is_not_correct():
    """The scale 2^30 (the layer left unrescaled at level 9): the
    precision below the configuration's."""
    result, checks = run_tiny(cfg=app.control_config(CFG))
    assert not result["correct"], checks
    assert {k for k, c in checks.items() if c["value"] > c["limit"]} == {"max_err"}


def test_the_references_method_is_w_times_x():
    """The hybrid method in float64 (diagonals, rotations, fold) leaves
    ``W x`` in every block of m slots, for the tiny layer and a 4 x 16 one."""
    tiny = dict(CFG, log_n=5, log_slots=4, secret_hamming_weight=8, rows=4, cols=16)
    for cfg, pool in ((CFG, 3), (tiny, 2)):
        _, w, x = ref_matvec.draw(cfg, pool, SEED)
        assert np.allclose(ref_matvec.hybrid(w, x), ref_matvec.expected(w, x), rtol=0, atol=1e-12)
        d = ref_matvec.diagonals(w)
        m, n = w.shape
        assert all(d[k, i] == w[i % m, (i + k) % n] for k in (0, m - 1) for i in (0, n - 1))


def test_work_file_is_the_references():
    cfg = run.load_json("configs", "ckks_pn14qp438")
    moduli = ref_ckks.moduli(cfg)
    scale, level, divided = app.result_form(cfg)
    assert (level, divided) == (8, [9]) and abs(np.log2(scale) - 34) < 1e-3
    work = run.load_json("work", REAL)
    assert work["cell"] == REAL
    assert work["transforms"] == ref_matvec.work(
        moduli["q"], len(moduli["p"]), 1 << cfg["log_n"], len(moduli["q"]) - 1, cfg["rows"],
        cfg["baby_steps"], 1 << cfg["log_slots"], divided)
    # 10 + 50 (hoisted), 63 x 24 (baby ModDowns), 18 x 84 (giant, fold), 2 + 18 (rescale)
    assert sum(t["rows"] * t["count"] for t in work["transforms"]) == 3104


@pytest.mark.parametrize("metric,counter,value", [
    ("scheme.rotations_per_req", "ckks.rotations", 81),
    ("scheme.decompositions_per_req", "ckks.decompositions", 19)])
def test_linear_layer_readers(monkeypatch, metric, counter, value):
    read = run.load_module("metrics", metric).read
    rec = run.Record([0.01], [0.001], 1.0, 1.0, 0, None, {}, None)
    monkeypatch.setattr(profiling, "counters", lambda replayed=False: {
        counter: 3 * value, "tjit.replays": 3})
    assert read(rec) == value
    monkeypatch.setattr(profiling, "counters", lambda replayed=False: {"tjit.replays": 3})
    assert read(rec) is None  # the other cells' programs, and the parent's
    monkeypatch.delattr(profiling, "counters")
    assert read(rec) is None


@pytest.mark.chip
def test_the_cell_on_the_card(cuda_device):
    """The cell's program at PN14QP438 and its 1024 x 8192 layer: two pool
    entries, each replay equal to ``mul_matrix_hybrid`` run eagerly, bit for
    bit, 81 rotations and 19 decompositions a replay, and the reference's
    checks within the cell's limits."""
    cfg = run.load_json("configs", "ckks_pn14qp438")
    wl = dict(run.load_json("workloads", REAL), pool=2)
    a = app.App(cfg, wl, 2**31 + 5, cuda_device)
    ev = ckks.Evaluator(app.parameters(cfg), device=cuda_device)
    profiling.reset()
    answers = {}
    for k in (0, 1, 0, 1):  # the first call captures, the others replay
        answers[k] = a.call(k)
    for k in (0, 1):
        eager = ckks.mul_matrix_hybrid(ev, a.cts[k], a.diags, a.rot_keys)
        assert eager.scale == answers[k].scale
        assert all(torch.equal(x, y) for x, y in zip(eager.value, answers[k].value))
    assert not torch.equal(answers[0].value[0], answers[1].value[0])
    c = profiling.counters(replayed=True)
    assert c["tjit.replays"] == 3
    assert (c["ckks.rotations"], c["ckks.decompositions"]) == (3 * 81, 3 * 19)
    assert c["ckks.linear.pt_products"] == 3 * 1024
    got = a.judge(answers)
    assert all(got[k] <= v for k, v in wl["limits"].items()), got
