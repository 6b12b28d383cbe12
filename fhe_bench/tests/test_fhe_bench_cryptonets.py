"""CryptoNets' cell (``cryptonets_pn14qp438.b8192``, request kind
``cryptonets``): a tiny cell at log N = 9 with PN14QP438's moduli sizes, a
6 x 6 image padded to 7 x 7 and 20 -> 6 -> 10 layers, run on the CPU
through ``run.run_cell``, sound and with the timed path broken underneath
(a weight dropped, two logits swapped, a level dropped, the nominal scale,
a word out of range), each fault and both controls (the scale 2^30,
float16 weights) making ``correct`` false; the reference's network against
the convolution written out; the cell's work file against the reference's
``work()``; the readers of ``scheme.relins_per_req`` and
``ct_matrix_roofline``; and, on a card, the cell's program at its full size
replayed bit-equal to the eager network, 945 relinearizations a replay."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fhe_bench import ct_matrix_roofline, run, trace
from fhe_bench.apps import cryptonets as app
from fhe_bench.reference import ckks as ref_ckks
from fhe_bench.reference import cryptonets as ref_net
from lattigo_tpu_torch.models import ckks
from lattigo_tpu_torch.utils import profiling

HERE = Path(__file__).resolve().parent
CPU = torch.device("cpu")
SEED = 2**31 + 93
CELL = "tiny.b256"
CFG = json.loads((HERE / "data" / "tiny_cryptonets.json").read_text())
# the toy's readings (6 seeds, CPU, tests/test_torch_cryptonets_cell.py): sound 9.2e-8 –
# 1.6e-7, the scale 2^30 1.3e-6 – 2.5e-6, float16 weights 6.5e-4 – 8.9e-4
WL = dict(config="tiny_cryptonets", app="cryptonets", batch=[36], pool=2,
          limits=dict(bad_form=0, limb_mismatch=0, max_err=4.5e-7, out_of_range=0))
REAL = "cryptonets_pn14qp438.b8192"


def bench() -> dict:
    real = run.load_bench()
    return dict(real, workloads=[dict(name=CELL, config="tiny_cryptonets", traffic="b256",
                                      chips=1, why="test")])


def run_tiny(factory=None, cfg=CFG):
    return run.run_cell(CELL, WL, cfg, SEED, 2.0, False, CPU, bench(), app_factory=factory)


def broken(fault: str):
    class Broken(app.App):
        def __init__(self, *args):
            super().__init__(*args)
            if fault == "weight":  # one weight of the first dense layer left out
                self.net.dense1.values[7] = 0

        def call(self, k):
            out = super().call(k)
            if fault == "swap":  # logits 2 and 3 exchanged
                out = ckks.Ciphertext([v[[0, 1, 3, 2, 4, 5, 6, 7, 8, 9]] for v in out.value],
                                      out.scale)
            elif fault == "dropped":  # one level too few
                out = ckks.Ciphertext([v[..., :-1, :] for v in out.value], out.scale)
            elif fault == "scale":  # the nominal scale, not the one the rescales leave
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


@pytest.mark.parametrize("fault", ["weight", "swap", "dropped", "scale", "range"])
def test_fault_makes_correct_false(fault):
    result, checks = run_tiny(broken(fault))
    assert not result["correct"], checks
    failed = {k for k, c in checks.items() if c["value"] > c["limit"]}
    assert failed == {"weight": {"max_err"}, "swap": {"max_err"}, "dropped": {"bad_form"},
                      "scale": {"bad_form"}, "range": {"out_of_range"}}[fault], checks


@pytest.mark.parametrize("control", ["scale", "float16"])
def test_control_is_not_correct(control):
    """The scale 2^30, and float16 weights and biases: the precision below
    the configuration's."""
    result, checks = run_tiny(cfg=app.control_config(CFG, control))
    assert not result["correct"], checks
    assert {k for k, c in checks.items() if c["value"] > c["limit"]} == {"max_err"}


def test_the_references_network_is_the_convolution_written_out():
    """The reference's conv2d of stride 2 on the padded images, its squares
    and dense layers, against the same network in numpy loops."""
    secret, w, pixels = ref_net.draw(CFG, 1, SEED)
    assert secret.shape == (512,) and np.count_nonzero(secret) == 32
    other = ref_net.draw(CFG, 1, SEED + 1)  # one model at every seed, other images
    assert all(np.array_equal(w[k], other[1][k]) for k in w)
    assert not np.array_equal(pixels, other[2])
    x = pixels[0, :5]
    got = ref_net.expected(CFG, w, x)
    padded = np.zeros((5, 7, 7))
    padded[:, :6, :6] = x
    conv = np.empty((5, 5, 2, 2))
    for m in range(5):
        for i in range(2):
            for j in range(2):
                conv[:, m, i, j] = (padded[:, 2 * i:2 * i + 5, 2 * j:2 * j + 5]
                                    * w["conv_w"][m]).sum((1, 2)) + w["conv_b"][m]
    h = (conv.reshape(5, -1) ** 2) @ w["w1"].T + w["b1"]
    want = (h ** 2) @ w["w2"].T + w["b2"]
    assert np.allclose(got, want, rtol=0, atol=1e-12)


def test_work_file_is_the_references():
    cfg = run.load_json("configs", "cryptonets_pn14qp438")
    moduli = ref_ckks.moduli(cfg)
    scale, level = app.result_form(cfg)
    assert level == 4 and abs(np.log2(scale) - 34) < 1e-2
    work = run.load_json("work", REAL)
    assert work["cell"] == REAL
    assert {k: work[k] for k in ("transforms", "layers")} == ref_net.work(
        cfg, moduli["q"], len(moduli["p"]))
    assert [(lay["outputs"], lay["inputs"], lay["nonzeros"], lay["limbs"])
            for lay in work["layers"]] == [(845, 784, 20480, 10), (100, 845, 84500, 8),
                                           (10, 100, 1000, 6)]
    # 845 x 77 + 100 x 54 (relinearizations at levels 8 and 6), 845 x 20 + 845 x 18
    # + 100 x 16 + 100 x 14 + 10 x 12 (the five rescales)
    assert sum(t["rows"] * t["count"] for t in work["transforms"]) == 105695


def test_relinearization_reader(monkeypatch):
    read = run.load_module("metrics", "scheme.relins_per_req").read
    rec = run.Record([0.01], [0.001], 1.0, 1.0, 0, None, {}, None)
    monkeypatch.setattr(profiling, "counters", lambda replayed=False: {
        "ckks.relinearized": 3 * 945, "tjit.replays": 3})
    assert read(rec) == 945
    monkeypatch.setattr(profiling, "counters", lambda replayed=False: {"tjit.replays": 3})
    assert read(rec) is None  # the other cells' programs, and the parent's
    monkeypatch.delattr(profiling, "counters")
    assert read(rec) is None


def test_roofline_reader():
    """The yardstick of the cell's layers over the ``ct_matrix`` set's
    device time a request; nothing without the kernel, the set or the
    layers."""
    read = run.load_module("metrics", "ct_matrix_roofline").read
    work = run.load_json("work", REAL)
    bound = ct_matrix_roofline.work_bound_s(work)
    assert 1.5e-3 < bound < 2.5e-3  # the convolution's 4.3 GB bound it most
    ops = [trace.Op("void ct_matrix_kernel<8>(Args)", "kernel", 0, 2000),
           trace.Op("ntt_cluster", "kernel", 2000, 9000)]
    s = trace.Slice(2, 0, 10000, ops, [])
    sets = dict(run.kernel_sets())
    rec = run.Record([0.01], [0.001], 1.0, 1.0, 0, s, sets, work)
    assert read(rec) == pytest.approx(100 * bound / 1e-3)
    for other in (dict(sets, ct_matrix=["nothing"]), {k: v for k, v in sets.items()
                                                       if k != "ct_matrix"}):
        assert read(run.Record([0.01], [0.001], 1.0, 1.0, 0, s, other, work)) is None
    no_layers = {k: v for k, v in work.items() if k != "layers"}
    assert read(run.Record([0.01], [0.001], 1.0, 1.0, 0, s, sets, no_layers)) is None


@pytest.mark.chip
def test_the_cell_on_the_card(cuda_device):
    """The cell's program at PN14QP438, 784 pixels of 8192 images: two
    pool entries, each replay equal to the network run eagerly, bit for
    bit, 945 relinearizations and 105980 plaintext products a replay, and
    the reference's checks within the cell's limits."""
    cfg = run.load_json("configs", "cryptonets_pn14qp438")
    wl = dict(run.load_json("workloads", REAL), pool=2)
    a = app.App(cfg, wl, 2**31 + 5, cuda_device)
    ev = ckks.Evaluator(app.parameters(cfg), device=cuda_device)
    profiling.reset()
    answers = {}
    for k in (0, 1, 0, 1):  # the first call captures, the others replay
        answers[k] = a.call(k)
    for k in (0, 1):
        eager = a.net.forward(ev, a.cts[k], a.rlk)
        assert eager.scale == answers[k].scale
        assert all(torch.equal(x, y) for x, y in zip(eager.value, answers[k].value))
    assert not torch.equal(answers[0].value[0], answers[1].value[0])
    c = profiling.counters(replayed=True)
    assert c["tjit.replays"] == 3
    assert c["ckks.relinearized"] == 3 * 945
    assert c["ckks.ct_matrix.products"] == 3 * (20480 + 84500 + 1000)
    got = a.judge(answers)
    assert all(got[k] <= v for k, v in wl["limits"].items()), got
