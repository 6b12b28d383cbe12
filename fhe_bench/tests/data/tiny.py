"""Tiny cells of the two request kinds for the CPU tests: the dBFV PIR at
log N = 8 and CKKS at log N = 10 with PN16QP1761's scale."""

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent

PIR_CFG = json.loads((HERE / "tiny_pir.json").read_text())
CKKS_CFG = json.loads((HERE / "tiny_ckks.json").read_text())
PIR_WL = dict(config="tiny_pir", app="pir_cloud", rows=8, pool=4,
              limits=dict(bad_form=0, wrong_slots=0, noise=0.5, out_of_range=0))
CKKS_WL = dict(config="tiny_ckks", app="ckks_mul_relin_rescale", batch=[4], pool=2,
               limits=dict(bad_form=0, limb_mismatch=0, max_err=1e-8, out_of_range=0))
CELLS = {"tiny.pir": (PIR_WL, PIR_CFG), "tiny.ckks": (CKKS_WL, CKKS_CFG)}


def bench() -> dict:
    """BENCHMARK.json's metrics, with the tiny cells for workloads."""
    real = json.loads((HERE.parents[2] / "BENCHMARK.json").read_text())
    return dict(real, workloads=[dict(name=n, config=w["config"], traffic=n.split(".")[1], chips=1,
                                      why="test") for n, (w, _) in CELLS.items()])
