"""Runs of the tiny cells on the CPU with the timed path broken underneath
(the harness's look for a chip skipped): each fault a serving cell can have
must make ``correct`` false, as must each cell's control, and a sound run
must come out correct."""

import importlib

import pytest
import torch

from fhe_bench import run
from fhe_bench.tests.data import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 77  # more than 32 signed bits hold


def run_tiny(cell, factory=None, cfg=None, seed=SEED):
    wl, base_cfg = tiny.CELLS[cell]
    result, checks = run.run_cell(cell, wl, cfg or base_cfg, seed, 2.0, False, CPU, tiny.bench(),
                                  app_factory=factory)
    return result, checks


def broken(cell: str, fault: str):
    """The cell's App with one fault planted in its request."""
    wl, _ = tiny.CELLS[cell]
    base = importlib.import_module(f"fhe_bench.apps.{wl['app']}").App
    pir = wl["app"] == "pir_cloud"

    class Broken(base):
        def call(self, k):
            if fault == "unchanged":  # the input comes back as the answer
                return self.queries[k] if pir else self.pairs[k][0]
            if fault == "stale":  # the step returns the previous request's state
                return super().call((k - 1) % self.pool)
            if fault == "half" and pir:  # half of the rows left out of the sum
                half = self.masks.shape[0] // 2
                rows = type(self.rows)([v[:half] for v in self.rows.value])
                return self.program(self.queries[k], rows, self.masks[:half], self.rlk,
                                    self.rot_keys)
            out = super().call(k)
            if fault == "half":  # half of the batch not computed: the other half again
                half = out.value[0].shape[0] // 2
                for v in out.value:
                    v[half:] = v[:half]
            elif fault == "altered":  # one word of the answer altered where it is made
                out.value[0][..., 0, 5] ^= 1
            return out

    return Broken


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_run_is_correct(cell):
    result, checks = run_tiny(cell)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "stale", "half", "altered"])
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_fault_makes_correct_false(cell, fault):
    result, checks = run_tiny(cell, factory=broken(cell, fault))
    assert not result["correct"], checks


def test_pir_control_is_not_correct():
    """The deployment one modulus of Q lower: the precision below."""
    from fhe_bench.apps import pir_cloud

    result, checks = run_tiny("tiny.pir", cfg=pir_cloud.control_config(tiny.PIR_CFG))
    assert not result["correct"], checks


def test_ckks_control_is_not_correct():
    """The products in complex64 read above the cell's limit."""
    from fhe_bench.apps import ckks_mul_relin_rescale as app

    wl, cfg = tiny.CELLS["tiny.ckks"]
    for seed in (1, 2, 3):
        assert app.control_readings(cfg, wl, seed)["max_err"] > wl["limits"]["max_err"]


def test_a_request_that_raises_counts_as_failed():
    wl, _ = tiny.CELLS["tiny.pir"]
    base = importlib.import_module(f"fhe_bench.apps.{wl['app']}").App

    class Raising(base):
        calls = 0

        def call(self, k):
            Raising.calls += 1
            if Raising.calls == 6:  # the second request of the window
                raise RuntimeError("planted")
            return super().call(k)

    result, checks = run_tiny("tiny.pir", factory=Raising)
    assert result["failed"] == 1 and not result["correct"]
