"""The readers of the metrics the program records itself (its spans and
counters, ``lattigo_tpu_torch/utils/profiling.py``) on a made-up recorder
state, on the recorder of a tiny program run on the CPU, and on a program
without a recorder, where they find nothing and do not raise."""

import pytest
import torch

from fhe_bench import run
from lattigo_tpu_torch import tjit
from lattigo_tpu_torch.utils import profiling

NEW = ("tjit.launch_ms", "tjit.signature_ms", "tjit.copy_in_ms", "tjit.copy_in_mb",
       "ntt.work_pct", "setup.tables_s")
WORK = dict(transforms=[dict(rows=24, limbs=3, n=8192, count=2),
                        dict(rows=10, limbs=5, n=8192, count=3)])  # 78 rows a request


def record(work=WORK) -> run.Record:
    return run.Record([0.01], [0.001], 1.0, 1.0, 0, None, {}, work)


def read(name: str, rec: run.Record):
    return run.load_module("metrics", name).read(rec)


def test_every_new_metric_is_declared():
    per_layer = {m["name"]: m for m in run.load_bench()["per_layer"]}
    for name in NEW:
        assert per_layer[name]["source"] in ("program_span", "program_counter")
        assert "workloads" not in per_layer[name]


def test_readers_on_a_made_up_recorder(monkeypatch):
    agg = {"tjit.replay": dict(count=5, total_s=1.0, recent_s=[4e-5, 1e-5, 3e-5, 2e-5, 9e-3]),
           "tjit.signature": dict(count=2, total_s=1.0, recent_s=[1e-4, 3e-4]),
           "tjit.copy_in.device": dict(count=3, total_s=1.0, recent_s=[3e-4, 2e-4, 1e-4]),
           "ring.tables": dict(count=40, total_s=12.5, recent_s=[0.3])}
    counted = {"tjit.replays": 4, "tjit.copy_in_bytes": 4 * 430_000_000,
               "ntt.rows.mxu": 4 * 60, "ntt.rows.tile": 4 * 20, "launches.modred": 4 * 7}
    monkeypatch.setattr(profiling, "aggregates", lambda: agg)
    monkeypatch.setattr(profiling, "counters", lambda replayed=False: dict(counted))
    rec = record()
    assert read("tjit.launch_ms", rec) == pytest.approx(0.03)
    assert read("tjit.signature_ms", rec) == pytest.approx(0.2)
    assert read("tjit.copy_in_ms", rec) == pytest.approx(0.2)
    assert read("tjit.copy_in_mb", rec) == pytest.approx(430.0)
    assert read("ntt.work_pct", rec) == pytest.approx(100 * 78 / 80)
    assert read("setup.tables_s", rec) == pytest.approx(12.5)
    assert read("ntt.work_pct", record(work=None)) is None


def test_readers_find_nothing_in_an_empty_recorder(monkeypatch):
    monkeypatch.setattr(profiling, "aggregates", lambda: {})
    monkeypatch.setattr(profiling, "counters", lambda replayed=False: {})
    for name in NEW:
        assert read(name, record()) is None, name


def test_readers_find_nothing_without_a_recorder(monkeypatch):
    """The parent's program has ``utils/profiling.py`` without the recorder."""
    monkeypatch.delattr(profiling, "aggregates")
    monkeypatch.delattr(profiling, "counters")
    for name in NEW:
        assert read(name, record()) is None, name


def test_readers_on_a_program_run_on_the_cpu():
    """A CPU program's calls: signature spans and copy-in bytes; no replay
    of a graph, no device time, no rows replayed."""
    profiling.reset()
    f = tjit.tjit(lambda a, b: a * b + 1)
    x = torch.arange(1000, dtype=torch.int64)
    for _ in range(4):
        f(x, x)
    assert read("tjit.signature_ms", record()) > 0
    assert read("tjit.copy_in_mb", record()) == pytest.approx(2 * 8000 / 1e6)
    for name in ("tjit.launch_ms", "tjit.copy_in_ms", "ntt.work_pct"):
        assert read(name, record()) is None, name
    profiling.reset()


def test_a_tiny_traced_cell_reads_the_program():
    """``--trace 1`` on a tiny CPU cell: the program metrics that a CPU
    program has (no graph replay, no device) are on the result line."""
    import json

    from fhe_bench.tests.test_fhe_bench_run import harness

    out = harness(["--workload", "tiny.ckks", "--seed", str(2**31 + 9), "--seconds", "2",
                   "--trace", "1"])
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    got = line["metrics"]
    assert {"tjit.signature_ms", "tjit.copy_in_mb", "setup.tables_s"} <= set(got)
    assert got["tjit.copy_in_mb"]["value"] > 0 and got["setup.tables_s"]["unit"] == "s"
