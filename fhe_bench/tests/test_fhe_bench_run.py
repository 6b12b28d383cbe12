"""The harness end to end on the CPU: a tiny cell run through ``run.main``
in a process of its own (the look for a chip skipped), the result line's
keys, no module of JAX or the JAX package loaded; no result without a card
or without the program; the metric readers on a made-up trace."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from fhe_bench import run, trace

REPO = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]

DRIVER = """
import json, sys, torch
from fhe_bench import run
from fhe_bench.tests.data import tiny
cells = {("workloads", n): w for n, (w, _) in tiny.CELLS.items()}
cells.update({("configs", w["config"]): c for w, c in tiny.CELLS.values()})
real = run.load_json
run.load_json = lambda kind, name: cells.get((kind, name)) or real(kind, name)
run.load_bench = tiny.bench
run.require_device = lambda chips: torch.device("cpu")
torch.cuda.set_device = lambda device: None
rc = run.main(sys.argv[1:])
print(json.dumps(dict(rc=rc, banned=run.banned_modules())), file=sys.stderr)
"""


def harness(args, cwd=REPO, driver=DRIVER):
    return subprocess.run([sys.executable, "-c", driver, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=600)


@pytest.mark.parametrize("cell", ["tiny.pir", "tiny.ckks"])
def test_tiny_cell_end_to_end(cell):
    out = harness(["--workload", cell, "--seed", str(2**31 + 5), "--seconds", "2", "--trace", "0"])
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == KEYS
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"req_per_s", "latency_p50_ms", "latency_p95_ms", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    tail = out.stderr.strip().splitlines()
    assert json.loads(tail[-1]) == dict(rc=0, banned=[])
    assert all(t.startswith("check ") for t in tail[-1 - len(line["checks"]):-1])


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "fhe_bench.run", "--workload", "pir_pn13qp218.rows8",
                          "--seed", "1", "--seconds", "1"], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's folder."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "fhe_bench", tmp_path / "fhe_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = harness(["--workload", "tiny.pir", "--seed", "1", "--seconds", "1"], cwd=tmp_path,
                  driver="import sys; sys.path[0] = '.'\n" + DRIVER)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "lattigo_tpu_torch" in out.stderr


def made_up_slice() -> trace.Slice:
    ops = [trace.Op("ntt_row<3>", "kernel", 0, 40), trace.Op("modred_kernel", "kernel", 50, 60),
           trace.Op("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 60, 70),
           trace.Op("elementwise_kernel", "kernel", 80, 100)]
    host = [trace.Op("fhe_bench.sync", "user_annotation", 70, 80)]
    return trace.Slice(requests=2, start=0, end=200, device=ops, host=host)


def test_metric_readers_on_a_made_up_trace():
    rec = run.Record(latencies=[0.01, 0.02, 0.03], spans=[0.001, 0.002, 0.003], window_s=0.5,
                     setup_s=12.0, memory_peak_bytes=2 * 10**9, slice=made_up_slice(),
                     sets=dict(ntt=["ntt_row"], modarith=["modred_kernel"]),
                     work=dict(transforms=[dict(rows=3, limbs=3, n=8192, count=1)]))
    read = lambda name: run.load_module("metrics", name).read(rec)
    assert read("req_per_s") == pytest.approx(6.0)
    assert read("latency_p50_ms") == pytest.approx(20.0)
    assert read("peak_mem_gb") == pytest.approx(2.0)
    assert read("tjit.call_ms") == pytest.approx(2.0)
    assert read("scheme.kernels_per_req") == pytest.approx(1.5)
    assert read("kernels.torch_ms") == pytest.approx(0.015)  # the copy and the elementwise kernel
    assert read("device.idle_pct") == pytest.approx(100 * (1 - 80 / 200))
    from fhe_bench import roofline

    want = 100 * roofline.ntt_bound_s(3, 3, 8192) / (40e-6 / 2)
    assert read("ntt_roofline") == pytest.approx(want)
    gaps = made_up_slice().breakdown()["idle_gaps"]
    assert gaps[0] == ["none", pytest.approx(100e-6)] and ["fhe_bench.sync", pytest.approx(10e-6)] in gaps


def test_readers_find_nothing_without_a_trace():
    rec = run.Record([0.01], [0.001], 1.0, 1.0, 0, None, {}, None)
    for name in ("scheme.kernels_per_req", "ntt_roofline", "kernels.torch_ms", "device.idle_pct",
                 "peak_mem_gb"):
        assert run.load_module("metrics", name).read(rec) is None


@pytest.mark.chip
def test_a_cell_on_the_card(cuda_device):
    """The smallest cell, a short window, on the card: correct, every
    end-to-end metric, the card named."""
    out = subprocess.run([sys.executable, "-m", "fhe_bench.run", "--workload", "pir_pn13qp218.rows8",
                          "--seed", str(2**31 + 11), "--seconds", "3", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {m["name"] for m in run.load_bench()["end_to_end"]}
