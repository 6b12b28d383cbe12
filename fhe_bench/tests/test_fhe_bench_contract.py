"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name: workload, configuration, request kind, work file, metric
readers and kernel-name sets.  Nothing here runs the port."""

import ast
import importlib
import json
import re
from pathlib import Path

import pytest

from fhe_bench import run

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PORT = "lattigo_tpu_torch"


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and (REPO / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"] == f"fhe_bench/configs/{c['name']}.json"
        assert run.load_json("configs", c["name"])["reduced"] == c["reduced"] == []


def test_workloads():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["chips"] in (1, 4)
        wl = run.load_json("workloads", w["name"])
        assert wl["config"] == w["config"]
        app = importlib.import_module(f"fhe_bench.apps.{wl['app']}")
        assert hasattr(app, "App")
        assert (REPO / "fhe_bench" / "work" / f"{w['name']}.json").exists()
        assert set(wl["limits"]) >= {"bad_form", "out_of_range"}


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    metrics = BENCH[kind]
    assert 1 <= len(metrics) <= (16 if kind == "end_to_end" else 128)
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in metrics:
        keys = {"name", "unit", "better", "source"} | (
            {"bound"} if kind == "end_to_end" else {"layer", "moves"})
        assert set(m) - {"workloads"} == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert callable(run.load_module("metrics", m["name"]).read)
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            assert one_line(m["layer"])
            assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    if kind == "end_to_end":
        assert "setup_s" in {m["name"] for m in metrics}


def test_kernel_sets_load_by_name():
    sets = run.kernel_sets()
    assert {"ntt", "modarith", "key_switch"} <= set(sets)
    for name, names in sets.items():
        doc = run.load_json("kernels", name)
        for src in doc["sources"]:
            assert (REPO / src).exists()
        assert names and all(isinstance(n, str) and n for n in names)


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(p.relative_to(REPO).as_posix()
                                        for p in (REPO / "fhe_bench").rglob("*.py")))
def test_no_jax_import(path):
    found = _imports(REPO / path)
    assert not found & {"jax", "jaxlib", "flax", "lattigo_tpu"}, found
    if path.startswith("fhe_bench/reference/"):
        assert PORT not in found  # the reference takes nothing from the program
