"""Runs one cell of the benchmark of ``lattigo_tpu_torch`` on one NVIDIA GPU:

    python3 -m fhe_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``workloads/<cell>.json``) names its
configuration (``configs/<config>.json``), its request kind
(``apps/<app>.py``) and the traffic's parameters.  A run:

1. imports the port, and exits with code 2 and no result without a CUDA
   device, or with fewer than the cell's chips;
2. sets up: the app makes keys and inputs from the seed and compiles the
   cell's one ``tjit`` program (the first run of a checkout builds the
   port's CUDA kernels into ``lattigo_tpu_torch/build/``); a few warm-up
   requests follow;
3. measures for ``--seconds``: a closed loop with one caller, request i + 1
   issued once request i's result is on the device and the host has
   synchronised, pool entries in turn, each request timed from the call to
   that synchronise; a request that raises counts as failed;
4. with ``--trace 1``, profiles a slice of about a second from 40 % of the
   window on, after two requests under the profiler (``trace.py``), the
   window lasting until the slice is done;
5. reads the device's peak memory, frees the program and runs the reference
   on a sample of the answers drawn from the seed: for each pool entry, one
   of the requests that used it;
6. prints the numbers compared, each with its limit, as the last lines of
   standard error, and the result as the last line of standard output.

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics of
``BENCHMARK.json``, with ``--trace 1`` its per-layer ones; each is read by
``metrics/<name>.py`` from the run's record.  The run exits non-zero, with no
result, if a module of JAX or of the JAX package is loaded once the window
has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "lattigo_tpu")
WARMUP = 3  # requests after the capture, before the window
TRACE_AT = 0.4  # share of the window before the profiled slice
TRACE_S = 1.0  # the profiled slice's length, about
TRACE_PAD_S = 0.05  # idle time inside the session on either side of the slice
# requests profiled before the slice: slices that began with the session's
# first request held one idle gap of 60-90 ms
TRACE_WARMUP = 2


def process_age() -> float:
    """Seconds since this process started (Linux), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_START = _T0 - process_age()


def load_bench() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py``, found by its file name (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(f"fhe_bench.{kind}.{name}", HERE / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_sets() -> dict[str, list[str]]:
    """Every kernel-name set: ``kernels/<set>.json``'s ``names`` (substrings
    of the profiler's kernel names)."""
    return {p.stem: json.loads(p.read_text())["names"] for p in sorted((HERE / "kernels").glob("*.json"))}


@dataclasses.dataclass
class Record:
    """What a run measured; the metric readers take their numbers from it."""

    latencies: list[float]  # s, every request of the window
    spans: list[float]  # s, every request's program call, no synchronise inside
    window_s: float
    setup_s: float
    memory_peak_bytes: int
    slice: object  # trace.Slice of a traced run, else None
    sets: dict[str, list[str]]
    work: dict | None

    def in_set(self, name: str, kernel_set: str) -> bool:
        return any(s in name for s in self.sets[kernel_set])

    def in_any_set(self, name: str) -> bool:
        return any(self.in_set(name, k) for k in self.sets)


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def require_device(chips: int):
    """The first CUDA device; exits 2 where the cell's chips are not there."""
    import torch

    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < chips:
        print(f"fhe_bench: the cell needs {chips} CUDA device(s), {count} found", file=sys.stderr)
        sys.exit(2)
    return torch.device("cuda", 0)


def card() -> dict:
    """The card's power limit and SM clock, as nvidia-smi reads them now."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit,clocks.sm",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.splitlines()[0].split(",")
        return dict(power_limit_w=float(out[0]), sm_clock_mhz=float(out[1]))
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {}


def run_cell(cell: str, wl: dict, cfg: dict, seed: int, seconds: float, traced: bool, device,
             bench: dict, app_factory=None) -> tuple[dict, dict]:
    """One run of ``cell`` on ``device``; returns the result line's object
    and the numbers compared with their limits.  ``app_factory`` replaces
    the app module's ``App`` (the tests break the timed path with it)."""
    import torch

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t_in = time.perf_counter()
    app = (app_factory or importlib.import_module(f"fhe_bench.apps.{wl['app']}").App)(
        cfg, wl, seed, device)
    sync()
    t_app = time.perf_counter()
    peak = lambda: torch.cuda.max_memory_allocated(device) if cuda else 0
    peak_app = peak()
    for i in range(WARMUP + 1):  # the first call captures the program
        app.call(i % app.pool)
    sync()
    t_ready = time.perf_counter()
    print(f"fhe_bench: set-up {t_ready - _START:.3f} s: start to the app {t_in - _START:.3f}, "
          f"keys and inputs {t_app - t_in:.3f} (peak {peak_app} B), capture and warm-up "
          f"{t_ready - t_app:.3f} (peak {peak()} B)", file=sys.stderr)
    # A call's outputs can sit in a reference cycle (tjit's tree_unflatten)
    # until the collector runs; left to its automatic runs, whose timing the
    # seed's set-up shifts, it set the peak memory.  So in the window it runs
    # after every request, and only then.
    gc.collect()
    gc.freeze()
    gc.disable()

    pick = random.Random(seed)
    seen = [0] * app.pool
    answers: dict[int, object] = {}
    latencies, spans = [], []
    failed = attempted = 0
    prof = slice_at = slice_ends = mark = None
    slice_n = 0
    t_start = time.perf_counter()
    setup_s = t_start - _START
    k = 0
    while True:
        now = time.perf_counter()
        if now - t_start >= seconds and not (traced and (prof is None or slice_ends is not None)):
            break  # a traced run's window lasts until its slice is done
        if traced and prof is None and now - t_start >= TRACE_AT * seconds:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.start()
            time.sleep(TRACE_PAD_S)
            per = sorted(latencies)[len(latencies) // 2] if latencies else TRACE_S
            slice_at = len(latencies) + TRACE_WARMUP
            slice_ends = slice_at + max(3, round(TRACE_S / per))
        if slice_ends is not None and len(latencies) == slice_at and mark is None:
            mark = record_function("fhe_bench.slice")
            mark.__enter__()
        attempted += 1
        t0 = time.perf_counter()
        try:
            out = app.call(k)
            t1 = time.perf_counter()
            sync()
        except Exception as exc:  # a failed request: counted, and the loop goes on
            failed += 1
            print(f"fhe_bench: request {attempted} failed: {exc!r}", file=sys.stderr)
            k = (k + 1) % app.pool
            continue
        t2 = time.perf_counter()
        latencies.append(t2 - t0)
        spans.append(t1 - t0)
        seen[k] += 1
        if pick.random() * seen[k] < 1:  # one answer of each pool entry, uniformly
            answers[k] = out
        del out
        gc.collect(0)
        k = (k + 1) % app.pool
        if slice_ends is not None and len(latencies) == slice_ends:
            slice_n = slice_ends - slice_at
            mark.__exit__(None, None, None)
            time.sleep(TRACE_PAD_S)
            prof.stop()
            slice_ends = None
    window_s = time.perf_counter() - t_start

    memory_peak = peak()
    gpu = card() if cuda else {}
    cut = None
    if prof is not None:
        from fhe_bench import trace

        cut = trace.read(trace.export(prof), slice_n)
        del prof

    work_file = HERE / "work" / f"{cell}.json"
    record = Record(latencies, spans, window_s, setup_s, memory_peak, cut, kernel_sets(),
                    json.loads(work_file.read_text()) if work_file.exists() else None)
    metrics = {}
    for m in cell_metrics(bench, cell, "per_layer" if traced else "end_to_end"):
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])

    app.release()
    gc.enable()
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    got = app.judge(answers)
    limits = wl["limits"]
    checks = {name: dict(value=got[name], limit=limits[name]) for name in limits}
    checks["failed"] = dict(value=failed, limit=0)
    checks["answers_missing"] = dict(value=app.pool - len(answers), limit=0)
    correct = attempted > 0 and all(c["value"] <= c["limit"] for c in checks.values())

    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(device) if cuda else "cpu",
               count=1, memory_peak_bytes=memory_peak, **gpu)
    if cut is not None:
        dev.update(busy_s=cut.busy_s, window_s=cut.window_s)
    result = dict(correct=correct, attempted=attempted, failed=failed, metrics=metrics, device=dev)
    if cut is not None:
        result["breakdown"] = cut.breakdown()
    result["checks"] = checks
    return result, checks


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_bench()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"fhe_bench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    wl = load_json("workloads", args.workload)
    cfg = load_json("configs", wl["config"])
    import torch

    torch.set_num_threads(1)
    device = require_device(cells[args.workload]["chips"])
    torch.cuda.set_device(device)
    result, checks = run_cell(args.workload, wl, cfg, args.seed, args.seconds, bool(args.trace),
                              device, bench)
    found = banned_modules()
    if found:
        print(f"fhe_bench: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
