"""The readings that a cell's limits are set from, on the chip:

    python3 -m fhe_bench.control --workload <cell> --seeds 1,2,3 [--sound] [--seconds 1]

For each seed, in one process: with ``--sound`` a short run of the cell
(``run.run_cell``: set-up, a closed loop for ``--seconds``, the reference on
one answer of each pool entry), which gives the lower readings; without it
the control, which has to come out as not correct: the app module's
``control_config`` (the deployment at the precision below the one its
configuration states) run the same way, or its ``control_readings`` (the
reference's own result computed at the precision below).  Prints one JSON
line a seed with the numbers compared, then one with the largest of each.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys

from fhe_bench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--sound", action="store_true", help="the program as configured")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)

    import torch

    bench = run.load_bench()
    wl = run.load_json("workloads", args.workload)
    cfg = run.load_json("configs", wl["config"])
    app = importlib.import_module(f"fhe_bench.apps.{wl['app']}")
    device = run.require_device(1)
    mode = "sound" if args.sound else "control"
    worst: dict[str, float] = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.sound or hasattr(app, "control_config"):
            conf = cfg if args.sound else app.control_config(cfg)
            res, checks = run.run_cell(args.workload, wl, conf, seed, args.seconds, False, device, bench)
            readings = {k: c["value"] for k, c in checks.items()}
            readings["correct"] = res["correct"]
        else:
            readings = app.control_readings(cfg, wl, seed)
        print(json.dumps(dict(workload=args.workload, mode=mode, seed=seed, **readings)), flush=True)
        for k, v in readings.items():
            if not isinstance(v, bool):
                worst[k] = max(worst.get(k, v), v)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(dict(workload=args.workload, mode=mode, largest=worst)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
