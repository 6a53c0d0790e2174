"""The readings a serving cell's limit is set from, in one process:
for each seed, the cell's own run (its traffic at its load, a short
window) and, at the same served positions, the control: the reference
in a lower precision (``--control``), whose first choices are judged by
the float32 reference as the program's tokens are.

    python -m portbench.calibrate --workload <cell> --seeds 1,2,3 \\
        --seconds 10 --control fp8

One JSON line a seed, then the summary: the largest program reading
(the lower end of the limit), the smallest control reading (the upper
end) and their ratio. The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from types import SimpleNamespace

import torch

from portbench import spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="append", default=[],
                   choices=("int8", "fp8"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.find_cell(bench, args.workload)
    cfg = spec.load_config(bench, cell["config"])
    mix = spec.load_traffic(cell["traffic"])
    driver = spec.kind_driver(mix["kind"])

    def sleep_until(t):
        while time.perf_counter() < t:
            time.sleep(min(0.05, max(0.0, t - time.perf_counter())))

    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = SimpleNamespace(seed=seed, seconds=args.seconds, trace=False,
                              cell=cell, config=cfg, traffic=dict(mix),
                              device=torch.device(args.device),
                              controls=args.control, sleep_until=sleep_until)
        run = driver.run(ctx)
        d = run["check_detail"]
        row = {"seed": seed, **d}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del run
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    # per number: the program's largest reading (the lower end of a
    # limit) and each control's smallest (the upper end)
    out = {"seeds": len(rows), "lower": {}, "upper": {}}
    for key in rows[0]["program"]:
        out["lower"][key] = max(r["program"][key] for r in rows)
        for c in args.control:
            out["upper"].setdefault(c, {})[key] = min(
                r[f"control_{c}"][key] for r in rows)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
