"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's traffic file names the driver (``kinds/<kind>.py``) that
builds the system from the configuration file, makes the weights and the
requests from ``--seed``, warms up every shape it will use, measures for
``--seconds`` and checks what the timed path produced against the plain
reference. With ``--trace 0`` the result carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics; each metric is read by
``metrics/<name>.py``. The last line of standard output is the JSON
result; the numbers compared for ``correct`` close standard error, each
beside its limit.

``--device cpu`` runs the same path on the CPU (for the tests' tiny
cells); ``--control P`` also reads the reference in precision P at the
same positions (the control, for setting a limit).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# top-level modules the run may not hold once its window has closed
BARRED = ("jax", "jaxlib", "flax", "nos_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def barred_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BARRED))


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's nvcc libraries are already under ``nos_tpu_torch/_build``)."""
    cache = ROOT / ".portbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--control", action="append", default=[],
                   choices=("int8", "fp8"))
    return p.parse_args(argv)


def finite(v):
    return v is not None and isinstance(v, (int, float)) and math.isfinite(v)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    from portbench import spec

    bench = spec.load_benchmark(ROOT)
    cell = spec.find_cell(bench, args.workload)
    config = spec.load_config(bench, cell["config"], ROOT)
    mix = spec.load_traffic(cell["traffic"])
    metrics = spec.cell_metrics(bench, cell["name"], bool(args.trace))
    readers = {m["name"]: spec.metric_reader(m["name"]) for m in metrics}
    driver = spec.kind_driver(mix["kind"])

    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available():
            log("no CUDA device: the benchmark measures the card")
            return 3
        if torch.cuda.device_count() < cell["chips"]:
            log(f"{torch.cuda.device_count()} CUDA devices, the cell asks "
                f"for {cell['chips']}")
            return 3
    device = torch.device(args.device)

    def sleep_until(t: float) -> None:
        while True:
            left = t - time.perf_counter()
            if left <= 0:
                return
            time.sleep(min(left, 0.05))

    ctx = SimpleNamespace(seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), cell=cell, config=config,
                          traffic=mix, device=device, controls=args.control,
                          sleep_until=sleep_until)
    run = driver.run(ctx)
    found = barred_modules()
    if found:
        log(f"the run loaded {', '.join(found)}: the benchmark measures the "
            f"port alone")
        return 4
    run.update(config=config, traffic=mix, cell=cell, seconds=args.seconds,
               setup_s=run["window"][0] - T_START)
    values = {}
    for m in metrics:
        v = readers[m["name"]](run)
        if finite(v):
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"] if cuda else 1,
           "memory_peak_bytes": run["memory_peak_bytes"]}
    if cuda:
        dev["power_limit_w"] = power_limit_w()
    out = {"correct": bool(run["correct"]), "attempted": run["attempted"],
           "failed": run["failed"], "metrics": values, "device": dev}
    tr = run.get("trace")
    if args.trace and tr:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    detail = run.get("check_detail", {})
    controls = {k[len("control_"):]: v for k, v in detail.items()
                if k.startswith("control_")}
    out["program"] = detail.get("program")
    if controls:
        out["controls"] = controls
    out["timing"] = run.get("timing", {})
    out["checks"] = {k: dict(c, compared=detail.get("tokens"))
                     for k, c in run["checks"].items()}
    for k, c in run["checks"].items():
        log(f"check {k}: {c['value']} limit {c['limit']} "
            f"({detail.get('tokens')} compared of "
            f"{detail.get('sequences')} {detail.get('unit', 'requests')})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
