"""The files a cell is made of, found by name from ``BENCHMARK.json``."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Optional

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(__file__).resolve().parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            cfg = json.loads((root / c["file"]).read_text())
            cfg["name"] = name
            return cfg
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def load_traffic(name: str, pkg: Path = PKG) -> dict:
    mix = json.loads((pkg / "traffic" / f"{name}.json").read_text())
    mix["name"] = name
    return mix


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``. A metric
    without ``workloads`` belongs to every cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell in m["workloads"]]


def metric_reader(name: str, pkg: Path = PKG) -> Callable[[dict], Optional[float]]:
    """``read(run)`` of ``metrics/<name>.py`` (a name may hold dots, so
    the file is loaded by its path)."""
    path = pkg / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kind_driver(kind: str):
    """The driver module ``kinds/<kind>.py`` a traffic file names."""
    return importlib.import_module(f"portbench.kinds.{kind}")
