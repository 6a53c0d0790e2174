"""On the card, at each cell's own size: the program's readings on three
fresh seeds sit within the configuration's limits, and each control (the
reference in a lower precision at the same positions or steps) breaks
at least one.
Run on the card with ``python -m pytest portbench/tests -m card``; it
skips where there is no CUDA device."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.spec import ROOT, load_benchmark, load_config

BENCH = load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
SEEDS = "2500000001,2500000002,2500000003"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_within_and_control_outside(card, cell):
    cfg = load_config(BENCH, next(c["config"] for c in BENCH["workloads"]
                                  if c["name"] == cell))
    limits = cfg["limits"]
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.calibrate", "--workload", cell,
         "--seeds", SEEDS, "--seconds", "20",
         *(a for c in cfg["control"] for a in ("--control", c))],
        cwd=ROOT, capture_output=True, text=True, timeout=3600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rows = [json.loads(l) for l in proc.stdout.splitlines() if l.strip()]
    for row in rows[:-1]:
        assert all(row["program"][k] <= v for k, v in limits.items()), row
        for c in cfg["control"]:
            ctl = row[f"control_{c}"]
            assert any(ctl[k] > v for k, v in limits.items()), (c, row)
