"""The training cell's check on a tiny copy at the CPU: a sound run is
correct, and each fault a training step can have (a step that leaves its
state unchanged; half of the batch left out, the mean taken over the
rest) fails one of the numbers compared; the control (the reference
with fp8 weights in its forward) fails one too. The window's first step
is among those checked: a window step whose loss is not finite fails."""
from __future__ import annotations

import json

import pytest

from portbench.tests.conftest import TINY, run_cell

LIMITS = {"loss_gap": 0.01, "grad_gap": 0.01, "change_gap": 0.1,
          "grad_diff": 0.08, "window_nonfinite": 0}



@pytest.fixture
def cell(tree):
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    cfg = json.loads((tree / "portbench/configs/mistral-7b.json").read_text())
    cfg.update(TINY)
    cfg.pop("engine")
    cfg["limits"] = LIMITS
    (tree / "portbench/configs/tinystage.json").write_text(json.dumps(cfg))
    job = json.loads((tree / "portbench/traffic/train.json").read_text())
    job.update(batch=4, seq=32, trace_after=1)
    # a larger step than the cell's, so bf16 leaves move by more than
    # their rounding at these small widths
    job["optimizer"]["lr"] = 3e-3
    (tree / "portbench/traffic/tinytrain.json").write_text(json.dumps(job))
    bench["configs"].append({"name": "tinystage", "source": "tiny",
                             "file": "portbench/configs/tinystage.json",
                             "reduced": [], "why": "a CPU test's"})
    bench["workloads"].append({"name": "tiny.train", "config": "tinystage",
                               "traffic": "tinytrain", "chips": 1,
                               "why": "a CPU test's"})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    return tree, "tiny.train"


def test_sound_run_is_correct_and_control_fails(cell):
    tree, name = cell
    out = run_cell(tree, name, "--control", "fp8", seed=2 ** 31 + 5)
    assert out["correct"] is True, out["checks"]
    ctl = out["controls"]
    assert any(ctl["fp8"][k] > v for k, v in LIMITS.items()), ctl


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "window_update_skipped"])
def test_fault_is_not_correct(cell, fault):
    tree, name = cell
    out = run_cell(tree, name, seed=2 ** 31 + 6,
                   entry=("-m", "portbench.faults", fault))
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
