"""A later change adds a cell by adding files only: a configuration, a
traffic file and a metric module, found by name. In a copy of the tree,
the harness runs such a new cell's CPU path with no edit to any file of
``portbench/`` that was there."""
from __future__ import annotations

import hashlib
import json

from portbench.tests.conftest import add_cell, run_cell

METRIC = '''"""Requests due in the window (a test's metric)."""


def read(run):
    t0, t1 = run["window"]
    return float(sum(1 for r in run["requests"] if t0 <= r["due"] < t1))
'''


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_runs_from_new_files_alone(tree):
    before = digests(tree)
    cell = add_cell(tree, "added", limit=0.05)
    (tree / "portbench/metrics/due.added.py").write_text(METRIC)
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "due.added", "unit": "requests", "better": "higher",
        "source": "host_clock", "layer": "serving loop",
        "moves": "ttft_p95_ms", "workloads": [cell]})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digests(tree)
    assert all(after[k] == v for k, v in before.items())
    out = run_cell(tree, cell, trace=1)
    assert out["metrics"]["due.added"]["value"] >= 1
    assert out["device"]["platform"] == "cpu"
    out = run_cell(tree, cell, trace=0)
    assert set(out["metrics"]) == {"ttft_p95_ms", "itl_p95_ms", "setup_s"}
    assert out["correct"] is True
    assert list(out)[-1] == "checks"
