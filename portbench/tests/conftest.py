"""Shared fixtures of the benchmark's own tests: a tiny copy of the
benchmark tree whose cells run the harness's whole path on the CPU, and
the card fixture that skips a card test where there is none."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
            num_key_value_heads=2, num_hidden_layers=2, vocab_size=256,
            max_position_embeddings=256, sliding_window=None)
TINY_ENGINE = dict(max_batch=4, kv_blocks=129, kv_block_size=8)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")


def add_cell(root: Path, name: str, limit: float, experts: bool = False,
             backlog: bool = False) -> str:
    """A tiny configuration and traffic file (after ``mistral-7b`` and
    ``chat``; ``experts``: 4 experts, top-2, dropless; ``backlog``: the
    queue kept full instead of the open loop), and a cell over them,
    added to the copy at ``root``; returns the cell's name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/mistral-7b.json").read_text())
    cfg.update(TINY)
    if experts:
        cfg.update(num_local_experts=4, num_experts_per_tok=2,
                   expert_capacity_factor=2.0)
    cfg["engine"].update(TINY_ENGINE)
    cfg["limits"] = {"logit_gap": limit}
    (root / "portbench/configs" / f"{name}.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "portbench/traffic/chat.json").read_text())
    mix.update(lead_in_s=1, trace_seconds=0.5, rate_per_s=4.0)
    if backlog:
        mix.update(arrivals="backlog", requests=64, outstanding=6)
    mix["prompt"].update(median=16, min=4, max=64)
    mix["output"].update(median=8, min=2, max=24)
    (root / "portbench/traffic" / f"{name}.json").write_text(json.dumps(mix))
    cell = f"{name}.serve"
    bench["configs"].append({"name": name, "source": "tiny", "reduced": [],
                             "file": f"portbench/configs/{name}.json",
                             "why": "a CPU test's"})
    bench["workloads"].append({"name": cell, "config": name,
                               "traffic": name, "chips": 1,
                               "why": "a CPU test's"})
    if not backlog:
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "mistral-7b.chat" in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


@pytest.fixture
def tree(tmp_path):
    """A copy of BENCHMARK.json and portbench/ (the port imported from
    the repository)."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def run_cell(root: Path, cell: str, *extra, seed: int = 3000000019,
             trace: int = 0, entry=("-m", "portbench.run")) -> dict:
    """One CPU run of ``cell`` in the copy; its result line, parsed."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, *entry, "--workload", cell, "--seed", str(seed),
         "--seconds", "2", "--trace", str(trace), "--device", "cpu", *extra],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
