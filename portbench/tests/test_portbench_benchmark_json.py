"""BENCHMARK.json keeps to the benchmark's contract: its keys, the
characters of its names and units, the files it names, and which cell
reports which metric."""
from __future__ import annotations

import json
import re

import pytest

from portbench.spec import PKG, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CELLS = {c["name"]: c for c in BENCH["workloads"]}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(BENCH) == KEYS
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32 and all(map(text_ok, BENCH["command"]))
    # a full check of 24 cells fits its 43,200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and text_ok(c["source"])
        assert text_ok(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["source"] == c["source"]
        assert sorted(body["reduced"]) == sorted(c["reduced"])
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in body["published"]
            assert not k.endswith(("_dim", "_rank", "_size")), k
            assert k not in ("num_experts_per_tok", "num_attention_heads",
                             "num_key_value_heads", "vocab_size")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_cells():
    assert 1 <= len(CELLS) <= 24 and len(CELLS) == len(BENCH["workloads"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and text_ok(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (PKG / "traffic" / f"{w['traffic']}.json").exists()
        assert (PKG / "kinds" / (json.loads(
            (PKG / "traffic" / f"{w['traffic']}.json").read_text())
            ["kind"] + ".py")).exists()


def reports(cell, group):
    return [m["name"] for m in group
            if "workloads" not in m or cell in m["workloads"]]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_enough(cell):
    e2e = reports(cell, BENCH["end_to_end"])
    assert "setup_s" in e2e and len(e2e) >= 2
    assert reports(cell, BENCH["per_layer"])


def test_metrics():
    names = set()
    layers = {}
    for group, e2e in ((BENCH["end_to_end"], True),
                       (BENCH["per_layer"], False)):
        for m in group:
            keys = {"name", "unit", "better", "source"} | (
                {"bound"} if e2e else {"layer", "moves"})
            assert set(m) - {"workloads"} == keys, m["name"]
            assert NAME.match(m["name"]) and m["name"] not in names
            names.add(m["name"])
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
            assert (PKG / "metrics" / f"{m['name']}.py").exists()
            for c in m.get("workloads", []):
                assert c in CELLS
            if e2e:
                assert m["source"] in ("host_clock", "device_trace")
                assert 0.01 <= m["bound"] <= 0.25
            else:
                assert m["source"] in ("device_trace", "program_span",
                                       "program_counter", "host_clock")
                assert text_ok(m["layer"]) and m["moves"] in E2E
                assert "workloads" in m
                for c in m["workloads"]:
                    assert m["moves"] in reports(c, BENCH["end_to_end"])
                layers.setdefault(m["layer"], m["layer"])
    assert "setup_s" in E2E
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_metric_file_has_a_reader():
    from portbench.spec import metric_reader

    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(metric_reader(m["name"]))
