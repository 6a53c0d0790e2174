"""No module of the benchmark imports JAX or the JAX package, and the
yardstick (the reference, the comparison, the formulas, the generator)
imports nothing of the port either. Top-level names are compared
whole: ``nos_tpu_torch`` begins with ``nos_tpu``."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
BARRED = {"jax", "jaxlib", "flax", "nos_tpu"}
YARDSTICK = {"reference.py", "model.py", "check.py", "roofline.py",
             "traffic.py", "stats.py"}
MODULES = sorted(p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts)


def top_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            yield node.args[0].value.split(".")[0]


def test_the_scan_sees_every_module():
    assert len(MODULES) > 20
    assert PKG / "reference.py" in MODULES


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_anywhere(path):
    assert not set(top_names(path)) & BARRED


@pytest.mark.parametrize("name", sorted(YARDSTICK))
def test_yardstick_imports_nothing_of_the_port(name):
    names = set(top_names(PKG / name))
    assert "nos_tpu_torch" not in names
    assert names <= {"__future__", "math", "random", "statistics",
                     "dataclasses", "typing", "contextlib", "torch",
                     "portbench"}, names
    for mod in [n for n in ast.walk(ast.parse((PKG / name).read_text()))
                if isinstance(n, ast.ImportFrom) and n.module
                and n.module.startswith("portbench")]:
        for a in mod.names:
            target = (mod.module.split(".")[1:] or [a.name])[0]
            assert f"{target}.py" in YARDSTICK, (name, target)


def test_top_names_are_whole(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import nos_tpu_torch.models\nfrom nos_tpu import x\n"
                     "import jaxtyping\n")
    assert list(top_names(probe)) == ["nos_tpu_torch", "nos_tpu",
                                      "jaxtyping"]
    assert set(top_names(probe)) & BARRED == {"nos_tpu"}
