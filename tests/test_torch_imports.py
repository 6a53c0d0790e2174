"""The port stands alone: nothing under ``nos_tpu_torch/`` (nor
``chip_smoke.py``) imports JAX or the JAX package ``nos_tpu``, and
importing the serving entry point pulls neither in."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "nos_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return (module == "jax" or module.startswith("jax.")
            or module == "nos_tpu" or module.startswith("nos_tpu."))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_matches_reference_not_port():
    assert _forbidden("nos_tpu.models") and _forbidden("jax.numpy")
    assert not _forbidden("nos_tpu_torch.models")


def test_importing_the_server_loads_no_jax():
    code = ("import sys, nos_tpu_torch.cmd.server, "
            "nos_tpu_torch.models.serving; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'nos_tpu' or "
            "m.startswith('nos_tpu.')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


def test_importing_the_trainer_loads_no_jax_and_builds_nothing():
    code = ("import sys, nos_tpu_torch.cmd.trainer, "
            "nos_tpu_torch.train.optim, nos_tpu_torch.train.data, "
            "nos_tpu_torch.models.transformer; "
            "from nos_tpu_torch.ops import _kernels; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'nos_tpu' or "
            "m.startswith('nos_tpu.')]; "
            "assert not bad, bad; "
            "assert all(k._fn is None for k in _kernels.KERNELS)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """With no CUDA device visible the smoke exits non-zero and prints
    no result line; so does a copy standing alone, without the port."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (alone, tmp_path)):
        run = subprocess.run([sys.executable, str(script)], env=env,
                             cwd=str(cwd), capture_output=True, text=True,
                             timeout=120)
        assert run.returncode != 0
        assert '"ok"' not in run.stdout
