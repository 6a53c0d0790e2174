"""The port stands alone: nothing under ``nos_tpu_torch/`` (nor
``chip_smoke.py``) imports JAX, the JAX package ``nos_tpu``, or the
reference's checkpoint stack (orbax, etils: the port keeps its own
format), and importing the serving entry point pulls neither in."""
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
    return module.split(".")[0] in ("jax", "nos_tpu", "orbax", "etils")


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
    assert _forbidden("orbax.checkpoint") and _forbidden("etils.epath")
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
            "nos_tpu_torch.train.checkpoint, "
            "nos_tpu_torch.models.transformer; "
            "from nos_tpu_torch.ops import _kernels; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'nos_tpu', 'orbax', 'etils')]; "
            "assert not bad, bad; "
            "assert all(k._fn is None for k in _kernels.KERNELS)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


def test_fabric_and_tenant_modules_load_no_jax_and_no_torch():
    """The KV fabric, the tenant quota module and the copied quota
    arithmetic are host bookkeeping: importing them loads neither JAX,
    nor the JAX package, nor torch."""
    code = ("import sys, nos_tpu_torch.kvfabric, "
            "nos_tpu_torch.kvfabric.codec, nos_tpu_torch.kvfabric.hosttier, "
            "nos_tpu_torch.models.tenantquota, nos_tpu_torch.quota.info; "
            "bad = [m for m in sys.modules if m in ('jax', 'nos_tpu', "
            "'torch') or m.startswith(('jax.', 'nos_tpu.', 'torch.'))]; "
            "assert not bad, bad")
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


def test_speculative_modules_load_no_jax_and_build_nothing():
    """The slot-static and speculative engines import as the paged one
    does: no JAX, no JAX package, no kernel built at import."""
    code = ("import sys, nos_tpu_torch.models.speculative, "
            "nos_tpu_torch.models.spec_serving, "
            "nos_tpu_torch.models.serving; "
            "from nos_tpu_torch.ops import _kernels; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'nos_tpu' or "
            "m.startswith('nos_tpu.')]; "
            "assert not bad, bad; "
            "assert all(k._fn is None for k in _kernels.KERNELS)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


def test_health_server_loads_no_jax_and_no_torch():
    """The trainer's metrics server (``cmd/serve.py``) is host plumbing:
    importing it loads neither JAX, nor the JAX package, nor torch; the
    ops that stand for the remat policies' names register on import of
    the model without building a kernel."""
    code = ("import sys, nos_tpu_torch.cmd.serve; "
            "bad = [m for m in sys.modules if m in ('jax', 'nos_tpu', "
            "'torch') or m.startswith(('jax.', 'nos_tpu.', 'torch.'))]; "
            "assert not bad, bad; "
            "import torch, nos_tpu_torch.models.transformer as tt; "
            "from nos_tpu_torch.ops import _kernels; "
            "assert torch.ops.nos_tpu_torch.qkv_proj.default in "
            "tt.remat_saved_ops('except_mlp'); "
            "assert all(k._fn is None for k in _kernels.KERNELS)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


def test_lifecycle_watcher_loads_no_jax_and_no_torch():
    """The notice watcher's copies of the control plane
    (``nos_tpu_torch/kube/``, ``lifecycle/``, ``constants.py``) are host
    plumbing: importing them loads neither JAX, nor the JAX package, nor
    torch."""
    code = ("import sys, nos_tpu_torch.constants, nos_tpu_torch.kube, "
            "nos_tpu_torch.kube.objects, nos_tpu_torch.kube.apiserver, "
            "nos_tpu_torch.kube.client, nos_tpu_torch.kube.serial, "
            "nos_tpu_torch.kube.controller, nos_tpu_torch.kube.predicates, "
            "nos_tpu_torch.kube.httpapi, nos_tpu_torch.lifecycle, "
            "nos_tpu_torch.lifecycle.events; "
            "bad = [m for m in sys.modules if m in ('jax', 'nos_tpu', "
            "'torch') or m.startswith(('jax.', 'nos_tpu.', 'torch.'))]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)


def test_tensor_parallel_modules_load_no_jax_and_build_nothing():
    """The serving mesh (``parallel/mesh.py``) and the sharded forward
    import as the engine does: no JAX, no JAX package, no kernel built
    at import."""
    code = ("import sys, nos_tpu_torch.parallel, "
            "nos_tpu_torch.parallel.mesh, nos_tpu_torch.models.generate, "
            "nos_tpu_torch.models.serving; "
            "from nos_tpu_torch.ops import _kernels; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'nos_tpu' or "
            "m.startswith('nos_tpu.')]; "
            "assert not bad, bad; "
            "assert all(k._fn is None for k in _kernels.KERNELS)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT), timeout=120)
