"""Port parity: the paged attention ops against the JAX reference (CPU).

int8 quantization, paged scatters and gathers move or compute integers
and exact copies, so they are held BIT-equal. The attention itself is
held at 2e-5 absolute in f32 — the reference's own pin for its Pallas
kernel against its gather oracle (tests/test_paged_kernel.py) — against
both the reference kernel in Pallas interpret mode and the reference's
gather formulation. The CUDA kernel itself runs only on the card
(chip_smoke.py holds it against ``paged_decode_attention_reference``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.models.generate import _cached_attention as j_cached  # noqa: E402
from nos_tpu.ops import attention as ja  # noqa: E402
from nos_tpu_torch.ops import _kernels  # noqa: E402
from nos_tpu_torch.ops import attention as ta  # noqa: E402

ATTN_TOL = 2e-5


@pytest.fixture
def pallas_compat(monkeypatch):
    """The installed JAX renamed ``pltpu.TPUCompilerParams`` to
    ``CompilerParams``; alias it for the duration of a test so the
    reference kernel runs in interpret mode without editing the
    reference package."""
    from jax.experimental.pallas import tpu as pltpu

    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_quantize_kv_bit_equal_including_zero_rows():
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(3, 2, 5, 16)).astype(np.float32) * 3
    vals[1, 0, 2] = 0.0                 # all-zero token: scale 1
    vals[2, 1, 4] = -0.0
    jq, js = ja.quantize_kv(jnp.asarray(vals))
    tq, ts = ta.quantize_kv(_t(vals))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    assert ts[1, 0, 2] == 1.0
    np.testing.assert_array_equal(
        np.asarray(ja.dequantize_kv(jq, js, jnp.float32)),
        ta.dequantize_kv(tq, ts, torch.float32).numpy())


def _arena_case(seed, b=3, h_kv=2, bs=8, nb=4, d=16, s=3):
    rng = np.random.default_rng(seed)
    nb_phys = b * nb + 1
    arena = rng.normal(size=(nb_phys, h_kv, bs, d)).astype(np.float32)
    scales = rng.random(size=(nb_phys, h_kv, bs)).astype(np.float32)
    perm = rng.permutation(np.arange(1, nb_phys)).astype(np.int32)
    table = perm[:b * nb].reshape(b, nb)
    return rng, arena, scales, table


@pytest.mark.parametrize("overrun", [False, True])
def test_paged_scatter_bit_equal_with_null_routing(overrun):
    rng, arena, scales, table = _arena_case(1)
    b, nb = table.shape
    s, bs = 3, arena.shape[2]
    if overrun:
        # row 1's window runs past its table: those positions route to
        # the null block 0 (one row only, so no write collides there)
        pos = np.array([5, nb * bs - 1, 12], np.int32)
    else:
        pos = np.array([0, 9, 17], np.int32)
    vals = rng.normal(size=(b, arena.shape[1], s, arena.shape[3])
                      ).astype(np.float32)
    svals = rng.random(size=(b, arena.shape[1], s)).astype(np.float32)
    ref = ja.paged_scatter_kv(jnp.asarray(arena), jnp.asarray(table),
                              jnp.asarray(pos), jnp.asarray(vals))
    out = ta.paged_scatter_kv(_t(arena), _t(table), _t(pos), _t(vals))
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    sref = ja.paged_scatter_scale(jnp.asarray(scales), jnp.asarray(table),
                                  jnp.asarray(pos), jnp.asarray(svals))
    sout = ta.paged_scatter_scale(_t(scales), _t(table), _t(pos),
                                  _t(svals))
    np.testing.assert_array_equal(np.asarray(sref), sout.numpy())
    if overrun:
        # the overrun landed in the null block, not the row's last block
        assert not np.array_equal(out[0].numpy(), arena[0])


def test_paged_gather_bit_equal():
    _, arena, scales, table = _arena_case(2)
    np.testing.assert_array_equal(
        np.asarray(ja.paged_gather_kv(jnp.asarray(arena),
                                      jnp.asarray(table))),
        ta.paged_gather_kv(_t(arena), _t(table)).numpy())
    np.testing.assert_array_equal(
        np.asarray(ja.paged_gather_scale(jnp.asarray(scales),
                                         jnp.asarray(table))),
        ta.paged_gather_scale(_t(scales), _t(table)).numpy())


def _attn_case(seed, s, int8):
    """Ragged per-row depths, shuffled physical blocks, a null tail past
    each row's live range, and row 0 all-null (an inactive slot)."""
    rng = np.random.default_rng(seed)
    b, h_kv, g, d, bs, nb = 3, 2, 2, 16, 8, 6
    nb_phys = b * nb + 1
    q = rng.normal(size=(b, h_kv * g, s, d)).astype(np.float32)
    ka = rng.normal(size=(nb_phys, h_kv, bs, d)).astype(np.float32)
    va = rng.normal(size=(nb_phys, h_kv, bs, d)).astype(np.float32)
    pos = rng.integers(0, nb * bs - s, size=b).astype(np.int32)
    pos[0] = min(pos[0], bs - 1)
    table = np.zeros((b, nb), np.int32)
    perm = rng.permutation(np.arange(1, nb_phys))
    i = 0
    for row in range(1, b):
        for j in range((int(pos[row]) + s - 1) // bs + 1):
            table[row, j] = perm[i]
            i += 1
    ks = vs = None
    if int8:
        ka, ks = (np.asarray(x) for x in ja.quantize_kv(jnp.asarray(ka)))
        va, vs = (np.asarray(x) for x in ja.quantize_kv(jnp.asarray(va)))
    return q, ka, va, table, pos, ks, vs


@pytest.mark.parametrize("s", [1, 3])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_attention_reference_matches_reference(
        s, int8, pallas_compat):
    q, ka, va, table, pos, ks, vs = _attn_case(10 + s, s, int8)
    d = q.shape[-1]
    J = jnp.asarray
    jk = dict(k_scale=J(ks), v_scale=J(vs)) if int8 else {}
    kernel = ja.paged_decode_attention(J(q), J(ka), J(va), J(table),
                                       J(pos), interpret=True, **jk)
    # the reference's gather oracle, composed as forward_paged does
    gk, gv = ja.paged_gather_kv(J(ka), J(table)), \
        ja.paged_gather_kv(J(va), J(table))
    if int8:
        gk = ja.dequantize_kv(gk, ja.paged_gather_scale(J(ks), J(table)),
                              jnp.float32)
        gv = ja.dequantize_kv(gv, ja.paged_gather_scale(J(vs), J(table)),
                              jnp.float32)
    positions = J(pos)[:, None] + jnp.arange(s)[None, :]
    oracle = j_cached(J(q), gk, gv, positions, d ** -0.5)
    tk = dict(k_scale=_t(ks), v_scale=_t(vs)) if int8 else {}
    for fn in (ta.paged_decode_attention_reference,
               ta.paged_decode_attention):      # the wrapper, on CPU
        out = fn(_t(q), _t(ka), _t(va), _t(table), _t(pos), **tk).numpy()
        for ref in (kernel, oracle):
            assert np.max(np.abs(out - np.asarray(ref))) <= ATTN_TOL
        assert np.isfinite(out).all()


def test_xla_attention_matches_reference():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 4, 6, 8)).astype(np.float32)
    k = rng.normal(size=(2, 2, 6, 8)).astype(np.float32)
    v = rng.normal(size=(2, 2, 6, 8)).astype(np.float32)
    for causal in (False, True):
        ref = ja.xla_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal)
        out = ta.xla_attention(_t(q), _t(k), _t(v), causal=causal)
        assert np.max(np.abs(out.numpy() - np.asarray(ref))) <= ATTN_TOL


def test_wrapper_launches_only_on_cuda_and_never_falls_back():
    q, ka, va, table, pos, _, _ = _attn_case(20, 1, False)
    meta = [torch.empty(x.shape, dtype=torch.from_numpy(x).dtype,
                        device="meta") for x in (q, ka, va, table, pos)]
    before = _kernels.paged_decode.launches
    # a non-CPU tensor goes to the kernel path, which refuses anything
    # but CUDA tensors instead of running the plain version
    with pytest.raises(ValueError, match="CUDA device"):
        ta.paged_decode_attention(*meta)
    # a CPU tensor runs the plain version and launches nothing
    ta.paged_decode_attention(_t(q), _t(ka), _t(va), _t(table), _t(pos))
    assert _kernels.paged_decode.launches == before


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels._PagedDecode().fn()


def test_kernels_module_imports_without_nvcc_or_cuda():
    code = ("import nos_tpu_torch.ops._kernels as k, sys; "
            "assert k.paged_decode.launches == 0; "
            "assert k.paged_decode._fn is None; "
            "assert 'triton' not in sys.modules")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root,
                   env={"PATH": "/nonexistent", "PYTHONPATH": root},
                   timeout=120)


def test_effective_paged_impl_env_and_head_dim(monkeypatch):
    """The env switch alone picks the formulation; a head dim the CUDA
    kernel is not built for raises on the card instead of quietly
    serving the plain version, and is fine on CPU tensors or with the
    kernel off."""
    monkeypatch.delenv("NOS_TPU_TORCH_PAGED_KERNEL", raising=False)
    assert ta.effective_paged_impl() == "kernel"
    cuda = torch.device("cuda")
    for d in (64, 128):
        ta.check_paged_kernel_head_dim(d, cuda, "kernel")
    with pytest.raises(ValueError, match="head_dim 8"):
        ta.check_paged_kernel_head_dim(8, cuda, "kernel")
    ta.check_paged_kernel_head_dim(8, torch.device("cpu"), "kernel")
    ta.check_paged_kernel_head_dim(8, cuda, "xla")
    monkeypatch.setenv("NOS_TPU_TORCH_PAGED_KERNEL", "0")
    assert ta.effective_paged_impl() == "xla"
