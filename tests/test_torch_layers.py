"""Port parity: the torch layer ops, int8 weight primitives and the
params bridge against the JAX reference (CPU, f32 unless stated).

Inputs come from numpy seeds and go through both implementations.
Tolerance: 1e-6 absolute for the float ops (f32 at unit scale; the two
frameworks may fuse or order a few multiplies differently); integer
outputs and the bridge are bit-equal.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu.models import quant as jmq  # noqa: E402
from nos_tpu.ops import layers as jl  # noqa: E402
from nos_tpu.ops import quant as jq  # noqa: E402
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402
from nos_tpu_torch.models import quant as tmq  # noqa: E402
from nos_tpu_torch.ops import layers as tl  # noqa: E402
from nos_tpu_torch.ops import quant as tq  # noqa: E402

TOL = 1e-6


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _close(a, b, tol=TOL):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.max(np.abs(a - b)) <= tol, np.max(np.abs(a - b))


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    ref = jl.rms_norm(jnp.asarray(x), jnp.asarray(w))
    out = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    _close(ref, _np(out))


@pytest.mark.parametrize("positions", ["none", "shared", "per_row"])
def test_apply_rope_matches_reference(positions):
    rng = np.random.default_rng(1)
    b, s, h, d, max_len = 2, 5, 3, 8, 32
    x = rng.normal(size=(b, s, h, d)).astype(np.float32)
    pos = {"none": None,
           "shared": rng.integers(0, max_len, size=(s,)),
           "per_row": rng.integers(0, max_len, size=(b, s))}[positions]
    jf = jl.rope_frequencies(d, max_len)
    tf = tl.rope_frequencies(d, max_len, 10000.0, torch.device("cpu"))
    ref = jl.apply_rope(jnp.asarray(x), jf,
                        None if pos is None else jnp.asarray(pos))
    out = tl.apply_rope(torch.from_numpy(x), tf,
                        None if pos is None else torch.from_numpy(pos))
    _close(ref, _np(out))


def test_quantize_array_bit_equal_including_zero_channels():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(2, 16, 12)).astype(np.float32)
    w[:, :, 3] = 0.0                    # an all-zero channel: scale 1
    for axis in (-2, -1):
        jr = jq.quantize_array(jnp.asarray(w), axis=axis)
        tr = tq.quantize_array(torch.from_numpy(w), axis=axis)
        np.testing.assert_array_equal(np.asarray(jr.q), tr.q.numpy())
        np.testing.assert_array_equal(np.asarray(jr.scale), tr.scale.numpy())


@pytest.mark.parametrize("int8", [False, True])
def test_qdot_embed_lookup_swiglu_match_reference(int8):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    ws = [rng.normal(size=shp).astype(np.float32) * 0.25
          for shp in ((16, 24), (16, 24), (24, 16))]
    table = rng.normal(size=(32, 16)).astype(np.float32)
    toks = rng.integers(0, 32, size=(2, 3))
    jw = [jnp.asarray(w) for w in ws]
    tw = [torch.from_numpy(w) for w in ws]
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    if int8:
        jw = [jq.quantize_array(w) for w in jw]
        tw = [tq.quantize_array(w) for w in tw]
        jt = jq.quantize_array(jt, axis=-1)
        tt = tq.quantize_array(tt, axis=-1)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    _close(jq.qdot(xj, jw[0]), _np(tq.qdot(xt, tw[0])))
    _close(jl.swiglu(xj, *jw), _np(tl.swiglu(xt, *tw)))
    _close(jq.embed_lookup(jt, jnp.asarray(toks), jnp.float32),
           _np(tq.embed_lookup(tt, torch.from_numpy(toks), torch.float32)))


def _bits(x) -> np.ndarray:
    """Raw bits of a reference (numpy/JAX) or port (torch) leaf."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_tree_bit_equal(jtree, ttree):
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree)
        for k in jtree:
            _assert_tree_bit_equal(jtree[k], ttree[k])
    elif isinstance(jtree, jq.QuantLinear):
        assert isinstance(ttree, tq.QuantLinear)
        _assert_tree_bit_equal(jtree.q, ttree.q)
        _assert_tree_bit_equal(jtree.scale, ttree.scale)
    else:
        a, b = _bits(jtree), _bits(ttree)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_params_bridge_round_trips_bit_equal(dtype):
    cfg = jtfm.TransformerConfig(vocab=64, d_model=16, n_layers=2,
                                 n_heads=2, n_kv_heads=1, d_ff=32,
                                 max_seq=64, dtype=dtype)
    jp = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    for tree in (jp, jmq.quantize_params(jp)):
        _assert_tree_bit_equal(tree, ttfm.params_from_jax(tree, "cpu"))


def test_quantize_params_matches_reference():
    cfg = jtfm.TransformerConfig(vocab=64, d_model=16, n_layers=2,
                                 n_heads=2, n_kv_heads=1, d_ff=32,
                                 max_seq=64, dtype=jnp.float32)
    jp = jtfm.init_params(jax.random.PRNGKey(1), cfg)
    ported = tmq.quantize_params(ttfm.params_from_jax(jp, "cpu"))
    _assert_tree_bit_equal(jmq.quantize_params(jp), ported)


def test_init_params_shapes_and_scales_match_reference():
    jcfg = jtfm.TransformerConfig(vocab=64, d_model=16, n_layers=2,
                                  n_heads=2, n_kv_heads=1, d_ff=32,
                                  max_seq=64, dtype=jnp.float32)
    tcfg = ttfm.TransformerConfig(vocab=64, d_model=16, n_layers=2,
                                  n_heads=2, n_kv_heads=1, d_ff=32,
                                  max_seq=64, dtype=torch.float32)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = ttfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert set(tp) == set(jp) and set(tp["layers"]) == set(jp["layers"])
    for k in jp["layers"]:
        assert tuple(tp["layers"][k].shape) == jp["layers"][k].shape
    assert tuple(tp["embed"].shape) == jp["embed"].shape
    # same init scale: normal * fan_in**-0.5 (std within sampling noise)
    assert abs(float(tp["layers"]["w_down"].std()) * 32 ** 0.5 - 1) < 0.1
    # the shape-only template a checkpoint restore fills (the port's
    # jax.eval_shape of the init): the same tree, shapes and dtypes, no
    # storage, dense and MoE
    moe_cfg = ttfm.TransformerConfig(vocab=64, d_model=16, n_layers=2,
                                     n_heads=2, d_ff=32, max_seq=64,
                                     n_experts=4)
    for cfg in (tcfg, moe_cfg):
        real = ttfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        meta = ttfm.abstract_params(cfg)
        assert set(meta["layers"]) == set(real["layers"])
        for a, b in zip(ttfm.param_leaves(meta), ttfm.param_leaves(real)):
            assert a.device.type == "meta"
            assert (a.shape, a.dtype) == (b.shape, b.dtype)
