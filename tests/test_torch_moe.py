"""Port parity: the Mixture-of-Experts FFN (``nos_tpu_torch/ops/moe.py``)
and the MoE decoder's params and decode forwards against the JAX
reference on the CPU, f32, on the same inputs (numpy, seeded) and
bridged weights.

Tolerances: ``expert_capacity`` and ``top2_gating``'s combine and
dispatch exactly equal (the port's softmax takes XLA's f32 exp, and the
sums over E hold at most two nonzero terms); the aux loss within 1e-6
relative (its mean over B x S follows XLA:CPU's vectorized reduction
order, which the port does not reproduce; serving drops it);
``moe_ffn`` within 1e-6 absolute; the MoE decode forwards' logits
within 1e-5 absolute (f32 through two layers, where the frameworks
order the matmul sums differently), greedy tokens equal.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.models import generate as jg  # noqa: E402
from nos_tpu.models import quant as jq  # noqa: E402
from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu.ops import moe as jmoe  # noqa: E402
from nos_tpu_torch.models import generate as tg  # noqa: E402
from nos_tpu_torch.models import quant as tq  # noqa: E402
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402
from nos_tpu_torch.ops import moe as tmoe  # noqa: E402
from nos_tpu_torch.ops.quant import QuantLinear  # noqa: E402

FFN_TOL = 1e-6
LOGIT_TOL = 1e-5
AUX_RTOL = 1e-6
# the reference's tiny serving config, with experts
KW = dict(vocab=64, d_model=16, n_layers=2, n_heads=2, n_kv_heads=1,
          d_ff=32, max_seq=64)


def cfgs(n_experts=4, **extra):
    return (jtfm.TransformerConfig(dtype=jnp.float32, n_experts=n_experts,
                                   **KW, **extra),
            ttfm.TransformerConfig(dtype=torch.float32, n_experts=n_experts,
                                   **KW, **extra))


@pytest.fixture(scope="module")
def params():
    jcfg, _ = cfgs()
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, ttfm.params_from_jax(jp, "cpu")


@pytest.fixture
def pallas_compat(monkeypatch):
    """Alias the renamed ``pltpu.TPUCompilerParams`` so the reference
    kernel runs in interpret mode on the installed JAX."""
    from jax.experimental.pallas import tpu as pltpu

    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,e,cf", [
    (64, 8, 1.0), (2, 8, 1.0),         # the reference's own cases
    (1, 8, 1.25), (5, 8, 1.25), (5, 4, 1.25), (3, 4, 1.25),
    (1024, 8, 1.25), (16, 4, 0.5), (7, 2, 1.25),
])
def test_expert_capacity_matches_reference(seq, e, cf):
    assert tmoe.expert_capacity(seq, e, cf) == jmoe.expert_capacity(
        seq, e, cf)


def test_xla_exp_is_xlas_bit_for_bit():
    """The softmax's exp against XLA:CPU's over its whole f32 range,
    the flushed subnormal tail included."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        (rng.standard_normal(100_000) * 8).astype(np.float32),
        -np.linspace(0, 100, 50_001, dtype=np.float32),
        np.linspace(0, 88.3, 50_001, dtype=np.float32)])
    want = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x)))
    got = tmoe._xla_exp(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_one_hot_is_jaxs_out_of_range_too():
    idx = np.array([[0, 3, 4, -1, 7, 2]], np.int32)
    want = np.asarray(jax.nn.one_hot(jnp.asarray(idx), 4, dtype=jnp.float32))
    got = tmoe._one_hot(torch.from_numpy(idx), 4).numpy()
    np.testing.assert_array_equal(got, want)


def _logits(kind, b, s, e, rng):
    if kind == "random":
        return (rng.standard_normal((b, s, e)) * 2).astype(np.float32)
    if kind == "ties":
        # few distinct values: exact ties for the top-1 and the top-2
        return rng.integers(0, 2, size=(b, s, e)).astype(np.float32)
    # "overflow": every token prefers expert 0, then expert 1
    base = np.zeros((b, s, e), np.float32)
    base[..., 0], base[..., 1] = 5.0, 2.0
    return base + 0.01 * rng.standard_normal((b, s, e)).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties", "overflow"])
@pytest.mark.parametrize("e", [2, 4, 8])
@pytest.mark.parametrize("b,s,cap", [(2, 16, 8), (3, 64, 5), (8, 1, 1),
                                     (1, 5, 1)])
def test_top2_gating_equals_reference(kind, e, b, s, cap):
    rng = np.random.default_rng(
        [["random", "ties", "overflow"].index(kind), e, b, s])
    lg = _logits(kind, b, s, e, rng)
    jc, jd, ja = jmoe.top2_gating(jnp.asarray(lg), cap)
    tc, td, ta = tmoe.top2_gating(torch.from_numpy(lg), cap)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tc.dtype == torch.float32 and td.dtype == torch.bool
    np.testing.assert_allclose(float(ta), float(ja), rtol=AUX_RTOL, atol=0)
    if kind == "overflow" and s >= 5:
        # the capacity really dropped assignments
        assert int(td.sum()) < 2 * b * s


@pytest.mark.parametrize("e,cf", [(2, 4.0), (4, 1.25), (4, 0.5),
                                  (8, 1.25)])
@pytest.mark.parametrize("b,s", [(2, 8), (8, 1), (1, 33)])
def test_moe_ffn_matches_reference(e, cf, b, s):
    rng = np.random.default_rng(e * 100 + s)
    d, f = 16, 32
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    router = rng.standard_normal((d, e)).astype(np.float32)
    w_gate, w_up = (rng.standard_normal((e, d, f)).astype(np.float32) * 0.1
                    for _ in range(2))
    w_down = rng.standard_normal((e, f, d)).astype(np.float32) * 0.1
    args = (h, router, w_gate, w_up, w_down)
    jo, ja = jmoe.moe_ffn(*map(jnp.asarray, args), capacity_factor=cf)
    to, ta = tmoe.moe_ffn(*map(torch.from_numpy, args), capacity_factor=cf)
    assert to.shape == (b, s, d) and to.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                               atol=FFN_TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=AUX_RTOL)


def test_moe_ffn_dropped_tokens_give_zero_rows():
    """The reference's capacity test: identical tokens all preferring
    expert 0 of 2 at capacity 1; the dropped tokens' rows are zero."""
    h = torch.ones((1, 4, 8))
    router = torch.zeros((8, 2))
    router[0, 0] = 5.0
    w = torch.ones((2, 8, 8))
    out, _ = tmoe.moe_ffn(h, router, w, w, torch.ones((2, 8, 8)),
                          capacity_factor=0.25)
    want, _ = jmoe.moe_ffn(jnp.asarray(h.numpy()), jnp.asarray(
        router.numpy()), jnp.asarray(w.numpy()), jnp.asarray(w.numpy()),
        jnp.ones((2, 8, 8)), capacity_factor=0.25)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert (out.norm(dim=-1)[0] == 0).sum() >= 1


@pytest.mark.parametrize("rows", [1, 3])
def test_colliding_null_block_writes_land_as_the_references(rows):
    """A window padded three blocks past its row's table writes each
    null-block slot three times (once a block); under MoE later pads
    attend to what is left there and route on it. The slot keeps the
    last write, as the reference's in-order scatter leaves it, on every
    plane."""
    from nos_tpu.ops import attention as ja
    from nos_tpu_torch.ops import attention as ta

    rng = np.random.default_rng(7)
    bs, nb, h_kv, d, s = 4, 3, 2, 8, 16
    arena = rng.normal(size=(rows * nb + 1, h_kv, bs, d)).astype(np.float32)
    scales = rng.random(size=arena.shape[:3]).astype(np.float32)
    table = (1 + np.arange(rows * nb, dtype=np.int32)).reshape(rows, nb)
    table[:, 1:] = 0                    # one block each: 12 pads on null
    pos = np.zeros(rows, np.int32)
    vals = rng.normal(size=(rows, h_kv, s, d)).astype(np.float32)
    svals = rng.random(size=(rows, h_kv, s)).astype(np.float32)
    want = ja.paged_scatter_kv(*map(jnp.asarray, (arena, table, pos, vals)))
    got = ta.paged_scatter_kv(*map(torch.from_numpy, (arena, table, pos,
                                                      vals)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    swant = ja.paged_scatter_scale(*map(jnp.asarray, (scales, table, pos,
                                                      svals)))
    sgot = ta.paged_scatter_scale(*map(torch.from_numpy, (scales, table,
                                                          pos, svals)))
    np.testing.assert_array_equal(sgot.numpy(), np.asarray(swant))
    # the null block holds the last row's last block of pads
    np.testing.assert_array_equal(
        got[0].numpy(), vals[-1, :, s - bs:].astype(np.float32))
    route = ta.paged_write_route(torch.from_numpy(table),
                                 torch.from_numpy(pos), s, bs,
                                 arena.shape[0])
    last = route[2].reshape(rows, s)
    assert int(last[0, bs]) == rows * s - bs    # first pad -> last pad


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def test_moe_config_builds_and_training_forward_refuses():
    """The training forward refused an MoE config until MoE training was
    ported; now it trains it: logits of the vocabulary's width and the
    layers' mean aux loss, positive and finite
    (tests/test_torch_moe_train.py holds both to the reference)."""
    cfg = ttfm.TransformerConfig(vocab=64, d_model=32, n_layers=2,
                                 n_heads=4, d_ff=64, max_seq=16,
                                 n_experts=8, dtype=torch.float32)
    assert cfg.n_experts == 8
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    logits, aux = ttfm.forward(params, cfg,
                               torch.zeros((1, 2), dtype=torch.long),
                               return_aux=True)
    assert logits.shape == (1, 2, 64) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all() and float(aux) > 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_init_params_moe_shapes_dtypes_and_scales(dtype):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    e = 4
    jcfg = jtfm.TransformerConfig(dtype=jdt, n_experts=e, **KW)
    tcfg = ttfm.TransformerConfig(dtype=tdt, n_experts=e, **KW)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = ttfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert set(tp["layers"]) == set(jp["layers"])
    for k, v in jp["layers"].items():
        assert tuple(tp["layers"][k].shape) == v.shape, k
        assert str(tp["layers"][k].dtype).split(".")[-1] == str(v.dtype), k
    assert tp["layers"]["w_router"].dtype == torch.float32
    assert tuple(tp["layers"]["w_gate"].shape) == (2, e, 16, 32)
    assert tuple(tp["layers"]["w_down"].shape) == (2, e, 32, 16)
    # the reference's scales: normal * fan_in**-0.5
    for k, fan_in in (("w_router", 16), ("w_gate", 16), ("w_up", 16),
                      ("w_down", 32)):
        std = float(tp["layers"][k].float().std()) * fan_in ** 0.5
        assert abs(std - 1) < 0.15, (k, std)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_params_from_jax_carries_moe_leaves_bit_equal(dtype):
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jcfg = jtfm.TransformerConfig(dtype=jdt, n_experts=4, **KW)
    jp = jtfm.init_params(jax.random.PRNGKey(2), jcfg)
    tp = ttfm.params_from_jax(jp, "cpu")
    for k in ("w_router", "w_gate", "w_up", "w_down"):
        want = np.asarray(jp["layers"][k])
        got = tp["layers"][k]
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_params_keeps_experts_unquantized(params):
    """The reference's rule (tests/test_quant.py:97): attention, embed
    and unembed quantize, the router and experts stay as they are;
    the port's tree equals the reference's bit for bit."""
    jp, tp = params
    jqp = jq.quantize_params(jp)
    tqp = tq.quantize_params(tp)
    assert isinstance(tqp["layers"]["wq"], QuantLinear)
    for k in ("w_router", "w_gate", "w_up", "w_down"):
        assert not isinstance(tqp["layers"][k], QuantLinear), k
        assert tqp["layers"][k] is tp["layers"][k]
    for k in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(tqp["layers"][k].q.numpy(),
                                      np.asarray(jqp["layers"][k].q))
        np.testing.assert_array_equal(tqp["layers"][k].scale.numpy(),
                                      np.asarray(jqp["layers"][k].scale))
    np.testing.assert_array_equal(tqp["unembed"].q.numpy(),
                                  np.asarray(jqp["unembed"].q))
    # a dense model still quantizes its FFN
    dense = tq.quantize_params(ttfm.init_params(
        ttfm.TransformerConfig(dtype=torch.float32, **KW),
        torch.Generator().manual_seed(0), "cpu"))
    assert isinstance(dense["layers"]["w_gate"], QuantLinear)


# ---------------------------------------------------------------------------
# the decode forwards under the engines
# ---------------------------------------------------------------------------

def _close(a, b, tol=LOGIT_TOL):
    err = float(np.max(np.abs(np.asarray(a) - b.numpy())))
    assert err <= tol, err


@pytest.mark.parametrize("weights", ["f32", "int8"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_forward_paged_moe_matches_reference(params, kv_dtype, impl,
                                             weights, pallas_compat):
    """A ragged prefill through shuffled block tables, then a verify-
    width window and a decode step; each formulation against the
    reference's same one, on the model-dtype ("bf16") and int8 arenas,
    with f32 and int8 (experts f32) weights."""
    jp, tp = params
    if weights == "int8":
        jp, tp = jq.quantize_params(jp), tq.quantize_params(tp)
    jcfg, tcfg = cfgs()
    rng = np.random.default_rng(3)
    b, bs, nb = 3, 8, 8
    table = rng.permutation(np.arange(1, 1 + b * nb)).astype(
        np.int32).reshape(b, nb)
    table[2, 4:] = 0                    # a null tail on one row
    jc = jg.init_paged_cache(jcfg, 1 + b * nb, bs, b, kv_dtype=kv_dtype)
    tc = tg.init_paged_cache(tcfg, 1 + b * nb, bs, b, kv_dtype=kv_dtype,
                             device="cpu")
    pos = np.array([0, 5, 11], np.int32)
    jc["pos"] = jnp.asarray(pos)
    tc["pos"] = torch.from_numpy(pos.copy())
    for s in (8, 4, 1):
        toks = rng.integers(0, KW["vocab"], size=(b, s))
        jl, jc = jg.forward_paged(jp, jcfg, jnp.asarray(toks), jc,
                                  jnp.asarray(table), paged_impl=impl)
        tl, tc = tg.forward_paged(tp, tcfg, torch.from_numpy(toks), tc,
                                  torch.from_numpy(table), paged_impl=impl)
        _close(jl, tl)
        np.testing.assert_array_equal(np.asarray(jc["pos"]),
                                      tc["pos"].numpy())


@pytest.mark.parametrize("vector", [False, True])
def test_forward_with_cache_moe_matches_reference(params, vector):
    """The slot-static forward: a bucket-padded prefill, then two decode
    steps, with a scalar pos (lockstep rows) or a per-row one."""
    jp, tp = params
    jcfg, tcfg = cfgs()
    rng = np.random.default_rng(5)
    b = 2
    jc = jg.init_cache(jcfg, b, per_row_pos=vector)
    tc = tg.init_cache(tcfg, b, per_row_pos=vector, device="cpu")
    if vector:
        pos = np.array([0, 9], np.int32)
        jc["pos"] = jnp.asarray(pos)
        tc["pos"] = torch.from_numpy(pos.copy())
    for s in (16, 1, 1):
        toks = rng.integers(0, KW["vocab"], size=(b, s))
        jl, jc = jg.forward_with_cache(jp, jcfg, jnp.asarray(toks), jc)
        tl, tc = tg.forward_with_cache(tp, tcfg, torch.from_numpy(toks), tc)
        _close(jl, tl)


@pytest.mark.parametrize("n_experts", [2, 4])
def test_generate_moe_tokens_equal_reference(n_experts):
    jcfg, tcfg = cfgs(n_experts)
    jp = jtfm.init_params(jax.random.PRNGKey(1), jcfg)
    tp = ttfm.params_from_jax(jp, "cpu")
    prompt = [[4, 5, 6, 7], [9, 8, 7, 6]]
    want = jg.generate(jp, jcfg, jnp.asarray(prompt, jnp.int32), 12)
    got = tg.generate(tp, tcfg, prompt, 12, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_paged_moe_tokens_equal_reference(params, monkeypatch):
    monkeypatch.setenv("NOS_TPU_PAGED_KERNEL", "0")
    jp, tp = params
    jcfg, tcfg = cfgs()
    prompt = [[4, 5, 6], [1, 2, 3]]
    want = jg.generate_paged(jp, jcfg, jnp.asarray(prompt, jnp.int32), 10,
                             block_size=8)
    got = tg.generate_paged(tp, tcfg, prompt, 10, block_size=8,
                            paged_impl="xla", device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
