"""Port parity: ``forward_paged``, ``forward_with_cache`` and greedy
generation against the JAX reference, on the same bridged weights (CPU,
f32, the tiny serving config of tests/test_serving_pipeline.py).

Logits are held at 1e-4 absolute: f32 through two layers, where the
frameworks order the matmul and softmax sums differently (~1e-6 per op)
and the int8 arena can amplify that by one quantization step on a rare
rounding tie. Greedy tokens are held equal.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.models import generate as jg  # noqa: E402
from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu_torch.models import generate as tg  # noqa: E402
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402

LOGIT_TOL = 1e-4
KW = dict(vocab=64, d_model=16, n_layers=2, n_heads=2, n_kv_heads=1,
          d_ff=32, max_seq=64)
JCFG = jtfm.TransformerConfig(dtype=jnp.float32, **KW)
TCFG = ttfm.TransformerConfig(dtype=torch.float32, **KW)


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, ttfm.params_from_jax(jp, "cpu")


@pytest.fixture
def pallas_compat(monkeypatch):
    """Alias the renamed ``pltpu.TPUCompilerParams`` so the reference
    kernel runs in interpret mode on the installed JAX."""
    from jax.experimental.pallas import tpu as pltpu

    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


def _close(a, b, tol=LOGIT_TOL):
    err = np.max(np.abs(np.asarray(a) - b.numpy()))
    assert err <= tol, err


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("j_impl,t_impl", [("xla", "xla"),
                                           ("kernel", "kernel")])
def test_forward_paged_matches_reference(params, kv_dtype, j_impl, t_impl,
                                         pallas_compat):
    """Prefill a ragged batch through shuffled block tables, then two
    decode steps; each formulation against the reference's same one."""
    jp, tp = params
    rng = np.random.default_rng(3)
    b, bs, nb = 3, 8, 8
    perm = rng.permutation(np.arange(1, 1 + b * nb)).astype(np.int32)
    table = perm.reshape(b, nb)
    table[2, 4:] = 0                    # a null tail on one row
    jc = jg.init_paged_cache(JCFG, 1 + b * nb, bs, b, kv_dtype=kv_dtype)
    tc = tg.init_paged_cache(TCFG, 1 + b * nb, bs, b, kv_dtype=kv_dtype,
                             device="cpu")
    pos = np.array([0, 5, 11], np.int32)
    jc["pos"] = jnp.asarray(pos)
    tc["pos"] = torch.from_numpy(pos.copy())
    for s in (4, 1, 1):
        toks = rng.integers(0, KW["vocab"], size=(b, s))
        jl, jc = jg.forward_paged(jp, JCFG, jnp.asarray(toks), jc,
                                  jnp.asarray(table), paged_impl=j_impl)
        tl, tc = tg.forward_paged(tp, TCFG, torch.from_numpy(toks), tc,
                                  torch.from_numpy(table),
                                  paged_impl=t_impl)
        _close(jl, tl)
        np.testing.assert_array_equal(np.asarray(jc["pos"]),
                                      tc["pos"].numpy())
    if kv_dtype == "int8":
        # the quantized arena bytes agree except at rare rounding ties
        diff = np.abs(np.asarray(jc["k"]).astype(int)
                      - tc["k"].numpy().astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-2


def test_forward_with_cache_matches_reference(params):
    jp, tp = params
    rng = np.random.default_rng(4)
    for per_row in (False, True):
        jc = jg.init_cache(JCFG, 2, 32, per_row_pos=per_row)
        tc = tg.init_cache(TCFG, 2, 32, per_row_pos=per_row, device="cpu")
        if per_row:
            jc["pos"] = jnp.asarray([0, 3], jnp.int32)
            tc["pos"] = torch.tensor([0, 3], dtype=torch.int32)
        for s in (5, 1):
            toks = rng.integers(0, KW["vocab"], size=(2, s))
            jl, jc = jg.forward_with_cache(jp, JCFG, jnp.asarray(toks), jc)
            tl, tc = tg.forward_with_cache(tp, TCFG, torch.from_numpy(toks),
                                           tc)
            _close(jl, tl)
        _close(jc["k"], tc["k"])


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_generate_paged_tokens_equal_reference(params, kv_dtype,
                                               monkeypatch):
    jp, tp = params
    # the reference's gather oracle, whatever switch an earlier test in
    # this process left in os.environ (its build_engine writes one)
    monkeypatch.setenv("NOS_TPU_PAGED_KERNEL", "0")
    prompt = [[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]]
    ref = jg.generate_paged(jp, JCFG, jnp.asarray(prompt, jnp.int32), 12,
                            block_size=8, kv_dtype=kv_dtype)
    out = tg.generate_paged(tp, TCFG, prompt, 12, block_size=8,
                            kv_dtype=kv_dtype, device="cpu")
    assert out.tolist() == np.asarray(ref).tolist()


def test_generate_greedy_equals_reference_and_generate_paged(params):
    jp, tp = params
    prompt = [[3, 1, 4, 1, 5, 9]]
    ref = jg.generate(jp, JCFG, jnp.asarray(prompt, jnp.int32), 10)
    out = tg.generate(tp, TCFG, prompt, 10, device="cpu")
    assert out.tolist() == np.asarray(ref).tolist()
    paged = tg.generate_paged(tp, TCFG, prompt, 10, block_size=8,
                              device="cpu")
    assert paged.tolist() == out.tolist()
    with pytest.raises(ValueError, match="temperature"):
        tg.generate(tp, TCFG, prompt, 4, temperature=0.7, device="cpu")
