"""Port parity: ``speculative_generate`` against the reference's, in the
cases of tests/test_speculative.py (CPU, f32, the tiny target and draft
configs there, bridged weights): a draft that mostly disagrees at
several ``n_draft``, draft = target, rows that accept unevenly, the
headroom check and zero tokens. Greedy output equals plain greedy
decoding of the target and the reference's tokens; sampled output
equals the reference's tokens at the same key.
"""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu.models.generate import generate as jgenerate  # noqa: E402
from nos_tpu.models.speculative import (  # noqa: E402
    speculative_generate as jspeculative_generate,
)
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402
from nos_tpu_torch.models.generate import generate  # noqa: E402
from nos_tpu_torch.models.speculative import speculative_generate  # noqa: E402
from nos_tpu_torch.utils import prng  # noqa: E402


def cfgs(**kw):
    base = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                max_seq=64)
    base.update(kw)
    return (jtfm.TransformerConfig(dtype=jnp.float32, **base),
            ttfm.TransformerConfig(dtype=torch.float32, **base))


JTARGET, TTARGET = cfgs(n_kv_heads=2)
JDRAFT, TDRAFT = cfgs(d_model=16, n_layers=1, n_heads=2, d_ff=32)


@pytest.fixture(autouse=True, scope="module")
def _no_leaked_paged_switch():
    """Leave no ``NOS_TPU_PAGED_KERNEL`` behind for the worker's next
    module: the reference's ``build_engine`` writes it into os.environ
    (ROADMAP C.5), and a reference engine built under it later takes the
    Pallas kernel path, which fails on this JAX (the renamed
    ``TPUCompilerParams``). This module's own engines set it per test."""
    yield
    os.environ.pop("NOS_TPU_PAGED_KERNEL", None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs torch on one thread in this module: its
    tiny models' ops are dominated by thread hand-off, which made the
    module several times slower beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models(target_key, draft_key=None):
    """(jax target, jax draft, torch target, torch draft); draft = target
    when ``draft_key`` is None."""
    jp = jtfm.init_params(jax.random.PRNGKey(target_key), JTARGET)
    tp = ttfm.params_from_jax(jp, "cpu")
    if draft_key is None:
        return jp, jp, tp, tp, (JTARGET, TTARGET)
    jd = jtfm.init_params(jax.random.PRNGKey(draft_key), JDRAFT)
    return jp, jd, tp, ttfm.params_from_jax(jd, "cpu"), (JDRAFT, TDRAFT)


def run_both(keys, prompt, n, **kw):
    """(port tokens, reference tokens, plain greedy tokens of the
    target) for one call; ``rng`` seeds both frameworks' keys."""
    jp, jd, tp, td, (jdc, tdc) = models(*keys)
    seed = kw.pop("seed", None)
    jkw, tkw = dict(kw), dict(kw)
    if seed is not None:
        jkw["rng"] = jax.random.PRNGKey(seed)
        tkw["rng"] = prng.PRNGKey(seed)
    want = np.asarray(jspeculative_generate(
        jp, JTARGET, jd, jdc, jnp.asarray(prompt, jnp.int32), n, **jkw))
    got = speculative_generate(tp, TTARGET, td, tdc,
                               np.asarray(prompt).tolist(), n,
                               device="cpu", **tkw).numpy()
    plain = np.asarray(jgenerate(jp, JTARGET,
                                 jnp.asarray(prompt, jnp.int32), n))
    return got, want, plain


@pytest.mark.parametrize("n_draft", [1, 3, 4])
def test_bad_draft_equals_plain_greedy(n_draft):
    """A draft that mostly disagrees changes nothing but the speed."""
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 5),
                                           0, 64))
    got, want, plain = run_both((0, 9), prompt, 12, n_draft=n_draft)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain)


def test_draft_equal_to_target_equals_plain_greedy():
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (3, 4),
                                           0, 64))
    got, want, plain = run_both((0, None), prompt, 10, n_draft=4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain)


def test_rows_with_uneven_acceptance_stay_exact():
    prompt = np.asarray([[1, 2, 3], [60, 61, 62], [7, 7, 7], [0, 1, 0]],
                        np.int32)
    got, want, plain = run_both((0, 3), prompt, 9, n_draft=3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain)


def test_port_greedy_equals_port_generate():
    """The port's speculative tokens equal the port's own ``generate``."""
    _, _, tp, td, (_, tdc) = models(0, 9)
    prompt = [[5, 6, 7, 8], [9, 10, 11, 12]]
    got = speculative_generate(tp, TTARGET, td, tdc, prompt, 11,
                               n_draft=3, device="cpu")
    want = generate(tp, TTARGET, prompt, 11, device="cpu")
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("trunc", [dict(top_k=8), dict(top_p=0.9),
                                   dict()], ids=["top_k", "top_p", "full"])
def test_sampled_tokens_equal_reference(seed, trunc):
    """Accept-reject sampling: the same key gives the reference's
    tokens (draft draws, accept uniforms and residual draws in the
    reference's order)."""
    prompt = np.asarray([[4, 5, 6], [9, 8, 7]], np.int32)
    got, want, _ = run_both((0, 9), prompt, 10, n_draft=3,
                            temperature=0.9, seed=seed, **trunc)
    np.testing.assert_array_equal(got, want)


def test_cache_headroom_validated():
    jp, _, tp, _, _ = models(0, None)
    with pytest.raises(ValueError, match="draft window") as want:
        jspeculative_generate(jp, JTARGET, jp, JTARGET,
                              jnp.zeros((1, 50), jnp.int32), 12, n_draft=4)
    with pytest.raises(ValueError, match="draft window") as got:
        speculative_generate(tp, TTARGET, tp, TTARGET, [[0] * 50], 12,
                             n_draft=4, device="cpu")
    assert str(got.value) == str(want.value)


def test_zero_tokens_returns_prompt():
    _, _, tp, _, _ = models(0, None)
    out = speculative_generate(tp, TTARGET, tp, TTARGET, [[0, 0, 0]], 0,
                               device="cpu")
    assert out.tolist() == [[0, 0, 0]]


@pytest.mark.parametrize("kw,match", [
    (dict(temperature=0.5), "rng"),
    (dict(top_k=3), "top_k/top_p only apply"),
    (dict(temperature=0.5, top_p=2.0, seed=0), "top_p in"),
])
def test_argument_refusals_match_reference(kw, match):
    jp, _, tp, _, _ = models(0, None)
    seed = kw.pop("seed", None)
    jkw, tkw = dict(kw), dict(kw)
    if seed is not None:
        jkw["rng"], tkw["rng"] = jax.random.PRNGKey(0), prng.PRNGKey(0)
    with pytest.raises(ValueError, match=match) as want:
        jspeculative_generate(jp, JTARGET, jp, JTARGET,
                              jnp.zeros((1, 3), jnp.int32), 4, **jkw)
    with pytest.raises(ValueError, match=match) as got:
        speculative_generate(tp, TTARGET, tp, TTARGET, [[0, 0, 0]], 4,
                             device="cpu", **tkw)
    assert str(got.value) == str(want.value)
