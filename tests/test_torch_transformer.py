"""Port parity: the training forward, loss and gradients of
``nos_tpu_torch.models.transformer`` against ``nos_tpu.models.transformer``
on the same f32 params (``params_from_jax``), on the CPU.

The reference's attention runs ``xla_attention`` here; the port's runs
the flash kernels' plain versions behind their autograd Function.
Tolerances (f32, a few layers): logits 2e-5 and loss 1e-6 relative, the
gap left by summation order between XLA's and PyTorch's CPU matmuls;
every gradient within 1e-5 of its tensor's largest element.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.models import transformer as jt  # noqa: E402
from nos_tpu_torch.models import transformer as tt  # noqa: E402

KW = dict(vocab=64, d_model=32, n_layers=3, n_heads=4, n_kv_heads=2,
          d_ff=64, max_seq=32)
LOGIT_TOL, LOSS_RTOL, GRAD_TOL = 2e-5, 1e-6, 1e-5


def _batch(seed=0, b=2, s=16):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, KW["vocab"], size=(b, s)).astype(np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}


def _models(**extra):
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **KW, **extra)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **KW, **extra)
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tt.params_from_jax(jparams, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _port_loss_and_grads(tparams, tcfg, batch):
    leaves = tt.param_leaves(tparams)
    for p in leaves:
        p.requires_grad_()
    loss = tt.loss_fn(tparams, tcfg, _tbatch(batch))
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


def _jax_leaves(tree):
    """The reference's pytree leaves in ``param_leaves``' order."""
    out = []
    for key in sorted(tree):
        v = tree[key]
        out.extend(_jax_leaves(v) if isinstance(v, dict) else [v])
    return out


def test_forward_logits_match_reference():
    jcfg, jparams, tcfg, tparams = _models()
    batch = _batch()
    want = np.asarray(jt.forward(jparams, jcfg, jnp.asarray(batch["tokens"])))
    got = tt.forward(tparams, tcfg, torch.from_numpy(batch["tokens"]).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=LOGIT_TOL,
                               rtol=0)
    logits, aux = tt.forward(tparams, tcfg,
                             torch.from_numpy(batch["tokens"]).long(),
                             return_aux=True)
    assert float(aux) == 0.0 and torch.equal(logits, got)


@pytest.mark.parametrize("loss_chunk", [0, 8])
def test_loss_and_every_gradient_match_value_and_grad(loss_chunk):
    jcfg, jparams, tcfg, tparams = _models(loss_chunk=loss_chunk)
    batch = _batch(1)
    jloss, jgrads = jax.value_and_grad(jt.loss_fn)(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _port_loss_and_grads(tparams, tcfg, batch)
    assert abs(loss - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    want = [np.asarray(g) for g in _jax_leaves(jgrads)]
    assert len(grads) == len(want) == 12
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=GRAD_TOL * np.abs(w).max(),
                                   rtol=0)


def test_remat_on_equals_remat_off():
    _, _, tcfg, tparams = _models()
    off = tt.TransformerConfig(dtype=torch.float32, remat=False, **KW)
    batch = _batch(2)
    loss_on, grads_on = _port_loss_and_grads(tparams, tcfg, batch)
    loss_off, grads_off = _port_loss_and_grads(tparams, off, batch)
    assert loss_on == loss_off
    for a, b in zip(grads_on, grads_off):
        np.testing.assert_allclose(a, b, atol=1e-7, rtol=0)


def test_chunked_loss_equals_unchunked():
    _, _, tcfg, tparams = _models()
    chunked = tt.TransformerConfig(dtype=torch.float32, loss_chunk=4, **KW)
    batch = _batch(3)
    loss, grads = _port_loss_and_grads(tparams, tcfg, batch)
    loss_c, grads_c = _port_loss_and_grads(tparams, chunked, batch)
    assert abs(loss - loss_c) <= LOSS_RTOL * abs(loss)
    for a, b in zip(grads, grads_c):
        np.testing.assert_allclose(a, b, atol=GRAD_TOL * np.abs(b).max(),
                                   rtol=0)


def test_return_hidden_feeds_lm_head_loss():
    _, _, tcfg, tparams = _models()
    batch = _tbatch(_batch(4))
    hidden, aux = tt.forward(tparams, tcfg, batch["tokens"],
                             return_hidden=True)
    assert hidden.shape == (2, 16, KW["d_model"])
    loss = tt.lm_head_loss(tparams["final_norm"], tparams["unembed"],
                           hidden, batch["targets"])
    logits = tt.forward(tparams, tcfg, batch["tokens"])
    assert torch.allclose(loss, tt.cross_entropy(logits, batch["targets"]))


def test_loss_chunk_must_divide_the_sequence():
    _, _, _, tparams = _models()
    hidden = torch.zeros(1, 12, KW["d_model"])
    with pytest.raises(ValueError, match="loss_chunk=5 does not divide"):
        tt.lm_head_loss(tparams["final_norm"], tparams["unembed"], hidden,
                        torch.zeros(1, 12, dtype=torch.long), loss_chunk=5)


@pytest.mark.parametrize("bad,match", [
    (dict(remat_policy="dots"), "remat_policy 'dots'"),
    (dict(remat_policy="minimal"), "remat_policy 'minimal'"),
    (dict(remat_policy="nope"), "unknown remat_policy"),
    (dict(n_experts=4), "n_experts"),
    (dict(sp_strategy="tree"), "unknown sp_strategy"),
])
def test_knobs_not_ported_raise(bad, match):
    with pytest.raises(ValueError, match=match):
        tt.TransformerConfig(**dict(KW, **bad))


def test_param_leaves_order_is_sorted_and_complete():
    _, _, _, tparams = _models()
    leaves = tt.param_leaves(tparams)
    assert len(leaves) == 3 + len(tparams["layers"])
    assert leaves[0] is tparams["embed"]
    assert leaves[-1] is tparams["unembed"]
