"""Port parity: Mixture-of-Experts training (``n_experts`` > 0) of
``nos_tpu_torch`` against ``nos_tpu`` on the CPU, f32, tiny widths.

From the same params (``params_from_jax``) and batches, at capacity
factor 1.25 (some assignments dropped) and 4.0 (none dropped):

- ``loss_fn``'s loss within 1e-5 relative and the aux (the mean of the
  layers') within 1e-6 relative;
- every gradient leaf, ``w_router`` included, within ``GRAD_TOL`` of
  the leaf's largest |gradient| (both sides f32: the attention and the
  expert products sum in other orders, ~1e-7 relative per product,
  which two layers' backward carry to ~1e-6 of a leaf's scale);
- three ``make_train_step`` steps: losses and params held as the dense
  ``test_three_train_steps_match_reference`` holds them;
- the gating softmax's backward against ``jax.vjp`` of
  ``jax.nn.softmax`` (JAX's rule; a few f32 ulps apart at most);
- ``train()`` with ``n_experts`` 4 on the CPU.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.models import transformer as jt  # noqa: E402
from nos_tpu.train import optim as jo  # noqa: E402
from nos_tpu_torch.cmd import trainer as ttr  # noqa: E402
from nos_tpu_torch.models import transformer as tt  # noqa: E402
from nos_tpu_torch.ops import moe as tmoe  # noqa: E402
from nos_tpu_torch.train import optim as to  # noqa: E402

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=64, max_seq=32, n_experts=4)
BATCH, SEQ = 2, 16
OPT = dict(warmup_steps=1, schedule="cosine", grad_clip=1.0,
           weight_decay=0.1)
LOSS_RTOL, AUX_RTOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-6, 1e-5, 2e-5
# 1.25: C = int(16 * 2 * 1.25 / 4) = 10 slots an expert, and the seeded
# batches overflow some; 4.0: C = 32 >= the 16 tokens a row can send
CAPACITIES = [1.25, 4.0]


def _leaves(tree):
    out = []
    for key in sorted(tree):
        v = tree[key]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _names(tree, prefix=""):
    out = []
    for key in sorted(tree):
        v = tree[key]
        out.extend(_names(v, f"{prefix}{key}/") if isinstance(v, dict)
                   else [prefix + key])
    return out


def _models(capacity):
    jcfg = jt.TransformerConfig(dtype=jnp.float32,
                                expert_capacity_factor=capacity, **KW)
    tcfg = tt.TransformerConfig(dtype=torch.float32,
                                expert_capacity_factor=capacity, **KW)
    jparams = jt.init_params(jax.random.PRNGKey(3), jcfg)
    return jcfg, tcfg, jparams, tt.params_from_jax(jparams, device="cpu")


def _batch(seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, KW["vocab"], size=(BATCH, SEQ)).astype(np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}


def _dropped(tparams, tcfg, tokens) -> int:
    """Routing assignments the capacity drops in the first layer."""
    from nos_tpu_torch.ops.layers import rms_norm

    layer = {k: v[0] for k, v in tparams["layers"].items()}
    x = torch.nn.functional.embedding(tokens, tparams["embed"])
    freqs = tt.rope_frequencies(tcfg.head_dim, tcfg.max_seq,
                                tcfg.rope_theta, tokens.device)
    x = tt.attention_block(x, layer, tcfg, freqs, tt._attention_call)
    h = rms_norm(x, layer["mlp_norm"])
    cap = tmoe.expert_capacity(SEQ, KW["n_experts"],
                               tcfg.expert_capacity_factor)
    _, dispatch, _ = tmoe.top2_gating(h @ layer["w_router"], cap)
    return 2 * BATCH * SEQ - int(dispatch.sum())


@pytest.mark.parametrize("capacity", CAPACITIES)
def test_loss_aux_and_gradients_match_reference(capacity):
    jcfg, tcfg, jparams, tparams = _models(capacity)
    batch = _batch(0)
    tokens = torch.from_numpy(batch["tokens"]).long()
    dropped = _dropped(tparams, tcfg, tokens)
    assert (dropped > 0) == (capacity == 1.25), dropped

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(jt.loss_fn)(jparams, jcfg, jbatch)
    _, jaux = jt.forward(jparams, jcfg, jbatch["tokens"], return_aux=True)

    leaves = tt.param_leaves(tparams)
    for p in leaves:
        p.requires_grad_()
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss = tt.loss_fn(tparams, tcfg, tbatch)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        _, aux = tt.forward(tparams, tcfg, tbatch["tokens"], return_aux=True)

    loss = float(loss.detach())
    assert abs(loss - float(jloss)) <= LOSS_RTOL * float(jloss)
    assert float(aux) > 0
    assert abs(float(aux) - float(jaux)) <= AUX_RTOL * float(jaux)
    names = _names(jgrads)
    assert "layers/w_router" in names
    for name, got, want in zip(names, grads, _leaves(jgrads)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0, name
        err = np.abs(got.numpy() - want).max()
        assert err <= GRAD_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("capacity", CAPACITIES)
def test_three_train_steps_match_reference(capacity):
    jcfg, tcfg, jparams, tparams = _models(capacity)
    leaves = tt.param_leaves(tparams)
    for p in leaves:
        p.requires_grad_()
    tx = jo.build_optimizer(1e-3, 3, **OPT)
    state = tx.init(jparams)
    jstep = jax.jit(jt.make_train_step(jcfg, tx))
    tstep = tt.make_train_step(tcfg, to.build_optimizer(leaves, 1e-3, 3,
                                                        **OPT))
    for i in range(3):
        batch = _batch(10 + i)
        jparams, state, jloss = jstep(
            jparams, state, {k: jnp.asarray(v) for k, v in batch.items()})
        loss = tstep(tparams, {k: torch.from_numpy(v).long()
                               for k, v in batch.items()})
        assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * float(jloss), i
    for got, want in zip(leaves, _leaves(jparams)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=PARAM_TOL, rtol=0)


@pytest.mark.parametrize("shape", [(2, 16, 4), (1, 5, 8), (3, 7, 2)])
def test_gating_softmax_backward_is_jax_rule(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    y, vjp = jax.vjp(jax.nn.softmax, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    yt = tmoe._softmax(xt)
    (got,) = torch.autograd.grad(yt, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(y))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=4 * np.finfo(np.float32).eps
                               * np.abs(g).max())


def test_gating_softmax_is_differentiated_as_exp_not_its_polynomial():
    """d softmax / dx through the emulated exp equals the analytic
    Jacobian diag(y) - y y^T, not the Cephes polynomial's derivative."""
    x = torch.tensor([[0.3, -1.2, 2.5, 0.0]], requires_grad=True)
    y = tmoe._softmax(x)
    jac = torch.stack([torch.autograd.grad(y[0, i], x, retain_graph=True)[0]
                       [0] for i in range(4)])
    yd = y.detach()[0]
    want = torch.diag(yd) - yd[:, None] * yd[None, :]
    torch.testing.assert_close(jac, want, rtol=0, atol=1e-7)


def test_train_with_n_experts_on_the_cpu(caplog):
    import logging

    cfg = ttr.TrainerConfig(**dict(KW, n_experts=4), steps=3, batch_size=2,
                            seq_len=16, log_every=1, bf16=False,
                            learning_rate=1e-2)
    with caplog.at_level(logging.INFO, logger="nos_tpu_torch.trainer"):
        loss = ttr.train(cfg, device="cpu")
    assert np.isfinite(loss)
    steps = [r for r in caplog.records if r.getMessage().startswith("step ")]
    assert len(steps) == 3


def test_moe_training_forward_under_remat_equals_without():
    """Full remat recomputes each layer's gating in backward with the
    same bits: loss, aux and gradients equal the un-rematerialized
    step's."""
    import dataclasses

    _, tcfg, _, tparams = _models(1.25)
    batch = {k: torch.from_numpy(v).long() for k, v in _batch(5).items()}
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        leaves = [p.detach().clone().requires_grad_()
                  for p in tt.param_leaves(tparams)]
        params = _rebuild(tparams, iter(leaves))
        loss = tt.loss_fn(params, cfg, batch)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (la, ga), (lb, gb) = out
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))


def _rebuild(tree, it):
    return {k: _rebuild(tree[k], it) if isinstance(tree[k], dict)
            else next(it) for k in sorted(tree)}
