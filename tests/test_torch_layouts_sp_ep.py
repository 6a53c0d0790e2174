"""Port parity: the trainer's sp (ring and Ulysses) and ep layouts, and
the MoE family under tp, of ``nos_tpu_torch`` against ``nos_tpu``'s
sharded train step, on the CPU.

As ``tests/test_torch_layouts.py`` (whose tiny f32 model, run, helpers
and tolerances this file shares): every rank a CPU process over gloo,
the reference's GSPMD step on the conftest's virtual CPU devices, both
from the reference's params and the same synthetic batches, three
steps' losses and the gathered params at rtol 1e-5 / atol 1e-5. Then
the MoE's own holds at tp 2 x ep 2: the router's gradient equals one
device's and is the same bits on every model rank, every rank routes
alike, the global-norm clip counts each leaf's parts once, and a
checkpoint saved there crosses to dp 2, one device, and back bit for
bit; and under sp the gating's capacity is the whole sequence's.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import test_torch_layouts as base  # noqa: E402
from nos_tpu.models import transformer as jt  # noqa: E402
from nos_tpu.ops import moe as jmoe  # noqa: E402
from nos_tpu.parallel.layout import ParallelLayout as JLayout  # noqa: E402
from nos_tpu_torch.cmd import trainer as ttr  # noqa: E402
from nos_tpu_torch.models import transformer as tt  # noqa: E402
from nos_tpu_torch.ops import moe as tmoe  # noqa: E402
from nos_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from nos_tpu_torch.parallel.layout import ParallelLayout  # noqa: E402
from nos_tpu_torch.parallel.mesh import init_train_mesh  # noqa: E402
from nos_tpu_torch.train import optim as to  # noqa: E402
from nos_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402

RTOL, ATOL, STEPS, TIMEOUT_S = base.RTOL, base.ATOL, base.STEPS, \
    base.TIMEOUT_S
AXES = ("dp", "fsdp", "tp", "sp", "ep")


@pytest.fixture(autouse=True)
def _rank_limit(monkeypatch):
    monkeypatch.setattr(ttr, "RANK_TIMEOUT_S", TIMEOUT_S)


LAYOUTS = [dict(ep=2, n_experts=2),
           # the reference's test_trains_moe_with_ep
           dict(dp=2, ep=2, n_experts=2),
           dict(tp=2, n_experts=2), dict(tp=2, ep=2, n_experts=4),
           dict(sp=2), dict(sp=2, sp_strategy="ulysses"), dict(dp=2, sp=2),
           dict(tp=2, sp=2, sp_strategy="ulysses"),
           # the gating over the whole sequence: E 2 takes every token
           # twice, E 4's capacity 10 drops across the sp boundary
           dict(sp=2, n_experts=2), dict(sp=2, n_experts=4),
           dict(sp=2, remat_policy="minimal")]


@pytest.mark.parametrize("kw", LAYOUTS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_layout_steps_match_reference(kw, tmp_path):
    """Three steps of ``train()`` under the layout against the
    reference's ``make_train_step(jcfg, tx, build_mesh(layout))``:
    losses, and the params the last step's checkpoint gathered (under
    Ulysses against the reference's ring step)."""
    layout = {k: v for k, v in kw.items() if k in AXES}
    model = {k: v for k, v in kw.items() if k not in layout}
    # the reference's Ulysses does not differentiate under this JAX (its
    # all-to-all's transpose gets a cotangent of another shape), so its
    # ring, the same exact attention, stands in on its side
    jcfg = base._jcfg(**dict(model, sp_strategy="ring") if "sp_strategy"
                      in model else model)
    jparams = jt.init_params(jax.random.PRNGKey(1), jcfg)
    d = str(tmp_path / "ckpt")
    cfg = base._cfg(checkpoint_dir=d, **kw)
    base._step0(d, jparams, cfg)
    losses, ranks = base._train(cfg)
    want_losses, want_params = base._reference(jparams, jcfg,
                                               JLayout(**layout), cfg)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL)
    base._close(base._restored(d, STEPS, base._tcfg(**model)), want_params)
    n = ParallelLayout(**layout).chips
    assert [r["rank"] for r in ranks] == list(range(n))
    assert {(r["first_step"], r["last_step"]) for r in ranks} == {(0, STEPS)}


MOE = dict(n_experts=4)
MOE_LAYOUT = ParallelLayout(tp=2, ep=2)


def _moe_batch():
    cfg = base._cfg(**MOE)
    return ttr.synthetic_batch(cfg, 0, "cpu")


def _grad_rank(rank, store, jparams, layout, timeout_s):
    """One rank of the router test: one forward and backward of its part
    of the reference's params on the step-0 batch; returns the router's
    gradient (whole on every rank) and every gating call's dispatch."""
    import torch.distributed as dist

    mesh = init_train_mesh(layout, rank, ["cpu"] * layout.chips, store,
                           timeout_s)
    dispatches = []
    real = tmoe.top2_gating

    def traced(*args, **kw):
        out = real(*args, **kw)
        dispatches.append(out[1].numpy().copy())
        return out

    tmoe.top2_gating = traced
    try:
        full = tt.params_from_jax(jparams, "cpu")
        params = tt.rank_params(full, mesh)
        for p in tt.param_leaves(params):
            p.requires_grad_()
        loss = tt.loss_fn(params, base._tcfg(**MOE), _moe_batch(), mesh)
        loss.backward()
        router = params["layers"]["w_router"]
        return router.grad.numpy(), dispatches
    finally:
        tmoe.top2_gating = real
        dist.destroy_process_group()


def test_router_gradient_and_routing_under_tp_and_ep():
    """At tp 2 x ep 2 the router, whole on every rank, gets one device's
    gradient (its combine path summed over the ranks' experts and d_ff
    slices, the aux loss counted once), the same bits on every rank; and
    every rank's gating dispatches the same tokens, bit for bit, in the
    forward and in the recompute."""
    jparams = jt.init_params(jax.random.PRNGKey(1), base._jcfg(**MOE))
    params = tt.params_from_jax(jparams, "cpu")
    for p in tt.param_leaves(params):
        p.requires_grad_()
    tt.loss_fn(params, base._tcfg(**MOE), _moe_batch()).backward()
    want = params["layers"]["w_router"].grad.numpy()
    got = run_ranks(
        lambda store: _grad_rank(0, store, jparams, MOE_LAYOUT, TIMEOUT_S),
        _grad_rank, (jparams, MOE_LAYOUT, TIMEOUT_S), MOE_LAYOUT.chips,
        TIMEOUT_S)
    np.testing.assert_allclose(got[0][0], want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())
    # each layer routes twice: its forward and its remat recompute
    assert len(got[0][1]) == 2 * base.MODEL["n_layers"]
    for grad, dispatches in got[1:]:
        assert np.array_equal(grad, got[0][0])
        assert len(dispatches) == len(got[0][1])
        for a, b in zip(dispatches, got[0][1]):
            assert np.array_equal(a, b)


def test_global_norm_clip_over_tp_and_ep_matches_one_device():
    """The clip's global norm over tp 2 x ep 2 (an expert leaf summed over
    its tp and ep parts, the router and the other leaves ep does not
    split counted once) clips every MoE gradient as one device does."""
    rng = np.random.default_rng(1)
    shapes = tt.abstract_params(base._tcfg(**MOE))
    grads = {k: ({n: rng.standard_normal(t.shape).astype(np.float32)
                  for n, t in v.items()} if k == "layers"
                 else rng.standard_normal(v.shape).astype(np.float32))
             for k, v in shapes.items()}
    clip = 1.0
    want = tt.param_leaves(tt.params_from_jax(grads, "cpu"))
    to.build_optimizer([torch.zeros_like(g) for g in want], 1e-3, 3,
                       grad_clip=clip)._clip(want)
    ranks = run_ranks(
        lambda store: base._clip_rank(0, store, grads, clip, MOE_LAYOUT,
                                      TIMEOUT_S),
        base._clip_rank, (grads, clip, MOE_LAYOUT, TIMEOUT_S),
        MOE_LAYOUT.chips, TIMEOUT_S)
    for got in ranks:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-6, atol=1e-7)


def test_checkpoint_crosses_tp_ep_layouts(tmp_path):
    """``train()`` at tp 2 x ep 2 checkpoints steps 2 and 4 (full leaves);
    step 2 resumed under dp 2 and on one device reaches step 4's losses
    and params within the f32 tolerance, and under tp 2 x ep 2 bit for
    bit."""
    a = str(tmp_path / "a")
    losses, _ = base._train(base._cfg(steps=4, checkpoint_dir=a,
                                      checkpoint_every=2, tp=2, ep=2, **MOE))
    assert CheckpointManager(a).all_steps() == [2, 4]
    want = base._restored(a, 4, base._tcfg(**MOE))
    for label, kw, exact in (("dp", dict(dp=2), False), ("one", {}, False),
                             ("tp_ep", dict(tp=2, ep=2), True)):
        d = str(tmp_path / label)
        base._copy_step(a, d, 2)
        resumed, _ = base._train(base._cfg(steps=4, checkpoint_dir=d, **kw,
                                           **MOE))
        got = base._restored(d, 4, base._tcfg(**MOE))
        if exact:
            assert resumed == losses[2:]
            for x, y in zip(tt.param_leaves(got), tt.param_leaves(want)):
                assert torch.equal(x, y)
            continue
        np.testing.assert_allclose(resumed, losses[2:], rtol=RTOL)
        for x, y in zip(tt.param_leaves(got), tt.param_leaves(want)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL,
                                       atol=ATOL)


def _moe_sp_rank(rank, store, arrays, factor, timeout_s):
    """One sp rank of the capacity test: ``moe_ffn_mesh`` on its rows
    under autograd; its rows of the output, the aux loss, and the
    gradients of its rows of h and of the whole router and experts."""
    import torch.distributed as dist

    sp = 2
    mesh = init_train_mesh(ParallelLayout(sp=sp), rank, ["cpu"] * sp, store,
                           timeout_s)
    try:
        h, router, wg, wu, wd, dy = (torch.from_numpy(a) for a in arrays)
        s = h.shape[1] // sp
        rows = slice(rank * s, (rank + 1) * s)
        h = h[:, rows].clone().requires_grad_()
        leaves = [t.clone().requires_grad_() for t in (router, wg, wu, wd)]
        out, aux = tmoe.moe_ffn_mesh(h, *leaves, mesh, factor)
        # each rank's share of a loss whose aux term counts once
        ((out * dy[:, rows]).sum() + aux / sp).backward()
        return [t.detach().numpy() for t in [out, aux, h.grad]
                ] + [t.grad.numpy() for t in leaves]
    finally:
        dist.destroy_process_group()


def test_moe_gating_under_sp_keeps_the_whole_sequence_capacity():
    """With a capacity factor that drops tokens, ``moe_ffn_mesh`` over
    sp 2 gates on the whole sequence: each rank's rows of the output and
    the aux loss equal the reference's ``moe_ffn`` on the unsplit batch
    (drops in the second half that only the first half's load causes
    included), and the gradients, summed over the ranks, equal the
    unsplit op's."""
    rng = np.random.default_rng(3)
    b, s, d, e, f, factor = 2, 16, 8, 2, 16, 0.5
    arrays = [rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, s, d), (d, e), (e, d, f), (e, d, f), (e, f, d), (b, s, d))]
    cap = jmoe.expert_capacity(s, e, factor)
    combine, _, _ = jmoe.top2_gating(jnp.asarray(arrays[0]) @ jnp.asarray(
        arrays[1]), cap)
    # tokens of the second half are dropped that the half alone keeps
    kept_whole = np.asarray(combine).sum(axis=(2, 3))[:, s // 2:] > 0
    half, _, _ = jmoe.top2_gating(jnp.asarray(arrays[0][:, s // 2:])
                                  @ jnp.asarray(arrays[1]), cap)
    assert (np.asarray(half).sum(axis=(2, 3)) > 0).sum() > kept_whole.sum()

    def ref(h, router, wg, wu, wd):
        out, aux = jmoe.moe_ffn(h, router, wg, wu, wd, factor)
        return (out * jnp.asarray(arrays[5])).sum() + aux, (out, aux)

    grads, (out, aux) = jax.grad(ref, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a) for a in arrays[:5]))
    got = run_ranks(
        lambda store: _moe_sp_rank(0, store, arrays, factor, TIMEOUT_S),
        _moe_sp_rank, (arrays, factor, TIMEOUT_S), 2, TIMEOUT_S)
    np.testing.assert_allclose(np.concatenate([r[0] for r in got], 1),
                               np.asarray(out), rtol=RTOL, atol=ATOL)
    for r in got:
        np.testing.assert_allclose(r[1], float(aux), rtol=RTOL)
    np.testing.assert_allclose(np.concatenate([r[2] for r in got], 1),
                               np.asarray(grads[0]), rtol=RTOL, atol=ATOL)
    for i, want in enumerate(grads[1:]):
        summed = sum(r[3 + i] for r in got)
        np.testing.assert_allclose(summed, np.asarray(want), rtol=1e-4,
                                   atol=ATOL)
