"""Port parity: ``nos_tpu_torch.train.optim`` against the reference's
optax chain (``nos_tpu.train.optim``) in f32, on the CPU.

The same gradient sequence (numpy, from a seed) feeds both; params are
compared after every step. Tolerance: 2e-6 absolute on params of unit
scale after lr-1e-2 updates: the libraries order the adamw arithmetic
differently (torch decays the param before the Adam step, optax sums
both into one update), a few f32 ulps per step.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from nos_tpu.train import optim as jo  # noqa: E402
from nos_tpu_torch.train import optim as to  # noqa: E402

PARAM_TOL = 2e-6
SHAPES = [(4, 3), (5,), (2, 3, 2)]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(warmup_steps=4),
    dict(schedule="cosine"),
    dict(schedule="cosine", warmup_steps=3, min_lr_ratio=0.1),
])
def test_schedule_matches_optax(kw):
    # optax evaluates the schedule in f32: near the end of the cosine,
    # 1 + cos(x) cancels, a relative f32 error of ~1e-6
    total = 12
    want = jo.build_lr_schedule(0.3, total, **kw)
    got = to.build_lr_schedule(0.3, total, **kw)
    for count in range(total + 4):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-5,
                                           abs=1e-8)


def test_warmup_gives_lr_zero_on_the_first_update():
    lr = to.build_lr_schedule(1.0, 10, warmup_steps=4)
    assert [lr(c) for c in range(5)] == [0.0, 0.25, 0.5, 0.75, 1.0]


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown lr schedule 'step'"):
        to.build_lr_schedule(1.0, 10, schedule="step")


def _run_both(kw, n_steps, seed=0, grad_scale=1.0):
    """Params after each step, (optax, port), for one grad sequence."""
    rng = np.random.default_rng(seed)
    init = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.normal(size=s) * grad_scale).astype(np.float32)
              for s in SHAPES] for _ in range(n_steps)]
    tx = jo.build_optimizer(1e-2, n_steps, **kw)
    jparams = [jnp.asarray(p) for p in init]
    state = tx.init(jparams)
    tparams = [torch.tensor(p, requires_grad=True) for p in init]
    opt = to.build_optimizer(tparams, 1e-2, n_steps, **kw)
    out = []
    for gs in grads:
        updates, state = tx.update([jnp.asarray(g) for g in gs], state,
                                   jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, gs):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        out.append(([np.asarray(p) for p in jparams],
                    [p.detach().numpy().copy() for p in tparams]))
    return out, opt


@pytest.mark.parametrize("kw", [
    dict(),
    dict(weight_decay=0.1, b1=0.8, b2=0.99),
    dict(warmup_steps=2, schedule="cosine", min_lr_ratio=0.2),
    dict(grad_clip=1.0),
    dict(accum_steps=3, warmup_steps=3, schedule="cosine"),
    dict(accum_steps=2, grad_clip=0.5),
], ids=["adamw", "decay_betas", "warmup_cosine", "clip", "accum3",
        "accum2_clip"])
def test_updates_match_optax_every_step(kw):
    steps, opt = _run_both(kw, 7)
    for i, (want, got) in enumerate(steps):
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, atol=PARAM_TOL, rtol=0,
                                       err_msg=f"step {i}")
    assert all(p.grad is None for p in opt.params)


def test_clip_scales_without_epsilon():
    """Grads far above the clip norm: one update with max_norm 1 moves
    exactly like optax's (t / ||g||) * max_norm, no 1e-6 in the norm."""
    steps, _ = _run_both(dict(grad_clip=1.0), 3, seed=5, grad_scale=50.0)
    for want, got in steps:
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, atol=PARAM_TOL, rtol=0)


def test_accumulation_applies_one_update_per_window():
    steps, opt = _run_both(dict(accum_steps=3), 6, seed=2)
    # micro-steps 1 and 2 leave the params as they were; the 3rd moves them
    for a, b, c in zip(steps[0][1], steps[1][1], steps[2][1]):
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(b, c)
    assert opt.count == 2 and opt.mini_step == 0


def test_moments_kept_in_the_params_dtype_and_decay_on_every_leaf():
    p = torch.ones(4, dtype=torch.bfloat16, requires_grad=True)
    norm = torch.ones(4, dtype=torch.float32, requires_grad=True)
    opt = to.build_optimizer([p, norm], 0.5, 10, weight_decay=0.1)
    p.grad = torch.zeros_like(p)
    norm.grad = torch.zeros_like(norm)
    opt.step()
    state = opt.adamw.state[p]
    assert state["exp_avg"].dtype == torch.bfloat16
    assert state["exp_avg_sq"].dtype == torch.bfloat16
    # zero gradients: only the decoupled decay moves the params
    assert torch.allclose(norm.detach(), torch.full((4,), 0.95))
    assert torch.allclose(p.detach().float(), torch.full((4,), 0.95),
                          atol=4e-3)
