"""Port parity: ``nos_tpu_torch.train.optim`` against the reference's
optax chain (``nos_tpu.train.optim``) in f32, on the CPU.

The same gradient sequence (numpy, from a seed) feeds both; params are
compared after every step. Tolerance in f32: 2e-6 absolute on params of
unit scale after lr-1e-2 updates (the bound the port was first held to;
the f32 schedules differ by a few ulp, ``test_schedule_matches_optax``).

In bf16 the port runs optax's own sequence of ops, each rounded to bf16,
with optax's constants rounded to bf16 (b1 = 0.9 becomes 0.8984375), so
the bound there is bit equality of params and both moments after every
step, against the chain jitted as the reference's train step is. It
holds on XLA:CPU, which rounds every bf16 op of that program; a backend
that kept f32 between the ops of a fusion would differ from it by a few
bf16 ulp per element.
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
    assert opt.mu[0].dtype == torch.bfloat16
    assert opt.nu[0].dtype == torch.bfloat16
    assert opt.mu[1].dtype == opt.nu[1].dtype == torch.float32
    # zero gradients: only the decoupled decay moves the params
    assert torch.allclose(norm.detach(), torch.full((4,), 0.95))
    assert torch.allclose(p.detach().float(), torch.full((4,), 0.95),
                          atol=4e-3)


def _adam_state(state):
    """optax's ScaleByAdamState inside a (chained, MultiSteps) state."""
    if hasattr(state, "mu") and hasattr(state, "nu"):
        return state
    children = (state if isinstance(state, tuple)
                else [getattr(state, "inner_opt_state", None)])
    for child in children:
        if child is not None and not isinstance(child, (int, float)):
            found = _adam_state(child)
            if found is not None:
                return found
    return None


@pytest.mark.parametrize("kw", [
    dict(),
    dict(weight_decay=0.1, b1=0.8, b2=0.99),
    dict(warmup_steps=2, schedule="cosine", min_lr_ratio=0.2),
    dict(grad_clip=0.05),
    dict(accum_steps=3, warmup_steps=3, schedule="cosine"),
], ids=["adamw", "decay_betas", "warmup_cosine", "clip_active", "accum3"])
def test_bf16_updates_equal_optax_bit_for_bit(kw):
    """bf16 params and gradients, 8 steps: params and both moments equal
    the jitted optax chain's after every step (the clip limit 0.05 is
    below every step's gradient norm, so clipping acts each time)."""
    import ml_dtypes

    bf16 = ml_dtypes.bfloat16
    n_steps = 8
    rng = np.random.default_rng(4)
    shapes = [(64, 32), (257,), (8, 16, 4)]
    init = [(rng.normal(size=s) * 0.05).astype(bf16) for s in shapes]
    grads = [[(rng.normal(size=s) * 1e-2).astype(bf16) for s in shapes]
             for _ in range(n_steps)]
    tx = jo.build_optimizer(1e-2, n_steps, **kw)
    jparams = [jnp.asarray(p) for p in init]
    state = tx.init(jparams)

    @jax.jit
    def update(gs, state, params):
        updates, state = tx.update(gs, state, params)
        return optax.apply_updates(params, updates), state

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)

    tparams = [t(p).requires_grad_() for p in init]
    opt = to.build_optimizer(tparams, 1e-2, n_steps, **kw)
    for i, gs in enumerate(grads):
        jparams, state = update([jnp.asarray(g) for g in gs], state,
                                jparams)
        for p, g in zip(tparams, gs):
            p.grad = t(g)
        opt.step()
        adam = _adam_state(state)
        for name, want, got in (("params", jparams, tparams),
                                ("mu", adam.mu, opt.mu),
                                ("nu", adam.nu, opt.nu)):
            for w, g in zip(want, got):
                assert g.dtype == torch.bfloat16
                np.testing.assert_array_equal(
                    g.detach().float().numpy(),
                    np.asarray(w).astype(np.float32),
                    err_msg=f"{name} after step {i}")


def _kernel_emulation(p, g, mu, nu, consts, dtype):
    """``csrc/adamw.cu``'s per-element arithmetic in numpy: each IEEE f32
    operation, then a rounding to the leaf's dtype (bf16 by ml_dtypes'
    round to nearest even, f32 the identity)."""
    import ml_dtypes

    def r(x):
        x = np.asarray(x, np.float32)
        return x if dtype == torch.float32 else \
            x.astype(ml_dtypes.bfloat16).astype(np.float32)

    c1, b1, c2, b2, bc1, bc2, eps, wd, step = (np.float32(c) for c in consts)
    m = r(r(c1 * g) + r(b1 * mu))
    v = r(r(c2 * r(g * g)) + r(b2 * nu))
    den = r(r(np.sqrt(r(v / bc2))) + eps)
    u = r(r(m / bc1) / den)
    u = r(u + r(wd * p))
    u = r(step * u)
    return r(p + u), m, v


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("count", [1, 2, 50])
def test_kernel_arithmetic_equals_the_plain_version(dtype, count):
    """The CUDA kernel runs only on the card; its arithmetic, emulated
    here op by op, gives the plain version's bits on the CPU."""
    rng = np.random.default_rng(count)
    vals = [torch.from_numpy(rng.normal(size=(33, 17)).astype(np.float32)
                             * s).to(dtype)
            for s in (0.05, 1e-2, 1e-3, 1e-5)]
    vals[3] = vals[3].abs()                         # nu >= 0
    consts = to.adamw_consts(dtype, count, 3e-3, b1=0.9, b2=0.95, eps=1e-8,
                             weight_decay=0.01)
    want = _kernel_emulation(*(v.float().numpy() for v in vals), consts,
                             dtype)
    p, g, mu, nu = (v.clone() for v in vals)
    to.adamw_update(p, g, mu, nu, consts)
    for got, w in zip((p, mu, nu), want):
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), w)


def test_adamw_consts_round_to_the_dtype():
    c = to.adamw_consts(torch.bfloat16, 1, 3e-4, b1=0.9, b2=0.95, eps=1e-8,
                        weight_decay=0.01)
    assert c[1] == 0.8984375 and c[3] == 0.94921875      # bf16 betas
    assert c[4] == float(torch.tensor(0.1, dtype=torch.bfloat16))
    f = to.adamw_consts(torch.float32, 3, 3e-4, b1=0.9, b2=0.95, eps=1e-8,
                        weight_decay=0.01)
    assert f[4] == float(np.float32(1) - np.float32(0.9) ** np.float32(3))
    assert f[8] == -float(np.float32(3e-4))


def test_kernel_wrapper_refuses_cpu_tensors():
    """On the card the update launches the kernel or raises; CPU tensors
    take the plain version only through ``adamw_update``."""
    from nos_tpu_torch.ops import _kernels

    t = [torch.zeros(8) for _ in range(4)]
    consts = to.adamw_consts(torch.float32, 1, 1e-3, b1=0.9, b2=0.95,
                             eps=1e-8, weight_decay=0.0)
    launches = _kernels.adamw.launches
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.adamw.launch(*t, consts)
    to.adamw_update(*t, consts)
    assert _kernels.adamw.launches == launches
