"""Port parity: the pipeline schedules of ``nos_tpu_torch``
(``parallel/pipeline.py``) against ``nos_tpu.parallel.pipeline``, on the
CPU.

The port's interleaved tick tables equal the reference's class cell for
cell. Each schedule's loss and gradients (GPipe, 1F1B, interleaved
1F1B; dense and MoE; pp 2 and 4, 1 to 4 microbatches) equal the
reference's ``pipeline_loss_fn``, ``pipeline_1f1b_loss_fn`` and
``pipeline_interleaved_loss_fn`` under ``jax.value_and_grad`` on the
conftest's virtual CPU devices, each pp rank of the port a CPU process
over gloo, at ``tests/test_torch_layouts.py``'s tolerance (rtol 1e-5 /
atol 1e-5: the two sides differ in the order of their reductions); so
does each schedule's forward-only loss (eval). A pipelined layout the
reference refuses is refused with its message, and a rank holds P saved
stage inputs under 1F1B and M under GPipe (slots counted).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import test_torch_layouts as base  # noqa: E402
from nos_tpu.models import transformer as jt  # noqa: E402
from nos_tpu.parallel import pipeline as jp  # noqa: E402
from nos_tpu.parallel.layout import ParallelLayout as JLayout  # noqa: E402
from nos_tpu.parallel.mesh import build_mesh  # noqa: E402
from nos_tpu_torch.cmd import trainer as ttr  # noqa: E402
from nos_tpu_torch.models import transformer as tt  # noqa: E402
from nos_tpu_torch.parallel import pipeline as tp  # noqa: E402
from nos_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from nos_tpu_torch.parallel.layout import ParallelLayout  # noqa: E402
from nos_tpu_torch.parallel.mesh import init_train_mesh  # noqa: E402

RTOL = ATOL = base.RTOL
TIMEOUT_S = base.TIMEOUT_S
MODEL = dict(base.MODEL, n_layers=4)
BATCH, SEQ = 4, 16


# -- the interleaved tables --------------------------------------------------

TABLE_CASES = [(P, v, M, fwd_only) for P in (2, 4) for v in (2, 4)
               for M in sorted({P, 2 * P, 8}) for fwd_only in (False, True)]


@pytest.mark.parametrize("P,v,M,fwd_only", TABLE_CASES)
def test_interleaved_tables_equal_the_reference(P, v, M, fwd_only):
    """Every table of the port's ``_InterleavedSchedule`` (unit, chunk
    slot, microbatch, the receive routing), its tick count, ring depth
    and bubble fraction equal the reference class's, and so does the
    ring depth the two table sets share."""
    got = tp._InterleavedSchedule(P, v, M, fwd_only)
    want = jp._InterleavedSchedule(P, v, M, fwd_only)
    for name in ("unit", "slot", "mb", "rf_slot", "rf_mb", "rg_slot",
                 "rg_mb"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert (got.T, got.R) == (want.T, want.R)
    assert got.bubble_fraction() == want.bubble_fraction()
    other = tp._InterleavedSchedule(P, v, M, not fwd_only)
    ref_other = jp._InterleavedSchedule(P, v, M, not fwd_only)
    R = max(want.R, ref_other.R)
    while not (want.ring_ok(R) and ref_other.ring_ok(R)) and R < M:
        R += 1
    assert tp._shared_ring(got, other, M) == R


@pytest.mark.parametrize("n_layers,P,v", [(4, 2, 2), (8, 2, 2), (8, 4, 2),
                                          (8, 2, 4), (16, 4, 4)])
def test_interleave_layer_order_and_inverse(n_layers, P, v):
    """``interleave_layer_order`` is the reference's, and
    ``interleave_params`` / ``deinterleave_params`` permute a layer leaf
    as the reference's do and invert each other."""
    assert tp.interleave_layer_order(n_layers, P, v) == \
        jp.interleave_layer_order(n_layers, P, v)
    cfg = base._jcfg(**dict(MODEL, n_layers=n_layers))
    jparams = jt.init_params(jax.random.PRNGKey(0), cfg)
    params = tt.params_from_jax(jparams, "cpu")
    got = tp.interleave_params(params, P, v)
    want = jp.interleave_params(jparams, P, v)
    for k, w in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][k].numpy(),
                                      np.asarray(w))
    back = tp.deinterleave_params(got, P, v)
    for a, b in zip(tt.param_leaves(back), tt.param_leaves(params)):
        assert torch.equal(a, b)


# -- loss and gradients against the reference's schedules -----------------

def _batch(vocab: int, rows: int = BATCH) -> dict:
    tok = np.random.default_rng(1).integers(0, vocab, (rows, SEQ))
    return {"tokens": tok, "targets": np.roll(tok, -1, 1)}


def _host(tree):
    """The reference's params as numpy arrays: what a rank unpickles
    then needs no JAX."""
    return jax.tree.map(np.asarray, tree)


class _flash_calls(dict):
    """Within the block, the flash kernels' plain versions' calls in
    this process (a rank's): ``fwd`` (the forward op's) and ``bwd`` (the
    backward's, three kernels on the card)."""

    def __enter__(self):
        from nos_tpu_torch.ops import attention

        self.mod = attention
        self.real = (attention.flash_attention_reference,
                     attention.flash_attention_backward_reference)
        self.update(fwd=0, bwd=0)

        def counted(key, fn):
            def call(*args, **kw):
                self[key] += 1
                return fn(*args, **kw)
            return call

        attention.flash_attention_reference = counted("fwd", self.real[0])
        attention.flash_attention_backward_reference = counted(
            "bwd", self.real[1])
        return self

    def __exit__(self, *exc):
        (self.mod.flash_attention_reference,
         self.mod.flash_attention_backward_reference) = self.real


def _pipe_rank(rank, store, jparams, model, P, M, schedule, v, timeout_s,
               rows=BATCH):
    """One pp rank: its part of the reference's params, the schedule's
    loss with its gradients, gathered whole, and the forward-only
    loss."""
    import torch.distributed as dist

    layout = ParallelLayout(pp=P)
    # one thread a rank: the ranks share the host's cores (rank 0's
    # process gets its own count back)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mesh = init_train_mesh(layout, rank, ["cpu"] * P, store, timeout_s)
    try:
        full = tt.params_from_jax(jparams, "cpu")
        splits = tt.leaf_splits(full, mesh)
        params = tt.rank_params(full, mesh)
        leaves = tt.param_leaves(params)
        for p in leaves:
            p.requires_grad_()
        batch = {k: torch.from_numpy(a) for k, a in
                 _batch(model["vocab"], rows).items()}
        pipe = tp.Pipeline(base._tcfg(**model), mesh, M, schedule, v)
        with _flash_calls() as calls:
            loss = pipe.loss_and_grads(params, batch)
        stats = dict(pipe.stats, flash=dict(calls))
        grads = [mesh.full_leaf(p.grad, *s).numpy()
                 for p, s in zip(leaves, splits)]
        return float(loss), grads, float(pipe.loss(params, batch)), stats
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)


def _ref_loss_fn(schedule):
    return {"gpipe": jp.pipeline_loss_fn,
            "1f1b": jp.pipeline_1f1b_loss_fn}.get(schedule)


SCHEDULE_CASES = [
    ("gpipe", 2, 1, {}), ("gpipe", 2, 2, {}), ("gpipe", 2, 4, {}),
    ("gpipe", 4, 4, {}),
    ("1f1b", 2, 1, {}), ("1f1b", 2, 2, {}), ("1f1b", 2, 4, {}),
    ("1f1b", 4, 2, {}), ("1f1b", 4, 4, {}),
    ("interleaved", 2, 2, {}), ("interleaved", 2, 4, {}),
    ("interleaved", 4, 4, dict(n_layers=8)),
    # the MoE aux loss's constant cotangent under each schedule
    ("gpipe", 2, 2, dict(n_experts=2)), ("1f1b", 2, 2, dict(n_experts=2)),
    ("interleaved", 2, 2, dict(n_experts=2)),
]


@pytest.mark.parametrize("schedule,P,M,kw", SCHEDULE_CASES,
                         ids=lambda x: "-".join(f"{k}{v}" for k, v in
                                                x.items())
                         if isinstance(x, dict) else str(x))
def test_schedule_loss_and_grads_match_reference(schedule, P, M, kw):
    """The schedule's loss and every leaf's gradient (the stages' layer
    leaves gathered over pp, the whole leaves summed over it) against
    ``jax.value_and_grad`` of the reference's loss function over a pp
    mesh of the virtual devices; the forward-only loss equals it too.
    Interleaved params are chunk-major on both sides. Each rank ran the
    flash forward and backward (their plain versions here, the kernels
    on the card) the schedule's count of times."""
    model = dict(MODEL, **kw)
    v = 2
    jcfg = base._jcfg(**model)
    jparams = jt.init_params(jax.random.PRNGKey(1), jcfg)
    if schedule == "interleaved":
        jparams = jp.interleave_params(jparams, P, v)
    mesh = build_mesh(JLayout(pp=P), jax.devices()[:P])
    batch = {k: jnp.asarray(a) for k, a in _batch(model["vocab"]).items()}
    if schedule == "interleaved":
        def ref(p):
            return jp.pipeline_interleaved_loss_fn(p, jcfg, batch, mesh, M, v)
    else:
        def ref(p):
            return _ref_loss_fn(schedule)(p, jcfg, batch, mesh, M)
    want_loss, want_grads = jax.jit(jax.value_and_grad(ref))(jparams)
    # a stage's K layers x M microbatches: forward in the forward units
    # (or ticks), again in 1F1B's backward units (their recompute from
    # the saved input), again in each layer's remat re-run; backward once
    k = model["n_layers"] // P
    want_flash = {"fwd": (2 if schedule == "gpipe" else 3) * k * M,
                  "bwd": k * M}
    args = (_host(jparams), model, P, M, schedule, v, TIMEOUT_S)
    got = run_ranks(lambda store: _pipe_rank(0, store, *args), _pipe_rank,
                    args, P, TIMEOUT_S)
    for loss, grads, eval_loss, stats in got:
        assert stats["flash"] == want_flash
        np.testing.assert_allclose(loss, float(want_loss), rtol=RTOL)
        np.testing.assert_allclose(eval_loss, float(want_loss), rtol=RTOL)
        for a, b in zip(grads, jax.tree.leaves(want_grads)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL,
                                       atol=ATOL)


def test_1f1b_residency_is_P_not_M():
    """The reference's ``test_1f1b_activation_residency_is_P_not_M``,
    counted in slots: at M 8 and P 2 a 1F1B rank holds at most P saved
    stage inputs at once, a GPipe rank all M; the bubble fractions are
    1F1B's (2P - 2) / (2M + 2P - 2) and GPipe's (P - 1) / (M + P - 1)."""
    P, M = 2, 8
    jparams = _host(jt.init_params(jax.random.PRNGKey(1),
                                   base._jcfg(**MODEL)))
    peaks = {}
    for schedule in ("1f1b", "gpipe"):
        args = (jparams, MODEL, P, M, schedule, 2, TIMEOUT_S, M)
        got = run_ranks(lambda store: _pipe_rank(0, store, *args),
                        _pipe_rank, args, P, TIMEOUT_S)
        peaks[schedule] = [r[3]["peak_saved"] for r in got]
        for r in got:
            assert r[3]["bubble_fraction"] == (
                (2 * P - 2) / (2 * M + 2 * P - 2) if schedule == "1f1b"
                else (P - 1) / (M + P - 1))
    assert max(peaks["1f1b"]) <= P
    assert peaks["gpipe"] == [M] * P


# -- refusals --------------------------------------------------------------

def _ref_message(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def _ref_refusal(case: str) -> str:
    """The reference's own message for ``case``."""
    cfg = base._jcfg(**MODEL)
    params = jt.init_params(jax.random.PRNGKey(0), cfg)
    batch = {k: jnp.asarray(a) for k, a in _batch(cfg.vocab).items()}
    pp2 = build_mesh(JLayout(pp=2), jax.devices()[:2])
    pp2_sp2 = build_mesh(JLayout(pp=2, sp=2), jax.devices()[:4])
    if case == "schedule":
        return _ref_message(lambda: jp.make_pipeline_train_step(
            cfg, None, pp2, schedule="zb"))
    if case == "sp":
        return _ref_message(lambda: jp.pipeline_1f1b_loss_fn(
            params, cfg, batch, pp2_sp2, 2))
    if case == "sp_interleaved":
        return _ref_message(lambda: jp.pipeline_interleaved_loss_fn(
            params, cfg, batch, pp2_sp2, 2, 2))
    if case == "layers":
        c3 = base._jcfg(**dict(MODEL, n_layers=3))
        return _ref_message(lambda: jp.pipeline_loss_fn(
            jt.init_params(jax.random.PRNGKey(0), c3), c3, batch, pp2, 2))
    if case == "batch":
        return _ref_message(lambda: jp.pipeline_loss_fn(
            params, cfg, batch, pp2, 3))
    if case == "sp_moe":
        ce = base._jcfg(**dict(MODEL, n_experts=2))
        return _ref_message(lambda: jp.pipeline_loss_fn(
            jt.init_params(jax.random.PRNGKey(0), ce), ce, batch, pp2_sp2,
            2))
    if case == "virtual":
        return _ref_message(lambda: jp.pipeline_interleaved_loss_fn(
            params, cfg, batch, pp2, 2, 4))
    assert case == "interleaved_mb"
    return _ref_message(lambda: jp.pipeline_interleaved_loss_fn(
        params, cfg, batch, pp2, 1, 2))


REFUSALS = [
    ("schedule", dict(pp=2, pipeline_schedule="zb")),
    ("sp", dict(pp=2, sp=2)),
    ("sp_interleaved", dict(pp=2, sp=2, pipeline_schedule="interleaved")),
    ("layers", dict(pp=2, n_layers=3)),
    ("batch", dict(pp=2, n_microbatches=3)),
    ("sp_moe", dict(pp=2, sp=2, pipeline_schedule="gpipe", n_experts=2)),
    ("virtual", dict(pp=2, pipeline_schedule="interleaved",
                     virtual_stages=4)),
    ("interleaved_mb", dict(pp=2, pipeline_schedule="interleaved",
                            n_microbatches=1)),
]


@pytest.mark.parametrize("case,kw", REFUSALS, ids=[c for c, _ in REFUSALS])
def test_pipeline_refusals_carry_the_reference_messages(case, kw):
    """What the reference's pipeline refuses (an unknown schedule, 1F1B
    or interleaved with sp, layers pp does not split, a batch the
    microbatches do not split, GPipe with sp and experts, layers pp x v
    does not split, microbatches pp does not split) ``train()`` refuses
    before any rank starts, with the message the reference raises."""
    cfg = ttr.TrainerConfig(**dict(base.RUN, **dict(MODEL, **kw)))
    with pytest.raises(ValueError) as err:
        ttr.train(cfg, devices=["cpu"] * 8)
    assert str(err.value) == _ref_refusal(case)


def test_microbatch_rows_split_each_microbatch_over_the_data_ranks():
    """A data rank holds its share of every microbatch's rows, as the
    reference's ``[M, mb]`` reshape of the data-sharded global batch
    lays them out; a microbatch the data ranks do not split is
    refused."""
    assert tp.microbatch_rows(8, 2, 2, 0).tolist() == [0, 1, 4, 5]
    assert tp.microbatch_rows(8, 2, 2, 1).tolist() == [2, 3, 6, 7]
    assert tp.microbatch_rows(8, 4, 1, 0).tolist() == list(range(8))
    cfg = ttr.TrainerConfig(**dict(base.RUN, pp=2, dp=2, n_microbatches=4))
    with pytest.raises(ValueError, match="microbatch of 1 rows not "
                                         "divisible by the data ranks"):
        ttr.train(cfg, devices=["cpu"] * 4)
