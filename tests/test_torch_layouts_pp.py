"""Port parity: the trainer's pp layouts of ``nos_tpu_torch`` (GPipe,
1F1B and interleaved 1F1B, alone and composed with dp, tp, fsdp, sp and
ep) against ``nos_tpu``'s ``make_pipeline_train_step``, on the CPU.

As ``tests/test_torch_layouts.py`` (whose tiny f32 model, run, helpers
and tolerances this file shares, at 2 layers so pp 2 leaves each stage
one; the interleaved layouts at 4): every rank a CPU process over
gloo, the reference's jitted pipelined step on the conftest's virtual
CPU devices, both from the reference's params (chunk-major under the
interleaved schedule, on both sides) and the same synthetic batches,
three steps' losses and the gathered params at rtol 1e-5 / atol 1e-5.
Then the global-norm clip under pp, and the checkpoints: full leaves
that cross from pp 2 to dp 2 and one device, and back bit for bit; an
interleaved run's stamp, its resume in kind, and the refusal, naming
``layer_order``, of a resume under another schedule.
"""
import json
import logging
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

import test_torch_layouts as base  # noqa: E402
from nos_tpu.models import transformer as jt  # noqa: E402
from nos_tpu.parallel import pipeline as jp  # noqa: E402
from nos_tpu.parallel.layout import ParallelLayout as JLayout  # noqa: E402
from nos_tpu.parallel.mesh import build_mesh, data_sharding  # noqa: E402
from nos_tpu.train import optim as jo  # noqa: E402
from nos_tpu_torch.cmd import trainer as ttr  # noqa: E402
from nos_tpu_torch.models import transformer as tt  # noqa: E402
from nos_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from nos_tpu_torch.parallel.layout import ParallelLayout  # noqa: E402
from nos_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from nos_tpu_torch.train.data import write_token_shards  # noqa: E402

RTOL, ATOL, STEPS, TIMEOUT_S = base.RTOL, base.ATOL, base.STEPS, \
    base.TIMEOUT_S
AXES = ("dp", "fsdp", "tp", "pp", "sp", "ep")
PIPE = ("n_microbatches", "pipeline_schedule", "virtual_stages")


@pytest.fixture(autouse=True)
def _rank_limit(monkeypatch):
    monkeypatch.setattr(ttr, "RANK_TIMEOUT_S", TIMEOUT_S)


def _reference(jparams, jcfg, layout, cfg, steps=STEPS):
    """The reference's jitted pipelined step over ``layout`` on the
    virtual devices, from ``jparams``, on the trainer's synthetic
    batches: (losses, params)."""
    mesh = build_mesh(layout, jax.devices()[:layout.chips])
    params = jax.device_put(jparams, jp.pipeline_param_shardings(mesh,
                                                                 jcfg))
    tx = jo.build_optimizer(
        cfg.learning_rate, cfg.steps, warmup_steps=cfg.warmup_steps,
        schedule=cfg.lr_schedule, weight_decay=cfg.weight_decay,
        grad_clip=cfg.grad_clip)
    state = tx.init(params)
    step = jax.jit(jp.make_pipeline_train_step(
        jcfg, tx, mesh, n_microbatches=cfg.n_microbatches,
        schedule=cfg.pipeline_schedule, virtual_stages=cfg.virtual_stages))
    losses = []
    for s in range(steps):
        key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 1), s)
        tokens = jax.random.randint(key, (cfg.batch_size, cfg.seq_len), 0,
                                    cfg.vocab)
        batch = {k: jax.device_put(v, data_sharding(mesh)) for k, v in
                 (("tokens", tokens), ("targets", jax.numpy.roll(tokens, -1,
                                                                 1)))}
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    return losses, params


def _jparams(jcfg, cfg):
    """The reference's params, chunk-major under the interleaved
    schedule (the order its trainer and checkpoints keep)."""
    jparams = jt.init_params(jax.random.PRNGKey(1), jcfg)
    if cfg.pp > 1 and cfg.pipeline_schedule == "interleaved":
        jparams = jp.interleave_params(jparams, cfg.pp, cfg.virtual_stages)
    return jparams


LAYOUTS = [dict(pp=2, pipeline_schedule="gpipe"), dict(pp=2),
           dict(pp=2, pipeline_schedule="interleaved", n_layers=4),
           # the reference's test_trains_pipelined
           dict(pp=2, dp=2),
           dict(pp=2, tp=2, pipeline_schedule="interleaved", n_layers=4),
           dict(pp=2, fsdp=2),
           # the reference's test_trains_gpipe_with_sp, without its dp
           dict(pp=2, sp=2, pipeline_schedule="gpipe"),
           # the reference's MoE x pp case (one microbatch: its aux loss
           # the plain forward's), and four microbatches
           dict(pp=2, ep=2, n_experts=2, n_microbatches=1),
           dict(pp=2, ep=2, n_experts=2, n_microbatches=4)]


@pytest.mark.parametrize("kw", LAYOUTS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_pp_layout_steps_match_reference(kw, tmp_path):
    """Three steps of ``train()`` under the layout against the
    reference's ``make_pipeline_train_step`` over ``build_mesh(layout)``:
    losses, and the params the last step's checkpoint gathered."""
    layout = {k: v for k, v in kw.items() if k in AXES}
    model = {k: v for k, v in kw.items() if k not in AXES + PIPE}
    jcfg = base._jcfg(**model)
    d = str(tmp_path / "ckpt")
    cfg = base._cfg(checkpoint_dir=d, **kw)
    jparams = _jparams(jcfg, cfg)
    base._step0(d, jparams, cfg)
    losses, ranks = base._train(cfg)
    want_losses, want_params = _reference(jparams, jcfg, JLayout(**layout),
                                          cfg)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL)
    base._close(base._restored(d, STEPS, base._tcfg(**model)), want_params)
    n = ParallelLayout(**layout).chips
    assert [r["rank"] for r in ranks] == list(range(n))
    inner = layout.get("sp", 1) * layout.get("ep", 1)
    assert [r["pp_index"] for r in ranks] == [
        r // inner % layout["pp"] for r in range(n)]
    assert {(r["first_step"], r["last_step"]) for r in ranks} == {(0, STEPS)}
    assert {r["pipeline"]["schedule"] for r in ranks} == {
        cfg.pipeline_schedule}


def test_global_norm_clip_over_pp_and_tp_matches_one_device():
    """The clip's global norm over pp 2 x tp 2 (a layer leaf summed over
    the stages' layers and its tp parts, the embeddings and final norm,
    whole on every stage, counted once) clips every gradient as the
    one-device clip does: each stage clipping by its own layers' norm
    would not."""
    rng = np.random.default_rng(2)
    shapes = tt.abstract_params(base._tcfg())
    grads = {k: ({n: rng.standard_normal(t.shape).astype(np.float32)
                  for n, t in v.items()} if k == "layers"
                 else rng.standard_normal(v.shape).astype(np.float32))
             for k, v in shapes.items()}
    clip = 1.0
    want = tt.param_leaves(tt.params_from_jax(grads, "cpu"))
    base.to.build_optimizer([torch.zeros_like(g) for g in want], 1e-3, 3,
                            grad_clip=clip)._clip(want)
    layout = ParallelLayout(pp=2, tp=2)
    ranks = run_ranks(
        lambda store: base._clip_rank(0, store, grads, clip, layout,
                                      TIMEOUT_S),
        base._clip_rank, (grads, clip, layout, TIMEOUT_S), layout.chips,
        TIMEOUT_S)
    for got in ranks:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-6, atol=1e-7)


def _close_or_equal(got, want, exact: bool):
    for x, y in zip(tt.param_leaves(got), tt.param_leaves(want)):
        if exact:
            assert torch.equal(x, y)
        else:
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL,
                                       atol=ATOL)


def test_pp_checkpoint_crosses_layouts(tmp_path):
    """``train()`` at pp 2 (1F1B) checkpoints steps 2 and 4 (full leaves,
    the one-device format); step 2 resumed under dp 2 and on one device
    reaches step 4's losses and params within the f32 tolerance, and
    under pp 2 bit for bit."""
    a = str(tmp_path / "a")
    losses, _ = base._train(base._cfg(steps=4, checkpoint_dir=a,
                                      checkpoint_every=2, pp=2))
    assert CheckpointManager(a).all_steps() == [2, 4]
    want = base._restored(a, 4, base._tcfg())
    for label, kw, exact in (("dp", dict(dp=2), False), ("one", {}, False),
                             ("pp", dict(pp=2), True)):
        d = str(tmp_path / label)
        base._copy_step(a, d, 2)
        resumed, _ = base._train(base._cfg(steps=4, checkpoint_dir=d, **kw))
        if exact:
            assert resumed == losses[2:]
        else:
            np.testing.assert_allclose(resumed, losses[2:], rtol=RTOL)
        _close_or_equal(base._restored(d, 4, base._tcfg()), want, exact)


def test_interleaved_stamps_resumes_in_kind_and_refuses_a_drift(tmp_path):
    """The reference's ``test_trains_interleaved_and_resumes``: an
    interleaved run stamps ``layer_order`` "interleaved:pp=2,v=2" and
    checkpoints its chunk-major params; step 2 resumed under the same
    schedule reaches step 4 bit for bit; a resume under 1F1B is refused
    by name, not run on permuted layers."""
    run = dict(pp=2, n_layers=4, pipeline_schedule="interleaved",
               virtual_stages=2)
    a = str(tmp_path / "a")
    losses, _ = base._train(base._cfg(steps=4, checkpoint_dir=a,
                                      checkpoint_every=2, **run))
    with open(os.path.join(a, "model_config.json")) as f:
        assert json.load(f)["layer_order"] == "interleaved:pp=2,v=2"
    d = str(tmp_path / "b")
    base._copy_step(a, d, 2)
    resumed, _ = base._train(base._cfg(steps=4, checkpoint_dir=d, **run))
    assert resumed == losses[2:]
    tcfg = base._tcfg(n_layers=4)
    _close_or_equal(base._restored(d, 4, tcfg), base._restored(a, 4, tcfg),
                    True)
    with pytest.raises(ValueError, match="layer_order"):
        base._train(base._cfg(steps=6, checkpoint_dir=d, pp=2, n_layers=4))


class _EvalLog(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.losses = []

    def emit(self, record):
        if record.msg.startswith("step %d eval loss"):
            self.losses.append(record.args[1])


def _eval_losses(cfg) -> list:
    log = _EvalLog()
    tlog = logging.getLogger("nos_tpu_torch.trainer")
    level = tlog.level
    tlog.setLevel(logging.INFO)
    tlog.addHandler(log)
    try:
        ttr.train(cfg, device="cpu")
    finally:
        tlog.removeHandler(log)
        tlog.setLevel(level)
    return log.losses


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_pp_eval_runs_the_schedules_forward(schedule, tmp_path):
    """With ``eval_every`` a pp 2 run's held-out loss, taken by the
    schedule's forward only (GPipe's forward, 1F1B's fill-drain, the
    interleaved ``fwd_only`` tables, as the reference's trainer does),
    equals one device's on the same params and eval batches."""
    d = str(tmp_path / "data")
    write_token_shards(d, [np.random.default_rng(4).integers(
        0, base.MODEL["vocab"], 4096).astype(np.uint32)])
    run = dict(n_layers=4, steps=2, eval_every=2, eval_steps=2,
               data_path=f"{d}/*.bin", eval_data_path=f"{d}/*.bin")
    one = _eval_losses(base._cfg(**run))
    got = _eval_losses(base._cfg(pp=2, pipeline_schedule=schedule, **run))
    assert len(one) == 1
    np.testing.assert_allclose(got, one, rtol=RTOL)
