"""Port parity: the trainer's dp / fsdp / tp layouts of ``nos_tpu_torch``
against ``nos_tpu``'s sharded train step, on the CPU.

Every rank of a layout is a CPU process over gloo (rank 0 in this
process, the others forked from the launcher's fork server); the
reference runs GSPMD over the conftest's 8 virtual CPU devices. Both
start from the same params (the reference's ``init_params``, carried
over by ``params_from_jax`` into a step-0 checkpoint the port's trainer
resumes) and draw the same synthetic batches (the port's threefry is
the reference's). Three f32
steps: each step's loss and the params gathered at the end agree at
rtol 1e-5 / atol 1e-5, the tolerance of the reference's own dp-vs-fsdp
test (``tests/test_jax_plane.py``); the two sides differ only in the
order of their reductions. Each layout run joins its ranks under its
own limit (``RANK_TIMEOUT_S`` 120 s), so a deadlocked collective fails
its test.
"""
import functools
import logging
import os
import shutil
import sys
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.models import transformer as jt  # noqa: E402
from nos_tpu.parallel.layout import ParallelLayout as JLayout  # noqa: E402
from nos_tpu.parallel.mesh import build_mesh, data_sharding  # noqa: E402
from nos_tpu.train import optim as jo  # noqa: E402
from nos_tpu_torch.cmd import generate as tgen  # noqa: E402
from nos_tpu_torch.cmd import trainer as ttr  # noqa: E402
from nos_tpu_torch.models import transformer as tt  # noqa: E402
from nos_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from nos_tpu_torch.parallel.layout import ParallelLayout  # noqa: E402
from nos_tpu_torch.parallel.mesh import init_train_mesh  # noqa: E402
from nos_tpu_torch.train import optim as to  # noqa: E402
from nos_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402

# tests/test_trainer.py's tiny model (MHA: 4 kv heads, 2 a tp rank)
MODEL = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
             max_seq=32)
RUN = dict(MODEL, batch_size=4, seq_len=16, bf16=False, log_every=1,
           learning_rate=1e-3, warmup_steps=1, lr_schedule="cosine",
           grad_clip=1.0, weight_decay=0.1)
STEPS = 3
RTOL = ATOL = 1e-5
TIMEOUT_S = 120.0


@pytest.fixture(autouse=True)
def _rank_limit(monkeypatch):
    monkeypatch.setattr(ttr, "RANK_TIMEOUT_S", TIMEOUT_S)


def _jcfg(**kw):
    return jt.TransformerConfig(dtype=jnp.float32, **dict(MODEL, **kw))


def _tcfg(**kw):
    return tt.TransformerConfig(dtype=torch.float32, **dict(MODEL, **kw))


def _cfg(steps=STEPS, **kw):
    return ttr.TrainerConfig(**dict(RUN, steps=steps, **kw))


def _step0(directory, jparams, cfg):
    """The reference's params and a fresh optimizer state as the port's
    step-0 checkpoint, which the trainer resumes."""
    params = tt.params_from_jax(jparams, "cpu")
    opt = to.build_optimizer(tt.param_leaves(params), cfg.learning_rate,
                             cfg.steps)
    mgr = CheckpointManager(directory)
    mgr.save(0, params, opt.state_dict())
    mgr.close()


def _restored(directory, step, tcfg):
    mgr = CheckpointManager(directory)
    try:
        return mgr.restore_params(step, params_template=tt.abstract_params(
            tcfg), device="cpu")
    finally:
        mgr.close()


class _Log(logging.Handler):
    """The trainer's step losses and rank summaries (rank 0's log)."""

    def __init__(self, on_step=None):
        super().__init__(logging.INFO)
        self.losses, self.ranks, self.on_step = [], [], on_step

    def emit(self, record):
        if record.msg.startswith("step %d/%d loss"):
            self.losses.append(record.args[2])
            if self.on_step is not None:
                self.on_step(record.args[0])
        elif hasattr(record, "rank_summary"):
            self.ranks.append(record.rank_summary)


def _train(cfg, on_step=None, stop_event=None, **kw):
    """``train(cfg)`` on CPU ranks; (losses, rank summaries)."""
    log = _Log(on_step)
    tlog = logging.getLogger("nos_tpu_torch.trainer")
    level = tlog.level
    tlog.setLevel(logging.INFO)
    tlog.addHandler(log)
    try:
        ttr.train(cfg, stop_event=stop_event, device="cpu", **kw)
    finally:
        tlog.removeHandler(log)
        tlog.setLevel(level)
    return log.losses, log.ranks


def _reference(jparams, jcfg, layout, cfg, steps=STEPS):
    """The reference's jitted step over ``layout`` on the virtual
    devices, from ``jparams``, on the trainer's synthetic batches:
    (losses, params)."""
    mesh = build_mesh(layout, jax.devices()[:layout.chips])
    params = jax.device_put(jparams, jt.param_shardings(mesh, jcfg))
    tx = jo.build_optimizer(
        cfg.learning_rate, cfg.steps, warmup_steps=cfg.warmup_steps,
        schedule=cfg.lr_schedule, weight_decay=cfg.weight_decay,
        grad_clip=cfg.grad_clip)
    state = tx.init(params)
    step = jax.jit(jt.make_train_step(jcfg, tx, mesh))
    losses = []
    for s in range(steps):
        key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 1), s)
        tokens = jax.random.randint(key, (cfg.batch_size, cfg.seq_len), 0,
                                    cfg.vocab)
        batch = {k: jax.device_put(v, data_sharding(mesh)) for k, v in
                 (("tokens", tokens), ("targets", jnp.roll(tokens, -1, 1)))}
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    return losses, params


def _close(got, want):
    for a, b in zip(tt.param_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


LAYOUTS = [dict(dp=2), dict(fsdp=2), dict(tp=2), dict(dp=2, tp=2),
           dict(dp=2, n_experts=2), dict(fsdp=2, n_experts=2),
           # the named remat policies and the chunked head under fsdp x tp
           dict(fsdp=2, tp=2, remat_policy="dots"),
           dict(fsdp=2, tp=2, remat_policy="except_mlp", loss_chunk=8),
           dict(fsdp=2, tp=2, remat_policy="minimal")]


@pytest.mark.parametrize("kw", LAYOUTS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_layout_steps_match_reference(kw, tmp_path):
    """Three steps of ``train()`` under the layout against the
    reference's ``make_train_step(jcfg, tx, build_mesh(layout))``:
    losses, and the params the last step's checkpoint gathered."""
    layout = {k: v for k, v in kw.items() if k in ("dp", "fsdp", "tp")}
    model = {k: v for k, v in kw.items() if k not in layout}
    jcfg = _jcfg(**model)
    jparams = jt.init_params(jax.random.PRNGKey(1), jcfg)
    d = str(tmp_path / "ckpt")
    cfg = _cfg(checkpoint_dir=d, **kw)
    _step0(d, jparams, cfg)
    losses, ranks = _train(cfg)
    want_losses, want_params = _reference(jparams, jcfg, JLayout(**layout),
                                          cfg)
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL)
    _close(_restored(d, STEPS, _tcfg(**model)), want_params)
    n = ParallelLayout(**layout).chips
    assert [r["rank"] for r in ranks] == list(range(n))
    assert {(r["first_step"], r["last_step"]) for r in ranks} == {(0, STEPS)}


def _clip_rank(rank, store, grads, clip, layout, timeout_s):
    """One rank of the clip test: its part of each full gradient, clipped
    by the optimizer over the layout, gathered back whole."""
    import torch.distributed as dist

    mesh = init_train_mesh(layout, rank, ["cpu"] * layout.chips, store,
                           timeout_s)
    try:
        full = tt.params_from_jax(grads, "cpu")
        splits = tt.leaf_splits(full, mesh)
        parts = tt.param_leaves(tt.rank_params(full, mesh))
        opt = to.build_optimizer(
            [torch.zeros_like(p) for p in parts], 1e-3, 3, grad_clip=clip,
            shard_sums=functools.partial(mesh.shard_sums, splits=splits))
        opt._clip(parts)
        return [mesh.full_leaf(p, *s).numpy()
                for p, s in zip(parts, splits)]
    finally:
        dist.destroy_process_group()


def test_global_norm_clip_over_fsdp_and_tp_matches_one_device():
    """The clip's global norm over fsdp 2 x tp 2 (split leaves summed over
    their parts, replicated ones once) clips every gradient as the
    one-device clip does."""
    rng = np.random.default_rng(0)
    shapes = tt.abstract_params(_tcfg())
    grads = {k: ({n: rng.standard_normal(t.shape).astype(np.float32)
                  for n, t in v.items()} if k == "layers"
                 else rng.standard_normal(v.shape).astype(np.float32))
             for k, v in shapes.items()}
    clip = 1.0
    want = tt.param_leaves(tt.params_from_jax(grads, "cpu"))
    norm = float(torch.sqrt(sum((g * g).sum() for g in want)))
    assert norm > 10 * clip
    to.build_optimizer([torch.zeros_like(g) for g in want], 1e-3, 3,
                       grad_clip=clip)._clip(want)
    layout = ParallelLayout(fsdp=2, tp=2)
    ranks = run_ranks(
        lambda store: _clip_rank(0, store, grads, clip, layout, TIMEOUT_S),
        _clip_rank, (grads, clip, layout, TIMEOUT_S), layout.chips,
        TIMEOUT_S)
    for got in ranks:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b.numpy(), rtol=1e-6, atol=1e-7)


def _copy_step(src, dst, step):
    """A checkpoint directory holding ``src``'s step alone."""
    os.makedirs(dst)
    shutil.copytree(os.path.join(src, str(step)), os.path.join(dst,
                                                                str(step)))
    shutil.copy(os.path.join(src, "model_config.json"), dst)


def test_checkpoint_crosses_layouts(tmp_path):
    """``train()`` at dp 2 x tp 2 checkpoints steps 2 and 4 (full leaves,
    the one-device format); step 2 resumed under fsdp 2 and on one
    device reaches step 4's losses and params within the f32 tolerance,
    and ``cmd/generate.py::load_params`` serves step 4 (the counterpart
    of ``tests/test_checkpoint.py``'s dp2 x tp2 -> fsdp4 restore)."""
    a = str(tmp_path / "a")
    losses, _ = _train(_cfg(steps=4, checkpoint_dir=a, checkpoint_every=2,
                            dp=2, tp=2))
    assert CheckpointManager(a).all_steps() == [2, 4]
    want = _restored(a, 4, _tcfg())
    for label, kw in (("fsdp", dict(fsdp=2)), ("one", {})):
        d = str(tmp_path / label)
        _copy_step(a, d, 2)
        resumed, _ = _train(_cfg(steps=4, checkpoint_dir=d, **kw))
        np.testing.assert_allclose(resumed, losses[2:], rtol=RTOL)
        got = _restored(d, 4, _tcfg())
        for x, y in zip(tt.param_leaves(got), tt.param_leaves(want)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL,
                                       atol=ATOL)
    _, served = tgen.load_params(tgen.GenerateConfig(
        **MODEL, bf16=False, checkpoint_dir=a), device="cpu")
    for x, y in zip(tt.param_leaves(served), tt.param_leaves(want)):
        assert torch.equal(x, y)


def test_stop_event_banks_one_step_on_every_rank(tmp_path):
    """A stop event set after step 2's log at dp 2: at the next sync
    (``host_sync_every`` 1) every rank stops at the same step, which is
    checkpointed, and ``train()`` returns cleanly: this process is left
    with no process group and its own exception hook."""
    d = str(tmp_path / "ckpt")
    stop = threading.Event()
    hook = sys.excepthook
    losses, ranks = _train(
        _cfg(steps=8, dp=2, host_sync_every=1, checkpoint_dir=d),
        on_step=lambda s: s == 2 and stop.set(), stop_event=stop)
    assert [r["last_step"] for r in ranks] == [3, 3]
    assert CheckpointManager(d).all_steps() == [3]
    assert len(losses) == 2
    assert not torch.distributed.is_initialized()
    assert sys.excepthook is hook


@pytest.mark.parametrize("kw,match", [
    # pp trains since the pipeline's port; what stays refused of it is
    # what the reference refuses, with its message: 1F1B under sp
    pytest.param(dict(pp=2, sp=2), "1F1B does not compose with sp",
                 id="kw0-pp"),
    (dict(sp=2, seq_len=15), "sp"), (dict(ep=2), "ep"),
    (dict(n_experts=3, ep=2), "n_experts"),
    (dict(dp=4), "layout needs 4 chips, only 2 devices"),
    (dict(dp=2, handle_sigterm=False), "requires handle_sigterm"),
    (dict(dp=2, batch_size=3), "batch_size 3 not divisible"),
    (dict(tp=2, sp=2, sp_strategy="ulysses", n_kv_heads=2),
     r"ulysses needs head counts divisible by the axis size \(2 q heads, "
     r"1 kv heads, axis 2\)"),
])
def test_refusals_name_the_knob(kw, match):
    """What the layouts do not run is refused before any rank starts,
    naming the knob: the 1F1B pipeline under sp (the reference's
    message), a sequence sp does not split (the reference's message),
    ep without experts, experts ep does not split, fewer
    devices than the layout's chips (the reference's message), a stop
    event without handle_sigterm (the reference's multi-host rule), a
    batch the data ranks do not split, and under Ulysses a tp rank's kv
    heads sp does not split (the reference's message)."""
    with pytest.raises(ValueError, match=match):
        ttr.train(_cfg(**kw), stop_event=threading.Event(),
                  devices=["cpu", "cpu"])


def test_multi_host_refused(monkeypatch):
    """A multi-host environment trains (tests/test_torch_multihost.py);
    a host index outside the gang is refused by name before any rank
    starts."""
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "2")
    with pytest.raises(ValueError, match="PROCESS_ID"):
        ttr.train(_cfg(dp=2), device="cpu")
