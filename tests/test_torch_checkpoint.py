"""The port's checkpoint layer (``nos_tpu_torch/train/checkpoint.py``) and
the trainer's checkpointing, on the CPU.

The reference's cases, ported as the port's own: every case of
tests/test_checkpoint.py (across meshes becomes across a fresh set of
params: the port has no mesh) and the checkpoint cases of
tests/test_trainer.py. Not ported, because they need what the port does
not run yet: the interleaved pipeline schedule (the reference's
``test_interleave_rejects_indivisible_layers`` and
``test_trains_interleaved_and_resumes``) and the profiler
(``test_profiler_fires_on_resume_past_start``).

Then the port's own: an asynchronous save followed at once by in-place
steps restores the saved step's values; the reference's ``latest_step``
reads the port's directory to the same step; and a reference trainer's
orbax checkpoint, converted here (orbax restore, ``params_from_jax``
and the optimizer-state mapping: a test helper, never part of the port),
resumes in the port for two steps within the dense parity tolerances of
the reference's own resume, and serves the reference's greedy tokens
through the port's generate binary and ``build_engine``, dense and MoE,
with the draft from ``draft_checkpoint_dir`` too.
"""
import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu_torch.cmd import trainer as ttr  # noqa: E402
from nos_tpu_torch.models import transformer as tt  # noqa: E402
from nos_tpu_torch.train import checkpoint as tck  # noqa: E402
from nos_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from nos_tpu_torch.train.optim import build_optimizer  # noqa: E402

# orbax restores in this process (the converter): run cache-less, as the
# reference's own trainer tests do
pytestmark = pytest.mark.usefixtures("_no_xla_compilation_cache")

# the dense trainer parity's tolerances (tests/test_torch_trainer.py)
LOSS_RTOL, PARAM_TOL = 1e-5, 2e-5


def cfg():
    return tt.TransformerConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                                d_ff=64, max_seq=16, dtype=torch.float32)


def setup(c, seed=0, accum_steps=1):
    """Seeded params as leaves, the optimizer over them, the step and a
    fixed batch."""
    params = tt.init_params(c, torch.Generator().manual_seed(seed), "cpu")
    leaves = tt.param_leaves(params)
    for p in leaves:
        p.requires_grad_()
    opt = build_optimizer(leaves, 1e-3, 10, accum_steps=accum_steps)
    step = tt.make_train_step(c, opt)
    tokens = torch.randint(0, c.vocab, (4, 16),
                           generator=torch.Generator().manual_seed(1))
    return params, opt, step, {"tokens": tokens, "targets": tokens}


def tiny(**kw):
    base = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                max_seq=32, steps=4, batch_size=4, seq_len=16,
                bf16=False, log_every=2)
    base.update(kw)
    return ttr.TrainerConfig(**base)


def train(c, stop_event=None):
    return ttr.train(c, stop_event=stop_event, device="cpu")


def _equal_trees(a, b):
    la, lb = tck._flatten(a, "", []), tck._flatten(b, "", [])
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), name
        else:
            assert x == y, name


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py, ported
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    """Save, restore into a fresh set of params and moments (another
    seed), and training continues bit-identical."""
    c = cfg()
    params, opt, step, batch = setup(c)
    step(params, batch)

    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, params, opt.state_dict())
    assert mgr.latest() == 1

    params2, opt2, step2, batch2 = setup(c, seed=7)
    r_params, r_opt = mgr.restore(params_template=params2,
                                  opt_state_template=opt2.state_dict())
    opt2.load_state_dict(r_opt)
    mgr.close()
    assert r_params is not params and opt2.count == opt.count == 1
    _equal_trees(params, r_params)
    _equal_trees(opt.state_dict(), opt2.state_dict())

    loss_ref = step(params, batch)
    loss_res = step2(r_params, batch2)
    assert torch.equal(loss_res, loss_ref)
    _equal_trees(params, r_params)


def test_latest_and_retention(tmp_path):
    c = cfg()
    params, opt, _, _ = setup(c)
    assert tck.latest_step(str(tmp_path / "ckpt")) is None
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for s in (1, 2, 3):
        mgr.save(s, params, opt.state_dict())
    assert mgr.latest() == 3
    assert mgr.all_steps() == [2, 3]        # retention pruned 1
    assert tck.latest_step(str(tmp_path / "ckpt")) == 3
    assert tck.latest_step(str(tmp_path / "never-written")) is None
    mgr.close()


def test_wait_within_bounds_an_async_save(tmp_path):
    c = cfg()
    params, opt, _, _ = setup(c)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, params, opt.state_dict(), wait=False)
    assert mgr.wait_within(30.0) is True
    assert mgr.latest() == 1
    # idle manager: an immediate re-fence returns at once
    assert mgr.wait_within(0.1) is True
    mgr.close()


def test_relative_directory_saves(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    c = cfg()
    params, opt, _, _ = setup(c)
    mgr = CheckpointManager("ckpt")
    assert mgr.directory == str(tmp_path / "ckpt")
    mgr.save(1, params, opt.state_dict())
    mgr.close()
    assert CheckpointManager(str(tmp_path / "ckpt")).latest() == 1


def test_restore_empty_dir_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError, match="no checkpoint under"):
        mgr.restore(params_template={}, opt_state_template={})
    mgr.close()


def test_async_save_completes_by_close(tmp_path):
    c = tt.TransformerConfig(vocab=32, d_model=16, n_layers=1, n_heads=2,
                             d_ff=32, max_seq=16, dtype=torch.float32)
    params, opt, _, _ = setup(c)
    m = CheckpointManager(str(tmp_path))
    m.save(3, params, opt.state_dict(), wait=False)
    m.close()

    m2 = CheckpointManager(str(tmp_path))
    assert m2.latest() == 3
    restored = m2.restore_params(params_template=tt.abstract_params(c),
                                 device="cpu")
    assert torch.equal(restored["embed"], params["embed"].detach())
    m2.close()


def test_pre_layer_order_stamp_defaults_to_canonical(tmp_path):
    d = str(tmp_path / "ckpt")
    os.makedirs(d)
    with open(os.path.join(d, "model_config.json"), "w") as f:
        json.dump({"vocab": 64, "d_model": 32, "n_layers": 4,
                   "n_heads": 4, "n_kv_heads": 4, "d_ff": 64,
                   "n_experts": 0}, f)   # pre-layer_order era stamp
    ck = CheckpointManager(d)
    expect = {"vocab": 64, "d_model": 32, "n_layers": 4, "n_heads": 4,
              "n_kv_heads": 4, "d_ff": 64, "n_experts": 0,
              "layer_order": "interleaved:pp=2,v=2"}
    with pytest.raises(ValueError, match="layer_order"):
        ck.validate_model_config(expect)
    ck.validate_model_config({**expect, "layer_order": "canonical"})


def test_model_arch_dict_is_the_reference_stamp():
    from nos_tpu.cmd import trainer as jtr
    from nos_tpu.train import checkpoint as jck

    for kw in (dict(), dict(n_kv_heads=2, n_experts=4),
               dict(pp=2, pipeline_schedule="interleaved", virtual_stages=3)):
        assert (tck.model_arch_dict(ttr.TrainerConfig(**kw))
                == jck.model_arch_dict(jtr.TrainerConfig(**kw)))


# ---------------------------------------------------------------------------
# the checkpoint cases of tests/test_trainer.py, ported
# ---------------------------------------------------------------------------

def test_checkpoint_resume_continues_from_latest(tmp_path, caplog):
    d = str(tmp_path / "ckpt")
    c = tiny(steps=4, checkpoint_dir=d, checkpoint_every=2)
    train(c)
    with caplog.at_level(logging.INFO, logger="nos_tpu_torch.trainer"):
        train(c)
    assert any("resumed from checkpoint step 4" in r.getMessage()
               for r in caplog.records)


def test_lowered_steps_does_not_relabel_checkpoints(tmp_path):
    d = str(tmp_path / "ckpt")
    train(tiny(steps=4, checkpoint_dir=d, checkpoint_every=2))
    train(tiny(steps=2, checkpoint_dir=d, checkpoint_every=2))
    mgr = CheckpointManager(d)
    assert mgr.latest() == 4
    assert mgr.all_steps() == [2, 4]
    mgr.close()


def test_dataset_resume_reproduces_uninterrupted_run(tmp_path):
    """Checkpoint at step 2, resume to step 4: the loss of an
    uninterrupted 4-step run, bit for bit (the resumed process feeds the
    same dataset batches for steps 2-3)."""
    from nos_tpu_torch.train.data import write_token_shards

    rng = np.random.default_rng(1)
    write_token_shards(str(tmp_path / "data"),
                       [rng.integers(0, 64, size=2000, dtype=np.uint32)])
    data = str(tmp_path / "data" / "shard_*.bin")
    ck = str(tmp_path / "ckpt")
    straight = train(tiny(data_path=data, steps=4))
    train(tiny(data_path=data, steps=2, checkpoint_dir=ck,
               checkpoint_every=2))
    resumed = train(tiny(data_path=data, steps=4, checkpoint_dir=ck,
                         checkpoint_every=2))
    assert resumed == straight


def test_stop_event_checkpoints_and_resumes(tmp_path):
    """A pre-set stop event banks the first step, labels it truthfully,
    and a restart finishes the run with the exact stream an
    uninterrupted run would have seen."""
    c = tiny(steps=6, checkpoint_dir=str(tmp_path), checkpoint_every=100)
    ev = threading.Event()
    ev.set()
    train(c, stop_event=ev)
    banked = CheckpointManager(str(tmp_path)).latest()
    straight = train(tiny(steps=6))
    resumed = train(c)
    final = CheckpointManager(str(tmp_path)).latest()
    assert banked == 1
    assert final == 6
    assert resumed == straight


def test_sigterm_checkpoints_midrun(tmp_path):
    """SIGTERM delivered mid-train (from a timer thread, handled in the
    main thread) stops the loop at whatever step it reached and
    checkpoints it."""
    before = signal.getsignal(signal.SIGTERM)
    c = tiny(steps=100000, checkpoint_dir=str(tmp_path),
             checkpoint_every=10**6, log_every=10**6)
    t = threading.Timer(2.0, lambda: os.kill(os.getpid(), signal.SIGTERM))
    t.start()
    try:
        train(c)
    finally:
        t.cancel()
    latest = CheckpointManager(str(tmp_path)).latest()
    assert latest is not None and 1 <= latest < 100000
    assert signal.getsignal(signal.SIGTERM) == before


def test_checkpoint_config_stamp_guards_drift(tmp_path):
    """A checkpoint carries its architecture; resuming or serving with
    different dims fails by FIELD NAME, not a shape error."""
    from nos_tpu_torch.cmd.generate import GenerateConfig, load_params

    train(tiny(steps=2, checkpoint_dir=str(tmp_path), checkpoint_every=1))
    stamp = json.load(open(os.path.join(tmp_path, "model_config.json")))
    assert stamp["d_model"] == 32 and stamp["n_layers"] == 2

    with pytest.raises(ValueError, match="d_ff: checkpoint has 64"):
        train(tiny(steps=4, d_ff=128, checkpoint_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="d_model"):
        load_params(GenerateConfig(
            vocab=64, d_model=48, n_layers=2, n_heads=4, d_ff=64,
            max_seq=32, bf16=False, checkpoint_dir=str(tmp_path)),
            device="cpu")
    # matching dims restore, with a LONGER max_seq (not a param shape)
    # and explicit n_kv_heads == n_heads (normalized against 0)
    _, params = load_params(GenerateConfig(
        vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
        d_ff=64, max_seq=128, bf16=False, checkpoint_dir=str(tmp_path)),
        device="cpu")
    assert params["layers"]["wq"].shape == (2, 32, 32)


def test_stale_stamp_without_checkpoints_is_replaced(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.write_model_config({"d_model": 999})
    m.close()
    train(tiny(steps=2, checkpoint_dir=str(tmp_path), checkpoint_every=2))
    stamp = json.load(open(os.path.join(tmp_path, "model_config.json")))
    assert stamp["d_model"] == 32


def test_metrics_exported(tmp_path):
    """nos_tpu_train_* series move with the run in the port's registry:
    steps/tokens count, the loss gauge lands, checkpoint saves and
    preemption exits counted."""
    from nos_tpu_torch.utils.metrics import default_registry

    reg = default_registry()
    steps0 = reg.counter("nos_tpu_train_steps_total", "x").value()
    saves0 = reg.counter("nos_tpu_train_checkpoint_saves_total", "x").value()
    pre0 = reg.counter("nos_tpu_train_preemptions_total", "x").value()

    train(tiny(steps=4, checkpoint_dir=str(tmp_path / "a"),
               checkpoint_every=2))
    assert reg.counter("nos_tpu_train_steps_total", "x").value() \
        == steps0 + 4
    assert reg.counter("nos_tpu_train_tokens_total", "x").value() > 0
    # saves at steps 2 and 4 (periodic covers the final step)
    assert reg.counter("nos_tpu_train_checkpoint_saves_total",
                       "x").value() == saves0 + 2
    exposed = reg.expose()
    assert "nos_tpu_train_loss" in exposed
    assert "nos_tpu_train_step_seconds" in exposed

    ev = threading.Event()
    ev.set()
    train(tiny(steps=4, checkpoint_dir=str(tmp_path / "b")), stop_event=ev)
    assert reg.counter("nos_tpu_train_preemptions_total", "x").value() \
        == pre0 + 1


def test_prestamp_checkpoints_never_get_caller_stamp(tmp_path):
    train(tiny(steps=2, checkpoint_dir=str(tmp_path), checkpoint_every=2))
    os.remove(os.path.join(tmp_path, "model_config.json"))  # pre-stamp era
    # drifted relaunch: the restore fails on shapes, naming the leaves,
    # and must not stamp
    with pytest.raises(ValueError, match="w_gate: checkpoint has"):
        train(tiny(steps=4, d_ff=128, checkpoint_dir=str(tmp_path)))
    assert not os.path.exists(os.path.join(tmp_path, "model_config.json"))


def test_wall_clock_checkpoint_cadence(tmp_path):
    d = str(tmp_path / "timed")
    train(tiny(steps=4, checkpoint_dir=d, checkpoint_every=10**6,
               checkpoint_every_s=1e-9))
    mgr = CheckpointManager(d)
    assert mgr.latest() == 4
    assert len(mgr.all_steps()) >= 2
    mgr.close()

    d2 = str(tmp_path / "stepcad")
    train(tiny(steps=4, checkpoint_dir=d2, checkpoint_every=10**6))
    mgr2 = CheckpointManager(d2)
    assert mgr2.all_steps() == [4]          # only the final save
    mgr2.close()


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------

def test_async_save_then_in_place_steps_restores_the_saved_step(
        tmp_path, monkeypatch):
    """``save(wait=False)`` and at once three in-place steps (the
    optimizer fenced on the save's event), with the writer held back
    until the steps are done: the checkpoint holds the saved step's
    values, not the later ones, and resuming from it replays the three
    steps bit for bit."""
    c = cfg()
    params, opt, step, batch = setup(c)
    step(params, batch)
    want_p = {n: t.detach().clone() for n, t in tck._flatten(params, "", [])}
    want_o = [t.clone() for t in opt.mu + opt.nu]

    gate = threading.Event()
    real_fsync = os.fsync

    def held_fsync(fd):
        gate.wait(60)
        real_fsync(fd)

    monkeypatch.setattr(tck.os, "fsync", held_fsync)
    mgr = CheckpointManager(str(tmp_path))
    opt.fence(mgr.save(1, params, opt.state_dict(), wait=False))
    losses = [step(params, batch) for _ in range(3)]
    assert not mgr.wait_within(0.05)         # still writing
    gate.set()
    mgr.wait_until_finished()
    monkeypatch.undo()

    params2, opt2, step2, _ = setup(c, seed=3)
    r_params, r_opt = mgr.restore(params_template=params2,
                                  opt_state_template=opt2.state_dict())
    opt2.load_state_dict(r_opt)
    mgr.close()
    for name, t in tck._flatten(r_params, "", []):
        assert torch.equal(t, want_p[name]), name
    assert all(torch.equal(a, b) for a, b in zip(opt2.mu + opt2.nu, want_o))
    assert opt2.count == 1
    assert [step2(r_params, batch) for _ in range(3)] == losses


def test_accumulation_state_resumes_mid_window(tmp_path):
    """With gradient accumulation the running mean and the micro-step
    travel too: saved mid-window, the resumed steps equal the
    uninterrupted ones bit for bit."""
    c = cfg()
    params, opt, step, batch = setup(c, accum_steps=2)
    step(params, batch)
    step(params, batch)
    step(params, batch)                     # mid-window: mini_step 1
    assert opt.mini_step == 1
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, params, opt.state_dict())
    params2, opt2, step2, _ = setup(c, seed=9, accum_steps=2)
    _, r_opt = mgr.restore(params_template=params2,
                           opt_state_template=opt2.state_dict())
    opt2.load_state_dict(r_opt)
    mgr.close()
    assert (opt2.mini_step, opt2.count) == (1, 1)
    for _ in range(3):
        assert torch.equal(step(params, batch), step2(params2, batch))
    _equal_trees(params, params2)


def test_bf16_leaves_are_stored_as_their_bits(tmp_path):
    c = tt.TransformerConfig(vocab=32, d_model=16, n_layers=1, n_heads=2,
                             d_ff=32, max_seq=16)
    params = tt.init_params(c, torch.Generator().manual_seed(0), "cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, params, {"count": 0})
    index = json.load(open(tmp_path / "1" / "index.json"))
    entry = next(e for e in index["leaves"] if e["name"] == "params/embed")
    assert entry["dtype"] == "bfloat16" and entry["shape"] == [32, 16]
    raw = np.fromfile(tmp_path / "1" / entry["file"], dtype=np.uint16)
    np.testing.assert_array_equal(
        raw, params["embed"].view(torch.int16).numpy().view(np.uint16)
        .reshape(-1))
    got = mgr.restore_params(params_template=tt.abstract_params(c),
                             device="cpu")
    mgr.close()
    _equal_trees(params, got)


def test_crash_mid_save_leaves_the_previous_step(tmp_path, monkeypatch):
    """A save that dies before its rename leaves only a partial
    directory, which neither the manager nor the reference's witness
    counts, and which the next manager on the directory removes."""
    from nos_tpu.train.checkpoint import latest_step as ref_latest_step

    c = cfg()
    params, opt, _, _ = setup(c)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, params, opt.state_dict())

    def boom(*_):
        raise OSError("disk lost")

    monkeypatch.setattr(tck.os, "rename", boom)
    with pytest.raises(OSError, match="disk lost"):
        mgr.save(2, params, opt.state_dict())
    monkeypatch.undo()
    assert any(tck._PARTIAL in n for n in os.listdir(tmp_path))
    assert mgr.latest() == 1 == ref_latest_step(str(tmp_path))
    mgr.close()
    assert CheckpointManager(str(tmp_path)).latest() == 1
    assert not any(tck._PARTIAL in n for n in os.listdir(tmp_path))


def test_restore_names_every_mismatched_leaf(tmp_path):
    c = cfg()
    params, opt, _, _ = setup(c)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, params, opt.state_dict())
    wide = tt.abstract_params(tt.TransformerConfig(
        vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=96, max_seq=16,
        dtype=torch.float32))
    with pytest.raises(ValueError) as err:
        mgr.restore_params(params_template=wide, device="cpu")
    for name in ("w_gate", "w_up", "w_down"):
        assert f"params/layers/{name}: checkpoint has" in str(err.value)
    with pytest.raises(ValueError, match="holds no leaf params/extra"):
        mgr.restore_params(params_template={
            **tt.abstract_params(c), "extra": torch.empty(2, device="meta")})
    mgr.close()


@pytest.mark.parametrize("where", ["manager", "latest_step", "trainer"])
def test_object_storage_directory_is_refused_naming_it(where):
    uri = "gs://bucket/run-1"
    with pytest.raises(ValueError, match="gs://bucket/run-1"):
        if where == "manager":
            CheckpointManager(uri)
        elif where == "latest_step":
            tck.latest_step(uri)
        else:
            train(tiny(steps=1, checkpoint_dir=uri))


def test_reference_latest_step_reads_the_port_directory(tmp_path):
    """The reference's witness (``nos_tpu.train.checkpoint.latest_step``,
    orbax's step listing) reads the port's directory to the same step,
    retention included."""
    from nos_tpu.train.checkpoint import latest_step as ref_latest_step

    d = str(tmp_path / "ckpt")
    assert ref_latest_step(d) is None
    c = cfg()
    params, opt, step, batch = setup(c)
    mgr = CheckpointManager(d, max_to_keep=2)
    for s in (1, 2):
        step(params, batch)
        mgr.save(s, params, opt.state_dict())
        assert ref_latest_step(d) == mgr.latest() == s
    step(params, batch)
    mgr.save(5, params, opt.state_dict(), wait=False)
    mgr.close()
    assert ref_latest_step(d) == mgr.latest() == 5
    import orbax.checkpoint as ocp

    assert sorted(ocp.utils.checkpoint_steps(d)) == mgr.all_steps() == [2, 5]


# ---------------------------------------------------------------------------
# a reference trainer's checkpoint, converted
# ---------------------------------------------------------------------------

REF = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=64, max_seq=32, batch_size=4, seq_len=16, bf16=False,
           log_every=1, lr_schedule="cosine", warmup_steps=1,
           grad_clip=1.0, learning_rate=1e-2)
KINDS = {"dense": {}, "moe": {"n_experts": 4}}
ENGINE = dict(kv_blocks=24, kv_block_size=8, max_batch=2)
PROMPTS = [([1, 2, 3], 6), ([60, 61], 9), ([7, 7, 7, 7, 7], 5)]

_CHILD = """
import json, shutil, sys
import jax
import optax
from nos_tpu.cmd.generate import GenerateConfig
from nos_tpu.cmd.server import ServerConfig
from nos_tpu.cmd.trainer import TrainerConfig, train
from nos_tpu.models import transformer as tfm
from nos_tpu.train import CheckpointManager
from nos_tpu.train.checkpoint import model_arch_dict

runs = json.loads(sys.argv[1])
out = {}
for kind, kw in runs["kinds"].items():
    root = runs["root"] + "/" + kind
    train(TrainerConfig(**kw, steps=2, checkpoint_dir=root + "/ref",
                        checkpoint_every=2))
    shutil.copytree(root + "/ref", root + "/ref_at2")
    out[kind] = train(TrainerConfig(**kw, steps=4,
                                    checkpoint_dir=root + "/ref",
                                    checkpoint_every=2))
sc = ServerConfig(**runs["model"])
g = GenerateConfig(vocab=sc.vocab, d_model=sc.draft_d_model,
                   n_layers=sc.draft_n_layers, n_heads=sc.draft_n_heads,
                   n_kv_heads=sc.draft_n_kv_heads, d_ff=sc.draft_d_ff,
                   max_seq=sc.max_seq, bf16=False)
cfg = tfm.TransformerConfig(vocab=g.vocab, d_model=g.d_model,
                            n_layers=g.n_layers, n_heads=g.n_heads,
                            d_ff=g.d_ff, max_seq=g.max_seq,
                            dtype=jax.numpy.float32)
params = tfm.init_params(jax.random.PRNGKey(11), cfg)
m = CheckpointManager(runs["root"] + "/draft")
m.write_model_config(model_arch_dict(g))
m.save(1, params, optax.adamw(1e-3).init(params))
m.close()
print("OUT=" + json.dumps(out))
"""


def _child(env, payload):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(payload)],
                          env=env, cwd=repo, capture_output=True, text=True,
                          timeout=420)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("OUT=")]
    return json.loads(line[-1][len("OUT="):])


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory, _fresh_jax_subprocess_env):
    """In one child process (a fresh JAX runtime, as the reference's own
    trainer tests run orbax): for dense and MoE, the reference trainer
    runs 2 steps with ``checkpoint_dir`` (a copy of the directory is
    kept), then resumes to step 4; and a draft at ``ServerConfig``'s
    draft widths is saved by the reference's manager. Returns the root
    and each kind's resumed loss."""
    root = tmp_path_factory.mktemp("reference")
    model = {k: REF[k] for k in ("vocab", "d_model", "n_layers", "n_heads",
                                 "n_kv_heads", "d_ff", "max_seq")}
    losses = _child(_fresh_jax_subprocess_env, {
        "root": str(root), "model": model,
        "kinds": {kind: {**REF, **kw} for kind, kw in KINDS.items()}})
    return root, losses


def _adam_state(tree):
    """The ScaleByAdamState inside an optax chain's state."""
    if all(hasattr(tree, a) for a in ("count", "mu", "nu")):
        return tree
    if hasattr(tree, "inner_opt_state"):
        return _adam_state(tree.inner_opt_state)
    if isinstance(tree, (tuple, list)):
        for item in tree:
            found = _adam_state(item)
            if found is not None:
                return found
    return None


def convert(ref_dir, out_dir, cfg_kw, with_opt):
    """The test-side converter: the reference's latest step restored by
    orbax (the reference's own manager), its params bridged by
    ``params_from_jax``, its optax state mapped to the port's optimizer
    state (the update count and the moments, in ``param_leaves``
    order), saved by the port's manager under the same step with the
    reference's stamp. Returns the step."""
    from nos_tpu.cmd import trainer as jtr
    from nos_tpu.models import transformer as jt
    from nos_tpu.train import CheckpointManager as JManager
    from nos_tpu.train import optim as jo

    c = jtr.TrainerConfig(**cfg_kw)
    jcfg = jt.TransformerConfig(
        vocab=c.vocab, d_model=c.d_model, n_layers=c.n_layers,
        n_heads=c.n_heads, n_kv_heads=c.n_kv_heads, d_ff=c.d_ff,
        max_seq=c.max_seq, n_experts=c.n_experts,
        dtype=jnp.bfloat16 if c.bf16 else jnp.float32)
    template = jax.eval_shape(
        lambda: jt.init_params(jax.random.PRNGKey(0), jcfg))
    jm = JManager(ref_dir)
    step = jm.latest()
    state = {}
    if with_opt:
        tx = jo.build_optimizer(
            c.learning_rate, c.steps, warmup_steps=c.warmup_steps,
            schedule=c.lr_schedule, min_lr_ratio=c.min_lr_ratio,
            weight_decay=c.weight_decay, b1=c.adam_b1, b2=c.adam_b2,
            grad_clip=c.grad_clip, accum_steps=c.accum_steps)
        params, jstate = jm.restore(
            step, params_template=template,
            opt_state_template=jax.eval_shape(tx.init, template))
        adam = _adam_state(jstate)
        state = {"count": int(np.asarray(adam.count)),
                 "mu": tt.param_leaves(tt.params_from_jax(
                     jax.device_get(adam.mu), "cpu")),
                 "nu": tt.param_leaves(tt.params_from_jax(
                     jax.device_get(adam.nu), "cpu"))}
    else:
        params = jm.restore_params(step, params_template=template)
    stamp = jm.read_model_config()
    jm.close()
    pm = CheckpointManager(out_dir)
    pm.write_model_config(stamp)
    pm.save(step, tt.params_from_jax(jax.device_get(params), "cpu"), state)
    pm.close()
    return step


@pytest.mark.parametrize("kind", list(KINDS))
def test_reference_checkpoint_resumes_in_the_port(reference_runs, kind,
                                                  tmp_path):
    """The reference's step-2 checkpoint, converted, resumed by the
    port's trainer to step 4: the final loss within 1e-5 relative of the
    reference's own resume, and every param of the two step-4
    checkpoints within 2e-5."""
    root, losses = reference_runs
    kw = {**REF, **KINDS[kind], "steps": 4}
    port_dir = str(tmp_path / "port")
    assert convert(str(root / kind / "ref_at2"), port_dir, kw, True) == 2
    loss = ttr.train(ttr.TrainerConfig(**kw, checkpoint_dir=port_dir,
                                       checkpoint_every=2), device="cpu")
    assert abs(loss - losses[kind]) <= LOSS_RTOL * abs(losses[kind])
    got_dir = str(tmp_path / "ref4")
    shutil.copytree(str(root / kind / "ref"), got_dir)
    assert convert(got_dir, str(tmp_path / "ref4_port"), kw, False) == 4
    mine = CheckpointManager(port_dir)
    theirs = CheckpointManager(str(tmp_path / "ref4_port"))
    assert mine.latest() == theirs.latest() == 4
    cfg_t = tt.TransformerConfig(
        **{k: kw[k] for k in ("vocab", "d_model", "n_layers", "n_heads",
                              "n_kv_heads", "d_ff", "max_seq")},
        n_experts=kw.get("n_experts", 0), dtype=torch.float32)
    a = mine.restore_params(params_template=tt.abstract_params(cfg_t),
                            device="cpu")
    b = theirs.restore_params(params_template=tt.abstract_params(cfg_t),
                              device="cpu")
    mine.close()
    theirs.close()
    for x, y in zip(tt.param_leaves(a), tt.param_leaves(b)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=PARAM_TOL,
                                   rtol=0)


def _drain(engine):
    rids = [engine.submit(p, n) for p, n in PROMPTS]
    out = engine.drain()
    return [list(out[r]) for r in rids]


@pytest.mark.parametrize("kind", list(KINDS))
def test_reference_checkpoint_serves_the_reference_tokens(
        reference_runs, kind, tmp_path, monkeypatch):
    """The reference trainer's step-4 checkpoint, converted, through the
    port's generate binary and ``build_engine``: the greedy tokens of
    the reference's ``run`` and ``build_engine`` on the orbax
    directory; with ``draft_checkpoint_dir`` (the reference manager's
    draft, converted) both build speculative engines with equal
    tokens."""
    from nos_tpu.cmd import generate as jgen
    from nos_tpu.cmd import server as jserver
    from nos_tpu.models.spec_serving import SpeculativeDecodeServer as JSpec
    from nos_tpu_torch.cmd import generate as tgen
    from nos_tpu_torch.cmd import server as tserver
    from nos_tpu_torch.models.spec_serving import SpeculativeDecodeServer

    root, _ = reference_runs
    kw = {**REF, **KINDS[kind], "steps": 4}
    ref_dir = str(tmp_path / "ref")
    shutil.copytree(str(root / kind / "ref"), ref_dir)
    port_dir = str(tmp_path / "port")
    assert convert(ref_dir, port_dir, kw, False) == 4
    model = {k: kw[k] for k in ("vocab", "d_model", "n_layers", "n_heads",
                                "n_kv_heads", "d_ff", "max_seq")}
    model["n_experts"] = kw.get("n_experts", 0)

    prompts = [p for p, _ in PROMPTS]
    want = jgen.run(jgen.GenerateConfig(**model, bf16=False,
                                        checkpoint_dir=ref_dir,
                                        max_new_tokens=6), prompts)
    got = tgen.run(tgen.GenerateConfig(**model, bf16=False,
                                       checkpoint_dir=port_dir,
                                       max_new_tokens=6), prompts,
                   device="cpu")
    assert got == want

    monkeypatch.setenv("NOS_TPU_PAGED_KERNEL", "0")
    draft_ref = str(tmp_path / "draft_ref")
    shutil.copytree(str(root / "draft"), draft_ref)
    draft_port = str(tmp_path / "draft_port")
    sc = tserver.ServerConfig(**model)
    dkw = dict(vocab=sc.vocab, d_model=sc.draft_d_model,
               n_layers=sc.draft_n_layers, n_heads=sc.draft_n_heads,
               n_kv_heads=sc.draft_n_kv_heads, d_ff=sc.draft_d_ff,
               max_seq=sc.max_seq, bf16=False)
    assert convert(draft_ref, draft_port, dkw, False) == 1
    for draft in (False, True):
        extra = {"draft_checkpoint_dir": draft_ref} if draft else {}
        # the reference's gather formulation, its own oracle
        ref = jserver.build_engine(jserver.ServerConfig(
            **model, bf16=False, checkpoint_dir=ref_dir, **ENGINE,
            paged_kernel="off", **extra))
        extra = {"draft_checkpoint_dir": draft_port} if draft else {}
        port = tserver.build_engine(tserver.ServerConfig(
            **model, bf16=False, checkpoint_dir=port_dir, **ENGINE, **extra),
            device="cpu")
        assert isinstance(ref, JSpec) == isinstance(
            port, SpeculativeDecodeServer) == draft
        assert _drain(port) == _drain(ref)
