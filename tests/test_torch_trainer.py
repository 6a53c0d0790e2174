"""Port parity: the training step, the input pipeline and the trainer
entry point of ``nos_tpu_torch`` against ``nos_tpu`` on the CPU.

Three f32 steps through ``make_train_step`` (adamw, warmup + cosine,
clipping) on the same params and batches: losses within 1e-5 relative;
params within 2e-5 absolute after the three updates (lr 1e-3: the f32
gradient noise of the two frameworks, <= 1e-5 of each tensor's scale,
moves Adam's normalised step by far less than that except where a
gradient is itself at the noise level). Token-shard batches and the
synthetic batches (threefry) are held bit for bit.
"""
import dataclasses
import json
import logging
import os
import socket
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.cmd import trainer as jtr  # noqa: E402
from nos_tpu.models import transformer as jt  # noqa: E402
from nos_tpu.train import data as jd  # noqa: E402
from nos_tpu.train import optim as jo  # noqa: E402
from nos_tpu_torch.cmd import trainer as ttr  # noqa: E402
from nos_tpu_torch.models import transformer as tt  # noqa: E402
from nos_tpu_torch.train import data as td  # noqa: E402
from nos_tpu_torch.train import optim as to  # noqa: E402

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=64, max_seq=32)
OPT = dict(warmup_steps=1, schedule="cosine", grad_clip=1.0,
           weight_decay=0.1)
LOSS_RTOL, PARAM_TOL = 1e-5, 2e-5
TINY = dict(KW, steps=4, batch_size=2, seq_len=16, log_every=1, bf16=False)


def _leaves(tree):
    out = []
    for key in sorted(tree):
        v = tree[key]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def test_three_train_steps_match_reference():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **KW)
    tcfg = tt.TransformerConfig(dtype=torch.float32, **KW)
    jparams = jt.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = tt.params_from_jax(jparams, device="cpu")
    leaves = tt.param_leaves(tparams)
    for p in leaves:
        p.requires_grad_()
    tx = jo.build_optimizer(1e-3, 3, **OPT)
    state = tx.init(jparams)
    jstep = jax.jit(jt.make_train_step(jcfg, tx))
    tstep = tt.make_train_step(tcfg, to.build_optimizer(leaves, 1e-3, 3,
                                                        **OPT))
    rng = np.random.default_rng(0)
    for i in range(3):
        tokens = rng.integers(0, KW["vocab"], size=(2, 16)).astype(np.int32)
        batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1)}
        jparams, state, jloss = jstep(
            jparams, state, {k: jnp.asarray(v) for k, v in batch.items()})
        loss = tstep(tparams, {k: torch.from_numpy(v).long()
                               for k, v in batch.items()})
        assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * float(jloss), i
    for got, want in zip(leaves, _leaves(jparams)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=PARAM_TOL, rtol=0)


@pytest.fixture
def shards(tmp_path):
    rng = np.random.default_rng(7)
    train = jd.write_token_shards(
        str(tmp_path / "train"), [rng.integers(0, 64, 900),
                                  rng.integers(0, 64, 300), np.arange(17)])
    evals = jd.write_token_shards(str(tmp_path / "eval"),
                                  [rng.integers(0, 64, 400)])
    return str(tmp_path / "train" / "*.bin"), str(tmp_path / "eval" /
                                                  "*.bin"), train, evals


def test_token_dataset_batches_bit_equal_to_reference(shards):
    train_glob, _, _, _ = shards
    jds = jd.TokenDataset(train_glob, 16, seed=3)
    tds = td.TokenDataset(train_glob, 16, seed=3)
    assert tds.n_tokens == jds.n_tokens and tds.paths == jds.paths
    for step in range(5):
        want, got = jds.batch(step, 4), tds.batch(step, 4)
        for k in ("tokens", "targets"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        part = tds.batch(step, 4, process_index=1, process_count=2)
        np.testing.assert_array_equal(part["tokens"], want["tokens"][1::2])


def test_write_token_shards_writes_the_reference_bytes(tmp_path):
    arrs = [np.arange(10), np.arange(5, 12)]
    jp = jd.write_token_shards(str(tmp_path / "j"), arrs, dtype=np.uint16)
    tp = td.write_token_shards(str(tmp_path / "t"), arrs, dtype=np.uint16)
    for a, b in zip(jp, tp):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert (open(str(tmp_path / "j" / "meta.json")).read()
            == open(str(tmp_path / "t" / "meta.json")).read())


def test_to_device_gives_int64_tensors():
    got = td.to_device({"tokens": np.arange(6, dtype=np.int32).reshape(2, 3)},
                       torch.device("cpu"))
    assert got["tokens"].dtype == torch.int64
    assert got["tokens"].tolist() == [[0, 1, 2], [3, 4, 5]]


def test_prefetch_yields_every_step_in_order_and_closes():
    batches = td.prefetch_to_device(lambda s: {"s": s}, 3, 5, depth=2)
    assert [b["s"] for b in batches] == [3, 4, 5, 6, 7]
    failing = td.prefetch_to_device(
        lambda s: 1 / (s - 1), 0, 3, depth=1)
    assert next(failing) == -1.0
    with pytest.raises(ZeroDivisionError):
        next(failing)


def test_train_on_cpu_from_token_shards_logs_eval(shards, caplog):
    train_glob, eval_glob, _, _ = shards
    cfg = ttr.TrainerConfig(
        **dict(TINY, steps=4), data_path=train_glob,
        eval_data_path=eval_glob, eval_every=2, eval_steps=2,
        learning_rate=1e-2, lr_schedule="cosine", warmup_steps=1,
        grad_clip=1.0, accum_steps=2, loss_chunk=8)
    with caplog.at_level(logging.INFO, logger="nos_tpu_torch.trainer"):
        loss = ttr.train(cfg, device="cpu")
    assert np.isfinite(loss)
    msgs = [r.getMessage() for r in caplog.records]
    assert sum("eval loss" in m for m in msgs) == 2
    assert sum(m.startswith("step ") and "steps/s" in m for m in msgs) == 4
    assert any("dataset: 3 shards" in m for m in msgs)


def test_train_synthetic_bf16_without_prefetch():
    loss = ttr.train(ttr.TrainerConfig(**dict(TINY, bf16=True, steps=2),
                                       prefetch=0), device="cpu")
    assert np.isfinite(loss)


def test_stop_event_ends_after_the_current_step(caplog):
    stop = threading.Event()
    stop.set()
    with caplog.at_level(logging.INFO, logger="nos_tpu_torch.trainer"):
        loss = ttr.train(ttr.TrainerConfig(**TINY), stop_event=stop,
                         device="cpu")
    assert np.isfinite(loss)
    assert any("stop requested" in r.getMessage() and "step 1/4"
               in r.getMessage() for r in caplog.records)


def test_synthetic_batches_are_a_function_of_seed_and_step():
    cfg = ttr.TrainerConfig(**TINY)
    a, b = ttr.synthetic_batch(cfg, 3), ttr.synthetic_batch(cfg, 3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["targets"],
                                  np.roll(a["tokens"], -1, axis=1))
    assert not np.array_equal(a["tokens"],
                              ttr.synthetic_batch(cfg, 4)["tokens"])
    other = dataclasses.replace(cfg, seed=1)
    assert not np.array_equal(a["tokens"],
                              ttr.synthetic_batch(other, 3)["tokens"])
    assert a["tokens"].min() >= 0 and a["tokens"].max() < cfg.vocab


@pytest.mark.parametrize("seed,step,vocab", [
    (0, 0, 64), (0, 3, 64), (1, 0, 32000), (5, 7, 7), (41, 2, 128256),
    (2 ** 31 - 2, 11, 1000)])
def test_synthetic_batch_is_the_reference_stream(seed, step, vocab):
    """The reference's ``batch_for`` on synthetic data: randint over
    fold_in(PRNGKey(seed + 1), step); tokens and targets bit-equal."""
    cfg = ttr.TrainerConfig(**dict(TINY, vocab=vocab, seed=seed,
                                   batch_size=3, seq_len=24))
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed + 1), step)
    want = np.asarray(jax.random.randint(
        key, (cfg.batch_size, cfg.seq_len), 0, cfg.vocab))
    got = ttr.synthetic_batch(cfg, step)
    assert got["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(got["tokens"].numpy(), want)
    np.testing.assert_array_equal(got["targets"].numpy(),
                                  np.roll(want, -1, axis=1))


def test_trainer_config_has_every_reference_field_and_default():
    want = {f.name: f.default for f in dataclasses.fields(jtr.TrainerConfig)}
    got = {f.name: f.default for f in dataclasses.fields(ttr.TrainerConfig)}
    assert got == want


def test_from_yaml_file_matches_reference(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("d_model: 64\nn_layers: 3\nlr_schedule: cosine\n"
                    "bf16: false\nlearning_rate: 0.001\n")
    assert (dataclasses.asdict(ttr.TrainerConfig.from_yaml_file(str(path)))
            == dataclasses.asdict(jtr.TrainerConfig.from_yaml_file(
                str(path))))
    path.write_text("d_model: 64\nwidth: 3\n")
    with pytest.raises(ValueError, match="unknown trainer config keys"):
        ttr.TrainerConfig.from_yaml_file(str(path))


def test_from_yaml_file_reads_json_without_pyyaml(tmp_path, monkeypatch):
    """Where PyYAML is not installed, a config in YAML's JSON subset
    loads to the config PyYAML would give."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"d_model": 64, "n_layers": 3,
                                "lr_schedule": "cosine", "bf16": False}))
    want = ttr.TrainerConfig.from_yaml_file(str(path))
    monkeypatch.setitem(sys.modules, "yaml", None)
    assert ttr.TrainerConfig.from_yaml_file(str(path)) == want
    assert want.d_model == 64 and not want.bf16


# knobs the trainer refused until MoE training and checkpoints, then
# the profiler and the metrics server, then the dp / fsdp / tp layouts
# (every rank a CPU process over gloo here), then sp and ep (ep with
# experts to split), then pp (the 1F1B schedule by default) were
# ported, trained now
TRAINED_KNOBS = {"n_experts", "checkpoint_dir", "profile_dir",
                 "metrics_port", "dp", "fsdp", "tp", "pp", "sp", "ep"}


@pytest.mark.parametrize("knob,value", [
    ("dp", 2), ("fsdp", 2), ("tp", 2), ("pp", 2), ("sp", 2), ("ep", 2),
    ("n_experts", 4), ("checkpoint_dir", "/ckpt"), ("profile_dir", "/prof"),
    ("metrics_port", 9090),
])
def test_refused_knobs_raise_naming_the_knob(knob, value, tmp_path):
    """A knob outside the port raises naming it. ``n_experts``,
    ``checkpoint_dir``, ``profile_dir``, ``metrics_port``, ``dp``,
    ``fsdp``, ``tp``, ``pp``, ``sp`` and ``ep`` (with experts) were
    refused so and train now: an MoE run and a layout's run (two CPU ranks over
    gloo) give a finite loss, a
    checkpointed run (its directory under the test's own) stamps the
    architecture and commits the final step, a profiled run writes a
    trace there, and ``train()`` leaves ``metrics_port`` to ``main()``
    (tested below)."""
    if knob not in TRAINED_KNOBS:
        cfg = ttr.TrainerConfig(**TINY, **{knob: value})
        with pytest.raises(ValueError, match=knob):
            ttr.train(cfg, device="cpu")
        return
    if knob in ("checkpoint_dir", "profile_dir"):
        value = str(tmp_path / value.lstrip("/"))
    experts = {"n_experts": 2} if knob == "ep" else {}
    loss = ttr.train(ttr.TrainerConfig(**TINY, **{knob: value}, **experts),
                     device="cpu")
    assert np.isfinite(loss)
    if knob == "checkpoint_dir":
        from nos_tpu_torch.train.checkpoint import CheckpointManager

        mgr = CheckpointManager(value)
        assert mgr.all_steps() == [TINY["steps"]]
        assert mgr.read_model_config()["d_model"] == TINY["d_model"]
        mgr.close()
    if knob == "profile_dir":
        assert _traces(value)


def test_lifecycle_watcher_and_multi_host_raise(monkeypatch):
    """The lifecycle watcher's knobs are ported (``main`` runs the
    watcher, tests/test_torch_lifecycle.py): ``train`` takes them. A
    gang of one host (``COORDINATOR_ADDRESS`` with ``NUM_PROCESSES`` 1)
    trains as one host, the loss of the run without it; a host index
    outside the gang raises naming ``PROCESS_ID``."""
    cfg = ttr.TrainerConfig(**TINY, node_name="n0", lifecycle_api="http://x")
    want = ttr.train(cfg, device="cpu")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("NUM_PROCESSES", "1")
    assert ttr.host_gang(ttr._layout(cfg)) is None
    assert ttr.train(cfg, device="cpu") == want
    monkeypatch.setenv("PROCESS_ID", "1")
    with pytest.raises(ValueError, match="PROCESS_ID"):
        ttr.train(ttr.TrainerConfig(**TINY), device="cpu")


def test_main_runs_on_the_card_by_default(tmp_path, monkeypatch):
    """``main()`` with no device: without a visible card it refuses
    rather than training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "cfg.yaml"
    path.write_text("d_model: 32\nn_layers: 1\nn_heads: 4\nvocab: 64\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.main(["--config", str(path)])


def _traces(d):
    return sorted(os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs)


def test_profiler_trace_written(tmp_path):
    """The reference's ``test_profiler_trace_written``, in process: a
    trace of steps [1, 3) lands under ``profile_dir``, a Chrome trace
    holding the steps' ops, and the profiler is off afterwards."""
    d = str(tmp_path / "trace")
    ttr.train(ttr.TrainerConfig(**TINY, profile_dir=d, profile_start=1,
                                profile_steps=2), device="cpu")
    found = _traces(d)
    assert [os.path.basename(f) for f in found] == [
        f"trainer_steps_1-3_{os.getpid()}.pt.trace.json"]
    with open(found[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "nos_tpu_torch::flash_attention_fwd" in names
    assert not torch.autograd._profiler_enabled()


def test_profiler_fires_on_resume_past_start(tmp_path):
    """A run resumed at step 4 with ``profile_start`` 2 (already past)
    still traces; its window runs past the end and is written when the
    run ends."""
    ckpt = str(tmp_path / "ckpt")
    d = str(tmp_path / "trace")
    ttr.train(ttr.TrainerConfig(**TINY, checkpoint_dir=ckpt,
                                checkpoint_every=4), device="cpu")
    ttr.train(ttr.TrainerConfig(**dict(TINY, steps=6), checkpoint_dir=ckpt,
                                checkpoint_every=4, profile_dir=d,
                                profile_start=2, profile_steps=10),
              device="cpu")
    assert [os.path.basename(f) for f in _traces(d)] == [
        f"trainer_steps_4-6_{os.getpid()}.pt.trace.json"]
    assert not torch.autograd._profiler_enabled()


def test_profiler_stops_when_a_step_raises(tmp_path, monkeypatch):
    """A step that raises inside the window: the trace is stopped and
    written on the way out, and the next profiled run starts cleanly."""
    real = tt.make_train_step

    def failing(cfg, optimizer, *mesh):
        step = real(cfg, optimizer, *mesh)
        calls = []

        def wrapped(params, batch):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("step failed")
            return step(params, batch)

        return wrapped

    monkeypatch.setattr(tt, "make_train_step", failing)
    d = str(tmp_path / "trace")
    with pytest.raises(RuntimeError, match="step failed"):
        ttr.train(ttr.TrainerConfig(**TINY, profile_dir=d, profile_start=1,
                                    profile_steps=3), device="cpu")
    assert not torch.autograd._profiler_enabled()
    assert [os.path.basename(f) for f in _traces(d)] == [
        f"trainer_steps_1-3_{os.getpid()}.pt.trace.json"]
    monkeypatch.setattr(tt, "make_train_step", real)
    ttr.train(ttr.TrainerConfig(**TINY, profile_dir=d, profile_start=0,
                                profile_steps=1), device="cpu")
    assert len(_traces(d)) == 2


@pytest.fixture
def root_logging():
    """``main()`` sets up the root logger; put it back afterwards."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    root.handlers[:] = handlers
    root.setLevel(level)


def test_metrics_port_serves_the_train_series(tmp_path, monkeypatch,
                                              root_logging):
    """``main()`` with ``metrics_port``: while it trains, /metrics
    carries the ``nos_tpu_train_*`` series (the steps counter up by the
    steps run) and /healthz answers 200; the server is gone once
    ``main()`` returns. The config is JSON, which the loader reads with
    or without PyYAML."""
    from nos_tpu_torch.utils.metrics import default_registry

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(dict(TINY, metrics_port=port)))
    steps = default_registry().get("nos_tpu_train_steps_total")
    before = steps.total() if steps is not None else 0.0
    url = f"http://127.0.0.1:{port}"
    seen = {}
    real = ttr.train

    def scraped(cfg, *args, **kwargs):
        out = real(cfg, *args, **kwargs)
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            seen["metrics"] = r.read().decode()
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            seen["healthz"] = r.status
        with urllib.request.urlopen(url + "/debug/traces", timeout=10) as r:
            seen["traces"] = json.loads(r.read())
        req = urllib.request.Request(url + "/metrics", headers={
            "Accept": "application/openmetrics-text"})
        with urllib.request.urlopen(req, timeout=10) as r:
            seen["openmetrics"] = (r.headers["Content-Type"],
                                   r.read().decode())
        return out

    monkeypatch.setattr(ttr, "train", scraped)
    ttr.main(["--config", str(path), "--log-format", "json"], device="cpu")
    lines = dict(line.rsplit(" ", 1) for line in seen["metrics"].splitlines()
                 if line.startswith("nos_tpu_train_"))
    assert float(lines["nos_tpu_train_steps_total"]) == before + TINY["steps"]
    assert float(lines["nos_tpu_train_tokens_total"]) > 0
    assert np.isfinite(float(lines["nos_tpu_train_loss"]))
    assert "nos_tpu_train_step_seconds_count" in lines
    assert seen["healthz"] == 200
    assert isinstance(seen["traces"], (dict, list))
    ctype, body = seen["openmetrics"]
    assert ctype.startswith("application/openmetrics-text")
    assert body.rstrip().endswith("# EOF")
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url + "/healthz", timeout=2)
