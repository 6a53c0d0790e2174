"""nos-tpu-trainer on one card (port of ``nos_tpu/cmd/trainer.py``,
single process).

Trains the decoder transformer, dense or Mixture-of-Experts
(``n_experts``), on synthetic or memory-mapped token batches, logging
loss and steps/s, with the reference's optimizer chain, held-out eval,
checkpoints (``checkpoint_dir``: resume from the latest step, the
``checkpoint_every`` and ``checkpoint_every_s`` cadences, asynchronous
saves; ``train/checkpoint.py``), stop event and SIGTERM handling (the
step just completed is checkpointed before the exit), the named remat
policies (``remat_policy``), a torch.profiler trace of a window of steps
(``profile_dir``) and, from ``main``, the ``nos_tpu_train_*`` series
served on ``metrics_port`` (``cmd/serve.py::HealthServer``), and with
``node_name`` and ``lifecycle_api`` the lifecycle notice watcher, which
stops the run with a checkpoint when the control plane stamps a
preemption or maintenance notice on the pod's node. Causal attention
runs through the hand-written CUDA flash-attention kernels on the card.

Not ported yet, and refused with a ValueError naming the knob: the
parallel layouts (``dp``/``fsdp``/``tp``/``pp``/``sp``/``ep`` > 1) and a
multi-host environment (``COORDINATOR_ADDRESS``).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import threading
import time
from dataclasses import dataclass, fields
from typing import Optional, Sequence

import torch

from nos_tpu_torch.device import DeviceLike, resolve_device

logger = logging.getLogger("nos_tpu_torch.trainer")


@dataclass
class TrainerConfig:
    # model (defaults are test-sized; production configs come from --config)
    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 0
    d_ff: int = 1408
    max_seq: int = 512
    n_experts: int = 0
    sp_strategy: str = "ring"          # ring | ulysses (sp axis attention)
    # memory/recompute trade (models/transformer.TransformerConfig):
    # full | dots | except_mlp | minimal, and the chunked lm head
    remat_policy: str = "full"
    loss_chunk: int = 0
    # layout
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    n_microbatches: int = 2            # pp only
    pipeline_schedule: str = "1f1b"    # 1f1b | gpipe | interleaved
    virtual_stages: int = 2
    # run
    steps: int = 10
    batch_size: int = 8
    seq_len: int = 256
    learning_rate: float = 3e-4
    # optimizer (train/optim.py): linear warmup into constant|cosine,
    # global-norm clipping, gradient accumulation
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    min_lr_ratio: float = 0.0
    weight_decay: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    grad_clip: float = 0.0
    accum_steps: int = 1
    seed: int = 0
    log_every: int = 10
    # data: glob of memory-mapped token shards (train/data.py); empty =
    # deterministic synthetic batches. prefetch = token-shard batches
    # staged ahead onto the device; 0 assembles each step's batch
    # synchronously (synthetic batches always are)
    data_path: str = ""
    prefetch: int = 2
    # held-out evaluation: every eval_every steps, mean loss over
    # eval_steps deterministic batches from eval_data_path (0 = off)
    eval_data_path: str = ""
    eval_every: int = 0
    eval_steps: int = 4
    # checkpointing (empty checkpoint_dir = off)
    checkpoint_dir: str = ""
    checkpoint_every: int = 100
    checkpoint_every_s: float = 0.0
    # preemption: catch SIGTERM, finish the in-flight step, and exit
    handle_sigterm: bool = True
    host_sync_every: int = 8
    # profiling: a torch.profiler trace (CPU and CUDA activity) of steps
    # [profile_start, profile_start + profile_steps) under profile_dir
    profile_dir: str = ""
    profile_start: int = 2
    profile_steps: int = 3
    # lifecycle integration: with both set, main() watches this pod's
    # node on the control plane's API server for a preemption or
    # maintenance notice, which stops the run with a checkpoint
    node_name: str = ""
    lifecycle_api: str = ""
    # misc
    log_level: str = "info"
    bf16: bool = True
    metrics_port: int = 0              # main(): /metrics, /healthz (0 = off)

    @classmethod
    def from_yaml_file(cls, path: str) -> "TrainerConfig":
        """The config a YAML file sets; without PyYAML installed, a file
        in YAML's JSON subset is read all the same."""
        with open(path) as f:
            text = f.read()
        try:
            import yaml
        except ImportError:
            data = json.loads(text) if text.strip() else {}
        else:
            data = yaml.safe_load(text) or {}
        known = {f.name for f in fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(
                f"{path}: unknown trainer config keys {sorted(unknown)}")
        return cls(**data)


def check_ported(cfg: TrainerConfig) -> None:
    """Raise a ValueError naming the first knob this slice does not run."""
    for knob in ("dp", "fsdp", "tp", "pp", "sp", "ep"):
        if getattr(cfg, knob) > 1:
            raise ValueError(
                f"{knob}={getattr(cfg, knob)}: parallel layouts are not "
                f"ported yet; the torch trainer runs one process on one "
                f"card")
    if os.environ.get("COORDINATOR_ADDRESS"):
        raise ValueError(
            "COORDINATOR_ADDRESS: multi-host training is not ported yet")


def synthetic_batch(cfg: TrainerConfig, step: int,
                    device: DeviceLike = "cpu") -> dict:
    """The deterministic synthetic batch of ``step``, the reference's own
    stream: tokens ``randint(fold_in(PRNGKey(seed + 1), step), (batch,
    seq), 0, vocab)`` drawn by the port's threefry on ``device`` (so a
    step on the card never waits for host work), targets the tokens
    rolled left by one; int64 tensors."""
    from nos_tpu_torch.utils import prng

    key = prng.fold_in(prng.PRNGKey(cfg.seed + 1, device), step)
    tokens = prng.randint(key, (cfg.batch_size, cfg.seq_len), 0, cfg.vocab)
    return {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}


def _start_profile(device: torch.device):
    """A running torch.profiler (CPU activity, and CUDA's on the card)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, cfg: TrainerConfig, first: int, end: int,
                  device: torch.device) -> str:
    """Stop ``prof`` once the traced steps' work is done and write its
    Chrome trace of steps [first, end) under ``cfg.profile_dir``;
    returns the file's path."""
    if device.type == "cuda":
        try:
            torch.cuda.synchronize(device)
        except RuntimeError:
            # a step that failed on the card: stop all the same
            pass
    prof.stop()
    os.makedirs(cfg.profile_dir, exist_ok=True)
    path = os.path.join(cfg.profile_dir, f"trainer_steps_{first}-{end}_"
                        f"{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
    return path


def train(cfg: TrainerConfig, stop_event: Optional[threading.Event] = None,
          device: DeviceLike = None) -> float:
    """Run the configured training job on one card (``device="cpu"`` runs
    the plain PyTorch versions); returns the final loss.

    ``stop_event`` requests a graceful early exit after the current step.
    When ``cfg.handle_sigterm`` is set and this is the main thread,
    SIGTERM sets it (the Kubernetes preemption contract): the step just
    completed is checkpointed and the loop exits.

    With ``cfg.profile_dir`` a torch.profiler trace covers the
    ``profile_steps`` steps from the first at or past ``profile_start``
    (so a run resumed past it still traces), and is stopped and written
    on every exit path."""
    from nos_tpu_torch.models import transformer as tfm
    from nos_tpu_torch.train.data import (
        TokenDataset, prefetch_to_device, to_device,
    )
    from nos_tpu_torch.train.optim import build_optimizer
    from nos_tpu_torch.utils.metrics import default_registry

    check_ported(cfg)
    device = resolve_device(device)
    model_cfg = tfm.TransformerConfig(
        vocab=cfg.vocab, d_model=cfg.d_model, n_layers=cfg.n_layers,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
        max_seq=cfg.max_seq, n_experts=cfg.n_experts,
        sp_strategy=cfg.sp_strategy, remat_policy=cfg.remat_policy,
        loss_chunk=cfg.loss_chunk,
        dtype=torch.bfloat16 if cfg.bf16 else torch.float32)
    params = tfm.init_params(
        model_cfg, torch.Generator(device).manual_seed(cfg.seed), device)
    leaves = tfm.param_leaves(params)
    for p in leaves:
        p.requires_grad_()
    optimizer = build_optimizer(
        leaves, cfg.learning_rate, cfg.steps,
        warmup_steps=cfg.warmup_steps, schedule=cfg.lr_schedule,
        min_lr_ratio=cfg.min_lr_ratio, weight_decay=cfg.weight_decay,
        b1=cfg.adam_b1, b2=cfg.adam_b2, grad_clip=cfg.grad_clip,
        accum_steps=cfg.accum_steps)

    ckpt = None
    start_step = 0
    if cfg.checkpoint_dir:
        from nos_tpu_torch.train.checkpoint import (
            CheckpointManager, model_arch_dict,
        )

        ckpt = CheckpointManager(cfg.checkpoint_dir)
        # stamp (or, on resume, validate against) the architecture so a
        # config drift between runs fails by field name, not shape error
        ckpt.write_model_config(model_arch_dict(cfg))
        latest = ckpt.latest()
        if latest is not None:
            # into the live leaves and moments, in place
            _, opt_state = ckpt.restore(
                latest, params_template=params,
                opt_state_template=optimizer.state_dict())
            optimizer.load_state_dict(opt_state)
            start_step = latest
            logger.info("resumed from checkpoint step %d", latest)
    step_fn = tfm.make_train_step(model_cfg, optimizer)

    dataset = None
    if cfg.data_path:
        dataset = TokenDataset(cfg.data_path, cfg.seq_len, seed=cfg.seed + 1)
        logger.info("dataset: %d shards, %d tokens",
                    len(dataset.paths), dataset.n_tokens)
    eval_dataset = eval_batches = None
    if cfg.eval_every > 0 and cfg.eval_data_path:
        eval_dataset = TokenDataset(cfg.eval_data_path, cfg.seq_len,
                                    seed=cfg.seed + 2)

    def batch_for(step: int) -> dict:
        # a pure function of (seed, step), so a resumed run replays the
        # stream an uninterrupted one would have seen
        if dataset is not None:
            return dataset.batch(step, cfg.batch_size)
        return synthetic_batch(cfg, step, device)

    def put(batch: dict) -> dict:
        return to_device(batch, device)

    reg = default_registry()
    m_steps = reg.counter(
        "nos_tpu_train_steps_total", "Training steps completed")
    m_tokens = reg.counter(
        "nos_tpu_train_tokens_total", "Tokens consumed by training")
    m_step_s = reg.histogram(
        "nos_tpu_train_step_seconds",
        "Avg wall time per step, observed at log boundaries (per-step "
        "timing would force a device sync every step)",
        buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0))
    m_saves = reg.counter(
        "nos_tpu_train_checkpoint_saves_total", "Checkpoints saved")
    m_preempt = reg.counter(
        "nos_tpu_train_preemptions_total",
        "Graceful preemption exits (SIGTERM/stop event, step banked)")
    g_loss = reg.gauge("nos_tpu_train_loss", "Most recent training loss")
    g_eval = reg.gauge(
        "nos_tpu_train_eval_loss", "Most recent held-out eval loss")

    stop = stop_event if stop_event is not None else threading.Event()
    handler_installed = False
    prev_handler = None
    loss = float("nan")
    preempted = False
    last_saved = start_step
    prof = None
    profiled = not (cfg.profile_dir and cfg.profile_steps > 0)
    profile_first = profile_end = start_step
    t0 = time.perf_counter()
    last_log_t, last_log_step = t0, start_step
    last_save_t = t0
    n = max(cfg.steps - start_step, 0)
    if cfg.prefetch > 0 and dataset is not None:
        batches = prefetch_to_device(batch_for, start_step, n, put=put,
                                     depth=cfg.prefetch)
    else:
        # synchronous, no background thread: a synthetic batch is drawn
        # on the card by this thread, because a producer thread's
        # hundreds of small launches contend with the step's dispatch
        # for the interpreter lock (10-30 ms a step on an H100)
        batches = (put(batch_for(s)) for s in range(start_step, cfg.steps))
    try:
        if cfg.handle_sigterm and \
                threading.current_thread() is threading.main_thread():
            prev_handler = signal.signal(signal.SIGTERM,
                                         lambda *_: stop.set())
            handler_installed = True
        batch = next(batches, None)
        for step in range(start_step, cfg.steps):
            if not profiled and step >= cfg.profile_start:
                # the profiler starts and stops on this, the training,
                # thread only (stopping it from another thread beside a
                # CUDA graph's replay hung, ROADMAP C.8; the trainer
                # replays no graph, and the checkpoint copy runs on a
                # side stream of this thread)
                prof = _start_profile(device)
                profiled = True
                profile_first = step
                profile_end = step + cfg.profile_steps
            loss_t = step_fn(params, batch)
            m_steps.inc()
            m_tokens.inc(cfg.batch_size * cfg.seq_len)
            if prof is not None and step + 1 >= profile_end:
                _stop_profile(prof, cfg, profile_first, step + 1, device)
                prof = None
            # the next batch goes on the stream behind this step, before
            # the host waits for its loss
            batch = next(batches, None)
            if stop.is_set():
                # preemption: bank the step just completed (synchronous:
                # the grace period is short, so before eval and the
                # periodic save) under its true count, so a resume
                # replays the stream an uninterrupted run would see
                preempted = True
                loss = float(loss_t)
                if ckpt is not None and last_saved != step + 1:
                    ckpt.save(step + 1, params, optimizer.state_dict())
                    last_saved = step + 1
                    m_saves.inc()
                m_preempt.inc()
                g_loss.set(loss)
                logger.info("stop requested (preemption): checkpointed "
                            "step %d/%d, exiting cleanly", step + 1,
                            cfg.steps)
                break
            if (step + 1) % cfg.log_every == 0 or step + 1 == cfg.steps:
                loss = float(loss_t)        # waits for the step
                g_loss.set(loss)
                now = time.perf_counter()
                m_step_s.observe((now - last_log_t)
                                 / max(step + 1 - last_log_step, 1))
                last_log_t, last_log_step = now, step + 1
                logger.info("step %d/%d loss %.4f (%.2f steps/s)",
                            step + 1, cfg.steps, loss,
                            (step + 1 - start_step)
                            / max(now - t0, 1e-9))
            if eval_dataset is not None and (step + 1) % cfg.eval_every == 0:
                if eval_batches is None:
                    # the eval set is deterministic: stage it once
                    eval_batches = [put(eval_dataset.batch(i,
                                                           cfg.batch_size))
                                    for i in range(cfg.eval_steps)]
                with torch.no_grad():
                    losses = [float(tfm.loss_fn(params, model_cfg, eb))
                              for eb in eval_batches]
                mean = sum(losses) / len(losses)
                g_eval.set(mean)
                logger.info("step %d eval loss %.4f (%d batches)", step + 1,
                            mean, cfg.eval_steps)
            due_by_time = (ckpt is not None and cfg.checkpoint_every_s > 0
                           and time.perf_counter() - last_save_t
                           >= cfg.checkpoint_every_s)
            if ckpt is not None and (
                    (step + 1) % cfg.checkpoint_every == 0 or due_by_time):
                # async: the copy overlaps the next step's forward and
                # backward; its update waits for the copy on the device
                optimizer.fence(ckpt.save(step + 1, params,
                                          optimizer.state_dict(),
                                          wait=False))
                last_saved = step + 1
                last_save_t = time.perf_counter()
                m_saves.inc()
        # final save only when steps ran to the configured end (a restart
        # whose restored step already meets cfg.steps must not relabel
        # old state, and a preempted exit must not label partial
        # progress as cfg.steps); finally fences and closes
        if ckpt is not None and not preempted and start_step < cfg.steps \
                and last_saved != cfg.steps:
            ckpt.save(cfg.steps, params, optimizer.state_dict())
            m_saves.inc()
    finally:
        # release the prefetch producer (and the batches it holds) now
        batches.close()
        # fence any in-flight save on every exit path: a retry must not
        # race a background writer over the checkpoint directory
        if ckpt is not None:
            ckpt.close()
        if handler_installed:
            signal.signal(signal.SIGTERM,
                          prev_handler if prev_handler is not None
                          else signal.SIG_DFL)
        # last: a window cut short (a step raised, a stop, or the run
        # ended inside it) is stopped and written here, so a later
        # train() in this process finds no profiler running
        if prof is not None:
            _stop_profile(prof, cfg, profile_first, step + 1, device)
    return loss


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = None) -> None:
    """The binary: ``--config`` YAML (or JSON), ``--log-format``; with
    ``metrics_port`` the process's metrics (the ``nos_tpu_train_*``
    series among them) on ``/metrics`` and ``/healthz`` while it
    trains."""
    from nos_tpu_torch.cmd import setup_logging

    parser = argparse.ArgumentParser(prog="nos-tpu-torch-trainer",
                                     description=__doc__)
    parser.add_argument("--config", default="", help="trainer config YAML")
    parser.add_argument(
        "--log-format", choices=("text", "json"), default="text",
        help="log line format; json emits one object per line with "
             "trace_id/span_id injected when a tracing span is active")
    args = parser.parse_args(argv)
    cfg = TrainerConfig.from_yaml_file(args.config) if args.config \
        else TrainerConfig()
    setup_logging(0, args.log_format,
                  numeric_level=getattr(logging, cfg.log_level.upper(),
                                        logging.INFO))
    health = None
    if cfg.metrics_port:
        from nos_tpu_torch.cmd.serve import HealthServer

        health = HealthServer(host="0.0.0.0", port=cfg.metrics_port).start()
        logger.info("metrics on %s/metrics", health.address)
    stop_event = None
    notice_mgr = None
    if cfg.node_name and cfg.lifecycle_api:
        # the preemption-notice watcher: a maintenance or preemption
        # notice on THIS pod's node sets the stop event train()
        # consumes, banking a checkpoint inside the notice's lead time
        # (lifecycle/events.py)
        from nos_tpu_torch.kube.controller import Manager
        from nos_tpu_torch.kube.httpapi import RemoteApiServer
        from nos_tpu_torch.lifecycle.events import (
            preemption_signal_controller,
        )

        stop_event = threading.Event()
        notice_mgr = Manager(RemoteApiServer(cfg.lifecycle_api))
        notice_mgr.add_controller(
            preemption_signal_controller(cfg.node_name, stop_event))
        watcher = threading.Thread(target=notice_mgr.run,
                                   name="notice-watcher", daemon=True)
        watcher.start()
        logger.info("watching node %s for preemption/maintenance notices",
                    cfg.node_name)
    try:
        final = train(cfg, stop_event=stop_event, device=device)
    finally:
        if notice_mgr is not None:
            notice_mgr.stop()
            watcher.join(timeout=5.0)
        if health is not None:
            health.stop()
    logger.info("training done, final loss %.4f", final)


if __name__ == "__main__":
    main()
