"""nos-tpu-trainer on one card (port of ``nos_tpu/cmd/trainer.py``,
single process).

Trains the decoder transformer on synthetic or memory-mapped token
batches, logging loss and steps/s, with the reference's optimizer chain,
held-out eval, stop event and SIGTERM handling. Causal attention runs
through the hand-written CUDA flash-attention kernels on the card.

Not ported yet, and refused with a ValueError naming the knob: the
parallel layouts (``dp``/``fsdp``/``tp``/``pp``/``sp``/``ep`` > 1), MoE
(``n_experts``), ``checkpoint_dir``, ``profile_dir``, ``metrics_port``,
the lifecycle watcher (``node_name``/``lifecycle_api``) and a multi-host
environment (``COORDINATOR_ADDRESS``).
"""
from __future__ import annotations

import argparse
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
    # checkpointing (not ported yet: a non-empty checkpoint_dir raises)
    checkpoint_dir: str = ""
    checkpoint_every: int = 100
    checkpoint_every_s: float = 0.0
    # preemption: catch SIGTERM, finish the in-flight step, and exit
    handle_sigterm: bool = True
    host_sync_every: int = 8
    # profiling (not ported yet: a non-empty profile_dir raises)
    profile_dir: str = ""
    profile_start: int = 2
    profile_steps: int = 3
    # lifecycle integration (not ported yet: setting both raises)
    node_name: str = ""
    lifecycle_api: str = ""
    # misc
    log_level: str = "info"
    bf16: bool = True
    metrics_port: int = 0              # not ported yet: non-zero raises

    @classmethod
    def from_yaml_file(cls, path: str) -> "TrainerConfig":
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
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
    refused = [("n_experts", cfg.n_experts > 0, "MoE"),
               ("checkpoint_dir", bool(cfg.checkpoint_dir), "checkpointing"),
               ("profile_dir", bool(cfg.profile_dir), "the profiler"),
               ("metrics_port", bool(cfg.metrics_port), "the metrics server"),
               ("node_name/lifecycle_api",
                bool(cfg.node_name and cfg.lifecycle_api),
                "the lifecycle notice watcher")]
    for knob, hit, what in refused:
        if hit:
            raise ValueError(f"{knob}: {what} is not ported yet")
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


def train(cfg: TrainerConfig, stop_event: Optional[threading.Event] = None,
          device: DeviceLike = None) -> float:
    """Run the configured training job on one card (``device="cpu"`` runs
    the plain PyTorch versions); returns the final loss.

    ``stop_event`` requests a graceful early exit after the current step.
    When ``cfg.handle_sigterm`` is set and this is the main thread,
    SIGTERM sets it (the Kubernetes preemption contract)."""
    from nos_tpu_torch.models import transformer as tfm
    from nos_tpu_torch.train.data import (
        TokenDataset, prefetch_to_device, to_device,
    )
    from nos_tpu_torch.train.optim import build_optimizer

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
        # a pure function of (seed, step), so a rerun replays the stream
        if dataset is not None:
            return dataset.batch(step, cfg.batch_size)
        return synthetic_batch(cfg, step, device)

    def put(batch: dict) -> dict:
        return to_device(batch, device)

    stop = stop_event if stop_event is not None else threading.Event()
    handler_installed = False
    prev_handler = None
    loss = float("nan")
    t0 = time.perf_counter()
    if cfg.prefetch > 0 and dataset is not None:
        batches = prefetch_to_device(batch_for, 0, cfg.steps, put=put,
                                     depth=cfg.prefetch)
    else:
        # synchronous, no background thread: a synthetic batch is drawn
        # on the card by this thread, because a producer thread's
        # hundreds of small launches contend with the step's dispatch
        # for the interpreter lock (10-30 ms a step on an H100)
        batches = (put(batch_for(s)) for s in range(cfg.steps))
    try:
        if cfg.handle_sigterm and \
                threading.current_thread() is threading.main_thread():
            prev_handler = signal.signal(signal.SIGTERM,
                                         lambda *_: stop.set())
            handler_installed = True
        batch = next(batches, None)
        for step in range(cfg.steps):
            loss_t = step_fn(params, batch)
            # the next batch goes on the stream behind this step, before
            # the host waits for its loss
            batch = next(batches, None)
            if stop.is_set():
                loss = float(loss_t)
                logger.info("stop requested (preemption): exiting after "
                            "step %d/%d", step + 1, cfg.steps)
                break
            if (step + 1) % cfg.log_every == 0 or step + 1 == cfg.steps:
                loss = float(loss_t)        # waits for the step
                logger.info("step %d/%d loss %.4f (%.2f steps/s)",
                            step + 1, cfg.steps, loss,
                            (step + 1) / max(time.perf_counter() - t0,
                                             1e-9))
            if eval_dataset is not None and (step + 1) % cfg.eval_every == 0:
                if eval_batches is None:
                    # the eval set is deterministic: stage it once
                    eval_batches = [put(eval_dataset.batch(i,
                                                           cfg.batch_size))
                                    for i in range(cfg.eval_steps)]
                with torch.no_grad():
                    losses = [float(tfm.loss_fn(params, model_cfg, eb))
                              for eb in eval_batches]
                logger.info("step %d eval loss %.4f (%d batches)", step + 1,
                            sum(losses) / len(losses), cfg.eval_steps)
    finally:
        # release the prefetch producer (and the batches it holds) now
        batches.close()
        if handler_installed:
            signal.signal(signal.SIGTERM,
                          prev_handler if prev_handler is not None
                          else signal.SIG_DFL)
    return loss


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(prog="nos-tpu-torch-trainer",
                                     description=__doc__)
    parser.add_argument("--config", default="", help="trainer config YAML")
    args = parser.parse_args(argv)
    cfg = TrainerConfig.from_yaml_file(args.config) if args.config \
        else TrainerConfig()
    logging.basicConfig(
        level=getattr(logging, cfg.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    final = train(cfg)
    logger.info("training done, final loss %.4f", final)


if __name__ == "__main__":
    main()
