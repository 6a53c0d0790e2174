"""nos-tpu-trainer (port of ``nos_tpu/cmd/trainer.py``).

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

The ``dp``, ``fsdp``, ``tp``, ``pp``, ``sp`` and ``ep`` layouts run one
process a rank over a ``torch.distributed`` process group
(``parallel/mesh.py::TrainMesh``):
rank 0 in the caller's process (its stop event, signal handler,
profiler, metrics and return value are the caller's), ranks 1..N-1
forked from a fork server that has imported the training modules
(``parallel/launch.py``). Each rank draws the global batch and keeps its
data rows' sequence chunk (the targets cut after the shift, from the
whole row), holds its part of the params and moments (its experts under
``ep``), and runs the flash and adamw kernels on them (under ``sp``
Ulysses runs the flash kernels on its H/sp heads over the whole
sequence; the ring runs plain products). Under ``pp`` a rank holds its
stage's layers and runs the reference's ``pipeline_schedule`` over
``n_microbatches`` (``gpipe``, ``1f1b``, or ``interleaved`` with
``virtual_stages`` chunks a stage, whose params are chunk-major,
stamped so in the checkpoint; ``parallel/pipeline.py``), each data rank
taking its share of every microbatch's rows; eval runs the schedule's
forward only. One card a rank by default
(``cuda:0..N-1``, NCCL); ``devices=`` may repeat one (gloo: NCCL refuses
two ranks on one card), and ``device="cpu"`` runs every rank on the CPU
over gloo. Several processes follow the reference's multi-host rule:
every ``host_sync_every`` steps one collective carries the stop flag
(any rank's) and rank 0's time-cadence save verdict, so every rank
banks the same step. A checkpoint holds full leaves (gathered to rank
0), so any layout, or one device, resumes it.

Several hosts (``host_gang``): the gang manifests' ``COORDINATOR_ADDRESS``
(``host:port``, served by ``PROCESS_ID`` 0), ``NUM_PROCESSES`` (hosts,
default 1) and ``PROCESS_ID`` (this host, default 0), the reference's
contract. Each host runs ``layout.chips / NUM_PROCESSES`` ranks (its
first in the caller, the rest forked), global rank ``PROCESS_ID x local
+ local index``, so tp stays within a host; the ranks meet at a TCP
store at the coordinator, bounded by ``RANK_TIMEOUT_S`` as every
collective is, and pick the backend from every rank's published card
(NCCL only when no two ranks share one, so two "hosts" on one card run
gloo). ``train`` returns the loss on every host, each host logs its own
ranks' summaries and counts its share of the tokens. The checkpoint
directory must be one every host sees (rank 0 writes it). The
reference's other trigger, ``TPU_WORKER_HOSTNAMES``, names TPU hosts and
is ignored on a GPU host. An address without a port, a ``PROCESS_ID``
outside ``[0, NUM_PROCESSES)`` and a layout ``NUM_PROCESSES`` does not
divide are refused with a ValueError naming the variable; a layout the
model does not divide, or a schedule that does not compose with it, is
refused with the reference's message
(``models/transformer.py::check_layout``).
"""
import argparse
import functools
import json
import logging
import os
import signal
import sys
import threading
import time
from dataclasses import dataclass, fields
from typing import List, NamedTuple, Optional, Sequence

import torch

from nos_tpu_torch.device import DeviceLike, resolve_device
from nos_tpu_torch.parallel.layout import AXES, ParallelLayout

logger = logging.getLogger("nos_tpu_torch.trainer")

# under a layout: every collective's time limit, and how long the other
# ranks have to report once rank 0 is done (parallel/launch.py)
RANK_TIMEOUT_S = 600.0


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


class HostGang(NamedTuple):
    """This host's place in a multi-host run: the rendezvous
    (``host:port``), the number of hosts, this host's index, and the
    ranks each host runs."""
    address: str
    hosts: int
    host_id: int
    local: int

    @property
    def ranks(self) -> range:
        """This host's global ranks: ``host_id * local + local index``.
        Ranks lie over dp, fsdp, tp, pp, sp, ep (ep innermost), so a tp
        group stays on one host whenever ``local`` is a multiple of
        tp x pp x sp x ep."""
        return range(self.host_id * self.local,
                     (self.host_id + 1) * self.local)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} must be an integer") from None


def host_gang(layout: ParallelLayout) -> Optional[HostGang]:
    """The gang manifests' contract (the reference's
    ``_maybe_init_distributed``): ``COORDINATOR_ADDRESS`` (``host:port``,
    hosted by process 0), ``NUM_PROCESSES`` (hosts, default 1) and
    ``PROCESS_ID`` (this host, default 0). None without
    ``COORDINATOR_ADDRESS``, or with one host (the run is one host's).
    Raises a ValueError naming the variable for an address without a
    port, a ``PROCESS_ID`` outside ``[0, NUM_PROCESSES)``, and a layout
    whose chips ``NUM_PROCESSES`` does not divide."""
    address = os.environ.get("COORDINATOR_ADDRESS", "")
    if not address:
        return None
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit() or not 0 < int(port) < 65536:
        raise ValueError(f"COORDINATOR_ADDRESS={address!r} must be "
                         f"host:port, with a port in 1-65535")
    hosts = _env_int("NUM_PROCESSES", 1)
    host_id = _env_int("PROCESS_ID", 0)
    if hosts < 1:
        raise ValueError(f"NUM_PROCESSES={hosts} must be at least 1")
    if not 0 <= host_id < hosts:
        raise ValueError(f"PROCESS_ID={host_id} is outside [0, "
                         f"NUM_PROCESSES={hosts})")
    if layout.chips % hosts:
        raise ValueError(f"NUM_PROCESSES={hosts} does not divide the "
                         f"layout's {layout.chips} chips")
    if hosts == 1:
        return None
    return HostGang(address, hosts, host_id, layout.chips // hosts)


def layout_devices(layout: ParallelLayout, device: DeviceLike = None,
                   devices: Optional[Sequence[DeviceLike]] = None,
                   chips: Optional[int] = None) -> List[torch.device]:
    """Each of this host's ranks' device (``chips`` of them, default the
    layout's): ``devices`` as listed (a device may repeat), else every
    rank on the CPU for ``device="cpu"``, else one card a rank
    (``cuda:0..N-1``). Raises the reference's message when there are
    fewer devices than ranks."""
    chips = layout.chips if chips is None else chips
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    elif device is not None and torch.device(device).type == "cpu":
        devs = [torch.device("cpu")] * chips
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if chips > len(devs):
        raise ValueError(f"layout needs {chips} chips, only "
                         f"{len(devs)} devices")
    return devs[:chips]


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
          device: DeviceLike = None,
          devices: Optional[Sequence[DeviceLike]] = None) -> float:
    """Run the configured training job; returns the final loss (under a
    layout the mean over the data and sp ranks, which every rank holds).
    One device: ``device`` (the card by default; ``device="cpu"`` runs
    the plain PyTorch versions). A layout (``dp`` x ``fsdp`` x ``tp`` x
    ``pp`` x ``sp`` x ``ep`` > 1): one process a rank on
    ``layout_devices(layout, device, devices)``; under
    ``COORDINATOR_ADDRESS`` (``host_gang``) this host's ranks only,
    ``devices`` then listing this host's.

    ``stop_event`` requests a graceful early exit after the current step.
    When ``cfg.handle_sigterm`` is set and this is the main thread,
    SIGTERM sets it (the Kubernetes preemption contract): the step just
    completed is checkpointed and the loop exits. Under a layout the
    ranks agree on the stop every ``host_sync_every`` steps, which needs
    ``handle_sigterm``.

    With ``cfg.profile_dir`` a torch.profiler trace covers the
    ``profile_steps`` steps from the first at or past ``profile_start``
    (so a run resumed past it still traces), and is stopped and written
    on every exit path (rank 0's, under a layout)."""
    from nos_tpu_torch.models.transformer import check_layout
    from nos_tpu_torch.parallel.launch import run_ranks
    from nos_tpu_torch.parallel.mesh import mesh_backend

    layout = _layout(cfg)
    gang = host_gang(layout)
    if layout.chips == 1:
        device = resolve_device(device if devices is None else devices[0])
        return _run(cfg, stop_event, device, None)["loss"]
    check_layout(_model_config(cfg), layout, cfg.batch_size, cfg.seq_len,
                 cfg.n_microbatches, cfg.pipeline_schedule,
                 cfg.virtual_stages)
    if stop_event is not None and not cfg.handle_sigterm:
        raise ValueError(
            "stop_event on a multi-host run requires handle_sigterm: true "
            "— without the per-step flag agreement an early breaker "
            "deadlocks the gang's collectives")
    local = layout.chips if gang is None else gang.local
    devs = layout_devices(layout, device, devices, local)
    if cfg.checkpoint_dir:
        from nos_tpu_torch.train.checkpoint import (
            CheckpointManager, model_arch_dict,
        )

        # a config drifted from the directory's stamp fails here, by
        # field name, before any rank starts (rank 0 raising alone would
        # leave the others waiting for it)
        mgr = CheckpointManager(cfg.checkpoint_dir)
        try:
            mgr.validate_model_config(model_arch_dict(cfg))
        finally:
            mgr.close()
    names = [str(d) for d in devs]
    shared = len(set(names)) < len(names)
    axes = " ".join(f"{a}={getattr(layout, a)}" for a in AXES)
    if gang is None:
        where = (f"{layout.chips} ranks on {names}, backend "
                 f"{mesh_backend(devs)}"
                 + (" (ranks share a device; NCCL takes one rank a "
                    "device)" if shared and devs[0].type == "cuda" else ""))
        ranks, store, hosts = None, None, 1
    else:
        where = (f"host {gang.host_id} of {gang.hosts} (rendezvous "
                 f"{gang.address}): ranks {gang.ranks.start}-"
                 f"{gang.ranks.stop - 1} of {layout.chips} on {names}, "
                 f"the backend agreed at the rendezvous")
        # every host's ranks index one gang-wide list; a rank reads its
        # own entry only
        names = names * gang.hosts
        ranks, store = gang.ranks, f"tcp://{gang.address}"
        hosts = gang.hosts
    msg = (f"layout {axes}"
           + (f" ({cfg.sp_strategy})" if layout.sp > 1 else "")
           + (f" ({cfg.pipeline_schedule}, {cfg.n_microbatches} "
              f"microbatches"
              + (f", {cfg.virtual_stages} virtual stages"
                 if cfg.pipeline_schedule == "interleaved" else "") + ")"
              if layout.pp > 1 else "")
           + f": {where}")
    logger.info(msg)
    print(f"nos_tpu_torch.trainer: {msg}", file=sys.stderr, flush=True)
    if devs[0].type == "cuda":
        from nos_tpu_torch.ops import _kernels

        # built once, here: the other ranks load the libraries
        _kernels.build_all()
    first = ranks[0] if ranks is not None else 0
    out = run_ranks(
        lambda store: _rank(first, store, cfg, names, RANK_TIMEOUT_S,
                            hosts, stop_event),
        _rank, (cfg, names, RANK_TIMEOUT_S, hosts), layout.chips,
        RANK_TIMEOUT_S, ranks=ranks, store=store)
    # this host's ranks (all of them on one host)
    for r in out:
        logger.info("rank %d of %d on %s (pp index %d): steps %d-%d, loss "
                    "%.6f, peak device memory %d bytes, params and moments "
                    "%d bytes, kernel launches %s, flash launches by shape "
                    "%s", r["rank"], layout.chips, r["device"],
                    r["pp_index"], r["first_step"], r["last_step"],
                    r["loss"], r["peak_bytes"], r["state_bytes"],
                    r["launches"], r["flash_launches_by_shape"],
                    extra={"rank_summary": r})
    return out[0]["loss"]


def _rank(rank: int, store: str, cfg: TrainerConfig, devices: List[str],
          timeout_s: float, hosts: int = 1,
          stop_event: Optional[threading.Event] = None) -> dict:
    """One rank of a layout (``devices`` by global rank; ``hosts`` the
    run's hosts): join its process group, train, leave the group on
    every exit path; returns ``_run``'s summary."""
    import torch.distributed as dist

    from nos_tpu_torch.parallel.mesh import init_train_mesh

    layout = _layout(cfg)
    # joining a group wraps sys.excepthook (torch prefixes tracebacks
    # with the rank) and leaving it does not unwrap: rank 0 is the
    # caller's process, which a later train() finds as it was
    hook = sys.excepthook
    try:
        mesh = init_train_mesh(layout, rank, devices, store, timeout_s)
        return _run(cfg, stop_event, mesh.device, mesh, hosts)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        sys.excepthook = hook


def _layout(cfg: TrainerConfig) -> ParallelLayout:
    return ParallelLayout(**{a: getattr(cfg, a) for a in AXES})


def _model_config(cfg: TrainerConfig):
    from nos_tpu_torch.models import transformer as tfm

    return tfm.TransformerConfig(
        vocab=cfg.vocab, d_model=cfg.d_model, n_layers=cfg.n_layers,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
        max_seq=cfg.max_seq, n_experts=cfg.n_experts,
        sp_strategy=cfg.sp_strategy, remat_policy=cfg.remat_policy,
        loss_chunk=cfg.loss_chunk,
        dtype=torch.bfloat16 if cfg.bf16 else torch.float32)


def _tree(names: List[str], leaves: list) -> dict:
    """``param_leaves``' leaves back into the params dict by their
    ``leaf_names``."""
    out: dict = {}
    for name, leaf in zip(names, leaves):
        *path, key = name.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[key] = leaf
    return out


def _run(cfg: TrainerConfig, stop_event: Optional[threading.Event],
         device: torch.device, mesh, hosts: int = 1) -> dict:
    """The training loop of one device, or of one rank of ``mesh`` (a
    ``TrainMesh``). Returns a summary: rank, device, pp index, the
    first and last steps, the final loss, peak device memory, the bytes
    of this rank's params and moments, the training kernels' launches
    in this process (the flash kernels' also by shape) and under pp the
    last step's schedule stats (``Pipeline.stats``)."""
    from nos_tpu_torch.models import transformer as tfm
    from nos_tpu_torch.ops import _kernels
    from nos_tpu_torch.train.data import (
        TokenDataset, prefetch_to_device, to_device,
    )
    from nos_tpu_torch.train.optim import build_optimizer
    from nos_tpu_torch.utils.metrics import default_registry

    model_cfg = _model_config(cfg)
    rank0 = mesh is None or mesh.rank == 0
    pipelined = mesh is not None and mesh.pp > 1
    params = tfm.init_params(
        model_cfg, torch.Generator(device).manual_seed(cfg.seed), device)
    if pipelined and cfg.pipeline_schedule == "interleaved":
        from nos_tpu_torch.parallel.pipeline import interleave_params

        # chunk-major layer order: the interleaved schedule's params
        # layout (checkpoints store this order too, stamped as
        # layer_order so a schedule drift fails by name)
        params = interleave_params(params, cfg.pp, cfg.virtual_stages)
    names = tfm.leaf_names(params)
    splits = None
    if mesh is not None:
        splits = tfm.leaf_splits(params, mesh)
        params = tfm.rank_params(params, mesh)
    leaves = tfm.param_leaves(params)
    for p in leaves:
        p.requires_grad_()
    optimizer = build_optimizer(
        leaves, cfg.learning_rate, cfg.steps,
        warmup_steps=cfg.warmup_steps, schedule=cfg.lr_schedule,
        min_lr_ratio=cfg.min_lr_ratio, weight_decay=cfg.weight_decay,
        b1=cfg.adam_b1, b2=cfg.adam_b2, grad_clip=cfg.grad_clip,
        accum_steps=cfg.accum_steps,
        shard_sums=(functools.partial(mesh.shard_sums, splits=splits)
                    if mesh is not None else None))

    # a leaf's (tp, fsdp, ep, pp) axes by its checkpoint name: params
    # and moments
    axes = {}
    if mesh is not None:
        for i, (name, split) in enumerate(zip(names, splits)):
            axes[f"params/{name}"] = split
            for key in ("mu", "nu", "acc"):
                axes[f"opt_state/{key}/{i}"] = split

    def part(name: str, full: torch.Tensor) -> torch.Tensor:
        return mesh.local_part(full, *axes[name]) if name in axes else full

    ckpt = None
    start_step = 0
    if cfg.checkpoint_dir:
        from nos_tpu_torch.train.checkpoint import (
            CheckpointManager, model_arch_dict,
        )

        if rank0:
            ckpt = CheckpointManager(cfg.checkpoint_dir)
            # stamp (or, on resume, validate against) the architecture so
            # a config drift between runs fails by field name, not shape
            # error
            ckpt.write_model_config(model_arch_dict(cfg))
        if mesh is not None:
            # rank 0's manager has cleared any save a crash cut short
            mesh.barrier()
            if not rank0:
                ckpt = CheckpointManager(cfg.checkpoint_dir)
        latest = ckpt.latest()
        if latest is not None:
            # into the live leaves and moments, in place (a rank: its
            # part of each full leaf)
            _, opt_state = ckpt.restore(
                latest, params_template=params,
                opt_state_template=optimizer.state_dict(),
                part=part if mesh is not None else None)
            optimizer.load_state_dict(opt_state)
            start_step = latest
            logger.info("resumed from checkpoint step %d", latest)
    if pipelined:
        from nos_tpu_torch.parallel.pipeline import make_pipeline_train_step

        step_fn = make_pipeline_train_step(
            model_cfg, optimizer, mesh, cfg.n_microbatches,
            cfg.pipeline_schedule, cfg.virtual_stages)

        def eval_loss(batch: dict) -> torch.Tensor:
            # the schedule's forward only (the mean over the token ranks)
            return step_fn.pipeline.loss(params, batch)
    else:
        step_fn = tfm.make_train_step(model_cfg, optimizer, mesh)

        def eval_loss(batch: dict) -> torch.Tensor:
            e = tfm.loss_fn(params, model_cfg, batch, mesh)
            return e if mesh is None else mesh.token_mean(e)

    def save(step: int, wait: bool = True) -> None:
        if mesh is None:
            # async: the copy overlaps the next step's forward and
            # backward; its update waits for the copy on the device
            optimizer.fence(ckpt.save(step, params, optimizer.state_dict(),
                                      wait=wait))
            return
        # a collective: every leaf whole, on rank 0's host, which writes
        # the one-device format (synchronously: the copies are its own)
        def whole(i: int, t: torch.Tensor):
            full = mesh.full_leaf(t.detach(), *splits[i])
            return full.cpu() if rank0 else None

        state = optimizer.state_dict()
        full_state = {k: ([whole(i, t) for i, t in enumerate(v)]
                          if isinstance(v, list) else v)
                      for k, v in state.items()}
        full_params = _tree(names, [whole(i, t)
                                    for i, t in enumerate(leaves)])
        if rank0:
            ckpt.save(step, full_params, full_state)

    dataset = None
    if cfg.data_path:
        dataset = TokenDataset(cfg.data_path, cfg.seq_len, seed=cfg.seed + 1)
        logger.info("dataset: %d shards, %d tokens",
                    len(dataset.paths), dataset.n_tokens)
    eval_dataset = eval_batches = None
    if cfg.eval_every > 0 and cfg.eval_data_path:
        eval_dataset = TokenDataset(cfg.eval_data_path, cfg.seq_len,
                                    seed=cfg.seed + 2)

    def rows(batch: dict) -> dict:
        # a rank keeps its data rows of the global batch (the reference's
        # data_sharding: dp outer, fsdp inner; under pp its share of each
        # microbatch's rows) and their sequence chunk over sp (the
        # targets were shifted on the whole row)
        if mesh is None:
            return batch
        s = cfg.seq_len // mesh.sp
        if pipelined:
            from nos_tpu_torch.parallel.pipeline import microbatch_rows

            idx = microbatch_rows(cfg.batch_size, cfg.n_microbatches,
                                  mesh.data_size, mesh.data_index)
            return {k: v[idx.to(v.device), mesh.sp_index * s:
                         (mesh.sp_index + 1) * s]
                    for k, v in batch.items()}
        n = cfg.batch_size // mesh.data_size
        return {k: v[mesh.data_index * n:(mesh.data_index + 1) * n,
                     mesh.sp_index * s:(mesh.sp_index + 1) * s]
                for k, v in batch.items()}

    def batch_for(step: int) -> dict:
        # a pure function of (seed, step), so a resumed run replays the
        # stream an uninterrupted one would have seen
        if dataset is not None:
            return rows(dataset.batch(step, cfg.batch_size))
        return rows(synthetic_batch(cfg, step, device))

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
    done = start_step
    prof = None
    profiled = not (rank0 and cfg.profile_dir and cfg.profile_steps > 0)
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

    def due_by_clock() -> bool:
        return (ckpt is not None and cfg.checkpoint_every_s > 0
                and time.perf_counter() - last_save_t
                >= cfg.checkpoint_every_s)

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
            done = step + 1
            m_steps.inc()
            # this host's share of the global batch, so a sum over a
            # gang's pods reads the global throughput (the reference's)
            m_tokens.inc(cfg.batch_size * cfg.seq_len / hosts)
            if prof is not None and step + 1 >= profile_end:
                _stop_profile(prof, cfg, profile_first, step + 1, device)
                prof = None
            # the next batch goes on the stream behind this step, before
            # the host waits for its loss
            batch = next(batches, None)
            due_by_time = None      # one device: read after eval
            if mesh is None:
                stop_now = stop.is_set()
            else:
                # the ranks agree on a step-keyed cadence: one collective
                # carries any rank's stop flag and rank 0's clock verdict
                # (clocks differ, so rank 0 arbitrates)
                stop_now = due_by_time = False
                sync_now = ((step + 1) % max(cfg.host_sync_every, 1) == 0
                            or step + 1 == cfg.steps)
                if sync_now and (cfg.handle_sigterm or (
                        ckpt is not None and cfg.checkpoint_every_s > 0)):
                    flags = mesh.flags([
                        float(cfg.handle_sigterm and stop.is_set()),
                        float(rank0 and due_by_clock())])
                    stop_now, due_by_time = flags[0] > 0, flags[1] > 0
            if stop_now:
                # preemption: bank the step just completed (synchronous:
                # the grace period is short, so before eval and the
                # periodic save) under its true count, so a resume
                # replays the stream an uninterrupted run would see
                preempted = True
                loss = float(loss_t)
                if ckpt is not None and last_saved != step + 1:
                    save(step + 1)
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
                    eval_batches = [put(rows(eval_dataset.batch(
                        i, cfg.batch_size))) for i in range(cfg.eval_steps)]
                with torch.no_grad():
                    losses = [float(eval_loss(eb)) for eb in eval_batches]
                mean = sum(losses) / len(losses)
                g_eval.set(mean)
                logger.info("step %d eval loss %.4f (%d batches)", step + 1,
                            mean, cfg.eval_steps)
            if due_by_time is None:
                due_by_time = due_by_clock()
            if ckpt is not None and (
                    (step + 1) % cfg.checkpoint_every == 0 or due_by_time):
                save(step + 1, wait=False)
                last_saved = step + 1
                last_save_t = time.perf_counter()
                m_saves.inc()
        # final save only when steps ran to the configured end (a restart
        # whose restored step already meets cfg.steps must not relabel
        # old state, and a preempted exit must not label partial
        # progress as cfg.steps); finally fences and closes
        if ckpt is not None and not preempted and start_step < cfg.steps \
                and last_saved != cfg.steps:
            save(cfg.steps)
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
    state = leaves + [t for k in ("mu", "nu", "acc")
                      for t in optimizer.state_dict().get(k, ())]
    return {"rank": 0 if mesh is None else mesh.rank, "device": str(device),
            "pp_index": 0 if mesh is None else mesh.pp_index,
            "pipeline": (dict(step_fn.pipeline.stats) if pipelined
                         else None),
            "first_step": start_step, "last_step": done, "loss": loss,
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else 0),
            "state_bytes": sum(t.numel() * t.element_size() for t in state),
            "launches": {k.symbol[4:]: k.launches for k in (
                _kernels.flash_fwd, _kernels.flash_bwd_pre,
                _kernels.flash_bwd_dkdv, _kernels.flash_bwd_dq,
                _kernels.adamw)},
            "flash_launches_by_shape": {
                k.symbol[4:]: dict(k.launches_by_shape) for k in (
                    _kernels.flash_fwd, _kernels.flash_bwd_pre,
                    _kernels.flash_bwd_dkdv, _kernels.flash_bwd_dq)}}


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
