"""Checkpoint / resume for the training plane (port of
``nos_tpu/train/checkpoint.py``, one process).

A training job that is preempted or rescheduled resumes from its last
committed step, and the serving entry points load a trained model from
the same directory. The reference writes orbax, which the port does not
use, so the format is the port's own behind the reference's API:

- ``<directory>/<step>/`` holds one raw file per leaf (``00000.bin``,
  ..., the tensor's bytes in order; bf16 as its 16 bits, as
  ``models/handoff.py`` carries it) and ``index.json``: the format, the
  step, and per leaf its name (``params/layers/wq``,
  ``opt_state/mu/3``), file, shape and dtype;
- a step is written under ``<step>.partial-<pid>``, each file synced,
  and renamed into place when complete: a step directory exists only
  once committed, and a crash mid-save leaves the previous step (a
  manager opening the directory removes stale partial ones);
- integer-named directories are what orbax's ``checkpoint_steps``
  lists, so the reference's ``latest_step`` reads this directory to the
  same step;
- ``model_config.json`` is the reference's architecture stamp, the same
  JSON.

A save snapshots every leaf into host memory first: 256 MiB slabs,
pinned when the leaves are on the card. With ``wait=False`` the copies
run on a side stream and ``save`` returns their event at once; the
caller's in-place writer waits for it on the device
(``TrainOptimizer.fence``), so the next step's forward and backward
overlap the copy, and a writer thread puts the files on disk. One save
is in flight at a time (the next ``save`` waits for it, as orbax's
does), so the host holds one snapshot: the state's bytes rounded up to
a slab, kept for the manager's life and released by ``close``.

Under a training layout a step is still one file per full leaf: the
trainer gathers every leaf to rank 0, which writes the format above (so
a one-device run and ``cmd/generate.py::load_params`` read it), and on
restore every rank reads each leaf and keeps its part (``restore``'s
``part``), whatever layout wrote it.

Object storage (a ``://`` directory) needs etils and gcsfs, which the
port does not use: it is refused with a ValueError naming it.
"""
from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from nos_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["model_arch_dict", "latest_step", "CheckpointManager"]

# (leaf name, full leaf) -> the part a rank keeps
Part = Callable[[str, torch.Tensor], torch.Tensor]

logger = logging.getLogger("nos_tpu_torch.checkpoint")

FORMAT = "nos_tpu_torch.checkpoint/1"
INDEX = "index.json"
_PARTIAL = ".partial-"
SLAB_BYTES = 256 << 20
# files written at once by a save's writer
WRITERS = 4

_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
           torch.float16: "float16", torch.float64: "float64",
           torch.int64: "int64", torch.int32: "int32", torch.int8: "int8",
           torch.uint8: "uint8", torch.bool: "bool"}
_BY_NAME = {v: k for k, v in _DTYPES.items()}


def _local(directory: str) -> str:
    if "://" in directory:
        raise ValueError(
            f"checkpoint directory {directory!r}: object storage (a :// "
            f"URI) is not ported; the torch port reads and writes local "
            f"directories only")
    return os.path.abspath(directory)


def model_arch_dict(cfg) -> dict:
    """The architecture fields stamped beside checkpoints
    (``model_config.json``) — only fields that determine PARAMETER
    SHAPES, so a stamp mismatch always means an un-restorable
    checkpoint (``max_seq`` is deliberately absent: it only feeds RoPE
    at apply time, and longer-context serving of an existing checkpoint
    is legitimate). ``n_kv_heads`` is normalized the way
    TransformerConfig reads it (0 means n_heads)."""
    out = {
        "vocab": cfg.vocab, "d_model": cfg.d_model,
        "n_layers": cfg.n_layers, "n_heads": cfg.n_heads,
        "n_kv_heads": cfg.n_kv_heads or cfg.n_heads,
        "d_ff": cfg.d_ff, "n_experts": cfg.n_experts,
        # layer ORDER in the stacked layer dim: the interleaved pipeline
        # schedule stores params chunk-major; resuming such a checkpoint
        # under a different schedule would silently train with permuted
        # layers, so the order is part of the stamp. Always present: an
        # absent key on either side would skip the comparison entirely.
        "layer_order": "canonical",
    }
    if getattr(cfg, "pipeline_schedule", "") == "interleaved" \
            and getattr(cfg, "pp", 1) > 1:
        out["layer_order"] = (
            f"interleaved:pp={cfg.pp},v={getattr(cfg, 'virtual_stages', 2)}")
    return out


def _steps(directory: str) -> List[int]:
    """Committed steps under ``directory``, ascending."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    return sorted(int(n) for n in names
                  if n.isdigit() and os.path.isdir(os.path.join(directory,
                                                                n)))


def latest_step(directory: str) -> Optional[int]:
    """The last committed step under ``directory`` without constructing a
    manager, cheap enough to poll. None when nothing is committed (or
    the directory does not exist yet)."""
    steps = _steps(_local(directory))
    return steps[-1] if steps else None


def _flatten(tree: Any, prefix: str, out: list) -> list:
    """(name, leaf) pairs in a fixed order: dict keys sorted, list and
    tuple items by index, names joined by ``/``."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            _flatten(tree[key], f"{prefix}/{key}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    else:
        out.append((prefix, tree))
    return out


def _rebuild(tree: Any, prefix: str, leaf_fn) -> Any:
    """``tree``'s structure with each leaf replaced by ``leaf_fn(name,
    leaf)``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, f"{prefix}/{k}", leaf_fn)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, f"{prefix}/{i}", leaf_fn)
                          for i, v in enumerate(tree))
    return leaf_fn(prefix, tree)


def _as_tensor(leaf: Any) -> torch.Tensor:
    """A leaf as a tensor: a Python number (the optimizer's counts)
    becomes a 0-d CPU one."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.as_tensor(leaf)


class _Snapshot:
    """Host slabs holding one save's leaves back to back, reused from save
    to save; pinned for copies from the card."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.slabs: List[torch.Tensor] = []

    def reserve(self, nbytes: int) -> None:
        have = sum(s.numel() for s in self.slabs)
        while have < nbytes:
            size = min(SLAB_BYTES, max(nbytes - have, 1))
            self.slabs.append(torch.empty((size,), dtype=torch.uint8,
                                          pin_memory=self.pinned))
            have += size

    def segments(self, offset: int, nbytes: int):
        """(slab, start, end) pieces of the byte range [offset, offset +
        nbytes), in order."""
        for slab in self.slabs:
            n = slab.numel()
            if offset < n and nbytes > 0:
                take = min(n - offset, nbytes)
                yield slab, offset, offset + take
                nbytes -= take
                offset = 0
            else:
                offset -= n


class CheckpointManager:
    """Step-numbered train-state checkpoints under one directory."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        # a relative directory (a pod spec's ``checkpoint_dir: ckpt``) is
        # absolutized up front, as the reference's
        self.directory = _local(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        for name in os.listdir(self.directory):
            if _PARTIAL in name:        # a save a crash cut short
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
        self._writer = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="nos-ckpt")
        self._pending: Optional[concurrent.futures.Future] = None
        self._snapshot: Optional[_Snapshot] = None
        self._stream = None

    # ------------------------------------------------------------------
    def save(self, step: int, params: Any, opt_state: Any,
             wait: bool = True) -> Optional["torch.cuda.Event"]:
        """Persist train state at ``step``. With ``wait=False`` the leaves
        are copied to host memory on a side stream and written by a
        background thread; the returned event (None for leaves on the
        CPU, whose copy is done on return) completes when the copy has
        read every leaf, and a caller that updates them in place must
        make its stream wait for it first (``TrainOptimizer.fence``). A
        crash before the commit resumes from the previous step.
        ``wait_until_finished`` / ``close`` fence the in-flight save."""
        t0 = time.perf_counter()
        self.wait_until_finished()
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):
            raise ValueError(
                f"checkpoint step {step} already exists under "
                f"{self.directory}")
        leaves = [(name, _as_tensor(leaf)) for name, leaf in
                  _flatten({"params": params, "opt_state": opt_state}, "",
                           [])]
        leaves = [(name[1:], t) for name, t in leaves]
        on_card = [t.device for _, t in leaves if t.device.type == "cuda"]
        if self._snapshot is None:
            self._snapshot = _Snapshot(pinned=bool(on_card))
        snap = self._snapshot
        entries, offset = [], 0
        for i, (name, t) in enumerate(leaves):
            nbytes = t.numel() * t.element_size()
            entries.append({"name": name, "file": f"{i:05d}.bin",
                            "shape": list(t.shape),
                            "dtype": _DTYPES[t.dtype], "offset": offset,
                            "nbytes": nbytes})
            offset += nbytes
        snap.reserve(offset)
        event = None
        if on_card:
            device = on_card[0]
            if self._stream is None:
                self._stream = torch.cuda.Stream(device)
            self._stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(self._stream):
                self._copy_in(leaves, entries, snap)
                event = torch.cuda.Event()
                event.record(self._stream)
        else:
            self._copy_in(leaves, entries, snap)
        # the host's stall: all of a synchronous save, this much of an
        # asynchronous one
        stall = None if wait else time.perf_counter() - t0
        self._pending = self._writer.submit(
            self._commit, step, entries, snap, event, t0, stall)
        if wait:
            self.wait_until_finished()
        return None if wait else event

    @staticmethod
    def _copy_in(leaves, entries, snap: _Snapshot) -> None:
        for (_, t), e in zip(leaves, entries):
            src = t.contiguous().reshape(-1).view(torch.uint8)
            done = 0
            for slab, a, b in snap.segments(e["offset"], e["nbytes"]):
                slab[a:b].copy_(src[done:done + b - a], non_blocking=True)
                done += b - a

    def _commit(self, step: int, entries: list, snap: _Snapshot, event,
                t0: float, stall: Optional[float]) -> None:
        """The writer thread's half of a save: wait for the copies, write
        and sync every file under the partial name, rename into place,
        prune to ``max_to_keep``."""
        if event is not None:
            event.synchronize()
        snapshot_s = time.perf_counter() - t0
        tmp = os.path.join(self.directory,
                           f"{step}{_PARTIAL}{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)

        def write(e: dict) -> None:
            with open(os.path.join(tmp, e["file"]), "wb") as f:
                for slab, a, b in snap.segments(e["offset"], e["nbytes"]):
                    f.write(memoryview(slab.numpy()[a:b]))
                f.flush()
                os.fsync(f.fileno())

        with concurrent.futures.ThreadPoolExecutor(WRITERS) as pool:
            list(pool.map(write, entries))
        index = {"format": FORMAT, "step": step,
                 "leaves": [{k: e[k] for k in ("name", "file", "shape",
                                               "dtype")} for e in entries]}
        with open(os.path.join(tmp, INDEX), "w") as f:
            json.dump(index, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, os.path.join(self.directory, str(step)))
        self._sync_dir()
        for old in _steps(self.directory)[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)
        seconds = time.perf_counter() - t0
        logger.info("saved checkpoint step %d: %d bytes in %.3f s (host "
                    "stall %.3f s, snapshot %.3f s)", step,
                    sum(e["nbytes"] for e in entries), seconds,
                    seconds if stall is None else stall, snapshot_s)

    def _sync_dir(self) -> None:
        fd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def wait_until_finished(self) -> None:
        """Block until the in-flight save (if any) is committed; raise
        its error if it failed."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def wait_within(self, timeout_s: float) -> bool:
        """Budget-bounded fence for an in-flight async save: True when the
        background commit finished inside ``timeout_s`` (a training job
        told to bank progress waits only as long as its checkpoint
        budget)."""
        pending = self._pending
        if pending is None:
            return True
        concurrent.futures.wait([pending], timeout=max(0.0, timeout_s))
        return pending.done()

    # ------------------------------------------------------------------
    # model-config stamp: architecture dims written next to the step
    # checkpoints so a consumer (generate/server/resume) mismatching the
    # saved shapes fails with a named field, not a shape error.

    def _stamp_path(self) -> str:
        return os.path.join(self.directory, "model_config.json")

    def write_model_config(self, config: dict) -> None:
        """Idempotently stamp the architecture. Raises if a DIFFERENT
        architecture is already stamped AND checkpoints exist — resuming
        a run with changed dims corrupts it silently otherwise. A stale
        stamp with no checkpoint behind it (aborted mis-configured
        launch) is simply replaced, not a dead-end."""
        path = self._stamp_path()
        if os.path.exists(path):
            if self.latest() is not None:
                self.validate_model_config(config)
                return
            # no checkpoint to protect: fall through and restamp
        elif self.latest() is not None:
            # pre-stamp-era checkpoints with unknown architecture: the
            # caller's dims are exactly what we CAN'T trust (a drifted
            # relaunch would poison the stamp and then blame the
            # corrected config). Leave unstamped; restore still fails on
            # the shapes.
            return
        body = json.dumps(config, indent=1, sort_keys=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(body)
        os.replace(tmp, path)

    def read_model_config(self) -> Optional[dict]:
        path = self._stamp_path()
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def validate_model_config(self, expect: dict) -> None:
        """No-op when unstamped; raises naming every mismatched field
        when the stamp disagrees with ``expect``."""
        have = self.read_model_config()
        if have is None:
            return
        have = dict(have)
        # stamps from before the layer_order field are all canonical-order
        # checkpoints: defaulting (rather than skipping the absent key)
        # keeps the drift guard closed
        if "layer_order" in expect:
            have.setdefault("layer_order", "canonical")
        bad = {k: (have[k], expect[k])
               for k in expect if k in have and have[k] != expect[k]}
        if bad:
            detail = ", ".join(
                f"{k}: checkpoint has {h}, caller expects {e}"
                for k, (h, e) in sorted(bad.items()))
            raise ValueError(
                f"model config mismatch under {self.directory}: {detail}")

    def latest(self) -> Optional[int]:
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return _steps(self.directory)

    # ------------------------------------------------------------------
    def restore(self, step: Optional[int] = None, *, params_template: Any,
                opt_state_template: Any, device: DeviceLike = None,
                part: Optional[Part] = None) -> Tuple[Any, Any]:
        """Restore (params, opt_state) in the templates' structure. A
        template leaf that is a tensor with storage is filled IN PLACE
        (the trainer's live params and moments) and returned; one on the
        meta device (``transformer.abstract_params``) becomes a new
        tensor on ``device`` (default: the card) with its dtype; a
        Python number becomes the stored number. ``part(name, leaf)``,
        when given, cuts each full leaf read to what the template holds
        (a layout's rank: its part). The index is read, and every shape
        checked, before any array."""
        step = self._resolve(step)
        index = self._index(step)
        self._check_template_shapes(step, index, part,
                                    params=params_template,
                                    opt_state=opt_state_template)
        out = self._load(step, index, {"params": params_template,
                                       "opt_state": opt_state_template},
                         device, part)
        return out["params"], out["opt_state"]

    def restore_params(self, step: Optional[int] = None, *,
                       params_template: Any, device: DeviceLike = None):
        """Params-only restore — what inference consumers
        (cmd/generate.py, cmd/server.py) need; the optimizer state on
        disk is ignored. Same template semantics as :meth:`restore`: a
        meta template places the leaves on the device one at a time,
        with no random init before."""
        step = self._resolve(step)
        index = self._index(step)
        self._check_template_shapes(step, index, None,
                                    params=params_template)
        return self._load(step, index, {"params": params_template},
                          device, None)["params"]

    def _resolve(self, step: Optional[int]) -> int:
        if step is None:
            step = self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return step

    def _index(self, step: int) -> Dict[str, dict]:
        with open(os.path.join(self.directory, str(step), INDEX)) as f:
            index = json.load(f)
        if index.get("format") != FORMAT:
            raise ValueError(
                f"checkpoint under {self.directory} step {step}: format "
                f"{index.get('format')!r}, expected {FORMAT!r}")
        return {e["name"]: e for e in index["leaves"]}

    def _check_template_shapes(self, step: int, index: Dict[str, dict],
                               part: Optional[Part], **templates: Any
                               ) -> None:
        """Refuse a restore whose template shapes disagree with what is
        on disk (cut by ``part``), naming every mismatched leaf; a
        template leaf the step does not hold is named too."""
        bad, missing = [], []
        for item, template in templates.items():
            for name, leaf in _flatten(template, item, []):
                entry = index.get(name)
                if entry is None:
                    missing.append(name)
                    continue
                want = tuple(getattr(leaf, "shape", ()))
                have = tuple(entry["shape"])
                if part is not None:
                    have = tuple(part(name, torch.empty(
                        have, device="meta")).shape)
                if have != want:
                    bad.append(f"{name}: checkpoint has "
                               f"{have}, caller expects {want}")
        if bad:
            raise ValueError(
                f"checkpoint shape mismatch under {self.directory} step "
                f"{step}: " + "; ".join(sorted(bad)))
        if missing:
            raise ValueError(
                f"checkpoint under {self.directory} step {step} holds no "
                f"leaf " + ", ".join(sorted(missing)))

    def _load(self, step: int, index: Dict[str, dict], templates: dict,
              device: DeviceLike, part: Optional[Part]) -> dict:
        t0 = time.perf_counter()
        root = os.path.join(self.directory, str(step))
        target = None
        nbytes = 0

        def read(name: str, leaf: Any):
            nonlocal target, nbytes
            e = index[name]
            raw = np.fromfile(os.path.join(root, e["file"]), dtype=np.uint8)
            nbytes += raw.size
            t = torch.from_numpy(raw).view(_BY_NAME[e["dtype"]]).reshape(
                e["shape"])
            if not isinstance(leaf, torch.Tensor):
                return type(leaf)(t.item())
            if part is not None:
                t = part(name, t)
            if leaf.device.type == "meta":
                if target is None:
                    target = resolve_device(device)
                return t.to(device=target, dtype=leaf.dtype)
            with torch.no_grad():
                leaf.copy_(t)
            return leaf

        out = {item: _rebuild(tree, item, read)
               for item, tree in templates.items()}
        seconds = time.perf_counter() - t0
        logger.info("restored checkpoint step %d: %d bytes in %.3f s", step,
                    nbytes, seconds)
        return out

    def close(self) -> None:
        """Fence any in-flight save, stop the writer, release the
        snapshot's host memory."""
        try:
            self.wait_until_finished()
        finally:
            self._writer.shutdown(wait=True)
            self._snapshot = None
