"""Input pipeline (a copy of ``nos_tpu/train/data.py``, numpy only):
memory-mapped token shards -> device batches.

- **Stateless, resumable sampling.** The batch for step N is a pure
  function of (seed, step) via counter-based Philox randomness, so the
  same shards give the same batches as the reference, bit for bit.
- **Memory-mapped shards.** Token files are flat little-endian arrays
  (dtype in ``meta.json``, default uint32) read through ``np.memmap``.
- **Per-process slicing.** ``batch(..., process_index, process_count)``
  hands each process only its rows of the global batch.
- **Device prefetch.** ``prefetch_to_device`` keeps ``depth`` batches in
  flight from a background thread; ``to_device`` stages host arrays
  through pinned memory with ``non_blocking`` copies on the card.
"""
from __future__ import annotations

import glob
import json
import os
import threading
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np

import torch

__all__ = ["TokenDataset", "prefetch_to_device", "to_device",
           "write_token_shards"]


class TokenDataset:
    """Deterministic LM batches from memory-mapped token shards.

    ``paths`` is a list of .bin files or a glob pattern. Each batch row is
    a length ``seq_len + 1`` window at a Philox-sampled offset; tokens =
    window[:-1], targets = window[1:] (true next-token prediction, unlike
    the trainer's synthetic roll)."""

    def __init__(self, paths, seq_len: int, *, dtype=None, seed: int = 0):
        if isinstance(paths, str):
            found = sorted(glob.glob(paths))
            if not found:
                raise FileNotFoundError(f"no token shards match {paths!r}")
            paths = found
        self.paths = list(paths)
        self.seq_len = int(seq_len)
        self.seed = int(seed)
        if dtype is None:
            dtype = np.uint32
            meta = os.path.join(os.path.dirname(self.paths[0]), "meta.json")
            if os.path.exists(meta):
                with open(meta) as f:
                    dtype = np.dtype(json.load(f).get("dtype", "uint32"))
        self._shards = [np.memmap(p, dtype=dtype, mode="r")
                        for p in self.paths]
        win = self.seq_len + 1
        # number of valid window start offsets: size - win + 1 (a shard of
        # exactly win tokens holds exactly one window)
        self._usable = np.array(
            [max(0, s.shape[0] - win + 1) for s in self._shards], np.int64)
        if self._usable.sum() == 0:
            raise ValueError(
                f"no shard holds a full window of {win} tokens")
        # windows are addressed by a global offset into the usable ranges
        self._cum = np.concatenate([[0], np.cumsum(self._usable)])

    @property
    def n_tokens(self) -> int:
        return int(sum(s.shape[0] for s in self._shards))

    def _window(self, global_off: int) -> np.ndarray:
        shard = int(np.searchsorted(self._cum, global_off, "right") - 1)
        off = int(global_off - self._cum[shard])
        return np.asarray(
            self._shards[shard][off:off + self.seq_len + 1], np.int32)

    def batch(
        self,
        step: int,
        batch_size: int,
        *,
        process_index: int = 0,
        process_count: int = 1,
    ) -> Dict[str, np.ndarray]:
        """The (deterministic) batch for ``step``. With multi-host args,
        returns only this process's rows of the global batch — row r goes
        to process r % process_count — so all processes together hold the
        exact global batch a single-host run would sample."""
        if batch_size % process_count:
            raise ValueError(
                f"batch_size {batch_size} not divisible by process_count "
                f"{process_count}")
        rng = np.random.Generator(
            np.random.Philox(key=[self.seed, step]))
        offs = rng.integers(0, int(self._cum[-1]), size=batch_size)
        rows = offs[process_index::process_count]
        wins = np.stack([self._window(int(o)) for o in rows])
        return {"tokens": wins[:, :-1], "targets": wins[:, 1:]}


def write_token_shards(
    directory: str,
    tokens: Sequence[np.ndarray],
    *,
    dtype=np.uint32,
) -> list:
    """Write arrays as .bin shards + meta.json (the format TokenDataset
    reads). Returns the shard paths. Used by tests and by data-prep
    scripts."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    for i, arr in enumerate(tokens):
        p = os.path.join(directory, f"shard_{i:05d}.bin")
        np.asarray(arr, dtype).tofile(p)
        paths.append(p)
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump({"dtype": np.dtype(dtype).name}, f)
    return paths


def prefetch_to_device(
    batch_for: Callable[[int], dict],
    start_step: int,
    n_steps: int,
    *,
    put: Optional[Callable[[dict], dict]] = None,
    depth: int = 2,
) -> Iterator[dict]:
    """Iterate device-resident batches for steps [start_step,
    start_step + n_steps), keeping up to ``depth`` staged ahead.

    ``batch_for(step)`` produces host arrays; ``put`` stages them onto
    the device (e.g. ``lambda b: to_device(b, device)``, whose
    non-blocking copies overlap compute). Host-side
    paging/assembly runs in one background thread; exceptions surface on
    the consuming thread at the step that failed. Memory is O(depth)
    regardless of n_steps (a bounded queue, not per-step slots)."""
    import queue

    put = put or (lambda b: b)
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def producer():
        for i in range(n_steps):
            if stop.is_set():
                return
            try:
                item = ("ok", put(batch_for(start_step + i)))
            except BaseException as e:  # surfaced on the consumer side
                item = ("err", e)
            while not stop.is_set():    # bounded put that honors stop
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if item[0] == "err":
                return

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        for _ in range(n_steps):
            kind, val = q.get()
            if kind == "err":
                raise val
            yield val
    finally:
        stop.set()
        while True:                     # unblock a producer stuck on Full
            try:
                q.get_nowait()
            except queue.Empty:
                break


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """Host arrays -> int64 tensors on ``device``. On the card each array
    goes through pinned memory and a ``non_blocking`` copy on the current
    stream (the caching host allocator keeps the pinned buffer until the
    copy is done), so staging overlaps the step running there. Tensors
    (a batch made on the device) pass through as int64."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device=device, dtype=torch.int64)
            continue
        t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.int64))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out
