"""Pinned staging for KV payload planes: the host half of every copy a
payload makes across the link (swap-out and swap-in under preemption,
restart capture, host-tier demotion and promotion, fabric export and
ingest).

A payload rests in pageable host memory (numpy arrays: the host tier
holds GiBs of it, sized by the operator, and pinning that much with
``cudaHostAlloc`` stalls), but it crosses the link through a small pool
of pinned slabs that is reused from copy to copy:

- ``download`` copies device planes into one slab, each a
  ``non_blocking`` copy queued on the caller's current stream (the
  engine's), and records an event behind them. The handle's ``arrays``
  (and ``views``) wait on that event before the host reads a byte, then
  copy the planes out into pageable arrays (or lend the slab until
  ``release``); ``arrays_later`` hands the wait and the copy-out to the
  pool's worker thread and returns at once, with a ``threading.Event``
  that a reader waits on (``models/handoff.py::settle``) before it reads
  the planes.
- ``upload`` copies host planes into one slab and queues
  ``non_blocking`` copies from it to the device on the current stream;
  the slab is not handed out again until the event recorded behind those
  copies has completed, so the host never waits for the ticks queued
  ahead of them unless every slab is busy.

Host copies are torch CPU copies, which split a large copy across the
intra-op threads: a single-threaded copy into fresh pageable memory runs
at the rate its page faults allow, several times below the link's.

The pool sizes itself: a slab grows to the largest payload it has been
asked to carry, and at most ``MAX_SLABS`` slabs are kept (more are made
only while every kept one is lent to a download not yet copied out, and
freed when returned). On the CPU the slabs are plain memory and the
copies synchronous, so the same code runs there.
"""
from __future__ import annotations

import queue
import threading
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nos_tpu_torch.models.handoff import READY, settle

__all__ = ["PinnedStaging", "Download", "READY", "settle"]

#: plane offsets inside a slab are aligned to this many bytes
_ALIGN = 256

#: slabs a pool keeps between copies (one for the engine's copies, one
#: for an export's snapshot waiting to be encoded)
MAX_SLABS = 2

def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy, bf16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _host_bytes(arr: np.ndarray) -> torch.Tensor:
    """A host plane's bytes as a CPU tensor, shared, not copied. A plane
    may be read-only (a decoded payload, another framework's): torch
    warns that it cannot mark the tensor so; it is only read here."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(flat)


class _Slab:
    """One staging buffer and the event behind the last copy that used
    it (None: no copy pending)."""

    __slots__ = ("buf", "event")

    def __init__(self, buf: torch.Tensor):
        self.buf = buf
        self.event = None

    @property
    def cap(self) -> int:
        return self.buf.numel()

    def ready(self) -> bool:
        return self.event is None or self.event.query()


class Download:
    """Device planes on their way into one slab. ``arrays()`` waits for
    the copies and returns pageable copies of the planes (the slab goes
    back to the pool); ``arrays_later()`` does the same on the pool's
    worker; ``views()`` waits and lends numpy views of the slab itself
    until ``release()``."""

    def __init__(self, pool: "PinnedStaging", slab: _Slab,
                 planes: Dict[str, torch.Tensor]):
        self._pool = pool
        self._slab: Optional[_Slab] = slab
        self._planes = planes

    def wait(self) -> None:
        if self._slab is not None and self._slab.event is not None:
            self._slab.event.synchronize()

    def views(self) -> Dict[str, np.ndarray]:
        """The planes as numpy views of the slab, after its copies
        landed; bf16 planes as their uint16 bits. Valid until
        ``release``."""
        if self._slab is None:
            raise RuntimeError("download already released")
        self.wait()
        return {name: _numpy(t) for name, t in self._planes.items()}

    def _copy_out(self, dst: Dict[str, torch.Tensor]) -> None:
        try:
            self.wait()
            for name, t in self._planes.items():
                dst[name].copy_(t)
        finally:
            self.release()

    def _destinations(self) -> Dict[str, torch.Tensor]:
        return {name: torch.empty(t.shape, dtype=t.dtype)
                for name, t in self._planes.items()}

    def arrays(self) -> Dict[str, np.ndarray]:
        """Pageable copies of the planes; the slab returns to the pool."""
        dst = self._destinations()
        self._copy_out(dst)
        return {name: _numpy(t) for name, t in dst.items()}

    def arrays_later(self) -> Tuple[Dict[str, np.ndarray], threading.Event]:
        """The planes' pageable arrays now, filled by the pool's worker
        once the copies landed, and the event it sets then: no host read
        of the arrays before the event (``settle``)."""
        dst = self._destinations()
        done = threading.Event()
        self._pool._later(self, dst, done)
        return {name: _numpy(t) for name, t in dst.items()}, done

    def release(self) -> None:
        slab, self._slab = self._slab, None
        if slab is not None:
            # the event stays: a slab released before its copies landed
            # is not handed out again until they have
            self._pool._give_back(slab)


class PinnedStaging:
    """A self-sizing pool of pinned host slabs for one device."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pinned = device.type == "cuda"
        self._idle: List[_Slab] = []
        self._lent = 0
        self._largest = 0
        self._lock = threading.Lock()
        self._jobs: Optional[queue.Queue] = None
        # copies made, bytes each way, and slabs (re)allocated: the pool's
        # whole cost, for introspection and the tests
        self.counts = {"downloads": 0, "uploads": 0, "bytes_down": 0,
                       "bytes_up": 0, "allocs": 0, "waits": 0}

    @property
    def pinned_bytes(self) -> int:
        """Host bytes the pool holds in idle slabs."""
        with self._lock:
            return sum(s.cap for s in self._idle)

    def _alloc(self, nbytes: int) -> _Slab:
        self.counts["allocs"] += 1
        return _Slab(torch.empty((nbytes,), dtype=torch.uint8,
                                 pin_memory=self.pinned))

    def _take(self, nbytes: int) -> _Slab:
        """A slab of at least ``nbytes`` that no copy is using: an idle
        ready one that fits, else a ready one regrown, else a new one
        while fewer than ``MAX_SLABS`` exist (or none is idle), else the
        oldest idle one once its copies are done."""
        with self._lock:
            self._largest = max(self._largest, nbytes)
            ready = [s for s in self._idle if s.ready()]
            fits = [s for s in ready if s.cap >= nbytes]
            if fits:
                slab = min(fits, key=lambda s: s.cap)
            elif ready:
                self._idle.remove(ready[0])
                slab = self._alloc(_aligned(self._largest))
                self._idle.append(slab)
            elif len(self._idle) + self._lent < MAX_SLABS \
                    or not self._idle:
                slab = self._alloc(_aligned(self._largest))
                self._idle.append(slab)
            else:
                slab = self._idle[0]
                self.counts["waits"] += 1
                slab.event.synchronize()
                slab.event = None
                if slab.cap < nbytes:
                    self._idle.remove(slab)
                    slab = self._alloc(_aligned(self._largest))
                    self._idle.append(slab)
            self._idle.remove(slab)
            self._lent += 1
            return slab

    def _give_back(self, slab: _Slab) -> None:
        with self._lock:
            self._lent -= 1
            if len(self._idle) + self._lent < MAX_SLABS:
                self._idle.append(slab)

    def _record(self, slab: _Slab) -> None:
        if self.pinned:
            slab.event = torch.cuda.Event()
            slab.event.record()

    def _later(self, dl: Download, dst: Dict[str, torch.Tensor],
               done: threading.Event) -> None:
        """Queue a download's copy-out for the worker thread (started at
        the first use); on the CPU it runs here."""
        if not self.pinned:
            dl._copy_out(dst)
            done.set()
            return
        with self._lock:
            if self._jobs is None:
                self._jobs = queue.Queue()
                threading.Thread(target=self._work, args=(self._jobs,),
                                 name="nos-staging", daemon=True).start()
        self._jobs.put((dl, dst, done))

    def close(self) -> None:
        """Stop the worker thread once the copies queued before are done
        (an engine that is dropped calls this)."""
        with self._lock:
            jobs, self._jobs = self._jobs, None
        if jobs is not None:
            jobs.put(None)

    @staticmethod
    def _work(jobs: queue.Queue) -> None:
        while True:
            job = jobs.get()
            if job is None:
                return
            dl, dst, done = job
            try:
                dl._copy_out(dst)
            except Exception as e:      # the reader's settle raises it
                done.error = e
            finally:
                done.set()

    def download(self, planes: Dict[str, torch.Tensor]) -> Download:
        """Queue copies of device ``planes`` into one slab on the current
        stream, with an event behind them; nothing waits here."""
        sizes = {k: t.numel() * t.element_size() for k, t in planes.items()}
        slab = self._take(sum(_aligned(n) for n in sizes.values()))
        views, off = {}, 0
        for name, t in planes.items():
            n = sizes[name]
            v = slab.buf[off:off + n].view(t.dtype).view(t.shape)
            v.copy_(t, non_blocking=self.pinned)
            views[name] = v
            off += _aligned(n)
        self._record(slab)
        self._count("downloads", "bytes_down", sum(sizes.values()))
        return Download(self, slab, views)

    def upload(self, planes: Dict[str, np.ndarray],
               dtypes: Dict[str, torch.dtype]) -> Dict[str, torch.Tensor]:
        """Copy host ``planes`` (numpy, bf16 as uint16 bits) into one slab
        and queue their copies to the device on the current stream;
        returns the device tensors, typed by ``dtypes``. The slab goes
        back to the pool busy until those copies are done."""
        sizes = {k: int(a.nbytes) for k, a in planes.items()}
        slab = self._take(sum(_aligned(n) for n in sizes.values()))
        out, off = {}, 0
        try:
            for name, arr in planes.items():
                n = sizes[name]
                dtype = dtypes[name]
                if arr.dtype.itemsize != torch.empty(
                        (), dtype=dtype).element_size():
                    raise ValueError(
                        f"plane {name}: {arr.dtype} cannot carry {dtype}")
                slab.buf[off:off + n].copy_(_host_bytes(arr))
                src = slab.buf[off:off + n].view(dtype).view(arr.shape)
                # on the CPU the slab is the device's own memory: copy
                # out, or the next use of the slab would rewrite it
                out[name] = (src.to(self.device, non_blocking=True)
                             if self.pinned else src.clone())
                off += _aligned(n)
            self._record(slab)
        finally:
            self._give_back(slab)
        self._count("uploads", "bytes_up", sum(sizes.values()))
        return out

    def _count(self, copies: str, nbytes_key: str, nbytes: int) -> None:
        with self._lock:
            self.counts[copies] += 1
            self.counts[nbytes_key] += nbytes
