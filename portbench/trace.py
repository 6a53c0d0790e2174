"""torch.profiler over a slice of the measured window, and its reduction
to what the per-layer readers take: device seconds by kernel name, the
busy time (the union of the device's operations), the slice's length,
the operations that took most time and the idle gaps by what the host
was doing.

The profiler starts and stops while the caller holds ``lock`` (the
serving loop's: every launch of its threads, a graph replay among them,
is made under it), with the device drained before the stop, so no
thread is inside a launch when the profiler stops: stopping it beside a
replaying thread hung both on the H100."""
from __future__ import annotations

import bisect
import contextlib
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Optional

import torch

TOP = 10
NAME_CHARS = 120
SCAN = 64


class Sampler:
    """What the host threads are doing while the profiler runs: every
    ``PERIOD`` seconds, each thread's innermost frame in the port's code
    (``nos_tpu_torch``), stamped on the wall clock as the profiler's
    events are. The profiler records the operations of the thread that
    started it only, and the serving loop launches from its own
    threads."""
    PERIOD = 0.005

    def __init__(self, first: Optional[int] = None):
        self.samples = []
        self.first = first          # thread to name a gap by, when busy
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()

    def _run(self) -> None:
        me = threading.get_ident()
        while not self._stop.wait(self.PERIOD):
            now = time.time_ns()
            seen = {}
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                f = frame
                while f is not None and "nos_tpu_torch" not in \
                        f.f_code.co_filename:
                    f = f.f_back
                if f is not None:
                    seen[tid] = (f"{os.path.basename(f.f_code.co_filename)}"
                                 f":{f.f_code.co_name}")
            self.samples.append((now, seen))

    def label(self, t_ns: float) -> str:
        """The port function a thread was in nearest ``t_ns`` (wall-clock
        nanoseconds, the profiler's clock)."""
        if not self.samples:
            return "no host sample"
        keys = [s[0] for s in self.samples]
        i = min(bisect.bisect_left(keys, t_ns), len(keys) - 1)
        seen = self.samples[i][1]
        if self.first in seen:
            return seen[self.first]
        return next(iter(sorted(seen.values())), "no port code running")


class Tracer:
    def __init__(self, cuda: bool, first_thread: Optional[int] = None):
        self.cuda = cuda
        self.prof = None
        self.t0 = self.t1 = None
        self.sampler = Sampler(first_thread)
        self.lo_ns = self.hi_ns = None

    def warm(self) -> None:
        """Start and stop a profile of nothing, so the profiler's own
        set-up is done before the traced slice."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            torch.zeros(1, device="cuda" if self.cuda else "cpu").add_(1)
            if self.cuda:
                torch.cuda.synchronize()

    def start(self, lock=None) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.t0_call = time.perf_counter()
        with lock or contextlib.nullcontext():
            self.prof.start()
            self.lo_ns = time.time_ns()
            self.t0 = time.perf_counter()
        self.sampler.start()

    def stop(self, lock=None) -> None:
        self.sampler.stop()
        with lock or contextlib.nullcontext():
            if self.cuda:
                torch.cuda.synchronize()
            self.hi_ns = time.time_ns()
            self.t1 = time.perf_counter()
            self.prof.stop()
            self.t1_done = time.perf_counter()

    def reduce(self) -> Optional[dict]:
        if self.prof is None:
            return None
        return reduce_events(self.prof.profiler.kineto_results.events(),
                             self.lo_ns, self.hi_ns, (self.t0, self.t1),
                             self.sampler)


def _union(intervals):
    """Sorted, merged intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events, lo: int, hi: int, host_window: tuple,
                  sampler: Optional[Sampler] = None) -> dict:
    """The trace between ``lo`` and ``hi``, nanoseconds of the wall clock
    on which the profiler stamps its events (the start and stop may be
    made on different threads, and it records the operations of the
    thread that started it only). An idle gap is named by the shortest
    host operation the profiler saw at its middle, else by the sampler's
    port function there."""
    device, host = [], []
    for e in events:
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if str(e.device_type()).endswith("CUDA"):
            device.append(span)
        elif e.duration_ns() > 0:
            host.append(span)
    kernels = defaultdict(float)
    count = defaultdict(int)
    spans = []
    for a, b, name in device:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        kernels[name] += (b - a) / 1e9
        count[name] += 1
        spans.append((a, b))
    busy = _union(spans)
    busy_s = sum(b - a for a, b in busy) / 1e9
    # idle gaps, each named by the shortest host operation running at its
    # middle (the most specific thing the host was doing)
    gaps = []
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    host.sort()
    starts = [h[0] for h in host]
    by_label = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        best = None
        # the innermost operation starts shortly before the middle: look
        # back over the last SCAN starts
        i = bisect.bisect_right(starts, mid)
        for ha, hb, name in host[max(0, i - SCAN):i]:
            if hb >= mid and (best is None or hb - ha < best[0]):
                best = (hb - ha, name)
        if best is None and sampler is not None:
            best = (0, sampler.label(mid))
        by_label[best[1] if best else "no host operation recorded"] += \
            (b - a) / 1e9
    ops = sorted(kernels.items(), key=lambda kv: -kv[1])
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy_s,
            "host_window": host_window,
            "kernels": dict(kernels), "launches": dict(count),
            "device_ops": [[n[:NAME_CHARS], s] for n, s in ops[:TOP]],
            "idle_gaps": [[n[:NAME_CHARS], s] for n, s in sorted(
                by_label.items(), key=lambda kv: -kv[1])[:TOP]]}


def kernel_seconds(trace: Optional[dict], pattern: str) -> Optional[float]:
    """Device seconds of the kernels whose name holds ``pattern``; None
    when the trace saw none."""
    if not trace:
        return None
    s = sum(v for k, v in trace["kernels"].items() if pattern in k)
    return s if s > 0 else None
