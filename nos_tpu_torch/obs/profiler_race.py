"""Does stopping torch.profiler race a CUDA graph replay on another thread?

A standalone probe of a hang seen on an NVIDIA H100: the serving loop's
ticker replayed its decode graph while another thread stopped
torch.profiler, and both threads stopped inside CUDA (stacks in
``profiler.stop_trace`` and ``CUDAGraph.replay``). Run on a machine with
a card:

    python -m nos_tpu_torch.obs.profiler_race [--cycles 20] [--limit 120]

It captures one graph of many small kernels (a decode tick's shape: a
few thousand launches of a few microseconds each), then runs three
steps, each printing one JSON line:

1. ``gil``: a thread replays the graph back to back without waiting, so
   ``cudaGraphLaunch`` blocks once the card's launch queue is full,
   while this thread counts loop iterations. Its rate against an idle
   baseline says whether ``CUDAGraph.replay`` holds the interpreter lock
   while it blocks (near 1: it lets go; near 0: it holds it), read only
   when the replays spent most of the wall inside ``replay``.
2. ``locked``: a thread replays the graph and waits on an event after
   each replay, as the serving loop's ticker does, taking a lock around
   each replay; this thread starts and stops the profiler ``--cycles``
   times under the same lock.
3. ``unlocked``: the same with no lock, as an operator profiling a live
   server from another thread would.

A step that does not end within ``--limit`` seconds dumps every
thread's stack to standard error and exits with code 1. Meanwhile a
third thread writes a heartbeat line to standard error every second: if
the heartbeats stop while a step hangs, some thread holds the
interpreter lock through the hang.
"""
from __future__ import annotations

import argparse
import contextlib
import faulthandler
import json
import sys
import threading
import time

import torch


def build_graph(device: torch.device, layers: int):
    """A captured graph of ``3 x layers`` small kernels (matmul, add,
    tanh on 256 x 256 f32)."""
    x = torch.randn(256, 256, device=device)
    w = torch.randn(256, 256, device=device) * 0.01

    def body():
        y = x
        for _ in range(layers):
            y = torch.tanh(y @ w + x)
        return y

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        body()                                  # loads cuBLAS
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    return graph


def replay_ms(graph, n: int = 20) -> float:
    """Device milliseconds of one replay."""
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    graph.replay()
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def spin(seconds: float) -> int:
    n, end = 0, time.perf_counter() + seconds
    while time.perf_counter() < end:
        n += 1
    return n


def gil_probe(graph, seconds: float, cap: int) -> dict:
    """Spin rate while another thread floods replays, against alone."""
    base = spin(seconds) / seconds
    inside = [0.0, 0]
    stop = threading.Event()

    def flood():
        while not stop.is_set() and inside[1] < cap:
            t = time.perf_counter()
            graph.replay()
            inside[0] += time.perf_counter() - t
            inside[1] += 1

    th = threading.Thread(target=flood)
    t0 = time.perf_counter()
    th.start()
    rate = spin(seconds) / seconds
    stop.set()
    th.join()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    share = inside[0] / wall
    return {"step": "gil", "replays": inside[1],
            "replay_share_of_wall": share,
            "spin_per_s_alone": base, "spin_per_s_beside_replays": rate,
            "spin_ratio": rate / base,
            "replay_holds_gil": (rate / base < 0.5) if share > 0.8
            else None}


def profiler_cycles(graph, cycles: int, locked: bool) -> dict:
    """Replays on a thread (each followed by an event wait) while this
    thread starts and stops torch.profiler ``cycles`` times."""
    from torch.profiler import ProfilerActivity, profile

    lock = threading.Lock()
    guard = (lambda: lock) if locked else contextlib.nullcontext
    stop = threading.Event()
    replays = [0]

    def ticker():
        event = torch.cuda.Event()
        while not stop.is_set():
            with guard():
                graph.replay()
                event.record()
            event.synchronize()
            replays[0] += 1

    th = threading.Thread(target=ticker, daemon=True)
    th.start()
    stops = []
    try:
        for i in range(cycles):
            print(f"{'locked' if locked else 'unlocked'} cycle {i}",
                  file=sys.stderr, flush=True)
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            with guard():
                prof.start()
            time.sleep(0.05)
            t = time.perf_counter()
            with guard():
                if locked:
                    torch.cuda.synchronize()
                prof.stop()
            stops.append(time.perf_counter() - t)
    finally:
        stop.set()
        th.join()
    return {"step": "locked" if locked else "unlocked", "cycles": cycles,
            "replays": replays[0], "stop_s_max": max(stops),
            "stop_s_mean": sum(stops) / len(stops)}


def heartbeat() -> None:
    """One line a second on standard error, while this thread can take
    the interpreter lock."""
    t0 = time.monotonic()
    while True:
        time.sleep(1.0)
        print(f"heartbeat {time.monotonic() - t0:.1f} s", file=sys.stderr,
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cycles", type=int, default=20)
    ap.add_argument("--layers", type=int, default=600)
    ap.add_argument("--limit", type=float, default=120.0,
                    help="seconds a step may take before its stacks are "
                         "dumped and the process exits")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    threading.Thread(target=heartbeat, daemon=True).start()
    graph = build_graph(device, args.layers)
    print(json.dumps({"step": "graph", "kernels": 3 * args.layers,
                      "replay_ms": replay_ms(graph),
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    steps = (lambda: gil_probe(graph, 1.0, 1000),
             lambda: profiler_cycles(graph, args.cycles, locked=True),
             lambda: profiler_cycles(graph, args.cycles, locked=False))
    for step in steps:
        faulthandler.dump_traceback_later(args.limit, exit=True)
        print(json.dumps(step()), flush=True)
        faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
