"""Serving cells: one ``DecodeServer`` built as ``cmd/server.py::
build_engine`` builds it (with the configuration's ``TransformerConfig``,
so its rope theta and expert capacity reach the model), driven in
process through ``ServingLoop.stream`` by client threads that time
every token.

Traffic ``arrivals``: "poisson" is an open loop whose requests are
submitted at their due times from one scheduler thread, each timed from
its due time; the window opens ``lead_in_s`` after the first is due.
"backlog" keeps ``outstanding`` requests submitted (a finished one's
client submits the next), so the queue stays full and the card sets the
pace; the window opens ``lead_in_s`` after every slot first holds a
request.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import List

import torch

from portbench import check, model, traffic
from portbench.trace import Tracer

# registry names of the serving loop's counters the readers take
TICKS = "nos_tpu_serve_ticks_total"
TICK_S = "nos_tpu_serve_tick_seconds"
PHASE_S = "nos_tpu_serve_tick_phase_seconds"
QUEUE_S = "nos_tpu_serve_queue_seconds"
PHASES = ("assemble", "dispatch", "wait", "sample", "bookkeep")
# seconds a client waits for its stream before it gives up
STREAM_TIMEOUT = 600.0


def build(cfg: dict, dm: model.Dims, params: dict, device):
    """The engine and its loop, as ``build_engine`` makes them from a
    ``ServerConfig`` with the configuration's ``engine`` settings."""
    from nos_tpu_torch.cmd.server import ServingLoop
    from nos_tpu_torch.models.serving import DecodeServer
    from nos_tpu_torch.models.transformer import TransformerConfig
    from nos_tpu_torch.ops.attention import check_paged_kernel_head_dim
    from nos_tpu_torch.ops.layers import rms_norm
    import inspect

    eps = inspect.signature(rms_norm).parameters["eps"].default
    if dm.norm_eps != eps:
        raise ValueError(f"the port's RMSNorm eps is {eps}; the "
                         f"configuration states {dm.norm_eps}")
    tcfg = TransformerConfig(
        vocab=dm.vocab, d_model=dm.d_model, n_layers=dm.n_layers,
        n_heads=dm.n_heads, n_kv_heads=dm.n_kv_heads, d_ff=dm.d_ff,
        max_seq=dm.max_seq, rope_theta=dm.rope_theta, dtype=torch.bfloat16,
        n_experts=dm.n_experts,
        expert_capacity_factor=cfg.get("expert_capacity_factor", 1.25))
    eng_kw = dict(cfg["engine"])
    check_paged_kernel_head_dim(dm.head_dim, device,
                                eng_kw.get("paged_impl", "kernel"))
    engine = DecodeServer(params, tcfg, device=device, **eng_kw)
    return engine, ServingLoop(engine)


def counters(loop, locked: bool = False) -> dict:
    """The loop's counters and the engine's dispatched ticks, read under
    the loop's lock (``locked``: the caller holds it)."""
    from nos_tpu_torch.utils.metrics import default_registry

    reg = default_registry()
    with contextlib.nullcontext() if locked else loop._work:
        return {"ticks": reg.get(TICKS).value(),
                "tick": reg.get(TICK_S).observations(),
                "queue": reg.get(QUEUE_S).observations(),
                "phase": {p: reg.get(PHASE_S).observations(p)
                          for p in PHASES},
                "dispatched": loop.engine.ticks_dispatched,
                "at": time.perf_counter()}


class TickHook:
    """Runs a function at the start of the serving loop's next quantum,
    on its ticker thread under its lock, before the quantum dispatches:
    then no thread can be launching, a graph replay included. Waiting for
    the lock from another thread can take seconds while every client
    thread wakes on each tick. A loop that runs no quantum within
    ``idle_s`` is idle, waiting on its condition: the function then runs
    under the loop's lock from the caller's thread."""

    def __init__(self, loop, idle_s: float = 1.0):
        self.loop = loop
        self.idle_s = idle_s
        self._orig = loop.engine.step_begin
        self._todo = None
        self._result = None
        self._take = threading.Lock()
        self._done = threading.Event()
        loop.engine.step_begin = self._step_begin

    def _step_begin(self):
        with self._take:
            fn, self._todo = self._todo, None
        if fn is not None:
            try:
                self._result = fn()
            finally:
                self._done.set()
        return self._orig()

    def call(self, fn):
        self._done.clear()
        self._todo = fn
        if not self._done.wait(self.idle_s):
            with self._take:
                mine = self._todo is fn
                self._todo = None
            if mine:
                with self.loop._work:
                    return fn()
            self._done.wait()
        return self._result


def buckets(lo: int, hi: int) -> List[int]:
    """The prefill scratch lengths prompts of lo..hi tokens use: the
    powers of two from 8 that hold them (the engine's ``_bucket``)."""
    b = 8
    while b < lo:
        b *= 2
    out = [b]
    while b < hi:
        b *= 2
        out.append(b)
    return out


class Clients:
    """The client side of a run: one thread a request, each stamping the
    arrival of every token with the host clock."""

    def __init__(self, loop, records: List[dict]):
        self.loop = loop
        self.records = records
        self.threads: List[threading.Thread] = []
        self.stopping = threading.Event()
        self.lock = threading.Lock()
        self.next = 0
        self.on_finish = None

    def submit(self, r: dict) -> None:
        r["submit"] = time.perf_counter()
        try:
            s = self.loop.stream(r["prompt"], r["max_new"],
                                 timeout=STREAM_TIMEOUT)
        except Exception as e:               # refused or failed
            r["status"] = "cut" if self.stopping.is_set() else "failed"
            r["error"] = repr(e)
            return
        r["status"] = "running"
        t = threading.Thread(target=self._consume, args=(r, s), daemon=True)
        with self.lock:
            self.threads.append(t)
        t.start()

    def _consume(self, r: dict, s) -> None:
        try:
            for delta in s:
                now = time.perf_counter()
                r["times"].extend([now] * len(delta))
                r["tokens"].extend(delta)
            r["status"] = "finished"
        except Exception as e:
            r["status"] = "cut" if self.stopping.is_set() else "failed"
            r["error"] = repr(e)
            return
        if self.on_finish is not None and not self.stopping.is_set():
            self.on_finish()

    def take(self):
        with self.lock:
            if self.next >= len(self.records):
                return None
            r = self.records[self.next]
            self.next += 1
            return r

    def join(self, timeout: float) -> None:
        end = time.monotonic() + timeout
        for t in list(self.threads):
            t.join(max(0.0, end - time.monotonic()))


def open_loop(clients: Clients, t0: float, close: float) -> threading.Thread:
    """The scheduler: each request submitted at its due time (late when
    a submit before it blocked), none due after the window closes."""
    for r in clients.records:
        r["due"] += t0

    def go():
        for r in clients.records:
            if r["due"] >= close or clients.stopping.is_set():
                break
            wait = r["due"] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            clients.submit(r)
    t = threading.Thread(target=go, daemon=True)
    t.start()
    return t


def backlog(clients: Clients, outstanding: int) -> None:
    """Keep ``outstanding`` requests submitted: a finished request's
    client submits the next."""
    def refill():
        r = clients.take()
        if r is not None:
            r["due"] = time.perf_counter()
            clients.submit(r)
    clients.on_finish = refill
    for _ in range(outstanding):
        refill()


def warm_up(loop, mix: dict, vocab: int, max_seq: int, seed: int) -> None:
    """One request at each prefill length the traffic's prompts use, so
    no shape is first met in the window."""
    g = torch.Generator().manual_seed(seed)
    for n in buckets(mix["prompt"]["min"], mix["prompt"]["max"]):
        n = min(n, max_seq - 2)
        prompt = torch.randint(vocab, (n,), generator=g).tolist()
        for _ in loop.stream(prompt, 2, timeout=STREAM_TIMEOUT):
            pass


def run(ctx) -> dict:
    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    cuda = dev.type == "cuda"
    dm = model.dims_of(cfg)
    clock = [time.perf_counter()]

    def lap():
        if cuda:
            torch.cuda.synchronize()
        clock.append(time.perf_counter())
        return clock[-1] - clock[-2]

    timing = {}
    params = model.make_params(dm, ctx.seed, dev)
    timing["weights_s"] = lap()
    engine, loop = build(cfg, dm, params, dev)
    timing["build_s"] = lap()
    engine.capture_programs()
    capture_s = engine.compile_s
    timing["capture_s"] = lap()
    warm_up(loop, mix, dm.vocab, dm.max_seq, ctx.seed)
    timing["warm_up_s"] = lap()

    if ctx.trace:
        # the profiler's first start is slow: pay it here, on the idle
        # engine, not inside the window under the loop's lock
        tracer = Tracer(cuda, loop._thread.ident)
        tracer.warm()
        hook = TickHook(loop)
        timing["profiler_warm_s"] = lap()

    reqs = traffic.generate(mix, ctx.seed, ctx.seconds, dm.vocab)
    records = [{"index": r.index, "due": r.due, "prompt": r.prompt,
                "max_new": r.max_new, "times": [], "tokens": [],
                "status": "due"} for r in reqs]
    clients = Clients(loop, records)
    scheduler = None
    if mix["arrivals"] == "poisson":
        t0 = time.perf_counter() + 0.05
        open_at = t0 + mix["lead_in_s"]
        close_at = open_at + ctx.seconds
        scheduler = open_loop(clients, t0, close_at)
    else:
        backlog(clients, mix["outstanding"])
        slots = cfg["engine"]["max_batch"]
        while sum(1 for r in records if r["times"]) < slots:
            time.sleep(0.005)
        open_at = time.perf_counter() + mix["lead_in_s"]
        close_at = open_at + ctx.seconds
    ctx.sleep_until(open_at)
    marks = [counters(loop)]
    trace = None
    if ctx.trace:
        # the window's last ``trace_seconds`` are profiled; the counters'
        # readings stop where the profile starts (the profiler slows the
        # host), and its stop, which holds the loop while it gathers the
        # trace, comes at the close
        ctx.sleep_until(close_at - mix["trace_seconds"])
        marks.append(hook.call(
            lambda: (counters(loop, locked=True), tracer.start())[0]))
        timing["trace_start_s"] = time.perf_counter() - tracer.t0_call
        ctx.sleep_until(close_at)
        hook.call(tracer.stop)
        timing["trace_stop_s"] = tracer.t1_done - tracer.t1
    else:
        ctx.sleep_until(close_at)
        marks.append(counters(loop))
    clients.stopping.set()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if scheduler is not None:
        scheduler.join()
    loop.shutdown()
    loop._thread.join(60)
    clients.join(60)
    timing["drain_s"] = lap()
    for n, (a, b) in enumerate(zip(marks[0::2], marks[1::2])):
        rows = sum(1 for r in records for j, t in enumerate(r["times"])
                   if j and a["at"] <= t <= b["at"])
        timing[f"segment{n}"] = {"s": b["at"] - a["at"],
                                 "ticks": b["dispatched"] - a["dispatched"],
                                 "loop_ticks": b["ticks"] - a["ticks"],
                                 "decode_rows": rows}
    if ctx.trace:
        trace = tracer.reduce()
        tracer = hook = None
        timing["trace_reduce_s"] = lap()
    del loop, engine, clients
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    window = (open_at, close_at)
    if mix["arrivals"] == "poisson":
        due = [r for r in records if open_at <= r["due"] < close_at]
    else:
        due = [r for r in records if r["status"] != "due"
               and r["due"] < close_at]
    chosen = check.sample(records, ctx.seed, mix["check"]["tokens"],
                          mix["check"]["sequences"])
    lap()
    gaps = check.served_gaps(params, dm, chosen, ctx.controls)
    timing["reference_s"] = lap()
    checks, correct = check.judge(gaps["program"], cfg.get("limits", {}))
    return {"dims": dm, "window": window, "requests": records,
            "counters": list(zip(marks[0::2], marks[1::2])),
            "capture_s": capture_s,
            "trace": trace, "memory_peak_bytes": peak,
            "attempted": len(due),
            "failed": sum(1 for r in due if r["status"] == "failed"),
            "checks": checks, "check_detail": gaps, "timing": timing,
            "correct": correct}
