"""The serving loop's request path on the tracer's clock, on a tiny CPU
engine driven through ``ServingLoop.stream``: the four children of a
``serve.request`` span tile it up to the first token, the lock-wait,
prefill and first-token-delivery histograms hold what the spans hold,
the profiler ranges line up with the spans, ``device_range`` is free
while ranges are off or no profiler is running, request traces survive many quanta (no tick
reaches the flight recorder), and ``/debug/profile`` still serves the
tick timeline, now on the tracer's clock. Jax-free."""
import json
import threading
import time
import urllib.request

import pytest
import torch

from nos_tpu_torch.cmd.server import ServerConfig, ServingLoop, \
    make_http_server
from nos_tpu_torch.models import transformer as ttfm
from nos_tpu_torch.models.serving import DecodeServer
from nos_tpu_torch.obs import tracing
from nos_tpu_torch.utils.metrics import default_registry

MODEL = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq=64)
CHILDREN = ("serve.lock_wait", "engine.queue", "engine.prefill",
            "serve.first_token")
HISTS = {"serve.lock_wait": ("nos_tpu_serve_lock_wait_seconds", "submit"),
         "engine.prefill": ("nos_tpu_serve_prefill_seconds",),
         "serve.first_token":
             ("nos_tpu_serve_first_token_delivery_seconds",)}


@pytest.fixture(scope="module")
def loop():
    cfg = ttfm.TransformerConfig(**MODEL, dtype=torch.float32)
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = DecodeServer(params, cfg, max_batch=2, device="cpu",
                       paged_impl="kernel", kv_block_size=8, kv_blocks=24)
    lp = ServingLoop(eng)
    yield lp
    lp.shutdown()


@pytest.fixture
def rec():
    """A fresh flight recorder of 8 traces behind the default tracer."""
    tr = tracing.tracer()
    old = tr.recorder
    tr.recorder = tracing.FlightRecorder(max_traces=8)
    yield tr.recorder
    tr.recorder = old


@pytest.fixture
def ranges_on():
    tracing.enable_device_ranges()
    yield
    tracing.enable_device_ranges(False)


def sums():
    reg = default_registry()
    return {k: reg.get(v[0]).observations(*v[1:])[1]
            for k, v in HISTS.items()}


def request_spans(rec):
    """name -> [spans] of every recorded serve.request trace."""
    out = {}
    for tid in rec.trace_ids():
        for sp in rec.trace(tid):
            out.setdefault(sp.name, []).append(sp)
    return out


def test_children_tile_the_request_and_match_the_histograms(loop, rec):
    before = sums()
    outs = []
    threads = [threading.Thread(
        target=lambda n=n: outs.append(loop.generate([1 + n, 2, 3], 4)))
        for n in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert len(outs) == 3
    after = sums()
    n = 0
    for tid in rec.trace_ids():
        spans = {sp.name: sp for sp in rec.trace(tid)}
        root = spans["serve.request"]
        kids = [spans[name] for name in CHILDREN]
        assert all(k.parent_id == root.span_id for k in kids)
        assert kids[0].start == root.start
        for a, b in zip(kids, kids[1:]):
            assert abs(b.start - a.end_time) < 1e-3, (a.name, b.name)
        # the children end at the first yield, which may come after a
        # request already finished at its first look closed its span
        assert all(k.end_time >= k.start for k in kids)
        n += 1
    assert n == 3
    spans = request_spans(rec)
    for name, total in after.items():
        got = sum(sp.duration for sp in spans[name])
        assert total - before[name] == pytest.approx(got, abs=1e-6), name


def test_submit_lock_wait_sees_a_held_lock(loop):
    reg = default_registry()
    hist = reg.get("nos_tpu_serve_lock_wait_seconds")
    n0, s0 = hist.observations("submit")
    with loop._work:
        t = threading.Thread(target=loop.generate, args=([5, 6], 2))
        t.start()
        time.sleep(0.05)
    t.join(60)
    n1, s1 = hist.observations("submit")
    assert n1 == n0 + 1
    assert s1 - s0 >= 0.045
    assert hist.observations("ticker")[0] > 0


def test_prefill_range_lines_up_with_its_span(loop, rec, ranges_on):
    from torch.profiler import ProfilerActivity, profile

    # both edges are two clock reads apart, so a thread descheduled
    # between them on a loaded host misses by that long: up to three
    # tries, and a clock that disagrees for good fails all three
    for _ in range(3):
        # a free slot: the submitting thread (this one) runs the prefill
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            loop.generate([7, 8, 9, 10], 2)
        ranges = [e for e in prof.profiler.kineto_results.events()
                  if e.name() == "engine.prefill"]
        assert len(ranges) == 1
        span = request_spans(rec)["engine.prefill"][-1]
        r = ranges[0]
        off = (abs(r.start_ns() / 1e9 - span.start),
               abs((r.start_ns() + r.duration_ns()) / 1e9 - span.end_time))
        if max(off) < 1e-3:
            break
    assert max(off) < 1e-3, off


def test_device_range_makes_nothing_without_a_profiler(loop, monkeypatch):
    import torch.autograd.profiler as prof
    from torch.profiler import ProfilerActivity, profile

    made = []
    real = prof.record_function
    monkeypatch.setattr(prof, "record_function",
                        lambda name: made.append(name) or real(name))
    # off by default: a running profiler alone opens no range
    with profile(activities=[ProfilerActivity.CPU]):
        loop.generate([3, 4], 3)
    assert made == []
    tracing.enable_device_ranges()
    try:
        assert tracing.device_range("x") is tracing.NOOP_RANGE
        loop.generate([3, 4], 3)
        assert made == []
        with profile(activities=[ProfilerActivity.CPU]):
            loop.generate([3, 4], 3)
    finally:
        tracing.enable_device_ranges(False)
    assert {"serve.step_begin", "engine.prefill", "engine.decode_launch",
            "model.attention", "serve.lock_wait", "serve.wait",
            "serve.step_finish", "serve.bookkeep"} <= set(made)


def test_request_traces_outlive_many_quanta(loop, rec):
    ticks = default_registry().get("nos_tpu_serve_ticks_total")
    loop.generate([1, 2], 2)
    first = rec.trace_ids()[0]
    t0 = ticks.value()
    loop.generate([9], 2 * rec.max_traces + 2)
    assert ticks.value() - t0 >= 2 * rec.max_traces
    names = sorted(sp.name for sp in rec.trace(first))
    assert names == sorted(("serve.request",) + CHILDREN)
    assert all(sp.name != "serve.tick" for sp in rec.spans())


def test_a_fork_records_no_prefill():
    cfg = ttfm.TransformerConfig(**MODEL, dtype=torch.float32)
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    eng = DecodeServer(params, cfg, max_batch=2, device="cpu",
                       kv_block_size=8, kv_blocks=24)
    r0 = eng.submit([4, 5, 6], 6)
    eng.step()
    assert len(eng.prefill_events) == 1
    f0 = eng.fork(r0)
    assert len(eng.prefill_events) == 1
    fork = next(r for r in eng._active.values() if r.rid == f0)
    assert fork.led.t_prefill_end >= fork.led.t_prefill_start > 0
    eng.drain()


def test_debug_profile_serves_ticks_on_the_tracer_clock(loop):
    loop.generate([2, 3], 3)
    httpd = make_http_server(
        ServerConfig(**MODEL, bf16=False, max_batch=2, port=0), loop,
        host="127.0.0.1")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(url + "/debug/profile?ticks=4",
                                    timeout=30) as r:
            events = json.loads(r.read())["traceEvents"]
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert any(e.get("name") == "serve.tick" for e in events)
    with loop._work:
        start = loop._tick_phases[-1][0]
    assert abs(start - tracing.tracer().clock()) < 60
