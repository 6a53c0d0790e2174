"""The port's copies of the reference's jax-free serving modules, held to
the reference: the metrics registry's exposition (both dialects, with
exemplars), the engine supervisor's backoff schedule, a watchdog trip on
a stub engine through both serving loops, the JSON log lines' trace
ids, and the SLO budget engine's and chip ledger's verdicts."""
import io
import json
import logging
import threading
import time

import pytest

from nos_tpu.cmd import setup_logging as jsetup_logging
from nos_tpu.cmd import server as jserver
from nos_tpu.models import supervision as jsup
from nos_tpu.obs import tracing as jtracing
from nos_tpu.utils import metrics as jmetrics
from nos_tpu_torch.cmd import server as tserver
from nos_tpu_torch.cmd import setup_logging as tsetup_logging
from nos_tpu_torch.models import supervision as tsup
from nos_tpu_torch.obs import tracing as ttracing
from nos_tpu_torch.utils import metrics as tmetrics


def _drive(m):
    """One fixed sequence of registry operations, exemplars included."""
    reg = m.Registry()
    c = reg.counter("demo_requests_total", "Requests by outcome",
                    ("outcome",))
    c.labels("ok").inc()
    c.labels("ok").inc(2)
    c.labels("err").inc(0)
    g = reg.gauge("demo_inflight", "In flight")
    g.set(3)
    g.inc()
    g.dec(2)
    h = reg.histogram("demo_latency_seconds", "Latency",
                      buckets=(0.01, 0.1, 1.0))
    h.observe(0.005, trace_id="ab" * 16)
    h.observe(0.05)
    h.observe(0.5, trace_id="cd" * 16, count=3)
    h.observe(5.0, trace_id="ef" * 16)
    lh = reg.histogram("demo_phase_seconds", "By phase", ("phase",),
                       buckets=(0.001, 0.01))
    lh.labels("wait").observe(0.002, trace_id="01" * 16)
    lh.labels("bookkeep").observe(0.0001)
    return reg


@pytest.mark.parametrize("openmetrics", [False, True],
                         ids=["prometheus", "openmetrics"])
def test_registry_exposes_what_the_reference_exposes(openmetrics,
                                                     monkeypatch):
    # exemplars carry a wall-clock stamp: pin both modules' clock
    monkeypatch.setattr(jmetrics, "_now", lambda: 1700000000.25)
    monkeypatch.setattr(tmetrics, "_now", lambda: 1700000000.25)
    want = _drive(jmetrics).expose(openmetrics=openmetrics)
    got = _drive(tmetrics).expose(openmetrics=openmetrics)
    assert got == want
    if openmetrics:
        assert '# {trace_id="' in got and got.endswith("# EOF\n")


def test_metrics_payload_negotiates_like_the_reference():
    from nos_tpu.cmd.serve import metrics_payload as jpayload

    for accept in ("", "application/openmetrics-text; version=1.0.0"):
        assert tserver.metrics_payload(accept)[1] == jpayload(accept)[1]


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_supervisor_backoff_schedule_matches_reference(seed):
    kw = dict(restart_budget=6, backoff_s=0.5, backoff_max_s=10.0,
              seed=seed)
    ref = jsup.EngineSupervisor(lambda: None, **kw)
    port = tsup.EngineSupervisor(lambda: None, **kw)
    assert [port.backoff_delay(i) for i in range(8)] \
        == [ref.backoff_delay(i) for i in range(8)]


class _HangingEngine:
    """A split-protocol stub whose first tick never returns from its
    device wait (until released): the watchdog must trip."""

    def __init__(self, hang: bool):
        self.pending, self.done, self._rid = {}, {}, 0
        self.hang = hang
        self.release = threading.Event()

    def submit(self, prompt, n, **kw):
        rid = self._rid
        self._rid += 1
        self.pending[rid] = n
        return rid

    def has_work(self):
        return bool(self.pending)

    def step_begin(self):
        return object() if self.pending else None

    def step_wait(self, handle):
        if self.hang:
            self.release.wait(timeout=30)

    def step_finish(self, handle):
        for rid, n in list(self.pending.items()):
            self.done[rid] = list(range(n))
            del self.pending[rid]
        return 1

    def progress(self, rid):
        if rid in self.done:
            return list(self.done[rid]), True
        if rid in self.pending:
            return [], False
        return None

    def pop_result(self, rid):
        return self.done.pop(rid, None)


def _watchdog_episode(mod):
    """Stuck tick -> watchdog -> rebuild through the factory: returns
    what the loop counted and what a client saw."""
    first = _HangingEngine(hang=True)
    loop = mod.ServingLoop(
        first, engine_factory=lambda: _HangingEngine(hang=False),
        restart_budget=1, restart_backoff_s=0.0, watchdog_s=0.1)
    reg = loop.m_requests
    before = {o: reg.value(o) for o in mod.OUTCOMES}
    trips0 = loop.m_watchdog.value()
    restarts0 = loop.m_restarts.value("watchdog")
    lost0 = loop.m_lost.value()
    try:
        with pytest.raises(RuntimeError) as e:
            loop.generate([1], 3, timeout=20)
        deadline = time.monotonic() + 20
        while loop.recovering and time.monotonic() < deadline:
            time.sleep(0.02)
        after = loop.generate([2], 4, timeout=20)
        sup = loop.stats()["supervisor"]
        return {
            "error": str(e.value),
            "after": after,
            "trips": loop.m_watchdog.value() - trips0,
            "restarts": loop.m_restarts.value("watchdog") - restarts0,
            "lost": loop.m_lost.value() - lost0,
            "outcomes": {o: reg.value(o) - before[o] for o in mod.OUTCOMES
                         if reg.value(o) != before[o]},
            "supervisor": {k: sup[k] for k in (
                "restart_budget", "attempts", "restarts", "resumed",
                "lost", "watchdog_s")},
            "healthy": loop.healthy,
        }
    finally:
        first.release.set()
        loop.shutdown()


def test_watchdog_trip_takes_the_reference_recovery_path():
    ref = _watchdog_episode(jserver)
    port = _watchdog_episode(tserver)
    assert port == ref
    assert port["trips"] == 1 and port["outcomes"] == {"failed": 1,
                                                       "finished": 1}


@pytest.fixture
def restore_logging():
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in list(root.handlers):
        root.removeHandler(h)
    for h in handlers:
        root.addHandler(h)
    root.setLevel(level)


def _json_line(setup, tracing, monkeypatch):
    stream = io.StringIO()
    monkeypatch.setattr("sys.stderr", stream)
    setup(0, "json")
    log = logging.getLogger("demo.server")
    with tracing.span("serve.request", component="server") as sp:
        log.info("inside %d", 1)
    log.info("outside")
    lines = [json.loads(x) for x in stream.getvalue().splitlines()]
    return sp, lines


def test_json_logs_carry_the_active_span(monkeypatch, restore_logging):
    rsp, ref = _json_line(jsetup_logging, jtracing, monkeypatch)
    psp, port = _json_line(tsetup_logging, ttracing, monkeypatch)
    assert [sorted(x) for x in port] == [sorted(x) for x in ref]
    assert port[0]["trace_id"] == psp.trace_id
    assert port[0]["span_id"] == psp.span_id
    assert "trace_id" not in port[1]
    for p, r in zip(port, ref):
        assert (p["level"], p["logger"], p["msg"]) \
            == (r["level"], r["logger"], r["msg"])


def test_span_counter_registers_under_the_reference_name():
    sp = ttracing.start_span("serve.tick", component="obs-test")
    sp.end()
    text = tmetrics.default_registry().expose()
    assert 'nos_trace_spans_total{component="obs-test"}' in text


def _slo_trace(m):
    """One fixed sequence through the SLO budget engine and the chip
    ledger (the port serves neither yet: tenant quotas are not ported)."""
    import random

    rng = random.Random(3)
    eng = m.SloBudgetEngine(
        {"gold": {"ttft_p99": 0.01, "goodput": 0.05}, "free": {}},
        fast_window_s=30.0, slow_window_s=300.0, burn_threshold=2.0,
        capture_interval_s=20.0, min_events=3)
    trips = []
    for i in range(200):
        now = i * 0.7
        trips.append(eng.note("gold", "ttft_p99", rng.random() < 0.2, now))
        trips.append(eng.note("gold", "goodput", rng.random() < 0.1, now))
    ledger = m.ChipLedger()
    for i in range(50):
        ledger.note_quantum(
            i * 0.03, i * 0.03 + 0.02 + (i % 3) * 0.001,
            {("gold", "decode"): 1 + i % 4, ("free", "prefill"): i % 2},
            {"gold": 4096 * (1 + i % 5)})
    return (trips, eng.rows(140.0), eng.snapshot(140.0),
            ledger.snapshot(), ledger.conserved(),
            m.aggregate_slo([eng.snapshot(140.0)] * 2, 2.0))


def test_slo_module_gives_the_reference_verdicts():
    from nos_tpu.obs import slo as jslo
    from nos_tpu_torch.obs import slo as tslo

    assert _slo_trace(tslo) == _slo_trace(jslo)
