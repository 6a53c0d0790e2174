"""The port's serving binary (``nos_tpu_torch/cmd/server.py``) on the CPU:
the colocated cases of tests/test_server_cmd.py carried over to the
port, the engine's split-step barrier, a reference replica and a port
replica side by side over HTTP (and the reference gateway in front of
the port), and ``main``'s flags against the reference's.

Tokens are held to the reference's own ``generate`` on the same params
(``params_from_jax``), f32; the reference replica runs its paged engine
over the gather formulation (NOS_TPU_PAGED_KERNEL=0, restored after),
and on CPU tensors the port's kernel wrapper runs its plain version.
Every wait is bounded: urlopen, result and join timeouts, and servers
and loops shut down in ``finally`` or fixture teardown.
"""
import dataclasses
import json
import logging
import threading
import time
import urllib.error
import urllib.request

import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu.models.generate import generate as jgenerate  # noqa: E402
from nos_tpu_torch.cmd import server as tserver  # noqa: E402
from nos_tpu_torch.cmd.server import (  # noqa: E402
    OUTCOMES, RATE_WINDOW_S, DrainingError, ServerConfig, ServingLoop,
    build_engine, make_http_server,
)
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402
from nos_tpu_torch.models.errors import NotPorted, QueueFull  # noqa: E402
from nos_tpu_torch.models.serving import DecodeServer  # noqa: E402
from nos_tpu_torch.obs import tracing  # noqa: E402
from nos_tpu_torch.utils.metrics import default_registry  # noqa: E402

# the reference's tests/test_server_cmd.py:19-20
MODEL = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq=64)
JCFG = jtfm.TransformerConfig(**MODEL, dtype=jnp.float32)
TCFG = ttfm.TransformerConfig(**MODEL, dtype=torch.float32)
PAGED = dict(kv_block_size=8, kv_blocks=24)
# the reference's documented replica /stats keys
# (tests/test_metrics_docs.py::REPLICA_STATS_KEYS)
REPLICA_STATS_KEYS = {
    "engine", "role", "handoff", "max_batch", "max_len", "slots",
    "active_slots", "pending", "prefill_sched", "pipeline",
    "prefix_cache", "prefix_index", "kv", "tenants", "compiles",
    "tokens_emitted", "healthy", "draining", "recovering", "uptime_s",
    "config", "per_request", "supervisor", "deadline", "slo", "rates",
    "kv_fabric_pulls", "tick_phases", "slo_budget", "chip_ledger",
}


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, ttfm.params_from_jax(jp, "cpu")


def port_engine(tp, max_batch=2, cls=DecodeServer, **kw):
    return cls(tp, TCFG, max_batch=max_batch, device="cpu",
               paged_impl="kernel", **{**PAGED, **kw})


class _ParkedWait(DecodeServer):
    """The port's engine with its device wait parked until ``go`` is
    set: the serving loop's ticker then sits between step_begin and
    step_finish with the loop's lock released."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.in_wait = threading.Event()
        self.go = threading.Event()

    def step_wait(self, ent):
        if ent is not None and not self.go.is_set():
            self.in_wait.set()
            assert self.go.wait(timeout=60)
        super().step_wait(ent)


class _Paced(DecodeServer):
    """The port's engine with each tick's wait lasting 5 ms, as a
    device's would: on the CPU a tiny model's tick is over before a
    streaming handler is scheduled."""

    def step_wait(self, ent):
        time.sleep(0.005)
        super().step_wait(ent)


def want(jp, prompt, n):
    """The reference's generate: prompt + n greedy tokens."""
    return [int(t) for t in
            jgenerate(jp, JCFG, jnp.asarray([prompt], jnp.int32), n)[0]]


def serve(loop, cfg=None):
    """Start the port's HTTP surface over ``loop`` on 127.0.0.1:0;
    returns (httpd, url)."""
    httpd = make_http_server(
        cfg or ServerConfig(**MODEL, bf16=False, max_batch=2, port=0),
        loop, host="127.0.0.1")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def stop(httpd, loop):
    httpd.shutdown()
    loop.shutdown()
    httpd.server_close()


@pytest.fixture(scope="module")
def served(params):
    jp, tp = params
    loop = ServingLoop(port_engine(tp))
    httpd, url = serve(loop)
    yield url, jp
    stop(httpd, loop)


def post(url, body, timeout=120, headers=None, path="/v1/generate"):
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def post_status(url, body, path="/v1/generate"):
    """(status, JSON body) of a POST, errors included."""
    try:
        return 200, post(url, body, timeout=60, path=path)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(url, path, timeout=30):
    with urllib.request.urlopen(url + path, timeout=timeout) as r:
        return r.status, r.read()


def sse_post(url, body, timeout=120):
    """POST with stream=true; parse SSE frames into (batches, done, err)."""
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    batches, done, err = [], False, None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                done = True
                break
            frame = json.loads(payload)
            if "error" in frame:
                err = frame["error"]
                break
            batches.append(frame["tokens"])
    return batches, done, err


def metric_value(text, name):
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[-1])
    return 0.0


def count_of(text, name):
    return metric_value(text, name + "_count")


def _outcomes():
    c = default_registry().counter(
        "nos_tpu_serve_requests_total", "x", ("outcome",))
    return {o: c.value(o) for o in OUTCOMES}


def _outcome_delta(before):
    return {o: v - before[o] for o, v in _outcomes().items()
            if v != before[o]}


def _wait_until(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


class _FakeEngine:
    """Instant-completion engine stub (step()-only): isolates the loop's
    bookkeeping from real decode work."""

    def __init__(self):
        self.pending, self.done, self._rid = {}, {}, 0

    def submit(self, prompt, n, **kw):
        rid = self._rid
        self._rid += 1
        self.pending[rid] = n
        return rid

    def has_work(self):
        return bool(self.pending)

    def step(self):
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


class _Gated(_FakeEngine):
    """Holds every request in flight until ``release`` is set."""

    def __init__(self):
        super().__init__()
        self.release = threading.Event()

    def step(self):
        if not self.release.is_set():
            time.sleep(0.002)
            return 0
        return super().step()


# ---------------------------------------------------------------------------
# health (test_server_cmd.py:47, :104, :113-207)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["/healthz", "/readyz", "/metrics"])
def test_health_endpoints(served, path):
    url, _ = served
    status, body = get(url, path)
    assert status == 200
    if path != "/metrics":
        assert json.loads(body)["status"] == "ok"


def test_failed_loop_reports_unhealthy():
    class Boom:
        def has_work(self):
            return True

        def step(self):
            raise RuntimeError("device fell over")

        def submit(self, p, n):
            return 0

        def pop_result(self, rid):
            return None

    loop = ServingLoop(Boom())
    try:
        assert _wait_until(lambda: not loop.healthy, timeout=5)
        with pytest.raises(RuntimeError, match="serving loop failed"):
            loop.generate([1], 2)
    finally:
        loop.shutdown()


def test_tick_failure_wakes_wait_idle_and_flips_health_first():
    class Boom(_FakeEngine):
        def step(self):
            raise RuntimeError("device fell over mid-drain")

    eng = Boom()
    eng.pending[0] = 3
    loop = ServingLoop(eng)
    try:
        loop.begin_drain()
        observed = {}

        def waiter():
            t0 = time.monotonic()
            drained = loop.wait_idle(timeout=30)
            observed["healthy"] = loop.healthy
            observed["drained"] = drained
            observed["took"] = time.monotonic() - t0

        t = threading.Thread(target=waiter)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive(), "wait_idle never woke on tick failure"
        assert observed["healthy"] is False
        assert observed["drained"] is False
        assert observed["took"] < 5
    finally:
        loop.shutdown()


def test_reap_failure_marks_unhealthy_not_silent():
    class BadReap(_Gated):
        def pop_result(self, rid):
            if self.release.is_set() and rid in self.done:
                raise RuntimeError("reap boom")
            return super().pop_result(rid)

    eng = BadReap()
    loop = ServingLoop(eng)
    try:
        s = loop.stream([1], 3)
        s.close()
        assert _wait_until(lambda: s.rid in loop._abandoned)
        eng.release.set()
        assert _wait_until(lambda: not loop.healthy, timeout=10)
    finally:
        loop.shutdown()


# ---------------------------------------------------------------------------
# generate and streaming (:53, :61, :242, :300-425, :457)
# ---------------------------------------------------------------------------

def test_generate_over_http_matches_reference_generate(served):
    url, jp = served
    got = post(url, {"prompt": [1, 2, 3], "max_new_tokens": 5})
    assert got["tokens"] == want(jp, [1, 2, 3], 5)


def test_concurrent_requests_batch_and_stay_exact(served):
    url, jp = served
    prompts = [[1, 2], [9, 8, 7], [5], [3, 3, 3, 3]]
    results = [None] * len(prompts)

    def worker(i):
        results[i] = post(url, {"prompt": prompts[i],
                                "max_new_tokens": 6})["tokens"]

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    for i, p in enumerate(prompts):
        assert results[i] == want(jp, p, 6), f"request {i}"


def test_sampling_params_over_http(served):
    url, _ = served
    body = {"prompt": [4, 5], "max_new_tokens": 8,
            "temperature": 0.9, "top_k": 6, "seed": 77}
    a = post(url, body)["tokens"]
    results = {}

    def worker(name, b):
        results[name] = post(url, b)["tokens"]

    ts = [threading.Thread(target=worker, args=("same", dict(body))),
          threading.Thread(target=worker, args=(
              "other", {"prompt": [9, 9, 9], "max_new_tokens": 6,
                        "temperature": 1.1, "top_p": 0.8, "seed": 5}))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=180)
    assert results["same"] == a
    assert post(url, {**body, "seed": 78})["tokens"] != a


def test_streaming_matches_generate_and_terminates(params):
    jp, tp = params
    loop = ServingLoop(port_engine(tp, cls=_Paced))
    httpd, url = serve(loop)
    try:
        n = 12
        batches, done, err = sse_post(
            url, {"prompt": [4, 5], "max_new_tokens": n, "stream": True})
        assert err is None and done
        assert [4, 5] + [t for b in batches for t in b] \
            == want(jp, [4, 5], n)
        assert len(batches) >= 2               # incremental, not one blob
    finally:
        stop(httpd, loop)


def test_streaming_and_unary_share_the_batch(served):
    url, jp = served
    out = {}

    def stream_req():
        out["stream"] = sse_post(
            url, {"prompt": [7, 8], "max_new_tokens": 8, "stream": True})

    def unary_req():
        out["unary"] = post(url, {"prompt": [9], "max_new_tokens": 8})

    ts = [threading.Thread(target=stream_req),
          threading.Thread(target=unary_req)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in ts), "request thread wedged"
    batches, done, err = out["stream"]
    assert err is None and done
    assert [7, 8] + [t for b in batches for t in b] == want(jp, [7, 8], 8)
    assert out["unary"]["tokens"] == want(jp, [9], 8)


def test_stream_closed_before_first_next_does_not_leak():
    eng = _FakeEngine()
    loop = ServingLoop(eng)
    try:
        s = loop.stream([1, 2], 4)
        s.close()
        assert _wait_until(lambda: not eng.done and not eng.pending)
        assert _wait_until(lambda: not loop._abandoned)
    finally:
        loop.shutdown()


def test_stream_closed_after_completion_pops_immediately():
    eng = _FakeEngine()
    loop = ServingLoop(eng)
    try:
        s = loop.stream([1], 3)
        assert _wait_until(lambda: s.rid in eng.done)
        s.close()
        assert eng.done == {}
        assert s.rid not in loop._abandoned
    finally:
        loop.shutdown()


def test_stop_tokens_over_http(served):
    url, jp = served
    full = want(jp, [4, 5], 10)
    stop_tok = full[2 + 3]
    got = post(url, {"prompt": [4, 5], "max_new_tokens": 10,
                     "stop_tokens": [stop_tok]})["tokens"]
    first_at = full.index(stop_tok, 2)
    assert got == full[:first_at + 1] and got[-1] == stop_tok


def test_watch_attaches_to_a_streamed_request(params):
    """GET /v1/stream/<rid> attaches to a live request's remaining
    tokens; an unknown rid, and /v1/result/<rid> on a colocated replica,
    answer 404 unknown_rid as the reference's does."""
    jp, tp = params
    loop = ServingLoop(port_engine(tp))
    httpd, url = serve(loop)
    try:
        # a finished request stays mapped until a consumer accounts it
        s = loop.stream([3, 1], 6)
        w = loop.watch(s.rid)
        got = [t for d in w for t in d]
        assert [3, 1] + got == want(jp, [3, 1], 6)
        s.close()
        for path in ("/v1/stream/99", "/v1/result/0"):
            with pytest.raises(urllib.error.HTTPError) as e:
                get(url, path)
            assert e.value.code == 404
            assert json.loads(e.value.read())["reason"] == "unknown_rid"
    finally:
        stop(httpd, loop)


# ---------------------------------------------------------------------------
# validation (:82, :97, :269, :427)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("body,code", [
    ({"max_new_tokens": 5}, 400),                        # no prompt
    ({"prompt": [], "max_new_tokens": 5}, 400),
    ({"prompt": [1, 2], "max_new_tokens": -5}, 400),
    ({"prompt": [1], "max_new_tokens": 2, "top_k": 3}, 400),
    ({"prompt": [1, 2], "max_new_tokens": 2, "cache_prefix": "false"}, 400),
    ({"prompt": [1, 2], "max_new_tokens": 63}, 400),     # infeasible
    ({"prompt": [], "stream": True}, 400),               # before headers
])
def test_bad_requests_rejected(served, body, code):
    url, _ = served
    status, reply = post_status(url, body)
    assert status == code, reply
    assert reply["reason"] in ("bad_request", "infeasible")


def test_unknown_path_is_404(served):
    url, _ = served
    status, reply = post_status(url, {}, path="/nope")
    assert status == 404 and reply == {"error": "unknown path /nope"}


# ---------------------------------------------------------------------------
# paths whose engine feature is not ported: 404 with the knob's name
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,path,body,knob", [
    ("POST", "/v1/handoff", {}, "role=decode"),
    ("GET", "/v1/kvchain/abc", None, "kv_fabric_token"),
    ("POST", "/v1/generate",
     {"prompt": [1], "max_new_tokens": 2,
      "kv_sources": [{"url": "http://peer", "digest": "d"}]},
     "kv_sources"),
])
def test_unported_routes_answer_404_naming_the_knob(served, method, path,
                                                    body, knob):
    url, _ = served
    if method == "POST":
        status, reply = post_status(url, body, path=path)
    else:
        with pytest.raises(urllib.error.HTTPError) as e:
            get(url, path)
        status, reply = e.value.code, json.loads(e.value.read())
    assert status == 404
    assert reply["reason"] == "not_ported" and knob in reply["error"]


def test_prefill_role_request_is_refused_by_name(params):
    _, tp = params
    loop = ServingLoop(port_engine(tp))
    httpd, url = serve(loop, ServerConfig(**MODEL, port=0, role="prefill"))
    try:
        status, reply = post_status(url, {"prompt": [1], "max_new_tokens": 2})
        assert status == 404 and "role=prefill" in reply["error"]
        with pytest.raises(NotPorted, match="role=decode"):
            loop.adopt(b"")
    finally:
        stop(httpd, loop)


@pytest.mark.parametrize("kw,knob", [
    ({"role": "decode"}, "role=decode"),
    ({"tenant_quota": object()}, "tenant_quota"),
    ({"fabric_token": "s"}, "kv_fabric_token"),
])
def test_loop_refuses_unported_options(kw, knob):
    with pytest.raises(NotPorted, match=knob):
        ServingLoop(_FakeEngine(), **kw)


# ---------------------------------------------------------------------------
# metrics, stats and rates (:209, :224, :643-785, :949)
# ---------------------------------------------------------------------------

def test_tick_histograms_exported(served):
    url, _ = served
    post(url, {"prompt": [3, 1], "max_new_tokens": 4})
    _, text = get(url, "/metrics")
    text = text.decode()
    for name in ("nos_tpu_serve_tick_seconds",
                 "nos_tpu_serve_dispatch_gap_seconds"):
        assert count_of(text, name) > 0, name
    for ph in ("assemble", "dispatch", "wait", "sample", "bookkeep"):
        assert f'nos_tpu_serve_tick_phase_seconds_count{{phase="{ph}"}}' \
            in text


def test_metrics_count_requests_and_tokens(params):
    """Exactly the reference's counting: one finished outcome per
    request, and tokens_total counts decode-tick tokens (the first token
    of each request comes from prefill)."""
    _, tp = params
    loop = ServingLoop(port_engine(tp))
    httpd, url = serve(loop)
    try:
        reg = default_registry()
        tokens = reg.counter("nos_tpu_serve_tokens_total", "x")
        t0, before = tokens.value(), _outcomes()
        post(url, {"prompt": [2, 4], "max_new_tokens": 3})
        post(url, {"prompt": [6], "max_new_tokens": 5})
        assert _outcome_delta(before) == {"finished": 2}
        assert tokens.value() - t0 == (3 - 1) + (5 - 1)
        _, text = get(url, "/metrics")
        assert 'nos_tpu_serve_requests_total{outcome="finished"}' \
            in text.decode()
    finally:
        stop(httpd, loop)


def test_occupancy_and_rejection_metrics():
    reg = default_registry()
    rej = reg.counter("nos_tpu_serve_requests_total", "x", ("outcome",))
    rej0 = rej.value("rejected")

    class Bounded(_FakeEngine):
        def submit(self, prompt, n, **kw):
            if len(self.pending) >= 1:
                raise QueueFull("full (max_pending=1)")
            return super().submit(prompt, n, **kw)

        def occupancy(self):
            return 0, len(self.pending)

        def step(self):
            return 0

    loop = ServingLoop(Bounded())
    try:
        gen = loop.stream([1], 2)
        assert reg.gauge("nos_tpu_serve_pending_requests", "x").value() == 1
        with pytest.raises(QueueFull):
            loop.stream([2], 2)
        assert rej.value("rejected") == rej0 + 1
        gen.close()
    finally:
        loop.shutdown()


def test_gauges_remirror_after_disconnect_cancel():
    class Cancelable(_FakeEngine):
        def occupancy(self):
            return 0, len(self.pending)

        def cancel(self, rid):
            return self.pending.pop(rid, None) is not None

        def step(self):
            return 0

    reg = default_registry()
    loop = ServingLoop(Cancelable())
    try:
        gen = loop.stream([1], 4)
        assert reg.gauge("nos_tpu_serve_pending_requests", "x").value() == 1
        gen.close()
        assert reg.gauge("nos_tpu_serve_pending_requests", "x").value() == 0
    finally:
        loop.shutdown()


def test_stats_endpoint_schema(served):
    url, _ = served
    post(url, {"prompt": [2, 3], "max_new_tokens": 3})
    _, body = get(url, "/stats")
    snap = json.loads(body)
    assert set(snap) <= REPLICA_STATS_KEYS
    assert snap["engine"] == "DecodeServer" and snap["max_batch"] == 2
    assert isinstance(snap["slots"], list)
    for s in snap["slots"]:
        assert set(s) >= {"slot", "rid", "age_s", "pos", "tokens_out",
                          "max_new_tokens", "prefilling", "sampling"}
    assert set(snap["pending"]) == {"depth", "oldest_wait_s"}
    assert set(snap["pipeline"]) == {"depth", "decode_steps", "in_flight",
                                     "flushes", "ticks_dispatched"}
    assert set(snap["prefix_cache"]) == {"capacity", "entries", "hits",
                                         "tokens_saved"}
    # eager torch compiles nothing
    assert snap["compiles"] == {"count": 0, "seconds": 0.0}
    assert snap["tokens_emitted"] >= 1
    assert snap["healthy"] is True and snap["draining"] is False
    assert snap["recovering"] is False and snap["supervisor"] is None
    assert set(snap["deadline"]) == {"default_s", "active", "shed",
                                     "expired", "est_ttft_s",
                                     "est_tpot_s"}
    assert set(snap["slo"]) == {"ttft_ms", "tpot_ms", "completed",
                                "goodput"}
    assert set(snap["rates"]) == {"window_s", "tokens_per_s",
                                  "requests_per_s"}
    assert snap["slo_budget"] is None and snap["chip_ledger"] is None
    assert snap["prefill_sched"] is None and snap["prefix_index"] is None
    assert snap["tick_phases"]["window"] >= 1


def test_latency_histograms_exported_and_no_compiles(params):
    _, tp = params
    loop = ServingLoop(port_engine(tp))
    httpd, url = serve(loop)
    try:
        hist = {"queue": loop.h_queue, "ttft": loop.h_ttft,
                "e2e": loop.h_e2e}
        before = {n: h.observations()[0] for n, h in hist.items()}
        tpot0 = loop.h_tpot.observations()[0]
        c0 = loop.m_compiles.value()
        compile0 = loop.h_compile.observations()[0]
        post(url, {"prompt": [5, 1], "max_new_tokens": 4})
        for n, h in hist.items():
            assert h.observations()[0] == before[n] + 1, n
        # 4 new tokens -> 3 decode tokens, each one TPOT sample
        assert loop.h_tpot.observations()[0] == tpot0 + 3
        # eager torch compiles nothing: the series exist and stay put
        assert loop.m_compiles.value() == c0
        assert loop.h_compile.observations()[0] == compile0
        text = get(url, "/metrics")[1].decode()
        assert "nos_tpu_serve_compiles_total" in text
    finally:
        stop(httpd, loop)


def test_paged_engine_stats_and_gauges(served):
    url, jp = served
    got = post(url, {"prompt": [1, 2, 3], "max_new_tokens": 5,
                     "priority": 3, "tenant": "gold"})
    assert got["tokens"] == want(jp, [1, 2, 3], 5)
    _, body = get(url, "/stats")
    kv = json.loads(body)["kv"]
    assert kv["block_size"] == 8 and kv["blocks_total"] == 23
    assert kv["blocks_free"] + kv["blocks_used"] == kv["blocks_total"]
    assert kv["preempts"] == {"swap": 0, "recompute": 0}
    assert "cow_shared" in kv and "hbm" in kv
    text = default_registry().expose()
    for name in ("nos_tpu_serve_kv_blocks_free",
                 "nos_tpu_serve_kv_blocks_used",
                 "nos_tpu_serve_kv_blocks_cow_shared",
                 'nos_tpu_serve_preempt_total{mode="swap"}',
                 'nos_tpu_serve_preempt_total{mode="recompute"}'):
        assert name in text


def test_stats_rates_decay_when_idle():
    loop = ServingLoop(_FakeEngine())
    try:
        loop.generate([1], 3, timeout=10)
        assert loop.stats()["rates"]["requests_per_s"] > 0
        with loop._work:
            loop._rates = type(loop._rates)(
                (t - RATE_WINDOW_S - 1.0, tok, req)
                for t, tok, req in loop._rates)
        assert loop.stats()["rates"] == {
            "window_s": 0.0, "tokens_per_s": 0.0, "requests_per_s": 0.0}
    finally:
        loop.shutdown()


def test_debug_profile_and_traces(served):
    url, _ = served
    post(url, {"prompt": [2], "max_new_tokens": 3})
    _, body = get(url, "/debug/profile?ticks=4")
    events = json.loads(body)["traceEvents"]
    assert any(e.get("name") == "serve.tick" for e in events)
    with pytest.raises(urllib.error.HTTPError) as e:
        get(url, "/debug/profile?ticks=x")
    assert e.value.code == 400
    _, body = get(url, "/debug/traces")
    assert "traces" in json.loads(body)


# ---------------------------------------------------------------------------
# drain and load shedding (:533-640)
# ---------------------------------------------------------------------------

def test_drain_rejects_new_admits_finishes_inflight():
    eng = _Gated()
    loop = ServingLoop(eng)
    try:
        gen = loop.stream([1, 2], 3, timeout=30)
        loop.begin_drain()
        assert eng.pending
        with pytest.raises(DrainingError):
            loop.generate([3], 2, timeout=5)
        assert not loop.wait_idle(timeout=0.05)
        eng.release.set()
        assert [t for d in gen for t in d] == [0, 1, 2]
        assert loop.wait_idle(timeout=10)
        assert loop.draining
    finally:
        loop.shutdown()


def test_drain_over_http_503_readyz_flips_and_undrain():
    loop = ServingLoop(_FakeEngine())
    httpd, url = serve(loop)
    try:
        assert json.loads(get(url, "/readyz")[1])["status"] == "ok"
        assert post(url, {}, path="/admin/drain") == {"status": "draining"}
        with pytest.raises(urllib.error.HTTPError) as e:
            get(url, "/readyz")
        assert e.value.code == 503
        assert json.loads(e.value.read())["status"] == "draining"
        status, reply = post_status(url, {"prompt": [1],
                                          "max_new_tokens": 2})
        assert status == 503 and reply["reason"] == "draining"
        assert post(url, {}, path="/admin/undrain") == {"status": "ok"}
        assert post(url, {"prompt": [1], "max_new_tokens": 2})["tokens"] \
            == [1, 0, 1]
    finally:
        stop(httpd, loop)


def test_queue_full_is_http_429(params):
    """The real engine's max_pending bound: both slots busy and one
    waiting, the next request is shed 429 + Retry-After."""
    _, tp = params
    eng = port_engine(tp, max_pending=1, cls=_ParkedWait)
    loop = ServingLoop(eng)
    httpd, url = serve(loop)
    try:
        gens = [loop.stream([i + 1], 20) for i in range(3)]
        assert eng.in_wait.wait(timeout=30)     # nothing finishes
        req = urllib.request.Request(
            url + "/v1/generate",
            data=json.dumps({"prompt": [4], "max_new_tokens": 2}).encode(),
            method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 429
        assert e.value.headers.get("Retry-After") == "1"
        reply = json.loads(e.value.read())
        assert "shed load" in reply["error"]
        assert reply["reason"] == "queue_full"
        eng.go.set()
        for g in gens:
            g.close()
    finally:
        eng.go.set()
        stop(httpd, loop)


# ---------------------------------------------------------------------------
# outcomes, exactly once (:787-947)
# ---------------------------------------------------------------------------

def test_outcome_finished_exactly_once():
    loop = ServingLoop(_FakeEngine())
    try:
        before = _outcomes()
        loop.generate([1], 3, timeout=10)
        assert _outcome_delta(before) == {"finished": 1}
    finally:
        loop.shutdown()


class _Cancellable(_FakeEngine):
    def step(self):
        time.sleep(0.002)
        return 0

    def cancel(self, rid):
        if rid in self.pending:
            self.done[rid] = []
            del self.pending[rid]
            return True
        return False


class _Dropper(_FakeEngine):
    def step(self):
        time.sleep(0.002)
        return 0

    def cancel(self, rid):
        return self.pending.pop(rid, None) is not None


@pytest.mark.parametrize("engine_cls", [_Cancellable, _Dropper],
                         ids=["cancel_parks_partial", "cancel_drops"])
def test_outcome_cancelled_on_disconnect(engine_cls):
    loop = ServingLoop(engine_cls())
    try:
        before = _outcomes()
        s = loop.stream([1], 5)
        s.close()
        assert _wait_until(
            lambda: _outcome_delta(before) == {"cancelled": 1})
        assert _wait_until(lambda: not loop._abandoned)
    finally:
        loop.shutdown()


def test_outcome_abandoned_exactly_once():
    eng = _Gated()
    loop = ServingLoop(eng)
    try:
        before = _outcomes()
        s = loop.stream([1], 4)
        s.close()
        assert _wait_until(lambda: s.rid in loop._abandoned)
        eng.release.set()
        assert _wait_until(
            lambda: _outcome_delta(before) == {"abandoned": 1})
        assert s.rid not in loop._abandoned
    finally:
        loop.shutdown()


def test_outcome_failed_drain_accounts_exactly_once():
    class FailsOnRelease(_Gated):
        def step(self):
            if not self.release.is_set():
                time.sleep(0.002)
                return 0
            raise RuntimeError("engine died")

    eng = FailsOnRelease()
    loop = ServingLoop(eng)
    try:
        before = _outcomes()
        s1 = loop.stream([1], 4)
        s2 = loop.stream([2], 4)
        s1.close()
        assert _wait_until(lambda: s1.rid in loop._abandoned)
        eng.release.set()
        assert _wait_until(lambda: not loop.healthy)
        s2.close()
        assert _outcome_delta(before) == {"failed": 2}
        loop._forget(s2.rid)
        assert _outcome_delta(before) == {"failed": 2}
    finally:
        loop.shutdown()


def test_stress_many_clients_exactly_once(params):
    """More client threads than cores, with a shortened interpreter
    switch interval: streams that finish and streams closed mid-flight
    share the real engine's ticks, barrier flushes included. Every
    finished stream carries the reference's tokens and every request
    earns exactly one outcome."""
    import sys

    jp, tp = params
    loop = ServingLoop(port_engine(tp, max_batch=4))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        before = _outcomes()
        prompts = [[1 + i % 7, 2 + i % 5] for i in range(24)]
        got, errors = {}, []

        def client(i):
            try:
                s = loop.stream(prompts[i], 6, timeout=120)
                if i % 3 == 2:          # walks away after one delta
                    next(s)
                    s.close()
                    return
                got[i] = prompts[i] + [t for d in s for t in d]
            except BaseException as e:  # noqa: BLE001 — asserted below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads) and not errors
        for i, seq in got.items():
            assert seq == want(jp, prompts[i], 6), i
        assert _wait_until(lambda: sum(_outcome_delta(before).values())
                           == len(prompts), timeout=30)
        d = _outcome_delta(before)
        assert d["finished"] >= len(got)
        assert set(d) <= {"finished", "cancelled", "abandoned"}
        assert loop.healthy and not loop._abandoned
    finally:
        sys.setswitchinterval(interval)
        loop.shutdown()


def test_outcomes_exactly_once_through_the_barrier(params):
    """Real engine: one request runs to completion, one is cancelled
    mid-decode (cancel is a barrier: the in-flight tick lands first),
    one is cancelled while still pending. Each earns exactly one
    outcome."""
    _, tp = params
    loop = ServingLoop(port_engine(tp))
    try:
        before = _outcomes()
        runner = loop.stream([1, 2], 10)
        victim = loop.stream([3, 4], 48)    # still decoding at close
        waiter = loop.stream([5], 8)        # pends: both slots busy
        waiter.close()
        victim.close()
        for _ in runner:
            pass
        assert _wait_until(
            lambda: sum(_outcome_delta(before).values()) == 3)
        d = _outcome_delta(before)
        assert d["finished"] == 1
        assert d.get("cancelled", 0) + d.get("abandoned", 0) == 2
    finally:
        loop.shutdown()


# ---------------------------------------------------------------------------
# the split step's barrier flush: a submit and a cancel while a tick is
# between step_begin and step_finish
# ---------------------------------------------------------------------------

def test_engine_barrier_flush_keeps_tokens(params):
    jp, tp = params
    eng = port_engine(tp, max_batch=3)
    a = eng.submit([1, 2, 3], 7)
    b = eng.submit([9, 8], 12)
    eng.step()
    handle = eng.step_begin()
    assert handle is not None and not handle.consumed
    c = eng.submit([4, 4, 4], 6)            # admission: barrier flush
    assert handle.consumed
    assert eng.cancel(b)                    # already flushed: no-op barrier
    eng.step_wait(handle)                   # no-op on a consumed tick
    assert eng.step_finish(handle) == 2     # a's and b's flushed tokens
    assert eng.step_finish(None) == 0       # credited once
    out = eng.drain()
    assert out[a] == want(jp, [1, 2, 3], 7)
    assert out[c] == want(jp, [4, 4, 4], 6)
    full_b = want(jp, [9, 8], 12)
    assert out[b] == full_b[:len(out[b])] and len(out[b]) == 2 + 3


def test_loop_barrier_flush_under_a_blocked_wait(params):
    """The ticker blocked in step_wait (lock released) while a handler
    submits (admission flushes the in-flight tick, then prefills) and
    another closes its stream (cancel): the tick is consumed exactly
    once, the survivors' tokens equal an undisturbed run, and every
    request earns one outcome."""
    jp, tp = params
    eng = port_engine(tp, max_batch=3, cls=_ParkedWait)
    loop = ServingLoop(eng)
    try:
        before = _outcomes()
        runner = loop.stream([1, 2], 8)
        victim = loop.stream([7, 7], 20)
        assert eng.in_wait.wait(timeout=30)     # ticker parked, unlocked
        late = loop.stream([5, 6, 7], 6)        # barrier flush + prefill
        victim.close()                          # cancel: barrier again
        flushes = eng.pipeline_flushes
        eng.go.set()
        got_r = [1, 2] + [t for d in runner for t in d]
        got_l = [5, 6, 7] + [t for d in late for t in d]
        assert got_r == want(jp, [1, 2], 8)
        assert got_l == want(jp, [5, 6, 7], 6)
        assert flushes == 1                     # the tick consumed once
        assert _wait_until(
            lambda: _outcome_delta(before) == {"finished": 2,
                                               "cancelled": 1})
    finally:
        eng.go.set()
        loop.shutdown()


class _HeldEvent:
    """Stands in for a tick's CUDA event: the first ``synchronize`` (the
    ticker's, inside ``step_wait``, with the loop's lock released) blocks
    until ``go``; a later one (a barrier flush's) returns at once, as a
    finished copy's would."""

    def __init__(self):
        self.entered = threading.Event()
        self.go = threading.Event()

    def synchronize(self):
        if not self.entered.is_set():
            self.entered.set()
            assert self.go.wait(timeout=60)


def test_flush_while_the_ticker_is_inside_the_device_wait(params):
    """A handler's barrier flush consumes the tick while the ticker sits
    inside the event's synchronize (past step_wait's consumed check):
    both fetch the same tick, the ticker's fetch still reads its tokens,
    and the tokens equal an undisturbed run."""
    jp, tp = params
    first = _HeldEvent()

    class HeldFirstTick(DecodeServer):
        def _dispatch_tick(self, active):
            super()._dispatch_tick(active)
            if not first.go.is_set():
                self._inflight.event = first

    eng = port_engine(tp, max_batch=3, cls=HeldFirstTick)
    loop = ServingLoop(eng)
    try:
        before = _outcomes()
        a = loop.stream([1, 2], 6)
        assert first.entered.wait(timeout=30)   # ticker inside the wait
        b = loop.stream([8, 9, 10], 5)          # flush + prefill
        first.go.set()
        got_a = [1, 2] + [t for d in a for t in d]
        got_b = [8, 9, 10] + [t for d in b for t in d]
        assert got_a == want(jp, [1, 2], 6)
        assert got_b == want(jp, [8, 9, 10], 5)
        assert loop.healthy and eng.pipeline_flushes == 1
        assert _wait_until(
            lambda: _outcome_delta(before) == {"finished": 2})
    finally:
        first.go.set()
        loop.shutdown()


# ---------------------------------------------------------------------------
# SLO counters (:971, goodput counters only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target_ms,verdict,goodput", [
    (600000.0, "met", 1.0), (1e-6, "breached", 0.0)])
def test_slo_counters_and_goodput(params, target_ms, verdict, goodput):
    _, tp = params
    reg = default_registry()
    slo = reg.counter("nos_tpu_serve_slo_total", "x", ("slo", "outcome"))
    base = {k: slo.value(k, verdict) for k in ("ttft", "tpot")}
    loop = ServingLoop(port_engine(tp, max_batch=1),
                       slo_ttft_ms=target_ms, slo_tpot_ms=target_ms)
    try:
        loop.generate([1, 2], 4, timeout=120)
        for k in ("ttft", "tpot"):
            assert slo.value(k, verdict) == base[k] + 1
        assert reg.gauge("nos_tpu_serve_goodput_ratio", "x").value() \
            == goodput
        assert loop.stats()["slo"]["goodput"] == goodput
    finally:
        loop.shutdown()


# ---------------------------------------------------------------------------
# deadlines: shed at admission, expiry at the tick barrier
# ---------------------------------------------------------------------------

def test_deadline_expiry_is_504_and_outcome_deadline():
    loop = ServingLoop(_Gated())
    httpd, url = serve(loop)
    try:
        before = _outcomes()
        status, reply = post_status(url, {"prompt": [1], "max_new_tokens": 3,
                                          "deadline_s": 0.05})
        assert status == 504 and reply["deadline_exceeded"] is True
        assert _outcome_delta(before) == {"deadline": 1}
        status, reply = post_status(url, {"prompt": [1], "max_new_tokens": 3,
                                          "deadline_s": "nan"})
        assert status == 400
    finally:
        stop(httpd, loop)


def test_unmeetable_deadline_is_shed_429():
    loop = ServingLoop(_FakeEngine())
    try:
        loop._est_ttft_s, loop._est_tpot_s = 1.0, 0.5
        before = _outcomes()
        with pytest.raises(QueueFull) as e:
            loop.generate([1], 8, deadline_s=0.5, timeout=5)
        assert e.value.reason == "deadline_unmeetable"
        assert _outcome_delta(before) == {"deadline": 1}
        assert loop.stats()["deadline"]["shed"] == 1
    finally:
        loop.shutdown()


# ---------------------------------------------------------------------------
# supervised recovery over the real engine
# ---------------------------------------------------------------------------

def test_step_error_rebuilds_engine_and_fails_live_requests(params):
    """A tick that raises: the loop rebuilds the engine through the
    factory, the live request (no capture in the torch engine) is
    accounted ``failed`` exactly once, and the rebuilt engine serves."""
    jp, tp = params

    class FailOnce(DecodeServer):
        armed = True

        def step_begin(self):
            if FailOnce.armed and self._active:
                FailOnce.armed = False
                raise RuntimeError("injected tick failure")
            return super().step_begin()

    def factory():
        return port_engine(tp, cls=FailOnce)

    dead = factory()
    loop = ServingLoop(dead, engine_factory=factory, restart_budget=1,
                       restart_backoff_s=0.0)
    try:
        before = _outcomes()
        with pytest.raises(RuntimeError, match="lost in engine restart"):
            loop.generate([1, 2], 5, timeout=30)
        assert _wait_until(lambda: not loop.recovering
                           and loop.engine is not dead)
        assert dead.params is None and dead.cache is None   # released
        assert loop.generate([3], 4, timeout=60) == want(jp, [3], 4)
        assert _outcome_delta(before) == {"failed": 1, "finished": 1}
        sup = loop.stats()["supervisor"]
        assert sup["restarts"] == 1 and sup["lost"] == 1
        assert loop.healthy
    finally:
        loop.shutdown()


# ---------------------------------------------------------------------------
# build_engine flags (:1065-1260), for the knobs the port serves or
# refuses by name
# ---------------------------------------------------------------------------

def test_build_engine_paged_flags_and_validation():
    eng = build_engine(ServerConfig(**MODEL, bf16=False, max_batch=2,
                                    kv_block_size=8, kv_blocks=16),
                       device="cpu")
    assert eng.paged and eng.kv_block_size == 8
    assert eng.kv_stats()["blocks_total"] == 15
    assert eng.kv_stats()["kernel"] == "kernel"
    eng = build_engine(ServerConfig(**MODEL, bf16=False, max_batch=2,
                                    kv_block_size=8, kv_blocks=16,
                                    kv_dtype="int8", paged_kernel="off"),
                       device="cpu")
    assert eng.kv_stats()["dtype"] == "int8"
    assert eng.kv_stats()["kernel"] == "xla"


@pytest.mark.parametrize("kw,match", [
    (dict(kv_block_size=12, kv_blocks=16), "power of two"),
    (dict(kv_block_size=128, kv_blocks=16), "multiple of"),
    (dict(kv_block_size=8, kv_blocks=1), "kv_blocks"),
    (dict(role="proxy"), "role must be"),
    (dict(role="decode"), "paged KV"),
    (dict(role="prefill", kv_block_size=8, kv_blocks=16), "decode-pool"),
    (dict(role="prefill", decode_pool="http://d0:8000", kv_block_size=8,
          kv_blocks=16, draft_checkpoint_dir="/nope"), "speculative"),
    (dict(kv_dtype="int8"), "paged"),
    (dict(kv_block_size=8, kv_blocks=16, kv_dtype="fp8"), "bf16\\|int8"),
    (dict(draft_checkpoint_dir="/ckpt/d", draft_n_tokens=0),
     "draft_n_tokens"),
    (dict(kv_block_size=8, kv_blocks=16, paged_kernel="maybe"),
     "on\\|off"),
])
def test_build_engine_validation_messages(kw, match):
    with pytest.raises(ValueError, match=match):
        build_engine(ServerConfig(**MODEL, **kw), device="cpu")


@pytest.mark.parametrize("kw,knob", [
    (dict(tp=2), "tp"),
    (dict(draft_checkpoint_dir="/nope"), "draft_checkpoint_dir"),
    (dict(tenant_config='{"tenants": {}}'), "tenant_config"),
    (dict(kv_fabric_token="s"), "kv_fabric_token"),
    (dict(role="decode"), "role=decode"),
    (dict(role="prefill", decode_pool="http://d0:8000"), "role=prefill"),
    (dict(prefill_chunk=16), "prefill_chunk"),
    (dict(pipeline_depth=2), "pipeline_depth"),
    (dict(decode_steps=2), "decode_steps"),
    (dict(kv_swap=False), "kv_swap"),
    (dict(kv_blocks=0, kv_block_size=0), "kv_blocks=0"),
])
def test_build_engine_refuses_unported_knobs_by_name(kw, knob):
    cfg = ServerConfig(**{**MODEL, **PAGED, **kw})
    with pytest.raises(NotPorted, match=knob):
        build_engine(cfg, device="cpu")


# ---------------------------------------------------------------------------
# main's flags against the reference's main
# ---------------------------------------------------------------------------

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


FLAG_LINES = [
    [],
    ["--kv-block-size", "16", "--kv-blocks", "32", "--kv-swap", "off"],
    ["--kv-dtype", "int8", "--draft-checkpoint-dir", "/ckpt/draft",
     "--draft-n-tokens", "6", "--checkpoint-dir", "/ckpt"],
    ["--paged-kernel", "off", "--port", "9000", "--pipeline-depth", "2",
     "--decode-steps", "4", "--prefill-chunk", "64",
     "--prefill-budget", "128", "--kv-swap", "on"],
    ["--restart-budget", "5", "--watchdog-s", "2.5",
     "--default-deadline-s", "30", "--device-stats-interval", "5"],
    ["--role", "prefill", "--decode-pool", "http://d0:8000,http://d1:8000",
     "--handoff-cooldown-s", "2", "--handoff-health-interval-s", "1"],
    ["--slo-ttft-ms", "200", "--slo-tpot-ms", "50",
     "--slo-fast-window-s", "60", "--slo-slow-window-s", "600",
     "--slo-burn-threshold", "6", "--slo-capture-interval-s", "30",
     "--log-format", "json", "--trace-sampling", "1"],
    ["--kv-host-tier-bytes", "1000", "--kv-fabric-token", "s3cret",
     "--config", "{config}"],
]


def _main_config(module, argv, monkeypatch):
    seen = {}

    def fake_build(cfg, *a, **kw):
        seen["cfg"] = cfg
        raise SystemExit(0)          # stop before the serving loop

    monkeypatch.setattr(module, "build_engine", fake_build)
    with pytest.raises(SystemExit):
        module.main(argv)
    return dataclasses.asdict(seen["cfg"])


@pytest.mark.parametrize("argv", FLAG_LINES,
                         ids=lambda a: " ".join(a)[:40] or "defaults")
def test_main_flags_give_the_reference_config(argv, monkeypatch, tmp_path,
                                              restore_logging):
    from nos_tpu.cmd import server as jserver

    config = tmp_path / "server.yaml"
    config.write_text("max_batch: 4\nkv_blocks: 64\nkv_block_size: 8\n"
                      "slo_ttft_ms: 500\ntp: 2\n")
    argv = [a.replace("{config}", str(config)) for a in argv]
    got = _main_config(tserver, argv, monkeypatch)
    ref = _main_config(jserver, argv, monkeypatch)
    assert got == ref


@pytest.mark.parametrize("argv,knob", [
    (["--kv-blocks", "16", "--kv-block-size", "8", "--role", "decode"],
     "role=decode"),
    (["--kv-blocks", "16", "--kv-block-size", "8",
      "--tenant-config", '{"tenants": {}}'], "tenant_config"),
    (["--kv-blocks", "16", "--kv-block-size", "8",
      "--draft-checkpoint-dir", "/d"], "draft_checkpoint_dir"),
    (["--kv-blocks", "16", "--kv-block-size", "8",
      "--kv-fabric-token", "s"], "kv_fabric_token"),
    (["--kv-blocks", "16", "--kv-block-size", "8",
      "--pipeline-depth", "2"], "pipeline_depth"),
])
def test_main_refused_knob_exits_naming_it(argv, knob, capsys,
                                           restore_logging):
    with pytest.raises(SystemExit) as e:
        tserver.main(argv)
    assert e.value.code == 2
    assert knob in capsys.readouterr().err


def test_main_validates_like_the_reference(restore_logging):
    with pytest.raises(ValueError, match="restart_budget"):
        tserver.main(["--restart-budget", "-1"])
    with pytest.raises(ValueError, match="watchdog_s"):
        tserver.main(["--watchdog-s", "-0.5"])


# ---------------------------------------------------------------------------
# side by side: the reference replica and the port replica over HTTP
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def replicas(params):
    """(reference url, port url, params): the same params in the
    reference's ServingLoop + make_http_server over its paged engine on
    the gather formulation, and in the port's on the CPU."""
    from nos_tpu.cmd import server as jserver
    from nos_tpu.models.serving import DecodeServer as JDecodeServer

    jp, tp = params
    with pytest.MonkeyPatch.context() as mp:
        # read once at the reference engine's build; restored after
        mp.setenv("NOS_TPU_PAGED_KERNEL", "0")
        jeng = JDecodeServer(jp, JCFG, max_batch=2, **PAGED)
    assert jeng.paged_kernel == "xla"
    cfg = jserver.ServerConfig(**MODEL, bf16=False, max_batch=2, port=0)
    jloop = jserver.ServingLoop(jeng)
    jhttpd = jserver.make_http_server(cfg, jloop)
    threading.Thread(target=jhttpd.serve_forever, daemon=True).start()
    tloop = ServingLoop(port_engine(tp))
    thttpd, turl = serve(tloop)
    try:
        yield (f"http://127.0.0.1:{jhttpd.server_address[1]}", turl, jp)
    finally:
        stop(jhttpd, jloop)
        stop(thttpd, tloop)


SIDE_BY_SIDE = [
    {"prompt": [1, 2, 3], "max_new_tokens": 6},
    {"prompt": [9, 8, 7, 6, 5], "max_new_tokens": 9},
    {"prompt": [4, 5], "max_new_tokens": 8, "temperature": 0.9,
     "top_k": 6, "seed": 77},
    {"prompt": [9, 9, 9], "max_new_tokens": 7, "temperature": 1.1,
     "top_p": 0.8, "seed": 5},
    {"prompt": [3], "max_new_tokens": 10, "temperature": 0.7, "seed": 1},
    {"prompt": [4, 5], "max_new_tokens": 10, "stop_tokens": [27, 11]},
]


@pytest.mark.parametrize("stream", [False, True], ids=["unary", "sse"])
@pytest.mark.parametrize("body", SIDE_BY_SIDE,
                         ids=[f"body{i}" for i in range(len(SIDE_BY_SIDE))])
def test_side_by_side_tokens(replicas, body, stream):
    jurl, turl, jp = replicas

    def tokens(url):
        if not stream:
            return post(url, body)["tokens"]
        batches, done, err = sse_post(url, {**body, "stream": True})
        assert done and err is None
        return body["prompt"] + [t for b in batches for t in b]

    ref = tokens(jurl)
    assert tokens(turl) == ref
    if "temperature" not in body and "stop_tokens" not in body:
        assert ref == want(jp, body["prompt"], body["max_new_tokens"])


@pytest.mark.parametrize("path,body", [
    ("/v1/generate", {"max_new_tokens": 5}),
    ("/v1/generate", {"prompt": [], "max_new_tokens": 5}),
    ("/nope", {}),
    ("/v1/generate", {"prompt": [1, 2], "max_new_tokens": -5}),
    ("/v1/generate", {"prompt": [1], "max_new_tokens": 2, "top_k": 3}),
    ("/v1/generate", {"prompt": [], "stream": True}),
    ("/v1/generate", {"prompt": [1, 2], "max_new_tokens": 63}),
    ("/v1/generate", {"prompt": [1], "max_new_tokens": 2,
                      "tenant": "a\nb"}),
])
def test_side_by_side_errors(replicas, path, body):
    jurl, turl, _ = replicas
    assert post_status(turl, body, path) == post_status(jurl, body, path)


def test_side_by_side_stats_keys(replicas):
    jurl, turl, _ = replicas
    snaps = [json.loads(get(u, "/stats")[1]) for u in (jurl, turl)]
    assert set(snaps[1]) == set(snaps[0])
    assert set(snaps[1]) <= REPLICA_STATS_KEYS
    for key in ("pending", "pipeline", "prefix_cache", "kv", "deadline",
                "slo", "rates", "per_request", "tick_phases"):
        assert set(snaps[1][key]) == set(snaps[0][key]), key


def test_reference_gateway_in_front_of_the_port(replicas):
    """The reference gateway (GatewayRouter + its HTTP surface) routes a
    unary and an SSE request to the port replica, and returns the
    replica's tokens."""
    from nos_tpu.cmd.gateway import (
        HttpReplicaTransport, make_http_server as make_gw_server,
    )
    from nos_tpu.gateway import GatewayRouter, Replica, RouterConfig

    _, turl, _ = replicas
    transport = HttpReplicaTransport(timeout_s=30.0)
    router = GatewayRouter(
        RouterConfig(max_attempts=4, backoff_s=0.002),
        transport=transport.send, stream_transport=transport.send_stream)
    router.update([Replica(name="port0", handle=turl)])
    gw_httpd = make_gw_server(router, 0, "web")
    threading.Thread(target=gw_httpd.serve_forever, daemon=True).start()
    gw = f"http://127.0.0.1:{gw_httpd.server_address[1]}"
    try:
        body = {"prompt": [6, 1, 2], "max_new_tokens": 7}
        direct = post(turl, body)["tokens"]
        through = post(gw, {**body, "deadline_s": 30})
        assert through["tokens"] == direct
        assert through["replica"] == "port0"
        batches, done, err = sse_post(gw, {**body, "stream": True})
        assert done and err is None
        assert body["prompt"] + [t for b in batches for t in b] == direct
    finally:
        gw_httpd.shutdown()
        gw_httpd.server_close()


def test_tracing_spans_carry_an_inbound_traceparent(served):
    """The serve.request span adopts the caller's W3C trace context."""
    url, _ = served
    tid = "4bf92f3577b34da6a3ce929d0e0e4736"
    post(url, {"prompt": [1], "max_new_tokens": 2},
         headers={"traceparent": f"00-{tid}-00f067aa0ba902b7-01"})
    spans = tracing.recorder().trace(tid)
    assert any(sp.name == "serve.request" for sp in spans)
