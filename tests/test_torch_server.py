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
from collections import deque

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
from nos_tpu_torch.models.tenantquota import TenantQuotaConfig  # noqa: E402
from nos_tpu_torch.obs import tracing  # noqa: E402
from nos_tpu_torch.utils.metrics import default_registry  # noqa: E402

# the reference's tests/test_server_cmd.py:19-20
MODEL = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq=64)
JCFG = jtfm.TransformerConfig(**MODEL, dtype=jnp.float32)
TCFG = ttfm.TransformerConfig(**MODEL, dtype=torch.float32)
PAGED = dict(kv_block_size=8, kv_blocks=24)
# knobs build_engine and main refused until the KV fabric and tenant
# quotas were ported, served now
SERVED_KNOBS = {"tenant_config", "kv_host_tier_bytes", "kv_fabric_token",
                "kv_blocks=0"}
# refused until checkpoint loading was ported, served now
CHECKPOINT_KNOBS = {"checkpoint_dir", "draft_checkpoint_dir"}
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
# the KV fabric's surfaces on a replica without the fabric token: a
# kv_sources offer is counted pull_denied and the request is served, the
# chain export answers 403 (the reference's, tests/test_server_cmd.py:1827)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,path,body,knob", [
    ("POST", "/v1/generate",
     {"prompt": [1], "max_new_tokens": 2, "stream": True,
      "kv_sources": [{"url": "http://peer", "digest": "d"}]},
     "kv_sources"),
    ("GET", "/v1/kvchain/abc", None, "kv_fabric_token"),
    ("POST", "/v1/generate",
     {"prompt": [1], "max_new_tokens": 2,
      "kv_sources": [{"url": "http://peer", "digest": "d"}]},
     "kv_sources"),
])
def test_unported_routes_answer_404_naming_the_knob(served, method, path,
                                                    body, knob):
    """These routes answered 404 naming the knob while the fabric was not
    ported; now a replica serves them as the reference's does. Without
    the fleet's token (this replica has none) a ``kv_sources`` offer is
    never fetched: it is counted ``pull_denied`` and the request is
    served (unary or SSE) with the reference's tokens; the chain export
    answers 403 ``fabric_token``."""
    url, jp = served

    def denied():
        return json.loads(get(url, "/stats")[1])["kv_fabric_pulls"][
            "pull_denied"]

    before = denied()
    if method == "GET":
        with pytest.raises(urllib.error.HTTPError) as e:
            get(url, path)
        assert e.value.code == 403
        assert json.loads(e.value.read()) == {
            "error": "kv fabric token required", "reason": "fabric_token"}
        assert denied() == before
        return
    if body.get("stream"):
        batches, done, err = sse_post(url, body)
        assert done and err is None
        got = [t for b in batches for t in b]
    else:
        got = post(url, body)["tokens"]
    assert got == want(jp, body["prompt"], body["max_new_tokens"])[
        -len(got):] if body.get("stream") else \
        want(jp, body["prompt"], body["max_new_tokens"])
    assert denied() == before + 1
    assert knob == "kv_sources"


def test_prefill_role_request_is_refused_by_name(params):
    """role=prefill is served now: a prefill-role replica answers a
    POST with the handoff descriptor of a decode-role loop that adopted
    the request (shipped in process here), and the decode loop's result
    is the reference's tokens; a request its first token completes
    answers with tokens."""
    jp, tp = params
    dec = ServingLoop(port_engine(tp, role="decode"), role="decode")
    loop = ServingLoop(port_engine(tp, role="prefill"), role="prefill",
                       handoff_targets=["in-process"],
                       handoff_send=lambda target, data: dec.adopt(data))
    httpd, url = serve(loop, ServerConfig(**MODEL, port=0, role="prefill"))
    try:
        reply = post(url, {"prompt": [1, 2], "max_new_tokens": 5})
        assert reply["handoff"]["target"] == "in-process"
        assert dec.result(reply["handoff"]["rid"], timeout=60) == \
            want(jp, [1, 2], 5)
        assert post(url, {"prompt": [3], "max_new_tokens": 1}) == \
            {"tokens": want(jp, [3], 1)}
    finally:
        stop(httpd, loop)
        dec.shutdown()


@pytest.mark.parametrize("kw,knob", [
    ({"role": "decode", "fabric_token": "s"}, "kv_fabric_token"),
    ({"tenant_quota": TenantQuotaConfig.from_json(
        '{"tenants": {"gold": {"min_rate": 5}}}')}, "tenant_quota"),
    ({"fabric_token": "s"}, "kv_fabric_token"),
])
def test_loop_refuses_unported_options(kw, knob):
    """The loop refused a tenant quota and the fabric token while they
    were not ported; now it serves them: the token gates its peer pulls
    and the quota registers the per-tenant series, with the reference's
    /stats keys (tests/test_server_cmd.py's loop options)."""
    loop = ServingLoop(_FakeEngine(), **kw)
    try:
        assert loop.generate([1, 2], 3, timeout=30) == [1, 2, 0, 1, 2]
        stats = loop.stats()
        assert stats["kv_fabric_pulls"] == {
            "pull_hit": 0, "pull_miss": 0, "pull_denied": 0}
        if knob == "kv_fabric_token":
            assert loop.fabric_token == "s"
        else:
            assert loop._tenant_cfg is kw["tenant_quota"]
            text = default_registry().expose()
            assert 'nos_tpu_serve_tenant_tokens_total{tenant="gold"}' \
                in text
            assert stats["slo_budget"] is None
            assert stats["chip_ledger"] is None
    finally:
        loop.shutdown()


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
    # the CPU captures no graph: nothing is compiled
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
        # the CPU captures no graph: the series exist and stay put
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
                self._inflight[-1].event = first

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
    """A tick that raises: the loop captures the live request, rebuilds
    the engine through the factory and resumes it (swap), so it finishes
    with the undisturbed tokens; nothing is accounted ``failed``, and the
    rebuilt engine serves."""
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
        assert loop.generate([1, 2], 5, timeout=60) == want(jp, [1, 2], 5)
        assert _wait_until(lambda: not loop.recovering
                           and loop.engine is not dead)
        assert dead.params is None and dead.cache is None   # released
        assert loop.generate([3], 4, timeout=60) == want(jp, [3], 4)
        assert _outcome_delta(before) == {"finished": 2}
        sup = loop.stats()["supervisor"]
        assert sup["restarts"] == 1 and sup["lost"] == 0
        assert sup["resumed"] == {"swap": 1, "recompute": 0}
        assert loop.healthy
    finally:
        loop.shutdown()


def test_step_error_at_depth_2_accounts_every_live_request_once(params):
    """A pipelined, fused engine (depth 2, T 4) fails a tick with two
    requests live and ticks in flight: the loop rebuilds it and resumes
    both (swap), each finishing exactly once with the undisturbed
    tokens; the dead engine keeps no graph, window or static buffer,
    and the rebuilt engine serves."""
    jp, tp = params

    class ParkThenFail(_ParkedWait):
        armed = True

        def step_wait(self, ent):
            if ParkThenFail.armed and self.go.is_set() \
                    and len(self._active) == 2 and len(self._inflight) == 2:
                ParkThenFail.armed = False
                raise RuntimeError("injected tick failure")
            super().step_wait(ent)

    def factory():
        eng = port_engine(tp, cls=ParkThenFail, pipeline_depth=2,
                          decode_steps=4)
        eng.go.set()
        return eng

    dead = port_engine(tp, cls=ParkThenFail, pipeline_depth=2,
                       decode_steps=4)
    loop = ServingLoop(dead, engine_factory=factory, restart_budget=1,
                       restart_backoff_s=0.0)
    try:
        before = _outcomes()
        a = loop.stream([1, 2], 40)
        assert dead.in_wait.wait(timeout=30)    # ticker parked, unlocked
        b = loop.stream([5, 6, 7], 40)          # barrier flush + prefill
        assert dead._inflight == deque() and len(dead._active) == 2
        dead.go.set()
        for st, prompt in ((a, [1, 2]), (b, [5, 6, 7])):
            toks = list(prompt)
            for delta in st:
                toks.extend(delta)
            assert toks == want(jp, prompt, 40)
        assert _wait_until(lambda: not loop.recovering
                           and loop.engine is not dead)
        assert dead.params is None and dead.cache is None
        assert not dead._graphs and dead._capture_stream is None
        assert dead._keep is None and dead._toks is None
        assert not dead._inflight
        assert loop.generate([3], 9, timeout=60) == want(jp, [3], 9)
        assert _wait_until(lambda: _outcome_delta(before)
                           == {"finished": 3})
        sup = loop.stats()["supervisor"]
        assert sup["restarts"] == 1 and sup["lost"] == 0
        assert sup["resumed"] == {"swap": 2, "recompute": 0}
        assert loop.healthy
    finally:
        dead.go.set()
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
    (dict(role="decode", tenant_config='{"tenants": {}}'), "tenant_config"),
    (dict(role="prefill", decode_pool="http://d0:8000",
          kv_host_tier_bytes=1024, prefix_cache_size=4),
     "kv_host_tier_bytes"),
    (dict(checkpoint_dir="/c"), "checkpoint_dir"),
    (dict(kv_swap=False, tp=2), "tp"),
    (dict(kv_blocks=0, kv_block_size=0), "kv_blocks=0"),
])
def test_build_engine_refuses_unported_knobs_by_name(kw, knob, tmp_path):
    """Knobs outside the port raise ``NotPorted`` by name before any
    weights; the tenant config, the host tier and the fabric token were
    among them and are served now: the engine carries the quota and the
    tier, and the token builds (it gates the loop's HTTP surfaces). So
    are the checkpoint directories: one with no committed step (under
    the test's own directory) raises the reference's ``no checkpoint
    under``."""
    cfg = ServerConfig(**{**MODEL, **PAGED, **kw})
    if knob in CHECKPOINT_KNOBS:
        missing = str(tmp_path / kw[knob].lstrip("/"))
        with pytest.raises(FileNotFoundError,
                           match=f"no checkpoint under {missing}"):
            build_engine(dataclasses.replace(cfg, bf16=False,
                                             **{knob: missing}),
                         device="cpu")
        return
    if knob not in SERVED_KNOBS:
        with pytest.raises(NotPorted, match=knob):
            build_engine(cfg, device="cpu")
        return
    eng = build_engine(dataclasses.replace(cfg, bf16=False), device="cpu")
    if knob == "tenant_config":
        assert eng._tq is not None and eng.tenant_snapshot() is not None
    elif knob == "kv_host_tier_bytes":
        assert eng._host_tier.capacity_bytes == 1024
        assert eng._pindex.on_evict == eng._demote_chain
    elif knob == "kv_blocks=0":
        # the reference's default: the slot-static engine
        assert not eng.paged and eng.kv_stats() is None
    else:
        assert eng._tq is None and eng._host_tier is None
    assert eng.role == cfg.role


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
    (["--kv-blocks", "16", "--kv-block-size", "8", "--role", "decode",
      "--kv-host-tier-bytes", "1024", "--prefix-cache-size", "4"],
     "kv_host_tier_bytes"),
    (["--kv-blocks", "16", "--kv-block-size", "8",
      "--tenant-config", '{"tenants": {}}'], "tenant_config"),
    (["--kv-blocks", "16", "--kv-block-size", "8",
      "--draft-checkpoint-dir", "/d"], "draft_checkpoint_dir"),
    (["--kv-blocks", "16", "--kv-block-size", "8",
      "--kv-fabric-token", "s"], "kv_fabric_token"),
])
def test_main_refused_knob_exits_naming_it(argv, knob, capsys,
                                           restore_logging, monkeypatch,
                                           tmp_path):
    """A knob outside the port exits 2 naming it. The host tier, the
    tenant config and the fabric token were refused so, and are served
    now: their flags reach the config ``main`` builds its engine from,
    as the reference's main makes it, and an engine builds from it. So
    is ``--draft-checkpoint-dir``: with the directory pointing at a
    draft saved at the config's draft widths, the engine is the
    speculative one."""
    if knob == "draft_checkpoint_dir":
        from nos_tpu.cmd import server as jserver
        from nos_tpu_torch.models.spec_serving import (
            SpeculativeDecodeServer,
        )

        got = _main_config(tserver, argv, monkeypatch)
        assert got == _main_config(jserver, argv, monkeypatch)
        monkeypatch.undo()
        got["draft_checkpoint_dir"] = _draft_checkpoint(tmp_path)
        eng = tserver.build_engine(tserver.ServerConfig(**{
            **got, **MODEL, "bf16": False, "max_batch": 2}), device="cpu")
        assert isinstance(eng, SpeculativeDecodeServer) and eng.paged
        return
    if knob not in SERVED_KNOBS:
        with pytest.raises(SystemExit) as e:
            tserver.main(argv)
        assert e.value.code == 2
        assert knob in capsys.readouterr().err
        return
    from nos_tpu.cmd import server as jserver

    got = _main_config(tserver, argv, monkeypatch)
    # the reference has no --prefix-cache-size flag: its config field
    # is the comparison
    jargv, extra = list(argv), {}
    if "--prefix-cache-size" in jargv:
        i = jargv.index("--prefix-cache-size")
        extra["prefix_cache_size"] = int(jargv[i + 1])
        del jargv[i:i + 2]
    assert got == {**_main_config(jserver, jargv, monkeypatch), **extra}
    monkeypatch.undo()          # the real build_engine again
    eng = tserver.build_engine(tserver.ServerConfig(**{
        **got, **MODEL, "bf16": False, "max_batch": 2}), device="cpu")
    assert (eng._host_tier is not None) == (knob == "kv_host_tier_bytes")
    assert (eng._tq is not None) == (knob == "tenant_config")


@pytest.mark.parametrize("argv,knobs", [
    (["--prefill-chunk", "16"], dict(prefill_chunk=16)),
    (["--prefill-chunk", "16", "--prefill-budget", "32"],
     dict(prefill_chunk=16, prefill_budget=32)),
    (["--prefix-cache-size", "4"], dict(prefix_cache_size=4)),
], ids=["prefill_chunk", "prefill_budget", "prefix_cache_size"])
def test_main_serves_admission_flags(argv, knobs, monkeypatch,
                                     restore_logging):
    """The admission flags reach the config the reference's main makes
    (the reference has no --prefix-cache-size flag: its config field is
    the comparison), and an engine built from it serves them."""
    from nos_tpu.cmd import server as jserver

    paged = ["--kv-blocks", "16", "--kv-block-size", "8"]
    got = _main_config(tserver, paged + argv, monkeypatch)
    if "prefix_cache_size" in knobs:
        ref = _main_config(jserver, paged, monkeypatch)
        ref.update(knobs)
    else:
        ref = _main_config(jserver, paged + argv, monkeypatch)
    assert got == ref
    monkeypatch.undo()          # the real build_engine again
    eng = tserver.build_engine(tserver.ServerConfig(**{
        **got, **MODEL, "bf16": False, "max_batch": 2}), device="cpu")
    assert eng._prefill_chunk == knobs.get("prefill_chunk", 0)
    assert eng.prefill_budget == knobs.get("prefill_budget", 0)
    assert eng._prefix_max == knobs.get("prefix_cache_size", 0)
    rid = eng.submit(list(range(1, 40)), 3)
    assert len(eng.drain()[rid]) == 42


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


@pytest.mark.parametrize("stream", [False, True], ids=["unary", "sse"])
def test_side_by_side_pipelined_fused_replicas(params, stream):
    """A reference replica and a port replica, both at pipeline_depth 2
    and decode_steps 4: every side-by-side body gives the same unary and
    joined-SSE tokens (SSE frames coarsen to about depth x T tokens)."""
    from nos_tpu.cmd import server as jserver
    from nos_tpu.models.serving import DecodeServer as JDecodeServer

    jp, tp = params
    knobs = dict(pipeline_depth=2, decode_steps=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NOS_TPU_PAGED_KERNEL", "0")
        jeng = JDecodeServer(jp, JCFG, max_batch=2, **PAGED, **knobs)
    cfg = jserver.ServerConfig(**MODEL, bf16=False, max_batch=2, port=0,
                               **knobs)
    jloop = jserver.ServingLoop(jeng)
    jhttpd = jserver.make_http_server(cfg, jloop)
    threading.Thread(target=jhttpd.serve_forever, daemon=True).start()
    tloop = ServingLoop(port_engine(tp, **knobs))
    thttpd, turl = serve(tloop)
    jurl = f"http://127.0.0.1:{jhttpd.server_address[1]}"
    try:
        for body in SIDE_BY_SIDE:
            def tokens(url):
                if not stream:
                    return post(url, body)["tokens"]
                batches, done, err = sse_post(url, {**body, "stream": True})
                assert done and err is None
                return body["prompt"] + [t for b in batches for t in b]

            assert tokens(turl) == tokens(jurl), body
    finally:
        stop(jhttpd, jloop)
        stop(thttpd, tloop)


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


def _admission_replicas(jp, tp, knobs):
    """A reference replica and a port replica over engines with the
    admission knobs on; returns ((jloop, jhttpd, jurl), (tloop, thttpd,
    turl))."""
    from nos_tpu.cmd import server as jserver
    from nos_tpu.models.serving import DecodeServer as JDecodeServer

    engine = dict(max_batch=2, kv_block_size=8, kv_blocks=8, **knobs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NOS_TPU_PAGED_KERNEL", "0")
        jeng = JDecodeServer(jp, JCFG, **engine)
    cfg = jserver.ServerConfig(**MODEL, bf16=False, max_batch=2, port=0)
    jloop = jserver.ServingLoop(jeng)
    jhttpd = jserver.make_http_server(cfg, jloop)
    threading.Thread(target=jhttpd.serve_forever, daemon=True).start()
    tloop = ServingLoop(DecodeServer(tp, TCFG, device="cpu",
                                     paged_impl="xla", **engine))
    thttpd, turl = serve(tloop)
    return ((jloop, jhttpd, f"http://127.0.0.1:{jhttpd.server_address[1]}"),
            (tloop, thttpd, turl))


ADMISSION_METRICS = (
    'nos_tpu_serve_prefix_evict_total{tier="drop"}',
    'nos_tpu_serve_prefix_evict_total{tier="demote"}',
    "nos_tpu_serve_prefill_budget_tokens_total",
    "nos_tpu_serve_prefill_clamp_total",
    "nos_tpu_serve_prefill_override_total",
    "nos_tpu_serve_prefix_hits",
    "nos_tpu_serve_prefix_tokens_saved",
)


@pytest.mark.parametrize("knobs", [
    dict(prefix_cache_size=4, prefill_chunk=8, prefill_budget=8),
    dict(prefix_cache_size=4, prefill_chunk=8),
], ids=["budgeted", "unbudgeted"])
def test_side_by_side_admission_stats_and_metrics(params, knobs):
    """Prefix cache, chunked (and budgeted) prefill on both replicas: the
    same tokens for a shared-prompt sequence and a long prompt that
    evicts the cached chain; /stats' prefix and prefill sections equal
    the reference's; /metrics moves the same counters by the same
    amounts, the budget counters registered only under a budget and the
    eviction counter (tier drop) whenever there is a prefix index."""
    from nos_tpu.cmd import server as jserver

    jp, tp = params
    (jloop, jhttpd, jurl), (tloop, thttpd, turl) = _admission_replicas(
        jp, tp, knobs)
    bodies = [
        {"prompt": list(range(1, 18)), "max_new_tokens": 3,
         "cache_prefix": True},
        {"prompt": list(range(1, 17)) + [40, 41, 42], "max_new_tokens": 5},
        {"prompt": list(range(1, 17)) + list(range(20, 32)),
         "max_new_tokens": 4},
        {"prompt": [33] * 40, "max_new_tokens": 6},
    ]
    try:
        texts = {}
        for url, reg in ((jurl, jserver.default_registry()),
                         (turl, default_registry())):
            before = reg.expose()
            toks = [post(url, body)["tokens"] for body in bodies]
            snap = json.loads(get(url, "/stats")[1])
            after = reg.expose()
            texts[url] = (toks, snap, {
                name: metric_value(after, name) - metric_value(before, name)
                for name in ADMISSION_METRICS})
        (jtoks, jsnap, jdelta), (ttoks, tsnap, tdelta) = \
            texts[jurl], texts[turl]
        assert ttoks == jtoks
        assert ttoks[1] == want(jp, bodies[1]["prompt"], 5)
        assert tdelta == jdelta
        assert jdelta['nos_tpu_serve_prefix_evict_total{tier="drop"}'] == 1
        for key in ("prefix_cache", "prefix_index"):
            assert tsnap[key] == jsnap[key], key
        assert tsnap["kv"]["prefix"] == jsnap["kv"]["prefix"]
        assert set(tsnap["prefill_sched"]) == set(jsnap["prefill_sched"])
        for key in ("budget", "backlog_tokens", "chunk_tokens",
                    "budget_spent_tokens", "clamped_ticks", "overrides"):
            assert tsnap["prefill_sched"][key] == \
                jsnap["prefill_sched"][key], key
        budgeted = knobs.get("prefill_budget", 0) > 0
        assert hasattr(tloop, "m_psched_spent") == budgeted \
            == hasattr(jloop, "m_psched_spent")
        assert hasattr(tloop, "m_prefix_evict") and \
            hasattr(jloop, "m_prefix_evict")
    finally:
        stop(jhttpd, jloop)
        stop(thttpd, tloop)


class _Backlogged(_FakeEngine):
    """A stub engine with seconds of chunked prefill queued ahead."""

    def prefill_backlog_s(self):
        return 2.0


def test_deadline_behind_the_prefill_backlog_is_shed_at_submit():
    """A deadline the rolling estimates alone would meet, but not with
    the chunk queue ahead of it, is shed at submit, by the port's loop as
    by the reference's, with the same message; the same deadline with
    no backlog is admitted."""
    from nos_tpu.cmd import server as jserver

    msgs = []
    for mod in (jserver, tserver):
        loop = mod.ServingLoop(_Backlogged())
        try:
            loop._est_ttft_s, loop._est_tpot_s = 0.1, 0.01
            with pytest.raises(Exception) as e:
                loop.generate([1], 8, deadline_s=1.0, timeout=5)
            assert type(e.value).__name__ == "DeadlineUnmeetable"
            assert e.value.reason == "deadline_unmeetable"
            msgs.append(str(e.value))
        finally:
            loop.shutdown()
        loop = mod.ServingLoop(_FakeEngine())
        try:
            loop._est_ttft_s, loop._est_tpot_s = 0.1, 0.01
            assert loop.generate([1], 8, deadline_s=1.0, timeout=5)
        finally:
            loop.shutdown()
    assert msgs[1] == msgs[0]
    assert "chunked prefill queued ahead" in msgs[1]


def test_loop_feeds_tick_seconds_to_a_budgeted_engine(params):
    """The serving loop's tick phases feed the engine's TPOT cost model
    (assemble + dispatch + wait), only under a budget."""
    _, tp = params
    for budget, fed in ((8, True), (0, False)):
        eng = port_engine(tp, prefill_chunk=8, prefill_budget=budget)
        seen = []
        eng.note_tick_seconds = seen.append
        loop = ServingLoop(eng)
        try:
            assert len(loop.generate(list(range(1, 30)), 6,
                                     timeout=60)) == 35
        finally:
            loop.shutdown()
        assert bool(seen) == fed


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


# ---------------------------------------------------------------------------
# tenant quotas and the KV fabric through the binary (twins of
# tests/test_server_cmd.py:1346, :1787, :1827, :1935)
# ---------------------------------------------------------------------------

def test_tenant_config_flag_overrides_and_validates_early(monkeypatch,
                                                         restore_logging):
    """--tenant-config reaches the config the engine factory closes over,
    a malformed inline JSON is a clean config error before any weights
    (the reference's message), and tenancy is off by default."""
    spec = ('{"tenants": {"gold": {"min_rate": 200},'
            ' "burst": {"max_rate": 50}}}')
    got = _main_config(tserver, ["--tenant-config", spec], monkeypatch)
    assert got["tenant_config"] == spec
    assert TenantQuotaConfig.load(got["tenant_config"]).tenants[
        "gold"].min_rate == 200
    bad = '{"tenants": {"a": {"min_rate": 9, "max_rate": 3}}}'
    from nos_tpu.cmd import server as jserver
    with pytest.raises(ValueError, match="min_rate") as want:
        _main_config(jserver, ["--tenant-config", bad], monkeypatch)
    with pytest.raises(ValueError, match="min_rate") as port:
        _main_config(tserver, ["--tenant-config", bad], monkeypatch)
    assert str(port.value) == str(want.value)
    assert ServerConfig().tenant_config == ""
    assert TenantQuotaConfig.load("") is None


def test_kv_host_tier_flag_and_validation(monkeypatch, restore_logging):
    """--kv-host-tier-bytes and --kv-fabric-token reach the config, and
    build_engine wires a bounded host tier under the paged engine; the
    knob without its prerequisites is the reference's config error."""
    got = _main_config(tserver, [
        "--kv-block-size", "8", "--kv-blocks", "16",
        "--kv-host-tier-bytes", "1048576",
        "--kv-fabric-token", "fleet-secret"], monkeypatch)
    assert got["kv_host_tier_bytes"] == 1048576
    assert got["kv_fabric_token"] == "fleet-secret"
    assert ServerConfig().kv_host_tier_bytes == 0
    assert ServerConfig().kv_fabric_token == ""
    monkeypatch.undo()
    with pytest.raises(ValueError, match="prefix"):
        build_engine(ServerConfig(**MODEL, kv_host_tier_bytes=1 << 20),
                     device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        build_engine(ServerConfig(**MODEL, kv_host_tier_bytes=-1),
                     device="cpu")
    eng = build_engine(ServerConfig(**MODEL, bf16=False, max_batch=2,
                                    kv_block_size=8, kv_blocks=16,
                                    prefix_cache_size=4,
                                    kv_host_tier_bytes=1 << 20),
                       device="cpu")
    assert eng._host_tier is not None
    assert eng._host_tier.capacity_bytes == 1 << 20


def _fabric_replica(tp, token, **kw):
    from nos_tpu_torch.kvfabric import HostTierStore

    eng = port_engine(tp, prefix_cache_size=8,
                      host_tier=HostTierStore(1 << 20), **kw)
    loop = ServingLoop(eng, fabric_token=token)
    httpd, url = serve(loop, ServerConfig(**MODEL, bf16=False, port=0,
                                          kv_fabric_token=token))
    return url, loop, httpd


def test_kvchain_endpoint_and_peer_pull_over_http(params):
    """The migration hop over real sockets: replica A publishes a chain,
    GET /v1/kvchain/<digest> serves its codec payload raw, and a
    /v1/generate on replica B carrying the gateway-shaped kv_sources
    offer pulls and ingests it before admission: B's tokens are the
    reference's and its pull ledger records the hit. Every fabric
    surface is token-gated."""
    from nos_tpu_torch.kvfabric import (
        FABRIC_TOKEN_HEADER, chain_digest, decode_chain,
    )

    jp, tp = params
    TOK = "fleet-secret"

    def get_chain(url, digest, token=None):
        req = urllib.request.Request(
            f"{url}/v1/kvchain/{digest}",
            headers={} if token is None else {FABRIC_TOKEN_HEADER: token})
        return urllib.request.urlopen(req, timeout=30)

    url_a, loop_a, httpd_a = _fabric_replica(tp, TOK)
    url_b, loop_b, httpd_b = _fabric_replica(tp, TOK)
    sys_p = [7] * 8
    try:
        post(url_a, {"prompt": sys_p + [1, 2], "max_new_tokens": 4,
                     "cache_prefix": True})
        digest = chain_digest(sys_p)
        with get_chain(url_a, digest, TOK) as r:
            assert r.headers["Content-Type"] == "application/octet-stream"
            blob = r.read()
        assert decode_chain(blob)["tokens"] == sys_p
        assert blob == loop_a.export_chain(digest)
        for bad in (None, "wrong-secret"):
            with pytest.raises(urllib.error.HTTPError) as e:
                get_chain(url_a, digest, bad)
            assert e.value.code == 403
        with pytest.raises(urllib.error.HTTPError) as e:
            get_chain(url_a, "feedface", TOK)
        assert e.value.code == 404

        offer = {"url": f"{url_a}/v1/kvchain/{digest}",
                 "digest": digest, "len": len(sys_p)}
        body = {"prompt": sys_p + [5, 6], "max_new_tokens": 6,
                "kv_sources": [offer]}
        assert post(url_b, body)["tokens"] == want(jp, sys_p + [5, 6], 6)
        assert loop_b.stats()["kv_fabric_pulls"] == {
            "pull_hit": 0, "pull_miss": 0, "pull_denied": 1}
        rows = loop_b.stats()["prefix_index"]["chains"]
        assert digest not in {row["digest"] for row in rows}

        got = post(url_b, body, headers={FABRIC_TOKEN_HEADER: TOK})
        assert got["tokens"] == want(jp, sys_p + [5, 6], 6)
        assert loop_b.stats()["kv_fabric_pulls"] == {
            "pull_hit": 1, "pull_miss": 0, "pull_denied": 1}
        rows = loop_b.stats()["prefix_index"]["chains"]
        assert digest in {row["digest"] for row in rows}
        assert loop_b.engine._fabric["ingest"] == 1

        got = post(url_b, {"prompt": [9] * 8 + [1], "max_new_tokens": 3,
                           "kv_sources": [{"url": f"{url_a}/v1/kvchain/"
                                           "feedface",
                                           "digest": "feedface"}]},
                   headers={FABRIC_TOKEN_HEADER: TOK})
        assert got["tokens"] == want(jp, [9] * 8 + [1], 3)
        assert loop_b.stats()["kv_fabric_pulls"]["pull_miss"] == 1

        text = default_registry().expose()
        for ev in ("pull_hit", "pull_miss", "pull_denied", "demote",
                   "promote"):
            assert f'nos_tpu_serve_kvfabric_total{{event="{ev}"}}' in text
    finally:
        stop(httpd_a, loop_a)
        stop(httpd_b, loop_b)


def test_kv_fabric_pull_guards():
    """The pull path's local guards: non-http(s) offer URLs are refused
    before any fetch, malformed offers are skipped, and concurrent
    offers for one digest collapse into one fetch (single-flight)."""
    loop = ServingLoop(_FakeEngine())
    try:
        for url in ("file:///etc/passwd", "ftp://peer/x", "gopher://x"):
            with pytest.raises(ValueError, match="non-http"):
                loop._fetch_chain_bytes(url)
        fetched = []
        loop.chain_fetch = lambda url: fetched.append(url) or b"blob"
        loop.prefetch_chain([{"digest": "aa"}, {"url": "http://p/x"},
                             {"url": 7, "digest": "aa"},
                             {"url": "http://p/x", "digest": ""},
                             "nonsense", None])
        assert fetched == []
        assert loop._pull_counts == {"pull_hit": 0, "pull_miss": 0,
                                     "pull_denied": 0}
    finally:
        loop.shutdown()

    class _IngestEngine(_FakeEngine):
        def __init__(self):
            super().__init__()
            self.ingested = []

        def ingest_chain(self, blob, tenant=None, expect_digest=None):
            self.ingested.append(blob)
            return True

    eng = _IngestEngine()
    loop = ServingLoop(eng)
    gate = threading.Event()
    calls = []

    def slow_fetch(url):
        calls.append(url)
        gate.wait(timeout=10)
        return b"blob"

    loop.chain_fetch = slow_fetch
    try:
        offers = [{"url": "http://peer/v1/kvchain/aa", "digest": "aa"}]
        t1 = threading.Thread(target=loop.prefetch_chain, args=(offers,))
        t1.start()
        assert _wait_until(lambda: calls, timeout=5)
        t2 = threading.Thread(target=loop.prefetch_chain, args=(offers,))
        t2.start()
        time.sleep(0.1)
        gate.set()
        t1.join(timeout=10)
        t2.join(timeout=10)
        assert calls == ["http://peer/v1/kvchain/aa"]
        assert len(eng.ingested) == 1
        assert loop._pull_counts["pull_hit"] == 2
        assert loop._pull_counts["pull_miss"] == 0
    finally:
        loop.shutdown()


def test_prefix_evict_counters_mirror_by_tier(params):
    """nos_tpu_serve_prefix_evict_total{tier} and
    nos_tpu_serve_kvfabric_total{event="demote"} mirror the engine's
    demotions through the loop (tests/test_server_cmd.py:2008)."""
    from nos_tpu_torch.kvfabric import HostTierStore

    _, tp = params
    loop = ServingLoop(port_engine(tp, prefix_cache_size=1,
                                   host_tier=HostTierStore(1 << 20)))
    try:
        loop.generate([7] * 8 + [1], 3, cache_prefix=True)
        loop.generate([9] * 8 + [2], 3, cache_prefix=True)
        assert loop._prefix_evict_seen == {"drop": 0, "demote": 1}
        assert loop._fabric_seen["demote"] == 1
        text = default_registry().expose()
        assert 'nos_tpu_serve_prefix_evict_total{tier="demote"}' in text
        assert 'nos_tpu_serve_kvfabric_total{event="demote"}' in text
    finally:
        loop.shutdown()


# ---------------------------------------------------------------------------
# tenant SLO accounting through the loop (twins of
# tests/test_slo_accounting.py:245-315, :389)
# ---------------------------------------------------------------------------

def _slo_quota(slo=True):
    gold = ('{"min_rate": 100, "slo": {"ttft_p99_ms": 500, '
            '"tpot_p99_ms": 50, "goodput_floor": 0.95}}' if slo
            else '{"min_rate": 100}')
    return TenantQuotaConfig.from_json(
        '{"tenants": {"gold": %s, "burst": {"max_rate": 50}}, '
        '"window_s": 8.0}' % gold)


def test_engine_attribution_off_without_slo_config(params):
    """A tenant config with no slo blocks means no ledger: the charge
    paths and the quantum note are no-ops and the engine serves."""
    jp, tp = params
    eng = port_engine(tp, kv_blocks=17, tenant_quota=_slo_quota(False),
                      tenant_clock=lambda: 0.0)
    assert eng.chip is None
    rid = eng.submit([1, 2], 4, tenant="gold")
    assert eng.drain()[rid] == want(jp, [1, 2], 4)


def test_handoff_adopt_charges_decode_to_served_tenant(params):
    """Disaggregation: the prefill engine charges the tenant's prefill
    tokens, the decode engine adopting the handoff charges the same
    tenant's decode tokens, and both ledgers conserve."""
    _, tp = params
    kw = dict(kv_blocks=17, kv_swap=True, tenant_quota=_slo_quota(),
              tenant_clock=lambda: 0.0)
    pre = port_engine(tp, role="prefill", **kw)
    dec = port_engine(tp, role="decode", **kw)
    pre.submit([1, 2, 3, 4], 5, tenant="gold")
    pre.step()
    while pre.has_work():
        pre.step()
    [st] = pre.pop_handoffs()
    assert st["tenant"] == "gold"
    drid = dec.restore(st)
    out = dec.drain()
    assert len(out[drid]) == 4 + 5
    assert pre.chip.conserved() and dec.chip.conserved()
    assert pre.chip.snapshot()["chip_ms"]["gold"]["prefill"] > 0
    assert dec.chip.snapshot()["chip_ms"]["gold"]["decode"] > 0


def test_loop_unconfigured_slo_is_off():
    """No tenant config, or one without slo blocks: no budget engine,
    and /stats pins the mode with explicit nulls."""
    for tq in (None, _slo_quota(False)):
        loop = ServingLoop(_FakeEngine(), tenant_quota=tq)
        try:
            assert loop.slo_engine is None
            snap = loop.stats()
            assert snap["slo_budget"] is None
            assert snap["chip_ledger"] is None
        finally:
            loop.shutdown()


def test_loop_slo_budget_and_chip_ledger_served(params):
    """With objectives configured the loop serves ``slo_budget`` and a
    conserved ``chip_ledger`` in /stats, the budget gauge moves, and
    the per-tenant series carry the reference's names."""
    jp, tp = params
    loop = ServingLoop(port_engine(tp, kv_blocks=17,
                                   tenant_quota=_slo_quota()),
                       tenant_quota=_slo_quota(), slo_min_events=1)
    try:
        assert loop.generate([1, 2, 3], 5, tenant="gold", timeout=60) == \
            want(jp, [1, 2, 3], 5)
        loop.generate([4, 5], 4, tenant="burst", timeout=60)
        snap = loop.stats()
        assert snap["tenants"]["gold"]["tokens_total"] == 5
        assert snap["slo_budget"]["objectives"]
        block = snap["chip_ledger"]
        assert block["conserved"] and block["wall_ms"] > 0
        assert block["chip_ms"]["gold"]["decode"] > 0
        assert block["chip_ms"]["burst"]["decode"] > 0
        text = default_registry().expose()
        for name in ("nos_tpu_serve_slo_budget_remaining_ratio",
                     "nos_tpu_serve_tenant_chip_ms_total",
                     "nos_tpu_serve_tenant_kv_byte_seconds_total",
                     "nos_tpu_serve_tenant_tokens_total"):
            assert name in text, name
    finally:
        loop.shutdown()


def test_slo_flags_reach_server_config(monkeypatch, restore_logging):
    """Every serving.slo.* value lands in the config main builds the
    loop from, as the reference's main makes it."""
    from nos_tpu.cmd import server as jserver

    argv = ["--slo-fast-window-s", "60", "--slo-slow-window-s", "600",
            "--slo-burn-threshold", "6.0", "--slo-capture-interval-s", "30"]
    got = _main_config(tserver, argv, monkeypatch)
    assert got == _main_config(jserver, argv, monkeypatch)
    assert (got["slo_fast_window_s"], got["slo_slow_window_s"],
            got["slo_burn_threshold"], got["slo_capture_interval_s"]) == \
        (60.0, 600.0, 6.0, 30.0)
    dflt = ServerConfig()
    assert (dflt.slo_fast_window_s, dflt.slo_slow_window_s) == \
        (300.0, 3600.0)


def test_tenant_quota_over_http_sheds_429_with_reason(params):
    """Through the binary: a tenant over its max under contention gets
    429 ``reason: tenant_quota`` (the loop counts the shed under the
    tenant), and the same tenant admits on an idle engine."""
    jp, tp = params
    clock = [0.0]
    cfg = TenantQuotaConfig.from_json(
        '{"tenants": {"gold": {"min_rate": 100}, '
        '"burst": {"max_rate": 5}}, "window_s": 4.0}')
    eng = port_engine(tp, cls=_ParkedWait, max_batch=1, kv_blocks=17,
                      tenant_quota=cfg, tenant_clock=lambda: clock[0])
    eng.go.set()
    loop = ServingLoop(eng, tenant_quota=cfg)
    httpd, url = serve(loop)
    try:
        assert post(url, {"prompt": [1] * 4, "max_new_tokens": 30,
                          "tenant": "burst"})["tokens"] == \
            want(jp, [1] * 4, 30)
        # idle engine: over max, still admitted
        assert post(url, {"prompt": [2] * 4, "max_new_tokens": 2},
                    headers={"X-Tenant": "burst"})["tokens"] == \
            want(jp, [2] * 4, 2)
        eng.go.clear()
        eng.in_wait.clear()
        holder = threading.Thread(target=post, args=(url, {
            "prompt": [3] * 4, "max_new_tokens": 4, "tenant": "gold"}))
        holder.start()
        assert eng.in_wait.wait(timeout=30)
        status, reply = post_status(url, {"prompt": [5] * 4,
                                          "max_new_tokens": 4,
                                          "tenant": "burst"})
        assert status == 429 and reply["reason"] == "tenant_quota"
        eng.go.set()
        holder.join(timeout=60)
        assert default_registry().counter(
            "nos_tpu_serve_tenant_shed_total", "x",
            ("tenant", "reason")).value("burst", "tenant_quota") >= 1
        assert json.loads(get(url, "/stats")[1])["tenants"]["burst"][
            "sheds"] == 1
    finally:
        eng.go.set()
        stop(httpd, loop)


# ---------------------------------------------------------------------------
# the reference's gateway reads the port's /stats
# ---------------------------------------------------------------------------

def test_fleet_prefix_index_syncs_from_port_stats_over_http(params):
    """The gateway's ``FleetPrefixIndex.sync`` over two port replicas'
    /stats ``prefix_index`` sections, scraped over HTTP: a chain in one
    replica's device index and another's host tier both list their
    holder and tier."""
    from nos_tpu.kvfabric import FleetPrefixIndex
    from nos_tpu_torch.kvfabric import chain_digest

    _, tp = params
    url_a, loop_a, httpd_a = _fabric_replica(tp, "t")
    from nos_tpu_torch.kvfabric import HostTierStore
    eng_b = port_engine(tp, prefix_cache_size=1,
                        host_tier=HostTierStore(1 << 20))
    loop_b = ServingLoop(eng_b)
    httpd_b, url_b = serve(loop_b)
    try:
        post(url_a, {"prompt": [7] * 8 + [1], "max_new_tokens": 2,
                     "cache_prefix": True})
        for p in ([7] * 8 + [2], [9] * 8 + [2]):   # the 2nd demotes
            post(url_b, {"prompt": p, "max_new_tokens": 2,
                         "cache_prefix": True})
        idx = FleetPrefixIndex()
        idx.sync({name: json.loads(get(u, "/stats")[1])["prefix_index"]
                  for name, u in (("rep-a", url_a), ("rep-b", url_b))})
        holders = dict(idx.holders(chain_digest([7] * 8)))
        assert holders["rep-a"]["tier"] == "hbm"
        assert holders["rep-b"]["tier"] == "host"
        assert [n for n, _ in idx.holders(chain_digest([9] * 8))] == \
            ["rep-b"]
        assert idx.stats() == {"replicas": 2, "chains": 3}   # rows
    finally:
        stop(httpd_a, loop_a)
        stop(httpd_b, loop_b)


def test_gateway_tenant_door_sheds_from_port_stats(params):
    """The reference gateway's tenant door (tests/test_gateway.py:988)
    reads the ``tenants`` sections of two port replicas' /stats: their
    rates sum fleet-wide, and a tenant at its fleet max sheds at the door
    with ``tenant_quota`` before any replica sees it."""
    from nos_tpu.gateway import GatewayRouter, Replica, RouterConfig
    from nos_tpu.models.errors import QueueFull as JQueueFull
    from nos_tpu.models.tenantquota import TenantQuotaConfig as JTQ

    _, tp = params
    spec = ('{"tenants": {"gold": {"min_rate": 100}, '
            '"burst": {"max_rate": 10}}, "window_s": 8.0}')
    clock = [0.0]
    loops, urls, httpds = [], [], []
    for _ in range(2):
        eng = port_engine(tp, kv_blocks=17,
                          tenant_quota=TenantQuotaConfig.from_json(spec),
                          tenant_clock=lambda: clock[0])
        loop = ServingLoop(eng, tenant_quota=TenantQuotaConfig.from_json(
            spec))
        httpd, url = serve(loop)
        loops.append(loop), urls.append(url), httpds.append(httpd)
    try:
        for url, n in zip(urls, (48, 40)):
            post(url, {"prompt": [1, 2], "max_new_tokens": n,
                       "tenant": "burst"})
        stats = [json.loads(get(u, "/stats")[1]) for u in urls]
        router = GatewayRouter(RouterConfig(tenant_config=JTQ.from_json(
            spec)), transport=lambda rep, req: req["prompt"])
        router.update([Replica(name=f"r{i}", stats=st)
                       for i, st in enumerate(stats)])
        rate = sum(st["tenants"]["burst"]["rate_tokens_per_s"]
                   for st in stats)
        assert rate == 88 / 8.0
        assert router.fleet_tenant_rate("burst") == rate
        with pytest.raises(JQueueFull) as e:
            router.dispatch([1], 1, tenant="burst")
        assert e.value.reason == "tenant_quota"
        assert router.stats()["tenant_shed"] == {"burst": 1}
        toks, _, _ = router.dispatch([1], 1, tenant="gold")
        assert toks == [1]
    finally:
        for httpd, loop in zip(httpds, loops):
            stop(httpd, loop)


# ---------------------------------------------------------------------------
# the reference's defaults (kv_blocks=0): the slot-static engine serves
# ---------------------------------------------------------------------------

def test_main_serves_the_default_config_over_http(monkeypatch,
                                                 restore_logging):
    """``main`` with the reference's default ``ServerConfig`` (kv_blocks
    0, its default widths) builds the slot-static engine and answers a
    request over HTTP with the tokens of the port's ``generate`` on the
    same engine's weights."""
    from nos_tpu_torch.models.generate import generate

    seen = {}
    real_http = tserver.make_http_server

    def capture_http(cfg, loop, host="0.0.0.0"):
        seen["httpd"] = real_http(cfg, loop, host="127.0.0.1")
        seen["loop"] = loop
        return seen["httpd"]

    monkeypatch.setattr(tserver, "make_http_server", capture_http)
    t = threading.Thread(target=tserver.main,
                         args=(["--port", "0"],),
                         kwargs=dict(device="cpu"), daemon=True)
    t.start()
    assert _wait_until(lambda: "httpd" in seen, timeout=120)
    httpd = seen["httpd"]
    try:
        eng = seen["loop"].engine
        assert not eng.paged and eng.kv_stats() is None
        assert eng.max_len == ServerConfig().max_seq
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        got = post(url, {"prompt": [1, 2, 3], "max_new_tokens": 4})
        want = generate(eng.params, eng.cfg, [[1, 2, 3]], 4, device="cpu")
        assert got["tokens"] == want[0].tolist()
        st = json.loads(get(url, "/stats")[1])
        assert st["kv"] is None and st["config"]["kv_blocks"] == 0
    finally:
        httpd.shutdown()
        t.join(timeout=60)
    assert not t.is_alive()


def _draft_checkpoint(root) -> str:
    """A draft at ``ServerConfig``'s draft widths (f32, seeded), saved by
    the port's ``CheckpointManager`` with its stamp; its directory."""
    from nos_tpu_torch.cmd.generate import GenerateConfig
    from nos_tpu_torch.train.checkpoint import (
        CheckpointManager, model_arch_dict,
    )

    sc = ServerConfig(**MODEL)
    gcfg = GenerateConfig(vocab=sc.vocab, d_model=sc.draft_d_model,
                          n_layers=sc.draft_n_layers,
                          n_heads=sc.draft_n_heads,
                          n_kv_heads=sc.draft_n_kv_heads,
                          d_ff=sc.draft_d_ff, max_seq=sc.max_seq, bf16=False)
    cfg = ttfm.TransformerConfig(
        vocab=gcfg.vocab, d_model=gcfg.d_model, n_layers=gcfg.n_layers,
        n_heads=gcfg.n_heads, n_kv_heads=gcfg.n_kv_heads, d_ff=gcfg.d_ff,
        max_seq=gcfg.max_seq, dtype=torch.float32)
    directory = str(root / "draft")
    mgr = CheckpointManager(directory)
    mgr.write_model_config(model_arch_dict(gcfg))
    mgr.save(1, ttfm.init_params(cfg, torch.Generator().manual_seed(5),
                                 "cpu"), {})
    mgr.close()
    return directory


def test_draft_checkpoint_dir_refused_naming_checkpoint_loading(tmp_path):
    """The binary's speculative switch takes its draft from a checkpoint
    (the reference's build_engine). It was refused until checkpoint
    loading was ported; now a directory with no committed step raises
    the reference's ``no checkpoint under``, and a saved draft gives a
    speculative engine whose draft is the saved params, bit for bit, at
    the config's draft widths."""
    from nos_tpu_torch.models.spec_serving import SpeculativeDecodeServer
    from nos_tpu_torch.train.checkpoint import CheckpointManager

    missing = str(tmp_path / "d")
    cfg = ServerConfig(**MODEL, **PAGED, bf16=False,
                       draft_checkpoint_dir=missing)
    with pytest.raises(FileNotFoundError,
                       match=f"no checkpoint under {missing}"):
        build_engine(cfg, device="cpu")
    directory = _draft_checkpoint(tmp_path)
    eng = build_engine(dataclasses.replace(cfg,
                                           draft_checkpoint_dir=directory),
                       device="cpu")
    assert isinstance(eng, SpeculativeDecodeServer)
    assert eng.k == cfg.draft_n_tokens
    assert eng.draft_cfg.d_model == cfg.draft_d_model
    assert eng.draft_cfg.n_layers == cfg.draft_n_layers
    mgr = CheckpointManager(directory)
    saved = mgr.restore_params(
        params_template=ttfm.abstract_params(eng.draft_cfg), device="cpu")
    mgr.close()
    for a, b in zip(ttfm.param_leaves(saved),
                    ttfm.param_leaves(eng.draft_params)):
        assert torch.equal(a, b)
    rid = eng.submit([1, 2, 3], 5)
    assert len(eng.drain()[rid]) == 3 + 5


SPEC_SERIES = ("nos_tpu_serve_spec_draft_total",
               "nos_tpu_serve_spec_accepted_total",
               "nos_tpu_serve_spec_accepted_per_window_count",
               "nos_tpu_serve_spec_accepted_per_window_sum")


@pytest.mark.parametrize("paged", [False, True], ids=["static", "paged"])
def test_loop_exports_speculative_series_and_stats(params, paged):
    """A ServingLoop over a SpeculativeDecodeServer exports the three
    speculative series and the /stats ``speculative`` section, with the
    values the reference's loop over the reference's engine exports for
    the same requests."""
    from nos_tpu.cmd import server as jserver
    from nos_tpu.models.spec_serving import SpeculativeDecodeServer as JSpec
    from nos_tpu_torch.models.spec_serving import SpeculativeDecodeServer

    jp, tp = params
    dkw = dict(MODEL, d_model=16, n_layers=1, n_heads=2, n_kv_heads=1,
               d_ff=32)
    jd = jtfm.init_params(jax.random.PRNGKey(1),
                          jtfm.TransformerConfig(**dkw, dtype=jnp.float32))
    td = ttfm.params_from_jax(jd, "cpu")
    kw = dict(PAGED) if paged else {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NOS_TPU_PAGED_KERNEL", "0")
        jeng = JSpec(jp, JCFG, jd,
                     jtfm.TransformerConfig(**dkw, dtype=jnp.float32),
                     n_draft=3, max_batch=2, **kw)
    teng = SpeculativeDecodeServer(
        tp, TCFG, td, ttfm.TransformerConfig(**dkw, dtype=torch.float32),
        n_draft=3, max_batch=2, device="cpu",
        **({**kw, "paged_impl": "kernel"} if paged else kw))
    jloop = jserver.ServingLoop(jeng)
    jhttpd = jserver.make_http_server(
        jserver.ServerConfig(**MODEL, bf16=False, max_batch=2, port=0),
        jloop)
    threading.Thread(target=jhttpd.serve_forever, daemon=True).start()
    tloop = ServingLoop(teng)
    thttpd, turl = serve(tloop)
    jurl = f"http://127.0.0.1:{jhttpd.server_address[1]}"
    try:
        before = {}
        for url in (jurl, turl):
            text = get(url, "/metrics")[1].decode()
            before[url] = {n: metric_value(text, n) for n in SPEC_SERIES}
            # the counters export zeros from the start
            for name in SPEC_SERIES[:2]:
                assert name in text, name
        bodies = [{"prompt": [4, 5], "max_new_tokens": 9},
                  {"prompt": [9, 8, 7], "max_new_tokens": 7,
                   "temperature": 0.8, "seed": 3}]
        got = {}
        for url in (jurl, turl):
            toks = [post(url, b)["tokens"] for b in bodies]
            text = get(url, "/metrics")[1].decode()
            for name in SPEC_SERIES:
                assert name in text, name
            deltas = {n: metric_value(text, n) - before[url][n]
                      for n in SPEC_SERIES}
            spec = json.loads(get(url, "/stats")[1])["speculative"]
            got[url] = (toks, deltas, spec)
        assert got[turl] == got[jurl]
        toks, deltas, spec = got[turl]
        assert toks[0] == want(jp, [4, 5], 9)
        assert deltas[SPEC_SERIES[0]] == spec["drafted"] > 0
        assert deltas[SPEC_SERIES[1]] == spec["accepted"]
        assert deltas[SPEC_SERIES[2]] == spec["drafted"] / 3
        assert deltas[SPEC_SERIES[3]] == spec["accepted"]
        assert ("draft_kv" in spec) == paged
    finally:
        stop(jhttpd, jloop)
        stop(thttpd, tloop)
