"""Port parity: the prefill->decode KV handoff (``models/handoff.py``,
the engine roles, the serving loop's pusher and adopter, ``POST
/v1/handoff``) against the JAX package (CPU, the tiny config of
tests/test_serving_paged.py, bridged weights).

The codec's bytes equal ``nos_tpu.models.handoff``'s for an equal state,
bf16 payloads included (the port carries bf16 bits as uint16 with the
name beside them; the wire names the plane ``"bfloat16"``); a JAX
prefill-role engine's handoff is adopted by a port decode-role engine
and the other way round, both finishing with the JAX colocated engine's
tokens; and the HTTP pair of tests/test_server_cmd.py:1432-1790 runs on
the port (deadline carried, departures before the push, the pusher's
cooldown, orphans reaped), and across frameworks.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import torch  # noqa: E402

from nos_tpu.cmd import server as jserver  # noqa: E402
from nos_tpu.models import handoff as jhandoff  # noqa: E402
from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu.models.serving import DecodeServer as JDecodeServer  # noqa: E402
from nos_tpu_torch.cmd import server as tserver  # noqa: E402
from nos_tpu_torch.cmd.server import (  # noqa: E402
    OUTCOMES, ServerConfig, ServingLoop,
)
from nos_tpu_torch.models import handoff as thandoff  # noqa: E402
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402
from nos_tpu_torch.models.serving import DecodeServer  # noqa: E402
from nos_tpu_torch.utils.metrics import default_registry  # noqa: E402

MODEL = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq=64)
JCFG = jtfm.TransformerConfig(**MODEL, dtype=jnp.float32)
TCFG = ttfm.TransformerConfig(**MODEL, dtype=torch.float32)
KV = dict(max_batch=2, kv_block_size=8, kv_blocks=24)
REQS = [([1, 2, 3], 6, {}),
        ([4, 4, 2, 7], 8, {"temperature": 0.7, "top_k": 8, "seed": 11})]


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, ttfm.params_from_jax(jp, "cpu")


@pytest.fixture(autouse=True)
def pallas_compat(monkeypatch):
    """The reference engine's gather oracle, and the renamed
    ``pltpu.TPUCompilerParams`` aliased, as every port test file does."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("NOS_TPU_PAGED_KERNEL", "0")
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


def port(tp, cfg=TCFG, **kw):
    return DecodeServer(tp, cfg, device="cpu",
                        **{**KV, "paged_impl": "kernel", **kw})


def colocated(jp, reqs=REQS, **kw):
    eng = JDecodeServer(jp, JCFG, **{**KV, **kw})
    rids = [eng.submit(p, n, **s) for p, n, s in reqs]
    res = eng.drain()
    return [res[r] for r in rids]


def outcomes():
    c = default_registry().counter(
        "nos_tpu_serve_requests_total", "", ("outcome",))
    return {o: c.value(o) for o in OUTCOMES}


def outcome_delta(before):
    after = outcomes()
    return {o: after[o] - before[o] for o in OUTCOMES
            if after[o] != before[o]}


def wait_until(cond, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(0.02)
    return False


# ---------------------------------------------------------------------------
# the codec: the reference's bytes for an equal state
# ---------------------------------------------------------------------------

def _planes(kind):
    """(port swap, reference swap) of one payload kind, equal values."""
    rng = np.random.default_rng(0)
    shape = (2, 3, 2, 8, 4)
    if kind == "float32":
        k, v = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(2))
        return {"nblk": 3, "k": k, "v": v}, {"nblk": 3, "k": k, "v": v}
    if kind == "int8":
        k, v = (rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (rng.random(shape[:4]).astype(np.float32)
                  for _ in range(2))
        swap = {"nblk": 3, "k": k, "v": v, "k_scale": ks, "v_scale": vs}
        return swap, dict(swap)
    k, v = (rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
            for _ in range(2))
    return ({"nblk": 3, "k": k.view(np.uint16), "v": v.view(np.uint16),
             "dtype": "bfloat16"}, {"nblk": 3, "k": k, "v": v})


META = {"rid": 4, "prompt": [1, 2, 3], "out": [9], "max_new_tokens": 6,
        "temperature": 0.5, "top_k": 3, "top_p": 0.9, "seed": 7,
        "stop_tokens": [2], "priority": 1, "tenant": "default",
        "cache_prefix": False, "handoff": True}


@pytest.mark.parametrize("kind", ["float32", "int8", "bfloat16", "none"])
def test_encode_bytes_equal_the_references(kind):
    if kind == "none":
        tstate = jstate = dict(META, deadline_s=1.5, traceparent="00-ab")
    else:
        tswap, jswap = _planes(kind)
        tstate, jstate = dict(META, swap=tswap), dict(META, swap=jswap)
    data = thandoff.encode_handoff(tstate)
    assert data == jhandoff.encode_handoff(jstate)
    assert thandoff.handoff_nbytes(tstate) == \
        jhandoff.handoff_nbytes(jstate)
    if kind == "bfloat16":
        # a reference payload (ml_dtypes planes) in the port's encoder
        assert thandoff.encode_handoff(jstate) == data


@pytest.mark.parametrize("kind", ["float32", "int8", "bfloat16", "none"])
def test_decode_reads_either_frameworks_bytes(kind):
    if kind == "none":
        tstate = dict(META)
    else:
        tstate = dict(META, swap=_planes(kind)[0])
    data = thandoff.encode_handoff(tstate)
    got = thandoff.decode_handoff(data)
    want = jhandoff.decode_handoff(data)
    assert {k: v for k, v in got.items() if k != "swap"} == \
        {k: v for k, v in want.items() if k != "swap"} == \
        {k: v for k, v in tstate.items() if k != "swap"}
    if kind == "none":
        assert "swap" not in got and "swap" not in want
        return
    for key in ("k", "v", "k_scale", "v_scale"):
        if key not in want["swap"]:
            continue
        assert thandoff.plane_dtype(got["swap"], key) == \
            str(want["swap"][key].dtype)
        assert got["swap"][key].tobytes() == want["swap"][key].tobytes()
        assert got["swap"][key].tobytes() == tstate["swap"][key].tobytes()
    assert got["swap"]["nblk"] == want["swap"]["nblk"] == 3
    # and back: the port's decoded state encodes to the same bytes
    assert thandoff.encode_handoff(got) == data


# ---------------------------------------------------------------------------
# engine roles across frameworks
# ---------------------------------------------------------------------------

def _prefill(eng, reqs=REQS):
    for p, n, s in reqs:
        eng.submit(p, n, **s)
    states = eng.pop_handoffs()
    assert len(states) == len(reqs) and not eng.has_work()
    return states


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_handoff_adopted_across_frameworks(params, direction, kv_dtype):
    """Prefill on one framework's prefill-role engine, ship the encoded
    handoffs, adopt them on the other's decode-role engine: greedy and
    sampled requests finish with the JAX colocated engine's tokens."""
    jp, tp = params
    kw = dict(kv_dtype=kv_dtype)
    if direction == "jax->port":
        pre = JDecodeServer(jp, JCFG, role="prefill", **{**KV, **kw})
        enc, dec = jhandoff.encode_handoff, thandoff.decode_handoff
        adopter = port(tp, role="decode", **kw)
    else:
        pre = port(tp, role="prefill", **kw)
        enc, dec = thandoff.encode_handoff, jhandoff.decode_handoff
        adopter = JDecodeServer(jp, JCFG, role="decode", **{**KV, **kw})
    states = _prefill(pre)
    assert all(st["handoff"] and len(st["out"]) == 1 for st in states)
    assert pre.stats()["handoff"]["total"] == 2
    rids = [adopter.restore(dec(enc(st))) for st in states]
    res = adopter.drain()
    assert [res[r] for r in rids] == colocated(jp, **kw)


def test_prefill_role_surface_is_the_references(params):
    """stats()["handoff"], the parked states' schema and the ledger's
    ``handoff`` outcome, as the reference's prefill-role engine has
    them."""
    jp, tp = params
    jeng = JDecodeServer(jp, JCFG, role="prefill", **KV)
    teng = port(tp, role="prefill")
    want, got = _prefill(jeng), _prefill(teng)
    assert [{k: v for k, v in s.items() if k != "swap"} for s in got] == \
        [{k: v for k, v in s.items() if k != "swap"} for s in want]
    js, ts = jeng.stats()["handoff"], teng.stats()["handoff"]
    assert {k: ts[k] for k in ("ready", "total", "payload_bytes")} == \
        {k: js[k] for k in ("ready", "total", "payload_bytes")}
    assert [teng.pop_ledger(r)["outcome"] for r in (0, 1)] == \
        [jeng.pop_ledger(r)["outcome"] for r in (0, 1)] == \
        ["handoff", "handoff"]
    assert teng.kv_stats()["blocks_used"] == 0
    assert port(tp).stats()["handoff"] is None


def _bf16_cfgs():
    return (jtfm.TransformerConfig(**MODEL, dtype=jnp.bfloat16),
            ttfm.TransformerConfig(**MODEL, dtype=torch.bfloat16))


@pytest.mark.parametrize("direction", ["jax->port", "jax->port in process",
                                       "port->jax"])
def test_bf16_handoff_lands_byte_for_byte(params, direction):
    """A bf16 arena's payload crosses frameworks as the same bits: the
    adopting engine's arena holds exactly the payload's bytes in the
    blocks it restored into, through the codec or (a reference state
    restored in process) straight from its ``ml_dtypes`` planes."""
    jp, _ = params
    jcfg, tcfg = _bf16_cfgs()
    jpb = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    tpb = ttfm.params_from_jax(jpb, "cpu")
    if direction.startswith("jax->port"):
        pre = JDecodeServer(jpb, jcfg, role="prefill", **KV)
        [st] = _prefill(pre, REQS[:1])
        adopt = port(tpb, cfg=tcfg, role="decode")
        bits = np.asarray(st["swap"]["k"]).view(np.uint16)
        if direction == "jax->port":
            state = thandoff.decode_handoff(jhandoff.encode_handoff(st))
            assert state["swap"]["dtype"] == "bfloat16"
        else:
            state = st
            assert str(state["swap"]["k"].dtype) == "bfloat16"
        rid = adopt.restore(state)
        slot = next(s for s, r in adopt._active.items() if r.rid == rid)
        blocks = adopt._tables[slot][:st["swap"]["nblk"]]
        got = adopt.cache["k"][:, blocks].view(torch.int16).numpy()
        assert got.view(np.uint16).tobytes() == bits.tobytes()
        adopt.drain()
    else:
        pre = port(tpb, cfg=tcfg, role="prefill")
        [st] = _prefill(pre, REQS[:1])
        assert st["swap"]["dtype"] == "bfloat16"
        assert st["swap"]["k"].dtype == np.uint16
        state = jhandoff.decode_handoff(thandoff.encode_handoff(st))
        assert str(state["swap"]["k"].dtype) == "bfloat16"
        assert state["swap"]["k"].view(np.uint16).tobytes() == \
            st["swap"]["k"].tobytes()
        adopt = JDecodeServer(jpb, jcfg, role="decode", **KV)
        rid = adopt.restore(state)
        slot = next(s for s, r in adopt._active.items() if r.rid == rid)
        blocks = jnp.asarray(adopt._tables[slot][:st["swap"]["nblk"]])
        got = np.asarray(adopt.cache["k"][:, blocks]).view(np.uint16)
        assert got.tobytes() == st["swap"]["k"].tobytes()
        adopt.drain()


def test_build_engine_serves_roles():
    """``role`` reaches the engine as the reference's build_engine
    passes it; role=prefill still needs a decode pool, with the
    reference's message."""
    kw = dict(MODEL, bf16=False, kv_block_size=8, kv_blocks=16)
    assert tserver.build_engine(ServerConfig(**kw, role="decode"),
                                device="cpu").role == "decode"
    eng = tserver.build_engine(
        ServerConfig(**kw, role="prefill", decode_pool="http://d0:8000"),
        device="cpu")
    assert eng.role == "prefill" and eng.stats()["handoff"]["total"] == 0
    with pytest.raises(ValueError, match="decode-pool"):
        tserver.build_engine(ServerConfig(**kw, role="prefill"),
                             device="cpu")


# ---------------------------------------------------------------------------
# over HTTP (tests/test_server_cmd.py:1432)
# ---------------------------------------------------------------------------

def _http_send(target, data):
    req = urllib.request.Request(
        target.rstrip("/") + "/v1/handoff", data=data,
        headers={"Content-Type": "application/octet-stream"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return int(json.loads(resp.read())["rid"])


def _serve(mod, loop, **cfg):
    """One replica of ``mod``'s HTTP surface on an ephemeral port;
    returns (httpd, url)."""
    config = mod.ServerConfig(**MODEL, bf16=False, port=0, kv_block_size=8,
                              kv_blocks=24, **cfg)
    if mod is tserver:
        httpd = mod.make_http_server(config, loop, host="127.0.0.1")
    else:
        httpd = mod.make_http_server(config, loop)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, body, path="/v1/generate"):
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=120) as r:
        return json.loads(r.read())


def _pair(params, pre_mod, dec_mod):
    """(pre_loop, pre_httpd, pre_url, dec_loop, dec_httpd, dec_url): a
    decode-role replica of ``dec_mod`` and a prefill-role replica of
    ``pre_mod`` whose decode pool is it."""
    jp, tp = params

    def engine(mod, role):
        if mod is tserver:
            return port(tp, role=role)
        return JDecodeServer(jp, JCFG, role=role, **KV)

    dec_loop = dec_mod.ServingLoop(engine(dec_mod, "decode"), role="decode",
                                   config_echo={"role": "decode"})
    dec_httpd, dec_url = _serve(dec_mod, dec_loop, role="decode")
    pre_loop = pre_mod.ServingLoop(
        engine(pre_mod, "prefill"), role="prefill",
        handoff_targets=[dec_url], handoff_send=_http_send,
        config_echo={"role": "prefill"})
    pre_httpd, pre_url = _serve(pre_mod, pre_loop, role="prefill",
                                decode_pool=dec_url)
    return pre_loop, pre_httpd, pre_url, dec_loop, dec_httpd, dec_url


def _close(*pairs):
    for httpd, loop in pairs:
        httpd.shutdown()
        loop.shutdown()
        httpd.server_close()


def test_http_prefill_decode_handoff_end_to_end(params):
    """Two port replicas over HTTP: the prefill replica answers a
    handoff descriptor; the decode replica's /v1/result gives the
    colocated engine's tokens (greedy and sampled), /v1/stream the same
    tokens as SSE; a request its first token completes never hands off;
    both /stats and the prefill replica's metrics tell the story."""
    jp, _ = params
    want = colocated(jp)
    pre_loop, pre_httpd, pre_url, dec_loop, dec_httpd, dec_url = \
        _pair(params, tserver, tserver)
    try:
        got = []
        for (p, n, s) in REQS:
            res = _post(pre_url, dict({"prompt": p, "max_new_tokens": n}, **s))
            assert res["handoff"]["target"] == dec_url
            got.append(_get(dec_url,
                            f"/v1/result/{res['handoff']['rid']}")["tokens"])
        assert got == want
        res = _post(pre_url, {"prompt": [1, 2, 3], "max_new_tokens": 6})
        toks = []
        with urllib.request.urlopen(
                f"{dec_url}/v1/stream/{res['handoff']['rid']}",
                timeout=120) as r:
            for line in r:
                line = line.decode().strip()
                if not line.startswith("data: "):
                    continue
                payload = line[len("data: "):]
                if payload == "[DONE]":
                    break
                frame = json.loads(payload)
                assert "error" not in frame, frame
                toks.extend(frame["tokens"])
        assert [1, 2, 3] + toks == want[0]
        res = _post(pre_url, {"prompt": [1, 2, 3], "max_new_tokens": 1})
        assert res["tokens"] == want[0][:4]
        psnap = _get(pre_url, "/stats")
        assert psnap["role"] == "prefill"
        assert psnap["handoff"]["total"] == 3
        assert psnap["handoff"]["payload_bytes"] > 0
        assert _get(dec_url, "/stats")["role"] == "decode"
        text = default_registry().expose()
        assert 'nos_tpu_serve_handoff_total{outcome="sent"}' in text
        assert "nos_tpu_serve_handoff_bytes" in text
        assert "nos_tpu_serve_handoff_seconds" in text
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(dec_url, "/v1/result/9999")
        assert e.value.code == 404
    finally:
        _close((pre_httpd, pre_loop), (dec_httpd, dec_loop))


@pytest.mark.parametrize("pair", ["port->jax", "jax->port"])
def test_http_handoff_across_frameworks(params, pair):
    """A port prefill replica ships to a reference decode replica, and
    the other way round: the colocated engine's tokens come back."""
    jp, _ = params
    pre_mod, dec_mod = ((tserver, jserver) if pair == "port->jax"
                        else (jserver, tserver))
    pre_loop, pre_httpd, pre_url, dec_loop, dec_httpd, dec_url = \
        _pair(params, pre_mod, dec_mod)
    try:
        got = []
        for (p, n, s) in REQS:
            res = _post(pre_url, dict({"prompt": p, "max_new_tokens": n}, **s))
            got.append(_get(dec_url,
                            f"/v1/result/{res['handoff']['rid']}")["tokens"])
        assert got == colocated(jp)
    finally:
        _close((pre_httpd, pre_loop), (dec_httpd, dec_loop))


def test_http_handoff_geometry_mismatch_is_400(params):
    """A payload from an engine of another block size is refused with
    the reference's 400 ``infeasible`` body."""
    _, tp = params
    dec_loop = ServingLoop(port(tp, role="decode"), role="decode")
    dec_httpd, dec_url = _serve(tserver, dec_loop, role="decode")
    pre = port(tp, role="prefill", kv_block_size=16)
    [st] = _prefill(pre, REQS[:1])
    try:
        req = urllib.request.Request(
            dec_url + "/v1/handoff", data=thandoff.encode_handoff(st),
            method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        body = json.loads(e.value.read())
        assert e.value.code == 400 and body["infeasible"] is True
        assert "does not match this engine's arena" in body["error"]
    finally:
        _close((dec_httpd, dec_loop))


# ---------------------------------------------------------------------------
# the loop's handoff bookkeeping over stub engines
# (tests/test_server_cmd.py:1574-1785)
# ---------------------------------------------------------------------------

class _FakeEngine:
    """Instant-completion engine stub (the reference tests' own)."""

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


class _ParkingEngine(_FakeEngine):
    """Prefill-role stub: a submitted request leaves progress() at once
    (parked as a handoff inside the engine) and only surfaces in
    ``_handoffs`` when the test releases it."""

    def __init__(self):
        super().__init__()
        self._handoffs, self.parked = [], {}

    def submit(self, prompt, n, **kw):
        rid = super().submit(prompt, n, **kw)
        del self.pending[rid]
        self.parked[rid] = {"rid": rid, "prompt": list(prompt)}
        return rid

    def release(self, rid):
        self._handoffs.append(self.parked.pop(rid))

    def pop_handoffs(self):
        out, self._handoffs = self._handoffs, []
        return out


class _Adopting(_FakeEngine):
    def restore(self, state):
        rid = self._rid
        self._rid += 1
        self.pending[rid] = 3
        return rid


def test_prefill_handoff_cancelled_when_client_departs_pre_push():
    shipped = []
    eng = _ParkingEngine()
    loop = ServingLoop(eng, role="prefill", handoff_targets=["http://dec"],
                       handoff_send=lambda t, d: shipped.append(t) or 1)
    try:
        before = outcomes()
        with pytest.raises(TimeoutError):
            loop.prefill([1, 2, 3], 6, timeout=0.05)
        assert loop._handoff_gone
        eng.release(0)
        with loop._work:
            loop._work.notify_all()
        assert wait_until(lambda: not loop._handoff_gone
                          and not eng._handoffs)
        assert shipped == [] and loop._handoff_done == {}
        assert outcome_delta(before) == {"cancelled": 1}
        assert not loop._live and not loop._adopted
    finally:
        loop.shutdown()


def test_handoff_carries_deadline_and_adopt_arms_it():
    shipped = []
    eng = _ParkingEngine()
    loop = ServingLoop(eng, role="prefill", handoff_targets=["http://dec"],
                       handoff_send=lambda t, d: shipped.append(d) or 7)
    try:
        done = {}

        def client():
            done["res"] = loop.prefill([1, 2, 3], 6, deadline_s=30.0)

        th = threading.Thread(target=client, daemon=True)
        th.start()
        assert wait_until(lambda: 0 in eng.parked)
        eng.release(0)
        with loop._work:
            loop._work.notify_all()
        th.join(timeout=10)
        assert done["res"]["handoff"] == {"target": "http://dec", "rid": 7}
        st = thandoff.decode_handoff(shipped[0])
        assert 0 < st["deadline_s"] <= 30.0
        assert loop._prefill_deadlines == {}
    finally:
        loop.shutdown()

    class Slow(_Adopting):
        live = {1}

        def cancel(self, rid):
            self.pending.pop(rid, None)

        def step(self):
            for rid, n in list(self.pending.items()):
                if rid in self.live:
                    self.done[rid] = list(range(n))
                    del self.pending[rid]
            return 1

    dec = ServingLoop(Slow(), role="decode")
    try:
        before = outcomes()
        dec.adopt(thandoff.encode_handoff({"rid": 0, "prompt": [1, 2],
                                           "deadline_s": -60.0}))
        assert wait_until(
            lambda: outcome_delta(before).get("deadline") == 1)
        rid2 = dec.adopt(thandoff.encode_handoff(
            {"rid": 1, "prompt": [1, 2], "deadline_s": 60.0}))
        assert dec.result(rid2, timeout=5) == [1, 2, 0, 1, 2]
    finally:
        dec.shutdown()


def test_pusher_cooldown_skips_failed_decode_target():
    calls = []

    def send(target, data):
        calls.append(target)
        if target == "http://bad":
            raise OSError("connection refused")
        return 1

    eng = _ParkingEngine()
    loop = ServingLoop(eng, role="prefill",
                       handoff_targets=["http://bad", "http://good"],
                       handoff_send=send, handoff_cooldown_s=60.0)
    try:
        for i in range(2):
            done = {}

            def client():
                done["res"] = loop.prefill([1, 2, 3], 6)

            th = threading.Thread(target=client, daemon=True)
            th.start()
            assert wait_until(lambda: i in eng.parked)
            eng.release(i)
            with loop._work:
                loop._work.notify_all()
            th.join(timeout=10)
            assert done["res"]["handoff"]["target"] == "http://good"
        assert calls == ["http://bad", "http://good", "http://good"]
        assert loop.m_handoff_skipped.value() >= 1
        assert "http://bad" in loop._handoff_unhealthy
    finally:
        loop.shutdown()


def test_health_view_skips_draining_and_orders_by_queue():
    eng = _ParkingEngine()
    views = {"http://a": {"pending": {"depth": 5}},
             "http://b": {"pending": {"depth": 1}},
             "http://c": {"draining": True}}
    loop = ServingLoop(eng, role="prefill",
                       handoff_targets=list(views) + ["http://d"],
                       handoff_send=lambda t, d: 1,
                       handoff_health_interval_s=60.0)
    try:
        loop.pool_stats_fetch = lambda t: views[t] if t in views else \
            (_ for _ in ()).throw(OSError("unreachable"))
        loop._refresh_pool_health(list(views) + ["http://d"])
        skipped = loop.m_handoff_skipped.value()
        assert loop._order_pool(list(views) + ["http://d"]) == \
            ["http://b", "http://a", "http://d"]
        assert loop.m_handoff_skipped.value() == skipped + 1
    finally:
        loop.shutdown()


def test_adopted_prompt_released_on_watch_path():
    loop = ServingLoop(_Adopting(), role="decode")
    try:
        rid = loop.adopt(thandoff.encode_handoff({"rid": 0,
                                                  "prompt": [1, 2]}))
        assert loop._adopted == {rid: [1, 2]}
        toks = []
        for delta in loop.watch(rid):
            toks.extend(delta)
        assert toks == [0, 1, 2]
        assert loop._adopted == {}, "watch path leaked the prompt"
    finally:
        loop.shutdown()


def test_adopted_orphan_reaped_and_result_refetchable():
    loop = ServingLoop(_Adopting(), role="decode", adopt_ttl_s=0.3)
    try:
        before = outcomes()
        rid = loop.adopt(thandoff.encode_handoff({"rid": 0,
                                                  "prompt": [1, 2]}))
        assert wait_until(lambda: not loop._adopted
                          and rid not in loop._rid_map)
        assert outcome_delta(before) == {"cancelled": 1}
        assert loop._handoff_deadline == {}
        rid2 = loop.adopt(thandoff.encode_handoff({"rid": 1,
                                                   "prompt": [1, 2]}))
        want = loop.result(rid2, timeout=5)
        assert want == [1, 2, 0, 1, 2]
        assert loop.result(rid2, timeout=5) == want
        assert wait_until(lambda: rid2 not in loop._adopted_final)
        with pytest.raises(ValueError):
            loop.result(rid2, timeout=5)
    finally:
        loop.shutdown()
