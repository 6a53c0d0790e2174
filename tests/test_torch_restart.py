"""Port parity: capture and restore (``capture_resumable``/``restore``)
and supervised restart through ``ServingLoop`` in the torch port against
the JAX engine (CPU, f32, the tiny config of tests/test_serving_paged.py,
bridged weights).

Twins of tests/test_serving_chaos.py:158, :256 and :640-729: a fault
injected at a chosen tick (``FaultInjector``, raised in Python) makes the
loop capture every live request, rebuild the engine and resume each by
swap or recompute, and every request finishes exactly once with the
undisturbed run's tokens. Capture states carry the reference's schema,
so a JAX capture restores into the port and a port capture into JAX.
"""
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.models import supervision as jsupervision  # noqa: E402
from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu.models.generate import generate as jgenerate  # noqa: E402
from nos_tpu.models.serving import DecodeServer as JDecodeServer  # noqa: E402
from nos_tpu_torch.cmd.server import OUTCOMES, ServingLoop  # noqa: E402
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402
from nos_tpu_torch.models.errors import (  # noqa: E402
    EngineRecovering, Infeasible,
)
from nos_tpu_torch.models.serving import DecodeServer  # noqa: E402
from nos_tpu_torch.models.supervision import (  # noqa: E402
    ChaosEngine, FaultInjector,
)
from nos_tpu_torch.utils.metrics import default_registry  # noqa: E402

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=64, max_seq=64)
JCFG = jtfm.TransformerConfig(dtype=jnp.float32, **KW)
TCFG = ttfm.TransformerConfig(dtype=torch.float32, **KW)
PAGED = dict(max_batch=2, kv_block_size=8, kv_blocks=17)


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


def ref(jp, prompt, n):
    out = jgenerate(jp, JCFG, jnp.asarray([prompt], jnp.int32), n)
    return [int(t) for t in out[0]]


def port(tp, **kw):
    return DecodeServer(tp, TCFG, device="cpu",
                        **{**PAGED, "paged_impl": "kernel", **kw})


def jax_engine(jp, **kw):
    return JDecodeServer(jp, JCFG, **{**PAGED, **kw})


def outcomes():
    c = default_registry().counter(
        "nos_tpu_serve_requests_total", "", ("outcome",))
    return {o: c.value(o) for o in OUTCOMES}


def outcome_delta(before):
    after = outcomes()
    return {o: after[o] - before[o] for o in OUTCOMES
            if after[o] != before[o]}


def wait_until(pred, timeout=30.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


# a mid-run engine: one finished-unpopped request, two decoding, one
# waiting (max_batch 2)
REQS = [([1, 2, 3], 2), ([4, 5], 12), ([9, 8, 7], 10), ([6], 8)]


def mid_run(srv):
    rids = [srv.submit(p, n) for p, n in REQS]
    for _ in range(3):
        srv.step()
    return rids


def finish(states, restore_into):
    """Restore ``states`` into ``restore_into`` in order and drain it;
    returns the sequences in the states' order."""
    new = [restore_into.restore(st) for st in states]
    res = restore_into.drain()
    return [res[r] for r in new]


def undisturbed_tokens(jp, kv_dtype):
    if kv_dtype == "bf16":
        return [ref(jp, p, n) for p, n in REQS]
    eng = jax_engine(jp, kv_dtype=kv_dtype)
    rids = [eng.submit(p, n) for p, n in REQS]
    res = eng.drain()
    return [res[r] for r in rids]


def _plain(st):
    return {k: v for k, v in st.items() if k != "swap"}


# ---------------------------------------------------------------------------
# capture_resumable / restore against the JAX engine's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_swap", [True, False], ids=["swap", "recompute"])
@pytest.mark.parametrize("device_ok", [True, False])
def test_capture_schema_is_the_references(params, kv_swap, device_ok):
    jp, tp = params
    jeng, teng = jax_engine(jp, kv_swap=kv_swap), port(tp, kv_swap=kv_swap)
    mid_run(jeng)
    mid_run(teng)
    want = jeng.capture_resumable(device_ok=device_ok)
    got = teng.capture_resumable(device_ok=device_ok)
    assert [_plain(s) for s in got] == [_plain(s) for s in want]
    assert [("swap" in s) for s in got] == [("swap" in s) for s in want]
    assert any("swap" in s for s in got) == (kv_swap and device_ok)
    for g, w in zip(got, want):
        if "swap" not in w:
            continue
        assert sorted(g["swap"]) == sorted(w["swap"])
        assert g["swap"]["nblk"] == w["swap"]["nblk"]
        for key in ("k", "v"):
            np.testing.assert_allclose(g["swap"][key], w["swap"][key],
                                       atol=1e-5)
    assert [s.get("done", False) for s in got] == [False, False, False, True]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("kv_swap", [True, False], ids=["swap", "recompute"])
@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_capture_restores_across_frameworks(params, direction, kv_swap,
                                            kv_dtype):
    """A capture from one framework's engine, restored in order into
    the other's, finishes with the undisturbed run's tokens (the
    reference's engine-vs-engine oracle under int8)."""
    jp, tp = params
    kw = dict(kv_swap=kv_swap, kv_dtype=kv_dtype)
    src, dst = ((jax_engine(jp, **kw), port(tp, **kw))
                if direction == "jax->port"
                else (port(tp, **kw), jax_engine(jp, **kw)))
    mid_run(src)
    states = src.capture_resumable()
    assert any("swap" in s for s in states) == kv_swap
    assert sum(1 for s in states if not s.get("done") and s["out"]) == 2
    want = undisturbed_tokens(jp, kv_dtype)     # by the source's rid
    assert finish(states, dst) == [want[st["rid"]] for st in states]
    assert dst.kv_stats()["preempts"] == {"swap": 0, "recompute": 0}


def _bad_states():
    blk = lambda bs, dt: np.zeros((2, 1, 2, bs, 8), dt)  # noqa: E731
    base = dict(prompt=[1, 2], max_new_tokens=4, out=[3])
    return [
        ("too long", dict(base, prompt=[1] * 60, max_new_tokens=20), {}),
        ("pool too small", dict(base, prompt=[1] * 20, max_new_tokens=20),
         dict(kv_blocks=4)),
        ("block size", dict(base, swap={"nblk": 1, "k": blk(16, np.float32),
                                        "v": blk(16, np.float32)}), {}),
        ("int8 into f32", dict(base, swap={
            "nblk": 1, "k": blk(8, np.int8), "v": blk(8, np.int8),
            "k_scale": np.zeros((2, 1, 2, 8), np.float32),
            "v_scale": np.zeros((2, 1, 2, 8), np.float32)}), {}),
        ("f32 into int8", dict(base, swap={"nblk": 1, "k": blk(8, np.float32),
                                           "v": blk(8, np.float32)}),
         dict(kv_dtype="int8")),
    ]


@pytest.mark.parametrize("case", _bad_states(), ids=lambda c: c[0])
def test_restore_refuses_with_the_references_messages(params, case):
    jp, tp = params
    _, state, kw = case
    with pytest.raises(Infeasible) as got:
        port(tp, **kw).restore(dict(state))
    with pytest.raises(ValueError) as want:
        jax_engine(jp, **kw).restore(dict(state))
    assert str(got.value) == str(want.value)


def test_done_state_parks_and_handoff_reparks_on_a_prefill_engine(params):
    _, tp = params
    eng = port(tp)
    rid = eng.restore({"rid": 7, "prompt": [1, 2], "out": [3, 4],
                       "max_new_tokens": 2, "done": True})
    assert eng.drain() == {rid: [1, 2, 3, 4]}
    pre = port(tp, role="prefill")
    st = {"rid": 3, "prompt": [1, 2], "out": [3], "max_new_tokens": 4,
          "handoff": True, "swap": {"nblk": 1}}
    rid = pre.restore(st)
    [parked] = pre.pop_handoffs()
    assert parked["rid"] == rid and parked["swap"] == {"nblk": 1}
    assert not pre.has_work()


# ---------------------------------------------------------------------------
# supervised restart through ServingLoop (tests/test_serving_chaos.py)
# ---------------------------------------------------------------------------

def _check_resume(params, mk, want_mode, prompts=([1, 2, 3], [7, 8]),
                  n=10, kv_dtype="bf16", schedule=None, **loop_kw):
    jp, _ = params
    inj = FaultInjector(schedule=schedule or {2: "error"})
    loop = ServingLoop(inj.wrap(mk()), engine_factory=lambda: inj.wrap(mk()),
                       restart_budget=2, restart_backoff_s=0.01, **loop_kw)
    outs = {}
    before = outcomes()

    def worker(i):
        # a submit that lands mid-recovery is refused (503 + Retry-After
        # on the wire): the client retries, as the HTTP client would
        while True:
            try:
                outs[i] = loop.generate(prompts[i], n, timeout=180)
                return
            except EngineRecovering:
                time.sleep(0.01)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    try:
        sup = loop._sup
        assert sup.restarts >= 1, "fault did not trigger a restart"
        assert sup.lost == 0
        assert sup.resumed[want_mode] >= 1, sup.resumed
        resumed = default_registry().counter(
            "nos_tpu_serve_requests_resumed_total", "", ("mode",))
        assert resumed.value(want_mode) >= sup.resumed[want_mode]
        if kv_dtype == "bf16":
            want = [ref(jp, p, n) for p in prompts]
        else:
            eng = jax_engine(jp, kv_dtype=kv_dtype)
            rids = [eng.submit(p, n) for p in prompts]
            res = eng.drain()
            want = [res[r] for r in rids]
        assert [outs.get(i) for i in range(len(prompts))] == want
        delta = outcome_delta(before)
        delta.pop("rejected", None)         # refused mid-recovery, retried
        assert delta == {"finished": len(prompts)}
        assert loop.healthy and not loop.recovering
        return sup
    finally:
        loop.shutdown()


@pytest.mark.parametrize("kv_swap", [True, False], ids=["swap", "recompute"])
@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("depth", [1, 2])
def test_restart_resume_bit_exact_matrix(params, depth, steps, kv_swap):
    _, tp = params
    _check_resume(params, lambda: port(tp, pipeline_depth=depth,
                                       decode_steps=steps, kv_swap=kv_swap),
                  "swap" if kv_swap else "recompute")


@pytest.mark.parametrize("kv_swap", [True, False], ids=["swap", "recompute"])
def test_restart_resume_bit_exact_gather(params, kv_swap):
    _, tp = params
    _check_resume(params, lambda: port(tp, paged_impl="xla", kv_swap=kv_swap,
                                       pipeline_depth=2, decode_steps=4),
                  "swap" if kv_swap else "recompute")


@pytest.mark.parametrize("kv_swap", [True, False], ids=["swap", "recompute"])
def test_restart_resume_int8_matches_the_reference_engine(params, kv_swap):
    _, tp = params
    _check_resume(params, lambda: port(tp, kv_dtype="int8", kv_swap=kv_swap),
                  "swap" if kv_swap else "recompute", kv_dtype="int8")


def test_restart_resumes_all_requests_exactly_once(params):
    """Two injected faults, three concurrent requests: two restarts,
    nothing lost, every request finished exactly once with its
    undisturbed tokens."""
    _, tp = params
    sup = _check_resume(
        params, lambda: port(tp, max_batch=3, kv_blocks=24), "swap",
        prompts=([100 % 64], [101 % 64], [102 % 64]), n=12,
        schedule={3: "error", 7: "error"})
    assert sup.restarts == 2
    assert len(sup.episodes) == 2
    assert all(e["mttr_s"] >= 0 for e in sup.episodes)


def test_watchdog_trip_resumes_by_recompute(params):
    """A hung tick trips the watchdog: the card is declared wedged, so
    the capture reads no device memory and every live request resumes
    by recompute, still with its undisturbed tokens."""
    _, tp = params
    sup = _check_resume(params, lambda: port(tp), "recompute",
                        schedule={3: "hang"}, watchdog_s=0.4)
    assert sup.resumed["swap"] == 0


def test_restore_failure_accounts_lost_exactly_once(params):
    _, tp = params

    class RestoreBoom(DecodeServer):
        def restore(self, state):
            raise ValueError("cannot restore here")

    inj = FaultInjector(schedule={1: "error"})
    loop = ServingLoop(
        inj.wrap(port(tp)),
        engine_factory=lambda: inj.wrap(
            RestoreBoom(tp, TCFG, device="cpu", **PAGED)),
        restart_budget=2, restart_backoff_s=0.01)
    before = outcomes()
    try:
        with pytest.raises(RuntimeError, match="lost in engine restart"):
            loop.generate([1, 2], 30, timeout=60)
        assert outcome_delta(before) == {"failed": 1}
        assert loop._sup.lost == 1
        assert loop.healthy
    finally:
        loop.shutdown()


def test_capture_failure_accounts_live_requests_failed_once(params):
    _, tp = params

    class CaptureBoom(DecodeServer):
        def capture_resumable(self, device_ok=True):
            raise RuntimeError("host bookkeeping corrupted")

    inj = FaultInjector(schedule={1: "error"})

    def mk():
        return inj.wrap(CaptureBoom(tp, TCFG, device="cpu", **PAGED))

    loop = ServingLoop(mk(), engine_factory=mk, restart_budget=2,
                       restart_backoff_s=0.01)
    before = outcomes()
    try:
        with pytest.raises(RuntimeError):
            loop.generate([1, 2], 30, timeout=60)
        assert wait_until(lambda: sum(outcome_delta(before).values()) == 1)
        assert outcome_delta(before) == {"failed": 1}
        assert loop._sup.lost == 1 and loop.healthy
    finally:
        loop.shutdown()


# ---------------------------------------------------------------------------
# the chaos seams, copied from the reference
# ---------------------------------------------------------------------------

class _Inner:
    def __init__(self):
        self.hbm, self._hbm_next = None, 0.0
        self.written = None

    def step_begin(self):
        return "begun"


def test_fault_injector_schedule_equals_the_references():
    kw = dict(seed=11, p_error=0.1, p_hang=0.05, p_slow=0.2)
    runs = []
    for cls in (FaultInjector, jsupervision.FaultInjector):
        inj = cls(**kw)
        for _ in range(200):
            try:
                inj.before_dispatch(_Inner())
            except RuntimeError:
                pass
            inj._pending_wait = None        # no sleeps: seams only
        runs.append([(e["tick"], e["kind"]) for e in inj.injected])
    assert runs[0] == runs[1] and runs[0]
    with pytest.raises(ValueError, match="unknown fault kinds"):
        FaultInjector(schedule={1: "melt"})


def test_chaos_engine_proxies_reads_writes_and_seams():
    inner = _Inner()
    inj = FaultInjector(schedule={1: "error", 2: "nofreeblocks",
                                  3: "hbm_spike"})
    eng = inj.wrap(inner)
    assert isinstance(eng, ChaosEngine)
    eng.written = 5
    assert inner.written == 5           # writes land on the inner engine
    assert eng.step_begin() == "begun"
    with pytest.raises(RuntimeError, match="injected engine fault"):
        eng.step_begin()
    from nos_tpu_torch.models.kvblocks import NoFreeBlocks
    with pytest.raises(NoFreeBlocks, match="injected"):
        eng.step_begin()
    eng.step_begin()
    assert inner.hbm["in_use"] == 999
    assert not hasattr(eng, "capture_resumable")
    assert inj.counts() == {"error": 1, "nofreeblocks": 1, "hbm_spike": 1}
