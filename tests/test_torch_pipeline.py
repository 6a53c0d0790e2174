"""Port parity: pipelined decode (``pipeline_depth``, the in-flight tick
window) and fused decode steps (``decode_steps``, T steps in one
program) in the torch ``DecodeServer`` against the JAX engine (CPU, the
f32 tiny config of tests/test_serving_pipeline.py, bridged weights).

The port's paged engine runs the decode program directly on the CPU
(its kernel wrapper runs the plain formulation on CPU tensors); the
reference paged engine runs its gather formulation
(``NOS_TPU_PAGED_KERNEL=0``), the oracle it designates. The contract is
the reference's: exact token equality at every (depth, T) point, f32
and int8 arenas, greedy and sampled; completions observed late roll
back by pos; admission and cancel are barriers; ``QueueFull`` is
unchanged.

Engine reuse, as in the reference's file: ``pipeline_depth`` is host
state (the window bound), so one drained engine per (T, max_batch,
kv_dtype) serves every depth; T is in the program, so T=1 and T=4 get
their own engines.
"""
import contextlib
import logging

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.cmd import server as jserver  # noqa: E402
from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu.models.generate import generate as jgenerate  # noqa: E402
from nos_tpu.models.serving import DecodeServer as JDecodeServer  # noqa: E402
from nos_tpu_torch.cmd import generate as tgen  # noqa: E402
from nos_tpu_torch.cmd import server as tserver  # noqa: E402
from nos_tpu_torch.models import serving as tserving  # noqa: E402
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402
from nos_tpu_torch.models.errors import QueueFull  # noqa: E402
from nos_tpu_torch.models.serving import DecodeServer  # noqa: E402

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=64, max_seq=64)
JCFG = jtfm.TransformerConfig(dtype=jnp.float32, **KW)
TCFG = ttfm.TransformerConfig(dtype=torch.float32, **KW)
PAGED = dict(kv_block_size=8, kv_blocks=24)
# the reference's grid: depth {1, 2, 4} x fused steps {1, 4}, over both
# arenas ("bf16" is the model-dtype arena, f32 here)
GRID = [(d, t) for d in (1, 2, 4) for t in (1, 4)]
ARENAS = ["bf16", "int8"]
GRID_X_ARENA = [(d, t, kv) for d, t in GRID for kv in ARENAS]


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, ttfm.params_from_jax(jp, "cpu")


@pytest.fixture(autouse=True)
def gather_oracle(monkeypatch):
    """The reference engine's formulation switch, set for every test
    (the reference's build_engine writes it into os.environ)."""
    monkeypatch.setenv("NOS_TPU_PAGED_KERNEL", "0")


def _cached(make):
    cache = {}

    def at(depth, steps=1, mb=2, kv="bf16"):
        eng = cache.get((steps, mb, kv))
        if eng is None:
            eng = cache[(steps, mb, kv)] = make(steps, mb, kv)
        assert not eng.has_work(), "previous test left work behind"
        eng.pipeline_depth = depth
        eng.max_pending = 0
        return eng

    return at


@pytest.fixture(scope="module")
def port(params):
    """Shared drained port engines; at(depth, steps, mb, kv) retunes the
    window bound."""
    _, tp = params
    return _cached(lambda steps, mb, kv: DecodeServer(
        tp, TCFG, max_batch=mb, decode_steps=steps, kv_dtype=kv,
        device="cpu", paged_impl="kernel", **PAGED))


@pytest.fixture(scope="module")
def ref_engine(params):
    """The reference paged engines, shared the same way; built inside
    tests, under ``gather_oracle``."""
    jp, _ = params
    return _cached(lambda steps, mb, kv: JDecodeServer(
        jp, JCFG, max_batch=mb, decode_steps=steps, kv_dtype=kv, **PAGED))


def ref(params, prompt, n):
    """The reference's generate: prompt + n greedy tokens."""
    jp, _ = params
    out = jgenerate(jp, JCFG, jnp.asarray([prompt], jnp.int32), n)
    return [int(t) for t in out[0]]


def serve(eng, reqs):
    """Submit every (prompt, n, sampling) and drain; sequences in order."""
    rids = [eng.submit(p, n, **kw) for p, n, kw in reqs]
    out = eng.drain()
    return [out[r] for r in rids]


GREEDY = [([1, 2, 3], 6, {}), ([60, 61], 9, {}), ([7, 7, 7, 7, 7], 5, {})]
SAMPLED = [([4, 5], 8, dict(temperature=0.9, top_k=8, seed=17)),
           ([9, 9], 8, dict(temperature=1.2, seed=5)),
           ([3, 1, 4, 1, 5], 7, dict(temperature=0.7, top_p=0.9, seed=3)),
           ([2, 7], 6, {})]


@pytest.mark.parametrize("depth,steps,kv", GRID_X_ARENA)
def test_greedy_tokens_equal_reference_engine_and_generate(
        port, ref_engine, params, depth, steps, kv):
    # 3 requests over 2 slots with unequal budgets: a slot recycles (a
    # barrier admission mid-window) inside the run
    got = serve(port(depth, steps, kv=kv), GREEDY)
    assert got == serve(ref_engine(depth, steps, kv=kv), GREEDY)
    if kv == "bf16":
        for (p, n, _), seq in zip(GREEDY, got):
            assert seq == ref(params, p, n), (depth, steps)


@pytest.mark.parametrize("depth,steps,kv", GRID_X_ARENA)
def test_sampled_streams_invariant_to_depth_and_equal_reference(
        port, ref_engine, depth, steps, kv):
    base = serve(port(1, 1, kv=kv), SAMPLED)
    got = serve(port(depth, steps, kv=kv), SAMPLED)
    assert got == base, (depth, steps)
    assert got == serve(ref_engine(depth, steps, kv=kv), SAMPLED)


@pytest.mark.parametrize("depth,steps", GRID)
def test_stop_token_late_detection_rolls_back(port, ref_engine, params,
                                              depth, steps):
    # the stop token is produced early but observed up to depth x steps
    # tokens late: the output ends at its first occurrence, pos is reset
    # and the recycled slot stays exact
    full = ref(params, [4, 5], 16)
    stop = full[2 + 3]
    first_at = full.index(stop, 2)
    srv = port(depth, steps)
    rid = srv.submit([4, 5], 16, stop_tokens=[stop])
    s = next(s for s, r in srv._active.items() if r.rid == rid)
    res = srv.drain()
    assert res[rid] == full[:first_at + 1] and res[rid][-1] == stop
    assert int(srv.cache["pos"][s]) == 0
    jsrv = ref_engine(depth, steps)
    jrid = jsrv.submit([4, 5], 16, stop_tokens=[stop])
    assert jsrv.drain()[jrid] == res[rid]
    nxt = srv.submit([9, 8, 7], 6)
    assert srv.drain()[nxt] == ref(params, [9, 8, 7], 6)


@pytest.mark.parametrize("depth,steps", [(4, 1), (2, 4)])
@pytest.mark.parametrize("kv", ARENAS)
def test_max_new_reached_mid_window_rolls_back(port, ref_engine, depth,
                                               steps, kv):
    # a 2-token budget over-decodes up to depth x steps - 1 tokens; the
    # overrun is invisible and the slot reusable at once
    srv, jsrv = port(depth, steps, mb=1, kv=kv), ref_engine(depth, steps,
                                                           mb=1, kv=kv)
    reqs = [([4, 5], 2, {})]
    assert serve(srv, reqs) == serve(jsrv, reqs)
    reqs = [([1, 2, 3], 8, {})]
    assert serve(srv, reqs) == serve(jsrv, reqs)
    assert srv.kv_stats()["blocks_used"] == 0


@pytest.mark.parametrize("kv", ARENAS)
def test_overrun_past_the_end_of_the_timeline(port, ref_engine, params,
                                              kv):
    # prompt + max_new_tokens = max_len: the overrun ticks run past the
    # rope table and the block table (clamped rows, null-block writes)
    prompt = list(range(1, 61))
    srv = port(4, 4, mb=1, kv=kv)
    got = serve(srv, [(prompt, 4, {})])
    assert got == serve(ref_engine(4, 4, mb=1, kv=kv), [(prompt, 4, {})])
    if kv == "bf16":
        assert got[0] == ref(params, prompt, 4)
    assert int(srv.cache["pos"].max()) == 0


@pytest.mark.parametrize("depth,steps", [(4, 1), (2, 4)])
@pytest.mark.parametrize("kv", ARENAS)
def test_late_arrival_joins_as_barrier(port, ref_engine, depth, steps, kv):
    def run(srv):
        r0 = srv.submit([1, 2, 3, 4], 12)
        for _ in range(3):
            srv.step()
        r1 = srv.submit([9, 9], 5)      # admission flushes the window
        assert not srv._inflight
        res = srv.drain()
        return res[r0], res[r1]

    assert run(port(depth, steps, kv=kv)) == run(ref_engine(depth, steps,
                                                            kv=kv))


@pytest.mark.parametrize("depth,steps", [(4, 1), (2, 4)])
def test_cancel_mid_flight_is_a_barrier(port, ref_engine, params, depth,
                                        steps):
    def run(srv):
        rid_a = srv.submit([1, 2], 32)
        rid_b = srv.submit([3], 4)                  # queued behind a
        for _ in range(3):
            srv.step()
        assert srv._inflight                        # ticks in flight
        assert srv.cancel(rid_a)
        assert not srv._inflight                    # barrier flushed
        out_a = srv.pop_result(rid_a)
        assert out_a[:2] == [1, 2] and len(out_a) < 2 + 32
        return out_a, srv.drain()[rid_b]

    got = run(port(depth, steps, mb=1))
    assert got == run(ref_engine(depth, steps, mb=1))
    assert got[1] == ref(params, [3], 4)


@pytest.mark.parametrize("kv", ARENAS)
def test_queue_full_unchanged_under_pipelining(port, kv):
    srv = port(4, 1, mb=1, kv=kv)
    srv.max_pending = 1
    try:
        first = srv.submit([1, 2, 3], 30)
        srv.step()
        srv.submit([4, 5], 30)
        with pytest.raises(QueueFull, match="max_pending=1"):
            srv.submit([6], 2)
        results = srv.drain()
        assert len(results) == 2 and first in results
        srv.submit([7], 2)                          # admission re-opens
        srv.drain()
    finally:
        srv.max_pending = 0


@pytest.mark.parametrize("depth,steps", [(2, 1), (4, 4)])
@pytest.mark.parametrize("kv", ARENAS)
def test_split_step_protocol_and_token_accounting(port, ref_engine, depth,
                                                  steps, kv):
    # step_begin/step_wait/step_finish compose to step(), and every token
    # is credited exactly once, barrier flushes included
    srv = port(depth, steps, kv=kv)
    rids = [srv.submit([1, 2], 4), srv.submit([9], 6)]
    total = 2                                   # the two prefill tokens
    while srv.has_work():
        h = srv.step_begin()
        srv.step_wait(h)
        total += srv.step_finish(h)
    res = srv.drain()
    assert total == 4 + 6
    assert [res[r] for r in rids] == serve(ref_engine(depth, steps, kv=kv),
                                           [([1, 2], 4, {}), ([9], 6, {})])


@pytest.mark.parametrize("depth", [2, 4])
def test_window_fills_to_depth_and_drains(port, depth):
    srv = port(depth, 1, mb=1)
    srv.reset_dispatch_stats()
    srv.submit([1, 2], 16)
    srv.step()
    # one step dispatched up to depth ticks and consumed the oldest
    assert len(srv._inflight) == depth - 1
    assert srv.ticks_dispatched == depth
    assert srv.stats()["pipeline"]["in_flight"] == depth - 1
    srv.drain()
    assert not srv._inflight


def test_frees_wait_for_the_window(port, ref_engine):
    # a completion consumed while later ticks are in flight parks its
    # blocks; they land when the window drains
    srv = port(4, 1)
    a = srv.submit([1, 2], 3)
    b = srv.submit([5, 6, 7], 20)
    while srv.progress(a)[1] is False:
        srv.step()
    assert srv._inflight and srv.kv_stats()["deferred_frees"] > 0
    res = srv.drain()
    assert srv.kv_stats()["deferred_frees"] == 0
    assert srv.kv_stats()["blocks_used"] == 0
    want = serve(ref_engine(4, 1), [([1, 2], 3, {}), ([5, 6, 7], 20, {})])
    assert [res[a], res[b]] == want


@pytest.mark.parametrize("kv", ARENAS)
def test_dispatch_stats_accumulate(port, kv):
    srv = port(2, 1, kv=kv)
    srv.reset_dispatch_stats()
    tokens0 = srv.tokens_emitted
    srv.submit([1, 2, 3], 8)
    srv.drain()
    assert srv.ticks_dispatched > 0
    assert srv.host_block_s > 0.0
    assert srv.tokens_emitted - tokens0 >= 7


def test_depth1_pays_a_dispatch_gap_deeper_windows_hide_it(port):
    # at depth 1 the window empties on every consume; deeper, it empties
    # only at barriers
    srv = port(1, 1, mb=1)
    srv.reset_dispatch_stats()
    srv.submit([1, 2], 12)
    srv.drain()
    gap1 = srv.dispatch_gap_s
    assert gap1 > 0.0
    srv = port(4, 1, mb=1)
    srv.reset_dispatch_stats()
    srv.submit([1, 2], 12)
    srv.drain()
    assert srv.dispatch_gap_s < gap1


@pytest.mark.parametrize("depth,steps", [(3, 4), (2, 1)])
@pytest.mark.parametrize("kv", ARENAS)
def test_random_schedules_stay_exact_under_pipelining(port, ref_engine,
                                                      depth, steps, kv):
    """Random lengths, budgets, arrival points and step interleavings:
    the port and the reference commit the same tokens."""
    rng = np.random.default_rng(23)
    for trial in range(2):
        n_req = int(rng.integers(3, 6))
        reqs = [([int(t) for t in rng.integers(0, 64, rng.integers(1, 41))],
                 int(rng.integers(1, 7))) for _ in range(n_req)]
        gaps = [int(rng.integers(0, 3)) for _ in reqs]

        def run(srv):
            rids = []
            for (p, n), g in zip(reqs, gaps):
                rids.append(srv.submit(p, n))
                for _ in range(g):
                    srv.step()
            out = srv.drain()
            return [out[r] for r in rids]

        got = run(port(depth, steps, kv=kv))
        assert got == run(ref_engine(depth, steps, kv=kv)), trial


@pytest.mark.parametrize("knob", ["pipeline_depth", "decode_steps"])
def test_zero_is_refused_with_the_reference_message(params, knob):
    jp, tp = params
    with pytest.raises(ValueError) as want:
        JDecodeServer(jp, JCFG, **PAGED, **{knob: 0})
    with pytest.raises(ValueError) as got:
        DecodeServer(tp, TCFG, device="cpu", **PAGED, **{knob: 0})
    assert str(got.value) == str(want.value)


def test_uncaptured_hook_restores_the_engine(port):
    srv = port(2, 4)
    with tserving.uncaptured(srv):
        assert "_launch_graph" in vars(srv)
        got = serve(srv, GREEDY)
    assert "_launch_graph" not in vars(srv)
    assert serve(srv, GREEDY) == got
    assert srv.compiles == 0        # the CPU captures nothing


def test_capture_programs_captures_nothing_on_the_cpu(port):
    srv = port(1)
    assert srv.capture_programs() == {}
    assert srv._graphs == {} and srv.compiles == 0
    assert serve(srv, GREEDY) == serve(port(2), GREEDY)


def test_capture_programs_needs_an_idle_engine(params):
    _, tp = params
    srv = DecodeServer(tp, TCFG, device="cpu", **PAGED)
    srv.submit([1, 2, 3], 4)
    srv.device = torch.device("cuda", 0)    # the check comes first
    with pytest.raises(RuntimeError, match="idle engine"):
        srv.capture_programs()


def test_keep_mask_follows_the_active_slot_set(port):
    srv = port(1, mb=4)
    for active in [(0, 2), (1,), (0, 2), (), (0, 1, 2, 3)]:
        srv._set_keep(active)
        assert srv._keep.nonzero().flatten().tolist() == list(active)
    srv._set_keep(())


def test_the_program_runs_on_the_engines_own_scratch(port, monkeypatch):
    """The paged kernel's split-merge scratch that a captured graph
    replays belongs to the engine, which nothing else can replace."""
    seen = []
    real = tserving.forward_paged

    def spy(*args, **kw):
        seen.append(kw.get("scratch"))
        return real(*args, **kw)

    monkeypatch.setattr(tserving, "forward_paged", spy)
    srv = port(2, 4)
    serve(srv, GREEDY)
    assert seen and all(s is srv._scratch for s in seen)
    assert isinstance(srv._scratch, tserving._kernels.PagedScratch)


@contextlib.contextmanager
def bridged_weights(monkeypatch, tp):
    """build_engine on the reference's params: the port's seeded
    ``load_params`` returns the bridged ones."""
    monkeypatch.setattr(tgen, "load_params", lambda cfg, device=None:
                        (TCFG, tp))
    yield


@pytest.mark.parametrize("depth,steps", [(2, 4), (4, 1)])
def test_build_engine_serves_the_reference_engines_tokens(
        params, ref_engine, monkeypatch, depth, steps):
    _, tp = params
    cfg = tserver.ServerConfig(bf16=False, max_batch=2, pipeline_depth=depth,
                               decode_steps=steps, **PAGED, **KW)
    with bridged_weights(monkeypatch, tp):
        eng = tserver.build_engine(cfg, device="cpu")
    assert (eng.pipeline_depth, eng.decode_steps) == (depth, steps)
    reqs = GREEDY + SAMPLED[:2]
    assert serve(eng, reqs) == serve(ref_engine(depth, steps), reqs)


@pytest.mark.parametrize("knob", [dict(pipeline_depth=0),
                                  dict(decode_steps=0)])
def test_build_engine_refuses_zero_as_the_reference(knob):
    cfg = dict(KW, bf16=False, **PAGED, **knob)
    with pytest.raises(ValueError) as want:
        jserver.build_engine(jserver.ServerConfig(**cfg))
    with pytest.raises(ValueError) as got:
        tserver.build_engine(tserver.ServerConfig(**cfg), device="cpu")
    assert str(got.value) == str(want.value)


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


def test_main_serves_a_pipelined_fused_engine(params, ref_engine,
                                              monkeypatch, tmp_path,
                                              restore_logging):
    """``main --pipeline-depth 2 --decode-steps 4`` builds the engine with
    both knobs and its loop serves the reference engine's tokens."""
    _, tp = params
    config = tmp_path / "server.yaml"
    config.write_text("".join(f"{k}: {v}\n" for k, v in dict(
        KW, bf16="false", max_batch=2, **PAGED).items()))
    seen = {}

    def fake_http(cfg, loop, *a, **kw):
        try:
            seen["knobs"] = (loop.engine.pipeline_depth,
                             loop.engine.decode_steps)
            seen["tokens"] = [loop.generate(p, n, **s) for p, n, s in GREEDY]
        finally:
            loop.shutdown()
        raise SystemExit(0)         # stop before serve_forever

    monkeypatch.setattr(tserver, "make_http_server", fake_http)
    with bridged_weights(monkeypatch, tp), pytest.raises(SystemExit):
        tserver.main(["--config", str(config), "--pipeline-depth", "2",
                      "--decode-steps", "4"], device="cpu")
    assert seen["knobs"] == (2, 4)
    assert seen["tokens"] == serve(ref_engine(2, 4), GREEDY)
