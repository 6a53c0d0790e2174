"""Port parity: chunked and budgeted prefill in the torch ``DecodeServer``
against the JAX engine (CPU, f32, the tiny config of
tests/test_chunked_prefill.py and tests/test_budgeted_prefill.py, bridged
weights, both engines paged).

Twins of tests/test_chunked_prefill.py, tests/test_budgeted_prefill.py's
paged scheduler cases (with ``slack_clock`` as their ``FakeClock``) and
tests/test_serving_paged.py's chunked cases: each scenario runs on the
reference engine and on the port's, and both must commit the same tokens
and make the same scheduler decisions (the chunk queue after every tick,
credit, spent/clamped/overrides counters), report the same
``stats()["prefill_sched"]`` and leave a balanced block pool. The
reference runs its gather formulation (``NOS_TPU_PAGED_KERNEL=0``) unless
a case names the kernel, which it then runs in Pallas interpret mode; the
port's kernel wrapper runs its plain version on CPU tensors.
"""
import random

import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.cmd import server as jserver  # noqa: E402
from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu.models.serving import DecodeServer as JDecodeServer  # noqa: E402
from nos_tpu_torch.cmd import server as tserver  # noqa: E402
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402
from nos_tpu_torch.models.serving import DecodeServer  # noqa: E402

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=64, max_seq=128)
JCFG = jtfm.TransformerConfig(dtype=jnp.float32, **KW)
TCFG = ttfm.TransformerConfig(dtype=torch.float32, **KW)
PAGED = dict(kv_block_size=8, kv_blocks=48)
LONG = [(i * 7 + 3) % 64 for i in range(40)]    # >> chunk of 8


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, ttfm.params_from_jax(jp, "cpu")


@pytest.fixture(autouse=True)
def gather_oracle(monkeypatch):
    """The reference engine's formulation switch, set for every test
    (its build_engine writes it into os.environ)."""
    monkeypatch.setenv("NOS_TPU_PAGED_KERNEL", "0")


@pytest.fixture
def pallas_compat(monkeypatch):
    """Alias the renamed ``pltpu.TPUCompilerParams`` so the reference
    kernel runs in interpret mode on the installed JAX."""
    from jax.experimental.pallas import tpu as pltpu

    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


class FakeClock:
    """The injectable slack clock of tests/test_budgeted_prefill.py."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def engines(params, impl="xla", **kw):
    """(reference engine, port engine) over the same params and knobs."""
    jp, tp = params
    knobs = {**PAGED, **kw}
    return (JDecodeServer(jp, JCFG, **knobs),
            DecodeServer(tp, TCFG, device="cpu", paged_impl=impl, **knobs))


def drain_all(srv, reqs):
    rids = [srv.submit(p, n, **kw) for p, n, kw in reqs]
    out = srv.drain()
    return [out[r] for r in rids]


def sched_state(srv) -> tuple:
    """What the scheduler decided so far: the chunk queue by request,
    the banked credit and the counters."""
    return ({e["req"].rid: len(e["todo"]) for e in srv._prefilling},
            round(srv._prefill_credit, 6), srv.prefill_budget_spent,
            srv.prefill_budget_clamped, srv.prefill_budget_overrides,
            srv.prefill_chunk_tokens)


def assert_pool_balanced(eng):
    """Quiescent pool: every block free or held by the prefix index."""
    assert not eng.has_work()
    held = eng._pindex.block_count if eng._pindex is not None else 0
    assert eng._alloc.used_count == held, (eng._alloc.used_count, held)
    assert not eng._deferred
    assert all(not t for t in eng._tables)


def both(params, scenario, impl="xla", **kw):
    """Run ``scenario(engine)`` on the reference and on the port; each
    must return the same record. Returns the port's."""
    jeng, teng = engines(params, impl=impl, **kw)
    want = scenario(jeng)
    got = scenario(teng)
    assert got == want
    assert_pool_balanced(teng)
    return got


# ---------------------------------------------------------------------------
# chunked prefill (tests/test_chunked_prefill.py)
# ---------------------------------------------------------------------------

MIX = [
    (LONG, 6, dict()),
    (LONG[:17], 5, dict(temperature=0.7, top_k=8, seed=5)),
    ([5, 9], 6, dict()),
    (LONG[:33], 4, dict()),
]


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_tokens_invariant_to_chunking(params, impl):
    """Chunked == one-shot in tokens (greedy and sampled) on both
    engines, and the port equals the reference."""
    reqs = MIX[:3]
    _, one_shot = engines(params, impl=impl, max_batch=2)
    want = drain_all(one_shot, reqs)
    got = both(params, lambda e: drain_all(e, reqs), impl=impl,
               max_batch=2, prefill_chunk=8)
    assert got == want


@pytest.mark.parametrize("plen", [16, 17, 15, 8, 9])
def test_chunk_exact_multiple_and_one_off(params, plen):
    prompt = LONG[:plen]
    got = both(params, lambda e: drain_all(e, [(prompt, 5, {})]),
               max_batch=1, prefill_chunk=8)
    _, one_shot = engines(params, max_batch=1)
    assert got == drain_all(one_shot, [(prompt, 5, {})])


def test_active_slots_decode_during_prefill(params):
    """While a long prompt prefills chunk by chunk, an active request
    emits one token per step."""
    def scenario(srv):
        a = srv.submit([4, 5], 30)
        srv.step()
        before = len(srv.progress(a)[0])
        b = srv.submit(LONG, 4)
        assert srv._prefilling          # admission ran no forward
        # a request still prefilling reports as active, with no tokens
        assert srv.progress(b) == ([], False)
        ticks, seen = 0, []
        while srv._prefilling:
            srv.step()
            ticks += 1
            seen.append(sched_state(srv))
        progressed = len(srv.progress(a)[0]) - before
        out = srv.drain()
        return ticks, progressed, seen, out[a], out[b]

    ticks, progressed, _, _, out_b = both(params, scenario, max_batch=2,
                                          prefill_chunk=8)
    assert progressed == ticks == 5     # ceil(40/8), one per tick
    assert out_b[:len(LONG)] == LONG


@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_prefix_cache_composes_with_chunking(params, impl, pallas_compat,
                                             monkeypatch):
    """A 24-token system prompt published, then a request that shares it
    with a suffix longer than one chunk: the chunked admission seeds its
    scratch from the shared blocks; tokens equal the unchunked engine's
    and the reference's, with the same hits and tokens saved."""
    monkeypatch.setenv("NOS_TPU_PAGED_KERNEL", "1" if impl == "kernel"
                       else "0")
    sys_prompt = LONG[:24]

    def scenario(srv):
        a = srv.submit(sys_prompt + [1], 4, cache_prefix=True)
        srv.drain()
        b = srv.submit(sys_prompt + LONG[:12], 4)
        queued = bool(srv._prefilling)
        srv.drain()
        return (srv.pop_result(a), srv.pop_result(b), queued,
                srv.prefix_hits, srv.prefix_tokens_saved,
                srv.stats()["prefix_cache"])

    got = both(params, scenario, impl=impl, max_batch=1,
               prefix_cache_size=8, prefill_chunk=8)
    assert got[2] and got[3] == 1 and got[4] == 24
    _, plain = engines(params, impl=impl, max_batch=1, prefix_cache_size=8)
    assert scenario(plain)[:2] == got[:2]


def test_cancel_mid_prefill_frees_slot(params):
    def scenario(srv):
        b = srv.submit(LONG, 4)
        srv.step()                      # one chunk in
        assert srv._prefilling
        reserved = srv._alloc.used_count
        assert srv.cancel(b)
        freed = reserved - srv._alloc.used_count
        assert not srv._prefilling and list(srv._free) == [0]
        c = srv.submit([7, 7], 3)
        out = srv.drain()
        return out[b], out[c], freed

    out_b, out_c, freed = both(params, scenario, max_batch=1,
                               prefill_chunk=8)
    assert out_b == LONG and len(out_c) == 5 and freed == 5


@pytest.mark.parametrize("bad", [7, 12, 4, -8])
def test_bad_chunk_sizes_rejected(params, bad):
    jp, tp = params
    with pytest.raises(ValueError, match="power of two") as ref:
        JDecodeServer(jp, JCFG, max_batch=1, prefill_chunk=bad, **PAGED)
    with pytest.raises(ValueError, match="power of two") as port:
        DecodeServer(tp, TCFG, max_batch=1, prefill_chunk=bad,
                     device="cpu", **PAGED)
    assert str(port.value) == str(ref.value)


# ---------------------------------------------------------------------------
# paged composition (tests/test_serving_paged.py:397, :412)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth,steps", [(1, 1), (2, 1), (2, 4)])
def test_chunked_prefill_composes_with_paging(params, depth, steps):
    def scenario(srv):
        r0 = srv.submit([1, 2, 3], 10)
        for _ in range(2):
            srv.step()
        long = list(range(1, 31))
        r1 = srv.submit(long, 5)
        out = srv.drain()
        return out[r0], out[r1]

    both(params, scenario, max_batch=2, kv_blocks=24, prefill_chunk=8,
         pipeline_depth=depth, decode_steps=steps)


def test_cancel_mid_prefill_releases_reserved_blocks(params):
    def scenario(srv):
        r0 = srv.submit([1, 2, 3], 6)
        r1 = srv.submit(list(range(1, 31)), 5)  # chunked: blocks reserved
        assert srv._prefilling
        reserved = srv._alloc.used_count
        assert srv.cancel(r1)
        freed = reserved - srv._alloc.used_count
        return srv.drain()[r0], freed

    _, freed = both(params, scenario, max_batch=2, kv_blocks=12,
                    prefill_chunk=8)
    assert freed == 4


# ---------------------------------------------------------------------------
# budgeted prefill: any budget schedule == the unbudgeted run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "kernel"])
def test_budget_invariance(params, impl):
    """(tests/test_budgeted_prefill.py's paged case, both formulations.)"""
    reqs = [(LONG, 4, {}), (LONG[:17], 4, {})]
    _, unbudgeted = engines(params, impl=impl, max_batch=2, prefill_chunk=8)
    want = drain_all(unbudgeted, reqs)
    got = both(params, lambda e: drain_all(e, reqs), impl=impl,
               max_batch=2, prefill_chunk=8, prefill_budget=8)
    assert got == want


@pytest.mark.parametrize("budget", [4, 16])
def test_budget_invariance_mix(params, budget):
    _, unbudgeted = engines(params, max_batch=4, prefill_chunk=8)
    want = drain_all(unbudgeted, MIX)
    got = both(params, lambda e: drain_all(e, MIX), max_batch=4,
               prefill_chunk=8, prefill_budget=budget)
    assert got == want


@pytest.mark.parametrize("seed", range(2))
def test_budget_invariance_seeded_fuzz(params, seed):
    rng = random.Random(100 + seed)
    chunk = rng.choice([8, 16])
    budget = rng.choice([2, 4, 8, 16, 40])
    pool = [LONG, LONG[:33], LONG[:17], [5, 9], [1, 2, 3]]
    reqs = []
    for _ in range(rng.randint(3, 5)):
        p = rng.choice(pool)
        kw = {}
        if rng.random() < 0.4:
            kw = dict(temperature=0.8, top_k=8, seed=rng.randint(0, 99))
        reqs.append((p, rng.randint(3, 6), kw))
    _, unbudgeted = engines(params, max_batch=4, prefill_chunk=chunk)
    want = drain_all(unbudgeted, reqs)
    got = both(params, lambda e: drain_all(e, reqs), max_batch=4,
               prefill_chunk=chunk, prefill_budget=budget)
    assert got == want, f"chunk={chunk} budget={budget}"


# ---------------------------------------------------------------------------
# budgeted prefill: the scheduler's decisions, deterministic under an
# injected slack clock and cost hints
# ---------------------------------------------------------------------------

def test_submit_records_deadline_on_slack_clock(params):
    clk = FakeClock()
    clk.t = 50.0
    jeng, teng = engines(params, max_batch=1, prefill_chunk=8,
                         prefill_budget=8, slack_clock=clk)
    for srv in (jeng, teng):
        srv.submit(LONG, 4, deadline_s=7.0)
        assert srv._prefilling[0]["req"].deadline == 57.0
        srv.submit(LONG, 4)
        assert srv._pending[0].deadline is None
        srv.drain()


def test_tpot_clamp_starves_prefill_until_decode_drains(params):
    def scenario(srv):
        srv.tick_s_hint = 1.0
        srv.prefill_tok_s_hint = 0.0
        a = srv.submit([4, 5], 20, deadline_s=5.0)  # needs 20 ticks, has 5
        srv.step()
        b = srv.submit(LONG, 4)
        seen = [sched_state(srv)]
        srv.step()
        seen.append(sched_state(srv))
        out = srv.drain()
        seen.append(sched_state(srv))
        return seen, out[a], out[b]

    seen, out_a, _ = both(params, scenario, max_batch=2, prefill_chunk=8,
                          prefill_budget=40, slack_clock=FakeClock())
    assert seen[1][3] >= 1                  # clamped
    assert seen[1][0] == seen[0][0]         # starved: no chunk ran
    assert len(out_a) == 2 + 20


def test_ttft_critical_prefill_overdraws_once_per_tick(params):
    def scenario(srv):
        srv.tick_s_hint = 1.0
        srv.prefill_tok_s_hint = 1.0
        srv.submit([4, 5], 30)
        srv.step()
        b = srv.submit(LONG, 4, deadline_s=10.0)    # hopeless TTFT
        seen = [sched_state(srv)]
        srv.step()
        seen.append(sched_state(srv))
        out = srv.drain()
        return seen, out[b]

    seen, out_b = both(params, scenario, max_batch=2, prefill_chunk=8,
                       prefill_budget=2, slack_clock=FakeClock())
    (before, *_), (after, credit, _, _, overrides, _) = seen
    assert overrides == 1
    assert list(after.values()) == [v - 1 for v in before.values()]
    assert credit < 0
    assert out_b[:len(LONG)] == LONG


def test_edf_picks_tightest_deadline_first(params):
    def scenario(srv):
        srv.tick_s_hint = 1.0
        srv.prefill_tok_s_hint = 1.0 / 8
        a = srv.submit(LONG, 4, deadline_s=100.0)       # loose
        b = srv.submit(LONG[:32], 4, deadline_s=6.0)    # tight
        seen = [sched_state(srv)]
        srv.step()
        seen.append(sched_state(srv))
        srv.drain()
        return a, b, seen

    a, b, seen = both(params, scenario, max_batch=2, prefill_chunk=8,
                      prefill_budget=8, slack_clock=FakeClock())
    before, after = seen[0][0], seen[1][0]
    assert after[b] == before[b] - 1 and after[a] == before[a]


def test_no_deadline_falls_back_to_fifo(params):
    def scenario(srv):
        a = srv.submit(LONG, 3)
        b = srv.submit(LONG[:32], 3)
        before = sched_state(srv)
        srv.step()
        after = sched_state(srv)
        srv.drain()
        return a, b, before[0], after[0]

    a, b, before, after = both(params, scenario, max_batch=2,
                               prefill_chunk=8, prefill_budget=8)
    assert after[a] == before[a] - 1 and after[b] == 4


def test_liveness_tiny_budget_drains_without_decode_work(params):
    _, unbudgeted = engines(params, max_batch=1, prefill_chunk=8)
    want = drain_all(unbudgeted, [(LONG, 4, {})])
    got = both(params, lambda e: drain_all(e, [(LONG, 4, {})]),
               max_batch=1, prefill_chunk=8, prefill_budget=1)
    assert got == want


def test_credit_accrual_is_capped_and_paces_chunks(params):
    def scenario(srv):
        srv.submit([4, 5], 30)
        srv.step()
        srv.submit(LONG, 3)
        advanced, seen = [], []
        for _ in range(10):
            before = sum(len(e["todo"]) for e in srv._prefilling)
            srv.step()
            after = sum(len(e["todo"]) for e in srv._prefilling)
            advanced.append(before - after)
            seen.append(sched_state(srv))
            assert srv._prefill_credit <= max(srv.prefill_budget,
                                              srv._prefill_chunk)
        srv.drain()
        return advanced, seen

    advanced, _ = both(params, scenario, max_batch=2, prefill_chunk=8,
                       prefill_budget=4)
    assert sum(advanced) == 5 and max(advanced) == 1


def test_stats_surface_and_backlog_accessors(params):
    def scenario(srv):
        srv.prefill_tok_s_hint = 0.5
        srv.submit(LONG, 3)
        out = [srv.prefill_backlog(), srv.prefill_backlog_s(),
               srv.stats()["prefill_sched"]]
        srv.drain()
        st = srv.stats()["prefill_sched"]
        # the tick estimate is the engine's own host reading
        st.pop("est_tick_s")
        out.append(st)
        return out

    backlog, backlog_s, st, _ = both(params, scenario, max_batch=2,
                                     prefill_chunk=8, prefill_budget=16)
    assert backlog == len(LONG) and backlog_s == pytest.approx(20.0)
    assert st["budget"] == 16 and st["backlog_tokens"] == len(LONG)
    jeng, teng = engines(params, max_batch=1)
    assert teng.stats()["prefill_sched"] is None
    assert jeng.stats()["prefill_sched"] is None


def test_bad_budget_rejected(params):
    jp, tp = params
    with pytest.raises(ValueError, match="prefill_budget") as ref:
        JDecodeServer(jp, JCFG, max_batch=1, prefill_chunk=8,
                      prefill_budget=-1, **PAGED)
    with pytest.raises(ValueError, match="prefill_budget") as port:
        DecodeServer(tp, TCFG, max_batch=1, prefill_chunk=8,
                     prefill_budget=-1, device="cpu", **PAGED)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("kw", [dict(prefill_budget=64),
                                dict(prefill_chunk=8, prefill_budget=-1),
                                dict(prefill_chunk=12)])
def test_server_config_validates_budget_and_chunk(kw):
    """build_engine fails on the config alone, with the reference's
    message."""
    base = dict(KW, bf16=False, kv_blocks=24, kv_block_size=8)
    with pytest.raises(ValueError) as ref:
        jserver.build_engine(jserver.ServerConfig(**base, **kw))
    with pytest.raises(ValueError) as port:
        tserver.build_engine(tserver.ServerConfig(**base, **kw),
                             device="cpu")
    assert str(port.value) == str(ref.value)


def test_step_self_measures_ticks_under_a_budget(params):
    """Without a serving loop, step() feeds the TPOT cost model its own
    dispatch-and-wait seconds (only under a budget, as the reference)."""
    jeng, teng = engines(params, max_batch=1, prefill_chunk=8,
                         prefill_budget=8)
    _, plain = engines(params, max_batch=1, prefill_chunk=8)
    for srv in (jeng, teng, plain):
        srv.submit([4, 5], 4)
        srv.drain()
    # the reference skips its compile ticks; the CPU port captures none
    assert teng._tick_s and jeng._tick_s
    assert not plain._tick_s
