"""Port parity: request-level tenant quotas (``models/tenantquota.py``,
the copied quota arithmetic in ``quota/info.py``, and the engine's
weighted admission, reclaim, over-max shed and tenant-scoped prefix
chains) against the JAX package on the CPU.

Twins of tests/test_tenant_serving.py on the tiny f32 config and bridged
weights: each scenario runs on the port's engine (the kernel formulation,
its plain version on CPU tensors) and the reference's paged engine (the
gather formulation, set by monkeypatch only), tokens held to the
reference's ``generate`` and the two engines' tenant records to each
other. The reference's slot-static cases run on the paged engine (the
port has no slot-static engine yet; ROADMAP A.12). Hypothesis
properties hold ``TenantScheduler.pick`` and ``borrow_shares`` to the
reference's under the same fake clock and draws.
"""
import pytest
import torch

jax = pytest.importorskip("jax")
hypothesis = pytest.importorskip("hypothesis")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from nos_tpu.models import tenantquota as jtq  # noqa: E402
from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu.models.generate import generate as jgenerate  # noqa: E402
from nos_tpu.models.serving import DecodeServer as JDecodeServer  # noqa: E402
from nos_tpu.quota import info as jinfo  # noqa: E402
from nos_tpu_torch.cmd import server as tserver  # noqa: E402
from nos_tpu_torch.models import tenantquota as ttq  # noqa: E402
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402
from nos_tpu_torch.models.errors import TenantQuotaExceeded  # noqa: E402
from nos_tpu_torch.models.serving import DecodeServer  # noqa: E402
from nos_tpu_torch.quota import info as tinfo  # noqa: E402

MODEL = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq=64)
JCFG = jtfm.TransformerConfig(**MODEL, dtype=jnp.float32)
TCFG = ttfm.TransformerConfig(**MODEL, dtype=torch.float32)


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


def quota(mod=ttq, window_s=8.0, gold_min=100.0, burst_max=5.0,
          share_prefix=False):
    return mod.TenantQuotaConfig(
        tenants={
            "gold": mod.TenantSpec("gold", min_rate=gold_min),
            "burst": mod.TenantSpec("burst", max_rate=burst_max),
        }, window_s=window_s, share_prefix=share_prefix)


def engines(params, clock, qkw=None, **kw):
    """(port engine, reference engine) over the same weights, quota and
    injected clock."""
    jp, tp = params
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("kv_block_size", 8)
    kw.setdefault("kv_blocks", 17)
    qkw = qkw or {}
    t = DecodeServer(tp, TCFG, tenant_quota=quota(ttq, **qkw),
                     tenant_clock=lambda: clock[0], device="cpu",
                     paged_impl="kernel", **kw)
    j = JDecodeServer(jp, JCFG, tenant_quota=quota(jtq, **qkw),
                      tenant_clock=lambda: clock[0], **kw)
    return t, j


def both(params, scenario, qkw=None, **kw):
    """Run ``scenario(engine, clock)`` on the port and the reference
    engine, each on its own fake clock from 0; returns both results."""
    out = []
    for i in range(2):
        clock = [0.0]
        eng = engines(params, clock, qkw, **kw)[i]
        out.append(scenario(eng, clock))
    return out


def _snap(eng):
    """The tenant snapshot without its timing-free keys' float noise."""
    return eng.tenant_snapshot()


# ---------------------------------------------------------------------------
# weighted admission (tests/test_tenant_serving.py:54-97)
# ---------------------------------------------------------------------------

def test_guaranteed_tenant_admitted_before_borrower(params):
    """With one slot busy and both tenants pending, the under-min gold
    request admits before the earlier burst request. The reference
    observes the queue alone on its slot-static engine; on the paged
    engine a burst holder would be reclaimed, so a gold holder (never a
    victim of its own tenant) keeps the queue the only mechanism."""
    def scenario(eng, clock):
        holder = eng.submit([9, 9], 4, tenant="gold")
        b = eng.submit([1, 2, 3], 3, tenant="burst")
        g = eng.submit([4, 5, 6], 3, tenant="gold")
        order = []
        while eng.has_work():
            eng.step()
            clock[0] += 0.25
            for led in eng.drain_ledgers():
                order.append(led["rid"])
        eng.drain()
        assert order[0] == holder
        assert order.index(g) < order.index(b)
        return order, eng.tenant_reclaims
    got, want = both(params, scenario, max_batch=1)
    assert got == want and got[1] == 0


def test_unlabeled_traffic_is_default_tenant(params):
    def scenario(eng, clock):
        rid = eng.submit([1, 2, 3], 2)
        eng.drain()
        led = eng.pop_ledger(rid)
        assert led["tenant"] == "default"
        snap = eng.tenant_snapshot()
        assert snap["default"]["tokens_total"] == 2
        assert set(snap) == {"default", "gold", "burst"}
        return snap
    got, want = both(params, scenario)
    assert got == want


def test_tenancy_off_keeps_fifo_and_no_snapshot(params):
    jp, tp = params
    eng = DecodeServer(tp, TCFG, max_batch=1, kv_block_size=8,
                       kv_blocks=17, device="cpu")
    assert eng.tenant_snapshot() is None
    assert eng.stats()["tenants"] is None
    a = eng.submit([1, 2], 2, tenant="whoever")     # tag stored, inert
    b = eng.submit([3, 4], 2)
    out = eng.drain()
    assert out == {a: ref(jp, [1, 2], 2), b: ref(jp, [3, 4], 2)}


# ---------------------------------------------------------------------------
# preemptive reclaim (tests/test_tenant_serving.py:104-150)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_swap", [True, False])
def test_guaranteed_arrival_reclaims_over_quota_slot_bit_exact(
        params, kv_swap):
    jp, _ = params
    mode = "swap" if kv_swap else "recompute"

    def scenario(eng, clock):
        b1 = eng.submit([1, 2, 3], 8, tenant="burst")
        b2 = eng.submit([4, 5, 6], 8, tenant="burst")
        eng.step()
        clock[0] += 0.1
        g = eng.submit([7, 8], 6, tenant="gold")
        assert eng.tenant_reclaims == 1
        assert eng.preempts[mode] == 1
        snap = eng.tenant_snapshot()
        assert snap["gold"]["active"] == 1
        assert snap["burst"]["pending"] == 1
        assert snap["burst"]["preempts"][mode] == 1
        while eng.has_work():
            eng.step()
            clock[0] += 0.1
        out = eng.drain()
        assert out[b1] == ref(jp, [1, 2, 3], 8)
        assert out[b2] == ref(jp, [4, 5, 6], 8)
        assert out[g] == ref(jp, [7, 8], 6)
        return out, snap, eng.kv_stats()["tenant_reclaims"]
    got, want = both(params, scenario, kv_swap=kv_swap)
    assert got == want


def test_no_reclaim_from_within_min_tenants(params):
    def scenario(eng, clock):
        eng.submit([1, 2], 8, tenant="gold")
        eng.submit([3, 4], 8, tenant="gold")
        eng.step()
        clock[0] += 0.1
        eng.submit([5, 6], 4, tenant="burst")
        eng.submit([7, 8], 4, tenant="gold")
        assert eng.tenant_reclaims == 0
        assert eng.preempts == {"swap": 0, "recompute": 0}
        while eng.has_work():
            eng.step()
            clock[0] += 0.1
        out = eng.drain()
        assert len(out) == 4
        return out
    got, want = both(params, scenario)
    assert got == want


# ---------------------------------------------------------------------------
# over-max shed (tests/test_tenant_serving.py:157-191)
# ---------------------------------------------------------------------------

def test_over_max_tenant_sheds_tenant_quota_under_contention(params):
    def scenario(eng, clock):
        eng.submit([1] * 4, 40, tenant="burst")
        for _ in range(25):
            eng.step()
        with pytest.raises(Exception) as ei:
            eng.submit([2] * 4, 4, tenant="burst")
        assert ei.value.reason == "tenant_quota"
        assert eng.tenant_snapshot()["burst"]["sheds"] == 1
        g = eng.submit([3] * 4, 2, tenant="gold")
        while eng.has_work():
            eng.step()
            clock[0] += 0.1
        assert g in eng.drain()
        return type(ei.value).__name__, str(ei.value)
    got, want = both(params, scenario, qkw=dict(window_s=4.0),
                     max_batch=1)
    assert got == want
    assert issubclass(TenantQuotaExceeded, tserver.QueueFull)


def test_idle_engine_lends_past_max(params):
    def scenario(eng, clock):
        eng.submit([1] * 4, 30, tenant="burst")
        while eng.has_work():
            eng.step()
        eng.drain()
        assert eng.tenant_snapshot()["burst"]["over_max"]
        rid = eng.submit([2] * 4, 2, tenant="burst")
        out = eng.drain()
        assert rid in out
        return out[rid]
    got, want = both(params, scenario, qkw=dict(window_s=4.0),
                     max_batch=1)
    assert got == want


# ---------------------------------------------------------------------------
# tenant-scoped prefix caches (tests/test_tenant_serving.py:198-243)
# ---------------------------------------------------------------------------

def test_paged_prefix_chains_disjoint_across_tenants(params):
    base = list(range(1, 17))

    def scenario(eng, clock):
        eng.submit(base + [20], 2, tenant="gold", cache_prefix=True)
        eng.drain()
        hits0 = eng._pindex.hits
        eng.submit(base + [21], 2, tenant="burst", cache_prefix=True)
        eng.drain()
        assert eng._pindex.hits == hits0
        assert eng._pindex.stats()["chains"] == 2
        eng.submit(base + [22], 2, tenant="gold")
        out = eng.drain()
        assert eng._pindex.hits == hits0 + 1
        scopes = sorted(k[0] for k, _ in eng._pindex.chain_items())
        assert scopes == ["burst", "gold"]
        return out, eng.stats()["prefix_index"]["chains"]
    got, want = both(params, scenario, prefix_cache_size=8)
    assert got[0] == want[0]
    assert [(r["digest"], r["scope"]) for r in got[1]] == \
        [(r["digest"], r["scope"]) for r in want[1]]


def test_share_prefix_opt_out_restores_cross_tenant_reuse(params):
    base = list(range(1, 17))

    def scenario(eng, clock):
        eng.submit(base + [20], 2, tenant="gold", cache_prefix=True)
        eng.drain()
        eng.submit(base + [21], 2, tenant="burst")
        out = eng.drain()
        assert eng._pindex.hits == 1
        assert eng._pindex.stats()["chains"] == 1
        return out
    got, want = both(params, scenario, qkw=dict(share_prefix=True),
                     prefix_cache_size=8)
    assert got == want


def test_slot_static_prefix_scoped_by_tenant(params):
    """The reference's case on both slot-static engines: the prefix
    cache is scoped by the resolved tenant, so another tenant's
    published prompt is no hit and the publisher's own is; tokens and
    hit counts equal the reference's, and ``build_engine`` serves the
    same config with a scoped slot-static engine."""
    jp, _ = params
    base = list(range(1, 13))

    def scenario(eng, clock):
        eng.submit(base, 1, tenant="gold", cache_prefix=True)
        eng.drain()
        r = eng.submit(base + [30, 31, 32, 33], 2, tenant="burst")
        got = eng.drain()[r]
        cross = eng.prefix_hits
        eng.submit(base + [40, 41, 42, 43], 2, tenant="gold")
        eng.drain()
        return got, cross, eng.prefix_hits

    got, want = both(params, scenario, max_batch=1, kv_blocks=0,
                     kv_block_size=0, prefix_cache_size=4)
    assert got == want
    assert got[1] == 0 and got[2] == 1
    assert got[0] == ref(jp, base + [30, 31, 32, 33], 2)
    cfg = tserver.ServerConfig(
        **MODEL, bf16=False, kv_blocks=0, prefix_cache_size=4,
        tenant_config='{"tenants": {"gold": {"min_rate": 100}}}')
    eng = tserver.build_engine(cfg, device="cpu")
    assert not eng.paged and eng._prefix_scoped


# ---------------------------------------------------------------------------
# restart / fork plumbing (tests/test_tenant_serving.py:250-280)
# ---------------------------------------------------------------------------

def test_capture_restore_preserves_tenant(params):
    jp, tp = params
    clock = [0.0]
    eng, _ = engines(params, clock)
    eng.submit([1, 2, 3], 8, tenant="burst")
    eng.step()
    states = eng.capture_resumable()
    assert states[0]["tenant"] == "burst"
    fresh, jfresh = engines(params, clock)
    nrid = fresh.restore(states[0])
    while fresh.has_work():
        fresh.step()
        clock[0] += 0.1
    out = fresh.drain()
    assert out[nrid] == ref(jp, [1, 2, 3], 8)
    assert fresh.pop_ledger(nrid)["tenant"] == "burst"
    # the reference engine adopts the port's capture with its tenant
    jrid = jfresh.restore(states[0])
    assert jfresh.drain()[jrid] == out[nrid]
    assert jfresh.pop_ledger(jrid)["tenant"] == "burst"


def test_fork_inherits_tenant(params):
    jp, _ = params

    def scenario(eng, clock):
        rid = eng.submit([1, 2, 3], 6, tenant="burst")
        eng.step()
        nrid = eng.fork(rid)
        snap = eng.tenant_snapshot()
        assert snap["burst"]["active"] == 2
        while eng.has_work():
            eng.step()
            clock[0] += 0.1
        out = eng.drain()
        assert out[rid] == out[nrid] == ref(jp, [1, 2, 3], 6)
        return out, snap
    got, want = both(params, scenario, max_batch=3)
    assert got == want


# ---------------------------------------------------------------------------
# the chip ledger (an SLO config turns it on)
# ---------------------------------------------------------------------------

def test_chip_ledger_charges_every_quantum_and_conserves(params):
    """With SLO objectives in the config the engine keeps the chip
    ledger: ``step`` charges each quantum to the tenants whose tokens it
    produced, prefill and decode apart, and per-tenant time adds up to
    the ledger's span; without objectives there is no ledger."""
    _, tp = params
    cfg = ttq.TenantQuotaConfig.from_json(
        '{"tenants": {"gold": {"min_rate": 10, "slo": '
        '{"ttft_p99_ms": 500}}, "burst": {}}}')
    eng = DecodeServer(tp, TCFG, max_batch=2, kv_block_size=8,
                       kv_blocks=17, tenant_quota=cfg, device="cpu",
                       paged_impl="kernel")
    eng.submit([1, 2, 3], 6, tenant="gold")
    eng.submit([4, 5], 5, tenant="burst")
    eng.drain()
    totals = eng.chip.totals_ns()
    assert {t for t, _ in totals} >= {"gold", "burst"}
    assert ("gold", "decode") in totals and ("burst", "decode") in totals
    assert eng.chip.conserved()
    assert sum(totals.values()) == eng.chip.wall_ns > 0
    off = DecodeServer(tp, TCFG, max_batch=2, kv_block_size=8, kv_blocks=17,
                       tenant_quota=quota(), device="cpu")
    assert off.chip is None


# ---------------------------------------------------------------------------
# the scheduler and the share arithmetic against the reference
# ---------------------------------------------------------------------------

_SPEC = st.tuples(
    st.sampled_from([0.0, 0.0, 3.5, 20.0, 55.25]),
    st.sampled_from([0.0, 0.0, 10.0, 60.0, 120.5]))


def _pair(specs, window_s):
    """(port config, reference config) from ((min, max), ...) specs; a
    max below its min is dropped (the config refuses it)."""
    out = []
    for mod in (ttq, jtq):
        tenants = {}
        for i, (mn, mx) in enumerate(specs):
            mx = mx if mx == 0.0 or mx >= mn else 0.0
            tenants[f"t{i}"] = mod.TenantSpec(f"t{i}", min_rate=mn,
                                              max_rate=mx)
        out.append(mod.TenantQuotaConfig(tenants=tenants,
                                         window_s=window_s))
    return out


@settings(max_examples=60, deadline=None)
@given(specs=st.lists(_SPEC, min_size=1, max_size=5),
       window_s=st.sampled_from([1.0, 4.0, 8.0]),
       events=st.lists(st.tuples(
           st.floats(0.05, 2.0), st.integers(0, 5), st.integers(0, 400),
           st.lists(st.integers(0, 5), min_size=1, max_size=6)),
           min_size=1, max_size=40))
def test_pick_equals_the_references(specs, window_s, events):
    """Under the same fake clock and the same draws (time steps, token
    notes, candidate sets), the port's pick, rates, under/over
    classification, reclaim ratio and snapshot are the reference's."""
    tcfg, jcfg = _pair(specs, window_s)
    ts, js = ttq.TenantScheduler(tcfg), jtq.TenantScheduler(jcfg)
    names = tcfg.names()
    assert names == jcfg.names()
    now = 0.0
    for dt, who, n, cands in events:
        now += dt
        tenant = names[who % len(names)]
        for s in (ts, js):
            s.note_tokens(tenant, n, now)
        cand = [names[c % len(names)] for c in cands] + ["stranger"]
        assert ts.pick(cand, now) == js.pick(cand, now)
        for t in names:
            assert ts.rate(t, now) == js.rate(t, now)
            assert ts.under_min(t, now) == js.under_min(t, now)
            assert ts.over_min(t, now) == js.over_min(t, now)
            assert ts.over_max(t, now) == js.over_max(t, now)
            assert ts.over_quota_ratio(t, now) == \
                js.over_quota_ratio(t, now)
        for s in (ts, js):
            s.note_shed(tenant)
            s.note_preempt(tenant, "swap")
    assert ts.snapshot(now) == js.snapshot(now)


@settings(max_examples=80, deadline=None)
@given(quotas=st.lists(st.tuples(
    st.sampled_from(["serve_tokens", "cpu", "memory"]),
    st.floats(0.0, 5e4), st.floats(0.0, 6e4)), min_size=1, max_size=6))
def test_borrow_shares_equal_guaranteed_overquotas(quotas):
    """The copied quota arithmetic is the reference's: the same quotas
    (min, used) give the same ``guaranteed_overquotas`` for every
    namespace, cpu's millicore floor included."""
    tin, jin = tinfo.QuotaInfos(), jinfo.QuotaInfos()
    for i, (res, mn, used) in enumerate(quotas):
        ns = f"ns{i}"
        tin.add(tinfo.QuotaInfo(name=ns, namespace=ns, namespaces={ns},
                                min={res: mn}, used={res: used}))
        jin.add(jinfo.QuotaInfo(name=ns, namespace=ns, namespaces={ns},
                                min={res: mn}, used={res: used}))
    for i in range(len(quotas)):
        ns = f"ns{i}"
        assert tin.guaranteed_overquotas(ns) == \
            jin.guaranteed_overquotas(ns)
    assert tin.aggregated_min() == jin.aggregated_min()
    assert tin.aggregated_overquotas() == jin.aggregated_overquotas()


@settings(max_examples=40, deadline=None)
@given(specs=st.lists(_SPEC, min_size=1, max_size=6),
       notes=st.lists(st.tuples(st.integers(0, 5), st.integers(1, 500),
                                st.floats(0.1, 1.5)), max_size=30))
def test_scheduler_borrow_shares_equal_the_references(specs, notes):
    """``TenantScheduler.borrow_shares`` (the shares the pick and the
    reclaim ranking read) equals the reference's after the same token
    notes."""
    tcfg, jcfg = _pair(specs, 8.0)
    ts, js = ttq.TenantScheduler(tcfg), jtq.TenantScheduler(jcfg)
    names = tcfg.names()
    now = 0.0
    for who, n, dt in notes:
        now += dt
        for s in (ts, js):
            s.note_tokens(names[who % len(names)], n, now)
        assert ts.borrow_shares(now) == js.borrow_shares(now)


def test_config_parsing_and_messages_are_the_references(tmp_path):
    good = ('{"tenants": {"gold": {"min_rate": 200, "slo": '
            '{"ttft_p99_ms": 300, "goodput_floor": 0.5}}, '
            '"burst": {"max_rate": 50}}, "window_s": 2.5, '
            '"share_prefix": true}')
    t, j = ttq.TenantQuotaConfig.from_json(good), \
        jtq.TenantQuotaConfig.from_json(good)
    assert t.echo() == j.echo() and t.slo_enabled() == j.slo_enabled()
    p = tmp_path / "t.json"
    p.write_text(good)
    assert ttq.TenantQuotaConfig.load(str(p)).echo() == t.echo()
    assert ttq.TenantQuotaConfig.load("") is None
    for bad in ('{"tenants": {"a": {"min_rate": 9, "max_rate": 3}}}',
                '{"unknown_key": 1}', '{"window_s": 0}', '[1]',
                '{"tenants": {"a": {"slo": {"goodput_floor": 1.5}}}}',
                '{"tenants": {"a\\nb": {}}}'):
        with pytest.raises(ValueError) as want:
            jtq.TenantQuotaConfig.from_json(bad)
        with pytest.raises(ValueError) as got:
            ttq.TenantQuotaConfig.from_json(bad)
        assert str(got.value) == str(want.value)
    for name in ("team-a", "", "x" * 200, 'a"b', 123):
        try:
            want = jtq.validate_tenant_name(name)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                ttq.validate_tenant_name(name)
        else:
            assert ttq.validate_tenant_name(name) == want
