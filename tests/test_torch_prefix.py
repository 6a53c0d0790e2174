"""Port parity: the paged prefix cache, copy-on-write and ``fork`` in the
torch ``DecodeServer`` against the JAX engine (CPU, f32, the tiny config
of tests/test_serving_paged.py, bridged weights).

Twins of tests/test_serving_paged.py:96 (COW fork over the {1,2}x{1,4}
grid), :148, :171, :195, :337 and :379: each scenario runs on the
reference engine and on the port's, which must commit the same tokens,
report the same prefix hits, tokens saved, ``stats()`` prefix sections
and shared-block counts, and leave a balanced pool. A prefix hit under
the kernel formulation prefills its suffix in the arena (one S > 1
window of ``forward_paged``), held against the reference's kernel path
in Pallas interpret mode; under the gather formulation the shared blocks
seed a scratch row, held against the reference's gather path. int8
arenas carry their scale planes through every copy-on-write.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu.models.generate import generate as jgenerate  # noqa: E402
from nos_tpu.models.serving import DecodeServer as JDecodeServer  # noqa: E402
from nos_tpu_torch.models import serving as tserving  # noqa: E402
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402
from nos_tpu_torch.models.errors import Infeasible  # noqa: E402
from nos_tpu_torch.models.serving import DecodeServer  # noqa: E402

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=64, max_seq=64)
JCFG = jtfm.TransformerConfig(dtype=jnp.float32, **KW)
TCFG = ttfm.TransformerConfig(dtype=torch.float32, **KW)
GRID = [(d, t) for d in (1, 2) for t in (1, 4)]
SYSP = list(range(1, 20))               # 19 tokens: 2 full blocks of 8


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, ttfm.params_from_jax(jp, "cpu")


@pytest.fixture(autouse=True)
def pallas_compat(monkeypatch):
    """The reference engine's formulation switch (gather unless a test
    says otherwise), and the renamed ``pltpu.TPUCompilerParams`` aliased
    so the reference kernel runs in interpret mode on the installed
    JAX."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("NOS_TPU_PAGED_KERNEL", "0")
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


def engines(params, monkeypatch, impl="xla", **kw):
    """(reference engine, port engine), the reference on the same
    formulation as the port's ``impl``."""
    jp, tp = params
    monkeypatch.setenv("NOS_TPU_PAGED_KERNEL", "1" if impl == "kernel"
                       else "0")
    knobs = dict(kv_block_size=8, **kw)
    jeng = JDecodeServer(jp, JCFG, **knobs)
    assert jeng.paged_kernel == impl
    return jeng, DecodeServer(tp, TCFG, device="cpu", paged_impl=impl,
                              **knobs)


def ref(jp, prompt, n):
    out = jgenerate(jp, JCFG, jnp.asarray([prompt], jnp.int32), n)
    return [int(t) for t in out[0]]


def assert_pool_balanced(eng):
    """Quiescent pool: every block free or held by the prefix index."""
    assert not eng.has_work()
    held = eng._pindex.block_count if eng._pindex is not None else 0
    assert eng._alloc.used_count == held, (eng._alloc.used_count, held)
    assert not eng._deferred
    assert all(not t for t in eng._tables)


def both(params, monkeypatch, scenario, impl="xla", **kw):
    """Run ``scenario`` on the reference and the port: the same record,
    and both pools balanced. Returns (record, port engine)."""
    jeng, teng = engines(params, monkeypatch, impl=impl, **kw)
    want = scenario(jeng)
    got = scenario(teng)
    assert got == want
    assert_pool_balanced(jeng)
    assert_pool_balanced(teng)
    return got, teng


def prefix_surface(srv) -> tuple:
    """The prefix sections of stats() and kv_stats()."""
    st = srv.stats()
    return (st["prefix_cache"], st["prefix_index"], srv.kv_stats()["prefix"],
            srv.kv_stats()["cow_shared"], srv.kv_stats()["scaled_blocks"],
            srv.prefix_hits, srv.prefix_tokens_saved)


# ---------------------------------------------------------------------------
# block-granular prefix reuse (tests/test_serving_paged.py:171)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("impl", ["kernel", "xla"])
def test_block_granular_prefix_reuse_is_exact_and_shares_storage(
        params, monkeypatch, impl, kv_dtype):
    def scenario(srv):
        srv.submit(SYSP + [33], 2, cache_prefix=True)
        srv.drain()
        kv0 = srv.kv_stats()
        used0 = kv0["blocks_used"]
        r = srv.submit(SYSP + [40, 41], 5)
        shared = srv._alloc.shared_count()
        during = prefix_surface(srv)
        res = srv.drain()
        kv = srv.kv_stats()
        after = prefix_surface(srv)
        srv._pindex.clear()
        srv.prefix_hits = srv.prefix_tokens_saved = 0
        return (res[r], kv0["prefix"]["blocks"], used0, shared, during,
                kv["blocks_used"], after)

    (out, blocks0, used0, shared, _, used, after), teng = both(
        params, monkeypatch, scenario, impl=impl, max_batch=2,
        kv_blocks=40, kv_dtype=kv_dtype, prefix_cache_size=8)
    assert blocks0 == 2 and shared >= 2 and used == used0
    assert after[0]["hits"] == 1 and after[0]["tokens_saved"] == 16
    assert after[1]["chains"][0]["len"] == 16
    if kv_dtype == "bf16":
        assert out == ref(params[0], SYSP + [40, 41], 5)
    # the kernel formulation took the hit in the arena
    assert teng.arena_windows == (1 if impl == "kernel" else 0)


@pytest.mark.parametrize("depth,steps", [(1, 1), (2, 4)])
def test_shared_prompt_traffic_matches_reference(params, monkeypatch, depth,
                                                 steps):
    """Phase (k)'s traffic shape at tiny size: one system prompt with
    ``cache_prefix``, then requests sharing it with suffixes of their
    own, several at once, through the kernel formulation."""
    suffixes = [[40, 41], [42] * 9, list(range(30, 43)), [7]]

    def scenario(srv):
        srv.submit(SYSP[:16] + [50], 3, cache_prefix=True)
        srv.drain()
        rids = [srv.submit(SYSP[:16] + s, 6) for s in suffixes]
        shared = srv._alloc.shared_count()
        res = srv.drain()
        return [res[r] for r in rids], shared, prefix_surface(srv)

    (outs, shared, surface), teng = both(
        params, monkeypatch, scenario, impl="kernel", max_batch=4,
        kv_blocks=40, prefix_cache_size=8, pipeline_depth=depth,
        decode_steps=steps)
    assert shared == 2 and surface[5] == len(suffixes)
    assert teng.arena_windows == len(suffixes)
    for out, s in zip(outs, suffixes):
        assert out == ref(params[0], SYSP[:16] + s, 6)


def test_in_arena_window_equals_the_scratch_path(params):
    """The port's in-arena window (kernel formulation) and its
    scratch-seeded suffix prefill (gather formulation) give the same
    last-position logits within f32 rounding and the same tokens."""
    _, tp = params
    firsts, outs = {}, {}
    for impl in ("kernel", "xla"):
        srv = DecodeServer(tp, TCFG, max_batch=2, kv_block_size=8,
                           kv_blocks=40, prefix_cache_size=8,
                           device="cpu", paged_impl=impl)
        srv.submit(SYSP + [33], 2, cache_prefix=True)
        srv.drain()
        steps = []
        orig = srv._finish_prefill

        def spy(req, row, step, **kw):
            steps.append(step.clone())
            return orig(req, row, step, **kw)

        srv._finish_prefill = spy
        r = srv.submit(SYSP + [40, 41, 42], 6)
        outs[impl] = srv.drain()[r]
        firsts[impl] = steps[0]
    np.testing.assert_allclose(firsts["kernel"].numpy(),
                               firsts["xla"].numpy(), atol=1e-5)
    assert outs["kernel"] == outs["xla"]


def test_in_arena_window_leaves_the_graph_scratch(params, monkeypatch):
    """The in-arena window takes the kernel's per-stream scratch, never
    the engine's: the tensors a captured decode program recorded
    (``_scratch``) are the ones it keeps replaying."""
    _, tp = params
    calls = []
    real = tserving.forward_paged

    def spy(*a, **kw):
        calls.append((a[2].shape[1], kw.get("scratch")))
        return real(*a, **kw)

    monkeypatch.setattr(tserving, "forward_paged", spy)
    srv = DecodeServer(tp, TCFG, max_batch=2, kv_block_size=8,
                       kv_blocks=40, prefix_cache_size=8, device="cpu",
                       paged_impl="kernel")
    recorded = torch.zeros(4), torch.zeros(2, dtype=torch.int32)
    srv._scratch.part, srv._scratch.ticket = recorded
    srv.submit(SYSP + [33], 2, cache_prefix=True)
    srv.drain()
    srv.submit(SYSP + [40, 41], 3)
    srv.drain()
    windows = [sc for s, sc in calls if s > 1]
    ticks = [sc for s, sc in calls if s == 1]
    assert len(windows) == 1 and windows[0] is None
    assert ticks and all(sc is srv._scratch for sc in ticks)
    assert srv._scratch.part is recorded[0]
    assert srv._scratch.ticket is recorded[1]


@pytest.mark.parametrize("impl", ["kernel", "xla"])
def test_prefix_chains_evicted_under_admission_pressure(params, monkeypatch,
                                                        impl):
    """(:195) With the pool nearly full of published chains and no
    active slot, admission evicts LRU chains instead of deadlocking."""
    long = [33] * 30

    def scenario(srv):
        srv.submit(list(range(1, 17)) + [20], 2, cache_prefix=True)
        srv.drain()
        blocks0 = srv.kv_stats()["prefix"]["blocks"]
        r = srv.submit(long, 4)
        res = srv.drain()
        return res[r], blocks0, prefix_surface(srv)

    (out, blocks0, surface), _ = both(
        params, monkeypatch, scenario, impl=impl, max_batch=2, kv_blocks=7,
        prefix_cache_size=8)
    assert blocks0 == 2 and surface[2]["blocks"] == 0
    assert surface[1]["evicted"] == {"drop": 1, "demote": 0}
    assert out == ref(params[0], long, 4)


def test_prefix_evicted_for_waiting_request_while_others_decode(
        params, monkeypatch):
    """(:337) Headroom eviction applies with active slots too."""
    long = [33] * 30

    def scenario(srv):
        srv.submit(list(range(1, 17)) + [20], 2, cache_prefix=True)
        srv.drain()
        r0 = srv.submit([1, 2], 16)
        r1 = srv.submit(long, 4)
        admitted = len(srv._active)
        blocks = srv.kv_stats()["prefix"]["blocks"]
        res = srv.drain()
        return res[r0], res[r1], admitted, blocks

    (out0, out1, admitted, blocks), _ = both(
        params, monkeypatch, scenario, max_batch=2, kv_blocks=8,
        prefix_cache_size=8)
    assert admitted == 2 and blocks == 0
    assert out0 == ref(params[0], [1, 2], 16)
    assert out1 == ref(params[0], long, 4)


def test_pressure_relief_evicts_a_chain_then_raises_without_preemption(
        params, monkeypatch):
    """Under decode-time pool pressure the port evicts LRU chains first,
    as the reference does, and preempts only after: a chunked
    reservation that squeezes the sole decoder preempts it (the
    reference's tests/test_serving_paged.py:357) instead of raising, and
    both engines commit the same tokens with the same preemption counts
    and a balanced pool."""
    _, tp = params
    srv = DecodeServer(tp, TCFG, max_batch=2, kv_block_size=8, kv_blocks=5,
                       prefix_cache_size=8, device="cpu")
    srv.submit(list(range(1, 17)) + [20], 1, cache_prefix=True)
    srv.drain()
    assert srv.kv_stats()["prefix"]["blocks"] == 2
    r = srv.submit([4, 5], 20)      # grows past the two free blocks
    out = srv.drain()
    assert srv.kv_stats()["prefix"]["evicted"]["drop"] == 1
    assert srv.kv_stats()["preempts"] == {"swap": 0, "recompute": 0}
    assert out[r] == ref(params[0], [4, 5], 20)

    long = list(range(1, 49))

    def scenario(eng):
        r0 = eng.submit(list(range(1, 8)), 20)
        r1 = eng.submit(long, 2)
        assert eng._prefilling
        res = eng.drain()
        return res[r0], res[r1], eng.kv_stats()["preempts"]

    (out0, out1, preempts), _ = both(
        params, monkeypatch, scenario, max_batch=2, kv_blocks=10,
        prefill_chunk=8, decode_steps=4, kv_swap=False)
    assert preempts["recompute"] >= 1
    assert out0 == ref(params[0], list(range(1, 8)), 20)
    assert out1 == ref(params[0], long, 2)


# ---------------------------------------------------------------------------
# copy-on-write fork (tests/test_serving_paged.py:96, :148, :379)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("depth,steps", GRID)
def test_cow_fork_bit_exact_across_grid(params, monkeypatch, depth, steps,
                                        kv_dtype):
    """Fork mid-decode: source and fork both finish as the reference's
    do (bit-identical to generate() in f32), the shared tail block is
    copied rather than aliased, and the pool ends balanced."""
    def scenario(srv):
        r0 = srv.submit([4, 5], 16)
        srv.step()
        f0 = srv.fork(r0)
        shared = srv._alloc.shared_count()
        res = srv.drain()
        return res[r0], res[f0], shared, srv._alloc.shared_count()

    (src, fork, shared, after), teng = both(
        params, monkeypatch, scenario, max_batch=2, kv_blocks=24,
        kv_dtype=kv_dtype, pipeline_depth=depth, decode_steps=steps)
    assert shared > 0 and after == 0 and teng.cow_copies >= 1
    assert src == fork
    if kv_dtype == "bf16":
        assert src == ref(params[0], [4, 5], 16)


def test_int8_cow_copies_the_scale_planes(params):
    """The copy-on-write of an int8 block carries its scales: right
    after the copy, the fresh block's bytes and scales equal the
    source's in every layer, and the scale ledger versions match."""
    _, tp = params
    srv = DecodeServer(tp, TCFG, max_batch=2, kv_block_size=8, kv_blocks=24,
                       kv_dtype="int8", device="cpu")
    r0 = srv.submit([4, 5, 6], 12)
    srv.step()
    f0 = srv.fork(r0)
    fslot = next(s for s, r in srv._active.items() if r.rid == f0)
    src = srv._tables[fslot][0]
    assert srv._alloc.ref(src) == 2
    assert not srv._alloc.writable(src)
    snap = {k: srv.cache[k][:, src].clone()
            for k in ("k", "v", "k_scale", "v_scale")}
    version = srv._scales.version(src)
    srv._ensure_blocks(sorted(srv._active))
    # the first holder to write takes the copy; the other keeps src
    firsts = {srv._tables[s][0] for s in srv._active}
    assert src in firsts and len(firsts) == 2 and srv.cow_copies == 1
    (dst,) = firsts - {src}
    for k, v in snap.items():
        assert torch.equal(srv.cache[k][:, dst], v), k
    assert srv._scales.version(dst) is not None and version is not None
    srv.drain()
    assert_pool_balanced(srv)


def test_sampled_fork_diverges_by_seed(params, monkeypatch):
    """(:148) n>1 sampling: shared history, divergent futures."""
    def scenario(srv):
        r0 = srv.submit([4, 5], 10, temperature=0.9, seed=3)
        for _ in range(3):
            srv.step()
        f1 = srv.fork(r0, seed=100)
        f2 = srv.fork(r0, seed=200)
        res = srv.drain()
        return res[r0], res[f1], res[f2]

    (base, f1, f2), _ = both(params, monkeypatch, scenario, max_batch=4,
                             kv_blocks=40)
    assert f1[:5] == base[:5] and f2[:5] == base[:5] and f1 != f2


def test_fork_finds_slot_freed_by_inflight_completion(params, monkeypatch):
    """(:379) A completion parked in an unconsumed tick frees its slot
    during fork's barrier flush."""
    def scenario(srv):
        r0 = srv.submit([1, 2], 2)
        r1 = srv.submit([4, 5], 16)
        for _ in range(2):
            srv.step()
        f1 = srv.fork(r1)
        res = srv.drain()
        return res[r0], res[r1], res[f1]

    (out0, out1, outf), _ = both(params, monkeypatch, scenario, max_batch=2,
                                 kv_blocks=24, pipeline_depth=4)
    assert out1 == outf == ref(params[0], [4, 5], 16)
    assert out0 == ref(params[0], [1, 2], 2)


def test_fork_of_a_prefix_hit_request(params, monkeypatch):
    """A fork of a request whose head is a shared prefix chain: three
    holders of the chain's blocks, every output as the reference's."""
    def scenario(srv):
        srv.submit(SYSP + [33], 2, cache_prefix=True)
        srv.drain()
        r = srv.submit(SYSP + [40, 41], 8)
        srv.step()
        f = srv.fork(r, seed=9, temperature=0.8)
        slot = next(s for s, q in srv._active.items() if q.rid == r)
        refs = srv._alloc.ref(srv._tables[slot][0])
        res = srv.drain()
        return res[r], res[f], refs, prefix_surface(srv)

    (out, _, refs, _), teng = both(params, monkeypatch, scenario,
                                   impl="kernel", max_batch=2, kv_blocks=40,
                                   prefix_cache_size=8)
    assert refs == 3
    assert out == ref(params[0], SYSP + [40, 41], 8)


@pytest.mark.parametrize("case", ["prefilling", "unknown", "full", "long",
                                  "spent"])
def test_fork_refusals_match_the_reference(params, monkeypatch, case):
    def scenario(srv):
        if case == "prefilling":
            srv.submit([1, 2], 4)
            rid = srv.submit(list(range(1, 31)), 2)
            assert srv._prefilling
        elif case == "unknown":
            rid = 99
        elif case == "full":
            rid = srv.submit([1, 2], 8)
            srv.submit([3, 4], 8)
            srv.step()
        else:
            rid = srv.submit([1, 2], 8)
            srv.step()
        kw = {"long": dict(max_new_tokens=80),
              "spent": dict(max_new_tokens=1)}.get(case, {})
        # each engine raises its own package's error types
        with pytest.raises(Exception) as err:
            srv.fork(rid, **kw)
        srv.drain()
        return type(err.value).__name__, str(err.value)

    (name, msg), _ = both(params, monkeypatch, scenario, max_batch=2,
                          kv_blocks=24, prefill_chunk=8)
    assert name == {"prefilling": "ValueError", "unknown": "ValueError",
                    "full": "QueueFull", "long": "Infeasible",
                    "spent": "ValueError"}[case]


def test_fork_beyond_pool_capacity_is_infeasible(params):
    _, tp = params
    srv = DecodeServer(tp, TCFG, max_batch=2, kv_block_size=8, kv_blocks=4,
                       device="cpu")
    r0 = srv.submit([1, 2], 8)
    srv.step()
    with pytest.raises(Infeasible, match="KV blocks"):
        srv.fork(r0, max_new_tokens=40)
    assert srv.drain()[r0] == ref(params[0], [1, 2], 8)
    assert_pool_balanced(srv)


def test_stats_keys_equal_the_reference_with_features_on(params,
                                                         monkeypatch):
    """stats() and kv_stats() carry the reference's keys with the prefix
    cache and budgeted chunking on, mid-flight and drained."""
    jeng, teng = engines(params, monkeypatch, max_batch=2, kv_blocks=40,
                         prefix_cache_size=8, prefill_chunk=8,
                         prefill_budget=8)
    snaps = []
    for srv in (jeng, teng):
        srv.submit(SYSP + [33], 2, cache_prefix=True)
        srv.drain()
        srv.submit(SYSP + list(range(30, 45)), 3)
        mid = srv.stats()
        srv.drain()
        snaps.append((mid, srv.stats()))
    (jm, jd), (tm, td) = snaps
    for a, b in ((jm, tm), (jd, td)):
        assert set(b) == set(a)
        for key in ("prefill_sched", "prefix_cache", "prefix_index", "kv",
                    "pipeline", "pending"):
            assert set(b[key]) == set(a[key]), key
        assert set(b["kv"]["prefix"]) == set(a["kv"]["prefix"])
        assert b["prefix_cache"] == a["prefix_cache"]
        assert b["prefix_index"] == a["prefix_index"]
        assert b["kv"]["prefix"] == a["kv"]["prefix"]
        assert [s["prefilling"] for s in b["slots"]] == \
            [s["prefilling"] for s in a["slots"]]
