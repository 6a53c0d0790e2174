"""Port parity: preemption in the torch ``DecodeServer`` against the JAX
engine (CPU, f32, the tiny config of tests/test_serving_paged.py,
bridged weights).

Twins of tests/test_serving_paged.py:115 (preempt and resume, swap and
recompute, over the {1,2}x{1,4} grid), :229, :253, :357,
tests/test_kv_int8.py:102-115 and tests/test_paged_kernel.py:365-385:
each scenario runs on the reference engine (its gather formulation, the
oracle it designates) and on the port (kernel and gather formulations),
which must commit the same tokens, which must equal the undisturbed
run's, and leave a balanced pool. Under the kernel formulation a
recompute resume replays the committed tokens through the paged kernel
at the tick's width; its rewritten K/V bytes are held against an
undisturbed engine's.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu.models.generate import generate as jgenerate  # noqa: E402
from nos_tpu.models.serving import DecodeServer as JDecodeServer  # noqa: E402
from nos_tpu_torch.cmd import server as tserver  # noqa: E402
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402
from nos_tpu_torch.models.serving import DecodeServer  # noqa: E402
from nos_tpu_torch.ops.attention import paged_gather_kv  # noqa: E402

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=64, max_seq=64)
JCFG = jtfm.TransformerConfig(dtype=jnp.float32, **KW)
TCFG = ttfm.TransformerConfig(dtype=torch.float32, **KW)
GRID = [(d, t) for d in (1, 2) for t in (1, 4)]
ARENAS = ["bf16", "int8"]       # "bf16" is the model-dtype arena, f32 here
IMPLS = ["kernel", "xla"]


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, ttfm.params_from_jax(jp, "cpu")


@pytest.fixture(autouse=True)
def pallas_compat(monkeypatch):
    """The reference engine's formulation switch (its gather oracle),
    and the renamed ``pltpu.TPUCompilerParams`` aliased, as every port
    test file does."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("NOS_TPU_PAGED_KERNEL", "0")
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


def _cache(make):
    cache = {}

    def at(depth=1, steps=1, **kw):
        key = (steps, tuple(sorted(kw.items())))
        eng = cache.get(key)
        if eng is None:
            eng = cache[key] = make(steps, **kw)
        assert not eng.has_work(), "previous test left work behind"
        eng.pipeline_depth = depth
        return eng

    return at


@pytest.fixture(scope="module")
def jengines(params):
    """Drained reference engines by (T, knobs); depth is host state."""
    jp, _ = params
    return _cache(lambda steps, **kw: JDecodeServer(
        jp, JCFG, max_batch=2, decode_steps=steps, kv_block_size=8,
        **{"kv_blocks": 24, **kw}))


@pytest.fixture(scope="module")
def tengines(params):
    """Drained port engines by (T, knobs); depth is host state."""
    _, tp = params
    return _cache(lambda steps, **kw: DecodeServer(
        tp, TCFG, max_batch=2, decode_steps=steps, kv_block_size=8,
        device="cpu", **{"kv_blocks": 24, "paged_impl": "kernel", **kw}))


def ref(jp, prompt, n):
    out = jgenerate(jp, JCFG, jnp.asarray([prompt], jnp.int32), n)
    return [int(t) for t in out[0]]


def assert_pool_balanced(eng):
    assert not eng.has_work()
    held = eng._pindex.block_count if eng._pindex is not None else 0
    assert eng._alloc.used_count == held, (eng._alloc.used_count, held)
    assert not eng._deferred
    assert all(not t for t in eng._tables)


def preempt_run(srv, mode, sampled=False):
    """The reference's preempt-and-resume scenario: two requests, two
    ticks, preempt the first (it resumes at the front of the queue)."""
    kw = dict(temperature=0.8, top_k=8, seed=3) if sampled else {}
    before = dict(srv.kv_stats()["preempts"])
    r0 = srv.submit([4, 5], 24, **kw)
    r1 = srv.submit([9, 8, 7], 8)
    for _ in range(2):
        srv.step()
    assert srv.preempt(r0, mode)
    assert srv._pending and srv._pending[0].rid == r0
    assert srv.kv_stats()["swapped_pending"] == (mode == "swap")
    res = srv.drain()
    after = srv.kv_stats()["preempts"]
    return [res[r0], res[r1]], {m: after[m] - before[m] for m in after}


def undisturbed(srv, sampled=False):
    kw = dict(temperature=0.8, top_k=8, seed=3) if sampled else {}
    r0 = srv.submit([4, 5], 24, **kw)
    r1 = srv.submit([9, 8, 7], 8)
    res = srv.drain()
    return [res[r0], res[r1]]


# ---------------------------------------------------------------------------
# preempt and resume over the grid (tests/test_serving_paged.py:115)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kv_dtype", ARENAS)
@pytest.mark.parametrize("depth,steps", GRID)
@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_preempt_resume_bit_exact_across_grid(params, jengines, tengines,
                                              mode, depth, steps, kv_dtype,
                                              impl):
    jeng = jengines(depth, steps, kv_dtype=kv_dtype)
    teng = tengines(depth, steps, kv_dtype=kv_dtype, paged_impl=impl)
    want, jpre = preempt_run(jeng, mode)
    got, tpre = preempt_run(teng, mode)
    assert got == want, (mode, depth, steps, kv_dtype, impl)
    assert tpre == jpre
    # the undisturbed run's tokens (the reference's own generate on the
    # model-dtype arena; the undisturbed reference engine under int8)
    if kv_dtype == "bf16":
        assert want == [ref(params[0], [4, 5], 24),
                        ref(params[0], [9, 8, 7], 8)]
    else:
        assert want == undisturbed(jeng)
    assert_pool_balanced(jeng)
    assert_pool_balanced(teng)


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_sampled_stream_survives_preemption(jengines, tengines, mode):
    """A sampled token is keyed by (seed, position): preempting and
    resuming the request changes nothing in its stream."""
    jeng = jengines(2, 1)
    teng = tengines(2, 1)
    want, _ = preempt_run(jeng, mode, sampled=True)
    got, _ = preempt_run(teng, mode, sampled=True)
    assert got == want == undisturbed(teng, sampled=True)
    assert_pool_balanced(teng)


# ---------------------------------------------------------------------------
# victim order and priority (tests/test_serving_paged.py:229, :253)
# ---------------------------------------------------------------------------

def pressure(srv):
    """Three growing requests over a 7-block pool at depth 2: the engine
    preempts to make progress, the priority-5 request never."""
    protected = srv.submit([1, 2], 20, priority=5)
    rids = [srv.submit([i + 3, i + 4], 20) for i in range(2)]
    res = srv.drain()
    return [res[protected]] + [res[r] for r in rids], \
        srv.kv_stats()["preempts"]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("kv_swap", [True, False], ids=["swap", "recompute"])
def test_pressure_preempts_lowest_priority_youngest(params, impl, kv_swap):
    jp, tp = params
    kw = dict(max_batch=3, kv_block_size=8, kv_blocks=7, pipeline_depth=2,
              kv_swap=kv_swap)
    want, jpre = pressure(JDecodeServer(jp, JCFG, **kw))
    srv = DecodeServer(tp, TCFG, device="cpu", paged_impl=impl, **kw)
    got, tpre = pressure(srv)
    assert got == want and tpre == jpre
    mode = "swap" if kv_swap else "recompute"
    assert tpre[mode] > 0
    assert got == [ref(jp, [1, 2], 20)] + [ref(jp, [i + 3, i + 4], 20)
                                           for i in range(2)]
    assert_pool_balanced(srv)


@pytest.mark.parametrize("impl", IMPLS)
def test_priority_protects_from_preemption(params, jengines, tengines, impl):
    def scenario(srv):
        hi = srv.submit([1, 2], 6, priority=10)
        lo = srv.submit([3, 4], 6, priority=0)
        srv.step()
        assert srv._preempt_victim()
        assert [r.rid for r in srv._pending] == [lo]
        assert srv._pending[0].preempted
        assert hi in {r.rid for r in srv._active.values()}
        res = srv.drain()
        return res[hi], res[lo]

    jeng = jengines(1, 1, kv_blocks=10)
    teng = tengines(1, 1, kv_blocks=10, paged_impl=impl)
    assert scenario(teng) == scenario(jeng) == (
        ref(params[0], [1, 2], 6), ref(params[0], [3, 4], 6))
    assert_pool_balanced(teng)


def test_youngest_of_equal_priority_is_the_victim(tengines, jengines):
    def scenario(srv):
        old = srv.submit([1, 2], 10)
        young = srv.submit([3, 4], 10)
        srv.step()
        assert srv._preempt_victim()
        victim = srv._pending[0].rid
        srv.drain()
        return victim == young and victim != old

    assert scenario(tengines(1, 1)) and scenario(jengines(1, 1))


@pytest.mark.parametrize("kv_swap", [True, False], ids=["swap", "recompute"])
def test_sole_decoder_preempted_when_prefill_reservation_squeezes(
        params, kv_swap):
    """The reference's :357 in both resume modes: the sole decoder
    yields to a chunked admission's reservation instead of raising."""
    jp, tp = params
    long = list(range(1, 49))
    kw = dict(max_batch=2, kv_block_size=8, kv_blocks=10, prefill_chunk=8,
              decode_steps=4, kv_swap=kv_swap)

    def scenario(srv):
        r0 = srv.submit(list(range(1, 8)), 20)
        r1 = srv.submit(long, 2)
        assert srv._prefilling
        res = srv.drain()
        return res[r0], res[r1], srv.kv_stats()["preempts"]

    want = scenario(JDecodeServer(jp, JCFG, **kw))
    srv = DecodeServer(tp, TCFG, device="cpu", paged_impl="kernel", **kw)
    got = scenario(srv)
    assert got == want
    assert got[:2] == (ref(jp, list(range(1, 8)), 20), ref(jp, long, 2))
    assert got[2]["swap" if kv_swap else "recompute"] >= 1
    assert_pool_balanced(srv)


def test_sole_decoder_with_nothing_to_reclaim_raises(params):
    """Step 4 of the relief order: one decoder, no chain, no chunked
    reservation: the pool is sized below one request, and the engine
    raises the reference's sizing error."""
    from nos_tpu_torch.models.kvblocks import NoFreeBlocks

    _, tp = params
    srv = DecodeServer(tp, TCFG, max_batch=1, kv_block_size=8, kv_blocks=8,
                       device="cpu")
    srv._alloc.alloc_many(4)            # leave the request short
    srv.submit([1, 2, 3], 30)
    with pytest.raises(NoFreeBlocks, match="nothing left to reclaim"):
        srv.drain()


# ---------------------------------------------------------------------------
# the swap payload (tests/test_kv_int8.py:102-115)
# ---------------------------------------------------------------------------

def _preempted_payload(srv):
    r0 = srv.submit([4, 5], 20)
    srv.submit([9, 8, 7], 8)
    for _ in range(2):
        srv.step()
    assert srv.preempt(r0, "swap")
    st = next(r for r in srv._pending if r.rid == r0).swap_state
    payload = {k: (np.asarray(v).copy() if k != "nblk" else v)
               for k, v in st.items()}
    srv.drain()
    return payload


@pytest.mark.parametrize("kv_dtype", ARENAS)
def test_swap_payload_is_the_references(jengines, tengines, kv_dtype):
    """Keys, shapes ``[L, nblk, Hkv, bs, D]`` / ``[L, nblk, Hkv, bs]``,
    dtype names and values of the payload equal the reference's: the
    int8 planes carry their f32 scales (within one quantization step of
    each other's rounding), the f32 planes within 1e-5."""
    want = _preempted_payload(jengines(1, 1, kv_dtype=kv_dtype))
    got = _preempted_payload(tengines(1, 1, kv_dtype=kv_dtype))
    assert sorted(got) == sorted(want)
    assert got["nblk"] == want["nblk"] == 1
    for key in [k for k in want if k != "nblk"]:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == want[key].dtype, key
    if kv_dtype == "int8":
        assert got["k"].dtype == np.int8 and got["k_scale"].dtype == np.float32
        for key in ("k", "v"):
            diff = np.abs(got[key].astype(int) - want[key].astype(int))
            assert diff.max() <= 1, key
        for key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-7)
    else:
        for key in ("k", "v"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-5)


# ---------------------------------------------------------------------------
# the kernel formulation's replay (tests/test_paged_kernel.py:365-385)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prompt,ticks", [([4, 5], 4),
                                          ([1, 2, 3, 4, 5, 6], 6)],
                         ids=["same-bucket", "crossing"])
@pytest.mark.parametrize("kv_dtype", ARENAS)
def test_recompute_replay_rewrites_the_ticks_bytes(params, kv_dtype, prompt,
                                                   ticks):
    """After a recompute preempt-and-resume under the kernel formulation
    the row's K/V over every written position (int8: planes and scales)
    is byte-identical to an undisturbed engine's: the prompt alone is
    re-prefilled, in the bucket its admission used (also where prompt +
    committed tokens has grown past it: 6 + 6 tokens against the
    prompt's 8), and each committed output token is replayed at the
    tick's width, one step a token."""
    _, tp = params

    def engine():
        return DecodeServer(tp, TCFG, max_batch=2, kv_block_size=8,
                            kv_blocks=40, device="cpu", paged_impl="kernel",
                            kv_dtype=kv_dtype)

    a, b = engine(), engine()
    ra, rb = a.submit(prompt, ticks + 6), b.submit(prompt, ticks + 6)
    for _ in range(ticks):
        a.step()
        b.step()
    assert b.preempt(rb, "recompute")
    b.step()            # nothing decodes; step_finish re-admits: resume
    qa = next(r for r in a._active.values() if r.rid == ra)
    qb = next(r for r in b._active.values() if r.rid == rb)
    assert qa.out == qb.out
    assert b.replayed_tokens == ticks   # the committed tokens but the last
    written = len(qb.prompt) + len(qb.out) - 1

    def timeline(eng, q, plane):
        arena = eng.cache[plane][0]
        if plane.endswith("_scale"):        # [NB, Hkv, bs] -> [.., 1]
            arena = arena[..., None]
        table = eng._table[q.slot:q.slot + 1]
        return paged_gather_kv(arena, table)[:, :, :written]

    planes = ("k", "v") + (("k_scale", "v_scale") if kv_dtype == "int8"
                           else ())
    for plane in planes:
        assert torch.equal(timeline(a, qa, plane), timeline(b, qb, plane)), \
            (kv_dtype, plane)
    a.drain()
    b.drain()


HEAD = [7] * 16                 # two full blocks, published
ADMISSIONS = {
    # (prompt, engine knobs, the resume path that repeats its admission)
    "prefix-hit": (HEAD + [3, 4, 5], dict(prefix_cache_size=8), "window"),
    "chunked": (list(range(1, 28)), dict(prefill_chunk=8), "chunked"),
    "chunked-hit": (HEAD + list(range(30, 49)),
                    dict(prefix_cache_size=8, prefill_chunk=8), "chunked"),
}


def _admitted(srv, prompt, n):
    """Publish the shared head (when the engine caches prefixes), then
    submit ``prompt`` and run its admission to its first decode tick."""
    if srv._prefix_max:
        srv.submit(HEAD + [1], 2, cache_prefix=True)
        srv.drain()
    rid = srv.submit(prompt, n)
    while any(e["req"].rid == rid for e in srv._prefilling) \
            or not any(r.rid == rid for r in srv._active.values()):
        srv.step()
    return rid


@pytest.mark.parametrize("admission", list(ADMISSIONS))
@pytest.mark.parametrize("kv_dtype", ARENAS)
def test_recompute_repeats_the_admissions_path(params, admission, kv_dtype):
    """ROADMAP C.12: a recompute victim admitted through a prefix hit
    (the in-arena S > 1 window over the shared head) or in chunks (with
    or without a shared head) resumes by the same path: its K/V over
    every written position (int8: planes and scales) is byte-identical
    to an undisturbed twin's, and its tokens are the undisturbed run's
    and the reference engine's for the same preemption."""
    jp, tp = params
    prompt, knobs, path = ADMISSIONS[admission]
    n = 14

    def engine():
        return DecodeServer(tp, TCFG, max_batch=2, kv_block_size=8,
                            kv_blocks=40, device="cpu", paged_impl="kernel",
                            kv_dtype=kv_dtype, **knobs)

    a, b = engine(), engine()
    ra, rb = _admitted(a, prompt, n), _admitted(b, prompt, n)
    qb = next(r for r in b._active.values() if r.rid == rb)
    assert qb.admission is not None and qb.admission[0] == path
    for _ in range(4):
        a.step()
        b.step()
    assert b.preempt(rb, "recompute")
    b.step()            # step_finish re-admits: the resume
    assert b.resume_paths == {**dict.fromkeys(b.resume_paths, 0), path: 1}
    qa = next(r for r in a._active.values() if r.rid == ra)
    qb = next(r for r in b._active.values() if r.rid == rb)
    assert qa.out == qb.out
    written = len(qb.prompt) + len(qb.out) - 1

    def timeline(eng, q, plane):
        arena = eng.cache[plane][0]
        if plane.endswith("_scale"):
            arena = arena[..., None]
        return paged_gather_kv(arena, eng._table[q.slot:q.slot + 1])[
            :, :, :written]

    planes = ("k", "v") + (("k_scale", "v_scale") if kv_dtype == "int8"
                           else ())
    for plane in planes:
        assert torch.equal(timeline(a, qa, plane), timeline(b, qb, plane)), \
            (admission, kv_dtype, plane)
    got, want = b.drain()[rb], a.drain()[ra]
    assert got == want
    # the reference engine, preempted at the same tick, resumes to the
    # same tokens (its own re-prefill, on the gather formulation)
    jeng = JDecodeServer(jp, JCFG, max_batch=2, kv_block_size=8,
                         kv_blocks=40, kv_dtype=kv_dtype, **knobs)
    jr = _admitted(jeng, prompt, n)
    for _ in range(4):
        jeng.step()
    assert jeng.preempt(jr, "recompute")
    assert jeng.drain()[jr] == got
    if kv_dtype == "bf16":      # f32 here: the reference's generate too
        assert got == ref(jp, prompt, n)
    assert_pool_balanced(b)


def test_recompute_falls_back_when_the_head_is_gone(params):
    """A prefix-hit victim whose shared head the index evicted while it
    waited resumes by the one-shot re-prefill (counted ``fallback``)
    and still finishes with the reference's tokens; with a host tier the
    demoted head is promoted back and the window repeats."""
    from nos_tpu_torch.kvfabric import HostTierStore

    jp, tp = params
    prompt, knobs, _ = ADMISSIONS["prefix-hit"]
    for host, path in ((None, "fallback"),
                       (HostTierStore(1 << 20), "window")):
        srv = DecodeServer(tp, TCFG, max_batch=2, kv_block_size=8,
                           kv_blocks=40, device="cpu", paged_impl="kernel",
                           host_tier=host, **knobs)
        rid = _admitted(srv, prompt, 12)
        srv.step()
        assert srv.preempt(rid, "recompute")
        srv._pindex.evict_lru(srv._alloc.capacity)
        assert not srv._pindex.chain_items()
        srv.step()
        assert srv.resume_paths[path] == 1
        assert srv.drain()[rid] == ref(jp, prompt, 12)
        assert_pool_balanced(srv)


def test_recompute_replay_runs_the_ticks_width(params, monkeypatch):
    """Each replayed token is one ``forward_paged`` over all ``max_batch``
    rows (S = 1), the resumed row's table live at its slot, every other
    row on the null block."""
    from nos_tpu_torch.models import serving as tserving

    _, tp = params
    srv = DecodeServer(tp, TCFG, max_batch=2, kv_block_size=8, kv_blocks=24,
                       device="cpu", paged_impl="kernel")
    r0 = srv.submit([4, 5], 12)
    for _ in range(3):
        srv.step()
    assert srv.preempt(r0, "recompute")
    calls = []
    real = tserving.forward_paged

    def spy(p, cfg, toks, cache, table, **kw):
        if cache["pos"] is srv._rpos:
            live = [int(r.ne(0).any()) for r in table]
            calls.append((tuple(toks.shape), live))
        return real(p, cfg, toks, cache, table, **kw)

    monkeypatch.setattr(tserving, "forward_paged", spy)
    srv._admit()
    slot = next(s for s, r in srv._active.items() if r.rid == r0)
    assert len(calls) == 3
    assert all(shape == (2, 1) for shape, _ in calls)
    assert all(live == [int(i == slot) for i in range(2)]
               for _, live in calls)
    assert not srv._rtable.any() and not srv._rpos.any()
    monkeypatch.setattr(tserving, "forward_paged", real)
    srv.drain()


@pytest.mark.parametrize("impl", IMPLS)
def test_recompute_reprefill_sequence_by_formulation(params, monkeypatch,
                                                     impl):
    """What a recompute resume re-prefills: under the kernel formulation
    the prompt alone, padded to the bucket its admission used (the
    committed tokens are replayed), also once prompt + committed tokens
    has outgrown that bucket; under the gather formulation the
    reference's ``prompt + out[:-1]`` in its own bucket."""
    from nos_tpu_torch.models import serving as tserving

    _, tp = params
    srv = DecodeServer(tp, TCFG, max_batch=2, kv_block_size=8, kv_blocks=24,
                       device="cpu", paged_impl=impl)
    prompt = [1, 2, 3, 4, 5, 6]
    r0 = srv.submit(prompt, 16)
    for _ in range(6):
        srv.step()
    assert srv.preempt(r0, "recompute")
    out = list(srv._pending[0].out)
    rows = []
    real = tserving.forward_with_cache

    def spy(p, cfg, toks, row):
        rows.append(toks[0].tolist())
        return real(p, cfg, toks, row)

    monkeypatch.setattr(tserving, "forward_with_cache", spy)
    srv._admit()
    monkeypatch.setattr(tserving, "forward_with_cache", real)
    want = (prompt + [0, 0] if impl == "kernel"
            else prompt + out[:-1] + [0] * (16 - len(prompt) - len(out) + 1))
    assert rows == [want]
    assert srv.replayed_tokens == (len(out) - 1 if impl == "kernel" else 0)
    srv.drain()
    assert_pool_balanced(srv)


# ---------------------------------------------------------------------------
# preempt()'s answers, cancel of a preempted request, the stats surface
# ---------------------------------------------------------------------------

def test_preempt_return_values_are_the_references(jengines, tengines):
    def scenario(srv):
        out = []
        r0 = srv.submit([1, 2], 2)          # finishes within the flush
        r1 = srv.submit([4, 5], 16)
        out.append(srv.preempt(999))                    # unknown
        srv.step()
        out.append(srv.preempt(r0))                     # done meanwhile
        with pytest.raises(ValueError, match="swap|recompute"):
            srv.preempt(r1, "drop")
        out.append(srv.preempt(r1, "recompute"))
        out.append(srv.preempt(r1))                     # pending now
        out.append(srv.kv_stats()["swapped_pending"])
        res = srv.drain()
        out.append(res[r1])
        return out

    got = scenario(tengines(4, 1))
    assert got == scenario(jengines(4, 1))
    assert got[:4] == [False, False, True, False]


def test_preempt_refuses_a_prefilling_request(params):
    _, tp = params
    srv = DecodeServer(tp, TCFG, max_batch=2, kv_block_size=8, kv_blocks=24,
                       prefill_chunk=8, device="cpu")
    srv.submit([1, 2, 3], 6)
    r1 = srv.submit(list(range(1, 31)), 4)
    assert srv._prefilling
    assert srv.preempt(r1) is False
    srv.drain()
    assert_pool_balanced(srv)


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_cancel_of_a_preempted_pending_request(jengines, tengines, mode):
    def scenario(srv):
        r0 = srv.submit([4, 5], 20)
        r1 = srv.submit([9, 8, 7], 6)
        srv.step()
        assert srv.preempt(r0, mode)
        partial = srv.progress(r0)
        assert srv.cancel(r0)
        res = srv.drain()
        return partial, res[r0], res[r1], srv.kv_stats()["swapped_pending"]

    got = scenario(tengines(1, 1))
    assert got == scenario(jengines(1, 1))
    assert got[0][1] is False and got[1] == [4, 5] + got[0][0]
    assert_pool_balanced(tengines(1, 1))


def test_stats_surface_after_preemption_is_the_references(jengines,
                                                          tengines):
    def scenario(srv):
        r0 = srv.submit([4, 5], 20)
        srv.submit([9, 8, 7], 6)
        srv.step()
        srv.preempt(r0, "swap")
        kv = srv.kv_stats()
        st = srv.stats()
        surface = ({k: kv[k] for k in ("preempts", "swapped_pending",
                                       "blocks_used", "blocks_free")},
                   st["pending"]["depth"], len(st["slots"]),
                   st["slots"][0]["tokens_out"])
        srv.drain()
        return surface

    assert scenario(tengines(1, 1)) == scenario(jengines(1, 1))


@pytest.mark.parametrize("kv_swap", [True, False], ids=["swap", "recompute"])
def test_build_engine_serves_kv_swap(kv_swap):
    """``kv_swap`` reaches the engine as the reference's build_engine
    passes it, and picks the resume mode of pressure preemption."""
    cfg = tserver.ServerConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                               n_kv_heads=2, d_ff=64, max_seq=64, bf16=False,
                               max_batch=3, kv_block_size=8, kv_blocks=7,
                               kv_swap=kv_swap)
    eng = tserver.build_engine(cfg, device="cpu")
    assert eng.kv_swap is kv_swap
    for i in range(3):
        eng.submit([i + 1, i + 2], 20)
    eng.drain()
    pre = eng.kv_stats()["preempts"]
    assert pre["swap" if kv_swap else "recompute"] > 0
    assert pre["recompute" if kv_swap else "swap"] == 0


@pytest.mark.parametrize("kv_swap", [True, False], ids=["swap", "recompute"])
def test_loop_counts_preemptions_by_mode(params, kv_swap):
    """The serving loop mirrors the engine's preemptions into
    ``nos_tpu_serve_preempt_total{mode}``, and every request still
    answers with the reference's tokens. The ticker's first device wait
    is held until all three requests are in, so they grow together over
    a pool that cannot hold them."""
    import threading

    from nos_tpu_torch.cmd.server import ServingLoop
    from nos_tpu_torch.utils.metrics import default_registry

    class Parked(DecodeServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.in_wait = threading.Event()
            self.go = threading.Event()

        def step_wait(self, ent):
            if ent is not None and not self.go.is_set():
                self.in_wait.set()
                assert self.go.wait(timeout=60)
            super().step_wait(ent)

    jp, tp = params
    eng = Parked(tp, TCFG, max_batch=3, kv_block_size=8, kv_blocks=7,
                 pipeline_depth=2, kv_swap=kv_swap, device="cpu",
                 paged_impl="kernel")
    mode = "swap" if kv_swap else "recompute"
    counter = default_registry().counter(
        "nos_tpu_serve_preempt_total", "", ("mode",))
    before = counter.value(mode)
    loop = ServingLoop(eng)
    prompts = [[1, 2], [3, 4], [4, 5]]
    try:
        streams = [loop.stream(prompts[0], 20)]
        assert eng.in_wait.wait(timeout=60)     # ticker parked, unlocked
        streams += [loop.stream(p, 20) for p in prompts[1:]]
        eng.go.set()
        outs = []
        for p, st in zip(prompts, streams):
            toks = list(p)
            for delta in st:
                toks.extend(delta)
            outs.append(toks)
        assert outs == [ref(jp, p, 20) for p in prompts]
        assert eng.kv_stats()["preempts"][mode] > 0
        assert counter.value(mode) - before == \
            eng.kv_stats()["preempts"][mode]
        assert loop.stats()["kv"]["preempts"] == eng.kv_stats()["preempts"]
    finally:
        eng.go.set()
        loop.shutdown()
