"""Port parity: the slot-static ``DecodeServer`` (``kv_blocks=0``, the
reference's default) against the reference's on the CPU, f32, the tiny
config of tests/test_serving.py, bridged weights.

Each scenario runs on the reference engine and on the port, which must
commit the same tokens (greedy and sampled, at every (pipeline_depth,
decode_steps) of the grid), keep the same prefix-cache LRU, chunk and
budget prefill alike, resume a captured request through
``_resume_recompute_static`` with the undisturbed tokens, and refuse what
the reference's slot-static engine refuses with its messages. The
forward under the engine, ``forward_with_cache`` with a per-row ``pos``,
is held to the reference's within rtol/atol 1e-5, including a row whose
write would run past the cache (the reference clamps its start).
"""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu.models.generate import (  # noqa: E402
    forward_with_cache as jforward_with_cache, generate as jgenerate,
)
from nos_tpu.models.serving import DecodeServer as JDecodeServer  # noqa: E402
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402
from nos_tpu_torch.models.generate import (  # noqa: E402
    forward_with_cache, generate,
)
from nos_tpu_torch.models.serving import DecodeServer  # noqa: E402

KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
          d_ff=64, max_seq=64)
JCFG = jtfm.TransformerConfig(dtype=jnp.float32, **KW)
TCFG = ttfm.TransformerConfig(dtype=torch.float32, **KW)
GRID = [(1, 1), (2, 1), (1, 3), (2, 2)]
TOL = dict(rtol=1e-5, atol=1e-5)
SAMPLED = dict(temperature=0.8, top_k=8, seed=3)


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, ttfm.params_from_jax(jp, "cpu")


@pytest.fixture(autouse=True, scope="module")
def _no_leaked_paged_switch():
    """Leave no ``NOS_TPU_PAGED_KERNEL`` behind for the worker's next
    module: the reference's ``build_engine`` writes it into os.environ
    (ROADMAP C.5), and a reference engine built under it later takes the
    Pallas kernel path, which fails on this JAX (the renamed
    ``TPUCompilerParams``). This module's own engines set it per test."""
    yield
    os.environ.pop("NOS_TPU_PAGED_KERNEL", None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs torch on one thread in this module: its
    tiny models' ops are dominated by thread hand-off, which made the
    module several times slower beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def pallas_compat(monkeypatch):
    """The reference's formulation switch and the renamed
    ``pltpu.TPUCompilerParams`` aliased, as every port test file does
    (its slot-static engine reads neither, its paged code paths do)."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("NOS_TPU_PAGED_KERNEL", "0")
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


@pytest.fixture(autouse=True)
def _bound_live_xla_programs_per_test():
    """Drop the reference engines' compiled programs after every test:
    each engine compiles its own, and their accumulated native state
    has crashed XLA:CPU's compiler within one module
    (tests/conftest.py bounds it per module)."""
    yield
    import gc

    jax.clear_caches()
    gc.collect()


def engines(params, **kw):
    """(reference engine, port engine) on the same weights and knobs."""
    jp, tp = params
    return (JDecodeServer(jp, JCFG, **kw),
            DecodeServer(tp, TCFG, device="cpu", **kw))


def both(params, scenario, **kw):
    """``scenario(engine)`` on the reference engine and on the port."""
    j, t = engines(params, **kw)
    return scenario(j), scenario(t)


def ref(jp, prompt, n):
    out = jgenerate(jp, JCFG, jnp.asarray([prompt], jnp.int32), n)
    return [int(t) for t in out[0]]


PROMPTS = [([4, 5], 10), ([9, 8, 7], 8), ([7, 7, 7, 7], 5),
           (list(range(1, 20)), 6)]


def batch(eng, sampled=False):
    """Four requests over two slots: slot recycling, a stop token, and
    with ``sampled`` every other request sampled."""
    rids = []
    for i, (p, n) in enumerate(PROMPTS):
        kw = dict(SAMPLED, seed=i) if sampled and i % 2 else {}
        rids.append(eng.submit(p, n, **kw))
    rids.append(eng.submit([3, 1, 4], 12, stop_tokens=[5]))
    res = eng.drain()
    return [res[r] for r in rids]


# ---------------------------------------------------------------------------
# forward_with_cache: the per-row write the static tick runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,pos", [
    (1, [3, 10, 40]),          # a vector pos, one token
    (4, [0, 61, 62]),          # rows whose window runs past max_len
    (1, [64, 63, 5]),          # a frozen row at max_len
    (3, None),                 # a scalar pos
])
def test_forward_with_cache_matches_reference(params, s, pos):
    """Logits within rtol/atol 1e-5 and the cache written where the
    reference writes it: a row's start clamps to max_len - S, while its
    rope rows and causal mask take the unclamped positions."""
    jp, tp = params
    rng = np.random.default_rng(s)
    toks = rng.integers(0, 64, size=(3, s))
    kv = rng.standard_normal((2, 3, 2, 64, 8)).astype(np.float32)
    jpos = (jnp.asarray(pos, jnp.int32) if pos is not None
            else jnp.int32(20))
    tpos = (torch.tensor(pos, dtype=torch.int32) if pos is not None
            else torch.tensor(20, dtype=torch.int32))
    jl, jc = jforward_with_cache(
        jp, JCFG, jnp.asarray(toks, jnp.int32),
        {"k": jnp.asarray(kv), "v": jnp.asarray(kv * 0.5), "pos": jpos})
    tl, tc = forward_with_cache(
        tp, TCFG, torch.tensor(toks),
        {"k": torch.tensor(kv), "v": torch.tensor(kv * 0.5), "pos": tpos})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


# ---------------------------------------------------------------------------
# tokens across the grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("depth,steps", GRID)
def test_tokens_equal_reference(params, depth, steps, sampled):
    """Greedy and sampled requests over recycled slots commit the
    reference's tokens at every (depth, T); greedy ones equal
    ``generate``."""
    jp, _ = params
    got, want = both(params, lambda e: batch(e, sampled), max_batch=2,
                     pipeline_depth=depth, decode_steps=steps)
    assert got == want
    for i, (p, n) in enumerate(PROMPTS):
        if not (sampled and i % 2):
            assert got[i] == ref(jp, p, n)


def test_engine_equals_port_generate(params):
    """The engine's greedy tokens equal the port's own ``generate``."""
    _, tp = params
    eng = DecodeServer(tp, TCFG, max_batch=2, device="cpu")
    out = batch(eng)
    for seq, (p, n) in zip(out, PROMPTS):
        want = generate(tp, TCFG, [p], n, device="cpu")[0].tolist()
        assert seq == want


def test_cache_rows_match_reference_after_admission(params):
    """After two admissions and three ticks, the slot rows' K/V within
    rtol/atol 1e-5 of the reference's and the pos rows equal."""
    def run(eng):
        eng.submit([4, 5, 6], 10)
        eng.submit(list(range(1, 12)), 10)
        for _ in range(3):
            eng.step()
        eng._flush()
        cache = {k: np.array(v) for k, v in eng.cache.items()}
        eng.drain()
        return cache

    j, t = both(params, run, max_batch=2)
    np.testing.assert_array_equal(t["pos"], j["pos"])
    for name in ("k", "v"):
        for s, p in enumerate(t["pos"]):
            np.testing.assert_allclose(t[name][:, s, :, :p],
                                       j[name][:, s, :, :p], **TOL)


@pytest.mark.parametrize("depth,steps", [(2, 2), (1, 3)])
def test_frozen_row_at_max_len_does_not_raise(params, depth, steps):
    """A request that fills the cache: the ticks that overrun its end
    (pipelined or fused) write at a frozen pos at max_len, which the
    reference clamps; the port must too, and commit the same tokens."""
    def run(eng):
        r0 = eng.submit([4, 5, 6, 7, 8, 9], 10)     # 6 + 10 = max_len 16
        r1 = eng.submit([2, 3], 5)
        res = eng.drain()
        return [res[r0], res[r1]]

    got, want = both(params, run, max_batch=2, max_len=16,
                     pipeline_depth=depth, decode_steps=steps)
    assert got == want


def test_stats_surface_matches_reference(params):
    def run(eng):
        eng.submit([4, 5], 4)
        eng.drain()
        st = eng.stats()
        return (sorted(st), st["kv"], st["prefix_index"],
                st["prefix_cache"], st["pipeline"], eng.kv_stats(),
                eng.paged, eng.kv_block_size, eng.kv_dtype)

    got, want = both(params, run, max_batch=2, pipeline_depth=2)
    assert got == want
    assert got[1] is None and got[6] is False


# ---------------------------------------------------------------------------
# the prefix cache's LRU
# ---------------------------------------------------------------------------

def prefix_run(eng):
    """Three system prompts published into a two-entry cache (the first
    evicted), then hits on the survivors and on a refreshed one."""
    out = []
    sys_a, sys_b, sys_c = (list(range(1, 18)), list(range(20, 37)),
                           list(range(40, 57)))
    for system in (sys_a, sys_b):
        eng.submit(system + [5], 2, cache_prefix=True)
        out.append(list(eng.drain().values()))
    r = eng.submit(sys_a + [6, 7], 4)          # hit: a becomes newest
    out.append(eng.drain()[r])
    eng.submit(sys_c + [5], 2, cache_prefix=True)    # evicts b
    out.append(list(eng.drain().values()))
    rb = eng.submit(sys_b + [9], 3)            # miss: b was evicted
    ra = eng.submit(sys_a + [8], 3)            # hit
    res = eng.drain()
    out.append([res[rb], res[ra]])
    keys = [(scope, len(toks), toks[0]) for scope, toks in eng._prefixes]
    return out, keys, eng.prefix_hits, eng.prefix_tokens_saved, \
        eng.stats()["prefix_cache"]


@pytest.mark.parametrize("depth,steps", [(1, 1), (2, 2)])
def test_prefix_lru_hits_savings_and_eviction_order(params, depth, steps):
    jp, _ = params
    got, want = both(params, prefix_run, max_batch=2, prefix_cache_size=2,
                     pipeline_depth=depth, decode_steps=steps)
    assert got == want
    out, keys, hits, saved, section = got
    assert [k[2] for k in keys] == [40, 1]      # b evicted, a refreshed
    assert hits == 2 and saved == 2 * 17
    assert section["entries"] == 2 and section["capacity"] == 2
    assert out[2] == ref(jp, list(range(1, 18)) + [6, 7], 4)


# ---------------------------------------------------------------------------
# chunked and budgeted prefill
# ---------------------------------------------------------------------------

class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


def chunk_run(eng):
    r0 = eng.submit([1, 2, 3], 8)
    for _ in range(2):
        eng.step()
    long = list(range(1, 31))
    r1 = eng.submit(long, 5, deadline_s=5.0)
    r2 = eng.submit(list(range(2, 21)), 4)
    res = eng.drain()
    sched = eng.stats()["prefill_sched"]
    return ([res[r0], res[r1], res[r2]],
            {k: sched[k] for k in ("budget", "chunk_tokens",
                                   "budget_spent_tokens", "clamped_ticks",
                                   "overrides", "backlog_tokens")})


@pytest.mark.parametrize("budget", [0, 8])
@pytest.mark.parametrize("depth,steps", [(1, 1), (2, 2)])
def test_chunked_and_budgeted_prefill(params, depth, steps, budget):
    jp, _ = params
    j, t = engines(params, max_batch=2, prefill_chunk=8,
                   prefill_budget=budget, pipeline_depth=depth,
                   decode_steps=steps, slack_clock=Clock())
    for eng in (j, t):
        eng.prefill_tok_s_hint = 1e-4
        eng.tick_s_hint = 1e-3
    got, want = chunk_run(t), chunk_run(j)
    assert got == want
    assert got[0][1] == ref(jp, list(range(1, 31)), 5)
    assert got[1]["chunk_tokens"] > 0


def test_chunked_prefill_reuses_a_cached_prefix(params):
    def run(eng):
        system = list(range(1, 25))
        eng.submit(system + [3], 2, cache_prefix=True)
        eng.drain()
        r = eng.submit(system + list(range(30, 50)), 4)
        return eng.drain()[r], eng.prefix_hits, eng.prefix_tokens_saved

    got, want = both(params, run, max_batch=2, prefix_cache_size=2,
                     prefill_chunk=8)
    assert got == want and got[1] == 1


# ---------------------------------------------------------------------------
# capture and restore (the supervised restart's path)
# ---------------------------------------------------------------------------

def restart_run(make, sampled):
    """Undisturbed tokens, then the same traffic captured after three
    ticks and restored into a fresh engine (``_resume_recompute_static``
    re-prefills each committed sequence)."""
    kw = SAMPLED if sampled else {}
    eng = make()
    want = [eng.submit(p, n, **kw) for p, n in PROMPTS]
    res = eng.drain()
    want = [res[r] for r in want]
    eng = make()
    for p, n in PROMPTS:
        eng.submit(p, n, **kw)
    for _ in range(3):
        eng.step()
    states = eng.capture_resumable()
    fresh = make()
    rids = [fresh.restore(st) for st in states]
    res = fresh.drain()
    return want, [res[r] for r in rids], [len(st["out"]) for st in states]


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("depth,steps", [(1, 1), (2, 2)])
def test_capture_restore_resumes_undisturbed_tokens(params, depth, steps,
                                                    sampled):
    jp, tp = params
    kw = dict(max_batch=2, pipeline_depth=depth, decode_steps=steps)
    want_j, got_j, outs_j = restart_run(
        lambda: JDecodeServer(jp, JCFG, **kw), sampled)
    want_t, got_t, outs_t = restart_run(
        lambda: DecodeServer(tp, TCFG, device="cpu", **kw), sampled)
    assert got_t == want_t
    assert (want_t, got_t, outs_t) == (want_j, got_j, outs_j)
    assert any(0 < n for n in outs_t)       # some resumed mid-stream


def test_capture_carries_no_swap_payload(params):
    """A slot-static engine captures tokens only (no paged payload)."""
    def run(eng):
        eng.submit([4, 5], 10)
        eng.step()
        states = eng.capture_resumable()
        eng.drain()
        return [sorted(st) for st in states]

    got, want = both(params, run, max_batch=2, kv_swap=True)
    assert got == want
    assert all("swap" not in keys for keys in got)


# ---------------------------------------------------------------------------
# refusals, with the reference's messages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(kv_dtype="int8"), dict(role="prefill"), dict(role="decode"),
], ids=["int8", "role-prefill", "role-decode"])
def test_build_refusals_match_reference(params, kw):
    jp, tp = params
    with pytest.raises(ValueError) as want:
        JDecodeServer(jp, JCFG, max_batch=2, **kw)
    with pytest.raises(ValueError) as got:
        DecodeServer(tp, TCFG, max_batch=2, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_host_tier_refused_like_reference(params):
    from nos_tpu.kvfabric import HostTierStore as JHostTierStore
    from nos_tpu_torch.kvfabric import HostTierStore

    jp, tp = params
    with pytest.raises(ValueError) as want:
        JDecodeServer(jp, JCFG, max_batch=2, prefix_cache_size=2,
                      host_tier=JHostTierStore(1 << 20))
    with pytest.raises(ValueError) as got:
        DecodeServer(tp, TCFG, max_batch=2, prefix_cache_size=2,
                     host_tier=HostTierStore(1 << 20), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("op", ["fork", "preempt"])
def test_fork_and_preempt_refused_like_reference(params, op):
    def run(eng):
        rid = eng.submit([1, 2], 4)
        with pytest.raises(RuntimeError) as err:
            getattr(eng, op)(rid)
        eng.drain()
        return str(err.value)

    got, want = both(params, run, max_batch=2)
    assert got == want and "paged" in got
