"""Port parity: ``SpeculativeDecodeServer`` against the reference's on the
CPU, f32, the tiny target and draft of tests/test_spec_serving.py and
tests/test_spec_paged.py, bridged weights, on both arms: slot-static and
paged (``kv_block_size`` 8), the paged arm under both formulations (the
kernel's plain version on the CPU, and the gather).

Each scenario runs on the reference engine (its gather formulation) and
on the port, which must commit the same tokens, greedy and sampled, and
count the same proposals and acceptances. Greedy tokens also equal plain
greedy decoding of the target. With draft = target every verify window
accepts what the reference's accepts, so a stale draft cache after a
fork or a preemption shows as a different count.
"""
import os

import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu.models.generate import generate as jgenerate  # noqa: E402
from nos_tpu.models.spec_serving import (  # noqa: E402
    SpeculativeDecodeServer as JSpec,
)
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402
from nos_tpu_torch.models.serving import QueueFull  # noqa: E402
from nos_tpu_torch.models.spec_serving import (  # noqa: E402
    SpeculativeDecodeServer,
)

TARGET = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
              d_ff=64, max_seq=64)
DRAFT = dict(vocab=64, d_model=16, n_layers=1, n_heads=2, n_kv_heads=1,
             d_ff=32, max_seq=64)
JT = jtfm.TransformerConfig(dtype=jnp.float32, **TARGET)
JD = jtfm.TransformerConfig(dtype=jnp.float32, **DRAFT)
TT = ttfm.TransformerConfig(dtype=torch.float32, **TARGET)
TD = ttfm.TransformerConfig(dtype=torch.float32, **DRAFT)
GRID = [(d, t) for d in (1, 2) for t in (1, 4)]
# (arm, the port's formulation): the reference runs its gather
ARMS = [("static", None), ("paged", "kernel"), ("paged", "xla")]
ARM_IDS = ["static", "paged-kernel", "paged-xla"]
PAGED_ARMS = ARMS[1:]
PAGED_IDS = ARM_IDS[1:]


@pytest.fixture(scope="module")
def models():
    jp = jtfm.init_params(jax.random.PRNGKey(0), JT)
    jd = jtfm.init_params(jax.random.PRNGKey(1), JD)
    return jp, jd, ttfm.params_from_jax(jp, "cpu"), \
        ttfm.params_from_jax(jd, "cpu")


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
    """The reference's formulation switch (its gather oracle) and the
    renamed ``pltpu.TPUCompilerParams`` aliased, as every port test file
    does."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("NOS_TPU_PAGED_KERNEL", "0")
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


# drained engines by their knobs, reused across the module's tests: a
# reference engine compiles its own programs, and building one per test
# made the module slow and, in one process, crashed XLA:CPU's compiler
# (the accumulated native state tests/conftest.py bounds per module)
_ENGINES: dict = {}


def make(models, arm, impl, *, port, self_draft=False, depth=1, steps=1,
         blocks=40, mb=2, n_draft=3, fresh=False, **kw):
    """One drained engine, the port's (``port``) or the reference's, on
    the arm, reused across tests with the same knobs unless ``fresh``;
    ``self_draft`` drafts with the target itself; ``pipeline_depth`` is
    host state, set here."""
    key = (port, arm, impl if port else None, self_draft, steps, blocks,
           mb, n_draft, tuple(sorted(kw.items())))
    eng = None if fresh else _ENGINES.get(key)
    if eng is None:
        eng = build(models, arm, impl, port, self_draft, steps, blocks, mb,
                    n_draft, **kw)
        if not fresh:
            _ENGINES[key] = eng
    assert not eng.has_work(), "an earlier test left work behind"
    eng.pipeline_depth = depth
    return eng


def build(models, arm, impl, port, self_draft, steps, blocks, mb, n_draft,
          **kw):
    jp, jd, tp, td = models
    if arm == "paged":
        kw.update(kv_block_size=8, kv_blocks=blocks)
    if port:
        p, c, dp, dc = (tp, TT, tp, TT) if self_draft else (tp, TT, td, TD)
        kw.update(device="cpu", paged_impl=impl)
        cls = SpeculativeDecodeServer
    else:
        p, c, dp, dc = (jp, JT, jp, JT) if self_draft else (jp, JT, jd, JD)
        cls = JSpec
    return cls(p, c, dp, dc, n_draft=n_draft, max_batch=mb,
               decode_steps=steps, **kw)


def counts(eng) -> tuple:
    """The engine's proposals and acceptances so far."""
    return eng.spec_drafted, eng.spec_accepted


# the reference's records by test (its id without the port's
# formulation: the reference runs its gather formulation under both)
_REFERENCE: dict = {}
_TEST = {"id": None}


@pytest.fixture(autouse=True)
def _test_id(request):
    _TEST["id"] = request.node.name.replace("paged-kernel", "paged") \
        .replace("paged-xla", "paged")
    yield
    _TEST["id"] = None


def both(models, arm, impl, scenario, **kw):
    """(port's record, reference's record) of ``scenario(engine)``, each
    with the engine's proposal and acceptance counts appended. The
    reference's record is made once per test and arm, whichever
    formulation the port runs."""
    def run(port):
        eng = make(models, arm, impl, port=port, **kw)
        d0, a0 = counts(eng)
        rec = scenario(eng)
        d1, a1 = counts(eng)
        return rec, d1 - d0, a1 - a0

    key = (_TEST["id"], arm, tuple(sorted(kw.items())))
    got = run(True)
    if key not in _REFERENCE:
        _REFERENCE[key] = run(False)
    return got, _REFERENCE[key]


def ref(models, prompt, n):
    jp = models[0]
    out = jgenerate(jp, JT, jnp.asarray([prompt], jnp.int32), n)
    return [int(t) for t in out[0]]


def assert_pools_balanced(srv):
    """Both pools quiescent: target blocks free or prefix-held, draft
    blocks all free, no deferred frees, every table empty."""
    assert not srv.has_work()
    if not srv.paged:
        return
    held = srv._pindex.block_count if srv._pindex is not None else 0
    assert srv._alloc.used_count == held, (srv._alloc.used_count, held)
    assert srv._d_alloc.used_count == 0, srv._d_alloc.used_count
    assert not srv._deferred and not srv._d_deferred
    assert all(not t for t in srv._tables)
    assert all(not t for t in srv._d_tables)


PROMPTS = [([4, 5], 10), ([9, 8, 7], 8), ([7, 7, 7, 7], 5)]


def greedy_batch(eng):
    rids = [eng.submit(p, n) for p, n in PROMPTS]
    res = eng.drain()
    assert_pools_balanced(eng)
    return [res[r] for r in rids]


# ---------------------------------------------------------------------------
# greedy: plain decoding's tokens at every (depth, T), both arms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth,steps", GRID)
@pytest.mark.parametrize("arm,impl", ARMS, ids=ARM_IDS)
def test_greedy_equals_plain_decoding(models, arm, impl, depth, steps):
    got, want = both(models, arm, impl, greedy_batch, depth=depth,
                     steps=steps)
    assert got == want
    for seq, (p, n) in zip(got[0], PROMPTS):
        assert seq == ref(models, p, n)


@pytest.mark.parametrize("arm,impl", ARMS, ids=ARM_IDS)
def test_slot_recycling_and_late_arrival(models, arm, impl):
    def run(eng):
        rids = {eng.submit([p], 6): [p] for p in (3, 1, 9)}
        res = eng.drain()
        out = [res[r] for r in rids]
        ra = eng.submit([4, 5], 12)
        eng.step()
        rb = eng.submit([7], 4)
        res = eng.drain()
        return out + [res[ra], res[rb]]

    got, want = both(models, arm, impl, run, mb=1)
    assert got == want
    assert got[0][3] == ref(models, [4, 5], 12)


@pytest.mark.parametrize("arm,impl", ARMS, ids=ARM_IDS)
def test_rows_advance_independently(models, arm, impl):
    """Rows commit their own acceptance, not the batch's least: a tick
    can emit more tokens than there are rows."""
    def run(eng):
        eng.submit([4, 5], 12)
        eng.submit([9], 12)
        total = ticks = 0
        while eng.has_work():
            total += eng.step()
            ticks += 1
        return total, ticks

    got, want = both(models, arm, impl, run)
    assert got == want
    total, ticks = got[0]
    assert total == 22 and ticks < 22


@pytest.mark.parametrize("arm,impl", ARMS, ids=ARM_IDS)
def test_stop_token_mid_round(models, arm, impl):
    full = ref(models, [4, 5], 12)
    stop = full[2 + 4]
    first_at = full.index(stop, 2)

    def run(eng):
        rid = eng.submit([4, 5], 12, stop_tokens=[stop])
        res = eng.drain()
        assert not eng._active and len(eng._free) == 2
        return res[rid]

    got, want = both(models, arm, impl, run)
    assert got == want
    assert got[0] == full[:first_at + 1]


# ---------------------------------------------------------------------------
# sampled rows
# ---------------------------------------------------------------------------

SAMPLED = dict(temperature=0.9, top_k=8, seed=17)


@pytest.mark.parametrize("arm,impl", ARMS, ids=ARM_IDS)
def test_sampled_rows_reproducible_and_batch_invariant(models, arm, impl):
    def run(eng):
        r1 = eng.submit([4, 5], 8, **SAMPLED)
        alone = eng.drain()[r1]
        r2 = eng.submit([4, 5], 8, **SAMPLED)
        r3 = eng.submit([9, 9], 8, temperature=1.2, seed=5)
        res = eng.drain()
        return alone, res[r2], res[r3]

    got, want = both(models, arm, impl, run)
    assert got == want
    alone, again, noisy = got[0]
    assert again == alone and len(noisy) == 2 + 8


def test_sampled_streams_invariant_to_knobs_and_arms(models):
    """The port's (1, 1) slot-static stream is every other (depth, T)
    and arm's, and the reference engine's at (1, 1) (the reference's
    own knob invariance is tests/test_spec_paged.py's)."""
    base = make(models, "static", None, port=True)
    r = base.submit([4, 5], 8, **SAMPLED)
    want = base.drain()[r]
    ref_eng = make(models, "static", None, port=False)
    r = ref_eng.submit([4, 5], 8, **SAMPLED)
    assert ref_eng.drain()[r] == want
    for depth, steps in [(2, 1), (1, 4), (2, 4)]:
        for arm, impl in ARMS:
            srv = make(models, arm, impl, port=True, depth=depth,
                       steps=steps)
            r1 = srv.submit([4, 5], 8, **SAMPLED)
            r2 = srv.submit([9, 9], 8, temperature=1.2, seed=5)
            res = srv.drain()
            assert res[r1] == want, (depth, steps, arm, impl)
            assert len(res[r2]) == 2 + 8


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("arm,impl", ARMS, ids=ARM_IDS)
def test_sampled_tokens_equal_reference(models, arm, impl, seed):
    """Mixed temperatures, top-k and top-p: the reference's tokens at
    the same seeds."""
    def run(eng):
        rids = [eng.submit([4, 5], 10, temperature=0.8, seed=seed),
                eng.submit([9, 8, 7], 9, temperature=1.1, top_p=0.9,
                           seed=seed + 7),
                eng.submit([3], 8, temperature=0.6, top_k=5,
                           seed=seed + 11)]
        res = eng.drain()
        return [res[r] for r in rids]

    got, want = both(models, arm, impl, run, depth=2)
    assert got == want


@pytest.mark.parametrize("arm,impl", ARMS, ids=ARM_IDS)
def test_mixed_greedy_and_sampled_batch(models, arm, impl):
    def run(eng):
        rg = eng.submit([4, 5], 8)
        rs = eng.submit([9], 8, temperature=0.8, seed=3)
        res = eng.drain()
        return res[rg], res[rs]

    got, want = both(models, arm, impl, run)
    assert got == want
    assert got[0][0] == ref(models, [4, 5], 8) and len(got[0][1]) == 9


# ---------------------------------------------------------------------------
# admission composes with speculation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arm,impl", ARMS, ids=ARM_IDS)
def test_prefix_cache_composes_with_spec(models, arm, impl):
    system = list(range(1, 20))

    def run(eng):
        hits, saved = eng.prefix_hits, eng.prefix_tokens_saved
        eng.submit(system + [33], 2, cache_prefix=True)
        eng.drain()
        rid = eng.submit(system + [40, 41], 6)
        res = eng.drain()
        return (res[rid], eng.prefix_hits - hits,
                eng.prefix_tokens_saved - saved)

    got, want = both(models, arm, impl, run, depth=2, prefix_cache_size=8)
    assert got == want
    assert got[0][1] == 1
    assert got[0][0] == ref(models, system + [40, 41], 6)


@pytest.mark.parametrize("arm,impl", ARMS, ids=ARM_IDS)
def test_chunked_prefill_composes_with_spec(models, arm, impl):
    long = list(range(1, 31))

    def run(eng):
        chunked = eng.prefill_chunk_tokens
        r0 = eng.submit([1, 2, 3], 8)
        for _ in range(2):
            eng.step()
        r1 = eng.submit(long, 5)
        res = eng.drain()
        assert_pools_balanced(eng)
        return res[r0], res[r1], eng.prefill_chunk_tokens - chunked

    got, want = both(models, arm, impl, run, depth=2, prefill_chunk=8)
    assert got == want
    assert got[0][1] == ref(models, long, 5)


@pytest.mark.parametrize("arm,impl", ARMS, ids=ARM_IDS)
def test_budgeted_chunked_prefill_composes_with_spec(models, arm, impl):
    long = list(range(1, 31))

    def run(eng):
        eng.prefill_tok_s_hint, eng.tick_s_hint = 1e-4, 1e-3
        r0 = eng.submit([1, 2, 3], 8)
        eng.step()
        r1 = eng.submit(long, 5, deadline_s=5.0)
        res = eng.drain()
        return (res[r0], res[r1], eng.prefill_chunk_tokens,
                eng.prefill_budget_spent)

    got, want = both(models, arm, impl, run, prefill_chunk=8,
                     prefill_budget=8, fresh=True)
    assert got == want


@pytest.mark.parametrize("arm,impl", ARMS, ids=ARM_IDS)
def test_recursive_admit_keeps_draft_cache_fresh(models, arm, impl):
    """C holds the slot; A finishes inside its own prefill and admits B
    recursively: B's draft row must be B's, not A's."""
    def run(eng):
        rc = eng.submit([2], 2)
        ra = eng.submit([4, 5], 1)
        rb = eng.submit([9, 8, 7], 4)
        while rb not in {r.rid for r in eng._active.values()}:
            eng.step()
        assert int(eng.d_cache["pos"][0]) == \
            3 + len(eng._active[0].out) - 1
        res = eng.drain()
        return [res[rc], res[ra], res[rb]]

    got, want = both(models, arm, impl, run, mb=1)
    assert got == want
    assert got[0][2] == ref(models, [9, 8, 7], 4)


# ---------------------------------------------------------------------------
# restart, stats, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arm,impl", ARMS, ids=ARM_IDS)
def test_capture_restore_resumes_undisturbed_tokens(models, arm, impl):
    """A supervised restart's path: capture after two ticks, restore
    into a fresh engine (the draft rebuilt for each committed
    sequence), the undisturbed tokens."""
    def traffic(eng):
        return [eng.submit([4, 5], 12), eng.submit([9, 8, 7], 10),
                eng.submit([1, 2], 9, temperature=0.8, seed=2)]

    def run(port):
        def fresh():
            return make(models, arm, impl, port=port, depth=2, fresh=True)

        eng = fresh()
        rids = traffic(eng)
        res = eng.drain()
        want = [res[r] for r in rids]
        eng = fresh()
        traffic(eng)
        for _ in range(2):
            eng.step()
        states = eng.capture_resumable()
        new = fresh()
        rids = [new.restore(st) for st in states]
        res = new.drain()
        assert_pools_balanced(new)
        return want, [res[r] for r in rids]

    got, want = run(True), run(False)
    assert got == want
    assert got[0] == got[1]


@pytest.mark.parametrize("arm,impl", ARMS, ids=ARM_IDS)
def test_stats_surface(models, arm, impl):
    def run(eng):
        rid = eng.submit([1, 2, 3], 6)
        eng.drain()
        eng.pop_result(rid)
        st = eng.stats()
        return st["speculative"], st["pipeline"], st["kv"] is None, \
            sorted(st)

    got, want = both(models, arm, impl, run, depth=2, fresh=True)
    assert got == want
    spec = got[0][0]
    assert spec["n_draft"] == 3 and spec["drafted"] > 0
    assert 0 <= spec["accepted"] <= spec["drafted"]
    if arm == "paged":
        dkv = spec["draft_kv"]
        assert dkv["blocks_total"] == dkv["blocks_free"] + \
            dkv["blocks_used"]


def test_window_events_parked_for_the_loop(models):
    srv = make(models, "paged", "kernel", port=True, depth=2)
    srv.submit([1, 2, 3], 6)
    srv.drain()
    assert srv.spec_window_events
    assert all(0 <= a <= 3 for a in srv.spec_window_events)


def test_vocab_mismatch_rejected(models):
    _, _, tp, td = models
    bad = ttfm.TransformerConfig(dtype=torch.float32,
                                 **{**DRAFT, "vocab": 32})
    with pytest.raises(ValueError, match="vocabulary"):
        SpeculativeDecodeServer(tp, TT, td, bad, device="cpu")


def test_prefill_role_refused_like_reference(models):
    jp, jd, tp, td = models
    with pytest.raises(ValueError) as want:
        JSpec(jp, JT, jd, JD, kv_block_size=8, kv_blocks=24,
              role="prefill")
    with pytest.raises(ValueError) as got:
        SpeculativeDecodeServer(tp, TT, td, TD, kv_block_size=8,
                                kv_blocks=24, role="prefill", device="cpu")
    assert str(got.value) == str(want.value)


def test_static_headroom_guard_matches_reference(models):
    """The slot-static engine reserves the in-flight windows' writes
    below max_len; the paged engine does not need to."""
    window = 2 * 1 * 3
    plen = 64 - 4 - window + 1
    prompt = list(range(1, plen + 1))
    msgs = []
    for port in (True, False):
        srv = make(models, "static", None, port=port, depth=2, mb=1)
        with pytest.raises(ValueError, match="draft window") as err:
            srv.submit(prompt, 4)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    for arm, impl in PAGED_ARMS:
        srv = make(models, arm, impl, port=True, depth=2, mb=1, blocks=24)
        rid = srv.submit(prompt, 4)
        assert srv.drain()[rid] == ref(models, prompt, 4)
        assert_pools_balanced(srv)


def test_fork_requires_paging(models):
    srv = make(models, "static", None, port=True)
    srv.submit([1, 2], 4)
    with pytest.raises(RuntimeError, match="paged"):
        srv.fork(0)
    srv.drain()


def test_fork_sheds_without_draft_blocks(models):
    """A fork whose draft copy cannot fit sheds with QueueFull before
    the base fork commits anything."""
    srv = make(models, "paged", "kernel", port=True, blocks=10, mb=3,
               fresh=True)
    r0 = srv.submit(list(range(1, 30)), 4)
    srv.step()
    srv._d_alloc.alloc_many(srv._d_alloc.free_count)
    with pytest.raises(QueueFull, match="draft"):
        srv.fork(r0)
    assert len(srv._active) == 1
