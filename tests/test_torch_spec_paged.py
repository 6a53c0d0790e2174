"""Port parity, the paged half of tests/test_spec_paged.py:
``SpeculativeDecodeServer`` on the paged arm (``kv_block_size`` 8) under
both of the port's formulations against the reference's, on the CPU,
f32, the tiny target and draft of tests/test_spec_serving.py, bridged
weights: copy-on-write forks and preemption by swap and by recompute
keep the draft cache coherent (greedy, sampled, and with draft = target
every window accepts what the reference's accepts), the draft's
recompute resume replays its committed tokens through the draft replay
program, the verify windows' tail blocks return to the pools, chunked
admissions reserve and release draft blocks, the int8 arenas, and the
kernel formulation against the gather formulation. The slot-static arm
and the rest of the engine are tests/test_torch_spec_serving.py's.
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
from nos_tpu_torch.models.kvblocks import blocks_for  # noqa: E402
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
SAMPLED = dict(temperature=0.9, top_k=8, seed=17)


# ---------------------------------------------------------------------------
# fork and preemption keep the draft coherent (paged)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth,steps", GRID)
@pytest.mark.parametrize("arm,impl", PAGED_ARMS, ids=PAGED_IDS)
def test_cow_fork_equals_plain(models, arm, impl, depth, steps):
    def run(eng):
        r0 = eng.submit([4, 5], 16)
        eng.step()
        f0 = eng.fork(r0)
        assert eng._alloc.shared_count() > 0
        assert eng._d_alloc.shared_count() == 0      # the draft copied
        res = eng.drain()
        assert_pools_balanced(eng)
        return res[r0], res[f0]

    got, want = both(models, arm, impl, run, depth=depth, steps=steps)
    assert got == want
    assert got[0][0] == got[0][1] == ref(models, [4, 5], 16)


@pytest.mark.parametrize("mode", ["swap", "recompute"])
@pytest.mark.parametrize("depth,steps", GRID)
@pytest.mark.parametrize("arm,impl", PAGED_ARMS, ids=PAGED_IDS)
def test_preempt_resume_equals_plain(models, arm, impl, depth, steps, mode):
    def run(eng):
        r0 = eng.submit([4, 5], 20)
        r1 = eng.submit([9, 8, 7], 8)
        for _ in range(2):
            eng.step()
        assert eng.preempt(r0, mode)
        assert eng.kv_stats()["preempts"][mode] >= 1
        res = eng.drain()
        assert_pools_balanced(eng)
        return res[r0], res[r1]

    got, want = both(models, arm, impl, run, depth=depth, steps=steps)
    assert got == want
    assert got[0] == (ref(models, [4, 5], 20), ref(models, [9, 8, 7], 8))


def self_draft(models, arm, impl, port, **kw):
    """A fresh engine drafting with the target itself: its acceptance
    counts are compared as the reference's test compares them, on an
    engine with no history (the reference's count differed on a reused
    engine)."""
    return make(models, arm, impl, port=port, self_draft=True, depth=2,
                mb=3, blocks=48, fresh=True, **kw)


@pytest.mark.parametrize("arm,impl", PAGED_ARMS, ids=PAGED_IDS)
def test_fork_keeps_draft_cache_coherent(models, arm, impl):
    """Draft = target: the fork's windows accept what the reference's
    accept (a garbage draft row would reject)."""
    out = []
    for port in (True, False):
        eng = self_draft(models, arm, impl, port)
        d0, a0 = counts(eng)
        r0 = eng.submit([4, 5], 14)
        for _ in range(2):
            eng.step()
        f0 = eng.fork(r0)
        res = eng.drain()
        assert_pools_balanced(eng)
        d1, a1 = counts(eng)
        out.append((res[r0], res[f0], d1 - d0, a1 - a0))
    assert out[0] == out[1]
    assert out[0][0] == out[0][1] == ref(models, [4, 5], 14)
    assert out[0][3] >= out[0][2] - 2 * 3      # at most the last windows


@pytest.mark.parametrize("mode", ["swap", "recompute"])
@pytest.mark.parametrize("arm,impl", PAGED_ARMS, ids=PAGED_IDS)
def test_preempt_keeps_draft_cache_coherent(models, arm, impl, mode):
    out = []
    for port in (True, False):
        eng = self_draft(models, arm, impl, port)
        d0, a0 = counts(eng)
        r0 = eng.submit([4, 5], 18)
        r1 = eng.submit([9, 8], 8)
        for _ in range(2):
            eng.step()
        assert eng.preempt(r0, mode)
        res = eng.drain()
        assert_pools_balanced(eng)
        d1, a1 = counts(eng)
        out.append((res[r0], res[r1], d1 - d0, a1 - a0))
    assert out[0] == out[1]
    assert out[0][:2] == (ref(models, [4, 5], 18), ref(models, [9, 8], 8))
    assert out[0][3] == out[0][2]               # every window accepted


@pytest.mark.parametrize("arm,impl", PAGED_ARMS, ids=PAGED_IDS)
def test_draft_pos_tracks_committed_across_fork_and_preempt(models, arm,
                                                            impl):
    eng = self_draft(models, arm, impl, True)
    r0 = eng.submit([4, 5], 16)
    r1 = eng.submit([9, 8], 12)
    for _ in range(2):
        eng.step()
    eng.fork(r0)
    eng.preempt(r1, "recompute")
    eng.step()
    eng._flush()
    for s, req in eng._active.items():
        want = len(req.prompt) + len(req.out) - 1
        assert int(eng.d_cache["pos"][s]) == want, (s, req.rid)
        assert int(eng.cache["pos"][s]) == want
    eng.drain()
    assert_pools_balanced(eng)


@pytest.mark.parametrize("mode", ["swap", "recompute"])
@pytest.mark.parametrize("depth,steps", [(1, 1), (2, 4)])
@pytest.mark.parametrize("arm,impl", PAGED_ARMS, ids=PAGED_IDS)
def test_sampled_stream_exact_across_preempt(models, arm, impl, depth,
                                             steps, mode):
    """A sampled row's draws read the draft's q: the preempted and
    resumed row must give the undisturbed row's tokens (and the
    reference engine's)."""
    kw = dict(temperature=0.8, top_k=8, seed=23)

    def run(eng):
        r = eng.submit([4, 5], 30, **kw)
        want = eng.drain()[r]
        r2 = eng.submit([4, 5], 30, **kw)
        eng.submit([9, 8, 7], 6)
        eng.step()
        assert eng.preempt(r2, mode)
        got = eng.drain()[r2]
        assert_pools_balanced(eng)
        return want, got

    got, want = both(models, arm, impl, run, depth=depth, steps=steps)
    assert got == want
    assert got[0][0] == got[0][1]


@pytest.mark.parametrize("self_draft", [False, True],
                         ids=["seeded-draft", "draft-is-target"])
def test_recompute_replays_the_draft_through_its_program(models,
                                                         self_draft):
    """Under the kernel formulation a recompute resume rewrites the
    committed output span of both caches with the bytes an undisturbed
    engine holds there: the draft's through the draft replay program, a
    committed token a step, the target's through the window replay
    program, a committed round a window (rounds of several tokens with
    draft = target)."""
    def snapshot(eng, rid):
        s = next(s for s, r in eng._active.items() if r.rid == rid)
        req = eng._active[s]
        n = len(req.prompt) + len(req.out) - 1
        planes = []
        for cache, tables in ((eng.d_cache, eng._d_tables),
                              (eng.cache, eng._tables)):
            for name in ("k", "v"):
                arena = cache[name]
                blocks = tables[s][:blocks_for(n, 8)]
                tl = arena[:, blocks].permute(0, 2, 1, 3, 4).reshape(
                    arena.shape[0], arena.shape[2], -1, arena.shape[-1])
                planes.append(tl[:, :, :n].clone())
        return n, planes, list(req.rounds)

    kw = dict(self_draft=self_draft, kv_swap=False)
    a = make(models, "paged", "kernel", port=True, fresh=True, **kw)
    b = make(models, "paged", "kernel", port=True, fresh=True, **kw)
    calls = {"dreplay": 0, "wreplay": 0}
    launch = b._launch_graph

    def count(key):
        if key in calls:
            calls[key] += 1
        return launch(key)

    b._launch_graph = count
    ra = a.submit([4, 5, 6], 20)
    rb = b.submit([4, 5, 6], 20)
    for _ in range(3):
        a.step()
        b.step()
    rounds = list(next(r for r in b._active.values() if r.rid == rb).rounds)
    assert b.preempt(rb, "recompute")
    b._admit()
    a._flush()
    na, pa, _ = snapshot(a, ra)
    nb, pb, _ = snapshot(b, rb)
    assert na == nb
    assert calls == {"dreplay": na - 3, "wreplay": len(rounds)}
    assert sum(c for _, c in rounds) == na - 3
    if self_draft:
        assert max(c for _, c in rounds) > 1
    for x, y in zip(pa, pb):
        assert torch.equal(x, y)
    assert b.replayed_windows == len(rounds)
    assert b.replayed_draft_tokens == na - 3
    a.drain()
    b.drain()


# ---------------------------------------------------------------------------
# the paged draft-block discipline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arm,impl", PAGED_ARMS, ids=PAGED_IDS)
def test_trim_spec_tails_returns_pools_to_balance(models, arm, impl):
    srv = make(models, arm, impl, port=True, blocks=24)
    srv.submit([4, 5], 16)
    for _ in range(3):
        srv.step()
        assert not srv._inflight
        for s, req in srv._active.items():
            need = blocks_for(len(req.prompt) + len(req.out) - 1, 8)
            assert len(srv._tables[s]) <= need
            assert len(srv._d_tables[s]) <= need
            for table, row in ((srv._tables[s], srv._table[s]),
                               (srv._d_tables[s], srv._d_table[s])):
                assert all(int(x) == 0 for x in row[len(table):])
    srv.drain()
    assert_pools_balanced(srv)


@pytest.mark.parametrize("arm,impl", PAGED_ARMS, ids=PAGED_IDS)
def test_chunked_admission_reserves_draft_blocks(models, arm, impl):
    long = list(range(1, 33))

    def run(eng):
        r0 = eng.submit(list(range(1, 8)), 20)
        r1 = eng.submit(long, 2)
        if eng._prefilling:
            rid = eng._prefilling[0]["req"].rid
            assert rid not in eng._chunked_dreserved \
                or eng._chunked_dreserved[rid]
        res = eng.drain()
        assert not eng._chunked_dreserved
        assert_pools_balanced(eng)
        return res[r0], res[r1]

    got, want = both(models, arm, impl, run, steps=4, blocks=12,
                     prefill_chunk=8, kv_swap=False)
    assert got == want
    assert got[0] == (ref(models, list(range(1, 8)), 20),
                      ref(models, long, 2))


@pytest.mark.parametrize("arm,impl", PAGED_ARMS, ids=PAGED_IDS)
def test_cancel_mid_prefill_releases_draft_reservation(models, arm, impl):
    srv = make(models, arm, impl, port=True, prefill_chunk=8)
    r0 = srv.submit([1, 2, 3], 6)
    r1 = srv.submit(list(range(1, 31)), 5)
    assert srv._prefilling and srv._chunked_dreserved.get(r1)
    used = srv._d_alloc.used_count
    assert srv.cancel(r1)
    assert r1 not in srv._chunked_dreserved
    assert srv._d_alloc.used_count < used
    res = srv.drain()
    assert res[r0] == ref(models, [1, 2, 3], 6)
    assert_pools_balanced(srv)


@pytest.mark.parametrize("depth,steps", [(1, 1), (2, 4)])
@pytest.mark.parametrize("arm,impl", PAGED_ARMS, ids=PAGED_IDS)
def test_int8_arena_equals_reference(models, arm, impl, depth, steps):
    """int8 KV in both arenas: the reference's tokens, and the (1, 1)
    run's at every knob setting."""
    def run(eng):
        rids = [eng.submit(p, n) for p, n in PROMPTS[:2]]
        rids.append(eng.submit([6, 2], 8, temperature=0.9, seed=4))
        res = eng.drain()
        assert_pools_balanced(eng)
        return [res[r] for r in rids]

    got, want = both(models, arm, impl, run, depth=depth, steps=steps,
                     kv_dtype="int8")
    assert got == want
    base, _ = both(models, arm, impl, run, kv_dtype="int8")
    assert got[0] == base[0]


# ---------------------------------------------------------------------------
# the kernel formulation against the gather formulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("depth,steps", [(1, 1), (2, 4)])
def test_kernel_formulation_equals_gather(models, depth, steps, kv_dtype):
    """``paged_impl`` "kernel" and "xla" commit the same tokens, greedy
    and sampled, with the same acceptance."""
    def run(eng):
        d0, a0 = counts(eng)
        rids = [eng.submit(p, n) for p, n in PROMPTS]
        rids.append(eng.submit([3, 4], 12, **SAMPLED))
        res = eng.drain()
        d1, a1 = counts(eng)
        return [res[r] for r in rids], d1 - d0, a1 - a0

    out = [run(make(models, "paged", impl, port=True, depth=depth,
                    steps=steps, kv_dtype=kv_dtype))
           for impl in ("kernel", "xla")]
    assert out[0] == out[1]




@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("impl", ["kernel", "xla"])
def test_verify_window_logits_match_reference(models, impl, kv_dtype):
    """The engine's verify window: ``forward_paged`` of an S = 3 window
    over two rows at their own pos (one mid-block, one across a block
    boundary) in a seeded arena; logits within rtol/atol 1e-5 of the
    reference's gather formulation, and the same arena bytes written
    (the int8 scales within 1e-5)."""
    import numpy as np

    from nos_tpu.models.generate import forward_paged as jforward_paged
    from nos_tpu.models.generate import init_paged_cache as jinit
    from nos_tpu_torch.models.generate import forward_paged, init_paged_cache

    jp, _, tp, _ = models
    rng = np.random.default_rng(7)
    jc = jinit(JT, 12, 8, 2, kv_dtype=kv_dtype)
    tc = init_paged_cache(TT, 12, 8, 2, kv_dtype=kv_dtype, device="cpu")
    for name in jc:
        if name == "pos":
            continue
        shape = jc[name].shape
        if jc[name].dtype == jnp.int8:
            vals = rng.integers(-127, 128, size=shape).astype(np.int8)
        else:
            vals = rng.standard_normal(shape).astype(np.float32)
            if name.endswith("_scale"):
                vals = np.abs(vals) * 0.01 + 1e-3
        jc[name] = jnp.asarray(vals)
        tc[name] = torch.from_numpy(vals.copy())
    pos = np.asarray([5, 13], np.int32)
    table = np.asarray([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    toks = rng.integers(0, 64, size=(2, 3))
    jc["pos"] = jnp.asarray(pos)
    tc["pos"] = torch.from_numpy(pos.copy())
    jl, jout = jforward_paged(jp, JT, jnp.asarray(toks, jnp.int32), jc,
                              jnp.asarray(table), paged_impl="xla")
    tl, tout = forward_paged(tp, TT, torch.tensor(toks), tc,
                             torch.from_numpy(table), paged_impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    for name in ("k", "v", "k_scale", "v_scale"):
        if name in tout:
            np.testing.assert_allclose(
                tout[name].float().numpy(),
                np.asarray(jout[name]).astype(np.float32),
                rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tout["pos"].numpy(),
                                  np.asarray(jout["pos"]))
