"""Port parity: the Mixture-of-Experts decoder served by the torch
engines against the reference's on the CPU, f32, the reference's tiny
config with 4 experts (vocab 64, d_model 16, 2 layers, 2/1 heads, d_ff
32), bridged weights.

Under MoE the call's S decides the routing: an expert's capacity is
``int(S * 2 * 1.25 / E)`` per row, and a bucket's pad tokens take their
top-1 slots before any real token's second choice. So an engine's tokens
equal the reference ENGINE's (the same buckets, chunks, windows), not
``generate``'s (ROADMAP C.16), and a verify window's drops make
speculative greedy differ from plain (C.17). Each scenario runs on the
reference engine (its gather formulation unless a test says otherwise)
and on the port (kernel and gather formulations), which must commit the
same tokens: the paged arena (model-dtype and int8 KV, f32 and int8
weights), the slot-static engine, sampling, chunked prefill, a prefix
hit, swap and recompute preemption, the speculative engine with draft =
target (its proposal and acceptance counts too), ``build_engine`` from
a YAML config and the generate binary.
"""
import os

import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.models import quant as jq  # noqa: E402
from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu.models.generate import generate as jgenerate  # noqa: E402
from nos_tpu.models.serving import DecodeServer as JDecodeServer  # noqa: E402
from nos_tpu.models.spec_serving import (  # noqa: E402
    SpeculativeDecodeServer as JSpec,
)
from nos_tpu_torch.cmd import generate as tgen  # noqa: E402
from nos_tpu_torch.cmd import server as tserver  # noqa: E402
from nos_tpu_torch.models import quant as tq  # noqa: E402
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402
from nos_tpu_torch.models.serving import DecodeServer  # noqa: E402
from nos_tpu_torch.models.spec_serving import (  # noqa: E402
    SpeculativeDecodeServer,
)
from nos_tpu_torch.ops.quant import QuantLinear  # noqa: E402

KW = dict(vocab=64, d_model=16, n_layers=2, n_heads=2, n_kv_heads=1,
          d_ff=32, max_seq=64, n_experts=4)
JCFG = jtfm.TransformerConfig(dtype=jnp.float32, **KW)
TCFG = ttfm.TransformerConfig(dtype=torch.float32, **KW)
# (arm, the port's formulation): the reference runs its gather
ARMS = [("static", None), ("paged", "kernel"), ("paged", "xla")]
ARM_IDS = ["static", "paged-kernel", "paged-xla"]
IMPLS = ["kernel", "xla"]
PAGED = dict(kv_blocks=24, kv_block_size=8)
# the probe's prompts, and a third that recycles a slot
PROMPTS = [([4, 5, 6], 12), ([9, 8, 7, 6, 5], 12), ([7] * 9, 6)]
SAMPLED = dict(temperature=0.8, top_k=8)
SYSP = list(range(1, 20))               # 19 tokens: 2 full blocks of 8


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, ttfm.params_from_jax(jp, "cpu")


@pytest.fixture(autouse=True, scope="module")
def _no_leaked_paged_switch():
    """Leave no ``NOS_TPU_PAGED_KERNEL`` behind for the worker's next
    module (ROADMAP C.5); this module's engines set it per test."""
    yield
    os.environ.pop("NOS_TPU_PAGED_KERNEL", None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side runs torch on one thread: its tiny models' ops
    are dominated by thread hand-off beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def pallas_compat(monkeypatch):
    """The reference's formulation switch (its gather oracle unless a
    test says otherwise) and the renamed ``pltpu.TPUCompilerParams``
    aliased, as every port test file does."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("NOS_TPU_PAGED_KERNEL", "0")
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)


# drained engines by their knobs, reused across the module's tests (a
# reference engine compiles its own programs)
_ENGINES: dict = {}


def engine(params, arm, impl, *, port, depth=1, steps=1, weights="f32",
           fresh=False, **kw):
    """One drained engine, the port's or the reference's, reused across
    tests with the same knobs unless ``fresh``; ``pipeline_depth`` is
    host state, set here."""
    key = (port, arm, impl if port else None, steps, weights,
           tuple(sorted(kw.items())))
    eng = None if fresh else _ENGINES.get(key)
    if eng is None:
        jp, tp = params
        if weights == "int8":
            jp, tp = jq.quantize_params(jp), tq.quantize_params(tp)
        knobs = dict(max_batch=2, decode_steps=steps, **kw)
        if arm == "paged":
            knobs = {**PAGED, **knobs}
        eng = (DecodeServer(tp, TCFG, device="cpu", paged_impl=impl,
                            **knobs) if port
               else JDecodeServer(jp, JCFG, **knobs))
        if not fresh:
            _ENGINES[key] = eng
    assert not eng.has_work(), "an earlier test left work behind"
    eng.pipeline_depth = depth
    return eng


def both(params, arm, impl, scenario, **kw):
    """(port's record, reference's record) of ``scenario(engine)``."""
    return (scenario(engine(params, arm, impl, port=True, **kw)),
            scenario(engine(params, arm, impl, port=False, **kw)))


def batch(eng, sampled=False):
    """The three prompts over two slots; with ``sampled`` each request
    sampled under its own seed."""
    rids = [eng.submit(p, n, **(dict(SAMPLED, seed=i) if sampled else {}))
            for i, (p, n) in enumerate(PROMPTS)]
    res = eng.drain()
    return [res[r] for r in rids]


def ref_generate(jp, prompt, n):
    out = jgenerate(jp, JCFG, jnp.asarray([prompt], jnp.int32), n)
    return [int(t) for t in out[0]]


def assert_pool_balanced(eng):
    assert not eng.has_work()
    if not eng.paged:
        return
    held = eng._pindex.block_count if eng._pindex is not None else 0
    assert eng._alloc.used_count == held, (eng._alloc.used_count, held)
    assert not eng._deferred
    assert all(not t for t in eng._tables)


# ---------------------------------------------------------------------------
# plain serving: both arenas, both weight types, both engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth,steps", [(1, 1), (2, 2)])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("impl", IMPLS)
def test_paged_greedy_equals_reference_engine(params, impl, kv_dtype, depth,
                                              steps):
    got, want = both(params, "paged", impl, batch, depth=depth,
                     steps=steps, kv_dtype=kv_dtype)
    assert got == want


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("impl", IMPLS)
def test_int8_weights_keep_experts_and_equal_reference(params, impl,
                                                       kv_dtype):
    """``quantize_params`` (experts unquantized, as the reference keeps
    them) on the paged engine, both arenas."""
    got, want = both(params, "paged", impl, batch, weights="int8",
                     kv_dtype=kv_dtype)
    assert got == want


@pytest.mark.parametrize("depth,steps", [(1, 1), (2, 2)])
def test_static_greedy_equals_reference_engine(params, depth, steps):
    got, want = both(params, "static", None, batch, depth=depth,
                     steps=steps)
    assert got == want


@pytest.mark.parametrize("arm,impl", ARMS, ids=ARM_IDS)
def test_sampled_equals_reference_engine(params, arm, impl):
    got, want = both(params, arm, impl, lambda e: batch(e, sampled=True))
    assert got == want


def test_engine_tokens_are_the_engines_not_generates(params):
    """The 5-token prompt prefills in an 8-token bucket (the smallest):
    its pad tokens' top-1 picks fill the capacity before real tokens'
    second choices, so the engines (the reference's and the port's,
    paged and slot-static) agree with each other and not with
    ``generate``, which runs the prompt unpadded (C.16)."""
    jp, _ = params
    prompt, n = PROMPTS[1]
    runs = [engine(params, arm, impl, port=port)
            for port in (False, True) for arm, impl in ARMS
            if port or impl != "xla"]
    outs = []
    for eng in runs:
        rid = eng.submit(prompt, n)
        outs.append(eng.drain()[rid])
    assert all(o == outs[0] for o in outs), outs
    assert outs[0] != ref_generate(jp, prompt, n)


# ---------------------------------------------------------------------------
# admission: chunks, a prefix hit
# ---------------------------------------------------------------------------

def chunked(eng):
    rids = [eng.submit(list(range(3, 25)), 6), eng.submit([4, 5, 6], 8),
            eng.submit(list(range(40, 51)), 5)]
    res = eng.drain()
    assert_pool_balanced(eng)
    return [res[r] for r in rids]


@pytest.mark.parametrize("arm,impl", ARMS, ids=ARM_IDS)
def test_chunked_prefill_equals_reference_engine(params, arm, impl):
    """``prefill_chunk`` 8: full chunks of S 8, the last padded to its
    own bucket, each routed over its own S, as the reference's."""
    got, want = both(params, arm, impl, chunked, prefill_chunk=8)
    assert got == want


def prefix_hits(eng):
    eng.submit(SYSP + [33], 2, cache_prefix=True)
    eng.drain()
    rids = [eng.submit(SYSP + s, 6) for s in ([40], [41, 42, 43])]
    res = eng.drain()
    assert eng.prefix_hits == 2, eng.prefix_hits
    assert_pool_balanced(eng)
    return [res[r] for r in rids]


@pytest.mark.parametrize("arm,impl", ARMS, ids=ARM_IDS)
def test_prefix_hit_equals_reference_engine(params, arm, impl):
    """A hit prefills its suffix as one window of its own bucket (S 1 or
    4 here), in the arena under the kernel, over a seeded scratch row
    under the gather, and the reference routes the same window."""
    got, want = both(params, arm, impl, prefix_hits, prefix_cache_size=4,
                     fresh=True)
    assert got == want


def test_prefix_hit_kernel_equals_reference_kernel_path(params,
                                                        monkeypatch):
    """The same against the reference's kernel path (Pallas interpret
    mode), whose hit also prefills its suffix in the arena."""
    monkeypatch.setenv("NOS_TPU_PAGED_KERNEL", "1")
    jp, tp = params
    jeng = JDecodeServer(jp, JCFG, max_batch=2, prefix_cache_size=4,
                         **PAGED)
    assert jeng.paged_kernel == "kernel"
    teng = DecodeServer(tp, TCFG, max_batch=2, prefix_cache_size=4,
                        device="cpu", paged_impl="kernel", **PAGED)
    assert prefix_hits(teng) == prefix_hits(jeng)


def test_prefix_hit_window_padded_past_its_blocks(monkeypatch):
    """A hit whose suffix (33 tokens) pads to a 64-token window that
    runs three blocks past the prompt's: the pads beyond write the null
    block three times a slot and attend to what is left there, and
    under MoE their top-1 picks take the real tokens' capacity. The
    port's kernel path against the reference's (Pallas interpret mode),
    twice, for the same tokens each time."""
    monkeypatch.setenv("NOS_TPU_PAGED_KERNEL", "1")
    kw = dict(KW, max_seq=128)
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **kw)
    tcfg = ttfm.TransformerConfig(dtype=torch.float32, **kw)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = ttfm.params_from_jax(jp, "cpu")
    system = [1 + i % 60 for i in range(64)]    # 8 full blocks of 8
    suffix = list(range(3, 36))         # 33 tokens: window 64, pads 24

    def scenario(eng):
        eng.submit(system + [40], 2, cache_prefix=True)
        eng.drain()
        outs = []
        for _ in range(2):
            rid = eng.submit(system + suffix, 6)
            outs.append(eng.drain()[rid])
        assert eng.prefix_hits == 2
        return outs

    knobs = dict(max_batch=2, prefix_cache_size=4, kv_blocks=40,
                 kv_block_size=8)
    jeng = JDecodeServer(jp, jcfg, **knobs)
    assert jeng.paged_kernel == "kernel"
    teng = DecodeServer(tp, tcfg, device="cpu", paged_impl="kernel",
                        **knobs)
    got = scenario(teng)
    assert teng.arena_windows == 2      # each hit ran the padded window
    assert got[0] == got[1]
    assert got == scenario(jeng)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

def preempt_run(srv, mode):
    """The reference's preempt-and-resume scenario: two requests, two
    ticks, preempt the first (it resumes at the front of the queue)."""
    r0 = srv.submit([4, 5, 6], 24)
    r1 = srv.submit([9, 8, 7, 6, 5], 8)
    for _ in range(2):
        srv.step()
    assert srv.preempt(r0, mode)
    res = srv.drain()
    assert_pool_balanced(srv)
    return [res[r0], res[r1]]


def undisturbed(srv):
    r0 = srv.submit([4, 5, 6], 24)
    r1 = srv.submit([9, 8, 7, 6, 5], 8)
    res = srv.drain()
    return [res[r0], res[r1]]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("impl", IMPLS)
def test_swap_preemption_equals_reference_and_undisturbed(params, impl,
                                                          kv_dtype):
    got, want = both(params, "paged", impl,
                     lambda e: preempt_run(e, "swap"), kv_dtype=kv_dtype)
    assert got == want
    assert got == undisturbed(engine(params, "paged", impl, port=True,
                                     kv_dtype=kv_dtype))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_recompute_preemption_by_formulation(params, kv_dtype):
    """Under the gather formulation the port re-prefills ``prompt +
    out[:-1]`` in its bucket, as the reference does: the reference's
    tokens. Under the kernel it re-prefills the prompt in its admission
    bucket and replays each committed token at S 1, the S each was
    first routed at: the undisturbed run's tokens, which the
    reference's longer re-prefill bucket need not give."""
    got, want = both(params, "paged", "xla",
                     lambda e: preempt_run(e, "recompute"),
                     kv_dtype=kv_dtype)
    assert got == want
    kern = preempt_run(engine(params, "paged", "kernel", port=True,
                              kv_dtype=kv_dtype), "recompute")
    assert kern == undisturbed(engine(params, "paged", "kernel", port=True,
                                      kv_dtype=kv_dtype))


# ---------------------------------------------------------------------------
# speculative decoding with an MoE target
# ---------------------------------------------------------------------------

def spec_engine(params, arm, impl, port):
    jp, tp = params
    knobs = dict(n_draft=3, max_batch=2)
    if arm == "paged":
        knobs.update(kv_blocks=40, kv_block_size=8)
    if port:
        return SpeculativeDecodeServer(tp, TCFG, tp, TCFG, device="cpu",
                                       paged_impl=impl, **knobs)
    return JSpec(jp, JCFG, jp, JCFG, **knobs)


def spec_record(eng, sampled=False):
    out = batch(eng, sampled)
    return out, eng.spec_drafted, eng.spec_accepted


@pytest.mark.parametrize("arm,impl", ARMS, ids=ARM_IDS)
def test_speculative_draft_equals_target_matches_reference(params, arm,
                                                           impl):
    """Draft = target, n_draft 3: the tokens and the proposal and
    acceptance counts are the reference's. The S = 4 verify window
    keeps 1 slot per expert and row, so it drops assignments the S = 1
    draft steps kept, and acceptance stays far under 1 (C.17)."""
    got = spec_record(spec_engine(params, arm, impl, port=True))
    want = spec_record(spec_engine(params, arm, impl, port=False))
    assert got == want
    _, drafted, accepted = got
    assert accepted < drafted // 2, (drafted, accepted)


@pytest.mark.parametrize("arm,impl", ARMS[:2], ids=ARM_IDS[:2])
def test_speculative_sampled_matches_reference(params, arm, impl):
    got = spec_record(spec_engine(params, arm, impl, port=True), True)
    want = spec_record(spec_engine(params, arm, impl, port=False), True)
    assert got == want


# ---------------------------------------------------------------------------
# the binaries
# ---------------------------------------------------------------------------

TINY_SERVER = ("vocab: 64\nd_model: 16\nn_layers: 2\nn_heads: 2\n"
               "n_kv_heads: 1\nd_ff: 32\nmax_seq: 64\nbf16: false\n"
               "max_batch: 2\nn_experts: 4\n")


@pytest.mark.parametrize("paged", [False, True])
def test_build_engine_takes_n_experts_from_yaml(params, tmp_path, paged):
    """``n_experts`` reaches the engine through ``--config``, as in the
    reference (``fields(cls)``): no refusal list blocks it, and the
    engine serves the MoE model it built."""
    from nos_tpu.cmd import server as jserver

    path = tmp_path / "server.yaml"
    path.write_text(TINY_SERVER + ("kv_blocks: 24\nkv_block_size: 8\n"
                                   if paged else ""))
    cfg = tserver.ServerConfig.from_yaml_file(str(path))
    assert cfg.n_experts == 4
    assert jserver.ServerConfig.from_yaml_file(str(path)).n_experts == 4
    eng = tserver.build_engine(cfg, device="cpu")
    assert eng.paged == paged
    layers = eng.params["layers"]
    assert tuple(layers["w_router"].shape) == (2, 16, 4)
    assert tuple(layers["w_gate"].shape) == (2, 4, 16, 32)
    # the reference engine on the same weights, bridged back
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), eng.params)
    knobs = dict(kv_blocks=24, kv_block_size=8) if paged else {}
    jeng = JDecodeServer(jp, JCFG, max_batch=2, **knobs)
    assert batch(eng) == batch(jeng)


def test_generate_binary_serves_moe(tmp_path):
    cfg = tgen.GenerateConfig(vocab=64, d_model=16, n_layers=2, n_heads=2,
                              n_kv_heads=1, d_ff=32, max_seq=64,
                              n_experts=4, bf16=False, max_new_tokens=5,
                              int8=True)
    out = tgen.run(cfg, [[1, 2, 3]], device="cpu")
    assert len(out) == 1 and len(out[0]) == 8
    model_cfg, params = tgen.load_params(cfg, "cpu")
    assert model_cfg.n_experts == 4
    assert not isinstance(params["layers"]["w_gate"], QuantLinear)
    assert isinstance(params["layers"]["wq"], QuantLinear)
