"""Port parity: the speculative engine and the MoE family served under
tensor parallelism (``SpeculativeDecodeServer(mesh=)``, the split MoE
FFN ``ops/moe.py::moe_ffn_tp``, ``transformer.shard_params`` on the MoE
family, ``build_engine``'s ``tp`` with a draft or ``n_experts``) against
the port's single-device engines and the reference's mesh engines
(tests/test_serving_sharded.py) on the CPU.

The target, the draft and the requests (greedy and sampled rows mixed,
prompts crossing block boundaries) are tests/test_serving_sharded.py's;
the MoE model is its target with 4 experts. The port's engines on two
CPU shards (``TpMesh(["cpu", "cpu"])``) on bridged weights give the
tokens of the port's tp = 1 engines and of the reference's engines on
its 4 x 2 CPU mesh (the gather formulation), through a fork, a
preemption in each mode and a decode-role speculative engine adopting a
handoff; the split MoE FFN is the unsplit one's within 1e-5 (f32) with
the same routing, bit for bit.
"""
import contextlib
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from nos_tpu.cmd import server as jserver  # noqa: E402
from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu.models.serving import DecodeServer as JDecodeServer  # noqa: E402
from nos_tpu.models.spec_serving import (  # noqa: E402
    SpeculativeDecodeServer as JSpec,
)
from nos_tpu_torch.cmd.generate import GenerateConfig  # noqa: E402
from nos_tpu_torch.cmd.server import (  # noqa: E402
    ServerConfig, ServingLoop, build_engine,
)
from nos_tpu_torch.models import handoff as thandoff  # noqa: E402
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402
from nos_tpu_torch.models.quant import quantize_params  # noqa: E402
from nos_tpu_torch.models.serving import DecodeServer  # noqa: E402
from nos_tpu_torch.models.spec_serving import (  # noqa: E402
    SpeculativeDecodeServer,
)
from nos_tpu_torch.ops import moe  # noqa: E402
from nos_tpu_torch.ops.quant import QuantLinear  # noqa: E402
from nos_tpu_torch.parallel.mesh import HeadShards, TpMesh  # noqa: E402
from nos_tpu_torch.train.checkpoint import (  # noqa: E402
    CheckpointManager, model_arch_dict,
)

MODEL = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq=64)
DRAFT = dict(vocab=64, d_model=16, n_layers=1, n_heads=2, n_kv_heads=2,
             d_ff=32, max_seq=64)
MOE = dict(MODEL, n_experts=4)
JCFG = jtfm.TransformerConfig(**MODEL, dtype=jnp.float32)
JDCFG = jtfm.TransformerConfig(**DRAFT, dtype=jnp.float32)
JMCFG = jtfm.TransformerConfig(**MOE, dtype=jnp.float32)
TCFG = ttfm.TransformerConfig(**MODEL, dtype=torch.float32)
TDCFG = ttfm.TransformerConfig(**DRAFT, dtype=torch.float32)
TMCFG = ttfm.TransformerConfig(**MOE, dtype=torch.float32)
REQS = [
    ([3, 1, 4, 1, 5], 8, dict()),
    ([2, 7], 10, dict(temperature=0.7, top_k=8, seed=3)),
    ([9, 9, 1, 2, 6, 6, 1, 8, 3], 6, dict(temperature=0.5, top_p=0.8,
                                          seed=11)),
]
PAGED = dict(max_batch=2, max_len=64, kv_block_size=8, kv_blocks=24)
STATIC = dict(max_batch=2, max_len=64)
CPU2 = ["cpu", "cpu"]
FFN_TOL = 1e-5
# tests/test_serving_sharded.py's (k, T, kv_dtype) grid; the reference
# mesh engine runs its two tier-1 corners, the port every corner
SPEC_GRID = [(k, t, kv) for k in (1, 2) for t in (1, 4)
             for kv in ("bf16", "int8")]
REF_CORNERS = {(1, 4, "int8"), (2, 4, "bf16")}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    # the reference's build_engine leaks its kernel switch into the
    # environment of later test files in this worker
    os.environ.pop("NOS_TPU_PAGED_KERNEL", None)


@contextlib.contextmanager
def gather_oracle():
    """The reference engine's gather formulation while one is built, and
    the renamed ``pltpu.TPUCompilerParams`` aliased, as every port test
    file does."""
    from jax.experimental.pallas import tpu as pltpu

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NOS_TPU_PAGED_KERNEL", "0")
        if not hasattr(pltpu, "TPUCompilerParams"):
            mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                       raising=False)
        yield


@pytest.fixture(scope="module")
def models():
    """(reference params, the port's) for the target, the draft and the
    MoE model."""
    out = {}
    for name, cfg, seed in (("target", JCFG, 0), ("draft", JDCFG, 9),
                            ("moe", JMCFG, 2)):
        jp = jtfm.init_params(jax.random.PRNGKey(seed), cfg)
        out[name] = (jp, ttfm.params_from_jax(jp, "cpu"))
    return out


@pytest.fixture(scope="module")
def jmesh():
    devs = np.asarray(jax.devices()[:8]).reshape(4, 2)
    return Mesh(devs, ("dp", "tp"))


def run_trace(eng, reqs=REQS):
    rids = [eng.submit(p, n, **kw) for p, n, kw in reqs]
    out = eng.drain()
    return [out[r] for r in rids]


def spec(models, tp=2, **kw):
    """The port's speculative engine on ``tp`` CPU shards (one device at
    tp 1), the kernel formulation on a paged arm."""
    mesh = TpMesh(["cpu"] * tp) if tp > 1 else None
    if "kv_blocks" in kw:
        kw.setdefault("paged_impl", "kernel")
    return SpeculativeDecodeServer(
        models["target"][1], TCFG, models["draft"][1], TDCFG, device="cpu",
        mesh=mesh, **kw)


def moe_engine(models, tp=2, params=None, **kw):
    mesh = TpMesh(["cpu"] * tp) if tp > 1 else None
    if "kv_blocks" in kw:
        kw.setdefault("paged_impl", "kernel")
    return DecodeServer(models["moe"][1] if params is None else params,
                        TMCFG, device="cpu", mesh=mesh, **kw)


def assert_split(plane, tp=2):
    """``plane`` lives split along its head axis, ``tp`` equal parts."""
    assert isinstance(plane, HeadShards)
    assert len({p.shape[2] for p in plane.parts}) == 1
    assert len(plane.parts) == tp


# ---------------------------------------------------------------------------
# the speculative engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,T,kv_dtype", SPEC_GRID)
def test_spec_engine_tokens_invariant_to_tp(models, jmesh, k, T, kv_dtype):
    """The speculative engine on two shards == the port's tp = 1 engine
    over the (k, T, kv_dtype) grid, greedy and seeded-sampled rows
    mixed, and == the reference's engine on its mesh at its tier-1
    corners; both arenas (and int8's scale planes) live split along the
    head axis, in lockstep."""
    kw = dict(PAGED, kv_dtype=kv_dtype, n_draft=k, decode_steps=T)
    eng = spec(models, **kw)
    got = run_trace(eng)
    assert got == run_trace(spec(models, tp=1, **kw))
    names = ("k", "v", "k_scale", "v_scale") if kv_dtype == "int8" \
        else ("k", "v")
    for name in names:
        assert_split(eng.cache[name])
        assert_split(eng.d_cache[name])
    assert eng.d_cache["k"].parts[0].shape[2] == DRAFT["n_kv_heads"] // 2
    assert isinstance(eng.draft_params, ttfm.TpParams)
    assert eng.capture_programs() == {} and eng._d_scratch is None
    if (k, T, kv_dtype) in REF_CORNERS:
        (jp, _), (jd, _) = models["target"], models["draft"]
        with gather_oracle():
            ref = JSpec(jax.device_put(jp, jtfm.param_shardings(jmesh, JCFG)),
                        JCFG,
                        jax.device_put(jd, jtfm.param_shardings(jmesh,
                                                                JDCFG)),
                        JDCFG, mesh=jmesh, **kw)
        assert got == run_trace(ref)


def test_slot_static_spec_engine_invariant_to_tp(models):
    """The slot-static arm: the draft's ``[L, B, Hkv/tp, T, D]`` rows a
    shard beside the target's, the tp = 1 tokens."""
    kw = dict(STATIC, n_draft=2, decode_steps=2)
    eng = spec(models, **kw)
    got = run_trace(eng)
    assert not eng.paged
    assert [p.shape for p in eng.d_cache["k"].parts] == [(1, 2, 1, 64, 8)] * 2
    assert got == run_trace(spec(models, tp=1, **kw))


def test_spec_fork_invariant_to_tp(models):
    """A fork mid-decode copies the source's committed draft blocks on
    every shard: both rows continue as on one device."""
    def run(eng):
        r0 = eng.submit([3, 1, 4, 1, 5], 10)
        for _ in range(2):
            eng.step()
        r1 = eng.fork(r0, seed=5)
        out = eng.drain()
        return out[r0], out[r1], eng.spec_accepted

    kw = dict(PAGED, max_batch=3, kv_blocks=30, n_draft=2)
    got = run(spec(models, **kw))
    assert got == run(spec(models, tp=1, **kw))


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_spec_preempt_resume_invariant_to_tp(models, mode):
    """Preempt and resume on two shards (swap: the target's payload
    scattered back, the draft rebuilt and replayed; recompute: both
    re-prefilled and replayed): the undisturbed tp = 1 tokens."""
    def run(eng):
        rids = [eng.submit(p, n, **s) for p, n, s in REQS[:2]]
        for _ in range(3):
            eng.step()
        assert eng.preempt(rids[0], mode)
        out = eng.drain()
        return [out[r] for r in rids], dict(eng.preempts), \
            eng.replayed_draft_tokens

    kw = dict(PAGED, n_draft=2, kv_swap=mode == "swap")
    got = run(spec(models, **kw))
    assert got == run(spec(models, tp=1, **kw))
    assert got[0] == run_trace(spec(models, tp=1, **kw), REQS[:2])
    assert got[1][mode] == 1 and got[2] > 0


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_spec_decode_role_adopts_handoff_on_tp2(models, kv_dtype):
    """The port's twin of the reference's
    ``test_spec_decode_role_adopts_handoff_kernel_on`` on a mesh: a
    draft-less tp = 1 prefill engine ships the handoff, a tp = 2
    decode-role speculative engine adopts it (the draft re-prefilled
    from the committed sequence and replayed on every shard); the
    target K/V re-read from the shards equal the shipped bytes, and the
    tokens are the colocated tp = 1 speculative engine's."""
    kw = dict(PAGED, kv_dtype=kv_dtype)
    spec_kw = dict(kw, n_draft=2, decode_steps=1)
    want = run_trace(spec(models, tp=1, **spec_kw))
    pre = DecodeServer(models["target"][1], TCFG, device="cpu",
                       role="prefill", paged_impl="kernel", **kw)
    for p, n, s in REQS:
        pre.submit(p, n, **s)
    states = pre.pop_handoffs()
    dec = spec(models, role="decode", **spec_kw)
    rids = [dec.restore(thandoff.decode_handoff(thandoff.encode_handoff(st)))
            for st in states]
    again = {st["rid"]: st for st in dec.capture_resumable()}
    for st, rid in zip(states, rids):
        thandoff.settle(st["swap"])
        for name in ("k", "v", "k_scale", "v_scale"):
            if name in st["swap"]:
                a = np.asarray(st["swap"][name])
                b = np.asarray(again[rid]["swap"][name])
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert_split(dec.d_cache["k"])
    out = dec.drain()
    assert [out[r] for r in rids] == want


def test_spec_draft_kv_heads_not_divisible_refused(models):
    """A draft with 3 kv heads over two shards: the engine refuses
    before it builds an arena, with the reference's message."""
    bad = dict(DRAFT, d_model=24, n_heads=3, n_kv_heads=3)
    tbad = ttfm.TransformerConfig(**bad, dtype=torch.float32)
    dp = ttfm.init_params(tbad, torch.Generator().manual_seed(1), "cpu")
    with pytest.raises(ValueError, match="draft kv_heads 3 not divisible "
                                         "by tp=2"):
        SpeculativeDecodeServer(models["target"][1], TCFG, dp, tbad,
                                device="cpu", mesh=TpMesh(CPU2), **PAGED)


def test_build_engine_refuses_an_unsplittable_draft_before_weights():
    """``_serving_mesh``'s draft check (the reference's
    ``build_engine``): a draft whose kv heads tp does not divide is
    refused before any weights load (the draft directory does not
    exist), with the reference's message."""
    kw = dict(MODEL, tp=2, bf16=False, draft_checkpoint_dir="/nope",
              draft_d_model=48, draft_n_heads=3, **PAGED_SERVER)
    with pytest.raises(ValueError) as port_err:
        build_engine(ServerConfig(**kw), device="cpu")
    with pytest.raises(ValueError) as ref_err:
        jserver.build_engine(jserver.ServerConfig(**kw))
    assert "draft kv_heads 3 not divisible by tp=2" in str(port_err.value)
    assert str(port_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# the MoE family
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, QuantLinear):
        return [tree.q, tree.scale]
    return [tree]


@pytest.mark.parametrize("int8", [False, True])
def test_moe_param_split_gathers_back_bit_for_bit(models, int8):
    """The MoE family split over two shards and gathered back is the
    params, bit for bit: each expert's gate and up split their d_ff
    columns, down its d_ff rows, the router whole on every shard; the
    int8 twin keeps the experts and the router unquantized."""
    full = quantize_params(models["moe"][1]) if int8 else models["moe"][1]
    tpp = ttfm.shard_params(full, TMCFG, TpMesh(CPU2))
    back = ttfm.gather_params(tpp)
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(full), _leaves(back)))
    layers = full["layers"]
    for r, sh in enumerate(tpp.shards):
        la = sh["layers"]
        f = MODEL["d_ff"] // 2
        assert not isinstance(la["w_gate"], QuantLinear)
        assert torch.equal(la["w_router"], layers["w_router"])
        assert torch.equal(la["w_gate"],
                           layers["w_gate"][..., r * f:(r + 1) * f])
        assert torch.equal(la["w_up"], layers["w_up"][..., r * f:(r + 1) * f])
        assert torch.equal(la["w_down"],
                           layers["w_down"][..., r * f:(r + 1) * f, :])


def test_moe_ffn_tp_matches_unsplit_with_one_routing(models):
    """The split MoE FFN (a prefill-like call, S 9, where capacity drops
    assignments, and a decode call, S 1) is the unsplit ``moe_ffn``'s
    within 1e-5 (f32); its gating runs once a call, and its combine and
    dispatch are the unsplit call's bit for bit."""
    la = models["moe"][1]["layers"]
    mesh = TpMesh(CPU2)
    tpp = ttfm.shard_params(models["moe"][1], TMCFG, mesh)
    gen = torch.Generator().manual_seed(4)
    calls = []
    gating = moe.top2_gating

    def traced(logits, capacity, mean=None):
        out = gating(logits, capacity, mean)
        calls.append(out[:2])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "top2_gating", traced)
        for s in (9, 1):
            h = torch.randn((3, s, MODEL["d_model"]), generator=gen)
            want, aux = moe.moe_ffn(h, la["w_router"][0], la["w_gate"][0],
                                    la["w_up"][0], la["w_down"][0])
            got, aux2 = moe.moe_ffn_tp(
                h, la["w_router"][0],
                [(sh["layers"]["w_gate"][0], sh["layers"]["w_up"][0],
                  sh["layers"]["w_down"][0]) for sh in tpp.shards], mesh)
            assert len(calls) == 2
            (c1, d1), (c2, d2) = calls
            calls.clear()
            assert torch.equal(c1, c2) and torch.equal(d1, d2)
            assert torch.equal(aux, aux2)
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       atol=FFN_TOL, rtol=0)
            if s > 1:
                kept = int(d1.sum())
                assert kept < 2 * 3 * s     # capacity dropped some


@pytest.mark.parametrize("arm", ["bf16", "int8", "static"])
def test_moe_engine_tokens_invariant_to_tp(models, jmesh, arm):
    """The MoE engine on two shards (each expert's d_ff split, the
    gating once on shard 0) == the port's tp = 1 MoE engine == the
    reference's MoE engine on its mesh (params ``device_put`` by
    ``param_shardings``), greedy and sampled rows mixed, on the paged
    engine's bf16 and int8 arenas and on the slot-static engine."""
    kw = dict(STATIC) if arm == "static" else dict(PAGED, kv_dtype=arm)
    eng = moe_engine(models, **kw)
    got = run_trace(eng)
    assert_split(eng.cache["k"])
    assert got == run_trace(moe_engine(models, tp=1, **kw))
    jp = models["moe"][0]
    with gather_oracle():
        ref = JDecodeServer(
            jax.device_put(jp, jtfm.param_shardings(jmesh, JMCFG)), JMCFG,
            mesh=jmesh, **kw)
    assert got == run_trace(ref)


def test_moe_int8_weights_invariant_to_tp(models):
    """``quantize_params``' MoE twin (attention int8, experts and router
    as they were) on two shards: the tp = 1 engine's tokens."""
    q = quantize_params(models["moe"][1])
    kw = dict(PAGED, kv_dtype="int8")
    assert run_trace(moe_engine(models, params=q, **kw)) == \
        run_trace(moe_engine(models, tp=1, params=q, **kw))


# ---------------------------------------------------------------------------
# the binary
# ---------------------------------------------------------------------------

PAGED_SERVER = dict(kv_blocks=24, kv_block_size=8, max_batch=2)


def draft_checkpoint(root) -> str:
    """A draft at ``ServerConfig``'s draft widths (f32, seeded), saved by
    the port's ``CheckpointManager`` with its stamp; its directory."""
    sc = ServerConfig(**MODEL)
    gcfg = GenerateConfig(vocab=sc.vocab, d_model=sc.draft_d_model,
                          n_layers=sc.draft_n_layers,
                          n_heads=sc.draft_n_heads,
                          n_kv_heads=sc.draft_n_kv_heads,
                          d_ff=sc.draft_d_ff, max_seq=sc.max_seq, bf16=False)
    cfg = ttfm.TransformerConfig(
        vocab=gcfg.vocab, d_model=gcfg.d_model, n_layers=gcfg.n_layers,
        n_heads=gcfg.n_heads, n_kv_heads=gcfg.n_kv_heads, d_ff=gcfg.d_ff,
        max_seq=gcfg.max_seq, dtype=torch.float32)
    directory = str(root / "draft")
    mgr = CheckpointManager(directory)
    mgr.write_model_config(model_arch_dict(gcfg))
    mgr.save(1, ttfm.init_params(cfg, torch.Generator().manual_seed(5),
                                 "cpu"), {})
    mgr.close()
    return directory


@pytest.mark.parametrize("knob", ["n_experts", "draft", "both"])
def test_build_engine_serves_moe_and_draft_at_tp2(knob, tmp_path):
    """``build_engine(ServerConfig(tp=2))`` with ``n_experts``, with a
    draft checkpoint, and with both: a tensor-parallel engine (the
    speculative one under a draft, its draft split too) whose answer
    through ``ServingLoop`` is the tp = 1 binary's."""
    extra = {}
    if knob in ("n_experts", "both"):
        extra["n_experts"] = 4
    if knob in ("draft", "both"):
        extra["draft_checkpoint_dir"] = draft_checkpoint(tmp_path)
    got = {}
    for tp in (1, 2):
        eng = build_engine(ServerConfig(**MODEL, bf16=False, tp=tp,
                                        **PAGED_SERVER, **extra),
                           device="cpu")
        assert (eng.mesh is not None) == (tp == 2)
        assert isinstance(eng, SpeculativeDecodeServer) == \
            ("draft_checkpoint_dir" in extra)
        if tp == 2:
            assert_split(eng.cache["k"])
            if "draft_checkpoint_dir" in extra:
                assert_split(eng.d_cache["k"])
                assert isinstance(eng.draft_params, ttfm.TpParams)
        loop = ServingLoop(eng)
        try:
            got[tp] = loop.generate([5, 6, 7], 6)
        finally:
            loop.shutdown()
    assert got[1] == got[2] and len(got[2]) >= 6
