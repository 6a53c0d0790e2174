"""Port parity: tensor-parallel serving (``parallel/mesh.py``,
``transformer.shard_params``, the sharded forwards of
``models/generate.py``, ``DecodeServer(mesh=)``, ``build_engine``'s
``tp``) against the reference's mesh engine (tests/test_serving_sharded.py)
on the CPU.

The model, the requests (greedy and sampled, prompts crossing block
boundaries) and the paged geometry are tests/test_serving_sharded.py's.
The port's engine on two CPU shards (``TpMesh(["cpu", "cpu"])``), on
bridged weights, gives the tokens of the port's single-device engine and
of the reference's engine on its 4 x 2 CPU mesh (the gather formulation,
as ``test_paged_engine_tokens_invariant_to_mesh`` runs it), on bf16 and
int8 arenas, through a COW fork, a preemption in either mode, a handoff
either way between tp = 1 and tp = 2 (the payload re-read from the
adopting arena equal to the one shipped, byte for byte), the slot-static
engine and ``build_engine`` behind ``ServingLoop``; the sharded forward's
logits are the reference's sharded forward's within 1e-5 (f32).
"""
import contextlib
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from nos_tpu.models import generate as jgen  # noqa: E402
from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu.models.serving import DecodeServer as JDecodeServer  # noqa: E402
from nos_tpu_torch.cmd.server import (  # noqa: E402
    ServerConfig, ServingLoop, build_engine,
)
from nos_tpu_torch.models import generate as tgen  # noqa: E402
from nos_tpu_torch.models import handoff as thandoff  # noqa: E402
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402
from nos_tpu_torch.models.errors import NotPorted  # noqa: E402
from nos_tpu_torch.models.quant import quantize_params  # noqa: E402
from nos_tpu_torch.models.serving import DecodeServer  # noqa: E402
from nos_tpu_torch.ops.quant import QuantLinear  # noqa: E402
from nos_tpu_torch.parallel.mesh import HeadShards, TpMesh  # noqa: E402

MODEL = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=64, max_seq=64)
JCFG = jtfm.TransformerConfig(**MODEL, dtype=jnp.float32)
TCFG = ttfm.TransformerConfig(**MODEL, dtype=torch.float32)
REQS = [
    ([3, 1, 4, 1, 5], 8, dict()),
    ([2, 7], 10, dict(temperature=0.7, top_k=8, seed=3)),
    ([9, 9, 1, 2, 6, 6, 1, 8, 3], 6, dict(temperature=0.5, top_p=0.8,
                                          seed=11)),
]
PAGED = dict(max_batch=2, max_len=64, kv_block_size=8, kv_blocks=24)
CPU2 = ["cpu", "cpu"]
LOGIT_TOL = 1e-5


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
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, ttfm.params_from_jax(jp, "cpu")


@pytest.fixture(scope="module")
def jmesh():
    devs = np.asarray(jax.devices()[:8]).reshape(4, 2)
    return Mesh(devs, ("dp", "tp"))


@pytest.fixture(scope="module")
def jsharded(params, jmesh):
    return jax.device_put(params[0], jtfm.param_shardings(jmesh, JCFG))


def run_trace(eng, reqs=REQS):
    rids = [eng.submit(p, n, **kw) for p, n, kw in reqs]
    out = eng.drain()
    return [out[r] for r in rids]


def port(tp_params, tp=2, **kw):
    mesh = TpMesh(["cpu"] * tp) if tp > 1 else None
    return DecodeServer(tp_params, TCFG, device="cpu", mesh=mesh,
                        **{"paged_impl": "kernel", **kw})


@pytest.fixture(scope="module")
def jax_mesh_tokens(params, jsharded, jmesh):
    """The reference mesh engine's tokens per engine kind, made once."""
    out = {}

    def get(kind):
        if kind not in out:
            kw = dict(PAGED, kv_dtype=kind) if kind != "static" \
                else dict(max_batch=2, max_len=64)
            with gather_oracle():
                eng = JDecodeServer(jsharded, JCFG, mesh=jmesh, **kw)
            out[kind] = run_trace(eng)
        return out[kind]

    return get


# ---------------------------------------------------------------------------
# the param split
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, QuantLinear):
        return [tree.q, tree.scale]
    return [tree]


@pytest.mark.parametrize("int8", [False, True])
def test_param_split_gathers_back_bit_for_bit(params, int8):
    """Split over two shards and gathered back, the params are the
    params, bit for bit; each shard holds whole heads of q (H/tp) and
    k/v (Hkv/tp), half the FFN, half the vocabulary, and whole norms."""
    tp_in = quantize_params(params[1]) if int8 else params[1]
    tpp = ttfm.shard_params(tp_in, TCFG, TpMesh(CPU2))
    back = ttfm.gather_params(tpp)
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(tp_in), _leaves(back)))
    sh, D = tpp.shards[1], TCFG.head_dim
    w = lambda x: x.q if int8 else x                      # noqa: E731
    assert w(sh["layers"]["wq"]).shape[-1] == 2 * D
    assert w(sh["layers"]["wk"]).shape[-1] == 1 * D
    assert w(sh["layers"]["wo"]).shape[-2] == 2 * D
    assert w(sh["layers"]["w_down"]).shape[-2] == 32
    assert w(sh["embed"]).shape[0] == 32 and w(sh["unembed"]).shape[-1] == 32
    assert torch.equal(sh["final_norm"], tp_in["final_norm"])
    # shard 1's k columns are kv head 1, its q columns q heads 2 and 3
    full = w(tp_in["layers"]["wk"])
    assert torch.equal(w(sh["layers"]["wk"]), full[..., D:])
    if int8:
        # row-parallel scales are per output channel: whole
        assert torch.equal(sh["layers"]["wo"].scale,
                           tp_in["layers"]["wo"].scale)


def test_head_shards_index_like_one_tensor():
    mesh = TpMesh(CPU2)
    full = torch.randn(2, 5, 4, 3, 2)
    h = HeadShards([p.clone() for p in full.chunk(2, 2)], 2, mesh)
    assert h.shape == full.shape and h.dtype == full.dtype
    idx = torch.tensor([1, 3])
    assert torch.equal(h[:, idx], full[:, idx])
    assert torch.equal(h[:, 1, :, :2], full[:, 1, :, :2])
    h[:, idx] = full[:, idx] * 2
    full[:, idx] *= 2
    h[:, 4] = h[:, 0]
    full[:, 4] = full[:, 0]
    h[:, 1, :, :2] = full[:, 2, :, :2]
    full[:, 1, :, :2] = full[:, 2, :, :2]
    assert torch.equal(h[:, :], full)
    with pytest.raises(IndexError, match="head axis"):
        h[:, :, 0]


# ---------------------------------------------------------------------------
# the sharded forward
# ---------------------------------------------------------------------------

def test_sharded_forward_logits_match_the_reference(params, jsharded, jmesh):
    """A prompt window and a decode step through ``forward_paged`` on
    two shards: logits within 1e-5 of the reference's sharded forward
    on its mesh, and of the port's single-device forward; the arena's
    K/V gathered from the shards equal the single-device arena's."""
    jp, tp = params
    nb, bs = 8, 8
    prompt = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]]
    table = (1 + np.arange(2 * nb, dtype=np.int32)).reshape(2, nb)
    jcache = jax.device_put(
        jgen.init_paged_cache(JCFG, 1 + 2 * nb, bs, 2),
        jgen.paged_cache_shardings(jmesh, JCFG))
    tpp = ttfm.shard_params(tp, TCFG, TpMesh(CPU2))
    tcache = tgen.init_paged_cache(TCFG, 1 + 2 * nb, bs, 2, device="cpu",
                                   mesh=TpMesh(CPU2))
    ocache = tgen.init_paged_cache(TCFG, 1 + 2 * nb, bs, 2, device="cpu")
    ttable = torch.as_tensor(table)
    for toks in (prompt, [[11], [13]]):
        with gather_oracle():
            jl, jcache = jgen.forward_paged(
                jsharded, JCFG, jnp.asarray(toks), jcache,
                jnp.asarray(table), paged_impl="xla", mesh=jmesh)
        tl, tcache = tgen.forward_paged(tpp, TCFG, torch.tensor(toks),
                                        tcache, ttable, paged_impl="kernel")
        ol, ocache = tgen.forward_paged(tp, TCFG, torch.tensor(toks),
                                        ocache, ttable, paged_impl="kernel")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
        np.testing.assert_allclose(tl.numpy(), ol.numpy(),
                                   atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(tcache["k"][:, :].numpy(),
                               ocache["k"].numpy(), atol=LOGIT_TOL, rtol=0)


def test_generate_on_a_mesh_matches_one_device(params):
    """``generate_paged`` (greedy) and ``generate`` (sampled) on two
    shards: the single-device tokens."""
    from nos_tpu_torch.utils import prng

    _, tp = params
    prompt = [[3, 1, 4, 1, 5], [2, 7, 1, 8, 2]]
    mesh = TpMesh(CPU2)
    assert torch.equal(
        tgen.generate_paged(tp, TCFG, prompt, 8, block_size=8,
                            paged_impl="kernel", mesh=mesh),
        tgen.generate_paged(tp, TCFG, prompt, 8, block_size=8,
                            paged_impl="kernel", device="cpu"))
    kw = dict(temperature=0.8, top_k=16, rng=prng.PRNGKey(5))
    assert torch.equal(tgen.generate(tp, TCFG, prompt, 8, mesh=mesh, **kw),
                       tgen.generate(tp, TCFG, prompt, 8, device="cpu",
                                     **kw))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_engine_tokens_invariant_to_tp(params, jax_mesh_tokens,
                                             kv_dtype):
    """The paged engine on two shards == the port's single-device
    engine == the reference's mesh engine, token for token, greedy and
    sampled slots mixed; the arena (and int8's scale planes) lives
    split along its head axis."""
    _, tp = params
    eng = port(tp, kv_dtype=kv_dtype, **PAGED)
    got = run_trace(eng)
    assert got == run_trace(port(tp, tp=1, kv_dtype=kv_dtype, **PAGED))
    assert got == jax_mesh_tokens(kv_dtype)
    names = ("k", "v", "k_scale", "v_scale") if kv_dtype == "int8" \
        else ("k", "v")
    for name in names:
        plane = eng.cache[name]
        assert isinstance(plane, HeadShards)
        assert [p.shape[2] for p in plane.parts] == [1, 1]
    assert eng.capture_programs() == {}


def test_slot_static_engine_tokens_invariant_to_tp(params, jax_mesh_tokens):
    """The reference's default engine (``kv_blocks`` 0) on two shards:
    its ``[L, B, Hkv/tp, T, D]`` rows per shard, the single-device and
    the reference mesh engine's tokens."""
    _, tp = params
    kw = dict(max_batch=2, max_len=64)
    eng = port(tp, **kw)
    got = run_trace(eng)
    assert not eng.paged
    assert [p.shape for p in eng.cache["k"].parts] == [(2, 2, 1, 64, 8)] * 2
    assert got == run_trace(port(tp, tp=1, **kw))
    assert got == jax_mesh_tokens("static")


def test_cow_fork_invariant_to_tp(params):
    """A fork mid-decode shares the source's blocks, and the copy on
    write runs on every shard: both continue as on one device."""
    _, tp = params

    def run(eng):
        r0 = eng.submit([3, 1, 4, 1, 5], 10)
        for _ in range(2):          # mid-block: the fork shares it
            eng.step()
        r1 = eng.fork(r0, seed=5)
        out = eng.drain()
        return out[r0], out[r1], eng.cow_copies

    kw = dict(PAGED, max_batch=3, kv_blocks=30, kv_dtype="int8")
    got = run(port(tp, **kw))
    assert got == run(port(tp, tp=1, **kw))
    assert got[2] > 0


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_preempt_resume_invariant_to_tp(params, mode):
    """Preempt and resume (swap: the gathered payload scattered back
    into the shards; recompute: re-prefill and replay): the undisturbed
    tokens, as on one device."""
    _, tp = params

    def run(eng):
        r0 = eng.submit([3, 1, 4, 1, 5], 10)
        r1 = eng.submit([2, 7], 9, temperature=0.7, seed=3)
        for _ in range(3):
            eng.step()
        assert eng.preempt(r0, mode)
        out = eng.drain()
        return out[r0], out[r1], dict(eng.preempts)

    got = run(port(tp, **PAGED))
    assert got == run(port(tp, tp=1, **PAGED))
    assert got[2][mode] == 1


def _adopt(dec, states):
    rids = [dec.restore(thandoff.decode_handoff(thandoff.encode_handoff(st)))
            for st in states]
    # the adopted requests sit in the arena now: re-read their payloads
    assert len(dec._active) == len(states)
    again = {st["rid"]: st for st in dec.capture_resumable()}
    return rids, [again[r] for r in rids]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("pre_tp,dec_tp", [(1, 2), (2, 1)])
def test_handoff_between_tp_1_and_tp_2(params, kv_dtype, pre_tp, dec_tp):
    """A prefill-role engine on one layout ships its handoffs to a
    decode-role engine on the other: the payload's size is the same at
    either tp, the adopting arena reads back the shipped K/V (and int8
    scales) byte for byte, and the requests finish with the colocated
    single-device tokens."""
    _, tp = params
    reqs = REQS[:2]
    kw = dict(PAGED, kv_dtype=kv_dtype)
    want = run_trace(port(tp, tp=1, **kw), reqs)
    pre = port(tp, tp=pre_tp, role="prefill", **kw)
    for p, n, s in reqs:
        pre.submit(p, n, **s)
    states = pre.pop_handoffs()
    other = port(tp, tp=dec_tp, role="prefill", **kw)
    for p, n, s in reqs:
        other.submit(p, n, **s)
    assert [thandoff.handoff_nbytes(st) for st in states] == \
        [thandoff.handoff_nbytes(st) for st in other.pop_handoffs()]
    dec = port(tp, tp=dec_tp, role="decode", **kw)
    rids, again = _adopt(dec, states)
    for st, st2 in zip(states, again):
        thandoff.settle(st["swap"])
        for name in ("k", "v", "k_scale", "v_scale"):
            if name in st["swap"]:
                a = np.asarray(st["swap"][name])
                b = np.asarray(st2["swap"][name])
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    out = dec.drain()
    assert [out[r] for r in rids] == want


def test_kv_heads_not_divisible_by_tp_is_refused(params):
    """Three kv heads over two shards: the engine and ``build_engine``
    refuse with the reference's messages (the paged arena's and the
    slot-static cache's)."""
    bad = dict(MODEL, d_model=48, n_heads=3, n_kv_heads=3)
    jbad = jtfm.TransformerConfig(**bad, dtype=jnp.float32)
    tbad = ttfm.TransformerConfig(**bad, dtype=torch.float32)
    tp = ttfm.params_from_jax(jtfm.init_params(jax.random.PRNGKey(1), jbad),
                              "cpu")
    with pytest.raises(ValueError, match="head axis") as err:
        DecodeServer(tp, tbad, device="cpu", mesh=TpMesh(CPU2), **PAGED)
    assert "paged KV on this mesh: kv_heads 3 not divisible by tp=2" \
        in str(err.value)
    with pytest.raises(ValueError, match="cannot shard evenly"):
        DecodeServer(tp, tbad, device="cpu", mesh=TpMesh(CPU2),
                     max_batch=2)
    with pytest.raises(ValueError) as port_err:
        build_engine(ServerConfig(**bad, tp=2, bf16=False), device="cpu")
    with pytest.raises(ValueError) as ref_err:
        jgen.cache_shardings(Mesh(np.asarray(jax.devices()[:2]), ("tp",)),
                             jbad)
    assert str(port_err.value) == str(ref_err.value)


def test_tp_above_the_visible_cards_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError,
                       match="tp=2 but only 1 devices visible"):
        build_engine(ServerConfig(**MODEL, tp=2, bf16=False))


@pytest.mark.parametrize("knob,kw", [
    ("n_experts", dict(n_experts=4)),
    ("draft", dict(draft_checkpoint_dir="/d")),
])
def test_moe_and_draft_under_tp_refused_by_name(params, knob, kw):
    """The next A.8 items stay refused by name, before any weights:
    MoE under a mesh, and the speculative engine's draft."""
    with pytest.raises(NotPorted, match=knob):
        build_engine(ServerConfig(**MODEL, tp=2, bf16=False, **PAGED_SERVER,
                                  **kw), device="cpu")
    if knob == "draft":
        from nos_tpu_torch.models.spec_serving import SpeculativeDecodeServer

        _, tp = params
        with pytest.raises(NotPorted, match="draft under a mesh"):
            SpeculativeDecodeServer(tp, TCFG, tp, TCFG, device="cpu",
                                    mesh=TpMesh(CPU2), **PAGED)


PAGED_SERVER = dict(kv_blocks=24, kv_block_size=8, max_batch=2)


@pytest.mark.parametrize("kv_blocks,int8", [(24, False), (0, False),
                                             (24, True)])
def test_build_engine_serves_tp_through_the_loop(kv_blocks, int8):
    """``build_engine(ServerConfig(tp=2))`` on the CPU: every shard on
    the CPU, one request answered through ``ServingLoop`` with the
    tp = 1 binary's tokens, on the paged and slot-static engines and on
    int8 weights (their scales split with them)."""
    base = dict(MODEL, bf16=False, max_batch=2, kv_blocks=kv_blocks,
                kv_block_size=8 if kv_blocks else 0, int8=int8)
    got = {}
    for tp in (1, 2):
        eng = build_engine(ServerConfig(**base, tp=tp), device="cpu")
        assert (eng.mesh is not None) == (tp == 2)
        loop = ServingLoop(eng)
        try:
            got[tp] = loop.generate([5, 6, 7], 6)
        finally:
            loop.shutdown()
    assert got[1] == got[2] and len(got[2]) >= 6
