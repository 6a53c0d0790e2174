"""Port parity: the torch ``DecodeServer`` and ``build_engine`` against the
JAX reference (CPU, f32, tiny config, bridged weights).

The contract is token equality, engine against engine: the same submit
sequence (staggered arrivals, ragged lengths, more requests than slots
so slots recycle) commits the same greedy tokens in the reference
engine and the port's, for bf16 and int8 arenas, and both equal the
port's ``generate_paged``. The reference engine runs its gather
formulation (NOS_TPU_PAGED_KERNEL=0), the oracle it designates; on CPU
tensors the port's kernel wrapper runs the same plain formulation.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nos_tpu.cmd import server as jserver  # noqa: E402
from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu.models import generate as jg  # noqa: E402
from nos_tpu.models.serving import DecodeServer as JDecodeServer  # noqa: E402
from nos_tpu_torch.cmd import generate as tgen  # noqa: E402
from nos_tpu_torch.cmd import server as tserver  # noqa: E402
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402
from nos_tpu_torch.models.errors import Infeasible, QueueFull  # noqa: E402
from nos_tpu_torch.models.generate import generate_paged  # noqa: E402
from nos_tpu_torch.models.serving import DecodeServer  # noqa: E402

KW = dict(vocab=64, d_model=16, n_layers=2, n_heads=2, n_kv_heads=1,
          d_ff=32, max_seq=64)
JCFG = jtfm.TransformerConfig(dtype=jnp.float32, **KW)
TCFG = ttfm.TransformerConfig(dtype=torch.float32, **KW)
ENGINE = dict(max_batch=2, kv_block_size=8, kv_blocks=24)
# (prompt, max_new_tokens, steps to run before the NEXT submit)
ARRIVALS = [([1, 2, 3], 6, 0), ([60, 61], 9, 2), ([7, 7, 7, 7, 7], 5, 1),
            ([4, 5], 10, 0), ([11, 12, 13, 14, 15, 16, 17, 18, 19], 7, 3)]


@pytest.fixture(scope="module")
def params():
    jp = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, ttfm.params_from_jax(jp, "cpu")


@pytest.fixture
def clean_env(monkeypatch):
    """The reference engine's kernel switch, restored after the test (the
    reference's build_engine writes it into os.environ). The port's
    engines take ``paged_impl`` instead."""
    monkeypatch.setenv("NOS_TPU_PAGED_KERNEL", "0")


def _serve(engine):
    rids = []
    for prompt, n, steps in ARRIVALS:
        rids.append(engine.submit(prompt, n))
        for _ in range(steps):
            engine.step()
    out = engine.drain()
    return [out[r] for r in rids]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_engine_tokens_equal_reference_engine_and_generate_paged(
        params, clean_env, kv_dtype):
    jp, tp = params
    ref = _serve(JDecodeServer(jp, JCFG, kv_dtype=kv_dtype, **ENGINE))
    port = DecodeServer(tp, TCFG, kv_dtype=kv_dtype, device="cpu",
                        paged_impl="kernel", **ENGINE)
    got = _serve(port)
    assert got == ref
    for (prompt, n, _), seq in zip(ARRIVALS, got):
        want = generate_paged(tp, TCFG, [prompt], n, block_size=8,
                              kv_dtype=kv_dtype, paged_impl="kernel",
                              device="cpu")
        assert seq == want[0].tolist()
        jwant = jg.generate_paged(jp, JCFG, jnp.asarray([prompt], jnp.int32),
                                 n, block_size=8, kv_dtype=kv_dtype)
        assert seq == np.asarray(jwant)[0].tolist()
    # every block returned to the pool; the kernel formulation echoed
    stats = port.kv_stats()
    assert stats["blocks_used"] == 0 and stats["kernel"] == "kernel"


def test_engine_progress_pop_result_and_refusals(params, clean_env):
    _, tp = params
    eng = DecodeServer(tp, TCFG, max_pending=1, device="cpu",
                       paged_impl="kernel", **ENGINE)
    a = eng.submit([1, 2, 3], 4)
    b = eng.submit([4, 5], 3)
    c = eng.submit([6], 2)                      # waits: both slots busy
    assert eng.progress(c) == ([], False)
    with pytest.raises(QueueFull):
        eng.submit([7], 2)
    with pytest.raises(Infeasible):
        eng.submit([1] * 60, 10)
    with pytest.raises(ValueError, match="temperature > 0"):
        eng.submit([1], 2, top_k=3)
    while eng.has_work():
        eng.step()
    assert eng.progress(a)[1] and len(eng.progress(a)[0]) == 4
    assert eng.pop_result(b)[:2] == [4, 5] and eng.pop_result(b) is None
    assert eng.ticks > 0 and eng.tokens_emitted == 4 + 3 + 2 - 3


BAD_CONFIGS = [
    dict(prefill_chunk=12),
    dict(prefill_budget=-1),
    dict(prefill_budget=8),
    dict(pipeline_depth=0),
    dict(decode_steps=0),
    dict(kv_dtype="fp8"),
    dict(kv_dtype="int8"),
    dict(paged_kernel="maybe"),
    dict(kv_blocks=8, kv_block_size=12),
    dict(kv_blocks=8, kv_block_size=128),
    dict(kv_blocks=1, kv_block_size=8),
    dict(role="router"),
    dict(role="decode"),
    dict(role="prefill", kv_blocks=8, kv_block_size=8),
    dict(kv_host_tier_bytes=-1),
    dict(kv_host_tier_bytes=1024),
]


@pytest.mark.parametrize("bad", BAD_CONFIGS)
def test_build_engine_raises_reference_messages(clean_env, bad):
    kw = dict(KW, bf16=False)
    kw.update(bad)
    with pytest.raises(ValueError) as ref:
        jserver.build_engine(jserver.ServerConfig(**kw))
    with pytest.raises(ValueError) as port:
        tserver.build_engine(tserver.ServerConfig(**kw), device="cpu")
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("knob", [
    dict(kv_blocks=0), dict(kv_fabric_token="s"),
    dict(kv_host_tier_bytes=1024, prefix_cache_size=4,
         role="prefill", decode_pool="http://d0:8000"), dict(tp=2),
    dict(tenant_config="t.json", role="decode"),
    dict(draft_checkpoint_dir="/d", kv_swap=False),
    dict(tenant_config="t.json"),
    dict(draft_checkpoint_dir="/d"), dict(checkpoint_dir="/c"),
])
def test_build_engine_names_every_knob_outside_the_slice(clean_env, knob,
                                                         tmp_path):
    """A knob outside the port is refused by name. tp is served: on
    this model's single kv head it is the reference's ValueError, word
    for word. The fabric token,
    the host tier and a tenant config (``t.json``, a file that does not
    exist) were refused so until their modules were ported; now they
    reach the reference's own validation: the token builds, the tier
    builds on a prefill-role replica, and the missing tenant config is
    the reference's ValueError, word for word. The checkpoint
    directories were refused until checkpoint loading was ported: one
    with no committed step (under the test's own directory) is the
    reference's FileNotFoundError, word for word."""
    kw = dict(KW, bf16=False, kv_blocks=24, kv_block_size=8)
    kw.update(knob)
    name = next(iter(knob))
    if name.endswith("checkpoint_dir"):
        kw[name] = str(tmp_path / kw[name].lstrip("/"))
        with pytest.raises(FileNotFoundError) as ref:
            jserver.build_engine(jserver.ServerConfig(**kw))
        with pytest.raises(FileNotFoundError) as port:
            tserver.build_engine(tserver.ServerConfig(**kw), device="cpu")
        assert str(port.value) == str(ref.value)
        assert str(port.value) == f"no checkpoint under {kw[name]}"
        return
    if name == "tenant_config":
        with pytest.raises(ValueError) as ref:
            jserver.build_engine(jserver.ServerConfig(**kw))
        with pytest.raises(ValueError) as port:
            tserver.build_engine(tserver.ServerConfig(**kw), device="cpu")
        assert str(port.value) == str(ref.value)
        assert "not ported" not in str(port.value)
        return
    if name == "kv_blocks":
        # kv_blocks=0 is served now: the slot-static engine
        eng = tserver.build_engine(tserver.ServerConfig(**kw), device="cpu")
        ref = jserver.build_engine(jserver.ServerConfig(**kw))
        assert eng.paged == ref.paged is False
        assert eng.kv_stats() is None and ref.kv_stats() is None
        return
    if name == "tp":
        # served now: on this model's one kv head both refuse tp=2 with
        # the reference's message (tests/test_torch_tp_serving.py serves
        # it on two kv heads)
        with pytest.raises(ValueError) as ref:
            jserver.build_engine(jserver.ServerConfig(**kw))
        with pytest.raises(ValueError) as port:
            tserver.build_engine(tserver.ServerConfig(**kw), device="cpu")
        assert str(port.value) == str(ref.value)
        assert "not ported" not in str(port.value)
        return
    if name in ("kv_fabric_token", "kv_host_tier_bytes"):
        eng = tserver.build_engine(tserver.ServerConfig(**kw), device="cpu")
        ref = jserver.build_engine(jserver.ServerConfig(**kw))
        assert (eng._host_tier is None) == (ref._host_tier is None)
        if eng._host_tier is not None:
            assert eng._host_tier.capacity_bytes == \
                ref._host_tier.capacity_bytes
        assert eng.role == ref.role
        return
    with pytest.raises(ValueError, match="not ported") as err:
        tserver.build_engine(tserver.ServerConfig(**kw), device="cpu")
    assert name.split("=")[0] in str(err.value)


@pytest.mark.parametrize("knob", [
    dict(prefix_cache_size=4), dict(prefill_chunk=16),
    dict(prefill_chunk=16, prefill_budget=16),
], ids=["prefix_cache_size", "prefill_chunk", "prefill_budget"])
def test_build_engine_serves_admission_knobs(clean_env, knob):
    """The knobs reach the engine as the reference's build_engine passes
    them, and serve: a shared-prompt, long-prompt mix gives the tokens of
    the engine built without them (prefix reuse and chunking change no
    token)."""
    kw = dict(KW, bf16=False, kv_blocks=24, kv_block_size=8, max_batch=2)
    ref = jserver.build_engine(jserver.ServerConfig(**kw, **knob))
    port = tserver.build_engine(tserver.ServerConfig(**kw, **knob),
                                device="cpu")
    plain = tserver.build_engine(tserver.ServerConfig(**kw), device="cpu")
    for attr in ("_prefill_chunk", "prefill_budget", "_prefix_max"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert (port._pindex is None) == (ref._pindex is None)
    head = list(range(1, 18))
    reqs = [(head, 3, dict(cache_prefix=True)), (head + [40, 41], 5, {}),
            (list(range(5, 45)), 4, {})]
    outs = []
    for eng in (port, plain):
        got = []
        for prompt, n, extra in reqs:
            rid = eng.submit(prompt, n, **extra)
            got.append(eng.drain()[rid])
        outs.append(got)
    assert outs[0] == outs[1]
    if "prefix_cache_size" in knob:
        assert port.prefix_hits == 1 and port.prefix_tokens_saved == 16


def test_build_engine_serves_seeded_weights(clean_env):
    cfg = tserver.ServerConfig(bf16=False, kv_blocks=24, kv_block_size=8,
                               max_batch=2, int8=True, seed=3, **KW)
    eng = tserver.build_engine(cfg, device="cpu")
    # the kernel formulation; on CPU tensors it runs the plain version
    assert eng.paged_kernel == "kernel"
    rid = eng.submit([5, 6, 7], 6)
    got = eng.drain()[rid]
    mcfg, p = tgen.load_params(
        tgen.GenerateConfig(bf16=False, int8=True, seed=3, **KW), "cpu")
    want = generate_paged(p, mcfg, [[5, 6, 7]], 6, block_size=8,
                          paged_impl="kernel", device="cpu")
    assert got == want[0].tolist()


@pytest.mark.parametrize("paged_kernel,want", [("on", "kernel"),
                                                ("off", "xla")])
def test_build_engine_leaves_the_environment_alone(clean_env, monkeypatch,
                                                   paged_kernel, want):
    """build_engine hands the formulation to the engine as its
    ``paged_impl``: ``os.environ`` is the same after the build, and the
    engine runs what ``cfg.paged_kernel`` says whatever the variable
    holds."""
    import os

    for env in ("1", "0"):
        monkeypatch.setenv("NOS_TPU_TORCH_PAGED_KERNEL", env)
        before = dict(os.environ)
        eng = tserver.build_engine(tserver.ServerConfig(
            bf16=False, kv_blocks=24, kv_block_size=8, max_batch=2,
            paged_kernel=paged_kernel, **KW), device="cpu")
        assert dict(os.environ) == before
        assert eng.paged_kernel == want == eng.kv_stats()["kernel"]


def test_engine_paged_impl_is_explicit_or_the_env_default(params,
                                                          monkeypatch):
    _, tp = params
    monkeypatch.setenv("NOS_TPU_TORCH_PAGED_KERNEL", "0")
    assert DecodeServer(tp, TCFG, device="cpu",
                        **ENGINE).paged_kernel == "xla"
    assert DecodeServer(tp, TCFG, device="cpu", paged_impl="kernel",
                        **ENGINE).paged_kernel == "kernel"
    with pytest.raises(ValueError, match="paged_impl must be kernel|xla"):
        DecodeServer(tp, TCFG, device="cpu", paged_impl="pallas", **ENGINE)


def test_kernel_engine_refuses_head_dim_on_the_card(params, clean_env):
    """head_dim 8 with the kernel on the card: build_engine and
    DecodeServer raise naming head_dim before any weights or arena are
    made, so no CUDA is touched."""
    _, tp = params
    with pytest.raises(ValueError, match="head_dim 8"):
        tserver.build_engine(tserver.ServerConfig(
            bf16=False, kv_blocks=24, kv_block_size=8, **KW), device="cuda")
    with pytest.raises(ValueError, match="head_dim 8"):
        DecodeServer(tp, TCFG, device="cuda", paged_impl="kernel", **ENGINE)


def test_entry_points_refuse_the_cpu_without_device(monkeypatch, params):
    """With no CUDA device and no device=, every entry point raises
    instead of running on the CPU."""
    _, tp = params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gcfg = tgen.GenerateConfig(bf16=False, **KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgen.load_params(gcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeServer(tp, TCFG, **ENGINE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_paged(tp, TCFG, [[1, 2]], 2, block_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserver.build_engine(tserver.ServerConfig(
            bf16=False, kv_blocks=24, kv_block_size=8, **KW))
