"""Port parity: the KV fabric (``nos_tpu_torch/kvfabric/``, the host tier
under the engine's arena, chain export and ingest) against the JAX
package on the CPU: twins of tests/test_kvfabric.py on the tiny f32
config and bridged weights, tokens held exact to the reference, and
cross-framework cases: a chain's codec bytes from the port's payload
equal the reference codec's, and a chain exported by either engine
ingests into the other and serves the exporting engine's tokens.

Port engines run the kernel formulation (its plain version on CPU
tensors); the reference's engines run the gather formulation, set by
monkeypatch only. Every payload plane crosses the port's pinned staging
pool, which on the CPU is plain memory (tests of the pool itself are at
the end).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from nos_tpu.kvfabric import FleetPrefixIndex  # noqa: E402
from nos_tpu.kvfabric import HostTierStore as JHostTierStore  # noqa: E402
from nos_tpu.kvfabric import codec as jcodec  # noqa: E402
from nos_tpu.models import transformer as jtfm  # noqa: E402
from nos_tpu.models.generate import generate as jgenerate  # noqa: E402
from nos_tpu.models.serving import DecodeServer as JDecodeServer  # noqa: E402
from nos_tpu_torch.kvfabric import (  # noqa: E402
    HostTierStore, chain_digest, decode_chain, encode_chain,
)
from nos_tpu_torch.models import transformer as ttfm  # noqa: E402
from nos_tpu_torch.models.handoff import encode_handoff  # noqa: E402
from nos_tpu_torch.models.serving import DecodeServer, _Request  # noqa: E402
from nos_tpu_torch.models.staging import (  # noqa: E402
    MAX_SLABS, PinnedStaging, settle,
)
from nos_tpu_torch.models.tenantquota import (  # noqa: E402
    TenantQuotaConfig, TenantSpec,
)

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


def fabric_engine(tp, host_bytes=1 << 20, prefix_blocks=8, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("kv_block_size", 8)
    kw.setdefault("kv_blocks", 24)
    kw.setdefault("kv_dtype", "int8")
    kw.setdefault("paged_impl", "kernel")
    host = HostTierStore(host_bytes) if host_bytes else None
    eng = DecodeServer(tp, TCFG, prefix_cache_size=prefix_blocks,
                       host_tier=host, device="cpu", **kw)
    return eng, host


def ref_engine(jp, prefix_blocks=8, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("kv_block_size", 8)
    kw.setdefault("kv_blocks", 24)
    kw.setdefault("kv_dtype", "int8")
    return JDecodeServer(jp, JCFG, prefix_cache_size=prefix_blocks, **kw)


def swap_bytes(eng, blocks):
    """The chain's KV planes as raw bytes, per array key: what tiering
    must keep exactly."""
    swap = eng._swap_payload(list(blocks), len(blocks))
    return {k: np.asarray(v).tobytes()
            for k, v in swap.items() if k not in ("nblk", "dtype")}


def quota(share_prefix=False):
    return TenantQuotaConfig(
        tenants={"gold": TenantSpec("gold"),
                 "burst": TenantSpec("burst")},
        window_s=8.0, share_prefix=share_prefix)


# ---------------------------------------------------------------------------
# codec (tests/test_kvfabric.py:79-111)
# ---------------------------------------------------------------------------

def test_chain_digest_embeds_scope():
    toks = [1, 2, 3, 4]
    assert chain_digest(toks) == chain_digest(list(toks))
    assert chain_digest(toks) != chain_digest(toks, "gold")
    assert chain_digest(toks, "gold") != chain_digest(toks, "burst")
    assert chain_digest([1, 23]) != chain_digest([12, 3])
    # the reference's digest, scope or none
    for scope in (None, "gold"):
        assert chain_digest(toks, scope) == jcodec.chain_digest(toks, scope)


def test_encode_decode_chain_roundtrip_bytes():
    rng = np.random.default_rng(0)
    swap = {
        "k": rng.integers(-128, 127, (2, 3, 2, 8, 8), dtype=np.int8),
        "v": rng.integers(-128, 127, (2, 3, 2, 8, 8), dtype=np.int8),
        "k_scale": rng.random((2, 3, 2, 1, 8), dtype=np.float32),
        "v_scale": rng.random((2, 3, 2, 1, 8), dtype=np.float32),
        "nblk": 3,
    }
    data = encode_chain("gold", [5, 6, 7], swap)
    assert data == jcodec.encode_chain("gold", [5, 6, 7], swap)
    state = decode_chain(data)
    assert state["scope"] == "gold" and state["tokens"] == [5, 6, 7]
    for key in ("k", "v", "k_scale", "v_scale"):
        out = state["swap"][key]
        assert out.dtype == swap[key].dtype
        assert out.tobytes() == swap[key].tobytes(), key


def test_decode_chain_rejects_foreign_payload():
    blob = encode_handoff({"swap": {"k": np.zeros((1, 1), np.int8)}})
    with pytest.raises(ValueError):
        decode_chain(blob)
    with pytest.raises(ValueError):
        decode_chain(b"junk")


# ---------------------------------------------------------------------------
# host tier (tests/test_kvfabric.py:118-172)
# ---------------------------------------------------------------------------

def _swap(n=1, fill=0):
    return {"k": np.full((2, n, 2, 8, 8), fill, np.int8),
            "v": np.full((2, n, 2, 8, 8), fill, np.int8),
            "nblk": n}


def test_host_tier_capacity_bound_evicts_lru():
    one = sum(np.asarray(v).nbytes for k, v in _swap().items()
              if k != "nblk")
    store = HostTierStore(2 * one)
    assert store.put(None, [1] * 8, _swap(fill=1))
    assert store.put(None, [2] * 8, _swap(fill=2))
    assert len(store) == 2 and store.nbytes == 2 * one
    assert store.match(None, [1] * 8 + [9] * 8, 8) is not None
    assert store.get((None, tuple([1] * 8))) is not None
    assert store.put(None, [3] * 8, _swap(fill=3))
    assert len(store) == 2 and store.nbytes == 2 * one
    assert store.match(None, [2] * 8, 8) is None
    assert store.match(None, [1] * 8, 8) is not None
    assert store.counts["evicted"] == 1


def test_host_tier_rejects_oversize_chain():
    store = HostTierStore(16)
    assert not store.put(None, [1] * 8, _swap())
    assert len(store) == 0 and store.counts["rejected"] == 1


def test_host_tier_match_is_scope_filtered():
    store = HostTierStore(1 << 20)
    assert store.put("gold", [1] * 8, _swap())
    assert store.match("gold", [1] * 16, 16) is not None
    assert store.match("burst", [1] * 16, 16) is None
    assert store.match(None, [1] * 16, 16) is None


def test_host_tier_longest_match_wins():
    store = HostTierStore(1 << 20)
    store.put(None, [1] * 8, _swap(1))
    store.put(None, [1] * 16, _swap(2))
    key = store.match(None, [1] * 24, 24)
    assert key is not None and len(key[1]) == 16
    key = store.match(None, [1] * 24, 8)
    assert key is not None and len(key[1]) == 8


# ---------------------------------------------------------------------------
# the fleet index reads the port's /stats (tests/test_kvfabric.py:179)
# ---------------------------------------------------------------------------

def test_fleet_index_sync_ages_out_missing_replicas(params):
    """The gateway's ``FleetPrefixIndex`` (the reference's: the fleet
    index is control plane, not ported) syncs from two port replicas'
    ``prefix_index`` sections, finds a chain's holders, and ages a
    replica out when it leaves the scrape set or stops reporting."""
    _, tp = params
    a, _ = fabric_engine(tp, prefix_blocks=4)
    b, _ = fabric_engine(tp, prefix_blocks=4)
    for eng in (a, b):
        eng.submit([7] * 8 + [1], 2, cache_prefix=True)
        eng.drain()
    digest = chain_digest([7] * 8)
    idx = FleetPrefixIndex()
    idx.sync({"rep-0": a.stats()["prefix_index"],
              "rep-1": b.stats()["prefix_index"]})
    assert len(idx.holders(digest)) == 2
    (name, row), = idx.holders(digest, exclude="rep-0")
    assert name == "rep-1" and row["tier"] == "hbm" and row["len"] == 8
    idx.sync({"rep-0": a.stats()["prefix_index"]})
    assert [n for n, _ in idx.holders(digest)] == ["rep-0"]
    idx.sync({"rep-0": None})
    assert idx.holders(digest) == []
    assert idx.stats() == {"replicas": 0, "chains": 0}


# ---------------------------------------------------------------------------
# demote -> promote on the port's engine (tests/test_kvfabric.py:195-358)
# ---------------------------------------------------------------------------

def test_demote_promote_roundtrip_byte_identical(params):
    jp, tp = params
    eng, host = fabric_engine(tp, prefix_blocks=1)
    sys_a, sys_b = [7] * 8, [9] * 8
    eng.submit(sys_a + [1, 2], 4, cache_prefix=True)
    eng.drain()
    key = (None, tuple(sys_a))
    blocks = dict(eng._pindex.chain_items())[key]
    before = swap_bytes(eng, blocks)
    eng.submit(sys_b + [3, 4], 4, cache_prefix=True)
    eng.drain()
    assert eng._fabric["demote"] == 1
    assert eng._pindex.evicted == {"drop": 0, "demote": 1}
    assert host.match(None, sys_a, 8) == key
    out = eng.submit(sys_a + [5, 6], 6)
    res = eng.drain()
    assert eng._fabric["promote"] == 1
    assert host.match(None, sys_a, 8) is None
    assert res[out] == ref(jp, sys_a + [5, 6], 6)
    blocks = dict(eng._pindex.chain_items())[key]
    after = swap_bytes(eng, blocks)
    assert set(after) == {"k", "v", "k_scale", "v_scale"}
    for plane, want in before.items():
        assert after[plane] == want, f"{plane} changed across tiers"


def test_demotion_falls_back_to_drop_without_host_room(params):
    jp, tp = params
    eng, host = fabric_engine(tp, host_bytes=16, prefix_blocks=1)
    eng.submit([7] * 8 + [1], 3, cache_prefix=True)
    eng.drain()
    eng.submit([9] * 8 + [2], 3, cache_prefix=True)
    eng.drain()
    assert eng._pindex.evicted == {"drop": 1, "demote": 0}
    assert len(host) == 0 and host.counts["rejected"] == 1
    rid = eng.submit([7] * 8 + [1, 2], 4)
    res = eng.drain()
    assert eng._fabric["promote"] == 0
    assert res[rid] == ref(jp, [7] * 8 + [1, 2], 4)


def test_promote_races_concurrent_decode(params):
    _, tp = params
    sys_a = [7] * 8
    oracle, _ = fabric_engine(tp, host_bytes=0, prefix_blocks=8)
    oracle.submit(sys_a + [1, 2], 4, cache_prefix=True)
    oracle.drain()
    o0 = oracle.submit([4, 5], 24)
    oracle.step()
    o1 = oracle.submit(sys_a + [5, 6], 6)
    want = oracle.drain()

    eng, host = fabric_engine(tp, prefix_blocks=1)
    eng.submit(sys_a + [1, 2], 4, cache_prefix=True)
    eng.drain()
    eng.submit([9] * 8 + [3], 4, cache_prefix=True)
    eng.drain()
    assert eng._fabric["demote"] == 1
    r0 = eng.submit([4, 5], 24)
    eng.step()
    r1 = eng.submit(sys_a + [5, 6], 6)
    res = eng.drain()
    assert eng._fabric["promote"] == 1
    assert res[r0] == want[o0]
    assert res[r1] == want[o1]
    assert eng._alloc.used_count == eng._pindex.block_count


def test_failed_promote_that_evicts_the_matched_chain_re_matches(params):
    """A promotion whose ingest fails can still have evicted the chain
    the caller's pre-promotion match returned: the returned (m, mkey) is
    always a fresh match after any ingest attempt."""
    _, tp = params
    sys8, sys32 = [7] * 8, [7] * 32
    oracle, _ = fabric_engine(tp, host_bytes=0, prefix_blocks=8)
    o0 = oracle.submit(sys8 + [2], 8)
    o1 = oracle.submit(sys32 + [9], 2)
    want = oracle.drain()

    donor, _ = fabric_engine(tp, prefix_blocks=8)
    donor.submit(sys32 + [1], 2, cache_prefix=True)
    donor.drain()
    dblocks = dict(donor._pindex.chain_items())[(None, tuple(sys32))]
    payload = donor._swap_payload(list(dblocks), len(dblocks))

    eng, host = fabric_engine(tp, prefix_blocks=4, kv_blocks=6)
    assert host.put(None, tuple(sys32), payload)
    eng.submit(sys8 + [1], 2, cache_prefix=True)
    eng.drain()
    r0 = eng.submit(sys8 + [2], 8)
    eng.step()

    probe = _Request(rid=-1, prompt=sys32 + [9], max_new_tokens=2)
    m, mkey = eng._pindex.match(probe.prompt, len(probe.prompt) - 1,
                                None)
    assert (m, mkey) == (8, (None, tuple(sys8)))
    m2, mkey2 = eng._promote_from_host(probe, m, mkey,
                                       len(probe.prompt))
    assert eng._fabric["promote"] == 0
    assert eng._fabric["demote"] == 1
    assert (None, tuple(sys8)) not in dict(eng._pindex.chain_items())
    assert (m2, mkey2) == (0, None)
    assert host.get((None, tuple(sys32))) is not None

    r1 = eng.submit(sys32 + [9], 2)
    res = eng.drain()
    assert eng._fabric["promote"] == 1
    assert host.get((None, tuple(sys32))) is None
    assert host.get((None, tuple(sys8))) is not None
    assert res[r0] == want[o0]
    assert res[r1] == want[o1]
    assert eng._alloc.used_count == eng._pindex.block_count


def test_bf16_chains_tier_byte_identical(params):
    jp, tp = params
    eng, host = fabric_engine(tp, prefix_blocks=1, kv_dtype="bf16")
    sys_a = [7] * 8
    eng.submit(sys_a + [1], 3, cache_prefix=True)
    eng.drain()
    key = (None, tuple(sys_a))
    before = swap_bytes(eng, dict(eng._pindex.chain_items())[key])
    assert set(before) == {"k", "v"}
    eng.submit([9] * 8 + [2], 3, cache_prefix=True)
    eng.drain()
    rid = eng.submit(sys_a + [5], 4)
    res = eng.drain()
    assert eng._fabric == {"demote": 2, "promote": 1, "ingest": 0,
                           "ingest_rejected": 0}
    assert res[rid] == ref(jp, sys_a + [5], 4)
    after = swap_bytes(eng, dict(eng._pindex.chain_items())[key])
    assert after == before


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_bf16_model_chain_tiers_byte_identical(params, kv_dtype):
    """A bf16 model's arena (bf16 planes carried as uint16 bits named
    "bfloat16", or int8 with f32 scales) demotes and promotes byte for
    byte, and the promoted prefix serves the tokens of an engine that
    never tiered."""
    jp, _ = params
    cfg = ttfm.TransformerConfig(**MODEL, dtype=torch.bfloat16)
    tp = ttfm.params_from_jax(
        jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp), "cpu")
    kw = dict(max_batch=2, kv_block_size=8, kv_blocks=24,
              kv_dtype=kv_dtype, paged_impl="kernel", device="cpu")
    oracle = DecodeServer(tp, cfg, prefix_cache_size=8, **kw)
    eng = DecodeServer(tp, cfg, prefix_cache_size=1,
                       host_tier=HostTierStore(1 << 20), **kw)
    sys_a = [7] * 8
    for e in (oracle, eng):
        e.submit(sys_a + [1], 3, cache_prefix=True)
        e.drain()
    key = (None, tuple(sys_a))
    before = eng._swap_payload(list(dict(eng._pindex.chain_items())[key]), 1)
    if kv_dtype == "bf16":
        assert before["dtype"] == "bfloat16" and before["k"].dtype == np.uint16
    eng.submit([9] * 8 + [2], 3, cache_prefix=True)
    eng.drain()
    o = oracle.submit(sys_a + [5], 6)
    r = eng.submit(sys_a + [5], 6)
    assert eng.drain()[r] == oracle.drain()[o]
    assert eng._fabric["promote"] == 1
    after = eng._swap_payload(list(dict(eng._pindex.chain_items())[key]), 1)
    for plane in ("k", "v", "k_scale", "v_scale"):
        if plane in before:
            assert after[plane].tobytes() == before[plane].tobytes(), plane


# ---------------------------------------------------------------------------
# tenant isolation (tests/test_kvfabric.py:365-401)
# ---------------------------------------------------------------------------

def test_cross_tenant_chains_never_match_nor_migrate(params):
    jp, tp = params
    eng, host = fabric_engine(tp, prefix_blocks=1, tenant_quota=quota())
    sys_a = [7] * 8
    eng.submit(sys_a + [1], 3, cache_prefix=True, tenant="gold")
    eng.drain()
    eng.submit([9] * 8 + [2], 3, cache_prefix=True, tenant="gold")
    eng.drain()
    assert eng._fabric["demote"] == 1
    assert host.match("gold", sys_a, 8) is not None
    rid = eng.submit(sys_a + [5], 4, tenant="burst")
    res = eng.drain()
    assert eng._fabric["promote"] == 0
    assert host.match("gold", sys_a, 8) is not None
    assert res[rid] == ref(jp, sys_a + [5], 4)
    rid = eng.submit(sys_a + [6], 4, tenant="gold")
    res = eng.drain()
    assert eng._fabric["promote"] == 1
    assert res[rid] == ref(jp, sys_a + [6], 4)


def test_ingest_rejects_cross_tenant_chain(params):
    _, tp = params
    eng, _ = fabric_engine(tp, prefix_blocks=4, tenant_quota=quota())
    sys_a = [7] * 8
    eng.submit(sys_a + [1], 3, cache_prefix=True, tenant="gold")
    eng.drain()
    digest = chain_digest(sys_a, "gold")
    blob = eng.export_chain(digest)
    assert blob is not None
    peer, _ = fabric_engine(tp, prefix_blocks=4, tenant_quota=quota())
    assert not peer.ingest_chain(blob, tenant="burst")
    assert peer._fabric["ingest_rejected"] == 1
    assert peer.ingest_chain(blob, tenant="gold")
    assert peer._fabric["ingest"] == 1


# ---------------------------------------------------------------------------
# cross-engine migration (tests/test_kvfabric.py:408-441)
# ---------------------------------------------------------------------------

def test_export_ingest_between_engines_bit_exact(params):
    jp, tp = params
    src, _ = fabric_engine(tp, prefix_blocks=4)
    sys_a = [7] * 8
    src.submit(sys_a + [1, 2], 4, cache_prefix=True)
    src.drain()
    digest = chain_digest(sys_a)
    blob = src.export_chain(digest)
    assert blob is not None
    assert src.export_chain("no-such-digest") is None

    dst, _ = fabric_engine(tp, prefix_blocks=4)
    assert dst.ingest_chain(blob, expect_digest=digest)
    assert dst._fabric["ingest"] == 1
    before_saved = dst._pindex.stats()["tokens_saved"]
    rid = dst.submit(sys_a + [5, 6], 6)
    res = dst.drain()
    assert res[rid] == ref(jp, sys_a + [5, 6], 6)
    assert dst._pindex.stats()["tokens_saved"] > before_saved
    assert not dst.ingest_chain(blob, expect_digest="deadbeef")
    assert dst._fabric["ingest_rejected"] == 1


def test_export_serves_host_tier_chains(params):
    _, tp = params
    eng, host = fabric_engine(tp, prefix_blocks=1)
    sys_a = [7] * 8
    eng.submit(sys_a + [1], 3, cache_prefix=True)
    eng.drain()
    eng.submit([9] * 8 + [2], 3, cache_prefix=True)
    eng.drain()
    assert host.match(None, sys_a, 8) is not None
    blob = eng.export_chain(chain_digest(sys_a))
    assert blob is not None
    state = decode_chain(blob)
    assert state["scope"] is None and state["tokens"] == sys_a
    assert state["swap"]["nblk"] == 1


# ---------------------------------------------------------------------------
# /stats prefix_index (tests/test_kvfabric.py:448-475)
# ---------------------------------------------------------------------------

def test_prefix_index_snapshot_reports_both_tiers(params):
    jp, tp = params
    eng, host = fabric_engine(tp, prefix_blocks=1)
    jeng = ref_engine(jp, prefix_blocks=1,
                      host_tier=JHostTierStore(1 << 20))
    for e in (eng, jeng):
        e.submit([7] * 8 + [1], 3, cache_prefix=True)
        e.drain()
        e.submit([9] * 8 + [2], 3, cache_prefix=True)
        e.drain()
    snap = eng.stats()["prefix_index"]
    tiers = {row["digest"]: row["tier"] for row in snap["chains"]}
    assert tiers == {chain_digest([9] * 8): "hbm",
                     chain_digest([7] * 8): "host"}
    for row in snap["chains"]:
        assert row["len"] == 8 and row["nbytes"] > 0
    assert snap["evicted"] == {"drop": 0, "demote": 1}
    assert snap["fabric"]["demote"] == 1
    assert snap["host_tier"]["chains"] == 1
    assert snap["host_tier"]["capacity_bytes"] == 1 << 20
    # the reference's section, key for key and value for value (an
    # int8 block snapshots to the same bytes in both frameworks)
    assert snap == jeng.stats()["prefix_index"]


def test_prefix_index_absent_without_paging(params):
    """The reference's engine without a paged prefix index reports no
    section: neither does the port's slot-static engine (with or
    without its prefix cache, which is not a block index), nor a paged
    engine without a prefix cache."""
    jp, tp = params
    for kw in (dict(), dict(prefix_cache_size=4)):
        eng = DecodeServer(tp, TCFG, max_batch=2, device="cpu", **kw)
        jeng = JDecodeServer(jp, JCFG, max_batch=2, **kw)
        assert eng.stats()["prefix_index"] is None
        assert jeng.stats()["prefix_index"] is None
        assert eng.export_chain("0" * 16) is None
        assert not eng.ingest_chain(b"")
    eng = DecodeServer(tp, TCFG, max_batch=2, kv_block_size=8,
                       kv_blocks=24, device="cpu")
    assert eng.stats()["prefix_index"] is None


def test_host_tier_requires_prefix_cache(params):
    jp, tp = params
    with pytest.raises(ValueError) as want:
        JDecodeServer(jp, JCFG, max_batch=2, kv_block_size=8,
                      kv_blocks=24, host_tier=JHostTierStore(1 << 20))
    with pytest.raises(ValueError) as got:
        DecodeServer(tp, TCFG, max_batch=2, kv_block_size=8, kv_blocks=24,
                     host_tier=HostTierStore(1 << 20), device="cpu")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# across frameworks
# ---------------------------------------------------------------------------

def _ml_bf16(swap):
    """A port payload as the reference engine holds it: bf16 planes as
    ``ml_dtypes.bfloat16`` arrays."""
    out = {k: v for k, v in swap.items() if k != "dtype"}
    if swap.get("dtype") == "bfloat16":
        for k in ("k", "v"):
            out[k] = swap[k].view(ml_dtypes.bfloat16)
    return out


@pytest.mark.parametrize("model_dtype,kv_dtype", [
    ("float32", "int8"), ("float32", "bf16"), ("bfloat16", "bf16"),
    ("bfloat16", "int8")])
def test_chain_bytes_equal_the_references_codec(params, model_dtype,
                                                kv_dtype):
    """A chain exported by the port (from the arena, or after a demotion
    from the host tier) is the reference codec's bytes for the same
    scope, tokens and planes."""
    jp, _ = params
    dt = getattr(torch, model_dtype)
    cfg = ttfm.TransformerConfig(**MODEL, dtype=dt)
    tp = ttfm.params_from_jax(jax.tree_util.tree_map(
        lambda x: x.astype(getattr(jnp, model_dtype)), jp), "cpu")
    eng = DecodeServer(tp, cfg, max_batch=2, kv_block_size=8, kv_blocks=24,
                       kv_dtype=kv_dtype, prefix_cache_size=1,
                       host_tier=HostTierStore(1 << 20),
                       tenant_quota=quota(), paged_impl="kernel",
                       device="cpu")
    sys_a = [7] * 16
    eng.submit(sys_a + [1], 2, cache_prefix=True, tenant="gold")
    eng.drain()
    key = ("gold", tuple(sys_a))
    swap = eng._swap_payload(list(dict(eng._pindex.chain_items())[key]), 2)
    blob = eng.export_chain(chain_digest(sys_a, "gold"))
    assert blob == jcodec.encode_chain("gold", sys_a, _ml_bf16(swap))
    # demoted: the host tier serves the same bytes
    eng.submit([9] * 8 + [2], 2, cache_prefix=True, tenant="gold")
    eng.drain()
    assert eng._fabric["demote"] == 1
    assert eng.export_chain(chain_digest(sys_a, "gold")) == blob
    # and the reference decodes the port's bytes to the same planes
    state = jcodec.decode_chain(blob)
    assert state["scope"] == "gold" and state["tokens"] == sys_a
    for k, v in _ml_bf16(swap).items():
        if k != "nblk":
            assert np.asarray(state["swap"][k]).tobytes() == v.tobytes()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kv_dtype", ["int8", "bf16"])
def test_chain_ingested_across_frameworks(params, direction, kv_dtype):
    """A chain the JAX engine exports, ingested by the port's engine,
    serves the JAX engine's own tokens for a request that hits it, and
    the other way round; on the f32 arena the hit's first-token logits
    agree within 1e-5."""
    jp, tp = params
    sys_a = [7] * 16
    prompt = sys_a + [3, 5, 2]
    jeng = ref_engine(jp, kv_dtype=kv_dtype, prefix_blocks=4)
    teng, _ = fabric_engine(tp, host_bytes=0, prefix_blocks=4,
                            kv_dtype=kv_dtype)
    src, dst = (jeng, teng) if direction == "jax_to_port" else (teng, jeng)
    src.submit(sys_a + [1], 2, cache_prefix=True)
    src.drain()
    digest = chain_digest(sys_a)
    blob = src.export_chain(digest)
    assert blob is not None
    assert dst.ingest_chain(blob, expect_digest=digest)
    assert dst._fabric["ingest"] == 1
    first = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        tail = eng._finish_prefill

        def spy(req, row, step, _tail=tail, _name=name, **kw):
            first[_name] = np.asarray(step, np.float32).copy() \
                if _name == "jax" else step.float().numpy().copy()
            return _tail(req, row, step, **kw)

        eng._finish_prefill = spy
    s = src.submit(prompt, 8)
    d = dst.submit(prompt, 8)
    got, want = dst.drain()[d], src.drain()[s]
    assert got == want
    assert dst.prefix_hits == 1 and src.prefix_hits == 1
    if kv_dtype == "bf16":      # the f32 arena: the hit's first logits
        np.testing.assert_allclose(first["port"], first["jax"], atol=1e-5)


def test_ingest_refuses_another_geometry_or_dtype(params):
    """The geometry and dtype gate: a chain from an engine with another
    block size or arena dtype never scatters (counted rejected)."""
    _, tp = params
    src, _ = fabric_engine(tp, host_bytes=0, prefix_blocks=4,
                           kv_dtype="bf16")
    src.submit([7] * 16 + [1], 2, cache_prefix=True)
    src.drain()
    blob = src.export_chain(chain_digest([7] * 16))
    for kw in (dict(kv_dtype="int8"), dict(kv_block_size=16)):
        dst, _ = fabric_engine(tp, host_bytes=0, prefix_blocks=4,
                               **{"kv_dtype": "bf16", **kw})
        assert not dst.ingest_chain(blob)
        assert dst._fabric == {"demote": 0, "promote": 0, "ingest": 0,
                               "ingest_rejected": 1}
        assert dst._alloc.used_count == 0


# ---------------------------------------------------------------------------
# the staging pool
# ---------------------------------------------------------------------------

def test_staging_pool_roundtrips_and_reuses_its_slabs():
    """Planes go down and up through the pool bit for bit (bf16 as its
    bits), the pool grows a slab to the largest payload and reuses it,
    and it keeps at most ``MAX_SLABS`` slabs."""
    pool = PinnedStaging(torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    planes = {"k": torch.randn(2, 3, 4, generator=g).to(torch.bfloat16),
              "s": torch.rand(2, 3, generator=g)}
    host = pool.download(planes).arrays()
    assert host["k"].dtype == np.uint16 and host["s"].dtype == np.float32
    assert host["k"].tobytes() == planes["k"].view(torch.int16).numpy(
    ).tobytes()
    back = pool.upload(host, {"k": torch.bfloat16, "s": torch.float32})
    assert torch.equal(back["k"], planes["k"])
    assert torch.equal(back["s"], planes["s"])
    allocs = pool.counts["allocs"]
    for _ in range(5):
        pool.upload(host, {"k": torch.bfloat16, "s": torch.float32})
        pool.download(planes).arrays()
    assert pool.counts["allocs"] == allocs          # reused
    big = {"k": torch.zeros(64, 64)}
    pool.download(big).arrays()
    assert pool.counts["allocs"] == allocs + 1      # grown once
    lent = [pool.download(planes) for _ in range(4)]
    for dl in lent:
        dl.release()
    assert len(pool._idle) <= MAX_SLABS and pool._lent == 0
    with pytest.raises(ValueError):
        pool.upload({"k": np.zeros(4, np.float32)}, {"k": torch.int8})
    # the copy-out handed to the worker (here, on the CPU, done at once)
    later, ready = pool.download(planes).arrays_later()
    settle({"_ready": ready})
    assert ready.is_set()
    assert {k: v.tobytes() for k, v in later.items()} == \
        {k: v.tobytes() for k, v in host.items()}


def test_export_views_the_slab_until_released(params):
    """An export's handle lends the pinned slab: the snapshot holds the
    chain's bytes even if the engine decodes meanwhile, and encoding
    gives the same bytes as the whole export."""
    _, tp = params
    eng, _ = fabric_engine(tp, host_bytes=0, prefix_blocks=4)
    eng.submit([7] * 16 + [1], 2, cache_prefix=True)
    eng.drain()
    digest = chain_digest([7] * 16)
    handle = eng.export_chain_begin(digest)
    r = eng.submit([4, 5, 6], 6)
    eng.drain()
    assert r is not None
    assert eng.export_chain_finish(handle) == eng.export_chain(digest)
    assert eng._staging._lent == 0


def test_staging_pool_under_concurrent_copies():
    """Threads (more than cores) copying down and up through one pool at
    once, the interpreter switching every microsecond: every copy keeps
    its bytes, every slab goes back, and the pool keeps at most
    ``MAX_SLABS``."""
    import os
    import sys
    import threading

    pool = PinnedStaging(torch.device("cpu"))
    errors = []

    def worker(i):
        try:
            g = torch.Generator().manual_seed(i)
            for n in range(20):
                t = torch.randn(3 + (i + n) % 5, 64, generator=g)
                dl = pool.download({"t": t})
                if n % 2:
                    got = dl.arrays()["t"]
                else:
                    got = dl.views()["t"].copy()
                    dl.release()
                assert got.tobytes() == t.numpy().tobytes()
                up = pool.upload({"t": got}, {"t": torch.float32})["t"]
                assert torch.equal(up, t)
        except Exception as e:          # reported after the join
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(2 * (os.cpu_count() or 2) + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[0]
    assert pool._lent == 0 and len(pool._idle) <= MAX_SLABS
    assert pool.counts["downloads"] == pool.counts["uploads"] == \
        20 * len(threads)
