"""Autoregressive decoding with a KV cache (port of the serving slice of
``nos_tpu/models/generate.py``).

PyTorch runs eagerly, so the reference's ``lax.scan`` over layers is a
Python loop and its donated caches are updated IN PLACE: ``forward_*``
write K/V into the cache tensors they are given and return the same
dict with a new ``pos``. Layouts are the reference's: slot-static k/v
``[L, B, Hkv, max_len, D]``, paged arena ``[L, NB, Hkv, bs, D]`` (+ f32
scale planes ``[L, NB, Hkv, bs]`` under int8), block 0 the null block.

Tensor-parallel serving (the reference's ``mesh``): params split by
``transformer.shard_params`` over a ``parallel.mesh.TpMesh`` and a cache
made with ``mesh=`` (k/v, and the scale planes, ``HeadShards`` on the
head axis) run the same forwards shard by shard. Each shard projects its
q/k/v heads, rotates them, writes its K/V into its own slice of the
cache and attends over its own Hkv/tp heads (on the card the paged
kernel at that head count, no collective inside it: the reference's
``_paged_kernel_sharded``); one reduction follows the row-parallel o
product and one the down product (under MoE each expert's down product,
the gating computed once on shard 0 and its dispatch and combine handed
to every shard), the embedding is a masked lookup per
vocab shard plus a reduction, and the logits are the vocab shards
gathered into one f32 row on shard 0's device (``replicated_logits``),
where every sampling decision runs, so the sampled stream is the
single-device one.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from nos_tpu_torch.device import DeviceLike, resolve_device
from nos_tpu_torch.models.transformer import (
    Params, TpParams, TransformerConfig, shard_params,
)
from nos_tpu_torch.obs.tracing import device_range
from nos_tpu_torch.ops._kernels import PagedScratch
from nos_tpu_torch.ops.attention import (
    _cached_attention, effective_paged_impl, paged_decode_attention,
    paged_decode_attention_reference, paged_write_route, quantize_kv,
    scatter_kv_routed, scatter_scale_routed,
)
from nos_tpu_torch.ops.layers import (
    rms_norm, rope_frequencies, rope_rows, rotate, swiglu,
)
from nos_tpu_torch.ops.moe import moe_ffn, moe_ffn_tp
from nos_tpu_torch.ops.quant import QuantLinear, embed_lookup, qdot
from nos_tpu_torch.parallel.mesh import HeadShards, TpMesh, head_shards
from nos_tpu_torch.utils import prng

__all__ = ["init_cache", "init_paged_cache", "forward_with_cache",
           "forward_paged", "generate", "generate_paged",
           "replicated_logits"]

Cache = Dict[str, torch.Tensor]


def _planes(shape, dtype, device, mesh: Optional[TpMesh]):
    """A zero cache plane: one tensor, or under ``mesh`` its head axis
    (axis 2) split over the shards."""
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    return head_shards(shape, 2, mesh, dtype)


def init_cache(cfg: TransformerConfig, batch: int,
               max_len: Optional[int] = None, dtype=None,
               per_row_pos: bool = False,
               device: DeviceLike = None,
               mesh: Optional[TpMesh] = None) -> Cache:
    """Pre-allocated KV cache: k/v [L, B, Hkv, max_len, head_dim] plus
    the write position, a scalar (rows in lockstep) or, with
    ``per_row_pos``, a [B] vector. Under ``mesh`` k/v are split over its
    shards along the head axis (the reference's ``cache_shardings``) and
    ``pos`` lives on shard 0's device."""
    device = mesh.devices[0] if mesh is not None else resolve_device(device)
    max_len = max_len or cfg.max_seq
    if max_len > cfg.max_seq:
        raise ValueError(
            f"cache max_len {max_len} exceeds the rope table "
            f"(cfg.max_seq {cfg.max_seq})")
    dtype = dtype or cfg.dtype
    shape = (cfg.n_layers, batch, cfg.kv_heads, max_len, cfg.head_dim)
    return {
        "k": _planes(shape, dtype, device, mesh),
        "v": _planes(shape, dtype, device, mesh),
        "pos": torch.zeros((batch,) if per_row_pos else (),
                           dtype=torch.int32, device=device),
    }


def init_paged_cache(cfg: TransformerConfig, kv_blocks: int,
                     block_size: int, batch: int, dtype=None,
                     kv_dtype: str = "bf16",
                     device: DeviceLike = None,
                     mesh: Optional[TpMesh] = None) -> Cache:
    """Pooled paged KV arena k/v [L, kv_blocks, Hkv, block_size,
    head_dim] shared by every slot through block tables, plus the
    per-row write position ``pos`` [batch]. ``kv_dtype="int8"`` stores
    the arena quantized with f32 ``k_scale``/``v_scale`` planes
    [L, kv_blocks, Hkv, block_size]. Under ``mesh`` the arena and its
    scale planes are split over the shards along the head axis (the
    reference's ``paged_cache_shardings``); ``pos`` lives on shard 0's
    device, as the block tables do."""
    device = mesh.devices[0] if mesh is not None else resolve_device(device)
    dtype = dtype or cfg.dtype
    shape = (cfg.n_layers, kv_blocks, cfg.kv_heads, block_size,
             cfg.head_dim)
    if kv_dtype not in ("bf16", "int8"):
        raise ValueError(
            f"kv_dtype must be bf16|int8, got {kv_dtype!r}")
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if kv_dtype == "int8":
        for name in ("k", "v"):
            cache[name] = _planes(shape, torch.int8, device, mesh)
            cache[f"{name}_scale"] = _planes(shape[:-1], torch.float32,
                                             device, mesh)
    else:
        for name in ("k", "v"):
            cache[name] = _planes(shape, dtype, device, mesh)
    return cache


def replicated_logits(step: torch.Tensor, mesh=None) -> torch.Tensor:
    """A logit row canonicalized for a sampling decision: f32. Under a
    mesh the sharded forwards already return the vocab shards gathered
    into one row on shard 0's device, so sampling runs the single-device
    program on it (the reference pins the row replicated for the same
    reason: a vocab-sharded row drew other threefry bits)."""
    return step.float()


def _tempered(step: torch.Tensor, temperature: float) -> torch.Tensor:
    """``step / temperature`` in f32, as a true division: the divisor is
    a tensor on ``step``'s device, because the card divides by a Python
    scalar as a multiplication by its reciprocal, which rounds apart
    from the reference's division."""
    return step / torch.full((), temperature, dtype=torch.float32,
                             device=step.device)


def _truncate_logits(logits: torch.Tensor, top_k: int,
                     top_p: float) -> torch.Tensor:
    """Mask logits outside the top-k set and/or the top-p nucleus of
    ``softmax(logits)`` (callers pass already-tempered logits), with a
    scalar ``top_k``/``top_p`` shared by every row; a shape adapter over
    ``_truncate_logits_rows``. No-op when both are unset."""
    do_k = 0 < top_k < logits.shape[-1]
    do_p = 0.0 < top_p < 1.0
    if not (do_k or do_p):
        return logits
    shape = logits.shape
    flat = logits.reshape(-1, shape[-1])
    b = flat.shape[0]
    out = _truncate_logits_rows(
        flat, torch.full((b,), top_k, dtype=torch.long, device=flat.device),
        torch.full((b,), top_p, dtype=torch.float32, device=flat.device))
    return out.reshape(shape)


def _truncate_logits_rows(logits: torch.Tensor, top_k: torch.Tensor,
                          top_p: torch.Tensor) -> torch.Tensor:
    """Per-row top-k/top-p truncation of f32 ``logits`` [B, V]: ``top_k``
    [B] (0 = off) and ``top_p`` [B] (outside (0, 1) = off) vary by row.
    The reference's sequential semantics: top-k first, then the nucleus
    of what is left; rows with both filters off pass through."""
    b, v = logits.shape
    neg = torch.finfo(logits.dtype).min
    ar = torch.arange(v, device=logits.device)
    k_eff = torch.where((top_k > 0) & (top_k < v), top_k.long(), v)
    # off-rows get threshold 2.0 (not 1.0): cumsum float error must
    # never drop the least-likely token of an untruncated row
    p_eff = torch.where((top_p > 0.0) & (top_p < 1.0), top_p.float(), 2.0)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    sorted_desc = torch.where(ar[None, :] < k_eff[:, None], sorted_desc,
                              neg)
    kth = torch.gather(sorted_desc, 1, k_eff[:, None] - 1)
    logits = torch.where(logits >= kth, logits, neg)
    # softmax and running sum in f64, rounded once: torch's f32 ones
    # drift ~1.5e-6 over a 32000-token row, where XLA's stay within
    # ~3e-7 of the exact sum
    cum = torch.cumsum(torch.softmax(sorted_desc.double(), dim=-1),
                       dim=-1).float()
    before = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=-1)
    keep = before < p_eff[:, None]
    cutoff = torch.where(keep, sorted_desc,
                         torch.finfo(logits.dtype).max).amin(
                             dim=-1, keepdim=True)
    return torch.where(logits >= cutoff, logits, neg)


def _layer(params: Params, i: int) -> dict:
    """Layer ``i``'s slice of the stacked [L, ...] params."""
    return {k: v[i] for k, v in params["layers"].items()}


def _mlp_residual(x: torch.Tensor, layer: dict,
                  cfg: TransformerConfig) -> torch.Tensor:
    """The FFN sublayer + residual: the dense SwiGLU, or with
    ``cfg.n_experts`` the reference's top-2 MoE, whose capacity is taken
    over this call's S (the aux loss is dropped, as serving drops it)."""
    h2 = rms_norm(x, layer["mlp_norm"])
    if cfg.n_experts > 0:
        y, _aux = moe_ffn(h2, layer["w_router"], layer["w_gate"],
                          layer["w_up"], layer["w_down"],
                          cfg.expert_capacity_factor)
        return x + y
    return x + swiglu(h2, layer["w_gate"], layer["w_up"], layer["w_down"])


def _qkv(x: torch.Tensor, layer: dict, heads: int, kv_heads: int,
         head_dim: int, rope):
    """Normed projections with rope (``rope_rows``' pair, gathered once
    per forward): q [B, S, heads, D], k/v [B, S, kv_heads, D] (a shard's
    heads under a mesh)."""
    b, s, _ = x.shape
    h = rms_norm(x, layer["attn_norm"])
    q = qdot(h, layer["wq"]).reshape(b, s, heads, head_dim)
    k = qdot(h, layer["wk"]).reshape(b, s, kv_heads, head_dim)
    v = qdot(h, layer["wv"]).reshape(b, s, kv_heads, head_dim)
    return rotate(q, rope), rotate(k, rope), v


def _logits(x: torch.Tensor, params: Params) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"])
    return qdot(x, params["unembed"]).float()


def _embed_shard(table, tokens: torch.Tensor, r: int,
                 dtype) -> torch.Tensor:
    """Shard r's part of the embedding lookup: the rows of the tokens in
    its vocab slice, zero for the others (the reduction over the shards
    adds each row from the one shard that holds it)."""
    n = (table.q if isinstance(table, QuantLinear) else table).shape[0]
    local = tokens - r * n
    inside = (local >= 0) & (local < n)
    rows = embed_lookup(table, local.clamp(0, n - 1), dtype)
    return torch.where(inside[..., None], rows, torch.zeros_like(rows))


def _decoder(params, cfg: TransformerConfig, tokens: torch.Tensor, rope,
             attend) -> torch.Tensor:
    """The decoder around a forward's attention: embedding, each layer's
    q/k/v, ``attend(r, i, q, k, v)`` (shard r's layer i: writes its K/V,
    returns o [B, S, heads x D]), o, the FFN, the head -> logits [B, S,
    vocab] f32. Under ``TpParams`` every step runs shard by shard with
    the mesh's reductions and the logits' gather between them."""
    if isinstance(params, TpParams):
        return _decoder_tp(params, cfg, tokens, rope, attend)
    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        q, k, v = _qkv(x, layer, cfg.n_heads, cfg.kv_heads, cfg.head_dim,
                       rope)
        x = x + qdot(_attend_ranged(attend, 0, i, q, k, v), layer["wo"])
        x = _mlp_residual(x, layer, cfg)
    return _logits(x, params)


def _attend_ranged(attend, r: int, i: int, q, k, v) -> torch.Tensor:
    """``attend(r, i, q, k, v)`` inside the ``model.attention`` profiler
    range. A call of its own, so that the caller holds no name on the
    output and it is freed after the o product, before the FFN."""
    with device_range("model.attention"):
        return attend(r, i, q, k, v)


def _decoder_tp(params: TpParams, cfg: TransformerConfig,
                tokens: torch.Tensor, rope, attend) -> torch.Tensor:
    """``_decoder`` over ``params.mesh``: the residual stream lives on
    shard 0's device and is broadcast before each sublayer; each shard
    runs its heads (and its d_ff slice, of each expert's under MoE), and
    its partial o and down products are reduced (``TpMesh.reduce``)."""
    mesh, shards = params.mesh, params.shards
    tp = mesh.tp
    heads, kv_heads = cfg.n_heads // tp, cfg.kv_heads // tp
    ropes = [tuple(t.to(d) for t in rope) for d in mesh.devices]
    x = mesh.reduce([_embed_shard(p["embed"], t, r, cfg.dtype)
                     for r, (p, t) in enumerate(
                         zip(shards, mesh.broadcast(tokens)))])
    for i in range(cfg.n_layers):
        layers = [_layer(p, i) for p in shards]
        parts = []
        for r, (layer, xr) in enumerate(zip(layers, mesh.broadcast(x))):
            q, k, v = _qkv(xr, layer, heads, kv_heads, cfg.head_dim,
                           ropes[r])
            parts.append(qdot(_attend_ranged(attend, r, i, q, k, v),
                              layer["wo"]))
        x = x + mesh.reduce(parts)
        x = x + _mlp_tp(x, layers, cfg, mesh)
    return mesh.gather([_logits(xr, p)
                        for p, xr in zip(shards, mesh.broadcast(x))], -1)


def _mlp_tp(x: torch.Tensor, layers: List[dict], cfg: TransformerConfig,
            mesh: TpMesh) -> torch.Tensor:
    """The FFN sublayer's output over the mesh (``_mlp_residual`` without
    the residual): each shard's d_ff slice of the dense SwiGLU, or with
    ``cfg.n_experts`` of every expert's (``moe_ffn_tp``: the gating once,
    on shard 0, over the replicated router), the partials reduced."""
    if cfg.n_experts > 0:
        h = rms_norm(x, layers[0]["mlp_norm"])
        y, _aux = moe_ffn_tp(
            h, layers[0]["w_router"],
            [(la["w_gate"], la["w_up"], la["w_down"]) for la in layers],
            mesh, cfg.expert_capacity_factor)
        return y
    return mesh.reduce([
        swiglu(rms_norm(xr, layer["mlp_norm"]), layer["w_gate"],
               layer["w_up"], layer["w_down"])
        for layer, xr in zip(layers, mesh.broadcast(x))])


def _shard_planes(cache: Cache, names, r: int, i: int):
    """Layer ``i`` of shard r's slice of each named cache plane (the
    whole plane without a mesh), None for a plane the cache lacks."""
    out = []
    for name in names:
        t = cache.get(name)
        if isinstance(t, HeadShards):
            t = t.parts[r]
        out.append(None if t is None else t[i])
    return out


def _on_devices(params, tensors: tuple) -> list:
    """``tensors`` on each shard's device (a one-entry list without a
    mesh); None entries stay None."""
    if not isinstance(params, TpParams):
        return [tensors]
    return [tuple(t.to(d) if isinstance(t, torch.Tensor) else t
                  for t in tensors) for d in params.mesh.devices]


def forward_paged(
    params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
    cache: Cache, table: torch.Tensor, *,
    paged_impl: Optional[str] = None,
    scratch: Optional[PagedScratch] = None,
) -> Tuple[torch.Tensor, Cache]:
    """``forward_with_cache`` over a paged arena: tokens [B, S] (the
    next S tokens after each row's ``cache['pos']``), block tables
    [B, nb] int32 -> (logits [B, S, vocab] f32, cache). K/V writes
    scatter into the arena in place (quantized under int8); attention
    runs the ``paged_decode_attention`` kernel (``paged_impl="kernel"``)
    or the gather formulation (``"xla"``); None reads
    ``effective_paged_impl``; ``scratch`` is the kernel's split-merge
    scratch when the caller keeps its own (a CUDA graph's owner; on a
    mesh, where each shard's launches take the kernel's default, pass
    None). With ``TpParams`` and a ``mesh=`` arena every shard writes
    and attends over its own heads (the reference's mesh path)."""
    b, s = tokens.shape
    if paged_impl is None:
        paged_impl = effective_paged_impl()
    use_kernel = paged_impl == "kernel"
    pos0 = cache["pos"]                                     # [B]
    int8_kv = "k_scale" in cache
    freqs = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                             tokens.device)
    positions = pos0.long()[:, None] + torch.arange(
        s, device=tokens.device)[None, :]                   # [B, S]
    scale = cfg.head_dim ** -0.5
    # what every layer shares, computed once: the rope rows and the
    # arena slots this call's K/V land in. A pipelined engine's overrun
    # ticks (a finished request not yet observed) may run past the rope
    # table; their rows are clamped, as the reference's gather clamps,
    # and their output is discarded.
    rope = rope_rows(freqs, positions.clamp(max=cfg.max_seq - 1))
    route = paged_write_route(table, pos0, s, cache["k"].shape[3],
                              cache["k"].shape[1])
    per_shard = _on_devices(params, (*route, table, pos0))

    def attend(r, i, q, k, v):
        ck, cv, cks, cvs = _shard_planes(
            cache, ("k", "v", "k_scale", "v_scale"), r, i)
        *route_r, table_r, pos_r = per_shard[r]
        kt = k.transpose(1, 2)                              # [B, Hkv, S, D]
        vt = v.transpose(1, 2)
        if int8_kv:
            kq, ksc = quantize_kv(kt)
            vq, vsc = quantize_kv(vt)
            scatter_kv_routed(ck, route_r, kq)
            scatter_kv_routed(cv, route_r, vq)
            scatter_scale_routed(cks, route_r, ksc)
            scatter_scale_routed(cvs, route_r, vsc)
        else:
            scatter_kv_routed(ck, route_r, kt)
            scatter_kv_routed(cv, route_r, vt)
        qt = q.transpose(1, 2).contiguous()                 # [B, H, S, D]
        if use_kernel:
            o = paged_decode_attention(qt, ck, cv, table_r, pos_r,
                                       k_scale=cks, v_scale=cvs,
                                       scale=scale, scratch=scratch)
        else:
            o = paged_decode_attention_reference(
                qt, ck, cv, table_r, pos_r, k_scale=cks, v_scale=cvs,
                scale=scale)
        return o.transpose(1, 2).reshape(b, s, -1)

    logits = _decoder(params, cfg, tokens, rope, attend)
    out = dict(cache)
    out["pos"] = pos0 + s
    return logits, out


def forward_with_cache(
    params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
    cache: Cache,
) -> Tuple[torch.Tensor, Cache]:
    """tokens [B, S] (the next S tokens after cache['pos']) -> (logits
    [B, S, vocab] f32, cache). A [B]-vector ``pos`` lets every row sit
    at its own depth. K/V are written into the cache in place, at a
    start clamped to ``max_len - S`` as the reference's
    ``dynamic_update_slice`` clamps it; the rope rows and the causal mask
    take the unclamped positions (the rope rows clamped to the table, as
    the reference's gather clamps). With a vector ``pos`` the write is
    one device-side scatter per plane: no host sync, so a decode program
    over it can be captured as a CUDA graph. With ``TpParams`` and a
    ``mesh=`` cache every shard writes and attends over its own
    heads."""
    b, s = tokens.shape
    pos0 = cache["pos"]
    vector = pos0.ndim == 1
    max_len = cache["k"].shape[3]
    freqs = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                             tokens.device)
    steps = torch.arange(s, device=tokens.device)
    positions = (pos0.long()[:, None] + steps[None, :] if vector
                 else pos0.long() + steps)
    scale = cfg.head_dim ** -0.5
    rows = slots = None
    if vector:
        # each row's write slots [B, S], the row index broadcast beside
        start = pos0.long().clamp(max=max_len - s)
        slots = start[:, None] + steps[None, :]
        rows = torch.arange(b, device=tokens.device)[:, None]
    else:
        start = min(int(pos0), max_len - s)
    rope = rope_rows(freqs, positions.clamp(max=cfg.max_seq - 1))
    per_shard = _on_devices(params, (rows, slots, positions))

    def attend(r, i, q, k, v):
        ck, cv = _shard_planes(cache, ("k", "v"), r, i)     # [B, Hkv, T, D]
        rows_r, slots_r, positions_r = per_shard[r]
        if vector:
            # advanced indices around the head slice: the indexed view
            # is [B, S, Hkv, D], k/v's own layout
            ck[rows_r, :, slots_r] = k.to(ck.dtype)
            cv[rows_r, :, slots_r] = v.to(cv.dtype)
        else:
            ck[:, :, start:start + s] = k.transpose(1, 2)
            cv[:, :, start:start + s] = v.transpose(1, 2)
        o = _cached_attention(q.transpose(1, 2), ck, cv, positions_r, scale)
        return o.transpose(1, 2).reshape(b, s, -1)

    logits = _decoder(params, cfg, tokens, rope, attend)
    out = dict(cache)
    out["pos"] = pos0 + s
    return logits, out


def _on_mesh(params, cfg: TransformerConfig, mesh: Optional[TpMesh]):
    """(params, mesh) for a generate call: plain params split over
    ``mesh`` when one is given; split params bring their own."""
    if isinstance(params, TpParams):
        return params, params.mesh
    if mesh is not None:
        return shard_params(params, cfg, check_mesh(mesh)), mesh
    return params, None


def check_mesh(mesh) -> TpMesh:
    """``mesh`` when it is the port's serving mesh, else a ValueError
    (the reference's ``jax.sharding.Mesh`` does not carry over)."""
    if not isinstance(mesh, TpMesh):
        raise ValueError(
            f"mesh must be a nos_tpu_torch.parallel.mesh.TpMesh, got "
            f"{type(mesh).__name__}")
    return mesh


def _prompt_tensor(prompt: Union[torch.Tensor, Sequence[Sequence[int]]],
                   device: torch.device) -> torch.Tensor:
    return torch.as_tensor(prompt, dtype=torch.long, device=device)


def generate(
    params: Params, cfg: TransformerConfig,
    prompt: Union[torch.Tensor, List[List[int]]], max_new_tokens: int, *,
    temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
    rng: Optional[torch.Tensor] = None, max_len: Optional[int] = None,
    mesh=None, device: DeviceLike = None,
) -> torch.Tensor:
    """Greedy (temperature 0) or temperature sampling, optionally
    truncated to the ``top_k`` most likely tokens and/or the smallest
    ``top_p``-mass nucleus, over the slot-static cache: prompt [B, S] ->
    [B, S + max_new_tokens]. ``rng`` is a ``utils.prng`` key; step i
    samples with ``split(rng, max_new_tokens)[i]``, the reference's
    stream. With ``mesh`` (a ``TpMesh``; or ``TpParams``) it runs
    tensor-parallel, on the mesh's devices."""
    params, mesh = _on_mesh(params, cfg, mesh)
    device = mesh.devices[0] if mesh is not None else resolve_device(device)
    prompt = _prompt_tensor(prompt, device)
    b, s = prompt.shape
    if max_new_tokens <= 0:
        return prompt
    max_len = max_len or cfg.max_seq
    if s + max_new_tokens > max_len:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"cache length {max_len}")
    if temperature > 0 and rng is None:
        raise ValueError("temperature sampling needs an rng key")
    if temperature <= 0 and (top_k or top_p):
        raise ValueError(
            "top_k/top_p only apply when sampling — set temperature > 0 "
            "(greedy decoding ignores truncation)")
    if top_k < 0 or not (0.0 <= top_p <= 1.0):
        raise ValueError(
            f"top_k must be >= 0 and top_p in [0, 1] (a probability, "
            f"not a percent): got top_k={top_k}, top_p={top_p}")
    keys = (prng.split(rng.to(device), max_new_tokens)
            if rng is not None else None)

    def pick(step: torch.Tensor, i: int) -> torch.Tensor:
        if temperature > 0:
            # temperature first, truncation second: the nucleus covers
            # the distribution actually sampled from
            step = _truncate_logits(
                _tempered(replicated_logits(step), temperature),
                top_k, top_p)
            return prng.categorical(keys[i], step)
        return torch.argmax(step, dim=-1)

    cache = init_cache(cfg, b, max_len, device=device, mesh=mesh)
    logits, cache = forward_with_cache(params, cfg, prompt, cache)
    tok = pick(logits[:, -1], 0)
    out = [tok]
    for i in range(1, max_new_tokens):
        logits, cache = forward_with_cache(params, cfg, tok[:, None], cache)
        tok = pick(logits[:, -1], i)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)


def generate_paged(
    params: Params, cfg: TransformerConfig,
    prompt: Union[torch.Tensor, List[List[int]]], max_new_tokens: int, *,
    block_size: int, kv_dtype: str = "bf16",
    max_len: Optional[int] = None, paged_impl: Optional[str] = None,
    mesh: Optional[TpMesh] = None, device: DeviceLike = None,
) -> torch.Tensor:
    """Reference GREEDY generation through the paged KV path: prompt
    [B, S] -> [B, S + max_new_tokens], over an arena where row i owns
    blocks [1 + i*nb, 1 + (i+1)*nb) (block 0 stays the null block). The
    oracle the serving engine is held against: prefill and decode steps
    run the same ``forward_paged`` formulation serving runs. With
    ``mesh`` (or ``TpParams``) it runs tensor-parallel over the mesh's
    arena shards."""
    params, mesh = _on_mesh(params, cfg, mesh)
    device = mesh.devices[0] if mesh is not None else resolve_device(device)
    prompt = _prompt_tensor(prompt, device)
    b, s = prompt.shape
    if max_new_tokens <= 0:
        return prompt
    max_len = max_len or cfg.max_seq
    if s + max_new_tokens > max_len:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"cache length {max_len}")
    if max_len % block_size:
        raise ValueError(
            f"max_len {max_len} must be a multiple of block_size "
            f"{block_size}")
    nb = max_len // block_size
    cache = init_paged_cache(cfg, 1 + b * nb, block_size, b,
                             kv_dtype=kv_dtype, device=device, mesh=mesh)
    table = (1 + torch.arange(b * nb, dtype=torch.int32, device=device)
             ).reshape(b, nb)
    logits, cache = forward_paged(params, cfg, prompt, cache, table,
                                  paged_impl=paged_impl)
    tok = torch.argmax(logits[:, -1], dim=-1)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = forward_paged(params, cfg, tok[:, None], cache,
                                      table, paged_impl=paged_impl)
        tok = torch.argmax(logits[:, -1], dim=-1)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
