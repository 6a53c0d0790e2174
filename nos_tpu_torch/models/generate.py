"""Autoregressive decoding with a KV cache (port of the serving slice of
``nos_tpu/models/generate.py``).

PyTorch runs eagerly, so the reference's ``lax.scan`` over layers is a
Python loop and its donated caches are updated IN PLACE: ``forward_*``
write K/V into the cache tensors they are given and return the same
dict with a new ``pos``. Layouts are the reference's: slot-static k/v
``[L, B, Hkv, max_len, D]``, paged arena ``[L, NB, Hkv, bs, D]`` (+ f32
scale planes ``[L, NB, Hkv, bs]`` under int8), block 0 the null block.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from nos_tpu_torch.device import DeviceLike, resolve_device
from nos_tpu_torch.models.transformer import Params, TransformerConfig
from nos_tpu_torch.ops.attention import (
    _cached_attention, effective_paged_impl, paged_decode_attention,
    paged_decode_attention_reference, paged_scatter_kv, paged_scatter_scale,
    quantize_kv,
)
from nos_tpu_torch.ops.layers import (
    apply_rope, rms_norm, rope_frequencies, swiglu,
)
from nos_tpu_torch.ops.quant import embed_lookup, qdot
from nos_tpu_torch.utils import prng

__all__ = ["init_cache", "init_paged_cache", "forward_with_cache",
           "forward_paged", "generate", "generate_paged",
           "replicated_logits"]

Cache = Dict[str, torch.Tensor]


def init_cache(cfg: TransformerConfig, batch: int,
               max_len: Optional[int] = None, dtype=None,
               per_row_pos: bool = False,
               device: DeviceLike = None) -> Cache:
    """Pre-allocated KV cache: k/v [L, B, Hkv, max_len, head_dim] plus
    the write position, a scalar (rows in lockstep) or, with
    ``per_row_pos``, a [B] vector."""
    device = resolve_device(device)
    max_len = max_len or cfg.max_seq
    if max_len > cfg.max_seq:
        raise ValueError(
            f"cache max_len {max_len} exceeds the rope table "
            f"(cfg.max_seq {cfg.max_seq})")
    dtype = dtype or cfg.dtype
    shape = (cfg.n_layers, batch, cfg.kv_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((batch,) if per_row_pos else (),
                           dtype=torch.int32, device=device),
    }


def init_paged_cache(cfg: TransformerConfig, kv_blocks: int,
                     block_size: int, batch: int, dtype=None,
                     kv_dtype: str = "bf16",
                     device: DeviceLike = None) -> Cache:
    """Pooled paged KV arena k/v [L, kv_blocks, Hkv, block_size,
    head_dim] shared by every slot through block tables, plus the
    per-row write position ``pos`` [batch]. ``kv_dtype="int8"`` stores
    the arena quantized with f32 ``k_scale``/``v_scale`` planes
    [L, kv_blocks, Hkv, block_size]."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    shape = (cfg.n_layers, kv_blocks, cfg.kv_heads, block_size,
             cfg.head_dim)
    if kv_dtype not in ("bf16", "int8"):
        raise ValueError(
            f"kv_dtype must be bf16|int8, got {kv_dtype!r}")
    cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if kv_dtype == "int8":
        for name in ("k", "v"):
            cache[name] = torch.zeros(shape, dtype=torch.int8, device=device)
            cache[f"{name}_scale"] = torch.zeros(
                shape[:-1], dtype=torch.float32, device=device)
    else:
        for name in ("k", "v"):
            cache[name] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def replicated_logits(step: torch.Tensor, mesh=None) -> torch.Tensor:
    """A logit row canonicalized for a sampling decision: f32. The
    reference also pins it replicated under a mesh; meshes are not
    ported, so one is refused."""
    _refuse_mesh(mesh)
    return step.float()


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise ValueError(
            "mesh is not ported to the torch port yet (tensor-parallel "
            "serving)")


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


def _mlp_residual(x: torch.Tensor, layer: dict) -> torch.Tensor:
    h2 = rms_norm(x, layer["mlp_norm"])
    return x + swiglu(h2, layer["w_gate"], layer["w_up"], layer["w_down"])


def _qkv(x: torch.Tensor, layer: dict, cfg: TransformerConfig, freqs,
         positions: torch.Tensor):
    """Normed projections with rope: q [B, S, H, D], k/v [B, S, Hkv, D]."""
    b, s, _ = x.shape
    h = rms_norm(x, layer["attn_norm"])
    q = qdot(h, layer["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = qdot(h, layer["wk"]).reshape(b, s, cfg.kv_heads, cfg.head_dim)
    v = qdot(h, layer["wv"]).reshape(b, s, cfg.kv_heads, cfg.head_dim)
    return (apply_rope(q, freqs, positions), apply_rope(k, freqs, positions),
            v)


def _logits(x: torch.Tensor, params: Params) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"])
    return qdot(x, params["unembed"]).float()


def forward_paged(
    params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
    cache: Cache, table: torch.Tensor, *,
    paged_impl: Optional[str] = None,
) -> Tuple[torch.Tensor, Cache]:
    """``forward_with_cache`` over a paged arena: tokens [B, S] (the
    next S tokens after each row's ``cache['pos']``), block tables
    [B, nb] int32 -> (logits [B, S, vocab] f32, cache). K/V writes
    scatter into the arena in place (quantized under int8); attention
    runs the ``paged_decode_attention`` kernel (``paged_impl="kernel"``)
    or the gather formulation (``"xla"``); None reads
    ``effective_paged_impl``. The mesh path is not ported."""
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

    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        ck, cv = cache["k"][i], cache["v"][i]               # arena views
        cks = cvs = None
        q, k, v = _qkv(x, layer, cfg, freqs, positions)
        kt = k.transpose(1, 2)                              # [B, Hkv, S, D]
        vt = v.transpose(1, 2)
        if int8_kv:
            cks, cvs = cache["k_scale"][i], cache["v_scale"][i]
            kq, ksc = quantize_kv(kt)
            vq, vsc = quantize_kv(vt)
            paged_scatter_kv(ck, table, pos0, kq)
            paged_scatter_kv(cv, table, pos0, vq)
            paged_scatter_scale(cks, table, pos0, ksc)
            paged_scatter_scale(cvs, table, pos0, vsc)
        else:
            paged_scatter_kv(ck, table, pos0, kt)
            paged_scatter_kv(cv, table, pos0, vt)
        qt = q.transpose(1, 2).contiguous()                 # [B, H, S, D]
        attend = (paged_decode_attention if use_kernel
                  else paged_decode_attention_reference)
        o = attend(qt, ck, cv, table, pos0, k_scale=cks, v_scale=cvs,
                   scale=scale)
        o = o.transpose(1, 2).reshape(b, s, cfg.d_model)
        x = x + qdot(o, layer["wo"])
        x = _mlp_residual(x, layer)
    out = dict(cache)
    out["pos"] = pos0 + s
    return _logits(x, params), out


def forward_with_cache(
    params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
    cache: Cache,
) -> Tuple[torch.Tensor, Cache]:
    """tokens [B, S] (the next S tokens after cache['pos']) -> (logits
    [B, S, vocab] f32, cache). A [B]-vector ``pos`` lets every row sit
    at its own depth. K/V are written into the cache in place."""
    b, s = tokens.shape
    pos0 = cache["pos"]
    vector = pos0.ndim == 1
    freqs = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                             tokens.device)
    steps = torch.arange(s, device=tokens.device)
    positions = (pos0.long()[:, None] + steps[None, :] if vector
                 else pos0.long() + steps)
    scale = cfg.head_dim ** -0.5
    starts = pos0.tolist() if vector else None
    start = None if vector else int(pos0)

    x = embed_lookup(params["embed"], tokens, cfg.dtype)
    for i in range(cfg.n_layers):
        layer = _layer(params, i)
        ck, cv = cache["k"][i], cache["v"][i]               # [B, Hkv, T, D]
        q, k, v = _qkv(x, layer, cfg, freqs, positions)
        kt = k.transpose(1, 2)
        vt = v.transpose(1, 2)
        if vector:
            for row, p in enumerate(starts):
                ck[row, :, p:p + s] = kt[row]
                cv[row, :, p:p + s] = vt[row]
        else:
            ck[:, :, start:start + s] = kt
            cv[:, :, start:start + s] = vt
        o = _cached_attention(q.transpose(1, 2), ck, cv, positions, scale)
        o = o.transpose(1, 2).reshape(b, s, cfg.d_model)
        x = x + qdot(o, layer["wo"])
        x = _mlp_residual(x, layer)
    out = dict(cache)
    out["pos"] = pos0 + s
    return _logits(x, params), out


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
    stream. A mesh is refused (not ported)."""
    device = resolve_device(device)
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
    _refuse_mesh(mesh)
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

    cache = init_cache(cfg, b, max_len, device=device)
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
    device: DeviceLike = None,
) -> torch.Tensor:
    """Reference GREEDY generation through the paged KV path: prompt
    [B, S] -> [B, S + max_new_tokens], over an arena where row i owns
    blocks [1 + i*nb, 1 + (i+1)*nb) (block 0 stays the null block). The
    oracle the serving engine is held against: prefill and decode steps
    run the same ``forward_paged`` formulation serving runs."""
    device = resolve_device(device)
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
                             kv_dtype=kv_dtype, device=device)
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
