"""Attention ops (port of ``nos_tpu/ops/attention.py``): the paged
decode half the serving slice runs and the causal/full flash attention
the training path runs.

Layouts are the reference's: a paged arena is ``[NB, Hkv, bs, D]`` per
layer (``[L, NB, Hkv, bs, D]`` in the cache), int8 scale planes
``[NB, Hkv, bs]`` f32, block tables ``[B, nb]`` int32 whose entry 0 is
the reserved null block.

``paged_decode_attention`` is the wrapper of the hand-written CUDA
kernel (``csrc/paged_decode_attention.cu``): on a CUDA tensor it
launches the kernel, on a CPU tensor it runs
``paged_decode_attention_reference``, the gather + masked-softmax
formulation the reference itself uses as its oracle. The scatters
update the arena IN PLACE where the reference's jitted programs donated
it.

``attention`` is the counterpart of the reference's dispatch between its
two Pallas library kernels, splash and flash: both map to one
hand-written CUDA kernel family (``csrc/flash_attention.cu``, forward
and backward) behind a ``torch.autograd.Function``, with
``flash_attention_reference`` / ``flash_attention_backward_reference``
as the plain versions the CPU runs.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from nos_tpu_torch.ops import _kernels

__all__ = ["attention", "effective_impl", "flash_attention_reference",
           "flash_attention_backward_reference", "flash_attention_backward",
           "check_attention_head_dim", "xla_attention", "paged_gather_kv",
           "paged_gather_scale", "paged_scatter_kv", "paged_scatter_scale",
           "quantize_kv", "dequantize_kv", "paged_decode_attention",
           "paged_decode_attention_reference", "effective_paged_impl",
           "check_paged_kernel_head_dim"]

_NEG = torch.finfo(torch.float32).min


def _grouped_scores(q: torch.Tensor, k: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """q [B, H, S, D], k [B, Hkv, T, D] -> f32 scores [B, Hkv, g, S, T]
    with query heads grouped per kv head (no K repeat); products and
    sums in f32, the reference's ``preferred_element_type``."""
    b, h, s, d = q.shape
    h_kv = k.shape[1]
    qg = q.reshape(b, h_kv, h // h_kv, s, d).float()
    return torch.matmul(qg, k.float().unsqueeze(2).transpose(-1, -2)) * scale


def _grouped_pv(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs [B, Hkv, g, S, T] (in q's dtype), v [B, Hkv, T, D] ->
    [B, H, S, D]."""
    b, h_kv, g, s, _ = probs.shape
    out = torch.matmul(probs, v.unsqueeze(2))
    return out.reshape(b, h_kv * g, s, v.shape[-1])


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Reference attention. q: [B, H, S, D]; k, v: [B, Hkv, S, D] with
    H % Hkv == 0 -> [B, H, S, D]."""
    s_q, d = q.shape[2], q.shape[3]
    scale = scale if scale is not None else d ** -0.5
    scores = _grouped_scores(q, k, scale)
    if causal:
        s_k = scores.shape[-1]
        mask = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril(s_k - s_q)
        scores = torch.where(mask, scores, _NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _grouped_pv(probs, v)


def _cached_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      positions: torch.Tensor, scale: float) -> torch.Tensor:
    """q: [B, H, S, D] at absolute ``positions`` ([S] or [B, S]); ck/cv:
    [B, Hkv, T, D]. Causal against the cache timeline: the query at
    position p attends to slots [0, p]. Masked with finfo(f32).min, not
    -inf, and the probabilities cast to q's dtype before the PV product
    (``nos_tpu/models/generate.py::_cached_attention``)."""
    scores = _grouped_scores(q, ck, scale)
    t = ck.shape[2]
    mask = torch.arange(t, device=q.device) <= positions[..., None]
    if mask.ndim == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores, _NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _grouped_pv(probs, cv)


def paged_gather_kv(arena: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """arena [NB, Hkv, bs, D], table [B, nb] -> each row's contiguous
    timeline [B, Hkv, nb*bs, D]."""
    _, h_kv, bs, d = arena.shape
    b, nb = table.shape
    view = arena[table]                     # [B, nb, Hkv, bs, D]
    return view.permute(0, 2, 1, 3, 4).reshape(b, h_kv, nb * bs, d)


def paged_gather_scale(scales: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """scales [NB, Hkv, bs] -> [B, Hkv, nb*bs]."""
    _, h_kv, bs = scales.shape
    b, nb = table.shape
    view = scales[table]                    # [B, nb, Hkv, bs]
    return view.permute(0, 2, 1, 3).reshape(b, h_kv, nb * bs)


def quantize_kv(vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per (…, token) over the head_dim axis: vals
    [..., T, D] -> (q int8 [..., T, D], scale f32 [..., T]); scale =
    amax/127, and 1 for an all-zero vector."""
    v32 = vals.float()
    amax = v32.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(v32 / scale[..., None]), -127, 127
                    ).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``quantize_kv``: an f32 multiply, then ONE cast."""
    return (q.float() * scale[..., None]).to(dtype)


def _route_paged_writes(table: torch.Tensor, pos: torch.Tensor, s: int,
                        bs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions pos..pos+s-1 on each row's timeline -> (phys [B, S]
    physical block ids, offs [B, S] within-block offsets). Out-of-range
    logical blocks route to the null block 0."""
    nb = table.shape[1]
    offs = pos.long()[:, None] + torch.arange(s, device=pos.device)[None, :]
    logical = torch.div(offs, bs, rounding_mode="floor")
    phys = torch.where(
        logical < nb,
        torch.gather(table.long(), 1, torch.clamp(logical, max=nb - 1)),
        torch.zeros_like(logical))
    return phys, offs % bs


def paged_scatter_kv(arena: torch.Tensor, table: torch.Tensor,
                     pos: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Write vals [B, Hkv, S, D] at positions pos..pos+S-1 of each row's
    timeline into arena [NB, Hkv, bs, D] IN PLACE (the reference donates
    the arena); returns it. Rows routed to the null block may collide
    there; its content is never read unmasked."""
    phys, offs = _route_paged_writes(table, pos, vals.shape[2],
                                     arena.shape[2])
    arena[phys, :, offs, :] = vals.permute(0, 2, 1, 3).to(arena.dtype)
    return arena


def paged_scatter_scale(scales: torch.Tensor, table: torch.Tensor,
                        pos: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Scale-plane twin of ``paged_scatter_kv``: vals [B, Hkv, S] into
    scales [NB, Hkv, bs] IN PLACE, same routing."""
    phys, offs = _route_paged_writes(table, pos, vals.shape[2],
                                     scales.shape[2])
    scales[phys, :, offs] = vals.permute(0, 2, 1)
    return scales


def effective_paged_impl() -> str:
    """Which paged attention formulation ``forward_paged`` dispatches:
    "kernel" (``paged_decode_attention``) or "xla" (gather + masked
    softmax). ``NOS_TPU_TORCH_PAGED_KERNEL`` (default "1") selects the
    kernel. On CPU tensors the kernel wrapper runs the plain version;
    on CUDA tensors it launches the kernel or raises."""
    if os.environ.get("NOS_TPU_TORCH_PAGED_KERNEL", "1") != "1":
        return "xla"
    return "kernel"


def check_paged_kernel_head_dim(head_dim: int, device: torch.device,
                                impl: str) -> None:
    """Raise a ValueError naming ``head_dim`` when the kernel formulation
    is selected on the card for a head dim the CUDA kernel is not built
    for (64 and 128, the reference's own gate), so an engine refuses at
    build instead of failing on its first decode tick."""
    if (impl == "kernel" and device.type == "cuda"
            and head_dim not in _kernels.HEAD_DIMS):
        raise ValueError(
            f"head_dim {head_dim} is not one the CUDA paged attention "
            f"kernel takes {_kernels.HEAD_DIMS}: pick widths with such a "
            f"head_dim, or serve with paged_kernel='off' "
            f"(NOS_TPU_TORCH_PAGED_KERNEL=0)")


def paged_decode_attention_reference(
    q: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
    table: torch.Tensor, pos: torch.Tensor, *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's plain PyTorch version: gather each row's timeline
    (dequantizing an int8 arena with ``dequantize_kv``'s rule into q's
    dtype), then ``_cached_attention``'s masked softmax at positions
    pos..pos+S-1."""
    s, d = q.shape[2], q.shape[3]
    gk = paged_gather_kv(k_arena, table)
    gv = paged_gather_kv(v_arena, table)
    if k_scale is not None:
        gk = dequantize_kv(gk, paged_gather_scale(k_scale, table), q.dtype)
        gv = dequantize_kv(gv, paged_gather_scale(v_scale, table), q.dtype)
    positions = pos.long()[:, None] + torch.arange(s, device=q.device)[None]
    return _cached_attention(q, gk, gv, positions,
                             scale if scale is not None else d ** -0.5)


def paged_decode_attention(
    q: torch.Tensor, k_arena: torch.Tensor, v_arena: torch.Tensor,
    table: torch.Tensor, pos: torch.Tensor, *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Paged attention of an S-wide query window walked by block table
    (``nos_tpu/ops/attention.py::paged_decode_attention`` without its
    ``interpret`` switch: a CUDA kernel has no interpret mode).

    q [B, H, S, D] at positions pos..pos+S-1 per row; k_arena/v_arena
    [NB, Hkv, bs, D] (bf16/f32, or int8 with ``k_scale``/``v_scale``
    [NB, Hkv, bs]); table [B, nb] int32; pos [B] int32 -> [B, H, S, D]
    in q's dtype. CUDA tensors launch the hand-written kernel; CPU
    tensors run ``paged_decode_attention_reference``."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_arena, v_arena, table, pos, k_scale=k_scale,
            v_scale=v_scale, scale=scale)
    return _kernels.paged_decode.launch(
        q, k_arena, v_arena, table, pos, k_scale=k_scale, v_scale=v_scale,
        scale=scale if scale is not None else q.shape[-1] ** -0.5)


# ---------------------------------------------------------------------------
# flash attention (training path)
# ---------------------------------------------------------------------------

_ATTN_IMPLS = ("splash", "flash", "xla")


def effective_impl(q_shape, k_shape, *, force_xla: bool = False) -> str:
    """Which formulation ``attention`` dispatches: "splash" | "flash"
    (both the CUDA flash-attention kernel family on the card, its plain
    version on the CPU) or "xla" (``xla_attention`` under autograd).
    ``NOS_TPU_TORCH_ATTN_IMPL`` (default "splash") selects it. Unlike the
    reference, no shape routes to "xla" on its own: the kernel masks
    ragged sequence tails itself, and on the card a head_dim it is not
    built for raises (``check_attention_head_dim``)."""
    impl = os.environ.get("NOS_TPU_TORCH_ATTN_IMPL", "splash")
    if impl not in _ATTN_IMPLS:
        raise ValueError(f"NOS_TPU_TORCH_ATTN_IMPL must be one of "
                         f"{_ATTN_IMPLS}, got {impl!r}")
    return "xla" if force_xla else impl


def check_attention_head_dim(head_dim: int, device: torch.device,
                             impl: str) -> None:
    """Raise a ValueError naming ``head_dim`` when the kernel formulation
    is selected on the card for a head dim the CUDA kernel is not built
    for (64 and 128): never a quiet fall-back to the plain version."""
    if (impl != "xla" and device.type == "cuda"
            and head_dim not in _kernels.HEAD_DIMS):
        raise ValueError(
            f"head_dim {head_dim} is not one the CUDA flash attention "
            f"kernel takes {_kernels.HEAD_DIMS}: pick widths with such a "
            f"head_dim, or set NOS_TPU_TORCH_ATTN_IMPL=xla")


def _masked_scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """f32 scores [B, Hkv, g, Sq, Sk], finfo(f32).min outside
    ``xla_attention``'s bottom-right causal mask."""
    scores = _grouped_scores(q, k, scale)
    if causal:
        s_q, s_k = scores.shape[-2:]
        mask = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril(s_k - s_q)
        scores = torch.where(mask, scores, _NEG)
    return scores


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool,
                              scale: float) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The forward kernel's plain version: (o [B, H, Sq, D] in q's dtype,
    lse f32 [B, H, Sq]). Scores and softmax in f32 with the scale on the
    f32 scores, probabilities cast to q's dtype before P.V, exactly
    ``xla_attention``; lse = logsumexp of the scaled, masked scores."""
    b, h, s_q, _ = q.shape
    scores = _masked_scores(q, k, causal, scale)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.exp(scores - lse[..., None]).to(q.dtype)
    return _grouped_pv(probs, v), lse.reshape(b, h, s_q)


def flash_attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' plain version, the textbook formulas in f32:
    P = exp(scale * Q K^T - lse) (exactly zero where the mask put
    finfo(f32).min), dV = P^T dO,
    dP = dO V^T, D = rowsum(dO * O), dS = P * (dP - D), dQ = scale * dS K,
    dK = scale * dS^T Q; the GQA group's query heads sum into their kv
    head. Returns (dq, dk, dv) in the inputs' dtypes."""
    b, h, s_q, d = q.shape
    h_kv = k.shape[1]
    g = h // h_kv

    def grouped(t):
        return t.float().reshape(b, h_kv, g, t.shape[2], d)

    qg, og, dog = grouped(q), grouped(o), grouped(do)
    k32, v32 = k.float().unsqueeze(2), v.float().unsqueeze(2)
    scores = _masked_scores(q, k, causal, scale)        # [B, Hkv, g, Sq, Sk]
    p = torch.exp(scores - lse.reshape(b, h_kv, g, s_q, 1))
    dv = torch.matmul(p.transpose(-1, -2), dog).sum(dim=2)
    dp = torch.matmul(dog, v32.transpose(-1, -2))
    delta = (dog * og).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, k32) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qg).sum(dim=2) * scale
    return (dq.reshape(b, h, s_q, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, causal: bool, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) through the three backward kernels on CUDA tensors
    (delta = rowsum(dO * O), then dK/dV, then dQ), through
    ``flash_attention_backward_reference`` on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, o, lse, do, causal=causal, scale=scale)
    delta = _kernels.flash_bwd_pre.launch(o, do)
    dk, dv = _kernels.flash_bwd_dkdv.launch(q, k, v, do, lse, delta,
                                            causal=causal, scale=scale)
    (dq,) = _kernels.flash_bwd_dq.launch(q, k, v, do, lse, delta,
                                         causal=causal, scale=scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Flash attention with a kernel backward: the forward saves q, k, v,
    o and the f32 lse (the counterpart of splash's ``"attn_residuals"``),
    and the backward never re-runs the forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if q.device.type == "cpu":
            o, lse = flash_attention_reference(q, k, v, causal=causal,
                                               scale=scale)
        else:
            o, lse = _kernels.flash_fwd.launch(q, k, v, causal=causal,
                                               scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
            scale=ctx.scale)
        return dq, dk, dv, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, scale: Optional[float] = None,
              force_xla: bool = False) -> torch.Tensor:
    """q [B, H, Sq, D]; k, v [B, Hkv, Sk, D] with H % Hkv == 0 ->
    [B, H, Sq, D] in q's dtype. The causal mask is bottom-right aligned
    (``xla_attention``'s), which is splash's top-left mask whenever
    Sq == Sk, as every training caller has. The scale multiplies the f32
    scores (flash's and ``xla_attention``'s rule; splash pre-scales q in
    q's dtype, a bf16 rounding apart). "splash" and "flash" run
    ``_FlashAttention``: on CUDA tensors the hand-written kernels (or a
    raise), on CPU tensors their plain versions; "xla" runs
    ``xla_attention`` under autograd."""
    impl = effective_impl(q.shape, k.shape, force_xla=force_xla)
    if impl == "xla":
        return xla_attention(q, k, v, causal=causal, scale=scale)
    check_attention_head_dim(q.shape[-1], q.device, impl)
    sm_scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, float(sm_scale))
