"""Mixture-of-Experts FFN (port of ``nos_tpu/ops/moe.py``): top-2 gating
with per-expert capacity and the dense dispatch/combine products; under
a serving mesh each expert's d_ff split over tp (``moe_ffn_tp``); in
training over a ``TrainMesh``'s tp x ep ranks, each with its experts'
d_ff slice, and its sp ranks, each with its rows (``moe_ffn_mesh``).

The routing is the reference's, capacity drops included: every token
picks its best and second-best expert; each expert takes at most C
tokens per batch row (``expert_capacity`` over the call's S), top-1
assignments before top-2 ones; the kept gates are renormalized per
token. Dispatch and combine stay dense [B, S, E, C] tensors with static
shapes, so the decode tick keeps one shape and is captured as a CUDA
graph, and which tokens are dropped is exactly the reference's.

Routing runs in f32 (the router product too: no TF32). The softmax
takes XLA's f32 exp (``_xla_exp``) and sums left to right, every step
an IEEE-rounded elementwise operation, so the gates, the top-2 picks
and the combine weights are the reference's on XLA:CPU bit for bit,
and the same bits on the card as on the CPU for the same logits. The
expert products run in the model dtype.

Gradients flow as in JAX: through the renormalized combine weights and
the aux loss's mean gate into the softmax (whose backward is JAX's
rule for ``jax.nn.softmax``) and the router; the picks, one-hots,
cumsums and the dispatch mask carry none.
"""
from __future__ import annotations

import struct
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["expert_capacity", "top2_gating", "moe_ffn", "moe_ffn_tp",
           "moe_ffn_mesh"]


def _f32(c: float) -> float:
    """``c`` rounded to f32, as XLA holds its constants."""
    return struct.unpack("f", struct.pack("f", c))[0]


# XLA's f32 exp (the Cephes polynomial, every multiply-add fused)
_EXP_HI = _f32(88.3762626647950)
_EXP_LO = _f32(-88.3762626647949)
_LOG2E = _f32(1.44269504088896341)
_LN2_HI = _f32(0.693359375)
_LN2_LO = _f32(-2.12194440e-4)
_EXP_POLY = tuple(_f32(c) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))
_F32_TINY = torch.finfo(torch.float32).tiny


def expert_capacity(seq: int, n_experts: int, capacity_factor: float,
                    top_k: int = 2) -> int:
    """Tokens each expert can accept per batch row."""
    return max(1, int(seq * top_k * capacity_factor / n_experts))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` as a fused multiply-add: the f64 product of two
    f32 values is exact, and the f64 sum cast to f32 is the fused result
    but on a tie of the second rounding (none among the values
    tests/test_torch_moe.py holds to XLA's exp)."""
    return (a.double() * b + c).float()


def _xla_exp(x: torch.Tensor) -> torch.Tensor:
    """f32 exp as XLA's CPU backend emits it: clamp, n = floor(x log2 e
    + 1/2), r = x - n ln2 in two fused steps, a degree-5 polynomial in
    fused multiply-adds, times 2^n, a subnormal result flushed to zero.
    ``torch.exp`` rounds ~9% of values apart from it, enough to flip a
    gate's last bit."""
    x = x.clamp(_EXP_LO, _EXP_HI)
    n = torch.floor(x * _LOG2E + 0.5)
    r = _fma(n, -_LN2_HI, x)
    r = _fma(n, -_LN2_LO, r)
    y = torch.full_like(r, _EXP_POLY[0])
    for c in _EXP_POLY[1:]:
        y = _fma(y, r, c)
    # 2^n from its exponent bits: exact on any device (n in [-127, 128];
    # -127 gives 0 where 2^-127 would be subnormal, flushed below anyway)
    pow2 = ((n.int() + 127) << 23).view(torch.float32)
    y = (_fma(y, r * r, r) + 1.0) * pow2
    return torch.where(y < _F32_TINY, 0.0, y)


def _softmax_values(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax over the last axis in f32: exp(x - max) / sum,
    with XLA's exp and the sum taken left to right, as XLA reduces a
    short minor axis."""
    u = _xla_exp(x - x.amax(dim=-1, keepdim=True))
    total = u[..., 0]
    for i in range(1, u.shape[-1]):
        total = total + u[..., i]
    return u / total[..., None]


class _Softmax(torch.autograd.Function):
    """``_softmax_values`` with JAX's own derivative of
    ``jax.nn.softmax`` (its custom_jvp rule, transposed): autograd
    through ``_xla_exp`` would differentiate the Cephes polynomial
    (poly'(r) 2^n, not exp) and keep its f64 chain for every layer."""

    @staticmethod
    def forward(ctx, x):
        y = _softmax_values(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return y * (g - (y * g).sum(-1, keepdim=True))


_softmax = _Softmax.apply


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot by comparison: an index outside [0, n) gives a zero
    row, as ``jax.nn.one_hot`` does (``F.one_hot`` would raise), with
    no host check, so it runs inside a captured program."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


BatchMean = Optional[Callable[[torch.Tensor], torch.Tensor]]


def top2_gating(logits: torch.Tensor, capacity: int,
                batch_mean: BatchMean = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits [B, S, E] f32 -> (combine [B, S, E, C] f32, dispatch bool
    [B, S, E, C], aux_loss f32 scalar). ``batch_mean`` maps a mean over
    this call's rows to the mean over the whole batch (a data-parallel
    rank's rows are a slice of it): the aux loss's statistics are the
    batch's, as the reference's over its global batch."""
    e = logits.shape[-1]
    gates = _softmax(logits)

    # top-1 and top-2 picks (argmax takes the first of tied maxima, as
    # JAX's does)
    mask1 = _one_hot(torch.argmax(gates, dim=-1), e)        # [B, S, E]
    gates2 = gates * (1.0 - mask1)
    mask2 = _one_hot(torch.argmax(gates2, dim=-1), e)

    # each token's slot in its expert's buffer: top-1 assignments fill
    # first, top-2 ones go after every top-1 of the row
    pos1 = torch.cumsum(mask1, dim=1) - mask1               # [B, S, E]
    count1 = mask1.sum(dim=1, keepdim=True)                 # [B, 1, E]
    pos2 = torch.cumsum(mask2, dim=1) - mask2 + count1

    keep1 = mask1 * (pos1 < capacity)
    keep2 = mask2 * (pos2 < capacity)

    # gate weights renormalized over the kept assignments
    g1 = (gates * keep1).sum(dim=-1)                        # [B, S]
    g2 = (gates * keep2).sum(dim=-1)
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom

    # a dropped assignment's slot index is 0 (pos x keep 0) and its
    # keep is 0, so its one-hot row never reaches combine
    cap1 = _one_hot((pos1 * keep1).sum(dim=-1).int(), capacity)
    cap2 = _one_hot((pos2 * keep2).sum(dim=-1).int(), capacity)
    combine = (g1[..., None, None] * keep1[..., None] * cap1[..., None, :]
               + g2[..., None, None] * keep2[..., None]
               * cap2[..., None, :])                        # [B, S, E, C]
    dispatch = combine > 0.0

    # load-balancing aux loss (GShard's, over top-1 fractions)
    frac_routed = mask1.mean(dim=(0, 1))                    # [E]
    mean_gate = gates.mean(dim=(0, 1))                      # [E]
    if batch_mean is not None:
        frac_routed, mean_gate = batch_mean(frac_routed), batch_mean(
            mean_gate)
    aux = e * (frac_routed * mean_gate).sum()
    return combine, dispatch, aux


def moe_ffn(h: torch.Tensor, router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h [B, S, d]; router [d, E]; expert weights [E, d, f] / [E, f, d]
    -> (out [B, S, d], aux_loss). The capacity is the reference's over
    this call's S, so the same tokens route alike only at the same S."""
    combine, dispatch, aux = _route(h, router, capacity_factor)
    return _experts(h, combine, dispatch, w_gate, w_up, w_down), aux


def moe_ffn_tp(h: torch.Tensor, router: torch.Tensor, experts,
               mesh, capacity_factor: float = 1.25
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` over a serving mesh's shards (``parallel.mesh.TpMesh``)
    with each expert's d_ff split Megatron-style: h [B, S, d] and the
    replicated router on shard 0's device; ``experts[r]`` shard r's
    (w_gate [E, d, f/tp], w_up, w_down [E, f/tp, d]) on its device. The
    gating runs once, on shard 0, and every shard takes the same combine
    and dispatch (``mesh.broadcast``), so the shards route alike by
    construction; each runs dispatch, its slice of every expert's SwiGLU
    and combine, and the partials are summed (``mesh.reduce``) ->
    (out [B, S, d] on shard 0's device, aux_loss)."""
    combine, dispatch, aux = _route(h, router, capacity_factor)
    parts = [_experts(hr, cr, dr, *w) for hr, cr, dr, w in zip(
        mesh.broadcast(h), mesh.broadcast(combine),
        mesh.broadcast(dispatch), experts)]
    return mesh.reduce(parts), aux


def moe_ffn_mesh(h: torch.Tensor, router: torch.Tensor,
                 w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, mesh, capacity_factor: float = 1.25
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` on one rank of a training ``TrainMesh``: h [B, S/sp, d]
    this rank's rows (the same bits on every tp x ep rank of its data
    and sp indices), the router [d, E] whole, the experts this rank's
    E/ep experts' slices of d_ff (w_gate, w_up [E/ep, d, f/tp], w_down
    [E/ep, f/tp, d]) -> (this rank's rows of out [B, S/sp, d], aux_loss).

    The gating sees the whole sequence, as the reference's does (its
    capacity and slot positions are a cumsum over the global S): the f32
    logits are gathered over sp, gated at the global S on every rank
    alike, and each rank keeps its rows of combine and dispatch and its
    experts' columns; the aux loss's statistics are means over the data
    ranks (``mesh.data_mean``: the reference's over the global batch;
    every sp rank gates the same rows whole). Dispatch, the experts'
    SwiGLU and combine run on those; a slot holding another sp rank's
    token holds zeros here and gives zeros (SwiGLU has no bias), so the
    rows' outputs are exact.
    The partial outputs are summed over tp x ep.

    Gradients: the gating's ``h`` and the aux loss are the same on every
    tp x ep rank and count once; the expert path's ``h`` and ``combine``
    pass a copy-to (identity forward, gradient summed over tp x ep), so
    the router's gradient through combine sums every rank's experts and
    d_ff slice, and is the same bits on every such rank."""
    e = router.shape[-1]
    s_local = h.shape[1]
    cap = expert_capacity(s_local * mesh.sp, e, capacity_factor)
    logits = torch.matmul(h.float(), router.float())       # [B, S/sp, E]
    combine, dispatch, aux = top2_gating(mesh.gather_sp(logits, 1), cap,
                                         mesh.data_mean)
    rows = slice(mesh.sp_index * s_local, (mesh.sp_index + 1) * s_local)
    e_local = w_gate.shape[0]
    cols = slice(mesh.ep_index * e_local, (mesh.ep_index + 1) * e_local)
    combine = mesh.copy_to_experts(combine[:, rows])[:, :, cols]
    y = _experts(mesh.copy_to_experts(h), combine, dispatch[:, rows, cols],
                 w_gate, w_up, w_down)
    return mesh.reduce_from_experts(y), aux


def _route(h: torch.Tensor, router: torch.Tensor, capacity_factor: float):
    """The gating of ``h`` [B, S, d] over ``router`` [d, E] at the
    reference's capacity over this call's S: (combine, dispatch, aux)."""
    cap = expert_capacity(h.shape[1], router.shape[-1], capacity_factor)
    logits = torch.matmul(h.float(), router.float())       # [B, S, E]
    return top2_gating(logits, cap)


def _experts(h: torch.Tensor, combine: torch.Tensor, dispatch: torch.Tensor,
             w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """Dispatch ``h`` [B, S, d] to the experts' [E, C] slots, each
    expert's SwiGLU (the slice of d_ff the weights hold), combine ->
    [B, S, d] in the model dtype."""
    b, s, d = h.shape
    e, cap = combine.shape[-2:]
    # dispatch: [B, S, E, C] x [B, S, d] -> [E, B, C, d]
    disp = dispatch.to(h.dtype).reshape(b, s, e * cap)
    x = torch.matmul(disp.transpose(1, 2), h)               # [B, E*C, d]
    x = x.reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)
    # per-expert SwiGLU, one batched product per weight over E
    gate = F.silu(torch.matmul(x, w_gate))                  # [E, B*C, f]
    up = torch.matmul(x, w_up)
    y = torch.matmul(gate * up, w_down)                     # [E, B*C, d]
    # combine: [E, B, C, d] x [B, S, E, C] -> [B, S, d]
    y = y.reshape(e, b, cap, d).transpose(0, 1).reshape(b, e * cap, d)
    comb = combine.to(h.dtype).reshape(b, s, e * cap)
    return torch.matmul(comb, y)
