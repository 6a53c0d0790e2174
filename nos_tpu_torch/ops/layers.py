"""Core layer ops (port of ``nos_tpu/ops/layers.py``): plain functions
on tensors, f32 statistics, one cast back to the input dtype."""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from nos_tpu_torch.ops.quant import qdot

Freqs = Tuple[torch.Tensor, torch.Tensor]


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    orig_dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(orig_dtype)


@functools.lru_cache(maxsize=8)
def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0,
                     device: Optional[torch.device] = None) -> Freqs:
    """Rotation table as real (cos, sin) pairs, each f32
    [max_len, head_dim//2] — the reference's complex ``exp(1j * freqs)``
    split into its parts. Cached per shape and device: it is a constant
    the reference's jit folds away."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def rope_rows(freqs: Freqs, positions: Optional[torch.Tensor] = None,
              seq: Optional[int] = None) -> Freqs:
    """The (cos, sin) rows ``apply_rope`` rotates by, gathered at
    ``positions`` ([seq] shared or [batch, seq] per row; None: the first
    ``seq`` rows) and shaped to broadcast over the heads axis. A forward
    gathers them once and rotates every layer's q and k with them."""
    cos, sin = freqs
    if positions is None:
        cos, sin = cos[:seq], sin[:seq]
    else:
        cos, sin = cos[positions], sin[positions]
    return cos[..., :, None, :], sin[..., :, None, :]


def rotate(x: torch.Tensor, rows: Freqs) -> torch.Tensor:
    """x: [..., seq, heads, head_dim] rotated by ``rope_rows``' pair:
    INTERLEAVED pairs (x[2i], x[2i+1]) as the reference's complex
    multiply does, in f32, cast back once."""
    cos, sin = rows
    xc = x.float().reshape(*x.shape[:-1], -1, 2)
    xr, xi = xc[..., 0], xc[..., 1]
    out = torch.stack([xr * cos - xi * sin, xr * sin + xi * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def apply_rope(x: torch.Tensor, freqs: Freqs,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; freqs: (cos, sin) from
    ``rope_frequencies``. ``positions`` may be [seq] (shared) or
    [batch, seq] (per row)."""
    return rotate(x, rope_rows(freqs, positions, x.shape[-3]))


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """down(silu(x @ gate) * (x @ up)); weights plain or ``QuantLinear``."""
    gate = F.silu(qdot(x, w_gate))
    up = qdot(x, w_up)
    return qdot(gate * up, w_down)


@torch.library.custom_op("nos_tpu_torch::qkv_proj", mutates_args=())
def qkv_proj(h: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
             wv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
             n_heads: int, kv_heads: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention block's q/k/v products as one registered op: h
    [B, S, d] -> (q [B, S, H, D] and k [B, S, Hkv, D] rotated by the
    ``rope_rows`` pair (cos, sin), v [B, S, Hkv, D]): the tensors the
    reference tags ``"qkv_proj"``. As an op, its outputs are what a
    selective-checkpoint policy can save by that name, and a recompute
    that has them saved skips the three products with them (a tag on
    q, k and v alone would leave the products to be re-run). Its
    gradient (``_qkv_proj_backward``) is autograd's through the same
    products and rotations."""
    b, s, _ = h.shape
    head_dim = wq.shape[1] // n_heads
    q = torch.matmul(h, wq).reshape(b, s, n_heads, head_dim)
    k = torch.matmul(h, wk).reshape(b, s, kv_heads, head_dim)
    v = torch.matmul(h, wv).reshape(b, s, kv_heads, head_dim)
    return rotate(q, (cos, sin)), rotate(k, (cos, sin)), v


@qkv_proj.register_fake
def _qkv_proj_fake(h, wq, wk, wv, cos, sin, n_heads, kv_heads):
    b, s, _ = h.shape
    head_dim = wq.shape[1] // n_heads
    return (h.new_empty((b, s, n_heads, head_dim)),
            h.new_empty((b, s, kv_heads, head_dim)),
            h.new_empty((b, s, kv_heads, head_dim)))


def _qkv_proj_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:6])


def _qkv_proj_backward(ctx, dq, dk, dv):
    """The rotations' transpose is the rotation by -theta, exactly
    autograd's arithmetic (a - x * -s is a + x * s in IEEE); then each
    product's two gradients, as ``mm``'s backward forms them, and the
    input gradient summed in the order autograd sums the three separate
    products' (v's and k's, then q's), so the op's gradients are the
    unfused block's bit for bit."""
    h, wq, wk, wv, cos, sin = ctx.saved_tensors
    back = (cos, -sin)
    flat = h.reshape(-1, h.shape[-1])
    dh, dws = None, [None, None, None]
    for i, g, w in ((2, dv, wv), (1, rotate(dk, back), wk),
                    (0, rotate(dq, back), wq)):
        g = g.reshape(-1, w.shape[1])
        if ctx.needs_input_grad[1 + i]:
            dws[i] = flat.t().mm(g)
        if ctx.needs_input_grad[0]:
            part = g.mm(w.t())
            dh = part if dh is None else dh + part
    return (dh.reshape(h.shape) if dh is not None else None, *dws,
            None, None, None, None)


qkv_proj.register_autograd(_qkv_proj_backward,
                           setup_context=_qkv_proj_setup)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Mean and variance over the last axis in f32, then the f32 scale
    and bias, one cast back to x's dtype (the reference's rule; not
    ``F.layer_norm``, whose reduced-precision inputs keep their dtype's
    affine product)."""
    orig_dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(orig_dtype)


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """out(gelu(x @ w_in + b_in)) + b_out, GELU's tanh approximation
    (``jax.nn.gelu(approximate=True)``)."""
    h = F.gelu(torch.matmul(x, w_in) + b_in, approximate="tanh")
    return torch.matmul(h, w_out) + b_out


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] (NHWC) -> [B, (H/p)*(W/p), p*p*C]: a reshape and a
    transpose, no convolution; each patch's pixels row-major, channels
    innermost."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // patch, patch, w // patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // patch) * (w // patch), patch * patch * c)
