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
