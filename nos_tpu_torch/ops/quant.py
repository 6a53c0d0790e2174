"""Weight-only int8 primitives (port of ``nos_tpu/ops/quant.py``).

Per-channel symmetric quantization over the contraction axis:
q = round(w / s), s = max|w| / 127 per output channel. ``qdot`` stays a
plain ``torch.matmul`` over the int8 weight cast to x's dtype; unlike
XLA, eager PyTorch materializes that cast, and a W8A16 kernel that
does not is later work.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["QuantLinear", "quantize_array", "qdot", "embed_lookup"]


@dataclass(frozen=True)
class QuantLinear:
    """int8 weights + f32 scales; w ~= q * scale broadcast over the
    quantized axis (-2 for matmul weights, -1 for embedding rows)."""
    q: torch.Tensor         # int8, same shape as the original weight
    scale: torch.Tensor     # f32, weight shape with the quantized axis removed

    def __getitem__(self, i) -> "QuantLinear":
        """Slice a stacked [L, ...] QuantLinear to one layer."""
        return QuantLinear(q=self.q[i], scale=self.scale[i])


def quantize_array(w: torch.Tensor, *, axis: int = -2) -> QuantLinear:
    w32 = w.float()
    amax = w32.abs().amax(dim=axis)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    # torch.round is round-half-to-even, as jnp.round
    q = torch.clamp(torch.round(w32 / scale.unsqueeze(axis)), -127, 127
                    ).to(torch.int8)
    return QuantLinear(q=q, scale=scale)


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a plain tensor or a 2-D QuantLinear; the scale is
    multiplied in x's dtype, as the reference does."""
    if isinstance(w, QuantLinear):
        y = torch.matmul(x, w.q.to(x.dtype))
        return y * w.scale.to(x.dtype)
    return torch.matmul(x, w)


def embed_lookup(table, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    """Embedding row gather for a plain [vocab, d] table or one quantized
    with per-row scales (``quantize_array(..., axis=-1)``)."""
    if isinstance(table, QuantLinear):
        rows = table.q[tokens].float() * table.scale[tokens][..., None]
    else:
        rows = table[tokens]
    return rows.to(dtype) if dtype is not None else rows
