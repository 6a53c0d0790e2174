"""The plain reference: the published decoder (Mistral-7B, and Mixtral's
top-2 experts) in float32 PyTorch, with no kernel, cache or batching.

Pre-norm blocks: RMSNorm, attention with grouped key/value heads and
rotary positions (interleaved pairs, as Mistral's own reference code
rotates them), causal over the whole sequence, SwiGLU (or the router's
two best experts, renormalized over those two), and the head after a
final RMSNorm. Weights are the benchmark's tensors in the layout
``portbench.model.make_params`` draws; each layer is cast to float32
once and applied to every sequence, so the reference holds one layer in
float32 at a time. TF32 is switched off for its products.

With ``quant`` the products' weights are first rounded to a lower
precision (per output channel: int8 at amax/127, fp8 e4m3 at amax/448),
the control that a sound comparison must refuse.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import List, Optional, Sequence

import torch

from portbench.model import Dims

# the rows of scores and products computed at once, so a long sequence's
# attention fits beside the weights
ROWS = 1024


@contextmanager
def _no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fake_quant(w: torch.Tensor, quant: Optional[str], axis: int = -2
               ) -> torch.Tensor:
    """``w`` in float32, first rounded to ``quant`` with one scale per
    slice along every axis but ``axis`` (-2: per output column of an
    [in, out] weight)."""
    w = w.float()
    if quant is None:
        return w
    amax = w.abs().amax(dim=axis, keepdim=True).clamp_min(1e-30)
    if quant == "int8":
        scale = amax / 127.0
        return torch.clamp(torch.round(w / scale), -127, 127) * scale
    if quant == "fp8":
        scale = amax / 448.0
        return (w / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {quant!r}")


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, heads, D] rotated at positions 0..S-1: pair (x[2i], x[2i+1])
    by angle p * theta^(-2i/D)."""
    s, _, d = x.shape
    inv = theta ** (-torch.arange(0, d, 2, device=x.device,
                                  dtype=torch.float64) / d)
    ang = torch.arange(s, device=x.device, dtype=torch.float64)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    xr, xi = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = xr * cos - xi * sin
    out[..., 1::2] = xr * sin + xi * cos
    return out


def attention(x: torch.Tensor, w: dict, dm: Dims) -> torch.Tensor:
    """Causal self-attention of one sequence x [S, d]."""
    s = x.shape[0]
    hd, group = dm.head_dim, dm.n_heads // dm.n_kv_heads
    q = rope((x @ w["wq"]).view(s, dm.n_heads, hd), dm.rope_theta)
    k = rope((x @ w["wk"]).view(s, dm.n_kv_heads, hd), dm.rope_theta)
    v = (x @ w["wv"]).view(s, dm.n_kv_heads, hd)
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)     # [H, S, D]
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    q = q.transpose(0, 1)
    out = torch.empty_like(q)
    keys = torch.arange(s, device=x.device)
    for lo in range(0, s, ROWS):
        hi = min(s, lo + ROWS)
        scores = (q[:, lo:hi] @ k[:, :hi].transpose(1, 2)) * hd ** -0.5
        mask = keys[None, :hi] <= torch.arange(lo, hi, device=x.device)[:, None]
        scores = scores.masked_fill(~mask, float("-inf"))
        out[:, lo:hi] = torch.softmax(scores, dim=-1) @ v[:, :hi]
    return out.transpose(0, 1).reshape(s, dm.d_model) @ w["wo"]


def swiglu(x: torch.Tensor, gate, up, down) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ gate) * (x @ up)) @ down


def experts(x: torch.Tensor, w: dict, dm: Dims) -> torch.Tensor:
    """Mixtral's sparse FFN: softmax over the router's logits, the two
    best experts, their weights renormalized to sum to 1."""
    gates = torch.softmax(x @ w["w_router"], dim=-1)
    top, idx = torch.topk(gates, dm.top_k, dim=-1)
    top = top / top.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(dm.n_experts):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel():
            y = swiglu(x[rows], w["w_gate"][e], w["w_up"][e], w["w_down"][e])
            out.index_add_(0, rows, y * top[rows, slot, None])
    return out


def _layer(params: dict, i: int, quant: Optional[str]) -> dict:
    w = {}
    for k, v in params["layers"].items():
        if k in ("attn_norm", "mlp_norm", "w_router"):
            w[k] = v[i].float()
        else:
            w[k] = fake_quant(v[i], quant)
    return w


def _rows(x: torch.Tensor, fn) -> torch.Tensor:
    return torch.cat([fn(x[lo:lo + ROWS]) for lo in range(0, x.shape[0], ROWS)])


def logits(params: dict, dm: Dims, seqs: Sequence[Sequence[int]],
           starts: Sequence[int], quant: Optional[str] = None
           ) -> List[torch.Tensor]:
    """Each sequence's float32 logits [len - start, vocab] at positions
    start.. (the positions that predict the tokens after ``start``)."""
    device = params["embed"].device
    with torch.no_grad(), _no_tf32():
        embed = params["embed"]
        hs = []
        for seq in seqs:
            ids = torch.tensor(list(seq), device=device)
            # one scale a row: the rows looked up, rounded alone
            hs.append(fake_quant(embed[ids], quant, axis=-1))
        for i in range(dm.n_layers):
            w = _layer(params, i, quant)
            for j, x in enumerate(hs):
                x = x + attention(rms_norm(x, w["attn_norm"], dm.norm_eps),
                                  w, dm)
                if dm.n_experts:
                    ffn = lambda h: experts(h, w, dm)
                else:
                    ffn = lambda h: swiglu(h, w["w_gate"], w["w_up"],
                                           w["w_down"])
                x = x + _rows(rms_norm(x, w["mlp_norm"], dm.norm_eps), ffn)
                hs[j] = x
            del w
        head = fake_quant(params["unembed"], quant)
        out = []
        for x, start in zip(hs, starts):
            x = rms_norm(x[start:], params["final_norm"], dm.norm_eps)
            out.append(_rows(x, lambda h: h @ head))
        return out
