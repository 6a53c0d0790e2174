"""Frozen yardstick: the H100's published peaks and the operations and
bytes of each kernel's call and of the model's whole step, counted from
shapes. Each input byte is read once and each output byte written once;
operations count what the inputs need (a causal mask's admitted pairs,
a token's two experts), not what an implementation computes."""
from __future__ import annotations

import math
from typing import Sequence

from portbench.model import Dims, param_count

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_s(flops: float, nbytes: float, peak: float = BF16_FLOPS) -> float:
    """The least seconds a call can take: the larger of its two bounds."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


# -- paged decode attention (csrc/paged_decode_attention.cu) ----------

def paged_decode_work(live: Sequence[int], *, h: int, h_kv: int, d: int,
                      bs: int, s: int = 1, elem: int = 2) -> tuple:
    """(flops, bytes) of one launch over rows whose live context (keys
    attended by the last query, pos + s) is ``live``: each live K/V token
    read once, each row's table entries and pos, q read and out written
    once; QK and PV over the keys each query attends."""
    rows = len(live)
    tokens = sum(live)
    blocks = sum(math.ceil(t / bs) for t in live)
    attended = sum(t - s + i + 1 for t in live for i in range(s))
    nbytes = (tokens * h_kv * d * elem * 2 + blocks * 4 + rows * 4
              + 2 * rows * h * s * d * elem)
    return 4 * h * d * attended, nbytes


# -- flash attention (csrc/flash_attention.cu) ------------------------

def causal_pairs(s_q: int, s_k: int) -> int:
    """(query, key) pairs a causal mask admits, per (batch, head)."""
    off = s_k - s_q
    if off >= 0:
        return s_q * (off + 1) + s_q * (s_q - 1) // 2
    return sum(max(0, i + off + 1) for i in range(s_q))


def flash_work(b: int, h: int, h_kv: int, s: int, d: int,
               elem: int = 2) -> dict:
    """{kernel: (flops, bytes)} of one causal self-attention at S = s:
    forward 4 operations a (pair, head dim), dK/dV 8, dQ 6, the
    backward's preprocess 2 an output element."""
    pairs = causal_pairs(s, s) * b * h
    qb, kb, rows = b * h * s * d * elem, b * h_kv * s * d * elem, b * h * s * 4
    return {"fwd": (4 * d * pairs, 2 * qb + 2 * kb + rows),
            "bwd_preprocess": (2 * b * h * s * d, 2 * qb + rows),
            "bwd_dkdv": (8 * d * pairs, 2 * qb + 4 * kb + 2 * rows),
            "bwd_dq": (6 * d * pairs, 3 * qb + 2 * kb + 2 * rows)}


# -- adamw (csrc/adamw.cu) ---------------------------------------------

def adamw_bytes(elements: int, elem: int = 2) -> int:
    """Param, gradient and both moments read, param and moments
    written: 7 x elem a parameter."""
    return 7 * elem * elements


# -- the model's whole step ----------------------------------------------

def weight_bytes(dm: Dims, experts_read: float) -> float:
    """Bytes of the weights one forward reads (bf16 products, f32 norms
    and router), with ``experts_read`` of each layer's experts; the
    embedding is a lookup of a few rows and is left out."""
    d, f, L = dm.d_model, dm.d_ff, dm.n_layers
    attn = 2 * (2 * d * d + 2 * d * dm.kv_dim)
    if dm.n_experts:
        ffn = 2 * 3 * d * f * experts_read + 4 * d * dm.n_experts
    else:
        ffn = 2 * 3 * d * f
    return L * (attn + ffn + 2 * 4 * d) + 2 * d * dm.vocab + 4 * d


def experts_touched(dm: Dims, tokens: int) -> float:
    """Experts of a layer that ``tokens`` tokens reach, as expected when
    each picks its top_k uniformly: E (1 - (1 - k/E)^tokens)."""
    if not dm.n_experts:
        return 0.0
    e, k = dm.n_experts, dm.top_k
    return e * (1.0 - (1.0 - k / e) ** tokens)


def token_flops(dm: Dims) -> float:
    """Product operations of one token through the model (its top_k
    experts), the embedding lookup left out."""
    return 2.0 * (param_count(dm, active=True) - dm.vocab * dm.d_model)


def kv_token_bytes(dm: Dims, elem: int = 2) -> int:
    """Bytes of one token's K and V over every layer."""
    return dm.n_layers * 2 * dm.kv_dim * elem


def prefill(dm: Dims, n: int) -> tuple:
    """(flops, bytes) of one prompt of ``n`` tokens prefilled alone: its
    products, causal attention, the weights read once, its K/V
    written."""
    attn = 4 * dm.n_heads * dm.head_dim * dm.n_layers * causal_pairs(n, n)
    flops = token_flops(dm) * n + attn
    nbytes = weight_bytes(dm, experts_touched(dm, n)) + kv_token_bytes(dm) * n
    return flops, nbytes


def train_step_flops(dm: Dims, batch: int, seq: int) -> float:
    """A training step's operations: 6 a parameter and token (forward 2,
    backward 4) and causal attention forward and backward (12 a pair and
    head dim); recomputation left out."""
    attn = 12 * dm.n_heads * dm.head_dim * dm.n_layers * batch * \
        causal_pairs(seq, seq)
    return 3 * token_flops(dm) * batch * seq + attn
