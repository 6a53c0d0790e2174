"""Ring attention (port of ``nos_tpu/ops/ring_attention.py``): exact
attention over a sequence split over the sp ranks of a
``parallel.mesh.TrainMesh``.

Each rank holds its sequence chunk of q, k and v; the K/V blocks rotate
around the ring (``TrainMesh.ring_step``, the reference's ``ppermute``
i -> i + 1) while each block's partial statistics (m, l, o) merge into
the rank's accumulators by the log-sum-exp rescaling, in f32. Causal
masking uses global positions, so the block boundaries are exact. The
local block runs first, then sp - 1 rotations, as the reference's
``fori_loop`` does. Only the kv heads circulate (GQA grouped, no K/V
repeat).

The partials are the reference's einsums in plain PyTorch (the reference
computes them outside any Pallas kernel), under autograd: the ring
step's backward carries each K/V block's gradient back around the ring
to the rank that holds it. Scores are f32 products of the inputs (the
reference's ``preferred_element_type``), the probabilities are cast to
v's dtype before P.V.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["ring_attention", "ring_attention_out"]


def _block_attention(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_offset: int, kv_offset: int, causal: bool,
                     scale: float):
    """One (local q, kv block) partial: (m, l, o) in f32. qg [B, Hkv, G,
    Sq, D] (G query heads a kv head); k, v [B, Hkv, Sk, D]; the offsets
    are the blocks' global sequence starts."""
    s_q, s_k = qg.shape[-2], k.shape[-2]
    scores = torch.matmul(qg.float(),
                          k.float().unsqueeze(2).transpose(-1, -2)) * scale
    if causal:
        q_pos = q_offset + torch.arange(s_q, device=qg.device)
        k_pos = kv_offset + torch.arange(s_k, device=qg.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        scores = torch.where(mask, scores, -torch.inf)
    m = scores.amax(dim=-1)                                 # [B, Hkv, G, Sq]
    # fully masked rows: keep m finite so exp() stays well-defined
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(torch.isfinite(scores), p, 0.0)
    l = p.sum(dim=-1)                                       # [B, Hkv, G, Sq]
    o = torch.matmul(p.to(v.dtype), v.unsqueeze(2)).float()
    return m_safe, l, o


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, *, causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """q [B, H, S/sp, D]; k, v [B, Hkv, S/sp, D] with H % Hkv == 0: this
    rank's sequence chunk (``mesh.sp_index``) -> its chunk of the
    attention output [B, H, S/sp, D] in q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    ring, me = mesh.sp, mesh.sp_index
    b, h, s_local, d = q.shape
    h_kv = k.shape[1]
    qg = q.reshape(b, h_kv, h // h_kv, s_local, d)
    q_offset = me * s_local
    # step 0: the local block
    m, l, acc = _block_attention(qg, k, v, q_offset, q_offset, causal, scale)
    kv = torch.stack((k, v))
    for i in range(1, ring):
        # rotate first: at step i this rank holds block (me - i)
        kv = mesh.ring_step(kv)
        kv_idx = (me - i) % ring
        m_blk, l_blk, o_blk = _block_attention(
            qg, kv[0], kv[1], q_offset, kv_idx * s_local, causal, scale)
        m_new = torch.maximum(m, m_blk)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(m_blk - m_new)
        l = alpha * l + beta * l_blk
        acc = alpha[..., None] * acc + beta[..., None] * o_blk
        m = m_new
    l = torch.clamp(l, min=1e-20)
    return (acc / l[..., None]).reshape(b, h, s_local, d).to(q.dtype)


@torch.library.custom_op("nos_tpu_torch::ring_attention_out",
                         mutates_args=())
def ring_attention_out(o: torch.Tensor) -> torch.Tensor:
    """The ring's output as a registered op (a copy of ``o``; identity
    gradient): the counterpart of the reference's ``"attn_out"`` tag on
    it, so the named remat policies keep it as they keep the flash op's
    output (``models/transformer.py::remat_saved_ops``)."""
    return o.clone()


@ring_attention_out.register_fake
def _ring_attention_out_fake(o):
    return torch.empty_like(o)


ring_attention_out.register_autograd(lambda ctx, g: g)
