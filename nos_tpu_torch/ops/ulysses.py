"""Ulysses sequence parallelism (port of ``nos_tpu/ops/ulysses.py``):
all-to-alls over the sp ranks of a ``parallel.mesh.TrainMesh`` turn the
sequence split into a head split, ``attention`` runs over the whole
sequence for this rank's H/sp query and Hkv/sp kv heads (the flash op:
the hand-written kernels on the card, their plain versions on the CPU),
and an all-to-all turns the output back into the sequence split. Two
exchanges a call (q, k and v in, packed into one; o out) whatever sp
is, against the ring's sp - 1 rotations; both head counts must divide
by sp.

The exchanges keep the reference's orders: ``seq_to_heads`` sends head
group j to rank j and lays the received sequence chunks chunk-major
(the global sequence order); ``heads_to_seq`` sends sequence chunk j to
rank j and lays the received head groups group-major.
"""
from __future__ import annotations

from typing import Optional

import torch

from nos_tpu_torch.ops.attention import attention

__all__ = ["ulysses_attention", "check_ulysses_heads"]


def check_ulysses_heads(h: int, h_kv: int, n: int) -> None:
    """The reference's refusal: both head counts must divide by the sp
    axis size."""
    if h % n or h_kv % n:
        raise ValueError(
            f"ulysses needs head counts divisible by the axis size "
            f"({h} q heads, {h_kv} kv heads, axis {n})")


def seq_to_heads(xs, mesh) -> list:
    """Each of ``xs`` [B, Hx, S/n, D] -> [B, Hx/n, S, D], in one exchange:
    head group j of each goes to sp rank j; the received sequence chunks
    land chunk-major, so the flatten gives the global order."""
    n = mesh.sp
    b, _, s_local, d = xs[0].shape
    groups = [x.shape[1] // n for x in xs]
    x = torch.cat([x.reshape(b, n, g, s_local, d)
                   for x, g in zip(xs, groups)], dim=2).movedim(1, 0)
    x = mesh.all_to_all_sp(x)                   # [n (chunk), B, *, S/n, D]
    x = x.movedim(0, 2).reshape(b, sum(groups), n * s_local, d)
    return list(x.split(groups, dim=1))


def heads_to_seq(x: torch.Tensor, mesh) -> torch.Tensor:
    """[B, H/n, S, D] -> [B, H, S/n, D]: sequence chunk j goes to sp rank
    j; the received head groups land group-major before the local
    heads."""
    n = mesh.sp
    b, hn, s, d = x.shape
    x = x.reshape(b, hn, n, s // n, d).movedim(2, 0)
    x = mesh.all_to_all_sp(x)                   # [n (group), B, H/n, S/n, D]
    return x.movedim(0, 1).reshape(b, hn * n, s // n, d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, *, causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """q [B, H, S/sp, D]; k, v [B, Hkv, S/sp, D]: this rank's sequence
    chunk -> its chunk of the attention output [B, H, S/sp, D]."""
    check_ulysses_heads(q.shape[1], k.shape[1], mesh.sp)
    out = attention(*seq_to_heads((q, k, v), mesh), causal=causal,
                    scale=scale)
    return heads_to_seq(out, mesh)
