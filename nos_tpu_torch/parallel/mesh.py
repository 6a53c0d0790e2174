"""The serving mesh (the tensor-parallel part of
``nos_tpu/parallel/mesh.py``): ``TpMesh``, an ordered list of ``tp``
devices, and the two things that cross it, written once here.

The engine is single-controller, as the reference's is (one decode
program spans the chips, host control flow unchanged): one process keeps
the scheduler, the block tables and the allocator once, and applies each
device op to every shard. A tensor split over the mesh along its head
axis is a ``HeadShards``; the residual stream, ``pos`` and the block
tables live on shard 0's device and are copied to the others.

- ``reduce``: the shards' partial sums into one tensor on shard 0's
  device, accumulated in f32 in shard order and rounded once (after the
  row-parallel ``wo`` and ``w_down`` products, and the masked embedding
  lookup). Each partial is copied to shard 0's device first: a no-op
  where shards share a device (the CPU, one card holding two shards), a
  peer copy between cards.
- ``gather``: the shards' slices concatenated in shard order on shard
  0's device (the vocab-sharded logits, a payload's heads).

A mesh may repeat a device: ``TpMesh(["cpu", "cpu"])`` runs two shards
on the CPU for the tests, ``TpMesh(["cuda:0", "cuda:0"])`` two shards
on one card. Later layouts (data, fsdp, sequence, pipeline axes) add
their axes here.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

__all__ = ["TpMesh", "HeadShards", "head_shards"]


class TpMesh:
    """``tp`` devices in shard order (a device may repeat)."""

    def __init__(self, devices: Sequence[Union[str, torch.device]]):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices: List[torch.device] = [torch.device(d)
                                            for d in devices]

    @property
    def tp(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"TpMesh({[str(d) for d in self.devices]})"

    def broadcast(self, x: torch.Tensor) -> List[torch.Tensor]:
        """``x`` on every shard's device (the same tensor where it is
        already there)."""
        return [x.to(d) for d in self.devices]

    def reduce(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of the shards' partials on shard 0's device: f32
        accumulation in shard order, one rounding to the partials'
        dtype."""
        dev = self.devices[0]
        total = parts[0].float()
        for p in parts[1:]:
            total = total + p.to(dev).float()
        return total.to(parts[0].dtype)

    def gather(self, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        """The shards' slices concatenated along ``dim`` in shard order,
        on shard 0's device."""
        dev = self.devices[0]
        return torch.cat([p.to(dev) for p in parts], dim=dim)

    def split(self, x: torch.Tensor, dim: int) -> List[torch.Tensor]:
        """``x`` cut into ``tp`` equal slices along ``dim``, slice r a
        fresh contiguous tensor on shard r's device."""
        if x.shape[dim] % self.tp:
            raise ValueError(
                f"axis of size {x.shape[dim]} does not split over "
                f"tp={self.tp}")
        return [torch.empty(c.shape, dtype=c.dtype, device=d).copy_(c)
                for c, d in zip(x.chunk(self.tp, dim), self.devices)]


def _index_tuple(idx) -> tuple:
    return idx if isinstance(idx, tuple) else (idx,)


class HeadShards:
    """A tensor split over a mesh along its head axis: ``parts[r]`` holds
    shard r's heads ``[r H/tp, (r+1) H/tp)``, on shard r's device. The
    KV arena (``[L, NB, Hkv, bs, D]``), its scale planes and the
    slot-static cache (``[L, B, Hkv, T, D]``) are held so, axis 2.

    Indexing reads and writes across the shards, so engine code written
    for one tensor runs on it: ``x[idx]`` gathers the indexed slices in
    shard order into one tensor on shard 0's device (the reference's
    layout: a payload's bytes are the same at any tp), and ``x[idx] =
    v`` splits ``v`` along its head axis and writes each slice into its
    shard. ``idx`` may index the axes before the head axis with ints,
    slices and one index list or tensor, and must take the head axis
    whole."""

    def __init__(self, parts: Sequence[torch.Tensor], axis: int,
                 mesh: TpMesh):
        self.parts = list(parts)
        self.axis = axis
        self.mesh = mesh

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[self.axis] = sum(p.shape[self.axis] for p in self.parts)
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def ndim(self) -> int:
        return self.parts[0].ndim

    def element_size(self) -> int:
        return self.parts[0].element_size()

    def _shard_index(self, idx, r: int) -> tuple:
        """``idx`` for shard r: index tensors moved to its device."""
        dev = self.parts[r].device
        return tuple(i.to(dev) if isinstance(i, torch.Tensor) else i
                     for i in idx)

    def _result_axis(self, idx: tuple) -> int:
        """Where the head axis lands in ``x[idx]``: ints before it drop
        their axes."""
        if len(idx) > self.axis and not (isinstance(idx[self.axis], slice)
                                         and idx[self.axis] == slice(None)):
            raise IndexError("a HeadShards index must take the head axis "
                             "whole")
        return self.axis - sum(isinstance(i, int) for i in idx[:self.axis])

    def __getitem__(self, idx) -> torch.Tensor:
        idx = _index_tuple(idx)
        axis = self._result_axis(idx)
        return self.mesh.gather([p[self._shard_index(idx, r)]
                                 for r, p in enumerate(self.parts)], axis)

    def __setitem__(self, idx, value) -> None:
        idx = _index_tuple(idx)
        axis = self._result_axis(idx)
        if isinstance(value, HeadShards):
            vals: List = value.parts
        elif isinstance(value, torch.Tensor) and value.ndim > 0:
            # the value's head axis sits where the indexed view's does,
            # counted from the right (the value may broadcast)
            view_ndim = self.ndim + sum(
                -1 if isinstance(i, int) else
                torch.as_tensor(i).ndim - 1 if isinstance(
                    i, (list, torch.Tensor)) else 0
                for i in idx)
            vax = value.ndim - (view_ndim - axis)
            vals = list(value.chunk(len(self.parts), vax))
        else:
            vals = [value] * len(self.parts)
        for r, (p, v) in enumerate(zip(self.parts, vals)):
            if isinstance(v, torch.Tensor):
                v = v.to(p.device)
            p[self._shard_index(idx, r)] = v


def head_shards(shape: Tuple[int, ...], axis: int, mesh: TpMesh,
                dtype: torch.dtype) -> HeadShards:
    """A zero ``HeadShards`` of global ``shape`` split along ``axis``."""
    if shape[axis] % mesh.tp:
        raise ValueError(
            f"head axis of size {shape[axis]} does not split over "
            f"tp={mesh.tp}")
    local = list(shape)
    local[axis] //= mesh.tp
    return HeadShards([torch.zeros(local, dtype=dtype, device=d)
                       for d in mesh.devices], axis, mesh)
