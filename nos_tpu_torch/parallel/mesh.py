"""The meshes of the port (``nos_tpu/parallel/mesh.py``'s part that lays
devices out over a layout's axes), and the collectives that cross them,
written once here.

Serving: ``TpMesh``, an ordered list of ``tp`` devices. The engine is
single-controller, as the reference's is (one decode program spans the
chips, host control flow unchanged): one process keeps the scheduler,
the block tables and the allocator once, and applies each device op to
every shard. A tensor split over the mesh along its head axis is a
``HeadShards``; the residual stream, ``pos`` and the block tables live
on shard 0's device and are copied to the others.

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
on one card.

Training: ``TrainMesh``, one rank's view of a ``ParallelLayout``'s dp,
fsdp and tp axes over a ``torch.distributed`` process group (SPMD, one
process a rank, as the reference's GSPMD program is one per chip). Ranks
lie over the reference's axis order, tp innermost (``arrange_devices``
keeps tp on adjacent chips): rank = (dp_i x fsdp + fsdp_i) x tp + tp_i.
The batch is split over dp x fsdp (``data_sharding``), dp outer. The
collectives, as autograd functions:

- tp (Megatron's): ``copy_to_tp`` (identity forward, all-reduce of the
  gradient) before a column-parallel product, ``reduce_from_tp``
  (all-reduce forward, identity backward) after a row-parallel one;
- fsdp (ZeRO-3's): ``gather_fsdp`` (all-gather forward, reduce-scatter
  backward) just before a leaf is used;
- ``grad_mean``: identity forward; backward the gradient's mean over
  the data ranks that hold the leaf whole (dp; dp x fsdp for a leaf
  fsdp does not split, whose gather already summed over fsdp);
- ``data_mean``: the mean over the data ranks, forward and backward
  (the MoE load-balancing loss's batch statistics).

Every collective is an ``all_reduce``: an all-gather is the all-reduce
of a zero-filled full buffer holding only the rank's slice (exact), a
reduce-scatter an all-reduce and the rank's slice. gloo on CUDA tensors
offers only ``all_reduce`` and ``broadcast``, so one code path serves
the card, the CPU tests and NCCL.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from nos_tpu_torch.parallel.layout import ParallelLayout

__all__ = ["TpMesh", "HeadShards", "head_shards", "TrainMesh"]


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


# ---------------------------------------------------------------------------
# training: one rank of a dp x fsdp x tp layout over torch.distributed
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A contiguous copy of ``x`` reduced over ``group`` (None: the copy
    alone, a group of one)."""
    y = x.clone(memory_format=torch.contiguous_format)
    if group is not None:
        dist.all_reduce(y, op=op, group=group)
    return y


def _placed(x: torch.Tensor, dim: int, index: int, size: int) -> torch.Tensor:
    """Zeros ``size`` times ``x``'s extent along ``dim``, holding ``x`` in
    slot ``index``."""
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = n * size
    full = x.new_zeros(shape)
    full.narrow(dim, index * n, n).copy_(x)
    return full


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` (slot ``index`` of ``size``); backward a
    reduce-scatter: the gradient summed over the group (its ranks hold
    different data), the rank's slice of it."""

    @staticmethod
    def forward(ctx, x, dim, index, size, group):
        ctx.dim, ctx.index, ctx.n, ctx.group = dim, index, x.shape[dim], group
        full = _placed(x, dim, index, size)
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        return (g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n).contiguous(),
                None, None, None, None)


class _Mean(torch.autograd.Function):
    """The mean over ``group`` of ``size`` ranks: of the forward value
    too when ``forward_too`` (else identity), of the gradient always."""

    @staticmethod
    def forward(ctx, x, group, size, forward_too):
        ctx.group, ctx.size = group, size
        if forward_too:
            return _all_reduce(x, group).div_(size)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group).div_(ctx.size), None, None, None


def mesh_backend(devices: Sequence[Union[str, torch.device]]) -> str:
    """NCCL when every rank has a CUDA device of its own, else gloo (ranks
    that share a device, and the CPU: NCCL refuses two ranks on one
    device)."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and \
            len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


class TrainMesh:
    """This rank's place in a dp x fsdp x tp layout, its process groups
    (one per axis of size > 1, the data group dp x fsdp, and the model
    group tp x fsdp: None where a group would hold this rank alone) and
    its device. The default process group must hold ``layout.chips``
    ranks (``init_train_mesh``)."""

    def __init__(self, layout: ParallelLayout,
                 device: Union[str, torch.device]):
        world, rank = dist.get_world_size(), dist.get_rank()
        if layout.chips != world:
            raise ValueError(f"layout needs {layout.chips} ranks, the "
                             f"process group has {world}")
        self.layout = layout
        self.rank, self.world = rank, world
        self.device = torch.device(device)
        self.dp, self.fsdp, self.tp = layout.dp, layout.fsdp, layout.tp
        tp, fsdp = self.tp, self.fsdp
        self.tp_index = rank % tp
        self.fsdp_index = rank // tp % fsdp
        self.dp_index = rank // (tp * fsdp)
        self.data_size = self.dp * fsdp
        self.data_index = self.dp_index * fsdp + self.fsdp_index
        # every rank creates every group, in one order
        self.tp_group = self._group(tp, lambda r: r // tp)
        self.fsdp_group = self._group(
            fsdp, lambda r: (r // (tp * fsdp), r % tp))
        self.dp_group = self._group(self.dp, lambda r: r % (tp * fsdp))
        self.data_group = self._group(self.data_size, lambda r: r % tp)
        self.model_group = self._group(tp * fsdp,
                                       lambda r: r // (tp * fsdp))

    def _group(self, size: int, key: Callable[[int], object]):
        if size == 1:
            return None
        members: dict = {}
        for r in range(self.world):
            members.setdefault(key(r), []).append(r)
        mine = None
        for k in sorted(members):
            group = dist.new_group(members[k])
            if self.rank in members[k]:
                mine = group
        return mine

    def __repr__(self) -> str:
        return (f"TrainMesh(dp={self.dp}, fsdp={self.fsdp}, tp={self.tp}, "
                f"rank={self.rank}, device={self.device})")

    # -- collectives under autograd -------------------------------------
    def copy_to_tp(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else _CopyTo.apply(x, self.tp_group)

    def reduce_from_tp(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else _ReduceFrom.apply(x, self.tp_group)

    def gather_fsdp(self, x: torch.Tensor,
                    dim: Optional[int]) -> torch.Tensor:
        """The leaf whole over fsdp (``dim`` None: not split, as is)."""
        if dim is None or self.fsdp == 1:
            return x
        return _Gather.apply(x, dim % x.dim(), self.fsdp_index, self.fsdp,
                             self.fsdp_group)

    def grad_mean(self, leaf: torch.Tensor, fsdp_split: bool) -> torch.Tensor:
        """``leaf`` as is; its gradient averaged over the data ranks
        (those holding it whole: dp when fsdp splits it, its gather
        having summed the fsdp ranks' already)."""
        if self.data_size == 1:
            return leaf
        group = self.dp_group if fsdp_split and self.fsdp > 1 \
            else self.data_group
        return _Mean.apply(leaf, group, self.data_size, False)

    def data_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the data ranks, forward and backward."""
        if self.data_size == 1:
            return x
        return _Mean.apply(x, self.data_group, self.data_size, True)

    # -- plain collectives ----------------------------------------------
    def all_reduce_tp_(self, x: torch.Tensor,
                       op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` reduced over tp, in place (no gradient)."""
        if self.tp > 1:
            dist.all_reduce(x, op=op, group=self.tp_group)
        return x

    def barrier(self) -> None:
        dist.all_reduce(torch.zeros(1, device=self.device))

    def flags(self, values: Sequence[float]) -> List[float]:
        """``values`` summed over every rank (one small all-reduce)."""
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.all_reduce(t)
        return t.tolist()

    # -- leaves: full <-> this rank's part ------------------------------
    def local_part(self, full: torch.Tensor, tp_axis: Optional[int],
                   fsdp_axis: Optional[int]) -> torch.Tensor:
        """This rank's block of a full leaf: its tp slice along
        ``tp_axis``, then its fsdp slice along ``fsdp_axis`` (None: not
        split), a contiguous tensor of its own."""
        part = full
        for axis, n, i in ((tp_axis, self.tp, self.tp_index),
                           (fsdp_axis, self.fsdp, self.fsdp_index)):
            if axis is not None and n > 1:
                if part.shape[axis] % n:
                    raise ValueError(f"axis of size {part.shape[axis]} "
                                     f"does not split over {n} ranks")
                part = part.chunk(n, axis)[i]
        return part.clone(memory_format=torch.contiguous_format)

    def _counts(self, tp_axis: Optional[int],
                fsdp_axis: Optional[int]) -> bool:
        """Whether this rank's part of a leaf split along these axes is
        the one its model group counts: a leaf is whole across a model
        axis that does not split it, so only index 0 there counts."""
        return ((tp_axis is not None or self.tp_index == 0)
                and (fsdp_axis is not None or self.fsdp_index == 0))

    def full_leaf(self, part: torch.Tensor, tp_axis: Optional[int],
                  fsdp_axis: Optional[int]) -> torch.Tensor:
        """``local_part``'s inverse, on every rank: one all-reduce over
        every rank of a zero-filled full tensor holding the parts the
        dp-index-0 model group counts (``_counts``; exact)."""
        full = part
        for axis, n, i in ((fsdp_axis, self.fsdp, self.fsdp_index),
                           (tp_axis, self.tp, self.tp_index)):
            if axis is not None and n > 1:
                full = _placed(full, axis % full.dim(), i, n)
        if full is part:
            full = part.clone(memory_format=torch.contiguous_format)
        if self.dp_index or not self._counts(tp_axis, fsdp_axis):
            full.zero_()
        dist.all_reduce(full)
        return full

    def shard_sums(self, partials: Sequence[torch.Tensor],
                   splits: Sequence[Tuple[Optional[int], Optional[int]]]
                   ) -> List[torch.Tensor]:
        """Per leaf, the sum over its parts of ``partials`` (each a
        0-d tensor: this rank's part's sum; ``splits`` each leaf's (tp,
        fsdp) axes): one all-reduce over the model group, in f32, where a
        leaf a model axis does not split counts once (from index 0 on
        that axis). Each sum comes back in its partial's dtype."""
        if self.model_group is None:
            return list(partials)
        # the model group holds one dp index: this rank's own
        vals = [s.float() if self._counts(*axes) else torch.zeros(
                    (), dtype=torch.float32, device=s.device)
                for s, axes in zip(partials, splits)]
        total = torch.stack(vals)
        dist.all_reduce(total, group=self.model_group)
        return [t.to(s.dtype) for t, s in zip(total, partials)]


def init_train_mesh(layout: ParallelLayout, rank: int,
                    devices: Sequence[Union[str, torch.device]],
                    store_path: str, timeout_s: float) -> TrainMesh:
    """Join the layout's process group as ``rank`` (rendezvous through a
    file store at ``store_path``; every collective, and the rendezvous,
    raises after ``timeout_s``) and build its ``TrainMesh`` on
    ``devices[rank]``. ``dist.destroy_process_group()`` ends it."""
    from datetime import timedelta

    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        mesh_backend(devices), init_method=f"file://{store_path}",
        rank=rank, world_size=len(devices),
        timeout=timedelta(seconds=timeout_s))
    return TrainMesh(layout, device)
