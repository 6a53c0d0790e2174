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
fsdp, tp, pp, sp and ep axes over a ``torch.distributed`` process group
(SPMD, one process a rank, as the reference's GSPMD program is one per
chip). Ranks lie over the reference's axis order (dp, fsdp, tp, pp, sp,
ep; ep innermost), so a rank's coordinates read as the reference mesh's
device's: rank = ((((dp_i x fsdp + fsdp_i) x tp + tp_i) x pp + pp_i) x
sp + sp_i) x ep + ep_i. The batch is split over dp x fsdp
(``data_sharding``), dp outer, and every activation's sequence over sp;
every ep rank holds the same tokens; a pp rank holds its stage's layers
(``parallel/pipeline.py``). Every group but pp's holds ranks of one pp
index, so a stage's collectives run among the ranks that run the stage.
The collectives, as autograd functions:

- tp (Megatron's): ``copy_to_tp`` (identity forward, all-reduce of the
  gradient) before a column-parallel product, ``reduce_from_tp``
  (all-reduce forward, identity backward) after a row-parallel one; the
  same over tp x ep around the MoE's experts (``copy_to_experts``,
  ``reduce_from_experts``);
- fsdp (ZeRO-3's): ``gather_fsdp`` (all-gather forward, reduce-scatter
  backward) just before a leaf is used;
- sp: ``ring_step`` (the ring's ``ppermute`` to the next rank; backward
  the inverse permutation), ``all_to_all_sp`` (Ulysses' exchange;
  backward the inverse exchange) and ``gather_sp`` (all-gather along
  the sequence, backward a reduce-scatter: the MoE gating's logits);
- ``grad_mean``: identity forward; backward the gradient's mean over
  the ranks that hold distinct tokens of the leaf whole (dp x sp; and
  fsdp for a leaf fsdp does not split, whose gather already summed over
  fsdp);
- ``data_mean``: the mean over the data ranks (dp x fsdp), forward and
  backward (the MoE load-balancing loss's batch statistics), and
  ``token_mean`` the same over dp x fsdp x sp (the loss).

The pipeline's hops are plain collectives (its schedule passes the
cotangents itself): ``pp_hop`` carries one tick's activations (stage p
to p + 1) and cotangents (p + 1 to p) in one all-reduce, and
``grad_mean_`` / ``pp_sum_`` average or sum a gradient once the
schedule has accumulated it.

Every collective is an ``all_reduce``: an all-gather is the all-reduce
of a zero-filled full buffer holding only the rank's slice (exact), a
reduce-scatter an all-reduce and the rank's slice, a ring step or an
all-to-all the all-reduce of a zero-filled buffer with a slot per rank
and the slice the rank receives (the all-to-all's without the pieces a
rank keeps). gloo on CUDA tensors offers only
``all_reduce`` and ``broadcast``, so one code path serves the card, the
CPU tests and NCCL.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

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


def _exchange(x: torch.Tensor, slot: int, take: int, size: int,
              group) -> torch.Tensor:
    """One all-reduce of zeros ``[size, *x.shape]`` holding ``x`` in
    ``slot``; returns slot ``take`` of the sum (what the rank whose slot
    that is holds)."""
    buf = x.new_zeros((size,) + tuple(x.shape))
    buf[slot].copy_(x)
    dist.all_reduce(buf, group=group)
    return buf[take]


class _RingStep(torch.autograd.Function):
    """The ring's ``ppermute`` (i -> i + 1): this rank receives the
    previous rank's ``x``; backward the inverse permutation, so each
    gradient goes back to the rank whose block it is."""

    @staticmethod
    def forward(ctx, x, index, size, group):
        ctx.index, ctx.size, ctx.group = index, size, group
        return _exchange(x, index, (index - 1) % size, size, group)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(g.contiguous(), ctx.index,
                          (ctx.index + 1) % ctx.size, ctx.size, ctx.group),
                None, None, None)


def _all_to_all(x: torch.Tensor, index: int, size: int,
                group) -> torch.Tensor:
    """``x`` [size, ...]: piece j goes to rank j; returns [size, ...],
    piece j the one rank j sent here. One all-reduce of zeros [size
    (to), size - 1 (from, the receiver skipped), ...]: a rank keeps its
    own piece, so only the pieces that cross ranks are in the buffer."""
    buf = x.new_zeros((size, size - 1) + tuple(x.shape[1:]))
    for j in range(size):
        if j != index:
            buf[j, index - (index > j)].copy_(x[j])
    dist.all_reduce(buf, group=group)
    got = buf[index]
    return torch.cat((got[:index], x[index:index + 1], got[index:]))


class _AllToAll(torch.autograd.Function):
    """``_all_to_all`` under autograd: its own inverse, so the backward
    is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, index, size, group):
        ctx.index, ctx.size, ctx.group = index, size, group
        return _all_to_all(x, index, size, group)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g.contiguous(), ctx.index, ctx.size, ctx.group),
                None, None, None)


def mesh_backend(devices: Sequence[Union[str, torch.device]]) -> str:
    """NCCL when every rank has a CUDA device of its own, else gloo (ranks
    that share a device, and the CPU: NCCL refuses two ranks on one
    device)."""
    return gang_backend([f"cuda:{d.index}" if d.type == "cuda" else d.type
                         for d in map(torch.device, devices)])


# the reference's axis order (``parallel/layout.py``), outermost first
_AXES = ("dp", "fsdp", "tp", "pp", "sp", "ep")


class TrainMesh:
    """This rank's place in a dp x fsdp x tp x pp x sp x ep layout, its
    process groups and its device. A group is named by the axes its
    ranks differ in (``_group``: None where it would hold this rank
    alone). The default process group must hold ``layout.chips`` ranks
    (``init_train_mesh``)."""

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
        self.pp, self.sp, self.ep = layout.pp, layout.sp, layout.ep
        (self.dp_index, self.fsdp_index, self.tp_index, self.pp_index,
         self.sp_index, self.ep_index) = self._coords(rank)
        self.data_size = self.dp * self.fsdp
        self.data_index = self.dp_index * self.fsdp + self.fsdp_index
        self.token_size = self.data_size * self.sp
        # every rank creates every group, in one order
        self._groups: dict = {}
        self.tp_group = self._group("tp")
        self.fsdp_group = self._group("fsdp")
        self.sp_group = self._group("sp")
        self.ep_group = self._group("ep")
        self.pp_group = self._group("pp")
        self.data_group = self._group("dp", "fsdp")
        # the gradient mean: the ranks holding distinct tokens, without
        # fsdp for a leaf fsdp splits (its gather sums over fsdp)
        self.token_group = self._group("dp", "fsdp", "sp")
        self.token_dp_group = self._group("dp", "sp")
        # the experts' partial sums, and the clip's per-leaf sums (a
        # stage's layers are a part of each layer leaf)
        self.expert_group = self._group("tp", "ep")
        self.model_group = self._group("tp", "fsdp", "pp", "ep")

    def _coords(self, rank: int) -> Tuple[int, ...]:
        """(dp, fsdp, tp, pp, sp, ep) indices of ``rank``, ep
        innermost."""
        out = []
        for axis in reversed(_AXES):
            n = getattr(self.layout, axis)
            out.append(rank % n)
            rank //= n
        return tuple(reversed(out))

    def _group(self, *axes: str):
        """The group of the ranks that differ from this one only in
        ``axes`` (None when that is this rank alone); one group object
        per set of axes of size > 1."""
        live = tuple(a for a in _AXES if a in axes and getattr(self, a) > 1)
        if not live:
            return None
        if live in self._groups:
            return self._groups[live]
        keep = [i for i, a in enumerate(_AXES) if a not in live]
        members: dict = {}
        for r in range(self.world):
            c = self._coords(r)
            members.setdefault(tuple(c[i] for i in keep), []).append(r)
        mine = None
        for k in sorted(members):
            group = dist.new_group(members[k])
            if self.rank in members[k]:
                mine = group
        self._groups[live] = mine
        return mine

    def __repr__(self) -> str:
        return (f"TrainMesh(dp={self.dp}, fsdp={self.fsdp}, tp={self.tp}, "
                f"pp={self.pp}, sp={self.sp}, ep={self.ep}, "
                f"rank={self.rank}, device={self.device})")

    # -- collectives under autograd -------------------------------------
    def copy_to_tp(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else _CopyTo.apply(x, self.tp_group)

    def reduce_from_tp(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else _ReduceFrom.apply(x, self.tp_group)

    def copy_to_experts(self, x: torch.Tensor) -> torch.Tensor:
        """Identity; the gradient summed over tp x ep (the ranks that
        share the MoE FFN's tokens, each with its experts' d_ff
        slice)."""
        if self.expert_group is None:
            return x
        return _CopyTo.apply(x, self.expert_group)

    def reduce_from_experts(self, x: torch.Tensor) -> torch.Tensor:
        """The MoE FFN's partial outputs summed over tp x ep."""
        if self.expert_group is None:
            return x
        return _ReduceFrom.apply(x, self.expert_group)

    def gather_fsdp(self, x: torch.Tensor,
                    dim: Optional[int]) -> torch.Tensor:
        """The leaf whole over fsdp (``dim`` None: not split, as is)."""
        if dim is None or self.fsdp == 1:
            return x
        return _Gather.apply(x, dim % x.dim(), self.fsdp_index, self.fsdp,
                             self.fsdp_group)

    def gather_sp(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x``'s sequence chunks along ``dim`` concatenated over sp, in
        sp order; the gradient summed over sp, this rank's chunk of
        it."""
        if self.sp == 1:
            return x
        return _Gather.apply(x, dim % x.dim(), self.sp_index, self.sp,
                             self.sp_group)

    def ring_step(self, x: torch.Tensor) -> torch.Tensor:
        """The previous sp rank's ``x`` (the ring's ``ppermute`` i ->
        i + 1)."""
        return _RingStep.apply(x.contiguous(), self.sp_index, self.sp,
                               self.sp_group)

    def all_to_all_sp(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [sp, ...]: piece j to sp rank j; returns [sp, ...],
        piece j from sp rank j."""
        return _AllToAll.apply(x.contiguous(), self.sp_index, self.sp,
                               self.sp_group)

    def _grad_group(self, fsdp_split: bool):
        """The ranks a leaf's gradient is averaged over: those holding
        distinct tokens (dp x sp when fsdp splits the leaf, its gather
        having summed the fsdp ranks' already; dp x fsdp x sp
        otherwise)."""
        return self.token_dp_group if fsdp_split and self.fsdp > 1 \
            else self.token_group

    def grad_mean(self, leaf: torch.Tensor, fsdp_split: bool) -> torch.Tensor:
        """``leaf`` as is; its gradient averaged over the ranks holding
        distinct tokens (``_grad_group``)."""
        if self.token_size == 1:
            return leaf
        return _Mean.apply(leaf, self._grad_group(fsdp_split),
                           self.token_size, False)

    def data_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the data ranks, forward and backward."""
        if self.data_size == 1:
            return x
        return _Mean.apply(x, self.data_group, self.data_size, True)

    def token_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the data and sp ranks, forward and
        backward: a loss each rank took over its own tokens."""
        if self.token_size == 1:
            return x
        return _Mean.apply(x, self.token_group, self.token_size, True)

    # -- plain collectives ----------------------------------------------
    def all_reduce_tp_(self, x: torch.Tensor,
                       op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` reduced over tp, in place (no gradient)."""
        if self.tp > 1:
            dist.all_reduce(x, op=op, group=self.tp_group)
        return x

    def grad_mean_(self, grad: torch.Tensor, fsdp_split: bool) -> None:
        """``grad_mean``'s backward on a gradient already accumulated (the
        pipeline's, once per leaf after the schedule), in place."""
        if self.token_size > 1:
            group = self._grad_group(fsdp_split)
            if group is not None:       # None: this rank alone
                dist.all_reduce(grad, group=group)
            grad.div_(self.token_size)

    def pp_sum_(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the pp ranks, in place: the loss, and the
        gradients of the leaves every stage holds whole."""
        if self.pp > 1:
            dist.all_reduce(x, group=self.pp_group)
        return x

    def pp_hop(self, x: Optional[torch.Tensor], fwd: Sequence[int],
               bwd: Sequence[int], shape: Sequence[int],
               dtype: torch.dtype
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """One tick's hops over pp, the reference's two ``ppermute``s in
        one all-reduce of zeros with a slot per sending stage: stage q
        in ``fwd`` sends its activation to q + 1 (mod pp), stage q in
        ``bwd`` its cotangent to q - 1 (mod pp); ``x`` is this stage's
        (None when it is in neither), of ``shape`` and ``dtype``. Every
        pp rank calls it with the same static ``fwd`` and ``bwd`` (the
        schedule's), idle or not, so the gang stays in step; a tick in
        which no stage sends makes no collective on any rank. Returns
        (the activation stage p - 1 sent here, the cotangent stage p + 1
        sent here), None where it sent none."""
        senders = sorted(set(fwd) | set(bwd))
        if not senders:
            return None, None
        p = self.pp_index
        buf = torch.zeros((len(senders),) + tuple(shape), dtype=dtype,
                          device=self.device)
        if p in senders:
            buf[senders.index(p)].copy_(x.detach())
        dist.all_reduce(buf, group=self.pp_group)

        def slot(q: int) -> torch.Tensor:
            # a tensor of its own where the buffer holds other slots, so
            # a saved input keeps no other stage's bytes alive
            return buf[0] if len(senders) == 1 else \
                buf[senders.index(q)].clone()

        prev, nxt = (p - 1) % self.pp, (p + 1) % self.pp
        return (slot(prev) if prev in fwd else None,
                slot(nxt) if nxt in bwd else None)

    def barrier(self) -> None:
        dist.all_reduce(torch.zeros(1, device=self.device))

    def flags(self, values: Sequence[float]) -> List[float]:
        """``values`` summed over every rank (one small all-reduce)."""
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.all_reduce(t)
        return t.tolist()

    # -- leaves: full <-> this rank's part ------------------------------
    def _cuts(self, tp_axis: Optional[int], fsdp_axis: Optional[int],
              ep_axis: Optional[int], pp_axis: Optional[int]) -> tuple:
        return ((tp_axis, self.tp, self.tp_index),
                (fsdp_axis, self.fsdp, self.fsdp_index),
                (ep_axis, self.ep, self.ep_index),
                (pp_axis, self.pp, self.pp_index))

    def local_part(self, full: torch.Tensor, tp_axis: Optional[int],
                   fsdp_axis: Optional[int], ep_axis: Optional[int] = None,
                   pp_axis: Optional[int] = None) -> torch.Tensor:
        """This rank's block of a full leaf: its tp slice along
        ``tp_axis``, its fsdp slice along ``fsdp_axis``, its ep slice
        (its experts) along ``ep_axis`` and its stage's layers along
        ``pp_axis`` (None: not split), a contiguous tensor of its own."""
        part = full
        for axis, n, i in self._cuts(tp_axis, fsdp_axis, ep_axis, pp_axis):
            if axis is not None and n > 1:
                if part.shape[axis] % n:
                    raise ValueError(f"axis of size {part.shape[axis]} "
                                     f"does not split over {n} ranks")
                part = part.chunk(n, axis)[i]
        return part.clone(memory_format=torch.contiguous_format)

    def _counts(self, tp_axis: Optional[int], fsdp_axis: Optional[int],
                ep_axis: Optional[int] = None,
                pp_axis: Optional[int] = None) -> bool:
        """Whether this rank's part of a leaf split along these axes is
        the one its model group counts: a leaf is whole across a model
        axis that does not split it (the embeddings and final norm on
        every stage), so only index 0 there counts."""
        return all(axis is not None or i == 0 for axis, _, i in
                   self._cuts(tp_axis, fsdp_axis, ep_axis, pp_axis))

    def full_leaf(self, part: torch.Tensor, tp_axis: Optional[int],
                  fsdp_axis: Optional[int], ep_axis: Optional[int] = None,
                  pp_axis: Optional[int] = None) -> torch.Tensor:
        """``local_part``'s inverse, on every rank: one all-reduce over
        every rank of a zero-filled full tensor holding the parts the
        model group of dp index 0 and sp index 0 counts (``_counts``;
        exact)."""
        full = part
        for axis, n, i in self._cuts(tp_axis, fsdp_axis, ep_axis, pp_axis):
            if axis is not None and n > 1:
                full = _placed(full, axis % full.dim(), i, n)
        if full is part:
            full = part.clone(memory_format=torch.contiguous_format)
        if self.dp_index or self.sp_index or \
                not self._counts(tp_axis, fsdp_axis, ep_axis, pp_axis):
            full.zero_()
        dist.all_reduce(full)
        return full

    def shard_sums(self, partials: Sequence[torch.Tensor],
                   splits: Sequence[Tuple[Optional[int], ...]]
                   ) -> List[torch.Tensor]:
        """Per leaf, the sum over its parts of ``partials`` (each a
        0-d tensor: this rank's part's sum; ``splits`` each leaf's (tp,
        fsdp, ep, pp) axes): one all-reduce over the model group (tp x
        fsdp x pp x ep), in f32, where a leaf a model axis does not
        split counts once (from index 0 on that axis). Each sum comes
        back in its partial's dtype."""
        if self.model_group is None:
            return list(partials)
        # the model group holds one dp and one sp index: this rank's own
        vals = [s.float() if self._counts(*axes) else torch.zeros(
                    (), dtype=torch.float32, device=s.device)
                for s, axes in zip(partials, splits)]
        total = torch.stack(vals)
        dist.all_reduce(total, group=self.model_group)
        return [t.to(s.dtype) for t, s in zip(total, partials)]


def card_identity(device: Union[str, torch.device]) -> str:
    """What a rank publishes at a multi-host rendezvous to say which
    device it runs on: ``"cpu"``, or the card's UUID (two "hosts" that
    are one machine see one card under two names)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return f"cuda:{torch.cuda.get_device_properties(device).uuid}"


def gang_backend(identities: Sequence[str]) -> str:
    """``mesh_backend``'s rule over a gang's published
    ``card_identity``s, every host reaching the same answer from the
    same list: NCCL when every rank has a card of its own, else gloo."""
    if all(i.startswith("cuda:") for i in identities) and \
            len(set(identities)) == len(identities):
        return "nccl"
    return "gloo"


def init_train_mesh(layout: ParallelLayout, rank: int,
                    devices: Sequence[Union[str, torch.device]],
                    store: str, timeout_s: float) -> TrainMesh:
    """Join the layout's process group as ``rank`` on ``devices[rank]``
    (``devices`` by global rank) and build its ``TrainMesh``; every
    collective, and the rendezvous, raises after ``timeout_s``.
    ``dist.destroy_process_group()`` ends it.

    ``store`` is a file store's path (one host: the backend is
    ``mesh_backend(devices)``) or ``tcp://host:port`` (several hosts:
    global rank 0 serves the store there, each rank publishes its
    ``card_identity`` and every rank takes ``gang_backend``'s answer
    over them all; another host's entries of ``devices`` are not
    read)."""
    from datetime import timedelta

    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = timedelta(seconds=timeout_s)
    if not store.startswith("tcp://"):
        dist.init_process_group(
            mesh_backend(devices), init_method=f"file://{store}",
            rank=rank, world_size=len(devices), timeout=timeout)
        return TrainMesh(layout, device)
    host, port = store[len("tcp://"):].rsplit(":", 1)
    tcp = dist.TCPStore(host, int(port), world_size=layout.chips,
                        is_master=rank == 0, timeout=timeout,
                        wait_for_workers=False)
    tcp.set(f"card/{rank}", card_identity(device))
    keys = [f"card/{r}" for r in range(layout.chips)]
    tcp.wait(keys, timeout)
    backend = gang_backend([tcp.get(k).decode() for k in keys])
    dist.init_process_group(
        backend, store=dist.PrefixStore("pg", tcp), rank=rank,
        world_size=layout.chips, timeout=timeout)
    return TrainMesh(layout, device)
