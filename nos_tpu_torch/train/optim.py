"""Optimizer construction for the trainer (port of
``nos_tpu/train/optim.py``): schedules, clipping, accumulation.

The reference builds one optax chain, ``clip_by_global_norm`` ->
``adamw(schedule)`` [-> ``MultiSteps``]; this module builds the same
update over a list of leaf tensors, updating them IN PLACE, in optax's
own order of operations:

- the schedule is read at the count of updates applied BEFORE this one
  (so linear warmup gives lr 0 on the first update);
- adamw is optax's sequence, each operation rounded to the leaf's dtype
  and its constants (betas, eps, decay, bias corrections, the step)
  rounded to that dtype first, as JAX does with a Python scalar beside a
  bf16 array; so a bf16 leaf takes optax's bits, not those of an f32
  update rounded once. On the card ``csrc/adamw.cu`` runs it in one
  launch per leaf; on the CPU ``adamw_update_reference`` (the plain
  version) does;
- weight decay applies to every leaf, norms and embedding included;
- the moments are kept in the params' dtype (optax's ``mu_dtype=None``);
- global-norm clipping has no epsilon: ``g * max_norm / ||g||`` once
  ``||g|| >= max_norm``;
- accumulation averages k micro-step gradients with MultiSteps' running
  mean and applies one update on the k-th call; the schedule counts
  updates, not micro-steps.

Under a training layout the leaves are one rank's parts (their
gradients already averaged over the data ranks): adamw and the
accumulation run on them unchanged, one adamw launch a leaf, and the
clip's norm sums each split leaf's squares over its parts
(``shard_sums``: ``parallel/mesh.py::TrainMesh.shard_sums``).

The state (``state_dict``: the update count, the moments, and under
accumulation the running mean and its micro-step) is what a checkpoint
carries as ``opt_state``, as optax's state is in the reference, and
``load_state_dict`` puts it back in place.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["build_lr_schedule", "build_optimizer", "TrainOptimizer",
           "adamw_consts", "adamw_update", "adamw_update_reference"]

Schedule = Callable[[int], float]
# per leaf, this rank's part's sum -> the leaf's sum over its parts
ShardSums = Callable[[Sequence[torch.Tensor]], List[torch.Tensor]]
# optax.adamw's eps (the reference leaves it at the default)
EPS = 1e-8


def build_lr_schedule(
    base_lr: float,
    total_steps: int,
    *,
    warmup_steps: int = 0,
    schedule: str = "constant",
    min_lr_ratio: float = 0.0,
) -> Schedule:
    """Linear warmup (optional) into a constant or cosine-decay schedule,
    as a function of the update count. ``min_lr_ratio`` is the cosine
    floor as a fraction of base_lr (optax's ``alpha``)."""
    if schedule not in ("constant", "cosine"):
        raise ValueError(f"unknown lr schedule {schedule!r}")
    decay_steps = max(1, total_steps - warmup_steps)

    def main(count: int) -> float:
        if schedule == "constant":
            return base_lr
        c = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return base_lr * ((1 - min_lr_ratio) * cosine + min_lr_ratio)

    if warmup_steps <= 0:
        return main

    def joined(count: int) -> float:
        if count < warmup_steps:
            return base_lr * count / warmup_steps
        return main(count - warmup_steps)

    return joined


def adamw_consts(dtype: torch.dtype, count: int, lr: float, *, b1: float,
                 b2: float, eps: float,
                 weight_decay: float) -> Tuple[float, ...]:
    """The update's constants for the ``count``-th update (1-based), each
    rounded to ``dtype`` as optax's are: (1 - b1, b1, 1 - b2, b2, bc1,
    bc2, eps, weight_decay, -lr), with bc = 1 - b^count in f32 (numpy's
    f32 power, the value XLA computes)."""
    def bc(b: float) -> float:
        return float(np.float32(1) - np.float32(b) ** np.float32(count))

    vals = (1 - b1, b1, 1 - b2, b2, bc(b1), bc(b2), eps, weight_decay,
            -float(np.float32(lr)))
    return tuple(torch.tensor(vals, dtype=dtype).tolist())


@torch.no_grad()
def adamw_update_reference(p: torch.Tensor, g: torch.Tensor,
                           mu: torch.Tensor, nu: torch.Tensor,
                           consts: Tuple[float, ...]) -> None:
    """The plain version of ``csrc/adamw.cu``: optax's adamw on one leaf
    in place, one eager op per optax op (each rounded to the dtype).
    Quotients take a divisor tensor on the leaf's device, so the card
    runs them as true divisions."""
    c1, b1, c2, b2, bc1, bc2, eps, wd, step = consts
    mu.mul_(b1).add_(g * c1)
    nu.mul_(b2).add_((g * g) * c2)
    def full(v: float) -> torch.Tensor:
        return torch.full((), v, dtype=p.dtype, device=p.device)

    u = (mu / full(bc1)) / ((nu / full(bc2)).sqrt() + eps)
    u = (u + p * wd) * step
    p.add_(u)


def adamw_update(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                 nu: torch.Tensor, consts: Tuple[float, ...]) -> None:
    """One leaf's adamw update in place: the CUDA kernel for a leaf on
    the card, the plain version for a leaf on the CPU."""
    if p.device.type == "cuda":
        from nos_tpu_torch.ops import _kernels

        _kernels.adamw.launch(p, g.contiguous(), mu, nu, consts)
    else:
        adamw_update_reference(p, g, mu, nu, consts)


class TrainOptimizer:
    """clip_by_global_norm -> adamw(schedule) [-> MultiSteps(k)] over
    ``params``. ``step()`` consumes each param's ``.grad`` and clears it;
    ``mu``/``nu`` hold the moments, one per param, in its dtype.
    ``fence(event)`` makes the next step's in-place writes wait for a
    device event: an asynchronous checkpoint's copy of these tensors.
    ``shard_sums`` (a layout's) completes the clip's per-leaf sums of
    squares over the leaves' parts."""

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule, *,
                 weight_decay: float, b1: float, b2: float,
                 grad_clip: float, accum_steps: int,
                 shard_sums: Optional[ShardSums] = None):
        self.params: List[torch.Tensor] = list(params)
        self.lr = lr
        self.weight_decay = weight_decay
        self.b1, self.b2 = b1, b2
        self.grad_clip = grad_clip
        self.accum_steps = accum_steps
        self.count = 0              # updates applied (the schedule's count)
        self.mini_step = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self._acc = ([torch.zeros_like(p) for p in self.params]
                     if accum_steps > 1 else None)
        self._fences: list = []
        self.shard_sums = shard_sums

    def state_dict(self) -> dict:
        """The state as named leaves: ``count`` (updates applied),
        ``mu``, ``nu`` (lists in the params' order), and with
        accumulation ``mini_step`` and ``acc``. The tensors are the live
        ones, not copies."""
        state = {"count": self.count, "mu": list(self.mu),
                 "nu": list(self.nu)}
        if self._acc is not None:
            state.update(mini_step=self.mini_step, acc=list(self._acc))
        return state

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Put ``state_dict()``'s leaves back, the tensors in place."""
        want = self.state_dict()
        if set(state) != set(want):
            raise ValueError(f"optimizer state keys {sorted(state)} != "
                             f"{sorted(want)}")
        for key in ("mu", "nu", "acc"):
            for dst, src in zip(want.get(key, ()), state.get(key, ())):
                if dst is not src:
                    dst.copy_(src)
        self.count = int(state["count"])
        self.mini_step = int(state.get("mini_step", 0))

    def fence(self, event: Optional["torch.cuda.Event"]) -> None:
        """The next ``step()`` waits, on its device's current stream, for
        ``event`` before it writes a tensor in place (None: nothing)."""
        if event is not None:
            self._fences.append(event)

    @torch.no_grad()
    def _clip(self, grads: List[torch.Tensor]) -> None:
        """optax's ``clip_by_global_norm``: the norm summed leaf by leaf
        in the leaves' dtype, compared with the limit in that dtype."""
        sums = [torch.sum(g * g) for g in grads]
        if self.shard_sums is not None:
            sums = self.shard_sums(sums)
        norm = torch.sqrt(sum(sums))
        keep = norm < torch.full((), self.grad_clip, dtype=norm.dtype,
                                 device=norm.device)
        for g in grads:
            limit = torch.tensor(self.grad_clip, dtype=g.dtype).item()
            g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * limit))

    @torch.no_grad()
    def step(self) -> None:
        for event in self._fences:
            torch.cuda.current_stream(self.params[0].device).wait_event(
                event)
        self._fences.clear()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self._acc is not None:
            n = self.mini_step
            for a, g in zip(self._acc, grads):
                # a tensor divisor: a true division on the card too
                a.add_((g - a) / torch.full((), n + 1, dtype=a.dtype,
                                            device=a.device))
            self.mini_step = (n + 1) % self.accum_steps
            if self.mini_step:
                self.zero_grad()
                return
            grads = [a.clone() for a in self._acc]
            for a in self._acc:
                a.zero_()
        if self.grad_clip > 0:
            self._clip(grads)
        lr = self.lr(self.count)
        self.count += 1
        consts = {}
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            if p.dtype not in consts:
                consts[p.dtype] = adamw_consts(
                    p.dtype, self.count, lr, b1=self.b1, b2=self.b2,
                    eps=EPS, weight_decay=self.weight_decay)
            adamw_update(p, g.to(p.dtype), mu, nu, consts[p.dtype])
        self.zero_grad()

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


def build_optimizer(
    params: Iterable[torch.Tensor],
    base_lr: float,
    total_steps: int,
    *,
    warmup_steps: int = 0,
    schedule: str = "constant",
    min_lr_ratio: float = 0.0,
    weight_decay: float = 0.01,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 0.0,
    accum_steps: int = 1,
    shard_sums: Optional[ShardSums] = None,
) -> TrainOptimizer:
    """adamw with the configured schedule, optional global-norm clipping,
    optional gradient accumulation, over ``params`` (leaf tensors).

    ``total_steps``/``warmup_steps`` are in caller steps (micro-steps):
    with accum_steps > 1 the update count advances once per window, so
    the horizons are converted to update units here, as the reference
    does. ``shard_sums``: ``TrainOptimizer``'s, under a layout."""
    if accum_steps > 1:
        total_steps = -(-total_steps // accum_steps)     # ceil div
        warmup_steps = -(-warmup_steps // accum_steps)
    lr = build_lr_schedule(
        base_lr, total_steps, warmup_steps=warmup_steps, schedule=schedule,
        min_lr_ratio=min_lr_ratio)
    return TrainOptimizer(params, lr, weight_decay=weight_decay, b1=b1,
                          b2=b2, grad_clip=grad_clip,
                          accum_steps=accum_steps, shard_sums=shard_sums)
