"""Optimizer construction for the trainer (port of
``nos_tpu/train/optim.py``): schedules, clipping, accumulation.

The reference builds one optax chain, ``clip_by_global_norm`` ->
``adamw(schedule)`` [-> ``MultiSteps``]; this module builds the same
update on ``torch.optim.AdamW`` over a list of leaf tensors, updating
them IN PLACE. Where the two libraries differ it follows optax:

- the schedule is read at the count of updates applied BEFORE this one
  (so linear warmup gives lr 0 on the first update);
- weight decay applies to every leaf, norms and embedding included;
- the moments are kept in the params' dtype (AdamW's ``zeros_like``, as
  optax's ``mu_dtype=None``);
- global-norm clipping has no epsilon: ``g * max_norm / ||g||`` once
  ``||g|| >= max_norm`` (``clip_grad_norm_`` would add 1e-6);
- accumulation averages k micro-step gradients with MultiSteps' running
  mean and applies one update on the k-th call; the schedule counts
  updates, not micro-steps.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, List

import torch

__all__ = ["build_lr_schedule", "build_optimizer", "TrainOptimizer"]

Schedule = Callable[[int], float]


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


class TrainOptimizer:
    """clip_by_global_norm -> adamw(schedule) [-> MultiSteps(k)] over
    ``params``. ``step()`` consumes each param's ``.grad`` and clears it."""

    def __init__(self, params: Iterable[torch.Tensor], lr: Schedule, *,
                 weight_decay: float, b1: float, b2: float,
                 grad_clip: float, accum_steps: int):
        self.params: List[torch.Tensor] = list(params)
        self.lr = lr
        self.grad_clip = grad_clip
        self.accum_steps = accum_steps
        self.count = 0              # updates applied (the schedule's count)
        self.mini_step = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=lr(0), betas=(b1, b2), eps=1e-8,
            weight_decay=weight_decay)
        self._acc = ([torch.zeros_like(p) for p in self.params]
                     if accum_steps > 1 else None)

    @torch.no_grad()
    def _clip(self, grads: List[torch.Tensor]) -> None:
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        keep = norm < self.grad_clip
        for g in grads:
            g.copy_(torch.where(keep, g,
                                g / norm.to(g.dtype) * self.grad_clip))

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self._acc is not None:
            n = self.mini_step
            for a, g in zip(self._acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step = (n + 1) % self.accum_steps
            if self.mini_step:
                self.zero_grad()
                return
            grads = [a.clone() for a in self._acc]
            for a in self._acc:
                a.zero_()
        if self.grad_clip > 0:
            self._clip(grads)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.adamw.param_groups:
            group["lr"] = self.lr(self.count)
        self.adamw.step()
        self.count += 1
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
) -> TrainOptimizer:
    """adamw with the configured schedule, optional global-norm clipping,
    optional gradient accumulation, over ``params`` (leaf tensors).

    ``total_steps``/``warmup_steps`` are in caller steps (micro-steps):
    with accum_steps > 1 the update count advances once per window, so
    the horizons are converted to update units here, as the reference
    does."""
    if accum_steps > 1:
        total_steps = -(-total_steps // accum_steps)     # ceil div
        warmup_steps = -(-warmup_steps // accum_steps)
    lr = build_lr_schedule(
        base_lr, total_steps, warmup_steps=warmup_steps, schedule=schedule,
        min_lr_ratio=min_lr_ratio)
    return TrainOptimizer(params, lr, weight_decay=weight_decay, b1=b1,
                          b2=b2, grad_clip=grad_clip,
                          accum_steps=accum_steps)
