"""Training cells: the port's training step (``models/transformer.py::
make_train_step`` with ``train/optim.py::build_optimizer``, as
``cmd/trainer.py`` builds them, the configuration's rope theta reaching
the model) on one device. Set-up builds the one step object, with its
weights from the seed, and drives it through its first ``warm_steps``
steps (the warm-up: every kernel is built and every shape met there);
the window then runs the same object's steps back to back, each on rows
of its own drawn from the seed. The float32 reference follows the first
``check_steps`` steps from the same weights and rows, the window's first
among them; every loss the window ran has to be finite."""
from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List

import torch

from portbench import check, model, train_reference
from portbench.trace import Tracer


def batch(dm: model.Dims, job: dict, seed: int, step: int, device) -> Dict:
    """Step ``step``'s rows: uniform random tokens, every row its own."""
    g = torch.Generator(device=device)
    g.manual_seed(seed * 1_000_003 + step)
    t = torch.randint(dm.vocab, (job["batch"], job["seq"] + 1), generator=g,
                      device=device)
    return {"tokens": t[:, :-1].contiguous(), "targets": t[:, 1:].contiguous()}


def build(cfg: dict, dm: model.Dims, job: dict, params: dict):
    from nos_tpu_torch.models import transformer as tfm
    from nos_tpu_torch.train.optim import build_optimizer

    tcfg = tfm.TransformerConfig(
        vocab=dm.vocab, d_model=dm.d_model, n_layers=dm.n_layers,
        n_heads=dm.n_heads, n_kv_heads=dm.n_kv_heads, d_ff=dm.d_ff,
        max_seq=dm.max_seq, rope_theta=dm.rope_theta, dtype=torch.bfloat16,
        n_experts=dm.n_experts, remat_policy=job["remat_policy"],
        loss_chunk=job.get("loss_chunk", 0))
    leaves = tfm.param_leaves(params)
    for p in leaves:
        p.requires_grad_()
    opt = job["optimizer"]
    optimizer = build_optimizer(
        leaves, opt["lr"], 10 ** 6, weight_decay=opt["weight_decay"],
        b1=opt["b1"], b2=opt["b2"], grad_clip=opt.get("grad_clip", 0.0))
    return tfm.make_train_step(tcfg, optimizer), optimizer, leaves


def _norm(t: torch.Tensor, device) -> float:
    """A tensor's norm summed in float64 on ``device`` (a float32 sum
    over a leaf of half a billion elements on the host drifts by
    percents)."""
    return float(torch.linalg.vector_norm(
        t.detach().to(device), dtype=torch.float64))


def _norms(ts, device) -> List[float]:
    return [_norm(t, device) for t in ts]


def gaps(prog: dict, ref: dict, device) -> dict:
    """The numbers compared: the worst step's loss gap over the
    reference's loss; by the worst leaf, the gap between the program's
    and the reference's first-gradient norms, and between their change
    norms after the checked steps, and the norm of the first gradients'
    difference ("grad_diff"), each over the larger of that leaf's
    reference norm and the median leaf's; and the count of the window's
    losses that are not finite. Leaves whose reference gradient is under
    a thousandth of the median leaf's move by round-off alone under Adam
    and are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                   ref["losses"]))
    med_g = statistics.median(ref["first_grad"])
    grad = max(abs(a - b) / max(b, med_g)
               for a, b in zip(prog["first_grad"], ref["first_grad"]))
    moved = [i for i, g in enumerate(ref["first_grad"]) if g >= 1e-3 * med_g]
    med_c = statistics.median(ref["change"][i] for i in moved)
    change = max(abs(prog["change"][i] - ref["change"][i])
                 / max(ref["change"][i], med_c) for i in moved)
    diff = max(_norm(a.to(device).float() - b.to(device).float(), device)
               / max(n, med_g)
               for a, b, n in zip(prog["first_grads"], ref["first_grads"],
                                  ref["first_grad"]))
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "grad_diff": diff,
            "window_nonfinite": sum(not math.isfinite(v)
                                    for v in prog.get("window_losses", [])),
            "leaves_left_out": len(ref["first_grad"]) - len(moved)}


def run(ctx) -> dict:
    cfg, job, dev = ctx.config, ctx.traffic, ctx.device
    cuda = dev.type == "cuda"
    dm = model.dims_of(cfg)
    timing = {}
    t = time.perf_counter()
    params = model.make_params(dm, ctx.seed, dev)
    step, optimizer, leaves = build(cfg, dm, job, params)
    elements = sum(p.numel() for p in leaves)
    b1 = job["optimizer"]["b1"]
    warm, k = job["warm_steps"], job["check_steps"]
    # the window's first step is among the checked ones
    assert 1 <= warm < k
    prog = {"losses": []}
    for i in range(warm):
        prog["losses"].append(float(step(params, batch(dm, job, ctx.seed, i,
                                                        dev))))
        if i == 0:
            # the gradient as adamw took it: mu after one update
            prog["first_grads"] = [(m.detach().float() / (1 - b1)).cpu()
                                   for m in optimizer.mu]
            prog["first_grad"] = _norms(optimizer.mu, dev)
            prog["first_grad"] = [n / (1 - b1) for n in prog["first_grad"]]
    if cuda:
        torch.cuda.synchronize()
    timing["set_up_steps_s"] = time.perf_counter() - t

    tokens = job["batch"] * job["seq"]
    steps = []                      # (start, end, traced)
    losses = []                     # every loss the window ran
    snapshot = None                 # the params after the k-th step
    tracer = Tracer(cuda) if ctx.trace else None
    i = warm
    open_at = time.perf_counter()
    close_at = open_at + ctx.seconds
    while True:
        t0 = time.perf_counter()
        # the window runs the checked steps, however short it is
        if t0 >= close_at and i >= k:
            break
        traced = tracer is not None and len(steps) == job["trace_after"]
        if traced:
            tracer.start()
        b = batch(dm, job, ctx.seed, i, dev)
        losses.append(float(step(params, b)))
        if i == k - 1:
            # a device copy of 2 bytes a parameter, read after the close
            snapshot = [p.detach().clone() for p in leaves]
        if traced:
            tracer.stop()
        steps.append((t0, time.perf_counter(), traced))
        i += 1
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    trace = tracer.reduce() if tracer is not None else None

    del step, optimizer, leaves, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    init_params = model.make_params(dm, ctx.seed, dev)
    prog["losses"] += losses[:k - warm]
    prog["window_losses"] = losses
    prog["change"] = _norms((p - q for p, q in zip(
        snapshot, train_reference.leaves(init_params))), dev)
    del snapshot
    batches = [batch(dm, job, ctx.seed, j, dev) for j in range(k)]
    ref = train_reference.train(init_params, dm, batches, job["optimizer"])
    detail = {"program": gaps(prog, ref, dev), "tokens": k * tokens,
              "sequences": k, "unit": "steps"}
    for prec in ctx.controls:
        ctl = train_reference.train(init_params, dm, batches,
                                    job["optimizer"], quant=prec)
        detail[f"control_{prec}"] = gaps(ctl, ref, dev)
    timing["reference_s"] = time.perf_counter() - t
    checks, correct = check.judge(detail["program"], cfg.get("limits", {}))
    return {"dims": dm, "window": (open_at, steps[-1][1]),
            "steps": steps, "tokens_per_step": tokens,
            "param_elements": elements,
            "trace": trace, "memory_peak_bytes": peak,
            "attempted": len(steps), "failed": 0, "checks": checks,
            "check_detail": detail, "timing": timing, "correct": correct}
