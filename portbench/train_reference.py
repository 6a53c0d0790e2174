"""The plain training reference: the decoder of ``reference.py`` in
float32 (TF32 off), its mean token cross-entropy, autograd's gradients,
and AdamW as optax applies it (bias-corrected moments, eps outside the
root, decay on every leaf, the learning rate of the update count before
this one). A batch runs one row at a time, each layer under a
checkpoint, so a 4096-token row fits beside the float32 state; the
rows' gradients add up to the batch mean's.

With ``quant`` the forward rounds the products' weights (a scale per
output channel) and the normed inputs of each block and of the head (a
scale per token) to that precision, as fp8 training does, the gradient
passing straight through: the control.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from portbench import reference
from portbench.model import Dims


class _Quant(torch.autograd.Function):
    """``reference.fake_quant`` forward, the identity's gradient."""

    @staticmethod
    def forward(ctx, w, quant, axis):
        return reference.fake_quant(w, quant, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _w(w: torch.Tensor, quant: Optional[str], key: str) -> torch.Tensor:
    if quant is None or key in ("attn_norm", "mlp_norm", "w_router",
                                "final_norm"):
        return w
    return _Quant.apply(w, quant, -2)


def _act(x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """A product's input rounded with one scale a token (the control)."""
    return x if quant is None else _Quant.apply(x, quant, -1)


def _layer(x, layer: Dict[str, torch.Tensor], dm: Dims, quant):
    w = {k: _w(v, quant, k) for k, v in layer.items()}
    x = x + reference.attention(
        _act(reference.rms_norm(x, w["attn_norm"], dm.norm_eps), quant),
        w, dm)
    h = _act(reference.rms_norm(x, w["mlp_norm"], dm.norm_eps), quant)
    if dm.n_experts:
        return x + reference.experts(h, w, dm)
    return x + reference.swiglu(h, w["w_gate"], w["w_up"], w["w_down"])


def row_loss(params: dict, dm: Dims, tokens: torch.Tensor,
             targets: torch.Tensor, quant: Optional[str] = None):
    """Summed token cross-entropy of one row (tokens, targets [S])."""
    x = params["embed"][tokens]
    if quant is not None:
        # the embedding's scale is a row's: round the rows looked up
        x = _Quant.apply(x, quant, -1)
    for i in range(dm.n_layers):
        layer = {k: v[i] for k, v in params["layers"].items()}
        x = checkpoint(_layer, x, layer, dm, quant, use_reentrant=False)
    x = _act(reference.rms_norm(x, params["final_norm"], dm.norm_eps), quant)
    logits = x @ _w(params["unembed"], quant, "unembed")
    return torch.nn.functional.cross_entropy(logits, targets,
                                             reduction="sum")


def leaves(params: dict) -> List[torch.Tensor]:
    """The tensors of a params dict in sorted-key order (the port's
    ``param_leaves`` order)."""
    out = []
    for k in sorted(params):
        v = params[k]
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def names(params: dict, prefix: str = "") -> List[str]:
    out = []
    for k in sorted(params):
        v = params[k]
        out.extend(names(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else [prefix + k])
    return out


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.detach().float().clone().requires_grad_()


def train(params: dict, dm: Dims, batches: List[Dict[str, torch.Tensor]],
          opt: dict, quant: Optional[str] = None) -> dict:
    """Steps over ``batches`` ({"tokens", "targets"} [B, S]) from
    ``params`` (the initial weights, read, not changed). Returns each
    step's loss, the first step's gradient per leaf (on the host) and
    its norm, and each leaf's change norm after the last step."""
    p = _f32(params)
    ps = leaves(p)
    mu = [torch.zeros_like(t) for t in ps]
    nu = [torch.zeros_like(t) for t in ps]
    b1, b2, lr, wd = opt["b1"], opt["b2"], opt["lr"], opt["weight_decay"]
    losses, first = [], None
    with reference._no_tf32():
        for step, batch in enumerate(batches, start=1):
            rows, seq = batch["tokens"].shape
            total = 0.0
            for r in range(rows):
                loss = row_loss(p, dm, batch["tokens"][r],
                                batch["targets"][r], quant) / (rows * seq)
                loss.backward()
                total += float(loss.detach())
            losses.append(total)
            grads = [t.grad for t in ps]
            if opt.get("grad_clip", 0) > 0:
                norm = torch.sqrt(sum((g * g).sum() for g in grads))
                if norm >= opt["grad_clip"]:
                    for g in grads:
                        g.mul_(opt["grad_clip"] / norm)
            if first is None:
                first = [float(torch.linalg.vector_norm(
                    g, dtype=torch.float64)) for g in grads]
                first_grads = [g.detach().to("cpu", copy=True) for g in grads]
            with torch.no_grad():
                for t, g, m, v in zip(ps, grads, mu, nu):
                    m.mul_(b1).add_(g, alpha=1 - b1)
                    v.mul_(b2).addcmul_(g, g, value=1 - b2)
                    upd = (m / (1 - b1 ** step)) / (
                        torch.sqrt(v / (1 - b2 ** step)) + opt["eps"])
                    t.sub_(lr * (upd + wd * t))
                    t.grad = None
    init = leaves(params)
    change = [float(torch.linalg.vector_norm(t.detach() - i.float(),
                                             dtype=torch.float64))
              for t, i in zip(ps, init)]
    return {"losses": losses, "first_grad": first, "change": change,
            "first_grads": first_grads}
