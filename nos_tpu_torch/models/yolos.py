"""YOLOS, the detection family (port of ``nos_tpu/models/yolos.py``): the
ViT backbone (``models/vit.py::encode``) with YOLOS's two changes on
top:

- ``n_det_tokens`` learned detection tokens appended AFTER the patch
  tokens, in place of the class token (You Only Look at One Sequence,
  Fang et al. 2021: detection as plain sequence encoding);
- per detection token, a linear class head (``n_classes`` + one
  no-object logit) and a 3-layer MLP box head with a sigmoid, boxes in
  normalised (cx, cy, w, h).

YOLOS-small's sequence is 196 patches + 100 detection tokens = 296, not
a multiple of the kernel's tiles: on the card its attention runs the
flash kernels with a full mask over a ragged tail.

Training uses the DETR set criterion over a one-to-one matching that
``sinkhorn_match`` solves with a fixed number of Sinkhorn iterations on
the entropic relaxation, hardened greedily (the reference's static
shapes, here Python loops with the batch vectorised). The matching is
computed without gradient from a detached cost, as the reference's int
assignment carries none; sorts are stable and argmax takes the first of
equal values, as JAX's do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from nos_tpu_torch.device import DeviceLike, resolve_device
from nos_tpu_torch.models.vit import (
    ViTConfig, _normal, dense_init, encode, init_encoder, param_count,
)
from nos_tpu_torch.ops.layers import patchify

__all__ = ["YolosConfig", "init_params", "forward", "param_count",
           "cxcywh_to_xyxy", "generalized_box_iou", "sinkhorn_match",
           "set_criterion", "postprocess"]

Params = Dict[str, Any]


@dataclass(frozen=True)
class YolosConfig:
    """YOLOS-small by default: the ViT-small/16 backbone (d 384, 12
    layers, 6 heads, MLP 1536) + 100 detection tokens, 91 COCO
    classes."""
    image_size: int = 224
    patch: int = 16
    d_model: int = 384
    n_layers: int = 12
    n_heads: int = 6
    d_ff: int = 1536
    n_det_tokens: int = 100
    n_classes: int = 91          # real classes; one extra no-object logit
    dtype: Any = torch.bfloat16

    @property
    def backbone(self) -> ViTConfig:
        return ViTConfig(
            image_size=self.image_size, patch=self.patch,
            d_model=self.d_model, n_layers=self.n_layers,
            n_heads=self.n_heads, d_ff=self.d_ff, dtype=self.dtype)

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch) ** 2


def init_params(generator: Optional[torch.Generator], cfg: YolosConfig,
                device: DeviceLike = None) -> Params:
    """Random params with the reference's shapes, dtypes and init scales
    (``det_tokens`` and ``pos_embed`` normal * 0.02, products normal *
    fan_in ** -0.5, biases zero). ``device`` is the card unless given
    (``"meta"`` allocates nothing)."""
    device = resolve_device(device)
    d = cfg.d_model
    patch_dim = cfg.patch * cfg.patch * 3
    seq = cfg.n_patches + cfg.n_det_tokens

    def dense(shape, fan_in):
        return dense_init(generator, shape, fan_in, cfg.dtype, device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=device)

    return {
        "patch_proj": dense((patch_dim, d), patch_dim),
        "det_tokens": _normal(generator, (1, cfg.n_det_tokens, d), 0.02,
                              cfg.dtype, device),
        "pos_embed": _normal(generator, (1, seq, d), 0.02, cfg.dtype,
                             device),
        **init_encoder(generator, cfg.backbone, device),
        "class_head": dense((d, cfg.n_classes + 1), d),
        "box_mlp": {"w1": dense((d, d), d), "b1": zeros(d),
                    "w2": dense((d, d), d), "b2": zeros(d),
                    "w3": dense((d, 4), d), "b3": zeros(4)},
    }


def forward(params: Params, cfg: YolosConfig,
            images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """images [B, H, W, 3] -> (class_logits [B, Q, n_classes+1] f32,
    boxes [B, Q, 4] f32, sigmoid-normalised cxcywh)."""
    b = images.shape[0]
    x = patchify(images.to(cfg.dtype), cfg.patch)
    x = torch.matmul(x, params["patch_proj"])
    det = params["det_tokens"].expand(b, cfg.n_det_tokens, cfg.d_model)
    x = torch.cat([x, det], dim=1) + params["pos_embed"]
    x = encode(params, cfg.backbone, x)
    tok = x[:, -cfg.n_det_tokens:]
    logits = torch.matmul(tok, params["class_head"]).float()
    m = params["box_mlp"]
    h = F.relu(torch.matmul(tok, m["w1"]) + m["b1"])
    h = F.relu(torch.matmul(h, m["w2"]) + m["b2"])
    boxes = torch.sigmoid((torch.matmul(h, m["w3"]) + m["b3"]).float())
    return logits, boxes


# ---------------------------------------------------------------- boxes

def cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _clip0(x: torch.Tensor) -> torch.Tensor:
    """``x.clip(0)`` as JAX differentiates it: ``maximum(0, x)``, whose
    gradient splits evenly where x is exactly 0 (``clamp``'s would pass
    it whole)."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def generalized_box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """GIoU between box sets a [..., N, 4] and b [..., M, 4] (xyxy) ->
    [..., N, M]. Degenerate (zero-area) boxes give IoU 0, not NaN."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    area_a = _clip0(a[..., 2] - a[..., 0]) * _clip0(a[..., 3] - a[..., 1])
    area_b = _clip0(b[..., 2] - b[..., 0]) * _clip0(b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    inter = _clip0(rb - lt).prod(-1)
    union = area_a + area_b - inter
    tiny = torch.tensor(1e-9, dtype=union.dtype, device=union.device)
    iou = inter / torch.maximum(union, tiny)
    lt_c = torch.minimum(a[..., :2], b[..., :2])
    rb_c = torch.maximum(a[..., 2:], b[..., 2:])
    hull = _clip0(rb_c - lt_c).prod(-1)
    return iou - (hull - union) / torch.maximum(hull, tiny)


# -------------------------------------------------------------- matching

@torch.no_grad()
def sinkhorn_match(cost: torch.Tensor, target_mask: torch.Tensor,
                   n_iters: int = 50, temp: float = 0.01) -> torch.Tensor:
    """One-to-one assignment of targets to queries, batched.

    cost [B, Q, T] (smaller = better), target_mask [B, T] bool (padded
    targets False). Sinkhorn on exp(-cost / temp) toward a doubly
    stochastic plan (each query offers at most 1, each real target
    wants 1), then a greedy hardening: targets in order of their best
    cost (a stable sort) each take their plan's best free query (the
    first of equal ones). Returns ``assign`` [B, T] int64, the query per
    target (0 where the mask is False). f32 throughout; padded columns
    cost ``big`` = 1e9 and carry a -``big`` potential (no mass)."""
    bsz, q, t = cost.shape
    dev = cost.device
    big = torch.tensor(1e9, dtype=torch.float32, device=dev)
    mask = target_mask.to(torch.bool)
    c = torch.where(mask[:, None, :], cost.detach().float(), big)
    logk = -c / torch.tensor(temp, dtype=torch.float32, device=dev)
    f = torch.zeros((bsz, q), dtype=torch.float32, device=dev)
    g = torch.zeros((bsz, t), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(n_iters):
        # columns: each real target wants total mass 1
        g = -torch.logsumexp(logk + f[:, :, None], dim=1)
        g = torch.where(mask, g, -big)          # padded: no mass
        # rows: each query offers at most 1 (<= 1 capacity via min)
        f = torch.minimum(-torch.logsumexp(logk + g[:, None, :], dim=2),
                          zero)
    plan = torch.exp(logk + f[:, :, None] + g[:, None, :])    # [B, Q, T]
    # subnormal entries to zero, as XLA leaves them (the TPU and XLA:CPU
    # flush them): the greedy pass's argmax then sees the reference's
    # ties among the near-zero entries, not the first subnormal
    tiny = torch.finfo(torch.float32).tiny
    plan = torch.where(plan < tiny, torch.zeros_like(plan), plan)

    best = torch.where(mask, c.amin(dim=1), big)
    order = torch.argsort(best, dim=1, stable=True)           # [B, T]
    assign = torch.zeros((bsz, t), dtype=torch.long, device=dev)
    taken = torch.zeros((bsz, q), dtype=torch.bool, device=dev)
    rows = torch.arange(bsz, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    for j in range(t):
        ti = order[:, j]
        score = torch.where(taken, neg_inf, plan[rows, :, ti])
        pick = torch.argmax(score, dim=1)       # the first of equal values
        live = mask[rows, ti]
        assign[rows, ti] = torch.where(live, pick, assign[rows, ti])
        taken[rows, pick] = taken[rows, pick] | live
    return assign


# ------------------------------------------------------------------ loss

def set_criterion(logits: torch.Tensor, boxes: torch.Tensor,
                  target_labels: torch.Tensor, target_boxes: torch.Tensor,
                  no_object_weight: float = 0.1,
                  cost_class: float = 1.0, cost_l1: float = 5.0,
                  cost_giou: float = 2.0) -> Dict[str, torch.Tensor]:
    """DETR set criterion (class CE + L1 + GIoU over the one-to-one
    matching), batched.

    logits [B, Q, C+1], boxes [B, Q, 4] cxcywh; target_labels [B, T]
    int with -1 padding; target_boxes [B, T, 4] cxcywh. Returns a dict
    of scalar losses; ``total`` is the training objective. The matching
    cost uses the losses' class/L1/GIoU weights (the DETR recipe); the
    no-object class index is C."""
    bsz, nq, nc1 = logits.shape
    if target_labels.shape[1] > nq:
        raise ValueError(
            f"{target_labels.shape[1]} targets exceed {nq} detection "
            "tokens: one-to-one matching needs T <= Q (raise "
            "n_det_tokens or truncate the target set)")
    mask = target_labels >= 0                              # [B, T]
    labels = torch.where(mask, target_labels,
                         torch.zeros_like(target_labels)).long()
    t = labels.shape[1]

    probs = torch.softmax(logits, dim=-1)                  # [B, Q, C+1]
    p_target = torch.gather(
        probs, 2, labels[:, None, :].expand(bsz, nq, t))   # [B, Q, T]
    l1 = (boxes[:, :, None, :] - target_boxes[:, None, :, :]).abs().sum(-1)
    giou = generalized_box_iou(cxcywh_to_xyxy(boxes),
                               cxcywh_to_xyxy(target_boxes))
    cost = cost_class * (-p_target) + cost_l1 * l1 + cost_giou * (-giou)

    assign = sinkhorn_match(cost.detach(), mask)           # [B, T]

    # scatter matched targets onto queries
    one_hot = (F.one_hot(assign, nq).permute(0, 2, 1).float()
               * mask[:, None, :])                          # [B, Q, T]
    matched = one_hot.sum(-1)                               # [B, Q] 0/1
    # class target per query: the matched target's label, else no-object
    q_label = torch.einsum("bqt,bt->bq", one_hot, labels.float())
    q_label = torch.where(matched > 0, q_label,
                          torch.full_like(q_label, nc1 - 1)).long()
    ce = -torch.gather(torch.log_softmax(logits, -1), 2,
                       q_label[..., None])[..., 0]
    w = torch.where(matched > 0, torch.ones_like(matched),
                    torch.full_like(matched, no_object_weight))
    loss_class = (ce * w).sum() / torch.clamp(w.sum(), min=1e-6)

    n_matched = torch.clamp(mask.sum(), min=1).float()
    loss_l1 = (l1 * one_hot).sum() / n_matched
    loss_giou = ((1.0 - giou) * one_hot).sum() / n_matched
    total = (cost_class * loss_class + cost_l1 * loss_l1
             + cost_giou * loss_giou)
    return {"class": loss_class, "l1": loss_l1, "giou": loss_giou,
            "total": total}


def postprocess(logits: torch.Tensor, boxes: torch.Tensor,
                top_k: int = 10) -> Dict[str, torch.Tensor]:
    """Per image: the best real class's score per query (no-object
    dropped), the top-k queries by that score (a stable sort: equal
    scores keep query order). Returns scores/labels [B, k] and boxes
    [B, k, 4] (xyxy, normalised to [0, 1])."""
    probs = torch.softmax(logits, dim=-1)[..., :-1]        # drop no-object
    scores = probs.amax(-1)
    labels = torch.argmax(probs, dim=-1)    # the first of equal values
    top = torch.argsort(-scores, dim=-1, stable=True)[:, :top_k]
    return {"scores": torch.gather(scores, 1, top),
            "labels": torch.gather(labels, 1, top),
            "boxes": torch.gather(cxcywh_to_xyxy(boxes), 1,
                                  top[..., None].expand(*top.shape, 4))}
