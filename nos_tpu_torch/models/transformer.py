"""Decoder-only transformer (port of ``nos_tpu/models/transformer.py``
without a mesh): config, params, the training forward, the loss and the
train step.

Params are a plain dict of tensors with the reference's layout: stacked
``layers`` with a leading L axis, ``embed [vocab, d]``, ``unembed
[d, vocab]``, f32 norms. PyTorch runs eagerly, so the reference's
``lax.scan`` over layers is a Python loop over the stacked tensors, and
its ``jax.checkpoint(policy=...)`` per layer is ``torch.utils.checkpoint``
with a selective-checkpoint ``context_fn`` per ``remat_policy``
(``remat_context_fn``): "full" saves nothing, "dots" the products with
no batch dimension, "except_mlp" and "minimal" the outputs of the ops
that stand for the reference's names (``REMAT_NAMES``). With
``n_experts > 0`` every layer's FFN is the reference's top-2 MoE
(``w_router`` [L, d, E] f32, experts [L, E, d, f] / [L, E, f, d]); the
decode path serves it (``models/generate.py``) and the training
``forward`` trains it, the layers' aux losses averaged into
``loss_fn``. Sequence parallelism is not ported: it needs a mesh.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    checkpoint, create_selective_checkpoint_contexts, noop_context_fn,
)

from nos_tpu_torch.device import DeviceLike, resolve_device
from nos_tpu_torch.ops.attention import attention
from nos_tpu_torch.ops.layers import (
    qkv_proj, rms_norm, rope_frequencies, rope_rows, swiglu,
)
from nos_tpu_torch.ops.moe import expert_capacity, moe_ffn
from nos_tpu_torch.ops.quant import QuantLinear

Params = Dict[str, Any]


@dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 1408
    max_seq: int = 2048
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    # per-layer rematerialization: what backward recomputes of a layer.
    # "full" recomputes all of it; "dots" saves the products with no
    # batch dimension; "except_mlp" saves q/k/v and the attention op's
    # outputs; "minimal" the attention op's outputs only
    # (``remat_context_fn``)
    remat: bool = True
    remat_policy: str = "full"
    # > 0: the lm head + cross-entropy run in sequence chunks of this size
    # under checkpoint, so the f32 [B, S, vocab] logits never exist at once
    loss_chunk: int = 0
    # grouped-query attention: 0 means MHA (n_kv_heads == n_heads)
    n_kv_heads: int = 0
    sp_strategy: str = "ring"
    n_experts: int = 0
    expert_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide by n_heads")
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must divide by n_kv_heads")
        if self.sp_strategy not in ("ring", "ulysses"):
            raise ValueError(f"unknown sp_strategy {self.sp_strategy!r}")
        if self.remat_policy not in ("full", "dots", "except_mlp", "minimal"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Random params with the reference's shapes and init scales
    (normal * fan_in**-0.5, norms at 1; with ``n_experts`` an f32 router
    and stacked experts). The numbers differ from JAX's PRNG stream;
    tests that compare the two bridge the reference's params with
    ``params_from_jax``. Each layer is drawn in f32 and cast into the
    stacked tensor one at a time, so the f32 transient is one layer's
    leaf, not the model's."""
    device = resolve_device(device)
    d, L = cfg.d_model, cfg.n_layers

    def randn(shape, fan_in, dtype=cfg.dtype):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * fan_in ** -0.5
                ).to(dtype)

    shapes = _layer_shapes(cfg)
    layers = {k: torch.empty((L,) + shp, dtype=dt, device=device)
              for k, (shp, _, dt) in shapes.items()}
    for i in range(L):
        for k, (shp, fan_in, dt) in shapes.items():
            layers[k][i] = randn(shp, fan_in, dt)
    layers["attn_norm"] = torch.ones((L, d), dtype=torch.float32,
                                     device=device)
    layers["mlp_norm"] = torch.ones((L, d), dtype=torch.float32,
                                    device=device)
    return {
        "embed": randn((cfg.vocab, d), d),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=torch.float32, device=device),
        "unembed": randn((d, cfg.vocab), d),
    }


def _layer_shapes(cfg: TransformerConfig) -> dict:
    """name -> (one layer's shape, fan_in, dtype) of the drawn leaves."""
    d, h, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    shapes = {"wq": ((d, d), d, cfg.dtype),
              "wk": ((d, cfg.kv_dim), d, cfg.dtype),
              "wv": ((d, cfg.kv_dim), d, cfg.dtype),
              "wo": ((d, d), d, cfg.dtype)}
    if e > 0:
        shapes.update(w_router=((d, e), d, torch.float32),
                      w_gate=((e, d, h), d, cfg.dtype),
                      w_up=((e, d, h), d, cfg.dtype),
                      w_down=((e, h, d), h, cfg.dtype))
    else:
        shapes.update(w_gate=((d, h), d, cfg.dtype),
                      w_up=((d, h), d, cfg.dtype),
                      w_down=((h, d), h, cfg.dtype))
    return shapes


def abstract_params(cfg: TransformerConfig) -> Params:
    """``init_params``' tree as tensors on the meta device (shapes and
    dtypes, no storage): the port's ``jax.eval_shape`` of the init, the
    template a checkpoint restore fills leaf by leaf."""
    meta = torch.device("meta")
    L, d = cfg.n_layers, cfg.d_model
    layers = {k: torch.empty((L,) + shp, dtype=dt, device=meta)
              for k, (shp, _, dt) in _layer_shapes(cfg).items()}
    for k in ("attn_norm", "mlp_norm"):
        layers[k] = torch.empty((L, d), dtype=torch.float32, device=meta)
    return {
        "embed": torch.empty((cfg.vocab, d), dtype=cfg.dtype, device=meta),
        "layers": layers,
        "final_norm": torch.empty((d,), dtype=torch.float32, device=meta),
        "unembed": torch.empty((d, cfg.vocab), dtype=cfg.dtype,
                               device=meta),
    }


def _tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)                 # a writable host copy
    if a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16: carry the raw 16 bits, bit-exact
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: Any, device: DeviceLike = None) -> Any:
    """The weights bridge: the reference's params pytree (dicts of numpy
    or JAX arrays, with ``QuantLinear`` leaves from
    ``nos_tpu.models.quant.quantize_params``) -> the port's, bit-equal.
    A QuantLinear is recognised by its ``q``/``scale`` attributes, so the
    port needs no import of the reference package."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return QuantLinear(q=_tensor_from_numpy(tree.q, device),
                           scale=_tensor_from_numpy(tree.scale, device))
    return _tensor_from_numpy(tree, device)


def param_leaves(params: Params) -> List[torch.Tensor]:
    """Every tensor of a params dict, in a fixed (sorted-key) order: the
    leaves a training step takes gradients of."""
    out = []
    for key in sorted(params):
        v = params[key]
        out.extend(param_leaves(v) if isinstance(v, dict) else [v])
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def attention_block(h_in: torch.Tensor, layer: dict, cfg: TransformerConfig,
                    freqs, attention_call) -> torch.Tensor:
    """Pre-RMSNorm attention sublayer + residual. ``attention_call(q, k,
    v)`` takes/returns [B, S, H, D]; k/v stay at kv_heads (GQA grouped
    inside the attention op). q, k (after rope) and v come out of the
    ``qkv_proj`` op, the reference's ``"qkv_proj"`` tensors, and o out of
    the flash op, its ``"attn_out"``."""
    b, s = h_in.shape[:2]
    h = rms_norm(h_in, layer["attn_norm"])
    q, k, v = qkv_proj(h, layer["wq"], layer["wk"], layer["wv"],
                       *rope_rows(freqs, None, s), cfg.n_heads, cfg.kv_heads)
    o = attention_call(q, k, v).reshape(b, s, cfg.d_model)
    return h_in + torch.matmul(o, layer["wo"])


def dense_ffn_block(h_in: torch.Tensor, layer: dict) -> torch.Tensor:
    """Pre-RMSNorm SwiGLU FFN sublayer + residual."""
    h = rms_norm(h_in, layer["mlp_norm"])
    return h_in + swiglu(h, layer["w_gate"], layer["w_up"], layer["w_down"])


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return nll.mean()


def _chunk_nll(xc: torch.Tensor, tc: torch.Tensor,
               unembed: torch.Tensor) -> torch.Tensor:
    logits = torch.matmul(xc, unembed).float()
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, tc[..., None].long()).sum()


def lm_head_loss(norm_w: torch.Tensor, unembed: torch.Tensor,
                 hidden: torch.Tensor, targets: torch.Tensor,
                 loss_chunk: int = 0) -> torch.Tensor:
    """Final rms-norm + unembed + token cross-entropy. With loss_chunk > 0
    the sequence runs in checkpointed chunks (the reference's
    ``jax.checkpoint`` under ``lax.scan``), so the f32 [B, S, vocab]
    logits never exist at once: backward recomputes one [B, chunk,
    vocab] block at a time."""
    hidden = rms_norm(hidden, norm_w)
    b, s, _ = hidden.shape
    if loss_chunk and s > loss_chunk and s % loss_chunk != 0:
        raise ValueError(
            f"loss_chunk={loss_chunk} does not divide seq_len={s}; "
            f"chunking would be silently disabled and the full fp32 "
            f"[B,S,vocab] logits materialised — pick a divisor of the "
            f"sequence length")
    if loss_chunk and s > loss_chunk:
        total = hidden.new_zeros((), dtype=torch.float32)
        for c0 in range(0, s, loss_chunk):
            total = total + checkpoint(
                _chunk_nll, hidden[:, c0:c0 + loss_chunk],
                targets[:, c0:c0 + loss_chunk], unembed,
                use_reentrant=False)
        return total / (b * s)
    logits = torch.matmul(hidden, unembed).float()
    return cross_entropy(logits, targets)


# the reference's checkpoint names -> the registered ops whose outputs
# carry them: q, k (after rope) and v are ``qkv_proj``'s outputs; o and
# the kernel's lse ("attn_residuals", splash's residual name) are the
# flash op's two outputs, saved together
REMAT_NAMES = {
    "qkv_proj": torch.ops.nos_tpu_torch.qkv_proj.default,
    "attn_out": torch.ops.nos_tpu_torch.flash_attention_fwd.default,
    "attn_residuals": torch.ops.nos_tpu_torch.flash_attention_fwd.default,
}
_SAVED_NAMES = {"except_mlp": ("qkv_proj", "attn_out", "attn_residuals"),
                "minimal": ("attn_out", "attn_residuals")}


def remat_saved_ops(policy: str) -> frozenset:
    """The ops whose outputs a layer's checkpoint keeps for backward
    under ``policy`` (the reference's ``_remat_policy``); every other op
    of the layer is recomputed. "dots" is
    ``dots_with_no_batch_dims_saveable``: a product with no batch
    dimension is ``aten.mm`` (``torch.matmul`` folds a [..., d] x [d, f]
    product into one: the o, FFN and MoE router products) or the
    ``qkv_proj`` op (whose products are such), while a product over a
    batch dimension (the MoE's dispatch, expert and combine products;
    the plain attention's) is ``aten.bmm`` and is recomputed, as the
    flash op, which is no product, is. The named policies save the
    outputs of the ops in ``REMAT_NAMES``."""
    if policy == "full":
        return frozenset()
    if policy == "dots":
        return frozenset((torch.ops.aten.mm.default,
                          REMAT_NAMES["qkv_proj"]))
    return frozenset(REMAT_NAMES[n] for n in _SAVED_NAMES[policy])


def remat_context_fn(policy: str):
    """``context_fn`` for a layer's ``torch.utils.checkpoint``: saves the
    outputs of ``remat_saved_ops(policy)`` in the forward and hands them
    to the recompute in backward, which runs the rest of the layer
    again and stops after the last tensor backward needs (the
    checkpoint's early stop), so a product whose output only feeds the
    residual add is not re-run either. Unlike the reference's partial
    evaluation, a saved output is kept whether backward reads it or
    not: under "dots" the down product's output (B S d a layer)."""
    ops = remat_saved_ops(policy)
    if not ops:
        return noop_context_fn
    return functools.partial(create_selective_checkpoint_contexts,
                             sorted(ops, key=str))


# each policy's re-run products in a layer's forward order; the last
# product (down, or the MoE's combine) never re-runs: the recompute
# stops at its inputs, the last tensors backward needs
_RERUN = {
    "full": ("qkv", "attention", "wo", "router", "dispatch", "ffn"),
    "dots": ("attention", "dispatch", "expert_ffn"),
    "except_mlp": ("wo", "router", "dispatch", "ffn"),
    "minimal": ("qkv", "wo", "router", "dispatch", "ffn"),
}


def remat_rerun_flops(cfg: TransformerConfig, batch: int, seq: int) -> dict:
    """What one training step's recompute re-runs under
    ``cfg.remat_policy``: ``products``, the FLOPs of the q/k/v, o, FFN
    (gate and up; with experts also the router, dispatch and down
    products) products it runs again over all layers, and
    ``attention_layers``, the layers whose flash forward it runs again
    (the caller counts that by its own convention). Derived from
    ``remat_saved_ops`` and the early stop (``remat_context_fn``); under
    "dots" the MoE's batched products re-run, the others are saved.
    Zero without ``cfg.remat``."""
    if not cfg.remat:
        return {"products": 0.0, "attention_layers": 0}
    t, d, f, e = batch * seq, cfg.d_model, cfg.d_ff, cfg.n_experts
    parts = {"qkv": 2 * t * d * (d + 2 * cfg.kv_dim), "wo": 2 * t * d * d}
    if e > 0:
        slots = batch * e * expert_capacity(seq, e,
                                            cfg.expert_capacity_factor)
        parts.update(router=2 * t * d * e, dispatch=2 * slots * seq * d,
                     ffn=3 * 2 * slots * d * f)
        parts["expert_ffn"] = parts["ffn"]
    else:
        parts.update(ffn=2 * 2 * t * d * f)
    names = _RERUN[cfg.remat_policy]
    return {"products": float(cfg.n_layers * sum(parts.get(n, 0)
                                                 for n in names)),
            "attention_layers": cfg.n_layers * ("attention" in names)}


def _attention_call(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q, k, v: [B, S, H, D] -> [B, H, S, D], causal ``attention``, back
    to [B, S, H, D]."""
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    return attention(q, k, v, causal=True).transpose(1, 2)


def forward(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
            return_aux: bool = False, return_hidden: bool = False):
    """tokens [B, S] -> logits [B, S, vocab] f32 (plus the MoE auxiliary
    loss, 0 on the dense path, when ``return_aux``). ``return_hidden``
    yields the pre-head hidden state [B, S, d_model] + aux instead, for
    ``loss_fn``, which applies the head itself (chunked). With
    ``cfg.remat`` each layer runs under ``torch.utils.checkpoint`` with
    ``remat_context_fn(cfg.remat_policy)``: what the policy does not
    save is recomputed in backward (the attention kernel too under
    "full" and "dots"). With ``n_experts > 0`` each layer's FFN is
    ``moe_ffn`` and the aux loss is the mean of the layers' (each
    returned by the checkpointed body, so the recompute routes with the
    same bits under every policy)."""
    freqs = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                             tokens.device)
    x = F.embedding(tokens, params["embed"])
    layers = params["layers"]

    def layer_body(x, *tensors):
        layer = dict(zip(names, tensors))
        x = attention_block(x, layer, cfg, freqs, _attention_call)
        if cfg.n_experts > 0:
            h = rms_norm(x, layer["mlp_norm"])
            y, aux = moe_ffn(h, layer["w_router"], layer["w_gate"],
                             layer["w_up"], layer["w_down"],
                             cfg.expert_capacity_factor)
            return x + y, aux
        return dense_ffn_block(x, layer), x.new_zeros((), dtype=torch.float32)

    names = sorted(layers)
    context_fn = remat_context_fn(cfg.remat_policy)
    auxes = []
    for i in range(cfg.n_layers):
        tensors = [layers[n][i] for n in names]
        if cfg.remat:
            x, aux = checkpoint(layer_body, x, *tensors, use_reentrant=False,
                                context_fn=context_fn)
        else:
            x, aux = layer_body(x, *tensors)
        auxes.append(aux)
    aux = torch.stack(auxes).mean()
    if return_hidden:
        return x, aux
    x = rms_norm(x, params["final_norm"])
    logits = torch.matmul(x, params["unembed"]).float()
    if return_aux:
        return logits, aux
    return logits


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def loss_fn(params: Params, cfg: TransformerConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    hidden, aux = forward(params, cfg, batch["tokens"], return_hidden=True)
    loss = lm_head_loss(params["final_norm"], params["unembed"], hidden,
                        batch["targets"], cfg.loss_chunk)
    return loss + cfg.moe_aux_weight * aux


def make_train_step(cfg: TransformerConfig, optimizer):
    """Returns train_step(params, batch) -> loss (a detached f32 scalar
    tensor). ``params`` are leaf tensors with ``requires_grad`` and
    ``optimizer`` is ``nos_tpu_torch.train.optim.build_optimizer``'s,
    built over ``param_leaves(params)``: the step takes the gradients and
    updates the params IN PLACE (the reference donates them to its jitted
    step and rebinds the outputs)."""

    def train_step(params: Params, batch: Dict[str, torch.Tensor]):
        loss = loss_fn(params, cfg, batch)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step
