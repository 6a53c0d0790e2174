"""Decoder-only transformer (port of ``nos_tpu/models/transformer.py``
without a mesh): config, params, the training forward, the loss and the
train step.

Params are a plain dict of tensors with the reference's layout: stacked
``layers`` with a leading L axis, ``embed [vocab, d]``, ``unembed
[d, vocab]``, f32 norms. PyTorch runs eagerly, so the reference's
``lax.scan`` over layers is a Python loop over the stacked tensors, and
its ``jax.checkpoint`` per layer is ``torch.utils.checkpoint`` (the
"full" policy). MoE (``n_experts > 0``), sequence parallelism and the
named remat policies are not ported yet and raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from nos_tpu_torch.device import DeviceLike, resolve_device
from nos_tpu_torch.ops.attention import attention
from nos_tpu_torch.ops.layers import (
    apply_rope, rms_norm, rope_frequencies, swiglu,
)
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
    # per-layer rematerialization: the whole layer is recomputed in
    # backward ("full", the only policy ported so far)
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
        if self.remat_policy != "full":
            raise ValueError(
                f"remat_policy {self.remat_policy!r} is not ported yet: the "
                f"torch port recomputes whole layers (remat_policy 'full')")
        if self.n_experts > 0:
            raise ValueError(
                "n_experts > 0 (MoE) is not ported yet: the torch port "
                "runs dense-FFN models only")

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
    (normal * fan_in**-0.5, norms at 1). The numbers differ from JAX's
    PRNG stream; tests that compare the two bridge the reference's
    params with ``params_from_jax``. Each layer is drawn in f32 and cast
    into the stacked tensor one at a time, so the f32 transient is one
    layer's matrix, not the model's."""
    device = resolve_device(device)
    d, h, L = cfg.d_model, cfg.d_ff, cfg.n_layers

    def randn(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * fan_in ** -0.5
                ).to(cfg.dtype)

    shapes = {"wq": ((d, d), d), "wk": ((d, cfg.kv_dim), d),
              "wv": ((d, cfg.kv_dim), d), "wo": ((d, d), d),
              "w_gate": ((d, h), d), "w_up": ((d, h), d),
              "w_down": ((h, d), h)}
    layers = {k: torch.empty((L,) + shp, dtype=cfg.dtype, device=device)
              for k, (shp, _) in shapes.items()}
    for i in range(L):
        for k, (shp, fan_in) in shapes.items():
            layers[k][i] = randn(shp, fan_in)
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
    inside the attention op)."""
    b, s = h_in.shape[:2]
    h = rms_norm(h_in, layer["attn_norm"])
    q = torch.matmul(h, layer["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = torch.matmul(h, layer["wk"]).reshape(b, s, cfg.kv_heads,
                                             cfg.head_dim)
    v = torch.matmul(h, layer["wv"]).reshape(b, s, cfg.kv_heads,
                                             cfg.head_dim)
    q, k = apply_rope(q, freqs), apply_rope(k, freqs)
    o = attention_call(q, k, v).reshape(b, s, cfg.d_model)
    return h_in + torch.matmul(o, layer["wo"])


def dense_ffn_block(h_in: torch.Tensor, layer: dict) -> torch.Tensor:
    """Pre-RMSNorm SwiGLU FFN sublayer + residual."""
    h = rms_norm(h_in, layer["mlp_norm"])
    return h_in + swiglu(h, layer["w_gate"], layer["w_up"], layer["w_down"])


def dense_layer_block(h_in: torch.Tensor, layer: dict,
                      cfg: TransformerConfig, freqs,
                      attention_call) -> torch.Tensor:
    """One decoder layer on the dense path."""
    x = attention_block(h_in, layer, cfg, freqs, attention_call)
    return dense_ffn_block(x, layer)


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
    ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``: its
    activations are recomputed in backward, attention kernel included."""
    freqs = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                             tokens.device)
    x = F.embedding(tokens, params["embed"])
    layers = params["layers"]

    def layer_body(x, *tensors):
        layer = dict(zip(names, tensors))
        return dense_layer_block(x, layer, cfg, freqs, _attention_call)

    names = sorted(layers)
    for i in range(cfg.n_layers):
        tensors = [layers[n][i] for n in names]
        if cfg.remat:
            x = checkpoint(layer_body, x, *tensors, use_reentrant=False)
        else:
            x = layer_body(x, *tensors)
    aux = x.new_zeros((), dtype=torch.float32)
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
