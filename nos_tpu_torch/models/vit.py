"""Vision Transformer (port of ``nos_tpu/models/vit.py``): ViT-small,
the backbone of the YOLOS detection family (``models/yolos.py``).

Patchify is a reshape and one projection product; each encoder block is
layer norm, non-causal attention through ``ops/attention.py::attention``
(on the card the hand-written flash kernels, ``csrc/flash_attention.cu``,
at a full mask and the ragged S of 197 or 296 tokens; on the CPU their
plain version) and a GELU MLP. The blocks' leaves are stacked
``[L, ...]`` as the reference's are, and ``encode`` walks them in a
Python loop where the reference scans them.

ViT-small/16: d 384, 12 layers, 6 heads, MLP 1536, patch 16, 224x224
input -> 196 patches + the class token.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from nos_tpu_torch.device import DeviceLike, resolve_device
from nos_tpu_torch.models.transformer import params_from_jax
from nos_tpu_torch.ops.attention import attention
from nos_tpu_torch.ops.layers import gelu_mlp, layer_norm, patchify

__all__ = ["ViTConfig", "dense_init", "init_encoder", "encode",
           "init_params", "forward", "param_count", "params_from_jax"]

Params = Dict[str, Any]


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch: int = 16
    d_model: int = 384
    n_layers: int = 12
    n_heads: int = 6
    d_ff: int = 1536
    n_classes: int = 1000
    dtype: Any = torch.bfloat16

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch) ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _normal(generator: Optional[torch.Generator], shape, std: float,
            dtype, device: torch.device) -> torch.Tensor:
    """An f32 normal draw times ``std``, cast once to ``dtype``. On the
    meta device nothing is drawn (``generator`` may be None)."""
    x = torch.randn(shape, dtype=torch.float32, device=device,
                    generator=generator if device.type != "meta" else None)
    return (x * std).to(dtype)


def dense_init(generator: Optional[torch.Generator], shape, fan_in: int,
               dtype, device: torch.device) -> torch.Tensor:
    """normal * fan_in ** -0.5 in f32, cast to ``dtype``."""
    return _normal(generator, shape, fan_in ** -0.5, dtype, device)


def init_encoder(generator: Optional[torch.Generator], cfg: ViTConfig,
                 device: DeviceLike = None) -> Params:
    """The stacked encoder blocks (each leaf ``[L, ...]``) and the final
    layer norm: the backbone the classifier head here and the YOLOS
    detection head share. Norm scales and biases are f32."""
    device = resolve_device(device)
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    def zeros(*shape, dtype=cfg.dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def stacked(shape, fan_in):
        return torch.stack([dense_init(generator, shape, fan_in, cfg.dtype,
                                       device) for _ in range(L)])

    blocks = {
        "ln1_scale": ones(L, d),
        "ln1_bias": zeros(L, d, dtype=torch.float32),
        "wqkv": stacked((d, 3 * d), d),
        "wo": stacked((d, d), d),
        "ln2_scale": ones(L, d),
        "ln2_bias": zeros(L, d, dtype=torch.float32),
        "w_in": stacked((d, f), d),
        "b_in": zeros(L, f),
        "w_out": stacked((f, d), f),
        "b_out": zeros(L, d),
    }
    return {"blocks": blocks, "final_ln_scale": ones(d),
            "final_ln_bias": zeros(d, dtype=torch.float32)}


def encode(params: Params, cfg: ViTConfig, x: torch.Tensor) -> torch.Tensor:
    """Embedded tokens x [B, S, D] -> [B, S, D] through every block and
    the final layer norm. ``params`` needs ``init_encoder``'s keys."""
    b, seq = x.shape[0], x.shape[1]
    blocks = params["blocks"]
    for i in range(blocks["wqkv"].shape[0]):
        blk = {k: v[i] for k, v in blocks.items()}
        h = layer_norm(x, blk["ln1_scale"], blk["ln1_bias"])
        qkv = torch.matmul(h, blk["wqkv"]).reshape(
            b, seq, 3, cfg.n_heads, cfg.head_dim)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        o = attention(q, k, v, causal=False)
        o = o.transpose(1, 2).reshape(b, seq, cfg.d_model)
        x = x + torch.matmul(o, blk["wo"])
        h = layer_norm(x, blk["ln2_scale"], blk["ln2_bias"])
        x = x + gelu_mlp(h, blk["w_in"], blk["b_in"], blk["w_out"],
                         blk["b_out"])
    return layer_norm(x, params["final_ln_scale"], params["final_ln_bias"])


def init_params(generator: Optional[torch.Generator], cfg: ViTConfig,
                device: DeviceLike = None) -> Params:
    """Random params with the reference's shapes, dtypes and init scales
    (normal * fan_in ** -0.5; ``pos_embed`` normal * 0.02; the class
    token zero). The numbers are not JAX's: parity tests carry the
    reference's params over with ``params_from_jax``. ``device`` is the
    card unless given (``"meta"`` allocates nothing)."""
    device = resolve_device(device)
    d = cfg.d_model
    patch_dim = cfg.patch * cfg.patch * 3
    return {
        "patch_proj": dense_init(generator, (patch_dim, d), patch_dim,
                                 cfg.dtype, device),
        "cls_token": torch.zeros((1, 1, d), dtype=cfg.dtype, device=device),
        "pos_embed": _normal(generator, (1, cfg.n_patches + 1, d), 0.02,
                             cfg.dtype, device),
        **init_encoder(generator, cfg, device),
        "head": dense_init(generator, (d, cfg.n_classes), d, cfg.dtype,
                           device),
    }


def forward(params: Params, cfg: ViTConfig,
            images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] -> logits [B, n_classes] f32."""
    b = images.shape[0]
    x = patchify(images.to(cfg.dtype), cfg.patch)
    x = torch.matmul(x, params["patch_proj"])
    cls = params["cls_token"].expand(b, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"]
    x = encode(params, cfg, x)
    return torch.matmul(x[:, 0], params["head"]).float()


def param_count(params: Params) -> int:
    """Elements over every leaf (nested dicts)."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()
