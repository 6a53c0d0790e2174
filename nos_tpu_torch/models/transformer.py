"""Decoder-only transformer config and params (port of the parts of
``nos_tpu/models/transformer.py`` the serving slice uses).

Params are a plain dict of tensors with the reference's layout: stacked
``layers`` with a leading L axis, ``embed [vocab, d]``, ``unembed
[d, vocab]``, f32 norms. Training (``forward``, remat, MoE) is not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from nos_tpu_torch.device import DeviceLike, resolve_device
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
    # grouped-query attention: 0 means MHA (n_kv_heads == n_heads)
    n_kv_heads: int = 0
    n_experts: int = 0

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError("d_model must divide by n_heads")
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must divide by n_kv_heads")
        if self.n_experts > 0:
            raise ValueError(
                "n_experts > 0 (MoE) is not ported yet: the torch port "
                "serves dense-FFN models only")

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
