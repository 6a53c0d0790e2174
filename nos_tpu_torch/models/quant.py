"""Param-tree quantization for the decode path (port of
``nos_tpu/models/quant.py::quantize_params``)."""
from __future__ import annotations

from typing import Any

from nos_tpu_torch.ops.quant import quantize_array

__all__ = ["quantize_params"]

_DENSE_FFN_KEYS = ("w_gate", "w_up", "w_down")
_ATTN_KEYS = ("wq", "wk", "wv", "wo")


def quantize_params(params: Any, *, quantize_embed: bool = True) -> Any:
    """A params dict whose decoder matmul weights are ``QuantLinear``
    (int8 + per-channel scales); norms stay f32, and an MoE model's
    router and expert stacks stay as they are (the MoE products take no
    ``qdot``), as in the reference. Embedding rows get per-ROW scales
    (axis -1)."""
    out = dict(params)
    layers = dict(params["layers"])
    for k in _ATTN_KEYS:
        layers[k] = quantize_array(layers[k])
    if "w_router" not in layers:        # dense FFN only; experts stay bf16
        for k in _DENSE_FFN_KEYS:
            layers[k] = quantize_array(layers[k])
    out["layers"] = layers
    out["unembed"] = quantize_array(params["unembed"])
    if quantize_embed:
        out["embed"] = quantize_array(params["embed"], axis=-1)
    return out
