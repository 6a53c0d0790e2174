"""Decode-side params loading (port of ``GenerateConfig`` and
``load_params`` from ``nos_tpu/cmd/generate.py``).

Weights are made from ``seed`` on the device. Checkpoint loading waits
until a checkpoint format is ported (the reference's is orbax).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from nos_tpu_torch.device import DeviceLike, resolve_device
from nos_tpu_torch.models import transformer as tfm


@dataclass
class GenerateConfig:
    # model
    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 0
    d_ff: int = 1408
    max_seq: int = 512
    n_experts: int = 0
    bf16: bool = True
    # weights (the reference's decode-loop fields wait for its ``run``)
    checkpoint_dir: str = ""
    int8: bool = False
    seed: int = 0


def load_params(cfg: GenerateConfig, device: DeviceLike = None):
    """(model config, params) with params drawn from ``cfg.seed`` by a
    ``torch.Generator`` on ``device``, plus the int8 twin when
    ``cfg.int8``."""
    if cfg.checkpoint_dir:
        raise ValueError(
            "checkpoint_dir is not supported by the torch port yet: no "
            "checkpoint format is ported (weights are made from seed)")
    device = resolve_device(device)
    model_cfg = tfm.TransformerConfig(
        vocab=cfg.vocab, d_model=cfg.d_model, n_layers=cfg.n_layers,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
        max_seq=cfg.max_seq, n_experts=cfg.n_experts,
        dtype=torch.bfloat16 if cfg.bf16 else torch.float32,
    )
    params = tfm.init_params(
        model_cfg, torch.Generator(device).manual_seed(cfg.seed), device)
    if cfg.int8:
        from nos_tpu_torch.models.quant import quantize_params

        params = quantize_params(params)
    return model_cfg, params
