"""A configuration file's sizes, its weights made from the seed, and the
frozen count of one forward's work. Imports only torch: the reference
and the harness share it, the port never sees it."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch


@dataclass(frozen=True)
class Dims:
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    max_seq: int
    rope_theta: float
    norm_eps: float
    n_experts: int = 0
    top_k: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def dims_of(cfg: dict) -> Dims:
    """The sizes of a configuration file, under the published keys."""
    if cfg.get("torch_dtype", "bfloat16") != "bfloat16":
        raise ValueError("the serving cells run bfloat16 weights")
    if cfg.get("hidden_act", "silu") != "silu":
        raise ValueError("the port's FFN is SwiGLU (silu)")
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    if cfg.get("head_dim", d // h) != d // h:
        raise ValueError("the port's head size is hidden_size / heads")
    experts = cfg.get("num_local_experts", 0)
    top_k = cfg.get("num_experts_per_tok", 2 if experts else 0)
    if experts and top_k != 2:
        raise ValueError("the port routes each token to 2 experts")
    window = cfg.get("sliding_window")
    if window is not None and window < cfg["max_position_embeddings"]:
        raise ValueError("the port attends causally over the whole row: a "
                         "sliding window shorter than max_seq differs")
    return Dims(vocab=cfg["vocab_size"], d_model=d,
                n_layers=cfg["num_hidden_layers"], n_heads=h,
                n_kv_heads=cfg["num_key_value_heads"],
                d_ff=cfg["intermediate_size"],
                max_seq=cfg["max_position_embeddings"],
                rope_theta=float(cfg["rope_theta"]),
                norm_eps=float(cfg["rms_norm_eps"]),
                n_experts=experts, top_k=top_k)


def layer_shapes(dm: Dims) -> Dict[str, tuple]:
    """name -> (one layer's shape, fan_in, dtype), in the port's layout:
    x @ w with w [in, out]; experts stacked [E, in, out]."""
    d, f, e, kv = dm.d_model, dm.d_ff, dm.n_experts, dm.kv_dim
    bf = torch.bfloat16
    shapes = {"wq": ((d, d), d, bf), "wk": ((d, kv), d, bf),
              "wv": ((d, kv), d, bf), "wo": ((d, d), d, bf)}
    if e:
        shapes.update(w_router=((d, e), d, torch.float32),
                      w_gate=((e, d, f), d, bf), w_up=((e, d, f), d, bf),
                      w_down=((e, f, d), f, bf))
    else:
        shapes.update(w_gate=((d, f), d, bf), w_up=((d, f), d, bf),
                      w_down=((f, d), f, bf))
    return shapes


def make_params(dm: Dims, seed: int, device) -> dict:
    """Random weights from ``seed``, drawn on ``device`` one stacked leaf
    a call in the type they are served in: normal x fan_in^-0.5 for the
    products, norms uniform in [0.5, 1.5] (not 1, so a norm weight left
    out shows)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    L, d = dm.n_layers, dm.d_model

    def normal(shape, fan_in, dtype):
        t = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return t.mul_(fan_in ** -0.5)

    def norm(shape):
        return torch.rand(shape, generator=g, device=device,
                          dtype=torch.float32).add_(0.5)

    layers = {k: normal((L,) + shp, fan_in, dt)
              for k, (shp, fan_in, dt) in layer_shapes(dm).items()}
    layers["attn_norm"] = norm((L, d))
    layers["mlp_norm"] = norm((L, d))
    return {"embed": normal((dm.vocab, d), d, torch.bfloat16),
            "layers": layers,
            "final_norm": norm((d,)),
            "unembed": normal((d, dm.vocab), d, torch.bfloat16)}


def param_count(dm: Dims, active: bool = False) -> int:
    """Parameters of the products (embedding included); ``active``: a
    token's, with top_k of the experts."""
    d, f, L, v = dm.d_model, dm.d_ff, dm.n_layers, dm.vocab
    attn = 2 * d * d + 2 * d * dm.kv_dim
    experts = dm.n_experts or 1
    used = (dm.top_k if dm.n_experts else 1) if active else experts
    ffn = 3 * d * f * used + (d * dm.n_experts if dm.n_experts else 0)
    return L * (attn + ffn) + 2 * v * d
