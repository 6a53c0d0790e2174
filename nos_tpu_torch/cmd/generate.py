"""nos-tpu-torch-generate — decode with KV-cache generation on the card
(port of ``nos_tpu/cmd/generate.py``).

Makes the params (from ``seed``; checkpoint loading waits until a
checkpoint format is ported, the reference's being orbax), optionally
quantizes the matmul weights to int8, and runs greedy or sampled
generation (``models/generate.py::generate``). Prompts are token-id
lists; output is one JSON line per prompt.

Usage:
    python -m nos_tpu_torch.cmd.generate --prompt 1,5,20 \\
        --max-new-tokens 64 --temperature 0.8 --top-k 50 --int8
"""
from __future__ import annotations

import argparse
import json
import logging
from dataclasses import dataclass, fields
from typing import Optional, Sequence

import torch

from nos_tpu_torch.device import DeviceLike, resolve_device
from nos_tpu_torch.models import transformer as tfm

logger = logging.getLogger("nos_tpu_torch.generate")


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
    # decode
    checkpoint_dir: str = ""
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    int8: bool = False
    seed: int = 0
    log_level: str = "info"

    @classmethod
    def from_yaml_file(cls, path: str) -> "GenerateConfig":
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        known = {f.name for f in fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(
                f"{path}: unknown generate config keys {sorted(unknown)}")
        return cls(**data)


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
        logger.info("quantized matmul weights to int8")
    return model_cfg, params


def run(cfg: GenerateConfig, prompts: Sequence[Sequence[int]],
        device: DeviceLike = None):
    """Generate continuations for prompt token lists on ``device``
    (default: the card). Prompts of one length make one batch; each
    length group samples with ``fold_in(PRNGKey(seed + 1), group)``, as
    the reference does. Returns the full token sequences as lists."""
    from nos_tpu_torch.models.generate import generate
    from nos_tpu_torch.utils import prng

    if any(len(p) == 0 for p in prompts):
        raise ValueError("empty prompt: every prompt needs >= 1 token id")
    device = resolve_device(device)
    model_cfg, params = load_params(cfg, device)
    rng = (prng.PRNGKey(cfg.seed + 1, device)
           if cfg.temperature > 0 else None)

    by_len: dict = {}
    for i, p in enumerate(prompts):
        by_len.setdefault(len(p), []).append((i, list(p)))

    results: list = [None] * len(prompts)
    for gi, (_, group) in enumerate(sorted(by_len.items())):
        idxs = [i for i, _ in group]
        # independent sampling noise per length group
        grng = prng.fold_in(rng, gi) if rng is not None else None
        out = generate(params, model_cfg, [p for _, p in group],
                       cfg.max_new_tokens, temperature=cfg.temperature,
                       top_k=cfg.top_k, top_p=cfg.top_p, rng=grng,
                       device=device)
        for row, i in zip(out.tolist(), idxs):
            results[i] = row
    return results


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = None) -> None:
    parser = argparse.ArgumentParser(prog="nos-tpu-torch-generate",
                                     description=__doc__)
    parser.add_argument("--config", default="", help="model config YAML")
    parser.add_argument("--checkpoint-dir", default="")
    parser.add_argument("--prompt", action="append", default=[],
                        help="comma-separated token ids (repeatable)")
    parser.add_argument("--max-new-tokens", type=int, default=None)
    parser.add_argument("--temperature", type=float, default=None)
    parser.add_argument("--top-k", type=int, default=None)
    parser.add_argument("--top-p", type=float, default=None)
    parser.add_argument("--int8", action="store_true")
    parser.add_argument(
        "--log-format", choices=("text", "json"), default="text",
        help="log line format; json emits one object per line")
    args = parser.parse_args(argv)

    cfg = GenerateConfig.from_yaml_file(args.config) if args.config \
        else GenerateConfig()
    if args.checkpoint_dir:
        cfg.checkpoint_dir = args.checkpoint_dir
    if args.max_new_tokens is not None:
        cfg.max_new_tokens = args.max_new_tokens
    if args.temperature is not None:
        cfg.temperature = args.temperature
    if args.top_k is not None:
        cfg.top_k = args.top_k
    if args.top_p is not None:
        cfg.top_p = args.top_p
    if args.int8:
        cfg.int8 = True
    from nos_tpu_torch.cmd import setup_logging

    setup_logging(0, args.log_format,
                  numeric_level=getattr(logging, cfg.log_level.upper(), 20))

    prompts = []
    for raw in args.prompt or ["0"]:
        try:
            toks = [int(t) for t in raw.split(",") if t.strip()]
        except ValueError:
            parser.error(f"--prompt {raw!r} contains a non-integer token; "
                         f"pass comma-separated token ids, e.g. '1,2,3'")
        if not toks:
            parser.error(f"--prompt {raw!r} parsed to zero tokens; pass a "
                         f"comma-separated list of token ids, e.g. '1,2,3'")
        prompts.append(toks)
    for seq in run(cfg, prompts, device):
        print(json.dumps({"tokens": seq}))


if __name__ == "__main__":
    main()
