"""A second witness for a serving cell's comparison: the port's own
prefill path (``forward_with_cache``) over the cell's prompts, in bf16
as served and in float32, each held to the plain reference by the same
gap as the benchmark's check (the reference's best logit minus its logit
of the witness's first choice), at several depths of the configuration.
With experts it also counts the near-ties of the reference's routing:
token-layers whose second and third gates lie within ``--tie`` of each
other, where a lower precision may pick another expert.

    python -m portbench.witness --workload <cell> --seed <n> \\
        --requests 4 --depths 1,4,16
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from portbench import check, reference, spec, traffic
from portbench.model import dims_of, make_params


def port_logits(params, dm, seq, dtype):
    from nos_tpu_torch.models.generate import forward_with_cache, init_cache
    from nos_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(
        vocab=dm.vocab, d_model=dm.d_model, n_layers=dm.n_layers,
        n_heads=dm.n_heads, n_kv_heads=dm.n_kv_heads, d_ff=dm.d_ff,
        max_seq=dm.max_seq, rope_theta=dm.rope_theta, dtype=dtype,
        n_experts=dm.n_experts,
        expert_capacity_factor=dm.n_experts / 2 if dm.n_experts else 1.25)
    dev = params["embed"].device
    cache = init_cache(cfg, 1, max_len=len(seq), device=dev)
    with torch.no_grad():
        logits, _ = forward_with_cache(params, cfg,
                                       torch.tensor([seq], device=dev), cache)
    return logits[0].float()


def cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    return tree if tree.dtype == torch.float32 else tree.to(dtype)


def near_ties(params, dm, seq, tie: float) -> float:
    """Share of the reference's token-layers whose 2nd and 3rd gates lie
    within ``tie``."""
    hits = total = 0
    orig = reference.experts

    def experts(x, w, d):
        nonlocal hits, total
        g = torch.softmax(x @ w["w_router"], dim=-1).topk(3, dim=-1).values
        hits += int(((g[:, 1] - g[:, 2]) < tie).sum())
        total += g.shape[0]
        return orig(x, w, d)
    reference.experts = experts
    try:
        reference.logits(params, dm, [seq], [len(seq) - 1])
    finally:
        reference.experts = orig
    return hits / max(total, 1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.witness")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--depths", default="1,4")
    p.add_argument("--tie", type=float, default=1e-2)
    p.add_argument("--f32-max", type=int, default=4,
                   help="deepest model the float32 witness runs at")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.find_cell(bench, args.workload)
    cfg = spec.load_config(bench, cell["config"])
    mix = spec.load_traffic(cell["traffic"])
    full = dims_of(cfg)
    reqs = traffic.generate(mix, args.seed, 1, full.vocab)[:args.requests]
    for depth in (int(d) for d in args.depths.split(",")):
        dm = dataclasses.replace(full, n_layers=depth)
        params = make_params(dm, args.seed, torch.device(args.device))
        row = {"depth": depth}
        for name, dtype in (("bf16", torch.bfloat16),
                            ("f32", torch.float32)):
            if dtype == torch.float32 and depth > args.f32_max:
                continue
            gaps = []
            for r in reqs:
                seq = r.prompt
                ref = reference.logits(params, dm, [seq], [0])[0]
                got = port_logits(cast(params, dtype), dm, seq, dtype)
                gaps.append(check._gap(ref, got.argmax(dim=-1)))
            row[name] = check.spread_of(torch.cat(gaps))
            row[name]["max"] = float(torch.cat(gaps).max())
        if dm.n_experts:
            row["near_ties"] = near_ties(params, dm, reqs[0].prompt, args.tie)
        print(json.dumps(row), flush=True)
        del params
        torch.cuda.empty_cache() if args.device == "cuda" else None
    return 0


if __name__ == "__main__":
    sys.exit(main())
