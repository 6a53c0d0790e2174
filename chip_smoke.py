#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``nos_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed N] [--phases cdefghi]

Phases (each raises on failure; nothing is caught):

a. identify the card (name, power limit) and turn TF32 off;
b. build every CUDA kernel from ``nos_tpu_torch/csrc`` with ``nvcc``;
c. hold the paged kernel against its plain PyTorch version on the card
   at the main path's shapes (S 1/4/256, bf16 and int8 arenas under bf16
   compute, the same under f32), at full context (every row at 2048
   tokens) and at bs 8 / head_dim 64, each element within a pin derived
   from the rounding each dtype allows, and bit-identical over two
   launches; time kernel (CUDA events, and torch.profiler's kernel
   durations), plain version, a library call and the bytes bound;
d. exact tokens in f32, plain and int8 arenas: the serving engine
   through the kernel commits the same tokens as ``generate_paged``
   through the kernel and through the plain gather formulation;
e. the main path at full width: ``build_engine`` on a Llama-3-8B-shaped
   decoder (GQA 32/8 heads, d_model 4096, d_ff 14336, vocab 128256, 32
   layers, random weights from the seed; max_seq cut to 2048) serves 8
   requests x 32 tokens, greedy with a bf16 and an int8 KV arena, then
   sampled on the bf16 arena (temperature 0.8, top-k 50, top-p 0.95,
   seeds 0-7, served twice for the same tokens); each run's kernel
   launch count must equal n_layers x decode ticks, and the profiled
   ticks must show one paged_decode kernel per layer (no merge launch);
   the sampled run also times its sampling ops alone;
f. the four flash-attention kernels (forward, backward preprocess, dK/dV,
   dQ) against their plain versions at the training slice's shape
   (batch 8, 16 query / 4 KV heads, S 2048, head_dim 128, causal), at
   head_dim 64, with a full mask, at a ragged S 1000 (head_dim 128 and
   64), with GQA groups of 1 and of 8 (S 4096), and with Sq 1000 < Sk
   2048 (causal), under bf16 and f32, each element of O, LSE, dQ, dK, dV
   within a rounding-derived pin, and dK, dV, dQ bit-identical over two
   launches; times kernel, plain version, SDPA and the FLOP bound;
g. the training path at full width: ``train()`` on bench.py's 1.1 B
   model (d_model 2048, 16 layers, GQA 16/4, d_ff 8192, vocab 32000,
   batch 8 x 2048, bf16, full remat, adamw, random weights and synthetic
   batches from the seed) takes 8 steps; the loss must be finite and
   fall, the flash forward must launch 2 x 16 x 8 times (full remat
   re-runs it), each backward kernel 16 x 8 times and the adamw kernel
   once per param leaf and step. Then 2 profiled steps (device idle
   share; the flash forward and backward kernels' milliseconds and
   their share of busy time), at 2 layers in f32 one step's loss and
   gradients through the kernel against ``NOS_TPU_TORCH_ATTN_IMPL=xla``,
   and the adamw kernel against its plain version on the model's leaves
   (bit-identical, bf16 and f32), timed beside the plain version and
   ``torch.optim.AdamW(fused=True)``;
h. sampled decoding, f32 on phase (d)'s model: the port's threefry
   (keys, bits, split, randint, uniform, gumbel, categorical) on the card
   equals it on the CPU bit for bit; the engine's sampled streams (mixed
   temperatures, top-k, top-p, seeds) through the kernel equal those
   through the gather formulation; each request alone equals it in a
   full batch; a rerun with the same seeds gives the same tokens;
i. the serving binary at phase (e)'s full width: ``build_engine`` on the
   same 8B-class decoder (bf16 arena, paged kernel on) drained directly
   once, then served by ``ServingLoop`` (restart budget 1, watchdog on)
   behind ``make_http_server`` on 127.0.0.1: phase (e)'s 8 prompts from 8
   concurrent client threads (6 unary, 2 SSE), greedy at 32 new tokens,
   then sampled at phase (e)'s params. Every response equals phase (e)'s
   tokens for its prompt (greedy and sampled), the SSE deltas joined equal
   the unary result, paged launches equal n_layers x the loop's ticks,
   /healthz and /readyz answer ok, /stats keys are the reference's,
   /metrics counts 8 finished requests and 8 x 31 decode tokens, and a
   request after /admin/drain gets 503. Prints TTFT/TPOT p50/p99 from the
   loop's histograms, ms per tick through the loop beside the direct
   drain, the tick phases, the device idle share of a profiled stretch
   of loop ticks, build seconds and peak memory.

Prints one JSON line per phase, then the kernels line, then as the last
line ``{"ok": true, "device": {...}}``. Exits non-zero without that line
when there is no CUDA device or when the port is not beside this file.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet; 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# the reference's bf16 pin for this kernel against its gather oracle,
# an absolute ceiling over every case
KERNEL_TOL = 4e-2
# per-element pins, |kernel - plain| <= r * |plain| + m * (P.|V|), by
# the compute dtype. bf16: both sides round their output to bf16 once,
# one ulp apart at most (<= 2^-7 |plain|), and the plain version rounds
# each probability to bf16 before P.V (relative 2^-9 each, so at most
# 2^-9 P.|V|; 2^-8 leaves room for the f32 score noise). f32: only the
# summation order differs.
PINS = {torch.bfloat16: (2.0 ** -7, 2.0 ** -8), torch.float32: (1e-5, 1e-5)}

FULL = dict(vocab=128256, d_model=4096, n_layers=32, n_heads=32,
            n_kv_heads=8, d_ff=14336, max_seq=2048)
# every phase after (a) and (b); a run of all of them prints the kernels
# line and the ok line
PHASES = "cdefghi"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ~200 us of spinning on the stream at the H100's 1.98 GHz boost clock
SPIN_CYCLES = 400_000


def cuda_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each timed
    alone with CUDA events after overwriting a buffer larger than L2,
    so every launch finds the cache cold as a decode step does. The
    stream then spins for ~200 us before the start event, so the host
    has queued ``fn``'s launches (its Python wrapper's checks and calls)
    before the start event is reached: host time does not enter the
    reading."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def kernel_profile(fn, iters: int, flush: torch.Tensor,
                   pattern: str) -> tuple:
    """(device ms per call, kernels per call) of the kernels whose name
    holds ``pattern``, from torch.profiler over ``iters`` calls of
    ``fn``, each after the L2 flush: the kernels' own durations, without
    launch gaps."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.key_averages():
        t = device_us(e)
        if t > 0 and pattern in e.key.lower():
            us += t
            n += e.count
    return us / 1e3 / iters, n / iters


def paged_case(rng, *, b, h, h_kv, d, bs, nb, s, int8, dtype, device,
               full=False):
    """Kernel inputs, q in ``dtype``: ragged positions, shuffled
    physical blocks, null tails, and row 0 inactive (all-null table);
    with ``full``, every row's window ends at its table's last slot."""
    from nos_tpu_torch.ops.attention import quantize_kv

    nb_phys = 1 + b * nb
    pos = rng.integers(0, nb * bs - s + 1, size=b).astype(np.int32)
    pos[0] = 0
    if full:
        pos[:] = nb * bs - s
    table = np.zeros((b, nb), np.int32)
    perm = rng.permutation(np.arange(1, nb_phys)).astype(np.int32)
    i = 0
    for row in range(0 if full else 1, b):
        n = (int(pos[row]) + s - 1) // bs + 1
        table[row, :n] = perm[i:i + n]
        i += n
    gen = torch.Generator(device).manual_seed(int(rng.integers(1 << 31)))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(dtype)

    q = randn(b, h, s, d)
    ka = randn(nb_phys, h_kv, bs, d)
    va = randn(nb_phys, h_kv, bs, d)
    ks = vs = None
    if int8:
        ka, ks = quantize_kv(ka)
        va, vs = quantize_kv(va)
    return dict(q=q, k_arena=ka, v_arena=va,
                table=torch.from_numpy(table).to(device),
                pos=torch.from_numpy(pos).to(device),
                k_scale=ks, v_scale=vs)


def paged_work(case) -> tuple:
    """(bytes, operations) of this call's work. Bytes: each live K/V
    token (+ its scales) read once, its table entries, q and pos read
    once, out written once. Operations: QK and PV over the live
    tokens."""
    q, ka = case["q"], case["k_arena"]
    b, h, s, d = q.shape
    h_kv, bs = ka.shape[1], ka.shape[2]
    tokens = np.minimum(case["pos"].cpu().numpy().astype(np.int64) + s,
                        case["table"].shape[1] * bs)
    per_tok = h_kv * d * ka.element_size() * 2
    if case["k_scale"] is not None:
        per_tok += h_kv * 4 * 2
    nbytes = (int(tokens.sum()) * per_tok
              + int(np.ceil(tokens / bs).sum()) * 4 + b * 4
              + 2 * q.numel() * q.element_size())
    return nbytes, 4 * h * s * d * int(tokens.sum())


def paged_bound(case) -> tuple:
    """(ms, "bytes"|"operations"): the least time for this call's work,
    bytes at the HBM rate, operations at the bf16 tensor rate."""
    nbytes, flops = paged_work(case)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(case):
    """One PyTorch call computing the same function, as a yardstick the
    port never calls: SDPA over the gathered, dequantized timeline with
    K/V repeated to every query head and the causal ``pos`` mask."""
    from nos_tpu_torch.ops.attention import (
        dequantize_kv, paged_gather_kv, paged_gather_scale,
    )

    q, table = case["q"], case["table"]
    g = q.shape[1] // case["k_arena"].shape[1]
    gk = paged_gather_kv(case["k_arena"], table)
    gv = paged_gather_kv(case["v_arena"], table)
    if case["k_scale"] is not None:
        gk = dequantize_kv(gk, paged_gather_scale(case["k_scale"], table),
                           q.dtype)
        gv = dequantize_kv(gv, paged_gather_scale(case["v_scale"], table),
                           q.dtype)
    gk = gk.repeat_interleave(g, dim=1)
    gv = gv.repeat_interleave(g, dim=1)
    s, t = q.shape[2], gk.shape[2]
    positions = case["pos"].long()[:, None] + torch.arange(
        s, device=q.device)[None]
    mask = (torch.arange(t, device=q.device)[None, None]
            <= positions[..., None])[:, None]           # [B, 1, S, T]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, gk, gv, attn_mask=mask)


def check_kernel(out, case) -> dict:
    """Hold one kernel output against the plain version on the same
    inputs with ``PINS`` per element and ``KERNEL_TOL`` over all; raises
    on a disagreement, returns the readings."""
    from nos_tpu_torch.ops.attention import paged_decode_attention_reference

    ref = paged_decode_attention_reference(**case).float()
    # P.|V|: the plain version over |V| (int8: |q| * scale dequantizes
    # to |v| exactly)
    mag = paged_decode_attention_reference(
        **dict(case, v_arena=case["v_arena"].abs())).float()
    r, m = PINS[case["q"].dtype]
    diff = (out.float() - ref).abs()
    # an exact zero (one attended token whose value quantized to 0)
    # has a zero pin and must match exactly
    share = torch.where(diff == 0, torch.zeros_like(diff),
                        diff / (r * ref.abs() + m * mag))
    ratio = float(share.max())
    err = float(diff.max())
    if not (err <= KERNEL_TOL and ratio <= 1.0
            and bool(torch.isfinite(out).all())):
        raise AssertionError(
            f"paged kernel disagrees with its plain version: max|diff| "
            f"{err} (ceiling {KERNEL_TOL}), worst share of the per-element "
            f"pin {ratio} (must be <= 1; pin {r}|ref| + {m} P.|V|)")
    return {"max_abs_err": err, "worst_pin_share": ratio,
            "pin": f"{r:g}*|ref| + {m:g}*P.|V|", "tol": KERNEL_TOL}


# phase (c)'s shapes: the serving slice's decode shape, and bs 8 with
# head_dim 64 (1 KB bf16 pages, the smallest bulk copies the kernel takes)
PAGED = dict(b=8, h=32, h_kv=8, d=128, bs=16, nb=128)
PAGED_BS8_D64 = dict(b=8, h=32, h_kv=8, d=64, bs=8, nb=256)


def phase_kernels(seed: int, device, flush) -> dict:
    """(c): the paged kernel against its plain version at the slice's
    shapes, with bf16 and int8 arenas under bf16 compute (the main
    path's) and the same under f32 compute, where only the summation
    order differs from the plain version and a structural slip (a
    dropped block, an off-by-one mask) cannot hide in rounding; at full
    context (bf16, int8) and at bs 8 / head_dim 64 (bf16, f32). Every
    case is also launched twice and must give the same bits. Returns the
    numbers for the kernels line."""
    from nos_tpu_torch.ops import _kernels
    from nos_tpu_torch.ops.attention import paged_decode_attention_reference

    rng = np.random.default_rng(seed)
    cases = [(f"S{s}", PAGED, arena, dtype, int8, s, False)
             for arena, dtype, int8 in (("bf16", torch.bfloat16, False),
                                        ("int8", torch.bfloat16, True),
                                        ("f32", torch.float32, False),
                                        ("int8_f32", torch.float32, True))
             for s in (1, 4, 256)]
    cases += [("full_context", PAGED, "bf16", torch.bfloat16, False, 1,
               True),
              ("full_context", PAGED, "int8", torch.bfloat16, True, 1, True),
              ("bs8_d64", PAGED_BS8_D64, "bf16", torch.bfloat16, False, 1,
               False),
              ("bs8_d64", PAGED_BS8_D64, "f32", torch.float32, False, 1,
               False)]
    worst = {"max_abs_err": 0.0, "worst_pin_share": 0.0}
    timed = {}
    for label, shape, arena, dtype, int8, s, full in cases:
        case = paged_case(rng, s=s, int8=int8, dtype=dtype, device=device,
                          full=full, **shape)

        def launch():
            return _kernels.paged_decode.launch(
                case["q"], case["k_arena"], case["v_arena"], case["table"],
                case["pos"], k_scale=case["k_scale"],
                v_scale=case["v_scale"], scale=shape["d"] ** -0.5)

        out = launch()
        row = {"phase": "kernel_vs_plain", "kernel":
               "paged_decode_attention", "case": label, "S": s,
               "arena": arena, "compute": str(dtype).split(".")[-1],
               **shape, "live_tokens": int((case["pos"] + s).clamp(
                   max=shape["nb"] * shape["bs"]).sum()),
               **check_kernel(out, case)}
        if not torch.equal(launch(), out):
            raise AssertionError(f"paged kernel {label} {arena}: two "
                                 f"launches gave different bits")
        row["bit_identical_rerun"] = True
        for k in worst:
            worst[k] = max(worst[k], row[k])
        if s == 1 and dtype == torch.bfloat16 and shape is PAGED:
            ref = paged_decode_attention_reference(**case)
            lib = library_call(case)
            row["library_max_abs_err"] = float(
                (lib().float() - ref.float()).abs().max())
            row["ms"] = cuda_ms(launch, 100, flush)
            row["profiled_ms"], row["kernels_per_call"] = kernel_profile(
                launch, 50, flush, "paged_decode")
            row["plain_ms"] = cuda_ms(
                lambda: paged_decode_attention_reference(**case), 30, flush)
            row["library_ms"] = cuda_ms(lib, 100, flush)
            row["bound_ms"], row["bound_by"] = paged_bound(case)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["achieved_gb_per_s"] = paged_work(case)[0] / row["ms"] / 1e6
            timed[(label, arena)] = row
        emit(row)
        del case, out
    main, i8 = timed[("S1", "bf16")], timed[("S1", "int8")]
    fc, fc8 = timed[("full_context", "bf16")], timed[("full_context", "int8")]
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "nos_tpu_torch/csrc/paged_decode_attention.cu",
            "replaces": "nos_tpu/ops/attention.py:430",
            "max_abs_err": worst["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "profiled_ms": main["profiled_ms"],
            "kernels_per_call": main["kernels_per_call"],
            "worst_pin_share": worst["worst_pin_share"],
            "int8_ms": i8["ms"], "int8_bound_ms": i8["bound_ms"],
            "full_context_ms": fc["ms"],
            "full_context_bound_ms": fc["bound_ms"],
            "full_context_int8_ms": fc8["ms"],
            "full_context_int8_bound_ms": fc8["bound_ms"]}


# phase (d)'s small f32 model, shared with phase (h)
SMALL = dict(vocab=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=512, max_seq=256)


def phase_exact_tokens(seed: int, device) -> None:
    """(d): f32, plain and int8 arenas: the engine through the kernel
    commits the same tokens as ``generate_paged`` through the kernel
    (the reference's serving == generate_paged contract) and as
    ``generate_paged`` through the plain gather formulation, which runs
    no kernel."""
    from nos_tpu_torch.models.generate import generate_paged
    from nos_tpu_torch.models.serving import DecodeServer
    from nos_tpu_torch.models.transformer import (
        TransformerConfig, init_params,
    )
    from nos_tpu_torch.ops import _kernels

    cfg = TransformerConfig(**SMALL, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device).manual_seed(seed),
                         device)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist()
               for n in (5, 17, 40, 77)]
    new = 16
    for kv_dtype in ("bf16", "int8"):       # "bf16" is the f32 arena here
        _kernels.paged_decode.launches = 0
        eng = DecodeServer(params, cfg, max_batch=4, kv_block_size=16,
                           kv_blocks=1 + 4 * 16, kv_dtype=kv_dtype,
                           device=device, paged_impl="kernel")
        assert eng.paged_kernel == "kernel", eng.paged_kernel
        rids = [eng.submit(p, new) for p in prompts]
        served = eng.drain()
        launches = _kernels.paged_decode.launches
        assert launches == cfg.n_layers * eng.ticks, (launches, eng.ticks)
        for rid, p in zip(rids, prompts):
            for impl in ("kernel", "xla"):
                want = generate_paged(params, cfg, [p], new, block_size=16,
                                      kv_dtype=kv_dtype, paged_impl=impl,
                                      device=device)[0].tolist()
                if served[rid] != want:
                    raise AssertionError(
                        f"serving != generate_paged({impl}) for prompt "
                        f"len {len(p)}, kv_dtype {kv_dtype}: "
                        f"{served[rid][len(p):]} vs {want[len(p):]}")
        emit({"phase": "exact_tokens_f32", "kv_dtype": kv_dtype,
              "requests": len(prompts), "new_tokens": new,
              "equal_generate_paged_kernel": True,
              "equal_generate_paged_plain": True,
              "engine_launches": launches})


# phase (h)'s requests: (prompt length, new tokens, sampling params)
SAMPLED_MIX = [(5, 16, dict(temperature=0.7, seed=11)),
               (17, 12, dict()),
               (40, 16, dict(temperature=1.3, top_k=5, seed=3)),
               (77, 9, dict(temperature=1.0, top_p=0.9, seed=2 ** 32 - 1)),
               (9, 14, dict(temperature=0.9, top_k=50, top_p=0.95, seed=8)),
               (33, 10, dict(temperature=1.1, top_k=1, seed=5))]


def prng_card_vs_cpu(device) -> int:
    """Threefry keys, bits, split, randint, uniform and gumbel on the card
    against the same calls on CPU tensors, bit for bit, over a grid of
    seeds and shapes; returns the number of comparisons."""
    from nos_tpu_torch.utils import prng

    n = 0

    def same(name, card, cpu):
        nonlocal n
        n += 1
        if not torch.equal(card.cpu(), cpu):
            raise AssertionError(f"prng {name}: the card's bits differ "
                                 f"from the CPU's")

    for seed in (0, 1, 42, 2 ** 31 - 1, 2 ** 32 - 1):
        kc, kh = prng.PRNGKey(seed, device), prng.PRNGKey(seed)
        same(f"fold_in {seed}", prng.fold_in(kc, 1234), prng.fold_in(kh, 1234))
        same(f"split {seed}", prng.split(kc, 64), prng.split(kh, 64))
        for shape in ((), (7,), (3, 5, 7), (8, 128256)):
            for name, fn in (
                    ("bits", prng.random_bits),
                    ("uniform", prng.uniform), ("gumbel", prng.gumbel),
                    ("randint", lambda k, sh: prng.randint(k, sh, 0,
                                                           128256))):
                same(f"{name} {seed} {shape}", fn(kc, shape), fn(kh, shape))
    seeds = torch.tensor([0, 7, 2 ** 32 - 1, 99], dtype=torch.int64)
    pos = torch.tensor([1, 500, 2047, 3], dtype=torch.int64)
    keys_c = prng.fold_in(prng.PRNGKey(seeds.to(device)), pos.to(device))
    keys_h = prng.fold_in(prng.PRNGKey(seeds), pos)
    same("batched fold_in", keys_c, keys_h)
    logits = torch.randn(4, 128256, generator=torch.Generator().manual_seed(1))
    same("batched categorical", prng.categorical(keys_c, logits.to(device)),
         prng.categorical(keys_h, logits))
    return n


def phase_sampling(seed: int, device) -> None:
    """(h): sampled decoding on the card, f32, phase (d)'s model: the
    port's threefry on the card equals it on the CPU; the engine's
    sampled streams through the kernel equal its streams through the
    gather formulation; a sampled request alone equals it in a full
    batch; rerunning with the same seeds gives the same tokens."""
    from nos_tpu_torch.models.serving import DecodeServer
    from nos_tpu_torch.models.transformer import (
        TransformerConfig, init_params,
    )
    from nos_tpu_torch.ops import _kernels

    checks = prng_card_vs_cpu(device)
    cfg = TransformerConfig(**SMALL, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device).manual_seed(seed),
                         device)
    rng = np.random.default_rng(seed + 1)
    reqs = [(rng.integers(0, cfg.vocab, size=n).tolist(), new, kw)
            for n, new, kw in SAMPLED_MIX]

    def engine(impl):
        return DecodeServer(params, cfg, max_batch=4, kv_block_size=16,
                            kv_blocks=1 + 4 * 16, device=device,
                            paged_impl=impl)

    def serve(impl, requests):
        eng = engine(impl)
        rids = [eng.submit(p, new, **kw) for p, new, kw in requests]
        out = eng.drain()
        return [out[r] for r in rids], eng.ticks

    _kernels.paged_decode.launches = 0          # the main path's count
    kernel, ticks = serve("kernel", reqs)
    launches = _kernels.paged_decode.launches
    if launches != cfg.n_layers * ticks:
        raise AssertionError(f"sampled engine: kernel launches {launches} "
                             f"!= n_layers x ticks {cfg.n_layers} x {ticks}")
    gather, _ = serve("xla", reqs)
    if kernel != gather:
        raise AssertionError(
            f"sampled streams through the kernel {kernel} differ from the "
            f"gather formulation's {gather}")
    again, _ = serve("kernel", reqs)
    if again != kernel:
        raise AssertionError("sampled rerun with the same seeds differs")
    alone = [serve("kernel", [r])[0][0] for r in reqs]
    if alone != kernel:
        raise AssertionError(
            f"a sampled request alone {alone} differs from it in a full "
            f"batch {kernel}")
    emit({"phase": "sampling_f32", "prng_comparisons": checks,
          "prng_card_equals_cpu": True, "requests": len(reqs),
          "sampled_requests": sum(1 for *_, kw in reqs if kw),
          "kernel_equals_gather": True, "alone_equals_batched": True,
          "rerun_same_tokens": True, "engine_ticks": ticks,
          "engine_launches": launches,
          "tokens_sha256": token_digest(kernel)})


def decode_probe(eng, snapshot) -> dict:
    """One decode step from a snapshot of the live arena through the
    kernel and through the plain formulation. The model is bf16 and the
    two formulations round differently (the plain version rounds its
    probabilities to bf16 before P.V), which 32 layers carry into the
    logits. Logit tolerance 0.15: 1.5x the largest difference read on
    the H100 at this seed and these widths (0.0879 bf16 arena, 0.0996
    int8). Greedy tokens must agree on every row whose top-2 gap exceeds
    twice the measured difference, where no logit shift within it can
    swap the top two; ``probe_rows_clear_gap`` says how many rows that
    check covered (with random weights and a 128256-word vocab the top-2
    gap is often smaller)."""
    from nos_tpu_torch.models.generate import forward_paged

    cache, table, last = snapshot
    out = {}
    for impl in ("kernel", "xla"):
        work = {k: v.clone() for k, v in cache.items()}
        out[impl], _ = forward_paged(eng.params, eng.cfg, last, work, table,
                                     paged_impl=impl)
        del work
    lk, lp = out["kernel"][:, -1], out["xla"][:, -1]
    err = float((lk - lp).abs().max())
    tol = 0.15
    top2 = lk.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * err
    agree = lk.argmax(-1) == lp.argmax(-1)
    if err > tol or not bool(agree[clear].all()):
        raise AssertionError(
            f"kernel vs plain decode step: max|dlogit| {err} (tol {tol}), "
            f"argmax agree {agree.tolist()}, clear-gap rows "
            f"{clear.tolist()}")
    return {"probe_max_abs_logit_err": err, "probe_tol": tol,
            "probe_rows_clear_gap": int(clear.sum()),
            "probe_argmax_agree": int(agree.sum())}


def profile_ticks(eng, prompts, ticks: int = 3, sampling=None) -> dict:
    """Device breakdown of steady decode ticks: serve ``prompts`` again
    (with ``sampling[i]``'s params when given), take one warm tick, then
    profile ``ticks`` engine steps with torch.profiler. Device busy = the
    sum of kernel times; the idle share against the profiled wall
    overstates idleness (the profiler slows the host), so the caller
    also reports it against the unprofiled tick. Kernels are grouped as
    the paged kernel (one launch per layer), matmuls (cuBLAS/CUTLASS
    names) and everything else."""
    from torch.profiler import ProfilerActivity, profile

    for i, p in enumerate(prompts):
        eng.submit(p, ticks + 2, **(sampling[i] if sampling else {}))
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / ticks
    eng.drain()
    out = device_breakdown(prof, ticks, {"paged_kernel": ("paged_decode",)})
    busy = out["device_busy_ms"]
    return {"profiled_ms_per_tick": wall_ms,
            "device_busy_ms_per_tick": busy,
            "device_idle_share_profiled": 1 - busy / wall_ms,
            "device_ms_per_tick": out["device_ms"],
            "kernels_per_tick": out["kernels_per_run"],
            "paged_kernels_per_tick":
                out["group_kernels_per_run"]["paged_kernel"],
            "top_kernels": out["top_kernels"]}


def device_us(event) -> float:
    """An averaged profiler event's own device microseconds (0 for host
    events)."""
    us = getattr(event, "self_device_time_total", None)
    if us is None:
        us = getattr(event, "self_cuda_time_total", 0.0)
    if str(getattr(event, "device_type", "")).endswith("CPU"):
        return 0.0
    return us


def device_breakdown(prof, runs: int, named: dict) -> dict:
    """Kernel time per run from a torch.profiler trace, grouped as
    ``named`` (group -> name substrings), matmuls (cuBLAS/CUTLASS names)
    and everything else, with the kernels of each group per run; busy =
    the sum of kernel times."""
    groups = {g: 0.0 for g in named}
    groups.update(matmul=0.0, other=0.0)
    counts = dict.fromkeys(groups, 0)
    kernels = []
    n_kernels = 0
    for e in prof.key_averages():
        us = device_us(e)
        if us <= 0:
            continue
        name = e.key
        low = name.lower()
        g = next((g for g, pats in named.items()
                  if any(p in low for p in pats)), None)
        if g is None:
            g = ("matmul" if any(k in low for k in (
                "gemm", "gemv", "xmma", "cutlass", "cublas", "nvjet",
                "sm90_")) else "other")
        groups[g] += us / 1e3 / runs
        counts[g] += e.count
        n_kernels += e.count
        kernels.append((us / 1e3 / runs, e.count // runs, name[:80]))
    kernels.sort(reverse=True)
    return {"device_busy_ms": sum(groups.values()), "device_ms": groups,
            "kernels_per_run": n_kernels / runs,
            "group_kernels_per_run": {g: n / runs for g, n in counts.items()},
            "top_kernels": [{"ms": ms, "count": c, "name": n}
                            for ms, c, n in kernels[:8]]}


# phase (e)'s sampled run: every request samples, per-request seeds
SAMPLED = [dict(temperature=0.8, top_k=50, top_p=0.95, seed=i)
           for i in range(8)]


def sampling_profile(eng) -> dict:
    """Device ms and kernels of the sampled tick's sampling ops alone
    (``DecodeServer._sample`` on a [max_batch, vocab] logit row with
    phase (e)'s sampling rows), from torch.profiler over 5 calls."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(eng.device).manual_seed(0)
    step = torch.randn((eng.max_batch, eng.cfg.vocab), generator=gen,
                       device=eng.device) * 3
    pos0 = torch.full((eng.max_batch,), 700, dtype=torch.int32,
                      device=eng.device)
    greedy = step.argmax(-1)
    eng._sample(step, pos0, greedy)
    torch.cuda.synchronize()
    n = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            eng._sample(step, pos0, greedy)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / n
    out = device_breakdown(prof, n, {})
    return {"sampling_device_ms": out["device_busy_ms"],
            "sampling_kernels": out["kernels_per_run"],
            "sampling_profiled_wall_ms": wall}


def full_width_prompts(seed: int) -> list:
    """Phase (e)'s 8 prompts, 64-1024 tokens, from the seed."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 1025, size=8)
    return [rng.integers(0, FULL["vocab"], size=n).tolist() for n in lens]


def phase_full_width(seed: int, kv_dtype: str, card: str,
                     sampled: bool = False) -> tuple:
    """(e): build_engine at the 8B-class widths, 8 requests x 32 tokens,
    greedy, or with ``sampled`` every request at ``SAMPLED``'s params
    and served twice (the same tokens both times); returns the kernel's
    launches on this main-path run and the served sequences."""
    from nos_tpu_torch.cmd.server import ServerConfig, build_engine
    from nos_tpu_torch.ops import _kernels

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_engine(ServerConfig(
        bf16=True, kv_blocks=1 + 8 * 128, kv_block_size=16, max_batch=8,
        paged_kernel="on", kv_dtype=kv_dtype, seed=seed, **FULL))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    assert eng.paged_kernel == "kernel", eng.paged_kernel
    prompts = full_width_prompts(seed)
    lens = [len(p) for p in prompts]
    new = 32
    sampling = SAMPLED if sampled else [{}] * len(prompts)

    _kernels.paged_decode.launches = 0          # the main path's count
    prefill_ms = []
    rids = []
    for p, kw in zip(prompts, sampling):
        t = time.perf_counter()
        rids.append(eng.submit(p, new, **kw))    # prefill + first token
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
    # the live arena after prefill, for the kernel-vs-plain probe below
    keep = torch.zeros(eng.max_batch, dtype=torch.bool, device=eng.device)
    keep[sorted(eng._active)] = True
    snapshot = ({k: v.clone() for k, v in eng.cache.items()},
                torch.where(keep[:, None], eng._table,
                            torch.zeros_like(eng._table)),
                eng._last.clone())
    t = time.perf_counter()
    served = eng.drain()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    launches = _kernels.paged_decode.launches
    ticks = eng.ticks
    decoded = eng.tokens_emitted                # before probe and profile

    for rid, p in zip(rids, prompts):
        got = served[rid][len(p):]
        if len(got) != new or served[rid][:len(p)] != p:
            raise AssertionError(f"request {rid}: {len(got)} tokens")
    if launches != FULL["n_layers"] * ticks:
        raise AssertionError(
            f"kernel launches {launches} != n_layers x ticks "
            f"{FULL['n_layers']} x {ticks}")
    extra = {}
    if sampled:
        again = [eng.submit(p, new, **kw) for p, kw in zip(prompts,
                                                           sampling)]
        rerun = eng.drain()
        if [rerun[r] for r in again] != [served[r] for r in rids]:
            raise AssertionError("sampled run: a second pass with the same "
                                 "seeds gave other tokens")
        extra = {"sampling": SAMPLED[0], "seeds": [kw["seed"]
                                                   for kw in SAMPLED],
                 "rerun_same_tokens": True, **sampling_profile(eng)}
    probe = decode_probe(eng, snapshot)
    del snapshot
    breakdown = profile_ticks(eng, prompts,
                              sampling=SAMPLED if sampled else None)
    if breakdown["paged_kernels_per_tick"] != FULL["n_layers"]:
        raise AssertionError(
            f"profiled paged_decode kernels per tick "
            f"{breakdown['paged_kernels_per_tick']} != one per layer "
            f"({FULL['n_layers']})")
    emit({"phase": "full_width", "kv_dtype": kv_dtype,
          "mode": "sampled" if sampled else "greedy", "card": card,
          **{k: FULL[k] for k in FULL}, "requests": len(prompts),
          "prompt_lens": [int(n) for n in lens], "new_tokens": new,
          "build_s": build_s, "prefill_ms": prefill_ms,
          "prefill_ms_mean": float(np.mean(prefill_ms)),
          "decode_ticks": ticks, "decode_ms_per_tick": decode_s * 1e3 / ticks,
          "decode_tokens": decoded,
          "decode_tokens_per_s": decoded / decode_s,
          "kernel_launches": launches,
          "tokens_sha256": token_digest([served[r] for r in rids]),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, **probe,
          "device_idle_share": 1 - breakdown["device_busy_ms_per_tick"]
          / (decode_s * 1e3 / ticks), **extra,
          "profile": breakdown})
    seqs = [served[r] for r in rids]
    del eng, served
    return launches, seqs


def token_digest(seqs) -> str:
    """A short digest of served token lists, to compare runs by."""
    import hashlib

    return hashlib.sha256(json.dumps(seqs).encode()).hexdigest()[:16]


# the reference's documented replica /stats keys
# (tests/test_metrics_docs.py::REPLICA_STATS_KEYS)
REPLICA_STATS_KEYS = {
    "engine", "role", "handoff", "max_batch", "max_len", "slots",
    "active_slots", "pending", "prefill_sched", "pipeline",
    "prefix_cache", "prefix_index", "kv", "tenants", "compiles",
    "tokens_emitted", "healthy", "draining", "recovering", "uptime_s",
    "config", "per_request", "supervisor", "deadline", "slo", "rates",
    "kv_fabric_pulls", "tick_phases", "slo_budget", "chip_ledger",
}


def http_call(url: str, path: str, body=None, timeout: float = 300.0):
    """(status, body bytes) of a GET (``body`` None) or a JSON POST,
    error statuses included."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def sse_tokens(url: str, body: dict, timeout: float = 300.0) -> list:
    """The token deltas of a ``"stream": true`` POST, SSE frame by frame
    (raises on an error frame or a missing [DONE])."""
    import urllib.request

    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps({**body, "stream": True})
        .encode(), headers={"Content-Type": "application/json"},
        method="POST")
    deltas = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if r.headers["Content-Type"] != "text/event-stream":
            raise AssertionError(f"SSE content type {r.headers}")
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                return deltas
            frame = json.loads(payload)
            if "error" in frame:
                raise AssertionError(f"SSE error frame: {frame['error']}")
            deltas.append(frame["tokens"])
    raise AssertionError("SSE stream ended without [DONE]")


def http_pass(url: str, prompts, new: int, sampling) -> tuple:
    """Phase (i)'s traffic: every prompt from its own client thread, all
    released together; the last two stream (SSE), the rest are unary.
    Returns (full sequences by prompt, SSE deltas by prompt, wall s)."""
    import threading

    n = len(prompts)
    seqs, deltas, errors = [None] * n, [None] * n, []
    gate = threading.Barrier(n + 1)

    def client(i):
        body = {"prompt": prompts[i], "max_new_tokens": new, **sampling[i]}
        try:
            gate.wait(timeout=60)
            if i >= n - 2:
                deltas[i] = sse_tokens(url, body)
                seqs[i] = prompts[i] + [t for d in deltas[i] for t in d]
            else:
                status, raw = http_call(url, "/v1/generate", body)
                if status != 200:
                    raise AssertionError(f"status {status}: {raw[:300]}")
                seqs[i] = json.loads(raw)["tokens"]
        except BaseException as e:       # re-raised below, on this thread
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    gate.wait(timeout=60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"HTTP clients failed: {errors}")
    return seqs, deltas, wall


def metric_line(text: str, name: str) -> float:
    """A sample's value in /metrics text; 0 before its first increment
    (an unlabeled counter is not exposed until then)."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[-1])
    return 0.0


def profile_loop_ticks(loop, url, prompts, new: int) -> dict:
    """Device busy and idle share over a stretch of the loop's ticks:
    8 greedy requests from client threads, torch.profiler on while the
    loop ticks with all 8 slots decoding (prefill excluded)."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    eng = loop.engine
    threads = [threading.Thread(target=http_call, args=(
        url, "/v1/generate", {"prompt": p, "max_new_tokens": new}))
        for p in prompts]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 60
    while eng.occupancy() != (len(prompts), 0):
        if time.monotonic() > deadline:
            raise AssertionError(f"occupancy {eng.occupancy()}: the 8 "
                                 f"requests were never decoding together")
        time.sleep(0.002)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ticks0 = loop.m_ticks.value()
        t = time.perf_counter()
        while loop.m_ticks.value() < ticks0 + 6:
            if time.perf_counter() - t > 60:
                raise AssertionError("the loop stopped ticking while "
                                     "profiled")
            time.sleep(0.002)
        ticks = loop.m_ticks.value() - ticks0
        wall_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
    for th in threads:
        th.join(timeout=300)
    out = device_breakdown(prof, 1, {"paged_kernel": ("paged_decode",)})
    busy = out["device_busy_ms"]
    return {"profiled_loop_ticks": ticks,
            "profiled_wall_ms_per_tick": wall_ms / ticks,
            "device_busy_ms_per_tick": busy / ticks,
            "device_idle_share": 1 - busy / wall_ms,
            "kernels_per_tick": out["kernels_per_run"] / ticks}


def loop_tick_cost(loop, url, prompts, new: int) -> list:
    """What the loop and its consumers cost a tick, drift-controlled: the
    same greedy traffic run directly on the engine (``drain()`` under the
    loop's lock, so the ticker stays parked) between runs through the
    loop with its consumers varied — over HTTP (8 client threads),
    in-process (8 threads calling ``loop.generate``), one consumer (8
    streams opened, then read one after another by this thread), and
    over HTTP with a 10x longer interpreter switch interval. Each run
    reports the engine's host-blocked ms per tick (dispatch + token
    wait, the same clock for every run) and, through the loop, the
    tick's service time and dispatch phase."""
    import sys
    import threading

    eng = loop.engine

    def direct():
        with loop._work:
            for p in prompts:
                eng.submit(p, new)
            eng.drain()

    def in_process():
        threads = [threading.Thread(target=loop.generate, args=(p, new))
                   for p in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)

    def one_consumer():
        streams = [loop.stream(p, new) for p in prompts]
        for st in streams:
            for _ in st:
                pass

    def http():
        http_pass(url, prompts, new, [{}] * len(prompts))

    def http_slow_switch():
        interval = sys.getswitchinterval()
        sys.setswitchinterval(interval * 10)
        try:
            http()
        finally:
            sys.setswitchinterval(interval)

    runs = []
    for name, run in (("direct", direct), ("http", http),
                      ("direct", direct), ("in_process", in_process),
                      ("direct", direct), ("one_consumer", one_consumer),
                      ("direct", direct),
                      ("http_switch_50ms", http_slow_switch),
                      ("direct", direct)):
        k0, b0 = eng.ticks, eng.host_block_s
        n0, s0 = loop.h_tick.observations()
        d0, ds0 = loop.h_tick_phase.observations("dispatch")
        t = time.perf_counter()
        run()
        wall = time.perf_counter() - t
        k1 = eng.ticks
        row = {"run": name, "ticks": k1 - k0, "wall_s": wall,
               "host_block_ms_per_tick":
                   (eng.host_block_s - b0) * 1e3 / (k1 - k0)}
        if name == "direct":
            row["ms_per_tick"] = wall * 1e3 / (k1 - k0)
        else:
            n1, s1 = loop.h_tick.observations()
            d1, ds1 = loop.h_tick_phase.observations("dispatch")
            row["loop_tick_ms"] = (s1 - s0) * 1e3 / (n1 - n0)
            row["dispatch_ms_per_tick"] = (ds1 - ds0) * 1e3 / (d1 - d0)
        runs.append(row)
    return runs


def phase_http(seed: int, card: str, served: dict) -> int:
    """(i): the serving binary at phase (e)'s width; returns the paged
    kernel's launches over the greedy HTTP pass. ``served`` holds phase
    (e)'s greedy and sampled sequences when (e) ran in this call."""
    import threading

    from nos_tpu_torch.cmd.server import (
        ServerConfig, ServingLoop, build_engine, make_http_server,
    )
    from nos_tpu_torch.ops import _kernels

    cfg = ServerConfig(
        bf16=True, kv_blocks=1 + 8 * 128, kv_block_size=16, max_batch=8,
        paged_kernel="on", kv_dtype="bf16", seed=seed, port=0, **FULL)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_engine(cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prompts = full_width_prompts(seed)
    new = 32
    greedy = [{}] * len(prompts)

    # the direct drain on this engine, before the loop owns it: the
    # reference tokens of this call and its ms per tick
    rids = [eng.submit(p, new) for p in prompts]
    torch.cuda.synchronize()
    ticks0 = eng.ticks
    t = time.perf_counter()
    direct = eng.drain()
    torch.cuda.synchronize()
    direct_ms = (time.perf_counter() - t) * 1e3 / (eng.ticks - ticks0)
    direct = [direct[r] for r in rids]
    if "greedy" in served and direct != served["greedy"]:
        raise AssertionError("direct drain != phase (e)'s greedy tokens")

    loop = ServingLoop(eng, engine_factory=lambda: build_engine(cfg),
                       restart_budget=1, watchdog_s=120.0,
                       device_stats_interval_s=10.0)
    for h in (loop.h_ttft, loop.h_tpot):
        h.enable_sample_tracking()
    httpd = make_http_server(cfg, loop, host="127.0.0.1")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for path in ("/healthz", "/readyz"):
            status, raw = http_call(url, path)
            if status != 200 or json.loads(raw)["status"] != "ok":
                raise AssertionError(f"{path}: {status} {raw}")
        _, text = http_call(url, "/metrics")
        text = text.decode()
        fin0 = metric_line(
            text, 'nos_tpu_serve_requests_total{outcome="finished"}')
        tok0 = metric_line(text, "nos_tpu_serve_tokens_total")
        ticks0 = loop.m_ticks.value()
        tick_n0, tick_s0 = loop.h_tick.observations()
        ttft_at, tpot_at = loop.h_ttft.num_samples(), \
            loop.h_tpot.num_samples()

        _kernels.paged_decode.launches = 0      # the main path's count
        seqs, deltas, wall = http_pass(url, prompts, new, greedy)
        launches = _kernels.paged_decode.launches
        ticks = loop.m_ticks.value() - ticks0

        if seqs != direct:
            bad = [i for i, (a, b) in enumerate(zip(seqs, direct)) if a != b]
            raise AssertionError(f"HTTP greedy tokens differ from the "
                                 f"direct drain for prompts {bad}")
        for i, d in enumerate(deltas):
            if d is not None and prompts[i] + [t for x in d for t in x] \
                    != direct[i]:
                raise AssertionError(f"SSE deltas of prompt {i}")
        if launches != FULL["n_layers"] * ticks:
            raise AssertionError(
                f"paged launches {launches} != n_layers x loop ticks "
                f"{FULL['n_layers']} x {ticks}")
        _, text = http_call(url, "/metrics")
        text = text.decode()
        finished = metric_line(
            text, 'nos_tpu_serve_requests_total{outcome="finished"}') - fin0
        tokens = metric_line(text, "nos_tpu_serve_tokens_total") - tok0
        if finished != len(prompts) or tokens != len(prompts) * (new - 1):
            raise AssertionError(f"/metrics: finished {finished}, tokens "
                                 f"{tokens}")
        _, raw = http_call(url, "/stats")
        snap = json.loads(raw)
        if not set(snap) <= REPLICA_STATS_KEYS:
            raise AssertionError(f"/stats keys outside the reference's: "
                                 f"{sorted(set(snap) - REPLICA_STATS_KEYS)}")
        if snap["per_request"]["window"] != len(prompts):
            raise AssertionError(f"per_request {snap['per_request']}")
        phases = snap["tick_phases"]["seconds"]
        tick_n, tick_s = loop.h_tick.observations()
        loop_tick_ms = (tick_s - tick_s0) * 1e3 / (tick_n - tick_n0)
        q = {}
        for name, h, at in (("ttft", loop.h_ttft, ttft_at),
                            ("tpot", loop.h_tpot, tpot_at)):
            for p in (0.5, 0.99):
                q[f"{name}_p{int(p * 100)}_ms"] = h.quantile(p, at) * 1e3

        sampled, _, sampled_wall = http_pass(url, prompts, new, SAMPLED)
        if "sampled" in served and sampled != served["sampled"]:
            bad = [i for i, (a, b) in enumerate(zip(sampled,
                                                    served["sampled"]))
                   if a != b]
            raise AssertionError(f"HTTP sampled tokens differ from phase "
                                 f"(e)'s for prompts {bad}")
        prof = profile_loop_ticks(loop, url, prompts, 48)
        cost = loop_tick_cost(loop, url, prompts, new)

        status, raw = http_call(url, "/admin/drain", {})
        if status != 200:
            raise AssertionError(f"/admin/drain: {status}")
        status, raw = http_call(url, "/v1/generate",
                                {"prompt": prompts[0][:8],
                                 "max_new_tokens": 2})
        if status != 503 or json.loads(raw)["reason"] != "draining":
            raise AssertionError(f"request while draining: {status} {raw}")
        if not loop.wait_idle(60):
            raise AssertionError("loop not idle after the drain")
    finally:
        httpd.shutdown()
        loop.shutdown()
        httpd.server_close()
    total = sum(phases.values())
    emit({"phase": "http", "card": card, "requests": len(prompts),
          "unary": len(prompts) - 2, "sse": 2, "new_tokens": new,
          "build_s": build_s, "loop_ticks": ticks,
          "kernel_launches": launches, "http_wall_s": wall,
          "sampled_http_wall_s": sampled_wall,
          "loop_ms_per_tick": loop_tick_ms,
          "direct_ms_per_tick": direct_ms, **q,
          "tick_phase_share": {k: v / total for k, v in phases.items()},
          "tick_phase_seconds": phases,
          "tokens_sha256": token_digest(seqs),
          "sampled_tokens_sha256": token_digest(sampled),
          "compared_with_phase_e": sorted(served),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          **prof, "consumers": cost})
    # the loop and its threads hold the engine in reference cycles
    del eng, loop, httpd
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return launches


# the training slice's attention shape (bench.py's 1.1B model: batch 8,
# seq 2048, 16 query / 4 KV heads of 128)
ATTN = dict(b=8, h=16, h_kv=4, s_q=2048, s_k=2048, d=128)
# per-element pins of the flash kernels against their plain versions, by
# compute dtype. Forward O, as phase (c): |d| <= r |ref| + m P.|V|. bf16:
# a bf16 rounding has unit roundoff 2^-8. Each side rounds O once (r =
# 2 x 2^-8), and each rounds its probabilities once before P.V: the
# plain version the normalised ones, the kernel the unnormalised ones
# (<= 1, relative to the running max; the later rescale by alpha is in
# f32 and keeps their relative error), so m = 2 x 2^-8. f32: summation
# order only. LSE: |d| <= r_l (1 + |ref|), f32 in both, scores summed in
# another order. Gradients: |d| <= r |ref| + m max|ref| per tensor: the
# kernel rounds P (for dV) and dS (for dK, dQ) to bf16 where the plain
# version keeps f32, a 2^-9 relative error per term of sums over up to
# g * S terms whose cancellation leaves the tensor's largest element as
# the scale; f32 sums differ in order.
FLASH_PINS = {
    torch.bfloat16: dict(o_rn=(2.0 ** -7, 2.0 ** -7), lse=2.0 ** -16,
                         grad=(2.0 ** -7, 2.0 ** -7)),
    torch.float32: dict(o_rn=(1e-5, 1e-5), lse=2.0 ** -16,
                        grad=(1e-5, 1e-5)),
}
F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores


def attn_case(rng, *, b, h, h_kv, s_q, s_k, d, dtype, device):
    gen = torch.Generator(device).manual_seed(int(rng.integers(1 << 31)))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(dtype)

    return (randn(b, h, s_q, d), randn(b, h_kv, s_k, d),
            randn(b, h_kv, s_k, d), randn(b, h, s_q, d))


def attn_pairs(s_q: int, s_k: int, causal: bool) -> int:
    """(query, key) pairs the mask admits, per (batch, head)."""
    if not causal:
        return s_q * s_k
    i = np.arange(s_q)
    return int(np.minimum(s_k, i + (s_k - s_q) + 1).sum())


def flash_bounds(q, k, causal: bool) -> dict:
    """{kernel: (ms, "bytes"|"operations")}: each input read once, each
    output written once; operations per admitted (query, key) pair and
    head dim: forward 4 (QK^T, PV), dK/dV 8 (S, dP, dV, dK), dQ 6 (S,
    dP, dQ), preprocess 2 per output element; at the bf16 tensor rate
    for bf16 inputs, the f32 rate for f32."""
    b, h, s_q, d = q.shape
    h_kv, s_k = k.shape[1], k.shape[2]
    e = q.element_size()
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    pairs = attn_pairs(s_q, s_k, causal) * b * h
    qb, kb, rows = b * h * s_q * d * e, b * h_kv * s_k * d * e, b * h * s_q * 4
    work = {
        "flash_attention_fwd": (4 * d * pairs, 2 * qb + 2 * kb + rows),
        "flash_attention_bwd_preprocess": (2 * b * h * s_q * d,
                                           2 * qb + rows),
        "flash_attention_bwd_dkdv": (8 * d * pairs,
                                     2 * qb + 4 * kb + 2 * rows),
        "flash_attention_bwd_dq": (6 * d * pairs, 3 * qb + 2 * kb + 2 * rows),
    }
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops = ops / peak * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = ((t_ops, "operations") if t_ops >= t_bytes
                     else (t_bytes, "bytes"))
    return out


def pin_check(name: str, got, ref, r: float, m: float, scale=None) -> dict:
    """|got - ref| <= r |ref| + m * scale per element (``scale`` a tensor
    or the tensor's max |ref| when None); raises on a miss."""
    got, ref = got.float(), ref.float()
    mag = ref.abs().max() if scale is None else scale
    diff = (got - ref).abs()
    share = float((diff / (r * ref.abs() + m * mag)).max())
    err = float(diff.max())
    if not (share <= 1.0 and bool(torch.isfinite(got).all())):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: max|diff| "
            f"{err}, worst share of the pin {share} (pin {r:g}|ref| + "
            f"{m:g} * scale)")
    return {"max_abs_err": err, "worst_pin_share": share}


def phase_flash(seed: int, device, flush) -> dict:
    """(f): the four flash-attention kernels against their plain versions
    at the training slice's shape (causal), at head_dim 64, with a full
    mask, at a ragged S = 1000, with GQA groups of 1 and 8, with Sq 1000
    < Sk 2048 under the causal mask, and with a negative scale, under bf16
    and f32, the backward also bit-identical over two launches; times
    kernel, plain version and SDPA at the slice shape in bf16. Returns
    the kernels-line rows keyed by kernel name."""
    from nos_tpu_torch.ops import _kernels
    from nos_tpu_torch.ops.attention import (
        flash_attention_backward_reference, flash_attention_reference,
    )

    rng = np.random.default_rng(seed + 7)

    def sized(s, **kw):
        return dict(ATTN, s_q=s, s_k=s, **kw)

    cases = [("slice", ATTN, True),
             ("d64", sized(1024, b=2, h=8, h_kv=2, d=64), True),
             ("full_mask", sized(1024, b=2), False),
             ("ragged_s1000", sized(1000, b=2), True),
             ("g1", sized(1024, b=2, h=8, h_kv=8), True),
             ("g8_s4096", sized(4096, b=1, h=32, h_kv=4), True),
             ("ragged_s1000_d64", sized(1000, b=2, h=8, h_kv=2, d=64), True),
             # Sq < Sk: the bottom-right mask's offset Sk - Sq moves the
             # diagonal off the tile grid
             ("offset_q1000_k2048", dict(ATTN, b=2, s_q=1000, s_k=2048),
              True),
             # a negative scale: the running max is of the scaled scores
             ("neg_scale_s1000", sized(1000, b=1, h=8, h_kv=2), True)]
    rows = {}
    for label, shape, causal in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = attn_case(rng, dtype=dtype, device=device, **shape)
            scale = shape["d"] ** -0.5 * (-1 if label == "neg_scale_s1000"
                                          else 1)
            pins = FLASH_PINS[dtype]
            kw = dict(causal=causal, scale=scale)
            o, lse = _kernels.flash_fwd.launch(q, k, v, **kw)
            o_ref, lse_ref = flash_attention_reference(q, k, v, **kw)
            mag = flash_attention_reference(q, k, v.abs(), **kw)[0].float()
            checks = {"o": pin_check("flash_attention_fwd O", o, o_ref,
                                     *pins["o_rn"], scale=mag),
                      "lse": pin_check("flash_attention_fwd LSE", lse,
                                       lse_ref, pins["lse"], pins["lse"],
                                       scale=1.0)}
            delta = _kernels.flash_bwd_pre.launch(o, do)
            checks["delta"] = pin_check(
                "flash_attention_bwd_preprocess", delta,
                (do.float() * o.float()).sum(-1), *pins["grad"])
            dk, dv = _kernels.flash_bwd_dkdv.launch(q, k, v, do, lse, delta,
                                                    **kw)
            (dq,) = _kernels.flash_bwd_dq.launch(q, k, v, do, lse, delta,
                                                 **kw)
            torch.cuda.synchronize()
            ref = flash_attention_backward_reference(q, k, v, o, lse, do,
                                                     **kw)
            for nm, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                checks[nm] = pin_check(f"flash_attention_bwd {nm}", got,
                                       want, *pins["grad"])
            # no atomics: a second launch gives the same bits
            again = (*_kernels.flash_bwd_dkdv.launch(q, k, v, do, lse, delta,
                                                     **kw),
                     *_kernels.flash_bwd_dq.launch(q, k, v, do, lse, delta,
                                                   **kw))
            if not all(torch.equal(a, b_) for a, b_ in
                       zip(again, (dk, dv, dq))):
                raise AssertionError(f"{label} {dtype}: dK/dV/dQ differ "
                                     f"between two launches")
            checks["bit_identical_rerun"] = True
            del again
            row = {"phase": "flash_vs_plain", "case": label,
                   "causal": causal, "compute": str(dtype).split(".")[-1],
                   **shape, "pins": {k_: str(v_) for k_, v_ in pins.items()},
                   "checks": checks}
            if label == "slice" and dtype == torch.bfloat16:
                row["timing"] = time_flash(q, k, v, do, o, lse, delta, kw,
                                           flush)
                rows = {name: dict(t, max_abs_err=0.0)
                        for name, t in row["timing"].items()}
            for name, keys in (("flash_attention_fwd", ("o", "lse")),
                               ("flash_attention_bwd_preprocess", ("delta",)),
                               ("flash_attention_bwd_dkdv", ("dk", "dv")),
                               ("flash_attention_bwd_dq", ("dq",))):
                if name in rows:
                    rows[name]["max_abs_err"] = max(
                        rows[name]["max_abs_err"],
                        *(checks[c]["max_abs_err"] for c in keys))
            emit(row)
            del q, k, v, do, o, lse, delta, dq, dk, dv, ref, o_ref, mag
            torch.cuda.empty_cache()
    return rows


def time_flash(q, k, v, do, o, lse, delta, kw, flush) -> dict:
    """Device ms of each kernel, its plain version and one SDPA call at
    the slice shape; SDPA takes K/V repeated to every query head."""
    from nos_tpu_torch.ops import _kernels
    from nos_tpu_torch.ops.attention import (
        flash_attention_backward_reference, flash_attention_reference,
    )

    f = torch.nn.functional.scaled_dot_product_attention
    g = q.shape[1] // k.shape[1]
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (
        q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)))
    lib_out = f(qr, kr, vr, is_causal=kw["causal"], scale=kw["scale"])
    bounds = flash_bounds(q, k, kw["causal"])
    plain_bwd = cuda_ms(lambda: flash_attention_backward_reference(
        q, k, v, o, lse, do, **kw), 3, flush)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qr, kr, vr), do, retain_graph=True), 10, flush)
    timed = {
        "flash_attention_fwd": (
            lambda: _kernels.flash_fwd.launch(q, k, v, **kw),
            cuda_ms(lambda: flash_attention_reference(q, k, v, **kw), 3,
                    flush),
            cuda_ms(lambda: f(qr, kr, vr, is_causal=kw["causal"],
                              scale=kw["scale"]), 10, flush)),
        "flash_attention_bwd_preprocess": (
            lambda: _kernels.flash_bwd_pre.launch(o, do),
            cuda_ms(lambda: (do.float() * o.float()).sum(-1), 10, flush),
            cuda_ms(lambda: torch.linalg.vecdot(do, o), 10, flush)),
        "flash_attention_bwd_dkdv": (
            lambda: _kernels.flash_bwd_dkdv.launch(q, k, v, do, lse, delta,
                                                   **kw),
            plain_bwd, lib_bwd),
        "flash_attention_bwd_dq": (
            lambda: _kernels.flash_bwd_dq.launch(q, k, v, do, lse, delta,
                                                 **kw),
            plain_bwd, lib_bwd),
    }
    out = {}
    for name, (fn, plain_ms, lib_ms) in timed.items():
        ms = cuda_ms(fn, 10, flush)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bounds[name][0],
                     "bound_by": bounds[name][1],
                     "achieved_tflops": None}
    for name in ("flash_attention_fwd", "flash_attention_bwd_dkdv",
                 "flash_attention_bwd_dq"):
        if bounds[name][1] == "operations":
            out[name]["achieved_tflops"] = (
                bounds[name][0] * BF16_FLOPS / 1e12 / out[name]["ms"])
    return out


# bench.py's one-card training configuration (the headline MFU bench,
# bench_mfu.py): 1.1 B parameters, full remat, adamw, bf16
TRAIN = dict(vocab=32000, d_model=2048, n_layers=16, n_heads=16,
             n_kv_heads=4, d_ff=8192, max_seq=2048)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 8
# f32, 2 layers: loss and gradients through the kernel against the plain
# attention. Both sides are f32 and differ only in the attention's
# summation order (~1e-6 relative, phase f), which two layers' backward
# carry into every gradient.
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-4


def model_flops_per_step(cfg, batch, seq) -> float:
    """bench.py's analytic matmul FLOPs of one fwd+bwd step (bwd = 2x fwd,
    attention at full S^2), copied so the MFU reads as the reference's."""
    d, ff, L, v, kv = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab, \
        cfg.kv_dim
    per_tok = L * (2 * d * (d + 2 * kv) + 2 * d * d + 6 * d * ff) + 2 * d * v
    attn = L * 4 * batch * seq * seq * d
    return 3 * (batch * seq * per_tok + attn)


def train_kernels() -> dict:
    """The training path's kernel wrappers by their kernels-line names:
    the four flash-attention kernels and the adamw update."""
    from nos_tpu_torch.ops import _kernels

    return {"flash_attention_fwd": _kernels.flash_fwd,
            "flash_attention_bwd_preprocess": _kernels.flash_bwd_pre,
            "flash_attention_bwd_dkdv": _kernels.flash_bwd_dkdv,
            "flash_attention_bwd_dq": _kernels.flash_bwd_dq,
            "adamw": _kernels.adamw}


def train_launches() -> dict:
    return {name: k.launches for name, k in train_kernels().items()}


def zero_train_launches() -> None:
    for k in train_kernels().values():
        k.launches = 0


def n_param_leaves() -> int:
    """Leaves of the decoder's params (one adamw launch each per update),
    counted on a tiny CPU instance: the count does not depend on the
    widths."""
    from nos_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig(vocab=8, d_model=8, n_layers=1, n_heads=1,
                                d_ff=8, max_seq=8, dtype=torch.float32)
    return len(tfm.param_leaves(tfm.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")))


# the adamw check's update: hyper-parameters as the trainer's defaults,
# an update count past the first
ADAMW = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01)
ADAMW_COUNT = 3


def check_adamw(seed: int, device, flush) -> dict:
    """The adamw kernel against its plain version on the training path's
    leaves (bench.py's 1.1 B model in bf16, and f32 copies of the first
    two layers of three stacked leaves):
    params and both moments bit-identical after one update from the same
    state. Times one update of every bf16 leaf: kernel, plain version,
    and one library call (``torch.optim.AdamW(fused=True).step``), and
    the bytes bound (p, g, mu, nu read, p, mu, nu written once)."""
    from nos_tpu_torch.models import transformer as tfm
    from nos_tpu_torch.ops import _kernels
    from nos_tpu_torch.train.optim import adamw_consts, \
        adamw_update_reference

    cfg = tfm.TransformerConfig(**TRAIN, dtype=torch.bfloat16)
    gen = torch.Generator(device).manual_seed(seed + 3)
    leaves = tfm.param_leaves(tfm.init_params(cfg, gen, device))

    def like(p, scale, square=False):
        t = torch.randn(p.shape, generator=gen, device=device) * scale
        return (t * t if square else t).to(p.dtype)

    def state(leaf_list):
        return [(p, like(p, 1e-2), like(p, 1e-3), like(p, 1e-2, True))
                for p in leaf_list]

    bf16 = state(leaves)
    # f32 leaves at the norms' and one projection's shapes
    f32 = state([p[:2].float().contiguous() for p in leaves
                 if p.dim() >= 2][:3])
    worst = 0.0
    compared = 0
    for group in (bf16, f32):
        consts = adamw_consts(group[0][0].dtype, ADAMW_COUNT, ADAMW["lr"],
                              b1=ADAMW["b1"], b2=ADAMW["b2"],
                              eps=ADAMW["eps"],
                              weight_decay=ADAMW["weight_decay"])
        for p, g, mu, nu in group:
            kern = [t.clone() for t in (p, mu, nu)]
            plain = [t.clone() for t in (p, mu, nu)]
            _kernels.adamw.launch(kern[0], g, kern[1], kern[2], consts)
            adamw_update_reference(plain[0], g, plain[1], plain[2], consts)
            for a, b in zip(kern, plain):
                worst = max(worst, float((a.float() - b.float()).abs()
                                         .max()))
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"adamw kernel differs from its plain version on a "
                        f"{p.dtype} leaf {tuple(p.shape)}")
                compared += 1
            del kern, plain
    consts = adamw_consts(torch.bfloat16, ADAMW_COUNT, ADAMW["lr"],
                          b1=ADAMW["b1"], b2=ADAMW["b2"], eps=ADAMW["eps"],
                          weight_decay=ADAMW["weight_decay"])
    ms = cuda_ms(lambda: [_kernels.adamw.launch(p, g, mu, nu, consts)
                          for p, g, mu, nu in bf16], 10, flush)
    plain_ms = cuda_ms(lambda: [adamw_update_reference(p, g, mu, nu, consts)
                                for p, g, mu, nu in bf16], 3, flush)
    params = [p for p, *_ in bf16]
    for p, g, *_ in bf16:
        p.grad = g
    lib = torch.optim.AdamW(params, lr=ADAMW["lr"],
                            betas=(ADAMW["b1"], ADAMW["b2"]),
                            eps=ADAMW["eps"],
                            weight_decay=ADAMW["weight_decay"], fused=True)
    library_ms = cuda_ms(lib.step, 10, flush)
    n = sum(p.numel() for p in params)
    bound_ms = 7 * 2 * n / HBM_BYTES_PER_S * 1e3
    row = {"phase": "adamw_vs_plain", "leaves": len(bf16),
           "elements": n, "compared_tensors": compared,
           "bit_identical": True, "max_abs_err": worst, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": "bytes",
           "achieved_gb_per_s": 7 * 2 * n / ms / 1e6}
    emit(row)
    del bf16, f32, params, lib, leaves
    torch.cuda.empty_cache()
    return row


class StepLog(logging.Handler):
    """Collects the trainer's per-step log records: (step, loss, time)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.steps = []

    def emit(self, record):
        if record.msg.startswith("step %d/%d loss"):
            self.steps.append((record.args[0], record.args[2],
                               record.created))


def train_setup(cfg, seed: int, device):
    """What ``train()`` builds before its loop: seeded params as leaves,
    the optimizer chain and the step, for the profiled and f32 runs."""
    from nos_tpu_torch.models import transformer as tfm
    from nos_tpu_torch.train.optim import build_optimizer

    params = tfm.init_params(cfg, torch.Generator(device).manual_seed(seed),
                             device)
    leaves = tfm.param_leaves(params)
    for p in leaves:
        p.requires_grad_()
    opt = build_optimizer(leaves, 3e-4, TRAIN_STEPS)
    return params, tfm.make_train_step(cfg, opt)


def profile_train(seed: int, device) -> dict:
    """Device breakdown of 2 steady training steps at full width under
    torch.profiler: busy = the sum of kernel times; groups: the flash
    forward, the flash backward (preprocess, dK/dV, dQ), matmuls,
    everything else."""
    from torch.profiler import ProfilerActivity, profile
    from nos_tpu_torch.cmd.trainer import TrainerConfig, synthetic_batch
    from nos_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(**TRAIN, dtype=torch.bfloat16)
    params, step = train_setup(cfg, seed, device)
    tcfg = TrainerConfig(**TRAIN, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                         seed=seed)
    batch = synthetic_batch(tcfg, 0, device)
    step(params, batch)
    torch.cuda.synchronize()
    n = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            step(params, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / n
    out = device_breakdown(prof, n, {"flash_fwd": ("flash_fwd",),
                                     "flash_bwd": ("flash_bwd",)})
    out["profiled_ms_per_step"] = wall_ms
    out["device_idle_share"] = 1 - out["device_busy_ms"] / wall_ms
    out["attention_share_of_busy"] = (
        (out["device_ms"]["flash_fwd"] + out["device_ms"]["flash_bwd"])
        / out["device_busy_ms"])
    del params, step, batch
    return out


def f32_parity(seed: int, device) -> dict:
    """2 layers in f32 at the full widths: one step's loss and every
    gradient through the kernel and through NOS_TPU_TORCH_ATTN_IMPL=xla
    (the plain attention under autograd, no kernel launched)."""
    from nos_tpu_torch.cmd.trainer import TrainerConfig, synthetic_batch
    from nos_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig(**dict(TRAIN, n_layers=2),
                                dtype=torch.float32)
    params, _ = train_setup(cfg, seed, device)
    tcfg = TrainerConfig(**TRAIN, batch_size=2, seq_len=TRAIN_SEQ, seed=seed)
    batch = synthetic_batch(tcfg, 0, device)
    leaves = tfm.param_leaves(params)
    runs = {}
    for impl in ("splash", "xla"):
        os.environ["NOS_TPU_TORCH_ATTN_IMPL"] = impl
        zero_train_launches()
        loss = tfm.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
        runs[impl] = (float(loss.detach()), grads, train_launches())
    del os.environ["NOS_TPU_TORCH_ATTN_IMPL"]
    (lk, gk, nk), (lx, gx, nx) = runs["splash"], runs["xla"]
    if nk["flash_attention_fwd"] != 2 * cfg.n_layers or any(nx.values()):
        raise AssertionError(f"launches kernel {nk}, xla {nx}")
    loss_rel = abs(lk - lx) / abs(lx)
    shares = [float((a - b).abs().max() / b.abs().max()) for a, b in
              zip(gk, gx)]
    if not (loss_rel <= TRAIN_LOSS_RTOL and max(shares) <= TRAIN_GRAD_TOL):
        raise AssertionError(
            f"f32 step through the kernel vs plain: loss rel {loss_rel} "
            f"(tol {TRAIN_LOSS_RTOL}), worst grad max|diff|/max|g| "
            f"{max(shares)} (tol {TRAIN_GRAD_TOL})")
    return {"f32_loss_kernel": lk, "f32_loss_plain": lx,
            "f32_loss_rel_diff": loss_rel, "f32_loss_rtol": TRAIN_LOSS_RTOL,
            "f32_worst_grad_rel_diff": max(shares),
            "f32_grad_tol": TRAIN_GRAD_TOL, "f32_grads_compared": len(gk)}


def phase_train(seed: int, card: str) -> dict:
    """(g): ``train()`` at bench.py's widths, bf16, synthetic data, 8
    steps; the flash kernels' launches must be 2 x n_layers x steps
    (forward, re-run by full remat) and n_layers x steps (each backward
    kernel). Then 2 profiled steps, and the f32 2-layer parity. Returns
    the main run's launches."""
    from nos_tpu_torch.cmd.trainer import TrainerConfig, train
    from nos_tpu_torch.models.transformer import TransformerConfig

    device = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log = StepLog()
    tlog = logging.getLogger("nos_tpu_torch.trainer")
    tlog.setLevel(logging.INFO)
    tlog.addHandler(log)
    cfg = TrainerConfig(**TRAIN, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                        steps=TRAIN_STEPS, log_every=1, seed=seed, bf16=True)
    zero_train_launches()                       # the main path's count
    t0 = time.perf_counter()
    final = train(cfg, device=device)
    wall_s = time.perf_counter() - t0
    launches = train_launches()
    tlog.removeHandler(log)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [loss for _, loss, _ in log.steps]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses}: not finite and "
                             f"falling over {TRAIN_STEPS} steps")
    L = TRAIN["n_layers"]
    want = {"flash_attention_fwd": 2 * L * TRAIN_STEPS,
            "flash_attention_bwd_preprocess": L * TRAIN_STEPS,
            "flash_attention_bwd_dkdv": L * TRAIN_STEPS,
            "flash_attention_bwd_dq": L * TRAIN_STEPS,
            "adamw": n_param_leaves() * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"training launches {launches} != {want}")
    times = [t for _, _, t in log.steps]
    step_ms = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
    steady_ms = float(np.median(step_ms[1:]))      # after the first two
    mcfg = TransformerConfig(**TRAIN)
    flops = model_flops_per_step(mcfg, TRAIN_BATCH, TRAIN_SEQ)
    tflops = flops / (steady_ms / 1e3) / 1e12
    row = {"phase": "train_full_width", "card": card, **TRAIN,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "remat": "full", "dtype": "bf16", "losses": losses,
           "final_loss": final, "wall_s": wall_s, "step_ms": step_ms,
           "step_ms_median_steady": steady_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (steady_ms / 1e3),
           "model_tflops_per_step": flops / 1e12,
           "model_tflops_per_s": tflops, "mfu_pct": 100 * tflops * 1e12
           / BF16_FLOPS, "peak_mem_gb": peak_gb, "launches": launches}
    torch.cuda.empty_cache()
    row["profile"] = profile_train(seed, device)
    torch.cuda.empty_cache()
    row.update(f32_parity(seed, device))
    emit(row)
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=PHASES,
                    help="phases to run after (a) and (b), e.g. 'f' while "
                         "iterating on a kernel; only a run of every phase "
                         "prints the kernels line and the ok line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nos_tpu_torch.ops import _kernels

    # (a)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_all = time.perf_counter()
    # (b)
    emit({"phase": "build", "seconds": _kernels.build_all()})
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    paged = phase_kernels(args.seed, device, flush) if "c" in args.phases \
        else {}
    flash = phase_flash(args.seed, device, flush) if "f" in args.phases \
        else {}
    if "d" in args.phases:
        phase_exact_tokens(args.seed, device)
    if "h" in args.phases:
        phase_sampling(args.seed, device)
    served = {}
    if "e" in args.phases:
        paged["launches"], served["greedy"] = phase_full_width(
            args.seed, "bf16", card)
        paged["int8_launches"], _ = phase_full_width(args.seed, "int8", card)
        paged["sampled_launches"], served["sampled"] = phase_full_width(
            args.seed, "bf16", card, sampled=True)
    if "i" in args.phases:
        paged["http_launches"] = phase_http(args.seed, card, served)
    adamw = {}
    if "g" in args.phases:
        launches = phase_train(args.seed, card)
        for name, row in flash.items():
            row["launches"] = launches[name]
        adamw = check_adamw(args.seed, device, flush)
        adamw["launches"] = launches["adamw"]
    del flush
    emit({"phase": "done", "seconds": time.perf_counter() - t_all,
          "card": card})
    if set(PHASES) - set(args.phases):
        return 0
    kernels = [paged]
    for name, row in flash.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": "nos_tpu_torch/csrc/flash_attention.cu",
                        "replaces": "nos_tpu/ops/attention.py:186",
                        "also_replaces": "nos_tpu/ops/attention.py:549",
                        **row})
    kernels.append({"name": "adamw", "route": "cuda",
                    "source": "nos_tpu_torch/csrc/adamw.cu",
                    "replaces": "nos_tpu/train/optim.py:78",
                    "replaces_what": "XLA's fusion of optax.adamw (no "
                                     "Pallas kernel)",
                    **{k: adamw[k] for k in (
                        "launches", "max_abs_err", "ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms")}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
