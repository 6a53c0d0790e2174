#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``nos_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed N]

Phases (each raises on failure; nothing is caught):

a. identify the card (name, power limit) and turn TF32 off;
b. build every CUDA kernel from ``nos_tpu_torch/csrc`` with ``nvcc``;
c. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, under bf16 and f32 compute, each element within
   a pin derived from the rounding each dtype allows; time kernel,
   plain version, a library call and the bytes/operations bound;
d. exact tokens in f32, plain and int8 arenas: the serving engine
   through the kernel commits the same tokens as ``generate_paged``
   through the kernel and through the plain gather formulation;
e. the main path at full width: ``build_engine`` on a Llama-3-8B-shaped
   decoder (GQA 32/8 heads, d_model 4096, d_ff 14336, vocab 128256, 32
   layers, random weights from the seed; max_seq cut to 2048) serves 8
   requests x 32 tokens, with a bf16 and an int8 KV arena; the kernel's
   launch count must equal n_layers x decode ticks.

Prints one JSON line per phase, then the kernels line, then as the last
line ``{"ok": true, "device": {...}}``. Exits non-zero without that line
when there is no CUDA device or when the port is not beside this file.
"""
from __future__ import annotations

import argparse
import json
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each timed
    alone with CUDA events after overwriting a buffer larger than L2,
    so every launch finds the cache cold as a decode step does."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def paged_case(rng, *, b, h, h_kv, d, bs, nb, s, int8, dtype, device):
    """Kernel inputs at the slice's shapes, q in ``dtype``: ragged
    positions, shuffled physical blocks, null tails, and row 0 inactive
    (all-null table)."""
    from nos_tpu_torch.ops.attention import quantize_kv

    nb_phys = 1 + b * nb
    pos = rng.integers(0, nb * bs - s + 1, size=b).astype(np.int32)
    pos[0] = 0
    table = np.zeros((b, nb), np.int32)
    perm = rng.permutation(np.arange(1, nb_phys)).astype(np.int32)
    i = 0
    for row in range(1, b):
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


def paged_bound(case) -> tuple:
    """(ms, "bytes"|"operations"): the least time for this call's work.
    Bytes: each live K/V token (+ its scales) read once, its table
    entries, q and pos read once, out written once. Operations: QK and
    PV over the live tokens, at the bf16 tensor rate."""
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
    flops = 4 * h * s * d * int(tokens.sum())
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


def phase_kernels(seed: int, device, flush) -> dict:
    """(c): the paged kernel against its plain version at the slice's
    shapes, with bf16 and int8 arenas under bf16 compute (the main
    path's) and the same under f32 compute, where only the summation
    order differs from the plain version and a structural slip (a
    dropped block, an off-by-one mask) cannot hide in rounding; returns
    the numbers for the kernels line."""
    from nos_tpu_torch.ops import _kernels
    from nos_tpu_torch.ops.attention import paged_decode_attention_reference

    rng = np.random.default_rng(seed)
    shape = dict(b=8, h=32, h_kv=8, d=128, bs=16, nb=128)
    worst = 0.0
    timed = {}
    for arena, dtype, int8 in (("bf16", torch.bfloat16, False),
                               ("int8", torch.bfloat16, True),
                               ("f32", torch.float32, False),
                               ("int8_f32", torch.float32, True)):
        for s in (1, 4, 256):
            case = paged_case(rng, s=s, int8=int8, dtype=dtype,
                              device=device, **shape)
            out = _kernels.paged_decode.launch(
                case["q"], case["k_arena"], case["v_arena"], case["table"],
                case["pos"], k_scale=case["k_scale"],
                v_scale=case["v_scale"], scale=128 ** -0.5)
            row = {"phase": "kernel_vs_plain", "kernel":
                   "paged_decode_attention", "S": s, "arena": arena,
                   "compute": str(dtype).split(".")[-1], **shape,
                   "live_tokens": int((case["pos"] + s).sum()),
                   **check_kernel(out, case)}
            worst = max(worst, row["max_abs_err"])
            if s == 1 and dtype == torch.bfloat16:
                ref = paged_decode_attention_reference(**case)
                lib = library_call(case)
                lib_err = float((lib().float() - ref.float()).abs().max())
                row.update(
                    ms=cuda_ms(lambda: _kernels.paged_decode.launch(
                        case["q"], case["k_arena"], case["v_arena"],
                        case["table"], case["pos"],
                        k_scale=case["k_scale"], v_scale=case["v_scale"],
                        scale=128 ** -0.5), 100, flush),
                    plain_ms=cuda_ms(
                        lambda: paged_decode_attention_reference(**case),
                        30, flush),
                    library_ms=cuda_ms(lib, 100, flush),
                    library_max_abs_err=lib_err)
                row["bound_ms"], row["bound_by"] = paged_bound(case)
                timed[arena] = row
            emit(row)
            del case, out
    main = timed["bf16"]
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "nos_tpu_torch/csrc/paged_decode_attention.cu",
            "replaces": "nos_tpu/ops/attention.py:430",
            "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "int8_ms": timed["int8"]["ms"],
            "int8_bound_ms": timed["int8"]["bound_ms"]}


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

    cfg = TransformerConfig(vocab=512, d_model=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=512, max_seq=256,
                            dtype=torch.float32)
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
                           device=device)
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


def profile_ticks(eng, prompts, ticks: int = 3) -> dict:
    """Device breakdown of steady decode ticks: serve ``prompts`` again,
    take one warm tick, then profile ``ticks`` engine steps with
    torch.profiler. Device busy = the sum of kernel times; the idle
    share against the profiled wall overstates idleness (the profiler
    slows the host), so the caller also reports it against the
    unprofiled tick. Kernels are grouped as the paged kernel (its
    attention and split-merge launches), matmuls (cuBLAS/CUTLASS names)
    and everything else."""
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        eng.submit(p, ticks + 2)
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
    groups = {"paged_kernel": 0.0, "matmul": 0.0, "other": 0.0}
    kernels = []
    n_kernels = 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us <= 0 or str(getattr(e, "device_type", "")).endswith("CPU"):
            continue
        name = e.key
        low = name.lower()
        if "paged_decode" in low:
            g = "paged_kernel"
        elif any(k in low for k in ("gemm", "gemv", "xmma", "cutlass",
                                    "cublas", "nvjet", "sm90_")):
            g = "matmul"
        else:
            g = "other"
        groups[g] += us / 1e3 / ticks
        n_kernels += e.count
        kernels.append((us / 1e3 / ticks, e.count // ticks, name[:80]))
    busy = sum(groups.values())
    kernels.sort(reverse=True)
    return {"profiled_ms_per_tick": wall_ms,
            "device_busy_ms_per_tick": busy,
            "device_idle_share_profiled": 1 - busy / wall_ms,
            "device_ms_per_tick": groups,
            "kernels_per_tick": n_kernels / ticks,
            "top_kernels": [{"ms": ms, "count": c, "name": n}
                            for ms, c, n in kernels[:8]]}


def phase_full_width(seed: int, kv_dtype: str, card: str) -> int:
    """(e): build_engine at the 8B-class widths, 8 requests x 32 tokens;
    returns the kernel's launches on this main-path run."""
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
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 1025, size=8)
    prompts = [rng.integers(0, FULL["vocab"], size=n).tolist() for n in lens]
    new = 32

    _kernels.paged_decode.launches = 0          # the main path's count
    prefill_ms = []
    rids = []
    for p in prompts:
        t = time.perf_counter()
        rids.append(eng.submit(p, new))          # prefill + first token
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
    probe = decode_probe(eng, snapshot)
    del snapshot
    breakdown = profile_ticks(eng, prompts)
    emit({"phase": "full_width", "kv_dtype": kv_dtype, "card": card,
          **{k: FULL[k] for k in FULL}, "requests": len(prompts),
          "prompt_lens": [int(n) for n in lens], "new_tokens": new,
          "build_s": build_s, "prefill_ms": prefill_ms,
          "prefill_ms_mean": float(np.mean(prefill_ms)),
          "decode_ticks": ticks, "decode_ms_per_tick": decode_s * 1e3 / ticks,
          "decode_tokens": decoded,
          "decode_tokens_per_s": decoded / decode_s,
          "kernel_launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, **probe,
          "device_idle_share": 1 - breakdown["device_busy_ms_per_tick"]
          / (decode_s * 1e3 / ticks),
          "profile": breakdown})
    del eng, served
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
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
    # (c)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
    kernel = phase_kernels(args.seed, device, flush)
    del flush
    # (d)
    phase_exact_tokens(args.seed, device)
    # (e)
    kernel["launches"] = phase_full_width(args.seed, "bf16", card)
    kernel["int8_launches"] = phase_full_width(args.seed, "int8", card)
    emit({"phase": "done", "seconds": time.perf_counter() - t_all,
          "card": card})
    emit({"kernels": [kernel]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
