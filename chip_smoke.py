#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``nos_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed N] [--phases cdefghijklmnopqrs]

Phases (each raises on failure; nothing is caught):

a. identify the card (name, power limit) and turn TF32 off;
b. build every CUDA kernel from ``nos_tpu_torch/csrc`` with ``nvcc``;
c. hold the paged kernel against its plain PyTorch version on the card
   at the main path's shapes (S 1/4/256, bf16 and int8 arenas under bf16
   compute, the same under f32), at full context (every row at 2048
   tokens) and at bs 8 / head_dim 64, each element within a pin derived
   from the rounding each dtype allows, and bit-identical over two
   launches; time kernel (CUDA events, and torch.profiler's kernel
   durations), plain version, a library call and the bytes bound; and
   at one shard's heads under tp = 2 (16 query / 4 kv heads, phase
   (s)'s), bf16 and int8 arenas, timed the same way;
d. exact tokens in f32, plain and int8 arenas: the serving engine
   through the kernel commits the same tokens as ``generate_paged``
   through the kernel and through the plain gather formulation. Every
   decode tick is a CUDA graph replay; the paged kernel counts its own
   launches on the card, the count must be n_layers x T x replays, and
   torch.profiler must see as many paged kernels (the engine captures
   its decode programs before the counted run, here and in (e), (h),
   (j));
e. the main path at full width: ``build_engine`` on a Llama-3-8B-shaped
   decoder (GQA 32/8 heads, d_model 4096, d_ff 14336, vocab 128256, 32
   layers, random weights from the seed; max_seq cut to 2048) serves 8
   requests x 32 tokens, greedy with a bf16 and an int8 KV arena, then
   sampled on the bf16 arena (temperature 0.8, top-k 50, top-p 0.95,
   seeds 0-7, served twice for the same tokens); each run's kernel
   launch count (the kernel's own) must equal n_layers x graph
   replays, and the profiled
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
   same 8B-class decoder (bf16 arena, paged kernel on) served by
   ``ServingLoop`` (restart budget 1, watchdog on) behind
   ``make_http_server`` on 127.0.0.1: phase (e)'s 8 prompts from 8
   concurrent client threads (6 unary, 2 SSE), greedy at 32 new tokens,
   then drained directly under the loop's lock, then sampled at phase
   (e)'s params. Every response equals phase (e)'s tokens for its prompt
   (greedy and sampled) and the direct drain's, and the SSE deltas
   joined equal the unary result. The binary captures each decode
   program at the first tick that needs it, as a user meets it, so the
   kernel's own count of paged launches equals n_layers x (graph
   replays + one warm-up run per capture), and the capture seconds are
   printed beside the TTFT/TPOT quantiles they fall in. /healthz and
   /readyz answer ok, /stats keys are the reference's, /metrics counts 8
   finished requests and 8 x 31 decode tokens, and a request after
   /admin/drain gets 503. Prints TTFT/TPOT p50/p99 from the loop's
   histograms, ms per tick through the loop beside the direct drain,
   the tick phases, the device idle share and paged kernels (n_layers
   per replay) of a profiled stretch of loop ticks, build seconds and
   peak memory. Then the same traffic through a second binary whose
   engine runs ``pipeline_depth`` 2 and ``decode_steps`` 4 (greedy and
   sampled, the same tokens, the launches counted the same way; its
   TTFT and TPOT p50/p99 and capture seconds);
j. pipelined, graph-replayed decode at phase (e)'s width: (depth, T) in
   (1, 1), (2, 1), (2, 4) greedy bf16, (2, 4) sampled bf16 and (2, 4)
   greedy int8, each served by the un-captured program (the same
   engine, every kernel launched from the host) and by the captured one:
   the same tokens, equal to phase (e)'s; paged launches (the kernel's
   own count) n_layers x T x replays, and n_layers x T paged kernels in each profiled replay; per
   engine, one tick replayed from a snapshot is bit-identical to the
   program called directly (logits, tokens, pos, feed tokens, arena).
   Prints ms per tick and per step beside the un-captured program,
   tokens/s, kernels per tick, device busy ms and idle share, capture
   seconds per program, graph-pool and peak memory.
k. the admission path at phase (e)'s width, every engine on one set of
   ``build_engine`` weights: (1) a 1024-token system prompt published
   with ``cache_prefix``, then 8 requests sharing it (32-256-token
   suffixes, greedy, 32 new tokens) on a prefix-cache engine, where each
   hit prefills its suffix in the arena through the paged kernel's S > 1
   window, and on a ``prefix_cache_size=0`` engine: TTFT p50/p99 of both,
   hits, tokens saved, shared blocks while active, the pool balanced
   after, the kernel's own launch count n_layers x (T x replays +
   in-arena windows), the decode graph's scratch untouched; each
   request's window logits against the scratch path's on the same arena
   (the gather formulation) within ``ARENA_LOGIT_TOL``; the same at
   depth 2, T 4 (the same tokens) and on an int8 arena (its windows
   against its scratch path too); the kernel
   alone on one window (B 1, S 256 from pos 1024) against its plain
   version, timed beside it, SDPA and the bound; where one hit
   admission's and one full prefill's time goes (torch.profiler); (2) 2
   active greedy requests forked, at depth 1 and at depth 2, T 4: each
   fork's tokens equal its source's, the copy-on-write copies counted;
   (3) three binaries (ServingLoop +
   make_http_server): 6 clients decode 128 tokens from 64-256-token
   prompts, then 2 send 1536-token prompts, with one-shot prefill,
   ``prefill_chunk`` 256, and 256 under a 256-token ``prefill_budget``:
   the decoders' TPOT p50/p99 (all gaps, and past each one's first),
   the long prompts' TTFT, the loop's tick, the budget counters;
   budgeted tokens equal chunked tokens bit for bit, and so do those of
   a chunked engine at depth 2, T 4 served directly; the cost model's
   host reading of a chunk beside its device busy time (torch.profiler);
   (4) in f32 on phase (d)'s model: prefix hit == fresh prefill, chunked
   == one-shot, budgeted == unbudgeted, through the kernel and the
   gather formulation.
l. the KV payload at phase (e)'s width, every engine on one set of
   ``build_engine`` weights: (1) after 4 ticks of phase (e)'s 8
   requests, one row's newest step replayed through the replay program
   (the tick's width, the other rows on the null block) and through a
   B = 1 ``forward_paged``: whether each rewrites the tick's K/V bytes
   and reproduces its logits bit for bit, with the paged kernel's split
   counts, bf16 and int8 arenas; a recompute resume against an
   undisturbed twin: the replayed output span's K/V must equal the
   twin's bytes, the re-prefilled prompt span's equality and the next
   step's max|dlogit| printed, the eager replay's bytes equal to the
   graph's, ms per replayed token of both; two recompute victims admitted
   another way (phase (k)'s system prompt + 64 tokens through a prefix
   hit's S > 1 window, phase (k.3)'s 1536-token prompt in 256-token
   chunks), bf16 and int8, resumed by repeating their admission's path:
   prompt span, output span, next-step logits and tokens equal to an
   undisturbed twin's, beside the one-shot re-prefill's; (2) phase (e)'s prompts x 64
   tokens on a pool of 88% of the batch's final footprint, kv_swap on
   and off x bf16 and int8 arenas x (depth, T) (1, 1) and (2, 4): at
   least two preemptions each, swap resumes giving the undisturbed
   run's tokens bit for bit, recompute's agreement with them printed,
   the kernel's own launch count n_layers x (T x replays + replayed
   tokens), swap payload bytes, swap-out / swap-in / resume ms; (3)
   ``ServingLoop`` with an engine factory and a ``FaultInjector`` error
   at the 10th tick: every request finishes exactly once with the
   undisturbed tokens (swap capture), the resumed-by-mode counters and
   recovery seconds; (4) a prefill-role and a decode-role replica over
   HTTP on 127.0.0.1: the undisturbed tokens through the handoff, the
   handoff bytes (bf16, int8) and the capture+ship ms per handoff.
m. the rest of the KV payload at phase (e)'s width, on one set of
   ``build_engine`` weights: (1) the reference bench's host-tier section
   (4 zipf-popular 1024-token system prompts, 24 requests of one plus a
   64-token suffix x 32 tokens, ``max_batch`` 2, a one-chain prefix
   cache, a pool of 4 requests' blocks, a host tier that holds every
   chain the trace demotes, 4 GiB): tiered, drop and no-pressure arms in
   int8 and bf16, prefill tokens, TTFT p50/p99, demotes and promotes,
   a chain's copy down and up (ms, GB/s) beside a plain pinned copy of
   the same bytes and the host copies staging makes, the tiered tokens
   equal to the no-pressure arm's; phase (l.2)'s swap points at (1, 1)
   again; (2) two
   replicas over HTTP with one fabric token: B pulls A's chain through
   ``kv_sources`` (4 concurrent requests, one pull), a tokenless offer
   counts ``pull_denied``, another tenant's offer is refused at ingest;
   B's tokens equal A's; pull bytes, fetch and ingest ms, B's TTFT with
   the pull and without; (3) bronze fills 8 slots, two guaranteed gold
   requests arrive after 8 ticks on the injected tenant clock: 2
   reclaims, bronze's 8 token digests equal the undisturbed run's, by
   swap and by recompute; through the binary, bronze over its max is
   served idle and gets 429 ``tenant_quota`` under contention, and
   /stats' chip ledger adds up to its span.
n. the slot-static engine and speculative decoding at phase (e)'s width,
   every engine on the weights of one ``build_engine`` with the
   reference's ``kv_blocks`` 0: (0) the paged kernel at the speculative
   engine's shapes against its plain version (the verify window, B 8, S
   4, heads 32/8, head_dim 128; the draft's step, B 8, S 1, heads 4/4,
   head_dim 64; each in bf16 and int8, each row at its own pos over
   64-1900),
   timed beside the plain version, SDPA and the bound; (1) the
   slot-static engine: phase (e)'s traffic greedy and sampled at (1, 1)
   and (2, 2) (the same tokens at both), ms and kernels a tick, idle
   share and captures beside the paged engine's, tokens against the
   paged engine's and ``generate``'s (two prompts) by the token rule,
   phase (k)'s shared prompt through the prefix LRU (hits, tokens saved,
   TTFT with and without), a supervised restart, and the binary over
   HTTP; (2) ``SpeculativeDecodeServer`` (n_draft 4) on the paged arm
   (bf16, int8) and the slot-static arm, at (1, 1) and (2, 2), with a
   seeded draft (``ServerConfig``'s draft widths) and with draft =
   target: ms a round, tokens a window, acceptance, tokens/s beside the
   plain engine's, greedy tokens against the plain engine's by the token
   rule, the kernel's own launches, counted by shape, equal to ticks x
   T x target layers at the verify window's and ticks x T x n_draft x
   draft layers at the draft step's; on every arm, sampled streams
   reproducible and equal across (1, 1) and (2, 2); a row preempted by swap and by recompute
   with the undisturbed sampled tokens; a fork; a ``ServingLoop`` over
   the paged engine exporting the speculative series. The token rule:
   equal tokens, or a first divergence at a step where the plain run's
   top-2 logit gap (teacher-forced) is under 0.1;
o. the Mixture-of-Experts family at Mixtral-8x7B's widths (vocab 32000,
   d_model 4096, 32/8 heads, d_ff 14336, 8 experts, top-2; 24 of its 32
   layers, so the bf16 experts fit; max_seq 2048), every engine on the
   weights of one ``build_engine`` with ``n_experts`` 8, built with under
   1 GB resident, its gating held to the CPU's bit for bit: phase (e)'s
   traffic greedy on the bf16 arena through the kernel at (depth, T)
   (1, 1) and (2, 2) (the same tokens bit for bit), sampled twice (the
   same tokens), int8 weights (the experts stay bf16) on the int8 arena
   (tokens against the gather formulation's), the slot-static engine
   (tokens against the paged engine's by the token rule, the gap read
   with the engine's routing: the prompt in its bucket, then a token a
   step; a divergence past the gap only after the two runs' traced
   gating first routes apart at a router near-tie, ``ROUTER_TOL``),
   ``SpeculativeDecodeServer`` (n_draft 4) with the seeded draft and
   with draft = target (each verify window against ``forward_with_cache``
   from the engine's own K/V, by the same rule), a swap
   preemption (the undisturbed tokens) and a recompute one (the spans'
   K/V against a twin, as l.1), phase (k)'s shared prefix with and
   without the prefix cache, and 8 concurrent greedy requests through
   the binary over HTTP (the direct drain's tokens); the paged kernel's
   own count held to n_layers x T x replays (or by shape, or with the
   in-arena windows) in every run. Prints ms a tick and tokens/s beside
   the weights' bytes over the HBM rate, kernels a tick, the idle share,
   the tick's device ms by kernel group with the MoE FFN's parts (gating,
   experts, dispatch and combine) timed as CUDA graphs at the tick's
   shape, prefill and TTFT, capture seconds, peak memory, the speculative
   rounds, and the share of routing assignments capacity drops in a
   prefill bucket, a verify window and a decode step. Then in f32 at 2
   layers: the engine's tokens through the kernel equal the gather
   formulation's.
p. the MoE family trained, checkpointed, resumed and served, at
   Mixtral-8x7B-v0.1's widths (1 of its 32 layers, to bound the disk
   writes: three checkpoints of 10.3 GB each; batch 8 x 2048, bf16,
   full remat, adamw, synthetic batches from the seed):
   (1) ``train()`` with ``n_experts`` 8 and ``checkpoint_dir`` on local
   disk takes 8 steps, an asynchronous save at step 4 overlapping steps
   5-8 and the last at step 8; the loss finite and falling, the flash
   forward launched 2 x n_layers x steps times (full remat re-runs it),
   each backward kernel n_layers x steps, adamw once a leaf and step;
   step ms with and without a save in flight, tokens/s, MFU over the
   products the step runs (``moe_step_flops``), peak memory, each save's
   bytes, seconds and host stall; (2) step 8 set aside, the run resumed
   from step 4 in the same directory: steps 5-8's losses equal (1)'s and
   the new step 8 equals the set-aside one in every leaf of params and
   optimizer state, bit for bit; the restore's seconds; then 2 steady
   steps profiled (device busy by kernel group, idle share); (3)
   ``build_engine`` with ``checkpoint_dir`` (paged, 1 + 8 x 128 blocks,
   ``max_batch`` 8): the served params equal (1)'s in process, phase
   (e)'s greedy traffic gives the tokens of an engine on (1)'s params in
   process, the kernel's launches n_layers x T x replays; then a seeded
   draft at ``ServerConfig``'s draft widths saved by the port's
   ``CheckpointManager`` through ``draft_checkpoint_dir``: the
   ``SpeculativeDecodeServer`` built holds the saved draft, its
   launches by shape and its verify windows held as phase (o)'s; load
   seconds, TTFT and TPOT p50; (4) one f32 2-layer MoE train step on
   the card against the same step on the CPU: the routing equal, loss
   and gradients within phase (g)'s f32 tolerances; then the flash
   kernels at (p)'s attention shape (batch 8, 32 query / 8 KV heads, S
   2048, head_dim 128, causal, bf16) against their plain versions,
   timed beside them, SDPA and the bound.
q. the trainer's named remat policies ("dots", "except_mlp",
   "minimal"; phase (g)'s run is "full", run here when (g) is not): (1)
   ``train()`` at (g)'s widths and batch, 8 steps under each; the flash
   forward launched n_layers x steps x 2 under "full" and "dots" and x
   1 under "except_mlp" and "minimal" (its outputs saved by name), each
   backward kernel n_layers x steps, adamw once a leaf and step; step
   ms, tokens/s, MFU, HFU (the model's products plus what the policy's
   recompute re-runs, ``remat_rerun_flops``), peak memory, and 2
   profiled steady steps by kernel group per policy; (2) the step-1
   gradients under each policy against "full"'s from the same params
   and batch, leaf by leaf (bit-equal expected; a differing leaf is
   printed with its largest difference over the leaf's largest value,
   and fails above 1e-3), and the 8 losses of each run against "full"'s
   the same way; (3) peak memory ordered minimal <= except_mlp <= dots
   and full <= except_mlp; (4) phase (p)'s MoE (1 layer, batch 8 x
   2048) 4 steps under each of the four policies, no checkpoint: the
   launches, step ms, MFU, HFU, peak, and every gating call routing
   exactly as under "full"; (5) ``train()`` with ``profile_dir`` under
   a temporary directory (steps 1-2 of 3 traced; a 2-layer model with
   head_dim 128): the Chrome trace names the flash kernels; (6) the
   trainer binary's ``main()`` with ``metrics_port`` on a free port:
   /metrics shows ``nos_tpu_train_steps_total`` up by the steps run and
   /healthz answers 200 while it trains. "dots" must peak below
   27.05 GB, what it peaked at while it kept the down product's output
   (C.18).
r. the trainer's lifecycle notice watcher at (g)'s widths and batch:
   the port's ``ApiHttpServer`` on 127.0.0.1 serves the pod's ``Node``,
   and the trainer binary's ``main()`` trains with ``node_name`` and
   ``lifecycle_api`` pointing at it and ``checkpoint_dir`` on local disk;
   a preemption notice stamped on the node after step 4's loss sets the
   watcher's stop event (ms from the notice), the step in flight is
   banked by a synchronous save (seconds from the notice, beside the
   ~30 s spot grace), and ``main()`` returns (exit code 0); ``main()``
   then resumes from that step to step 8, and an uninterrupted run of 8
   steps has the same 8 losses (and (g)'s, when (g) ran) and the same
   step-8 params and optimizer state in every leaf, bit for bit (the
   two step-8 states are compared in host memory: the phase writes one
   checkpoint); the training kernels' launches held in each run.
s. tensor-parallel serving at phase (e)'s widths, tp = 2, both shards on
   the one card (``TpMesh([cuda:0, cuda:0])``; ``build_engine`` takes
   tp from the visible cards): phase (e)'s traffic greedy on the bf16
   and int8 arenas and sampled on the bf16 arena through the paged
   engine, and greedy on the slot-static engine, each against the
   tp = 1 engine on the same weights by the token rule (sampled: the
   draw's perturbed scores within the rule's tolerance over the
   temperature, or the truncation's edge); the paged kernel's own
   launches twice tp = 1's, all at (S 1, head_dim 128), n_layers x 2 x
   ticks; a tp = 1 prefill-role engine's handoff adopted by a tp = 2
   decode-role engine, its K/V read back from the shards byte for
   byte, its tokens by the token rule; ms a tick and peak memory beside
   tp = 1's, captured and eager (a tp = 2 engine runs eagerly): what one
   card computing both shards costs, not a speed.

Prints one JSON line per phase, then the kernels line, then as the last
line ``{"ok": true, "device": {...}}``. Exits non-zero without that line
when there is no CUDA device or when the port is not beside this file.
"""
from __future__ import annotations

import argparse
import faulthandler
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
PHASES = "cdefghijklmnopqrs"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# seconds after which a run is taken to hang (see ``main``)
HANG_S = 1100
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
               full=False, pos=None):
    """Kernel inputs, q in ``dtype``: ragged positions, shuffled
    physical blocks, null tails, and row 0 inactive (all-null table);
    with ``full``, every row's window ends at its table's last slot;
    with ``pos``, every row live at the positions given."""
    from nos_tpu_torch.ops.attention import quantize_kv

    nb_phys = 1 + b * nb
    live = full or pos is not None
    if pos is not None:
        pos = np.asarray(pos, np.int32)
    else:
        pos = rng.integers(0, nb * bs - s + 1, size=b).astype(np.int32)
        pos[0] = 0
    if full:
        pos[:] = nb * bs - s
    table = np.zeros((b, nb), np.int32)
    perm = rng.permutation(np.arange(1, nb_phys)).astype(np.int32)
    i = 0
    for row in range(0 if live else 1, b):
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
    once, out written once. Operations: QK and PV over the keys each
    query row attends (causal: row i of a window at pos sees pos+i+1)."""
    q, ka = case["q"], case["k_arena"]
    b, h, s, d = q.shape
    h_kv, bs = ka.shape[1], ka.shape[2]
    cap = case["table"].shape[1] * bs
    pos = case["pos"].cpu().numpy().astype(np.int64)
    tokens = np.minimum(pos + s, cap)
    attended = np.minimum(pos[:, None] + np.arange(1, s + 1)[None], cap)
    per_tok = h_kv * d * ka.element_size() * 2
    if case["k_scale"] is not None:
        per_tok += h_kv * 4 * 2
    nbytes = (int(tokens.sum()) * per_tok
              + int(np.ceil(tokens / bs).sum()) * 4 + b * 4
              + 2 * q.numel() * q.element_size())
    return nbytes, 4 * h * d * int(attended.sum())


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
# phase (s)'s shape: one shard's heads of the serving slice at tp = 2
PAGED_TP2 = dict(PAGED, h=16, h_kv=4)


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
               False),
              ("tp_shard", PAGED_TP2, "bf16", torch.bfloat16, False, 1,
               False),
              ("tp_shard", PAGED_TP2, "int8", torch.bfloat16, True, 1,
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
        if s == 1 and dtype == torch.bfloat16 and shape in (PAGED,
                                                            PAGED_TP2):
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
            "full_context_int8_bound_ms": fc8["bound_ms"],
            "tp_shard": {arena: timed[("tp_shard", arena)]
                         for arena in ("bf16", "int8")}}


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
        eng = DecodeServer(params, cfg, max_batch=4, kv_block_size=16,
                           kv_blocks=1 + 4 * 16, kv_dtype=kv_dtype,
                           device=device, paged_impl="kernel")
        assert eng.paged_kernel == "kernel", eng.paged_kernel
        eng.capture_programs()
        _kernels.paged_decode.launches = 0      # the main path's count

        def run():
            rids = [eng.submit(p, new) for p in prompts]
            return rids, eng.drain()

        (rids, served), seen = paged_kernels_seen(run)
        launches = _kernels.paged_decode.launches
        # every tick a graph replay of one paged launch per layer
        want = cfg.n_layers * eng.decode_steps * eng.ticks_dispatched
        if not launches == want == seen:
            raise AssertionError(
                f"paged launches {launches}, profiled {seen}, want n_layers "
                f"x T x ticks = {want}")
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
              "engine_launches": launches, "profiled_paged_kernels": seen,
              "graph_replays": eng.ticks_dispatched})


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

    def serve(impl, requests, count=False):
        eng = engine(impl)
        eng.capture_programs()
        if count:
            _kernels.paged_decode.launches = 0  # the main path's count

        def run():
            rids = [eng.submit(p, new, **kw) for p, new, kw in requests]
            out = eng.drain()
            return [out[r] for r in rids]

        out, seen = paged_kernels_seen(run) if count else (run(), None)
        return out, eng.ticks_dispatched, seen

    kernel, ticks, seen = serve("kernel", reqs, count=True)
    launches = _kernels.paged_decode.launches
    if not launches == cfg.n_layers * ticks == seen:
        raise AssertionError(f"sampled engine: kernel launches {launches}, "
                             f"profiled {seen}, want n_layers x ticks "
                             f"{cfg.n_layers} x {ticks}")
    gather, _, _ = serve("xla", reqs)
    if kernel != gather:
        raise AssertionError(
            f"sampled streams through the kernel {kernel} differ from the "
            f"gather formulation's {gather}")
    again, _, _ = serve("kernel", reqs)
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
          "engine_launches": launches, "profiled_paged_kernels": seen,
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


def paged_kernels_seen(fn) -> tuple:
    """(fn's result, paged_decode kernels the card ran during it) from
    torch.profiler: the kernels a graph replay launches included."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if device_us(e) > 0 and "paged_decode" in e.key.lower())
    return out, n


def profile_ticks(eng, prompts, ticks: int = 3, sampling=None) -> dict:
    """Device breakdown of steady decode ticks: serve ``prompts`` again
    (with ``sampling[i]``'s params when given), fill the engine's window,
    let the card finish what is queued, then profile ``ticks`` engine
    steps with torch.profiler; each dispatches one tick (one graph
    replay of T steps), and the readings are per dispatched tick. Device
    busy = the sum of kernel times; the idle share against the profiled
    wall overstates idleness (the profiler slows the host), so the
    caller also reports it against the unprofiled tick. Kernels are
    grouped as the paged kernel (one launch per layer and step), matmuls
    (cuBLAS/CUTLASS names) and everything else."""
    from torch.profiler import ProfilerActivity, profile

    new = (ticks + eng.pipeline_depth + 2) * eng.decode_steps
    for i, p in enumerate(prompts):
        eng.submit(p, new, **(sampling[i] if sampling else {}))
    eng.step()
    torch.cuda.synchronize()
    k0 = eng.ticks_dispatched
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    dispatched = eng.ticks_dispatched - k0
    eng.drain()
    out = device_breakdown(prof, dispatched,
                           {"paged_kernel": ("paged_decode",)})
    busy = out["device_busy_ms"]
    return {"profiled_ticks": dispatched,
            "profiled_ms_per_tick": wall_ms / dispatched,
            "device_busy_ms_per_tick": busy,
            "device_idle_share_profiled": 1 - busy * dispatched / wall_ms,
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


def full_width_prompts(seed: int, vocab: int = FULL["vocab"]) -> list:
    """Phase (e)'s 8 prompts, 64-1024 tokens, from the seed."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 1025, size=8)
    return [rng.integers(0, vocab, size=n).tolist() for n in lens]


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
    capture_s = eng.capture_programs()

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
    ticks = eng.ticks_dispatched
    decoded = eng.tokens_emitted                # before probe and profile

    for rid, p in zip(rids, prompts):
        got = served[rid][len(p):]
        if len(got) != new or served[rid][:len(p)] != p:
            raise AssertionError(f"request {rid}: {len(got)} tokens")
    # every tick one graph replay of one paged launch per layer; the
    # profile below shows the card running them
    if launches != FULL["n_layers"] * ticks:
        raise AssertionError(
            f"kernel launches {launches} != n_layers x graph replays "
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
          "kernel_launches": launches, "graph_replays": ticks,
          "capture_s": capture_s,
          "graph_pool_gb": {("sampled" if k else "greedy"): g.pool_bytes / 1e9
                            for k, g in eng._graphs.items()},
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
    """(status, body bytes) of a GET (``body`` None), a POST of raw
    bytes, or a JSON POST, error statuses included."""
    import urllib.error
    import urllib.request

    raw = isinstance(body, bytes)
    req = urllib.request.Request(
        url + path, data=body if raw or body is None
        else json.dumps(body).encode(),
        headers={"Content-Type": "application/octet-stream" if raw
                 else "application/json"},
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
    loop ticks with all 8 slots decoding (prefill excluded). ``new``
    must keep them decoding past the profiler's start."""
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
    # the profiler starts and stops while no thread can launch: a graph
    # replay on the ticker racing the profiler's stop deadlocked inside
    # both on the H100 (every launch of the loop's threads is made under
    # its lock)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with loop._work:
        prof.start()
        ticks0 = loop.m_ticks.value()
        replays0 = eng.ticks_dispatched
        t = time.perf_counter()
    try:
        while loop.m_ticks.value() < ticks0 + 6:
            if time.perf_counter() - t > 60:
                raise AssertionError("the loop stopped ticking while "
                                     "profiled")
            time.sleep(0.002)
    finally:
        with loop._work:
            ticks = loop.m_ticks.value() - ticks0
            replays = eng.ticks_dispatched - replays0
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
            prof.stop()
    for th in threads:
        th.join(timeout=300)
    out = device_breakdown(prof, 1, {"paged_kernel": ("paged_decode",)})
    busy = out["device_busy_ms"]
    paged = out["group_kernels_per_run"]["paged_kernel"]
    # every replay dispatched while the profiler ran finished before it
    # stopped; the ticks already in flight at its start may show some of
    # their kernels too
    want = FULL["n_layers"] * eng.decode_steps
    if not want * replays <= paged <= want * (replays
                                              + eng.pipeline_depth):
        raise AssertionError(f"profiled paged kernels {paged} over "
                             f"{replays} replays, want n_layers x T = "
                             f"{want} each")
    # the device's work per replay dispatched in the window (a loop
    # tick finished in it may have been dispatched before it)
    return {"profiled_loop_ticks": ticks,
            "profiled_wall_ms_per_tick": wall_ms / ticks,
            "device_busy_ms_per_tick": busy / replays,
            "device_idle_share": 1 - busy / wall_ms,
            "kernels_per_tick": out["kernels_per_run"] / replays,
            "profiled_replays": replays, "paged_kernels_profiled": paged}


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
    L = FULL["n_layers"]

    # the binary captures each decode program at the first tick that
    # needs it, as a user meets it: the greedy pass below pays the greedy
    # capture and the sampled pass the sampled one
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

        # (the loop drains the engine's compile_events into its
        # histogram, so captures are read from the running totals)
        replays0, compiles0, capture0 = (eng.ticks_dispatched,
                                         eng.compiles, eng.compile_s)
        _kernels.paged_decode.launches = 0      # the main path's count
        seqs, deltas, wall = http_pass(url, prompts, new, greedy)
        launches = _kernels.paged_decode.launches
        ticks = loop.m_ticks.value() - ticks0
        replays = eng.ticks_dispatched - replays0
        captures = eng.compiles - compiles0
        capture_s = {"greedy": eng.compile_s - capture0}
        q = loop_quantiles(loop, {"ttft": ttft_at, "tpot": tpot_at})

        # the direct drain on this engine, the loop's ticker parked on
        # its lock: the reference tokens of this call and its ms per tick
        with loop._work:
            rids = [eng.submit(p, new) for p in prompts]
            torch.cuda.synchronize()
            ticks1 = eng.ticks
            t = time.perf_counter()
            direct = eng.drain()
            torch.cuda.synchronize()
            direct_ms = (time.perf_counter() - t) * 1e3 / (eng.ticks
                                                          - ticks1)
        direct = [direct[r] for r in rids]
        if "greedy" in served and direct != served["greedy"]:
            raise AssertionError("direct drain != phase (e)'s greedy tokens")
        if seqs != direct:
            bad = [i for i, (a, b) in enumerate(zip(seqs, direct)) if a != b]
            raise AssertionError(f"HTTP greedy tokens differ from the "
                                 f"direct drain for prompts {bad}")
        for i, d in enumerate(deltas):
            if d is not None and prompts[i] + [t for x in d for t in x] \
                    != direct[i]:
                raise AssertionError(f"SSE deltas of prompt {i}")
        # the kernel's own count: one launch per layer in every replay,
        # and in the warm-up run before each capture
        if captures != 1 or launches != L * (replays + captures):
            raise AssertionError(
                f"paged launches {launches} != n_layers x (graph replays + "
                f"captures) = {L} x ({replays} + {captures})")
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

        at = {"ttft": loop.h_ttft.num_samples(),
              "tpot": loop.h_tpot.num_samples()}
        compiles0, capture0 = eng.compiles, eng.compile_s
        sampled, _, sampled_wall = http_pass(url, prompts, new, SAMPLED)
        capture_s["sampled"] = eng.compile_s - capture0
        q_sampled = loop_quantiles(loop, at)
        if eng.compiles - compiles0 != 1:
            raise AssertionError(f"the sampled pass captured "
                                 f"{eng.compiles - compiles0} programs, "
                                 f"not 1")
        if "sampled" in served and sampled != served["sampled"]:
            bad = [i for i, (a, b) in enumerate(zip(sampled,
                                                    served["sampled"]))
                   if a != b]
            raise AssertionError(f"HTTP sampled tokens differ from phase "
                                 f"(e)'s for prompts {bad}")
        prof = profile_loop_ticks(loop, url, prompts, 256)
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
    # the loop and its threads hold the engine in reference cycles
    del eng, loop, httpd
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    pipelined = http_pipelined(cfg, prompts, new, direct, served)
    total = sum(phases.values())
    emit({"phase": "http", "card": card, "requests": len(prompts),
          "unary": len(prompts) - 2, "sse": 2, "new_tokens": new,
          "build_s": build_s, "loop_ticks": ticks, "graph_replays": replays,
          "kernel_launches": launches, "http_wall_s": wall,
          "capture_s": capture_s,
          "sampled_http_wall_s": sampled_wall,
          "loop_ms_per_tick": loop_tick_ms,
          "direct_ms_per_tick": direct_ms, **q,
          "sampled_pass": q_sampled,
          "tick_phase_share": {k: v / total for k, v in phases.items()},
          "tick_phase_seconds": phases,
          "tokens_sha256": token_digest(seqs),
          "sampled_tokens_sha256": token_digest(sampled),
          "compared_with_phase_e": sorted(served),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          **prof, "consumers": cost, "pipelined": pipelined})
    return launches


def loop_quantiles(loop, at: dict) -> dict:
    """TTFT and TPOT p50/p99 in ms from the loop's histograms, over the
    samples taken since ``at`` ({name: sample count})."""
    q = {}
    for name, h in (("ttft", loop.h_ttft), ("tpot", loop.h_tpot)):
        for p in (0.5, 0.99):
            q[f"{name}_p{int(p * 100)}_ms"] = h.quantile(p, at[name]) * 1e3
    return q


def http_pipelined(cfg, prompts, new: int, direct, served) -> dict:
    """Phase (i)'s traffic through the binary again, on an engine built
    with ``pipeline_depth`` 2 and ``decode_steps`` 4: greedy and sampled
    passes give phase (e)'s tokens (greedy: this phase's direct drain's),
    SSE deltas joined included, and the paged launches equal n_layers x
    T x graph replays. Returns TTFT/TPOT p50/p99 and ms per replay."""
    import dataclasses
    import threading

    from nos_tpu_torch.cmd.server import (
        ServingLoop, build_engine, make_http_server,
    )
    from nos_tpu_torch.ops import _kernels
    from nos_tpu_torch.utils.metrics import default_registry

    pcfg = dataclasses.replace(cfg, pipeline_depth=2, decode_steps=4)
    eng = build_engine(pcfg)
    # the loop's histograms live in the process registry, where the first
    # loop of this phase turned their sample retention on; a new loop
    # registers them with it off, as production code does
    reg = default_registry()
    for name in ("nos_tpu_serve_ttft_seconds", "nos_tpu_serve_tpot_seconds"):
        reg.get(name).track_samples = False
    loop = ServingLoop(eng, restart_budget=0, device_stats_interval_s=10.0)
    for h in (loop.h_ttft, loop.h_tpot):
        h.enable_sample_tracking()
    httpd = make_http_server(pcfg, loop, host="127.0.0.1")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        at = {"ttft": loop.h_ttft.num_samples(),
              "tpot": loop.h_tpot.num_samples()}
        replays0, n0, s0 = eng.ticks_dispatched, *loop.h_tick.observations()
        _kernels.paged_decode.launches = 0      # the main path's count
        seqs, deltas, wall = http_pass(url, prompts, new, [{}] * len(prompts))
        launches = _kernels.paged_decode.launches
        replays = eng.ticks_dispatched - replays0
        captures, capture_s = eng.compiles, {"greedy": eng.compile_s}
        n1, s1 = loop.h_tick.observations()
        q = loop_quantiles(loop, at)
        if seqs != direct:
            raise AssertionError("pipelined HTTP greedy tokens differ from "
                                 "the direct drain")
        for i, d in enumerate(deltas):
            if d is not None and prompts[i] + [t for x in d for t in x] \
                    != direct[i]:
                raise AssertionError(f"pipelined SSE deltas of prompt {i}")
        # the kernel's own count: T launches per layer in every replay,
        # and in the warm-up run before the greedy capture
        want = FULL["n_layers"] * pcfg.decode_steps * (replays + 1)
        if captures != 1 or launches != want:
            raise AssertionError(f"pipelined paged launches {launches} != "
                                 f"n_layers x T x (replays + 1 capture) = "
                                 f"{want} ({captures} captures)")
        at = {"ttft": loop.h_ttft.num_samples(),
              "tpot": loop.h_tpot.num_samples()}
        sampled, _, _ = http_pass(url, prompts, new, SAMPLED)
        q_sampled = loop_quantiles(loop, at)
        capture_s["sampled"] = eng.compile_s - capture_s["greedy"]
        if eng.compiles != 2:
            raise AssertionError(f"{eng.compiles} captures, not 2")
        if "sampled" in served and sampled != served["sampled"]:
            raise AssertionError("pipelined HTTP sampled tokens differ from "
                                 "phase (e)'s")
        sse_frames = [len(d) for d in deltas if d is not None]
    finally:
        httpd.shutdown()
        loop.shutdown()
        httpd.server_close()
    out = {"pipeline_depth": 2, "decode_steps": 4, "http_wall_s": wall,
           "graph_replays": replays, "kernel_launches": launches,
           "loop_ms_per_tick": (s1 - s0) * 1e3 / (n1 - n0), **q,
           "sse_frames": sse_frames,
           "capture_s": capture_s,
           "sampled_pass": q_sampled,
           "tokens_sha256": token_digest(seqs),
           "sampled_tokens_sha256": token_digest(sampled)}
    del eng, loop, httpd
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return out


# phase (j)'s points: (kv_dtype, sampled, pipeline_depth, decode_steps)
PIPELINE_POINTS = [("bf16", False, 1, 1), ("bf16", False, 2, 1),
                   ("bf16", False, 2, 4), ("bf16", True, 2, 4),
                   ("int8", False, 2, 4)]


def timed_drain(eng, prompts, new: int, sampling) -> tuple:
    """Submit every prompt (prefill), then drain on the host clock:
    (sequences, decode seconds, ticks dispatched, decode tokens)."""
    rids = [eng.submit(p, new, **kw) for p, kw in zip(prompts, sampling)]
    torch.cuda.synchronize()
    k0, n0 = eng.ticks_dispatched, eng.tokens_emitted
    t = time.perf_counter()
    out = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return ([out[r] for r in rids], wall, eng.ticks_dispatched - k0,
            eng.tokens_emitted - n0)


def replay_vs_direct(eng, prompts, sampling) -> dict:
    """One tick from a snapshot (the prompts prefilled, every slot
    decoding): the captured program replayed, then, from the same
    snapshot, the same program called directly on the card. Logits, the
    T steps' tokens, pos, the feed tokens and the arena must be
    bit-identical. The snapshot is restored after, and the requests
    drained."""
    sampled = bool(sampling[0])
    for p, kw in zip(prompts, sampling):
        eng.submit(p, 8 * eng.decode_steps, **kw)
    eng._set_keep(tuple(sorted(eng._active)))
    bufs = dict(eng.cache, last=eng._last, toks=eng._toks)
    snap = {k: v.clone() for k, v in bufs.items()}

    def restore():
        for k, v in bufs.items():
            v.copy_(snap[k])

    runs = []
    for fn in (eng._launch, eng._decode_program):
        restore()
        logits = fn(sampled).clone()
        runs.append((logits, {k: v.clone() for k, v in bufs.items()}))
    restore()
    torch.cuda.synchronize()
    (lr, br), (ld, bd) = runs
    same = {k: bool(torch.equal(br[k], bd[k])) for k in bufs}
    same["logits"] = bool(torch.equal(lr, ld))
    if not all(same.values()):
        raise AssertionError(f"replayed tick != direct program: {same}")
    eng.drain()
    return {"replay_bit_identical": same,
            "replay_logits_max_abs_diff": float((lr - ld).abs().max())}


def phase_pipeline(seed: int, card: str, served: dict) -> list:
    """(j): pipelined, graph-replayed decode at phase (e)'s width. For
    each ``PIPELINE_POINTS`` point, the 8 prompts x 32 tokens through the
    un-captured program (the same engine, each tick's kernels launched
    from the host) and then through the captured one; both give the same
    tokens, equal to phase (e)'s when it ran in this call; the paged
    launches of the captured run equal n_layers x T x graph replays, and
    the profiled ticks show n_layers x T paged kernels each. Per engine,
    one replayed tick against the direct call (bit-identical). Returns
    the point rows."""
    import dataclasses
    import gc

    from nos_tpu_torch.cmd.server import ServerConfig, build_engine
    from nos_tpu_torch.models.serving import uncaptured
    from nos_tpu_torch.ops import _kernels

    prompts = full_width_prompts(seed)
    new = 32
    L = FULL["n_layers"]
    base = ServerConfig(bf16=True, kv_blocks=1 + 8 * 128, kv_block_size=16,
                        max_batch=8, paged_kernel="on", seed=seed, **FULL)
    rows = []
    eng = key = None
    for kv_dtype, sampled, depth, steps in PIPELINE_POINTS:
        probes = None
        if key != (kv_dtype, steps):
            del eng
            gc.collect()
            torch.cuda.empty_cache()
            key = (kv_dtype, steps)
            eng = build_engine(dataclasses.replace(
                base, kv_dtype=kv_dtype, decode_steps=steps))
            capture_s = eng.capture_programs()
            probes = {("sampled" if m else "greedy"): replay_vs_direct(
                eng, prompts, SAMPLED if m else [{}] * len(prompts))
                for m in (False, True)}
            torch.cuda.reset_peak_memory_stats()
        eng.pipeline_depth = depth
        sampling = SAMPLED if sampled else [{}] * len(prompts)
        with uncaptured(eng):
            eager, eager_s, eager_ticks, _ = timed_drain(eng, prompts, new,
                                                         sampling)
        _kernels.paged_decode.launches = 0      # the main path's count
        seqs, wall, ticks, decoded = timed_drain(eng, prompts, new, sampling)
        launches = _kernels.paged_decode.launches
        if seqs != eager:
            raise AssertionError(f"{key} depth {depth}: captured tokens != "
                                 f"the un-captured program's")
        ref = served.get(("int8_" if kv_dtype == "int8" else "")
                         + ("sampled" if sampled else "greedy"))
        if ref is not None and seqs != ref:
            raise AssertionError(f"{key} depth {depth}: tokens != phase "
                                 f"(e)'s")
        if launches != L * steps * ticks:
            raise AssertionError(f"paged launches {launches} != n_layers x "
                                 f"T x replays = {L * steps * ticks}")
        prof = profile_ticks(eng, prompts, sampling=sampling if sampled
                             else None)
        if prof["paged_kernels_per_tick"] != L * steps:
            raise AssertionError(f"profiled paged kernels per replay "
                                 f"{prof['paged_kernels_per_tick']} != "
                                 f"n_layers x T = {L * steps}")
        ms = wall * 1e3 / ticks
        row = {"phase": "pipeline", "card": card, "kv_dtype": kv_dtype,
               "mode": "sampled" if sampled else "greedy",
               "pipeline_depth": depth, "decode_steps": steps,
               "ticks": ticks, "ms_per_tick": ms,
               "ms_per_step": ms / steps,
               "tokens_per_s": decoded / wall,
               "uncaptured_ticks": eager_ticks,
               "uncaptured_ms_per_tick": eager_s * 1e3 / eager_ticks,
               "uncaptured_ms_per_step": eager_s * 1e3 / eager_ticks / steps,
               "speedup_vs_uncaptured": eager_s / wall,
               "kernel_launches": launches,
               "kernels_per_tick": prof["kernels_per_tick"],
               "device_busy_ms_per_tick": prof["device_busy_ms_per_tick"],
               "device_idle_share": 1 - prof["device_busy_ms_per_tick"] / ms,
               "device_idle_share_profiled":
                   prof["device_idle_share_profiled"],
               "capture_s": capture_s,
               "graph_pool_gb": {("sampled" if k else "greedy"):
                                 g.pool_bytes / 1e9
                                 for k, g in eng._graphs.items()},
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "tokens_sha256": token_digest(seqs),
               "equal_phase_e": ref is not None, "profile": prof}
        if probes is not None:
            row["replay_vs_direct"] = probes
        rows.append(row)
        emit(row)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# phase (k)'s traffic: a 1024-token system prompt (64 blocks of 16) that
# chat and agent front-ends send with every request, then 8 requests
# sharing it, each with its own 32-256-token suffix, greedy, 32 new tokens
PREFIX_LEN = 1024
PREFIX_NEW = 32
# the in-arena windows against the scratch path's on the same arena
# bits. bf16: the same two attention formulations (kernel, plain) over
# the same 32 layers as phase (e)'s decode probe, whose tolerance (0.15,
# 1.5x the largest difference read at these widths) this holds to; the
# 8 windows read 0.074-0.098 on the H100. int8: the window attends over
# its own suffix's K/V quantized in the arena, the scratch path over
# them in bf16 (the reference's asymmetry, ROADMAP C.7); its 8 windows
# read 0.078-0.102 on the H100 at this seed, and 0.15 is 1.48x the
# largest
ARENA_LOGIT_TOL = 0.15


def prefix_traffic(seed: int, vocab: int = FULL["vocab"]) -> tuple:
    """(system prompt, 8 suffixes) from the seed."""
    rng = np.random.default_rng(seed + 101)
    system = rng.integers(0, vocab, size=PREFIX_LEN).tolist()
    lens = rng.integers(32, 257, size=8)
    return system, [rng.integers(0, vocab, size=n).tolist() for n in lens]


def first_logits(eng) -> list:
    """Record the last-position logits each admission picks its first
    token from (wraps the engine's admission tail)."""
    seen = []
    tail = eng._finish_prefill

    def spy(req, row, step, **kw):
        seen.append(step.float().clone())
        return tail(req, row, step, **kw)

    eng._finish_prefill = spy
    return seen


def prefix_pass(eng, system, suffixes, L: int) -> dict:
    """Phase (k)'s traffic on ``eng`` (programs captured up front): the
    system prompt with ``cache_prefix``, then the 8 shared requests at
    once, twice; the second pass is measured (the first meets each
    window width and bucket for the first time). Checks the kernel's own
    launch count (n_layers x (T x replays + in-arena windows)), the
    shared blocks while active, and the pool after the drain; returns
    the sequences, TTFTs and counters."""
    eng.capture_programs()
    eng.submit(system, PREFIX_NEW, cache_prefix=True)
    eng.drain()
    cold = shared_pass(eng, system, suffixes, L)
    out = shared_pass(eng, system, suffixes, L)
    if out["seqs"] != cold["seqs"]:
        raise AssertionError("the second pass's tokens differ")
    out["cold_ttft_p50_ms"] = cold["ttft_p50_ms"]
    return out


def shared_pass(eng, system, suffixes, L: int) -> dict:
    from nos_tpu_torch.ops import _kernels

    eng.drain_ledgers()
    torch.cuda.synchronize()
    replays0, windows0, hits0, saved0 = (
        eng.ticks_dispatched, eng.arena_windows, eng.prefix_hits,
        eng.prefix_tokens_saved)
    _kernels.paged_decode.launches = 0          # the main path's count
    t0 = time.perf_counter()
    rids = [eng.submit(system + s, PREFIX_NEW) for s in suffixes]
    torch.cuda.synchronize()
    admit_s = time.perf_counter() - t0
    shared = eng._alloc.shared_count()
    out = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.paged_decode.launches
    replays = eng.ticks_dispatched - replays0
    windows = eng.arena_windows - windows0
    want = L * (eng.decode_steps * replays + windows)
    if launches != want:
        raise AssertionError(
            f"paged launches {launches} != n_layers x (T x replays + "
            f"in-arena windows) = {L} x ({eng.decode_steps} x {replays} "
            f"+ {windows})")
    held = eng._pindex.block_count if eng._pindex is not None else 0
    if eng._alloc.used_count != held or eng._deferred \
            or any(eng._tables):
        raise AssertionError(f"pool not balanced after the drain: used "
                             f"{eng._alloc.used_count}, index holds {held}")
    ledgers = {d["rid"]: d for d in eng.drain_ledgers()}
    seqs = [out[r] for r in rids]
    for s, seq in zip(suffixes, seqs):
        if len(seq) != PREFIX_LEN + len(s) + PREFIX_NEW \
                or seq[:PREFIX_LEN] != system:
            raise AssertionError("a shared-prefix request's sequence")
    ttft = [ledgers[r]["ttft_s"] * 1e3 for r in rids]
    return {"seqs": seqs, "ttft_ms": ttft,
            "ttft_p50_ms": float(np.percentile(ttft, 50)),
            "ttft_p99_ms": float(np.percentile(ttft, 99)),
            "admit_s": admit_s, "wall_s": wall,
            "hits": eng.prefix_hits - hits0,
            "tokens_saved": eng.prefix_tokens_saved - saved0,
            "shared_blocks_active": shared, "in_arena_windows": windows,
            "graph_replays": replays, "kernel_launches": launches,
            "pool_balanced": True, "index_blocks": held}


def admission_profile(eng, prompt) -> dict:
    """Where one admission's time goes: torch.profiler around a submit
    (prefill and the first token, nothing in flight), device ms by
    kernel group (the paged kernel, matmuls, other) beside the host
    wall; the request is then drained."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.submit(prompt, 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    eng.drain()
    out = device_breakdown(prof, 1, {"paged_kernel": ("paged_decode",)})
    return {"profiled_wall_ms": wall,
            "device_busy_ms": out["device_busy_ms"],
            "device_idle_share": 1 - out["device_busy_ms"] / wall,
            "device_ms": out["device_ms"], "kernels": out["kernels_per_run"],
            "paged_kernels": out["group_kernels_per_run"]["paged_kernel"]}


def window_kernel(seed: int, device, flush) -> dict:
    """Row 1's new launch shape: the paged kernel on one in-arena window
    (B 1, S 256 query rows from pos 1024, the shared 1024-token head and
    the window's own keys through the table; Llama-3-8B's heads, bf16),
    against its plain version (``check_kernel``'s pins), timed beside
    the plain version, SDPA and the bound."""
    from nos_tpu_torch.ops import _kernels
    from nos_tpu_torch.ops.attention import paged_decode_attention_reference

    s, pos, bs, nb, h, h_kv, d = 256, PREFIX_LEN, 16, 128, 32, 8, 128
    gen = torch.Generator(device).manual_seed(seed)
    n_live = (pos + s) // bs
    table = torch.zeros((1, nb), dtype=torch.int32)
    table[0, :n_live] = torch.randperm(n_live, generator=torch.Generator()
                                       .manual_seed(seed)) + 1
    case = dict(
        q=torch.randn((1, h, s, d), generator=gen, device=device
                      ).to(torch.bfloat16),
        k_arena=torch.randn((1 + n_live, h_kv, bs, d), generator=gen,
                            device=device).to(torch.bfloat16),
        v_arena=torch.randn((1 + n_live, h_kv, bs, d), generator=gen,
                            device=device).to(torch.bfloat16),
        table=table.to(device),
        pos=torch.tensor([pos], dtype=torch.int32, device=device),
        k_scale=None, v_scale=None)

    def launch():
        return _kernels.paged_decode.launch(
            case["q"], case["k_arena"], case["v_arena"], case["table"],
            case["pos"], k_scale=None, v_scale=None, scale=d ** -0.5)

    out = launch()
    row = {"B": 1, "S": s, "pos": pos, "live_tokens": pos + s,
           **check_kernel(out, case)}
    if not torch.equal(launch(), out):
        raise AssertionError("window kernel: two launches, other bits")
    row["ms"] = cuda_ms(launch, 50, flush)
    row["plain_ms"] = cuda_ms(
        lambda: paged_decode_attention_reference(**case), 20, flush)
    row["library_ms"] = cuda_ms(library_call(case), 50, flush)
    row["bound_ms"], row["bound_by"] = paged_bound(case)
    return row


def window_vs_scratch(engine, system, suffixes, window, kv_dtype) -> dict:
    """Each shared request's in-arena window logits (``window``, in
    submission order, from the kernel engine's first pass) against the
    scratch path's for the same prompt on the same arena bits: a gather
    formulation engine takes every hit over a scratch row seeded from
    the shared blocks (dequantized for int8), which the same system
    prompt prefill made. Raises past ``ARENA_LOGIT_TOL`` or
    where the argmax differs on a row whose top-2 gap exceeds twice its
    difference."""
    eng = engine(paged_impl="xla", kv_dtype=kv_dtype)
    logits = first_logits(eng)
    eng.submit(system, 1, cache_prefix=True)
    for s in suffixes:
        eng.submit(system + s, 1)
    eng.drain()
    if eng.prefix_hits != len(suffixes):
        raise AssertionError(f"gather engine: {eng.prefix_hits} hits")
    scratch = logits[1:]
    del eng, logits
    errs, clear, agree = [], 0, 0
    for w, sc in zip(window, scratch):
        err = float((w - sc).abs().max())
        top2 = w.topk(2).values
        same = bool(w.argmax() == sc.argmax())
        errs.append(err)
        agree += same
        if float(top2[0] - top2[1]) > 2 * err:
            clear += 1
            if not same:
                raise AssertionError(f"{kv_dtype} in-arena window vs "
                                     f"scratch path: argmax differs on a "
                                     f"clear-gap row (max|dlogit| {err})")
    if max(errs) > ARENA_LOGIT_TOL:
        raise AssertionError(f"{kv_dtype} in-arena window vs scratch path: "
                             f"max|dlogit| {errs} (tol {ARENA_LOGIT_TOL})")
    return {"max_abs_logit_err": max(errs), "per_request": errs,
            "tol": ARENA_LOGIT_TOL, "argmax_agree": agree,
            "rows_clear_gap": clear, "requests": len(errs)}


def fork_pair(eng, prompts) -> dict:
    """Fork each of ``prompts``' requests after 3 engine steps: every
    fork's tokens must equal its source's continuation bit for bit, and
    the copy-on-write copies must be one per pair whose tail block is
    partial at the fork (the first holder to write it copies it)."""
    cow0 = eng.cow_copies
    src = [eng.submit(p, 32) for p in prompts]
    for _ in range(3):
        eng.step()
    forks = [eng.fork(r) for r in src]
    bases = [len(p) + len(eng.progress(f)[0]) - 1
             for p, f in zip(prompts, forks)]
    shared = eng._alloc.shared_count()
    res = eng.drain()
    for r, f in zip(src, forks):
        if res[r] != res[f]:
            raise AssertionError("a fork's tokens differ from its source's "
                                 "continuation")
    want = sum(1 for b in bases if b % 16)
    cow = eng.cow_copies - cow0
    if cow != want:
        raise AssertionError(f"{cow} copy-on-write copies, want {want} "
                             f"(one per pair whose tail block is partial)")
    return {"forked": len(forks), "fork_tokens_equal_source": True,
            "shared_blocks_at_fork": shared, "cow_copies": cow,
            "committed_at_fork": bases}


def agreement(a: list, b: list, start: int) -> dict:
    """Greedy agreement of two runs' generated tokens (past ``start``
    for each sequence's own prompt length)."""
    same = tot = first_diff = 0
    exact = 0
    for x, y, n in zip(a, b, start):
        gx, gy = x[n:], y[n:]
        k = next((i for i, (p, q) in enumerate(zip(gx, gy)) if p != q),
                 len(gx))
        first_diff += k
        same += sum(p == q for p, q in zip(gx, gy))
        tot += len(gx)
        exact += gx == gy
    return {"requests_identical": exact, "requests": len(a),
            "token_agreement": same / tot,
            "mean_tokens_before_first_difference": first_diff / len(a)}


def phase_prefix(seed: int, card: str, eng0) -> dict:
    """(k), parts 1 and 2: the paged prefix cache and fork at phase (e)'s
    width, every engine on ``eng0``'s weights. Part 1 serves
    ``prefix_traffic`` on a prefix-cache engine (kernel formulation, so
    every hit prefills its suffix in the arena through the paged kernel's
    S > 1 window) and on a ``prefix_cache_size=0`` engine: TTFT p50/p99
    of both, hits and tokens saved, shared blocks while active, the pool
    balanced after; the kernel's launch count is n_layers x (T x replays
    + in-arena windows); the captured graphs still hold the scratch they
    recorded. Each request's in-arena window logits against the scratch
    path's on the same arena (the gather formulation) within
    ``ARENA_LOGIT_TOL``, on the bf16 and the int8 arena; greedy
    agreement with the no-prefix engine. Repeated at depth 2, T 4 (the
    same tokens) and on an int8 arena.
    Part 2 forks 2 active greedy requests: each fork's tokens equal its
    source's, and the copy-on-write copies are counted."""
    import gc

    from nos_tpu_torch.models.serving import DecodeServer

    system, suffixes = prefix_traffic(seed)
    L = FULL["n_layers"]
    starts = [PREFIX_LEN + len(s) for s in suffixes]

    def engine(**kw):
        gc.collect()
        torch.cuda.empty_cache()
        return DecodeServer(eng0.params, eng0.cfg, max_batch=8,
                            kv_block_size=16, kv_blocks=1 + 8 * 128,
                            device=eng0.device, **{
                                "prefix_cache_size": 128,
                                "paged_impl": "kernel", **kw})

    out = {"phase": "prefix_cache", "card": card,
           "prefix_tokens": PREFIX_LEN,
           "suffix_lens": [len(s) for s in suffixes],
           "new_tokens": PREFIX_NEW,
           "window_widths": sorted({int(2 ** np.ceil(np.log2(max(8, len(s)))))
                                    for s in suffixes})}
    # part 1: the prefix engine, then the no-prefix baseline
    eng = engine()
    logits = first_logits(eng)
    hit = prefix_pass(eng, system, suffixes, L)
    window = logits[1:1 + len(suffixes)]    # the first pass's windows
    if hit["hits"] != len(suffixes) or hit["in_arena_windows"] != \
            len(suffixes) or hit["shared_blocks_active"] != PREFIX_LEN // 16:
        raise AssertionError(f"prefix engine: {hit['hits']} hits, "
                             f"{hit['in_arena_windows']} windows, "
                             f"{hit['shared_blocks_active']} shared blocks")
    g = eng._graphs[False]
    if g.scratch[0] is not eng._scratch.part \
            or g.scratch[1] is not eng._scratch.ticket:
        raise AssertionError("an in-arena window replaced the scratch the "
                             "decode graph recorded")
    longest = system + max(suffixes, key=len)
    hit_profile = admission_profile(eng, longest)
    # part 2 on the same engine: fork 2 active greedy requests
    prompts = full_width_prompts(seed)[:2]
    fork = fork_pair(eng, prompts)
    del eng, logits
    eng = engine(prefix_cache_size=0)
    miss = prefix_pass(eng, system, suffixes, L)
    miss_profile = admission_profile(eng, longest)
    del eng
    vs_scratch = {"bf16": window_vs_scratch(engine, system, suffixes,
                                            window, "bf16")}
    del window
    # depth 2, T 4: the same tokens; then the int8 arena
    eng = engine(pipeline_depth=2, decode_steps=4)
    fused = prefix_pass(eng, system, suffixes, L)
    fused_fork = fork_pair(eng, prompts)
    del eng
    if fused["seqs"] != hit["seqs"]:
        raise AssertionError("prefix engine at depth 2, T 4: tokens differ "
                             "from depth 1, T 1")
    eng = engine(kv_dtype="int8")
    logits = first_logits(eng)
    q8 = prefix_pass(eng, system, suffixes, L)
    window = logits[1:1 + len(suffixes)]
    del eng, logits
    vs_scratch["int8"] = window_vs_scratch(engine, system, suffixes,
                                           window, "int8")
    del window
    gc.collect()
    torch.cuda.empty_cache()

    def row(r):
        return {k: v for k, v in r.items() if k != "seqs"}

    out.update({
        "prefix": row(hit), "no_prefix": row(miss),
        "admission_profile": {"prefix_hit": hit_profile,
                              "no_prefix": miss_profile,
                              "prompt_tokens": len(longest)},
        "ttft_speedup_p50": miss["ttft_p50_ms"] / hit["ttft_p50_ms"],
        "window_vs_scratch": vs_scratch,
        "agreement_with_no_prefix": agreement(hit["seqs"], miss["seqs"],
                                              starts),
        "depth2_T4": row(fused), "depth2_T4_tokens_equal": True,
        "depth2_T4_fork": fused_fork,
        "int8": row(q8),
        "int8_agreement_with_bf16": agreement(q8["seqs"], hit["seqs"],
                                              starts),
        "fork": fork,
        "graph_scratch_kept": True,
        "tokens_sha256": token_digest(hit["seqs"])})
    emit(out)
    return {"launches": hit["kernel_launches"],
            "windows": hit["in_arena_windows"],
            "fused_launches": fused["kernel_launches"],
            "int8_launches": q8["kernel_launches"]}


# phase (k)'s binary traffic: 6 decoders, 64-256-token prompts x 128 new
# tokens; once they decode, 2 long prompts of 1536 tokens x 32
DECODERS, DECODE_NEW = 6, 128
LONG_PROMPT, LONG_NEW = 1536, 32
CHUNK = 256
BINARIES = [("one_shot", dict()), ("chunked", dict(prefill_chunk=CHUNK)),
            ("budgeted", dict(prefill_chunk=CHUNK, prefill_budget=CHUNK))]


def admission_traffic(seed: int) -> tuple:
    rng = np.random.default_rng(seed + 202)
    short = [rng.integers(0, FULL["vocab"], size=n).tolist()
             for n in rng.integers(64, 257, size=DECODERS)]
    long = [rng.integers(0, FULL["vocab"], size=LONG_PROMPT).tolist()
            for _ in range(2)]
    return short, long


def chunk_device(eng, n: int = 5) -> dict:
    """One CHUNK-token chunk forward on a 2048-position scratch row at
    its middle, the work the cost model's host reading stands for:
    device busy ms (the kernels' own durations from torch.profiler, no
    launch gaps), kernels and profiled wall ms per chunk, over ``n``,
    and the median CUDA-event span of one chunk (which also holds every
    wait of the device for the host's dispatch)."""
    from torch.profiler import ProfilerActivity, profile

    from nos_tpu_torch.models.generate import forward_with_cache

    toks = torch.zeros((1, CHUNK), dtype=torch.long, device=eng.device)
    row = eng._row(2048, 1024)
    forward_with_cache(eng.params, eng.cfg, toks, row)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        events = []
        for _ in range(n):
            row["pos"] = torch.tensor(1024, dtype=torch.int32)
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
            forward_with_cache(eng.params, eng.cfg, toks, row)
            events[-1][1].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / n
    out = device_breakdown(prof, n, {})
    return {"device_busy_ms": out["device_busy_ms"],
            "kernels": out["kernels_per_run"], "profiled_wall_ms": wall,
            "event_span_ms": float(np.median(
                [a.elapsed_time(b) for a, b in events]))}


def admission_binary(eng, short, long) -> dict:
    """One binary (ServingLoop + make_http_server on 127.0.0.1 over
    ``eng``): the 6 decoders from client threads, then, once all of them
    decode, the 2 long prompts. Returns sequences, the decoders' TPOT and
    the long prompts' TTFT from the engine's ledgers, the loop's tick and
    the budget counters."""
    import threading

    from nos_tpu_torch.cmd.server import (
        ServerConfig, ServingLoop, make_http_server,
    )

    led = {}
    pop = eng.pop_ledger

    def keep(rid):
        d = pop(rid)
        if d is not None:
            led[rid] = d
        return d

    eng.pop_ledger = keep
    eng.capture_programs()
    # one long prompt alone first: the measured pass then meets no shape
    # (and no allocator growth) for the first time
    eng.submit(long[0], 2)
    eng.drain()
    eng.drain_ledgers()
    counters = (eng.prefill_budget_spent, eng.prefill_budget_clamped,
                eng.prefill_budget_overrides, eng.prefill_chunk_tokens)
    loop = ServingLoop(eng, restart_budget=0, device_stats_interval_s=10.0)
    httpd = make_http_server(ServerConfig(port=0), loop, host="127.0.0.1")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    prompts = short + long
    seqs, errors = [None] * len(prompts), []

    def client(i):
        body = {"prompt": prompts[i], "max_new_tokens":
                DECODE_NEW if i < DECODERS else LONG_NEW}
        try:
            status, raw = http_call(url, "/v1/generate", body)
            if status != 200:
                raise AssertionError(f"status {status}: {raw[:300]}")
            seqs[i] = json.loads(raw)["tokens"]
        except BaseException as e:
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    names = ("nos_tpu_serve_prefill_budget_tokens_total",
             "nos_tpu_serve_prefill_clamp_total",
             "nos_tpu_serve_prefill_override_total")
    try:
        _, text = http_call(url, "/metrics")
        before = {n: metric_line(text.decode(), n) for n in names}
        n0, s0 = loop.h_tick.observations()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads[:DECODERS]:
            t.start()
        deadline = time.monotonic() + 120
        while True:
            with loop._work:
                live = [r for r in eng._active.values() if r.out]
            if len(live) == DECODERS:
                break
            if time.monotonic() > deadline:
                raise AssertionError("the decoders never decoded together")
            time.sleep(0.002)
        for t in threads[DECODERS:]:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"HTTP clients failed: {errors}")
        n1, s1 = loop.h_tick.observations()
        _, text = http_call(url, "/metrics")
        text = text.decode()
    finally:
        httpd.shutdown()
        loop.shutdown()
        httpd.server_close()
    del eng.pop_ledger
    # a decoder's first gap spans the other decoders' one-shot prefills
    # (they arrive together, and a prompt of at most one chunk is not
    # chunked); the steady gaps after it are where the long prompts land
    tpot, steady, ttft = [], [], []
    for d in led.values():
        if d["prompt_tokens"] == LONG_PROMPT:
            ttft.append(d["ttft_s"] * 1e3)
        else:
            for i, (gap, n) in enumerate(d["tpot"]):
                tpot += [gap / n * 1e3] * n
                if i:
                    steady += [gap / n * 1e3] * n
    metrics = {n: metric_line(text, n) - before[n] for n in names}
    return {"seqs": seqs, "decoder_tpot_p50_ms": float(np.percentile(tpot, 50)),
            "decoder_tpot_p99_ms": float(np.percentile(tpot, 99)),
            "decoder_tpot_max_ms": float(max(tpot)),
            "decoder_steady_tpot_p50_ms": float(np.percentile(steady, 50)),
            "decoder_steady_tpot_p99_ms": float(np.percentile(steady, 99)),
            "decoder_steady_tpot_max_ms": float(max(steady)),
            "long_ttft_ms": ttft,
            "loop_ms_per_tick": (s1 - s0) * 1e3 / (n1 - n0),
            "loop_ticks": n1 - n0,
            "budget_spent_tokens": eng.prefill_budget_spent - counters[0],
            "clamped_ticks": eng.prefill_budget_clamped - counters[1],
            "overrides": eng.prefill_budget_overrides - counters[2],
            "chunk_tokens": eng.prefill_chunk_tokens - counters[3],
            "metrics": metrics,
            "est_prefill_tok_s": eng._est_prefill_tok_s()}


def phase_admission(seed: int, card: str, eng0) -> dict:
    """(k), part 3: chunked and budgeted prefill through the binary at
    phase (e)'s width, three binaries in turn on ``eng0``'s weights (the
    engine ``build_engine`` makes, with ``prefill_chunk`` and
    ``prefill_budget`` as ``main`` passes them): one-shot, chunked at 256
    and chunked at 256 under a 256-token budget. The budgeted run's
    tokens must equal the chunked run's bit for bit; the chunked run's
    agreement with the one-shot run is printed. The cost model's host
    reading of a chunk beside its device busy time."""
    import gc

    from nos_tpu_torch.models.serving import DecodeServer
    from nos_tpu_torch.utils.metrics import default_registry

    short, long = admission_traffic(seed)
    starts = [len(p) for p in short + long]
    reg = default_registry()
    for name in ("nos_tpu_serve_ttft_seconds", "nos_tpu_serve_tpot_seconds"):
        h = reg.get(name)
        if h is not None:
            h.track_samples = False
    runs = {}
    for name, knobs in BINARIES:
        gc.collect()
        torch.cuda.empty_cache()
        eng = DecodeServer(eng0.params, eng0.cfg, max_batch=8,
                           kv_block_size=16, kv_blocks=1 + 8 * 128,
                           hbm_admit_frac=0.95, device=eng0.device,
                           paged_impl="kernel", **knobs)
        runs[name] = admission_binary(eng, short, long)
        if name == "chunked":
            runs[name]["chunk_device"] = chunk_device(eng)
        del eng
    if runs["budgeted"]["seqs"] != runs["chunked"]["seqs"]:
        raise AssertionError("budgeted tokens differ from chunked tokens")
    # the chunk installs and block growth with ticks in flight: the same
    # traffic straight into a chunked engine at depth 2, T 4
    gc.collect()
    torch.cuda.empty_cache()
    eng = DecodeServer(eng0.params, eng0.cfg, max_batch=8,
                       kv_block_size=16, kv_blocks=1 + 8 * 128,
                       device=eng0.device, paged_impl="kernel",
                       prefill_chunk=CHUNK, pipeline_depth=2,
                       decode_steps=4)
    eng.capture_programs()
    rids = [eng.submit(p, DECODE_NEW) for p in short]
    for _ in range(2):
        eng.step()
    rids += [eng.submit(p, LONG_NEW) for p in long]
    queued = len(eng._prefilling)
    out = eng.drain()
    fused = [out[r] for r in rids]
    del eng, out
    if queued != len(long) or fused != runs["chunked"]["seqs"]:
        raise AssertionError(f"chunked at depth 2, T 4: {queued} queued, "
                             f"tokens equal {fused == runs['chunked']['seqs']}")
    ch = runs["chunked"]
    host_tok_ms = ch["est_prefill_tok_s"] * 1e3
    dev_tok_ms = ch["chunk_device"]["device_busy_ms"] / CHUNK
    out = {"phase": "admission", "card": card, "decoders": DECODERS,
           "decoder_new_tokens": DECODE_NEW, "long_prompts": len(long),
           "long_prompt_tokens": LONG_PROMPT, "long_new_tokens": LONG_NEW,
           "chunk": CHUNK, "budget": CHUNK,
           "budgeted_equals_chunked": True,
           "chunked_depth2_T4_equals_chunked": True,
           "chunked_vs_one_shot": agreement(ch["seqs"],
                                            runs["one_shot"]["seqs"],
                                            starts),
           "cost_model_host_ms_per_token": host_tok_ms,
           "chunk_device_busy_ms_per_token": dev_tok_ms,
           "cost_model_over_device_busy": host_tok_ms / dev_tok_ms}
    for name, r in runs.items():
        out[name] = {k: v for k, v in r.items() if k != "seqs"}
    emit(out)
    return out


def phase_small_invariants(seed: int, card: str, device) -> dict:
    """(k), part 4: the reference's token invariants in f32 on phase
    (d)'s small model, on the card: a prefix hit equals a fresh prefill
    through the kernel and through the gather formulation; chunked
    equals one-shot prefill; budgeted equals unbudgeted."""
    from nos_tpu_torch.models.serving import DecodeServer
    from nos_tpu_torch.models.transformer import (
        TransformerConfig, init_params,
    )

    cfg = TransformerConfig(**SMALL, dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device).manual_seed(seed),
                         device)
    rng = np.random.default_rng(seed + 303)
    system = rng.integers(0, cfg.vocab, size=64).tolist()
    reqs = [system + rng.integers(0, cfg.vocab, size=n).tolist()
            for n in (3, 20, 57, 100)]

    def serve(impl, first_publish=False, **kw):
        eng = DecodeServer(params, cfg, max_batch=4, kv_block_size=16,
                           kv_blocks=1 + 4 * 16, device=device,
                           paged_impl=impl, **kw)
        if first_publish:
            eng.submit(system + [1], 4, cache_prefix=True)
            eng.drain()
        rids = [eng.submit(p, 16) for p in reqs]
        out = eng.drain()
        return [out[r] for r in rids], eng

    checks = {}
    for impl in ("kernel", "xla"):
        fresh, _ = serve(impl)
        hit, eng = serve(impl, first_publish=True, prefix_cache_size=16)
        if hit != fresh or eng.prefix_hits != len(reqs):
            raise AssertionError(f"f32 {impl}: prefix hit != fresh prefill "
                                 f"({eng.prefix_hits} hits)")
        windows = eng.arena_windows
        chunked, _ = serve(impl, prefill_chunk=16)
        if chunked != fresh:
            raise AssertionError(f"f32 {impl}: chunked != one-shot")
        budgeted, eng = serve(impl, prefill_chunk=16, prefill_budget=8)
        if budgeted != chunked or not eng.prefill_budget_spent:
            raise AssertionError(f"f32 {impl}: budgeted != unbudgeted")
        checks[impl] = {"prefix_hit_equals_fresh": True,
                        "chunked_equals_one_shot": True,
                        "budgeted_equals_unbudgeted": True,
                        "in_arena_windows": windows}
    out = {"phase": "admission_f32", "card": card, "requests": len(reqs),
           "prefix_tokens": len(system), **checks}
    emit(out)
    return out


def phase_k(seed: int, card: str, flush) -> dict:
    """(k): the admission path on the card; one set of full-width weights
    (``build_engine``'s, from the seed) serves every engine of it."""
    import gc

    from nos_tpu_torch.cmd.server import ServerConfig, build_engine

    torch.cuda.empty_cache()
    window = window_kernel(seed, torch.device("cuda"), flush)
    emit({"phase": "window_kernel_vs_plain", "card": card, **window})
    eng0 = build_engine(ServerConfig(
        bf16=True, kv_blocks=2, kv_block_size=16, max_batch=1,
        paged_kernel="on", seed=seed, **FULL))
    out = phase_prefix(seed, card, eng0)
    out["window"] = window
    phase_admission(seed, card, eng0)
    phase_small_invariants(seed, card, eng0.device)
    del eng0
    gc.collect()
    torch.cuda.empty_cache()
    return out


# phase (l): the KV payload at phase (e)'s width. A pool sized at
# PRESSURE_FRAC of the batch's final footprint: the reference's
# memory-aware admission waits for headroom, so at 75% the requests
# queue at admission and no decoding slot is squeezed (a CPU rehearsal
# of these prompts' block arithmetic preempted none); at 88% all 8
# admit and their growth preempts 3 slots
PRESSURE_NEW = 64
PRESSURE_FRAC = 0.88
PRESSURE_POINTS = [(swap, kv, d, t) for swap in (True, False)
                   for kv in ("bf16", "int8") for d, t in ((1, 1), (2, 4))]
HANDOFF_NEW = 32


def quiet_histograms() -> None:
    """A new ``ServingLoop`` registers the loop's histograms without
    sample retention, as production code does; an earlier phase may
    have turned it on in the process registry."""
    from nos_tpu_torch.utils.metrics import default_registry

    reg = default_registry()
    for name in ("nos_tpu_serve_ttft_seconds", "nos_tpu_serve_tpot_seconds"):
        h = reg.get(name)
        if h is not None:
            h.track_samples = False


def pressure_pool(prompts, new: int, bs: int = 16) -> int:
    """Blocks (the null block included) for ``PRESSURE_FRAC`` of the
    batch's final KV footprint."""
    from nos_tpu_torch.models.kvblocks import blocks_for

    final = sum(blocks_for(len(p) + new - 1, bs) for p in prompts)
    return 1 + int(PRESSURE_FRAC * final)


def instrument(eng) -> dict:
    """Time the engine's swap-out, swap-in and replay on the card (a sync
    before and after each, so each reads its own device work) and record
    the swap payloads' bytes; returns the lists it fills."""
    rec = {"swap_out_ms": [], "swap_in_ms": [], "payload_bytes": [],
           "replay_ms": [], "replay_tokens": []}
    swap_out, swap_in, replay = (eng._swap_payload, eng._resume_swapped,
                                 eng._replay_committed)

    def timed(fn, key, *a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        rec[key].append((time.perf_counter() - t) * 1e3)
        return out

    def swap_payload(table, nblk, **kw):
        p = timed(lambda *a: swap_out(*a, **kw), "swap_out_ms", table, nblk)
        rec["payload_bytes"].append(sum(
            int(p[k].nbytes) for k in ("k", "v", "k_scale", "v_scale")
            if k in p))
        return p

    def replay_committed(req):
        rec["replay_tokens"].append(len(req.out) - 1)
        return timed(replay, "replay_ms", req)

    eng._swap_payload = swap_payload
    eng._resume_swapped = lambda req: timed(swap_in, "swap_in_ms", req)
    eng._replay_committed = replay_committed
    return rec


def kv_at(eng, slot: int, pos: int) -> list:
    """Every K/V plane (and int8 scale plane) of one slot at one
    position, all layers, cloned."""
    bs = eng.kv_block_size
    blk = eng._tables[slot][pos // bs]
    return [eng.cache[n][:, blk, :, pos % bs].clone()
            for n in ("k", "v", "k_scale", "v_scale") if n in eng.cache]


def put_kv(eng, slot: int, pos: int, planes: list) -> None:
    bs = eng.kv_block_size
    blk = eng._tables[slot][pos // bs]
    for n, x in zip([n for n in ("k", "v", "k_scale", "v_scale")
                     if n in eng.cache], planes):
        eng.cache[n][:, blk, :, pos % bs] = x


def same(a: list, b: list) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def batch_invariance(eng, prompts) -> dict:
    """(l.1) The last tick wrote K/V for each row at its newest position
    and left that step's logits in the greedy graph's output. Replay the
    same token at the same position for one row through the replay
    program (the tick's width, only that row live) and through a B = 1
    ``forward_paged`` on a one-row view of the same arena: whether each
    rewrote the tick's K/V bytes and reproduced its logits bit for bit,
    with the paged kernel's split count of each. The tick's bytes are
    put back after each replay."""
    from nos_tpu_torch.models.generate import forward_paged
    from nos_tpu_torch.ops import _kernels

    for p in prompts:
        eng.submit(p, 16)
    for _ in range(4):
        eng.step()
    torch.cuda.synchronize()
    assert not eng._inflight and eng.decode_steps == 1
    s = sorted(eng._active)[0]
    req = eng._active[s]
    pos = len(req.prompt) + len(req.out) - 2
    tok = req.out[-2]
    tick_logits = eng._graphs[False].logits[s].clone()
    tick = kv_at(eng, s, pos)
    eng._rtable[s].copy_(eng._table[s])
    eng._rtoks[s, 0].fill_(tok)
    eng._rpos[s].fill_(pos)
    width_logits = eng._launch_replay()[s].clone()
    eng._rtable[s].zero_()
    eng._rpos[s].zero_()
    torch.cuda.synchronize()
    width = kv_at(eng, s, pos)
    put_kv(eng, s, pos, tick)
    view = {k: v for k, v in eng.cache.items() if k != "pos"}
    view["pos"] = torch.tensor([pos], dtype=torch.int32, device=eng.device)
    one_logits, _ = forward_paged(
        eng.params, eng.cfg, torch.tensor([[tok]], device=eng.device), view,
        eng._table[s:s + 1], paged_impl="kernel")
    torch.cuda.synchronize()
    one = kv_at(eng, s, pos)
    put_kv(eng, s, pos, tick)
    eng.drain()
    cfg = eng.cfg
    g = cfg.n_heads // cfg.n_kv_heads
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def splits(b):
        return _kernels.paged_splits(
            b * cfg.n_kv_heads * _kernels.paged_row_tiles(g), sms)

    def err(x, y):
        return float(max((a.float() - b.float()).abs().max()
                         for a, b in zip(x, y)))

    one_logits = one_logits[0, -1].float()
    return {"kv_dtype": eng.kv_dtype, "slot": s, "position": pos,
            "width_rows": eng.max_batch,
            "width_kv_bit_equal": same(width, tick),
            "width_logits_bit_equal": bool(torch.equal(width_logits,
                                                       tick_logits)),
            "width_max_abs_logit_diff": float(
                (width_logits - tick_logits).abs().max()),
            "b1_kv_bit_equal": same(one, tick),
            "b1_max_abs_kv_diff": err(one, tick),
            "b1_logits_bit_equal": bool(torch.equal(one_logits,
                                                    tick_logits)),
            "b1_max_abs_logit_diff": float(
                (one_logits - tick_logits).abs().max()),
            "paged_splits_width": splits(eng.max_batch),
            "paged_splits_b1": splits(1)}


def recompute_probe(engine, prompts, plen: int, ticks: int,
                    eager: bool) -> dict:
    """A recompute resume against an undisturbed twin, two engines on one
    set of weights and the same traffic (8 requests, ``ticks`` ticks):
    the request whose prompt has ``plen`` tokens is preempted by
    recompute in the second and resumed (a re-prefill of its prompt over
    a scratch row, then its committed tokens replayed through the replay
    graph), then both take one more tick. The re-prefilled prompt span's
    K/V (the prompt alone, in its admission's bucket) and the replayed
    output span's must equal the twin's bytes; the next step's logits
    and token are compared and printed. With ``eager`` the request is
    then preempted again and resumed with the replay program called
    eagerly: its output span must equal the graph resume's bytes; ms per
    committed token of both."""
    from nos_tpu_torch.models.serving import uncaptured

    twin, eng = engine(kv_swap=False), engine(kv_swap=False)
    for e in (twin, eng):
        e.capture_programs()
        for p in prompts:
            e.submit(p, ticks + 8)
        for _ in range(ticks):
            e.step()
    torch.cuda.synchronize()
    s = next(k for k, r in eng._active.items() if len(r.prompt) == plen)
    req = eng._active[s]
    rid = req.rid
    rec = instrument(eng)
    assert eng.preempt(rid, "recompute")
    eng._admit()

    def slot_of(e, r):
        return next(k for k, q in e._active.items() if q.rid == r)

    def timeline(e, slot, written):
        bs = e.kv_block_size
        return [torch.stack([e.cache[n][:, e._tables[slot][q // bs], :,
                                        q % bs] for q in range(written)])
                for n in ("k", "v", "k_scale", "v_scale") if n in e.cache]

    def spans(a, b):
        return (same([x[:plen] for x in a], [y[:plen] for y in b]),
                same([x[plen:] for x in a], [y[plen:] for y in b]))

    n = plen + len(req.out) - 1
    written = n
    prompt_equal, output_equal = spans(timeline(eng, slot_of(eng, rid),
                                                written),
                                       timeline(twin, s, written))
    if not (prompt_equal and output_equal):
        raise AssertionError(
            f"recompute resume: K/V differs from the undisturbed engine's "
            f"(prompt span equal {prompt_equal}, output span equal "
            f"{output_equal}): the prompt re-prefills as its admission did "
            f"and the replay runs the tick's shapes")
    for e in (twin, eng):
        e.step()
    torch.cuda.synchronize()
    la = twin._graphs[False].logits[s]
    lb = eng._graphs[False].logits[slot_of(eng, rid)]
    out = {"request_prompt_tokens": plen, "committed_tokens": len(req.out),
           "admission_bucket": max(8, 1 << (plen - 1).bit_length()),
           "committed_sequence_bucket": max(8, 1 << (n - 1).bit_length()),
           "prompt_span_bit_equal": prompt_equal,
           "output_span_bit_equal": output_equal,
           "next_step_logits_bit_equal": bool(torch.equal(la, lb)),
           "next_step_max_abs_logit_diff": float((la - lb).abs().max()),
           "next_token_equal": twin._active[s].out
           == eng._active[slot_of(eng, rid)].out,
           "replayed_tokens": list(rec["replay_tokens"]),
           "resume_ms": list(rec["replay_ms"]),
           "replay_graph_ms_per_token":
               rec["replay_ms"][-1] / rec["replay_tokens"][-1]}
    if eager:
        # again, the replay program called eagerly: the same bytes
        written = plen + len(eng._active[slot_of(eng, rid)].out) - 1
        before = timeline(eng, slot_of(eng, rid), written)
        assert eng.preempt(rid, "recompute")
        with uncaptured(eng):
            eng._admit()
        torch.cuda.synchronize()
        _, eager_equal = spans(timeline(eng, slot_of(eng, rid), written),
                               before)
        if not eager_equal:
            raise AssertionError("recompute resume: the eager replay wrote "
                                 "other bytes than the replay graph")
        out.update(eager_replay_output_span_bit_equal=True,
                   resume_ms=list(rec["replay_ms"]),
                   replay_eager_ms_per_token=rec["replay_ms"][-1]
                   / rec["replay_tokens"][-1])
    twin.drain()
    eng.drain()
    return out


ADMISSION_PROBE_TICKS = 6


def admission_probe(engine, kind: str, kv_dtype: str, seed: int) -> dict:
    """(l.1, ROADMAP C.12) A recompute victim admitted another way than a
    one-shot prefill, against an undisturbed twin: ``hit``, phase (k)'s
    1024-token system prompt (published) plus a 64-token suffix, which
    the kernel admits as one S > 1 window over the shared head; or
    ``chunked``, phase (k.3)'s 1536-token prompt in 256-token chunks.
    After ``ADMISSION_PROBE_TICKS`` ticks the victim is preempted by
    recompute and resumed, which repeats its admission's path (the
    window over the re-shared head, or the same chunks) and replays its
    committed tokens; then both take one more tick. Its prompt span's
    and output span's K/V (planes and scales), the next step's logits
    and its tokens to the end must equal the twin's. A third engine
    resumes the same victim by the one-shot re-prefill of its prompt
    (the resume before the repair), whose equality is printed."""
    system, suffixes = prefix_traffic(seed)
    _, long = admission_traffic(seed)
    rng = np.random.default_rng(seed + 303)
    if kind == "hit":
        prompt = system + rng.integers(0, FULL["vocab"], size=64).tolist()
        knobs = dict(prefix_cache_size=PREFIX_LEN // 16)
        path = "window"
    else:
        prompt, knobs, path = long[0], dict(prefill_chunk=CHUNK), "chunked"
    plen = len(prompt)
    new = ADMISSION_PROBE_TICKS + 8

    def admitted(e):
        if kind == "hit":
            e.submit(system, 2, cache_prefix=True)
            e.drain()
        rid = e.submit(prompt, new)
        while any(x["req"].rid == rid for x in e._prefilling):
            e.step()
        for _ in range(ADMISSION_PROBE_TICKS):
            e.step()
        torch.cuda.synchronize()
        return rid

    def slot_of(e, r):
        return next(k for k, q in e._active.items() if q.rid == r)

    def timeline(e, r, written):
        bs, slot = e.kv_block_size, slot_of(e, r)
        return [torch.stack([e.cache[n][:, e._tables[slot][q // bs], :,
                                        q % bs] for q in range(written)])
                for n in ("k", "v", "k_scale", "v_scale") if n in e.cache]

    twin = engine(kv_swap=False, kv_dtype=kv_dtype, **knobs)
    rt = admitted(twin)
    out = {"kind": kind, "kv_dtype": kv_dtype, "prompt_tokens": plen,
           "admission": twin._active[slot_of(twin, rt)].admission[0]}
    for name, repeat in (("repaired", True), ("one_shot", False)):
        eng = engine(kv_swap=False, kv_dtype=kv_dtype, **knobs)
        rid = admitted(eng)
        committed = len(eng._active[slot_of(eng, rid)].out)
        assert eng.preempt(rid, "recompute")
        if not repeat:
            eng._pending[0].admission = None
        eng._admit()
        torch.cuda.synchronize()
        if repeat and eng.resume_paths[path] != 1:
            raise AssertionError(f"{kind}: the resume took "
                                 f"{eng.resume_paths}, not {path}")
        written = plen + committed - 1
        a, b = timeline(eng, rid, written), timeline(twin, rt, written)
        prompt_eq = same([x[:plen] for x in a], [y[:plen] for y in b])
        output_eq = same([x[plen:] for x in a], [y[plen:] for y in b])
        for e in (twin, eng) if repeat else (eng,):
            e.step()
        torch.cuda.synchronize()
        # the graphs' output buffers: every later replay rewrites them
        la = twin._graphs[False].logits[slot_of(twin, rt)].clone()
        lb = eng._graphs[False].logits[slot_of(eng, rid)].clone()
        tokens = eng.drain()[rid]
        row = {"prompt_span_bit_equal": prompt_eq,
               "output_span_bit_equal": output_eq,
               "next_step_logits_bit_equal": bool(torch.equal(la, lb)),
               "next_step_max_abs_logit_diff": float((la - lb).abs().max()),
               "committed_tokens": committed, "resume_paths":
               dict(eng.resume_paths), "tokens": tokens}
        out[name] = row
        del eng
    want = twin.drain()[rt]
    for name in ("repaired", "one_shot"):
        out[name]["tokens_equal_twin"] = out[name].pop("tokens") == want
    rep = out["repaired"]
    if not (rep["prompt_span_bit_equal"] and rep["output_span_bit_equal"]
            and rep["next_step_logits_bit_equal"]
            and rep["tokens_equal_twin"]):
        raise AssertionError(f"C.12 {kind} {kv_dtype}: the repaired "
                             f"recompute resume differs from its twin: "
                             f"{rep}")
    del twin
    return out


def pressure_run(engine, prompts, kv_swap: bool, kv_dtype: str,
                 depth: int, steps: int, L: int) -> dict:
    """(l.2) One point: phase (e)'s 8 prompts x ``PRESSURE_NEW`` tokens on
    a pool of ``pressure_pool`` blocks, programs captured up front. At
    least two slots must be preempted; the kernel's own launch count is
    n_layers x (T x replays + replayed tokens); the pool balances."""
    from nos_tpu_torch.ops import _kernels

    eng = engine(kv_blocks=pressure_pool(prompts, PRESSURE_NEW),
                 kv_swap=kv_swap, kv_dtype=kv_dtype, pipeline_depth=depth,
                 decode_steps=steps)
    capture_s = eng.capture_programs()
    rec = instrument(eng)
    torch.cuda.synchronize()
    replays0 = eng.ticks_dispatched
    _kernels.paged_decode.launches = 0          # the main path's count
    t0 = time.perf_counter()
    rids = [eng.submit(p, PRESSURE_NEW) for p in prompts]
    served = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.paged_decode.launches
    replays = eng.ticks_dispatched - replays0
    replayed = eng.replayed_tokens
    want = L * (steps * replays + replayed)
    if launches != want:
        raise AssertionError(
            f"paged launches {launches} != n_layers x (T x replays + "
            f"replayed tokens) = {L} x ({steps} x {replays} + {replayed})")
    pre = eng.kv_stats()["preempts"]
    mode = "swap" if kv_swap else "recompute"
    if pre[mode] < 2:
        raise AssertionError(f"{pre[mode]} {mode} preemptions (want >= 2)")
    if kv_swap and replayed:
        raise AssertionError("a swap resume replayed tokens")
    if eng._alloc.used_count or eng._deferred or any(eng._tables):
        raise AssertionError("pool not balanced after the drain")
    seqs = [served[r] for r in rids]
    del eng
    return {"kv_swap": kv_swap, "kv_dtype": kv_dtype,
            "pipeline_depth": depth, "decode_steps": steps,
            "pool_blocks": pressure_pool(prompts, PRESSURE_NEW),
            "preempts": pre, "kernel_launches": launches,
            "graph_replays": replays, "replayed_tokens": replayed,
            "capture_s": capture_s, "wall_s": wall,
            "swap_payload_bytes": rec["payload_bytes"],
            "swap_out_ms": rec["swap_out_ms"], "swap_in_ms": rec["swap_in_ms"],
            "resume_ms": rec["replay_ms"],
            "resume_ms_per_token": [ms / max(1, n) for ms, n in zip(
                rec["replay_ms"], rec["replay_tokens"])],
            "seqs": seqs}


def restart_run(engine, prompts, L: int) -> dict:
    """(l.3) Phase (e)'s 8 greedy prompts through ``ServingLoop`` with an
    engine factory (swap capture), a ``FaultInjector`` error raised at
    the 10th tick's dispatch: every request finishes exactly once;
    returns the sequences, the resumed-by-mode counters, the recovery
    seconds and the kernel's launches over the run."""
    import threading

    from nos_tpu_torch.cmd.server import OUTCOMES, ServingLoop
    from nos_tpu_torch.models.supervision import FaultInjector
    from nos_tpu_torch.ops import _kernels
    from nos_tpu_torch.utils.metrics import default_registry

    inj = FaultInjector(schedule={10: "error"})
    built = []

    def factory():
        eng = engine()
        built.append(eng)
        return inj.wrap(eng)

    first = factory()
    built[0].capture_programs()
    quiet_histograms()
    loop = ServingLoop(first, engine_factory=factory, restart_budget=1,
                       restart_backoff_s=0.0)
    counter = default_registry().counter(
        "nos_tpu_serve_requests_total", "", ("outcome",))
    before = {o: counter.value(o) for o in OUTCOMES}
    outs, errors = {}, []

    def client(i):
        try:
            outs[i] = loop.generate(prompts[i], HANDOFF_NEW, timeout=600)
        except BaseException as e:
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    _kernels.paged_decode.launches = 0          # the main path's count
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        launches = _kernels.paged_decode.launches
        if errors or len(outs) != len(prompts):
            raise AssertionError(f"restart clients failed: {errors}")
        sup = loop._sup.stats()
        delta = {o: counter.value(o) - before[o] for o in OUTCOMES}
        if sup["restarts"] != 1 or sup["lost"] or delta["finished"] != \
                len(prompts) or sum(delta.values()) != len(prompts):
            raise AssertionError(f"restart: {sup}, outcomes {delta}")
        if sup["resumed"]["swap"] < 1:
            raise AssertionError(f"no swap resume: {sup['resumed']}")
        replays = sum(e.ticks_dispatched for e in built)
        warmups = built[1].compiles
        want = L * (replays + warmups)
        if launches != want:
            raise AssertionError(
                f"paged launches {launches} != n_layers x (replays + "
                f"capture warm-ups) = {L} x ({replays} + {warmups})")
        return {"seqs": [outs[i] for i in range(len(prompts))],
                "restarts": sup["restarts"], "resumed": sup["resumed"],
                "lost": sup["lost"],
                "recovery_s": [e["mttr_s"] for e in sup["episodes"]],
                "injected": inj.injected[0]["tick"],
                "kernel_launches": launches, "graph_replays": replays,
                "capture_warmups": warmups}
    finally:
        loop.shutdown()


def handoff_pair(engine, prompts, L: int) -> dict:
    """(l.4) A prefill-role and a decode-role replica (``ServingLoop`` +
    ``make_http_server`` on 127.0.0.1, one process, one set of weights):
    phase (e)'s greedy prompts POSTed to the prefill replica come back
    as handoff descriptors; the decode replica's /v1/result gives each
    request's tokens. Returns them, the handoff bytes, the capture+ship
    ms per handoff and the decode replica's paged launches."""
    import threading

    from nos_tpu_torch.cmd.server import (
        ServerConfig, ServingLoop, make_http_server,
    )
    from nos_tpu_torch.ops import _kernels

    quiet_histograms()
    cfg = dict(bf16=True, kv_blocks=1 + 8 * 128, kv_block_size=16,
               max_batch=8, port=0, **FULL)
    dec_eng = engine(role="decode")
    dec_eng.capture_programs()
    dec = ServingLoop(dec_eng, role="decode")
    dec_httpd = make_http_server(ServerConfig(role="decode", **cfg), dec,
                                 host="127.0.0.1")
    threading.Thread(target=dec_httpd.serve_forever, daemon=True).start()
    dec_url = f"http://127.0.0.1:{dec_httpd.server_address[1]}"

    def send(target, data):
        status, raw = http_call(target, "/v1/handoff", data)
        if status != 200:
            raise RuntimeError(f"handoff push: {status} {raw[:200]}")
        return int(json.loads(raw)["rid"])

    pre_eng = engine(role="prefill")
    pre = ServingLoop(pre_eng, role="prefill", handoff_targets=[dec_url],
                      handoff_send=send)
    pre_httpd = make_http_server(
        ServerConfig(role="prefill", decode_pool=dec_url, **cfg), pre,
        host="127.0.0.1")
    threading.Thread(target=pre_httpd.serve_forever, daemon=True).start()
    pre_url = f"http://127.0.0.1:{pre_httpd.server_address[1]}"
    try:
        replays0 = dec_eng.ticks_dispatched
        n0, s0 = pre.h_handoff.observations()
        _kernels.paged_decode.launches = 0      # the main path's count
        descs, seqs = [], []
        for p in prompts:
            status, raw = http_call(pre_url, "/v1/generate",
                                    {"prompt": p,
                                     "max_new_tokens": HANDOFF_NEW})
            if status != 200:
                raise AssertionError(f"prefill replica: {status} {raw}")
            descs.append(json.loads(raw)["handoff"])
        for d in descs:
            if d["target"] != dec_url:
                raise AssertionError(f"handoff target {d}")
            status, raw = http_call(dec_url, f"/v1/result/{d['rid']}")
            if status != 200:
                raise AssertionError(f"decode replica: {status} {raw}")
            seqs.append(json.loads(raw)["tokens"])
        torch.cuda.synchronize()
        launches = _kernels.paged_decode.launches
        replays = dec_eng.ticks_dispatched - replays0
        if launches != L * replays:
            raise AssertionError(f"decode replica: paged launches "
                                 f"{launches} != {L} x {replays} replays")
        n1, s1 = pre.h_handoff.observations()
        st = pre_eng.stats()["handoff"]
        return {"seqs": seqs, "handoffs": st["total"],
                "payload_bytes_bf16": st["payload_bytes"],
                "capture_ms_per_handoff": st["capture_s"] * 1e3
                / max(1, st["total"]),
                "capture_and_ship_ms_per_handoff": (s1 - s0) * 1e3
                / max(1, n1 - n0),
                "kernel_launches": launches, "graph_replays": replays}
    finally:
        for httpd, loop in ((pre_httpd, pre), (dec_httpd, dec)):
            httpd.shutdown()
            loop.shutdown()
            httpd.server_close()


def phase_l(seed: int, card: str, served: dict) -> dict:
    """(l): preemption, restart and handoff at phase (e)'s width, every
    engine a ``DecodeServer`` on one set of ``build_engine`` weights;
    ``served`` holds phase (e)'s sequences when (e) ran in this call.
    Returns the paged kernel's launches of each main-path run."""
    import gc

    from nos_tpu_torch.cmd.server import ServerConfig, build_engine
    from nos_tpu_torch.models.serving import DecodeServer

    torch.cuda.empty_cache()
    eng0 = build_engine(ServerConfig(
        bf16=True, kv_blocks=2, kv_block_size=16, max_batch=1,
        paged_kernel="on", seed=seed, **FULL))
    L = FULL["n_layers"]
    prompts = full_width_prompts(seed)
    starts = [len(p) for p in prompts]

    def engine(**kw):
        gc.collect()
        torch.cuda.empty_cache()
        return DecodeServer(eng0.params, eng0.cfg, max_batch=8,
                            kv_block_size=16, device=eng0.device, **{
                                "kv_blocks": 1 + 8 * 128,
                                "paged_impl": "kernel", **kw})

    out = {"phase": "kv_payload", "card": card}
    # l.1: batch invariance of a replayed step, both arenas
    out["batch_invariance"] = []
    for kv_dtype in ("bf16", "int8"):
        eng = engine(kv_swap=False, kv_dtype=kv_dtype)
        eng.capture_programs()
        out["batch_invariance"].append(batch_invariance(eng, prompts))
        del eng
    # a resume whose committed sequence stays in its prompt's bucket (the
    # longest prompt after 6 ticks; seed 0: 881 tokens, bucket 1024),
    # timed graph against eager; then one whose committed sequence has
    # crossed into the next bucket (the prompt nearest below a power of
    # two, 4 ticks past it; seed 0: 103 tokens, 128 -> 256), where a
    # re-prefill of prompt + out[:-1] (the reference's) gave other bits
    # on the H100
    def bucket(n):
        return max(8, 1 << (n - 1).bit_length())

    cross = min((len(p) for p in prompts), key=lambda n: bucket(n) - n)
    out["recompute_probe"] = [
        recompute_probe(engine, prompts, max(len(p) for p in prompts), 6,
                        eager=True),
        recompute_probe(engine, prompts, cross, bucket(cross) - cross + 4,
                        eager=False)]
    # victims admitted through a prefix hit and in chunks (ROADMAP C.12)
    out["admission_probe"] = [
        admission_probe(engine, kind, kv_dtype, seed)
        for kind in ("hit", "chunked") for kv_dtype in ("bf16", "int8")]
    # l.2: the undisturbed runs, then pressure
    undisturbed = {}
    for kv_dtype in ("bf16", "int8"):
        eng = engine(kv_dtype=kv_dtype)
        eng.capture_programs()
        rids = [eng.submit(p, PRESSURE_NEW) for p in prompts]
        res = eng.drain()
        undisturbed[kv_dtype] = [res[r] for r in rids]
        del eng
    for key, kv_dtype in (("greedy", "bf16"), ("int8_greedy", "int8")):
        if key in served:
            head = [s[:n + 32] for s, n in zip(undisturbed[kv_dtype], starts)]
            if head != served[key]:
                raise AssertionError(f"undisturbed {kv_dtype} run differs "
                                     f"from phase (e)'s tokens")
    points, launches = [], {}
    for kv_swap, kv_dtype, depth, steps in PRESSURE_POINTS:
        r = pressure_run(engine, prompts, kv_swap, kv_dtype, depth, steps, L)
        seqs = r.pop("seqs")
        ref = undisturbed[kv_dtype]
        r["agreement_with_undisturbed"] = agreement(seqs, ref, starts)
        r["tokens_equal_undisturbed"] = seqs == ref
        if kv_swap and not r["tokens_equal_undisturbed"]:
            raise AssertionError(
                f"swap resume at {kv_dtype} ({depth}, {steps}): tokens "
                f"differ from the undisturbed run")
        r["tokens_sha256"] = token_digest(seqs)
        points.append(r)
        launches[f"{'swap' if kv_swap else 'recompute'}_{kv_dtype}_depth"
                 f"{depth}_T{steps}"] = r["kernel_launches"]
    out["pressure"] = points
    out["undisturbed_sha256"] = {k: token_digest(v)
                                 for k, v in undisturbed.items()}
    b16 = [sum(r["swap_payload_bytes"]) for r in points
           if r["kv_swap"] and r["kv_dtype"] == "bf16"]
    q8 = [sum(r["swap_payload_bytes"]) for r in points
          if r["kv_swap"] and r["kv_dtype"] == "int8"]
    # l.3: supervised restart, swap capture
    head = [s[:n + HANDOFF_NEW] for s, n in zip(undisturbed["bf16"], starts)]
    restart = restart_run(engine, prompts, L)
    if restart.pop("seqs") != head:
        raise AssertionError("supervised restart (swap): tokens differ from "
                             "the undisturbed run")
    out["restart"] = dict(restart, tokens_equal_undisturbed=True)
    # l.4: handoff over HTTP; the int8 payload's bytes from a prefill-role
    # engine alone
    hand = handoff_pair(engine, prompts, L)
    if hand.pop("seqs") != head:
        raise AssertionError("handoff: tokens differ from the undisturbed "
                             "run")
    eng = engine(role="prefill", kv_dtype="int8")
    for p in prompts:
        eng.submit(p, HANDOFF_NEW)
    eng.pop_handoffs()
    hand["payload_bytes_int8"] = eng.handoff_payload_bytes
    hand["int8_over_bf16_bytes"] = eng.handoff_payload_bytes \
        / hand["payload_bytes_bf16"]
    del eng
    out["handoff"] = dict(hand, tokens_equal_undisturbed=True)
    out["swap_payload_int8_over_bf16"] = (
        sum(q8) / sum(b16) if b16 and q8 and sum(b16) else None)
    emit(out)
    del eng0
    gc.collect()
    torch.cuda.empty_cache()
    launches["restart"] = restart["kernel_launches"]
    launches["handoff_decode"] = hand["kernel_launches"]
    return launches


# phase (m): the reference bench's kv_fabric_section (bench_serve.py
# :1016-1120, its KF_* constants at :164-171) at phase (e)'s width
KF_SYS = 4                  # system prompts, zipf popularity
KF_ZIPF_S = 1.1
KF_SUFFIX = 64              # unique suffix tokens a request
KF_NEW = 32
KF_REQUESTS = 24
KF_CACHE_CHAINS = 1         # prefix-cache budget: every switch evicts
# the reference sizes its host tier to hold every chain the trace
# demotes; at this width that is the 4 system chains (128 MiB each in
# bf16) and the 24 request chains (136 MiB each: every request publishes
# its prompt), 3.7 GiB in bf16
KF_HOST_BYTES = 4 << 30
FABRIC_TOKEN = "chip-smoke-fabric"
TENANT_NEW = 64
TENANT_TICKS = 8


def fabric_trace(seed: int) -> tuple:
    """(system prompts, [(system index, suffix)] x KF_REQUESTS)."""
    rng = np.random.default_rng(seed + 17)
    systems = [rng.integers(1, FULL["vocab"], size=PREFIX_LEN).tolist()
               for _ in range(KF_SYS)]
    w = np.array([1.0 / (r + 1) ** KF_ZIPF_S for r in range(KF_SYS)])
    picks = rng.choice(KF_SYS, size=KF_REQUESTS, p=w / w.sum())
    return systems, [(int(i), rng.integers(1, FULL["vocab"],
                                           size=KF_SUFFIX).tolist())
                     for i in picks]


def link_rate(nbytes: int) -> dict:
    """The link's rate for ``nbytes``: a plain pinned ``copy_`` each way,
    CUDA events around 5 copies after a warm-up, GB/s; beside it the
    host copies a staged payload makes (best of 5, host clock): pinned
    out to fresh pageable memory by numpy (one thread) and by torch (the
    intra-op threads), and pageable into pinned by both."""
    host = torch.empty((nbytes,), dtype=torch.uint8, pin_memory=True)
    dev = torch.empty((nbytes,), dtype=torch.uint8, device="cuda")
    out = {"bytes": nbytes}
    src = np.random.default_rng(0).integers(0, 255, nbytes, dtype=np.uint8)
    for name, fn in (
            ("out_numpy", lambda: np.array(host.numpy())),
            ("out_torch", lambda: torch.empty(nbytes, dtype=torch.uint8)
             .copy_(host)),
            ("in_numpy", lambda: host.numpy().__setitem__(slice(None), src)),
            ("in_torch", lambda: host.copy_(torch.from_numpy(src)))):
        best = []
        for _ in range(5):
            t = time.perf_counter()
            fn()
            best.append(time.perf_counter() - t)
        out[f"host_{name}_gb_s"] = nbytes / min(best) / 1e9
    for name, dst, src in (("h2d", dev, host), ("d2h", host, dev)):
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(5):
            dst.copy_(src, non_blocking=True)
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b) / 5
        out[f"{name}_ms"] = ms
        out[f"{name}_gb_s"] = nbytes / ms / 1e6
    return out


def chain_copies(eng, reps: int = 5) -> dict:
    """A resident chain's copies across the link, as a demotion and a
    promotion make them, each timed alone after a sync: down (into a
    pinned slab, then out to pageable memory on the staging worker, until
    its event is set) and up (into a slab, then to fresh blocks, until
    the device is done); ms and bytes a chain."""
    from nos_tpu_torch.models.staging import READY

    _key, chain = eng._pindex.chain_items()[-1]
    rec = {"down_ms": [], "up_ms": [], "bytes": []}
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        planes, ready = eng._swap_download(list(chain)).arrays_later()
        ready.wait()
        rec["down_ms"].append((time.perf_counter() - t) * 1e3)
        swap = {"nblk": len(chain), **planes, READY: ready}
        rec["bytes"].append(sum(int(a.nbytes) for a in planes.values()))
        fresh = eng._alloc.alloc_many(len(chain))
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng._restore_blocks(swap, fresh)
        torch.cuda.synchronize()
        rec["up_ms"].append((time.perf_counter() - t) * 1e3)
        for b in fresh:
            eng._alloc.decref(b)
    return rec


def rate_summary(ms: list, nbytes: list) -> dict:
    if not ms:
        return {"n": 0}
    gbs = [b / m / 1e6 for m, b in zip(ms, nbytes)]
    return {"n": len(ms), "ms_min": min(ms), "ms_max": max(ms),
            "ms_p50": float(np.median(ms)), "bytes": nbytes[0],
            "gb_s_min": min(gbs), "gb_s_max": max(gbs),
            "gb_s_p50": float(np.median(gbs))}


def fabric_arm(engine, systems, trace, kv_dtype: str, tiered: bool,
               cache_chains: int, blocks: int, L: int) -> tuple:
    """(m.1) One arm of the bench: the system prompts published once
    (warm, outside the trace), then the trace one request at a time with
    ``cache_prefix``; prefill tokens, TTFT from each request's ledger,
    the tier counters, the copies' ms and GB/s, and the paged kernel's
    own count over the trace, which must be n_layers x (replays +
    in-arena windows). Returns (record, outputs)."""
    from nos_tpu_torch.kvfabric import HostTierStore
    from nos_tpu_torch.ops import _kernels

    eng = engine(max_batch=2, kv_blocks=blocks, kv_dtype=kv_dtype,
                 prefix_cache_size=cache_chains,
                 host_tier=HostTierStore(KF_HOST_BYTES) if tiered else None)
    # the warm publishes capture the greedy program at their first tick
    for sp in systems:
        eng.submit(sp + [1], 2, cache_prefix=True)
        eng.drain()
    eng.drain_ledgers()
    torch.cuda.synchronize()
    replays0, windows0 = eng.ticks_dispatched, eng.arena_windows
    _kernels.paged_decode.launches = 0          # the main path's count
    prefill, ttft, outputs = [], [], []
    t0 = time.perf_counter()
    for si, suffix in trace:
        prompt = systems[si] + suffix
        saved0 = eng.prefix_tokens_saved
        rid = eng.submit(prompt, KF_NEW, cache_prefix=True)
        outputs.append(eng.drain()[rid])
        ttft.append(eng.pop_ledger(rid)["ttft_s"] * 1e3)
        prefill.append(len(prompt) - (eng.prefix_tokens_saved - saved0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.paged_decode.launches
    replays = eng.ticks_dispatched - replays0
    windows = eng.arena_windows - windows0
    if launches != L * (replays + windows):
        raise AssertionError(f"fabric arm: paged launches {launches} != "
                             f"{L} x ({replays} + {windows})")
    snap = eng.prefix_index_snapshot()
    rec = chain_copies(eng) if tiered else {"down_ms": [], "up_ms": [],
                                            "bytes": []}
    out = {"kv_dtype": kv_dtype, "tiered": tiered,
           "pool_blocks": blocks, "prefix_cache_blocks": cache_chains,
           "prefill_tokens": sum(prefill),
           "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_p99": float(np.percentile(ttft, 99)),
           "prefix_hits": eng.prefix_hits, "evicted": snap["evicted"],
           "fabric": snap["fabric"],
           "host_tier": None if snap["host_tier"] is None else {
               k: snap["host_tier"][k] for k in ("chains", "bytes")},
           "demote_copy": rate_summary(rec["down_ms"], rec["bytes"]),
           "promote_copy": rate_summary(rec["up_ms"], rec["bytes"]),
           "staging": dict(eng._staging.counts,
                           pinned_bytes=eng._staging.pinned_bytes),
           "wall_s": wall, "kernel_launches": launches,
           "graph_replays": replays, "arena_windows": windows}
    del eng
    return out, outputs


def phase_m1(engine, seed: int, L: int) -> dict:
    """(m.1) The host tier: tiered, drop and no-pressure arms in int8
    and bf16; the tiered arm's tokens must equal the no-pressure arm's.
    Beside them the link's rate for a chain's bytes, and phase (l.2)'s
    two swap points at (1, 1) again (swap-in ms through the staging)."""
    from nos_tpu_torch.models.kvblocks import blocks_for

    bs = 16
    systems, trace = fabric_trace(seed)
    sys_blocks = PREFIX_LEN // bs
    suffix_blocks = blocks_for(KF_SUFFIX, bs)
    per_req = blocks_for(PREFIX_LEN + KF_SUFFIX + KF_NEW, bs) + 1
    pool = 4 * per_req
    big_pool = (KF_SYS * (sys_blocks + 1) + KF_REQUESTS * (suffix_blocks + 1)
                + 4 * per_req)
    big_cache = KF_SYS * sys_blocks + KF_REQUESTS * (sys_blocks
                                                    + suffix_blocks)
    out = {"trace": {"requests": KF_REQUESTS, "system_prompts": KF_SYS,
                     "system_prompt_tokens": PREFIX_LEN,
                     "zipf_s": KF_ZIPF_S, "suffix_tokens": KF_SUFFIX,
                     "new_tokens": KF_NEW,
                     "prefix_cache_blocks": KF_CACHE_CHAINS,
                     "pool_blocks": pool, "host_tier_bytes": KF_HOST_BYTES},
           "arms": {}}
    launches = {}
    for kv_dtype in ("int8", "bf16"):
        tiered, t_out = fabric_arm(engine, systems, trace, kv_dtype, True,
                                   KF_CACHE_CHAINS, pool, L)
        drop, d_out = fabric_arm(engine, systems, trace, kv_dtype, False,
                                 KF_CACHE_CHAINS, pool, L)
        nopress, n_out = fabric_arm(engine, systems, trace, kv_dtype, False,
                                    big_cache, big_pool, L)
        tiered["bit_exact_vs_no_pressure"] = t_out == n_out
        drop["bit_exact_vs_no_pressure"] = d_out == n_out
        if not tiered["bit_exact_vs_no_pressure"]:
            raise AssertionError(f"m.1 {kv_dtype}: the tiered arm's tokens "
                                 f"differ from the no-pressure arm's")
        if not tiered["fabric"]["promote"]:
            raise AssertionError(f"m.1 {kv_dtype}: nothing was promoted")
        out["arms"][kv_dtype] = {"tiered": tiered, "drop": drop,
                                 "no_pressure": nopress,
                                 "tokens_sha256": token_digest(t_out)}
        launches[f"host_tier_{kv_dtype}"] = tiered["kernel_launches"]
    chain = out["arms"]["bf16"]["tiered"]["promote_copy"].get("bytes") \
        or 2 * 32 * 8 * 16 * 128 * 2 * sys_blocks
    out["link"] = link_rate(int(chain))
    prompts = full_width_prompts(seed)

    def pressure_engine(**kw):
        return engine(max_batch=8, **kw)

    out["swap_points"] = []
    for kv_dtype in ("bf16", "int8"):
        r = pressure_run(pressure_engine, prompts, True, kv_dtype, 1, 1, L)
        r.pop("seqs")
        out["swap_points"].append({k: r[k] for k in (
            "kv_dtype", "preempts", "swap_payload_bytes", "swap_out_ms",
            "swap_in_ms", "kernel_launches")})
        launches[f"swap_{kv_dtype}"] = r["kernel_launches"]
    return out, launches


def first_frame_ms(url: str, body: dict, headers: dict) -> tuple:
    """(ms to the first SSE frame, every token) of one streamed POST."""
    import urllib.request

    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps({**body, "stream": True})
        .encode(), headers={"Content-Type": "application/json", **headers},
        method="POST")
    t0 = time.perf_counter()
    first, toks = None, []
    with urllib.request.urlopen(req, timeout=300) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                return first, toks
            frame = json.loads(payload)
            if "error" in frame:
                raise AssertionError(f"SSE error frame: {frame['error']}")
            if first is None:
                first = (time.perf_counter() - t0) * 1e3
            toks.extend(frame["tokens"])
    raise AssertionError("SSE stream ended without [DONE]")


def phase_m2(engine, seed: int, L: int) -> dict:
    """(m.2) The fabric: replicas A and B (``ServingLoop`` +
    ``make_http_server`` on 127.0.0.1, one set of weights, one fabric
    token, tenants gold and bronze with scoped chains). A publishes the
    system prompt for gold; B gets phase (k)'s 8 shared requests as
    gold, each offering A's chain in ``kv_sources``: one alone, 4 at
    once (one pull: single-flight), the rest in turn; an offer without
    the token counts ``pull_denied``, a bronze request offered gold's
    chain is refused at ingest. B's tokens must equal A's for the same
    prompts; B's TTFT with the pull beside a replica without it."""
    import threading

    from nos_tpu_torch.cmd.server import (
        ServerConfig, ServingLoop, make_http_server,
    )
    from nos_tpu_torch.kvfabric import FABRIC_TOKEN_HEADER, chain_digest
    from nos_tpu_torch.models.tenantquota import TenantQuotaConfig
    from nos_tpu_torch.ops import _kernels

    quiet_histograms()
    system, suffixes = prefix_traffic(seed)
    spec = '{"tenants": {"gold": {}, "bronze": {}}}'
    cfg = dict(bf16=True, kv_blocks=1 + 8 * 128, kv_block_size=16,
               max_batch=8, port=0, prefix_cache_size=PREFIX_LEN // 16,
               kv_fabric_token=FABRIC_TOKEN, tenant_config=spec, **FULL)
    reps = []

    def replica(token=FABRIC_TOKEN):
        tq = TenantQuotaConfig.from_json(spec)
        eng = engine(prefix_cache_size=PREFIX_LEN // 16, tenant_quota=tq)
        eng.capture_programs()
        loop = ServingLoop(eng, tenant_quota=tq, fabric_token=token)
        httpd = make_http_server(ServerConfig(**cfg), loop, host="127.0.0.1")
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        reps.append((httpd, loop))
        return eng, loop, f"http://127.0.0.1:{httpd.server_address[1]}"

    try:
        eng_a, loop_a, url_a = replica()
        eng_b, loop_b, url_b = replica()
        eng_c, _, url_c = replica()
        status, raw = http_call(url_a, "/v1/generate", {
            "prompt": system, "max_new_tokens": 2, "cache_prefix": True,
            "tenant": "gold"})
        if status != 200:
            raise AssertionError(f"replica A: {status} {raw}")
        digest = chain_digest(system, "gold")
        offer = [{"url": f"{url_a}/v1/kvchain/{digest}", "digest": digest,
                  "len": PREFIX_LEN}]
        tok = {FABRIC_TOKEN_HEADER: FABRIC_TOKEN}
        fetch, ingest = [], []
        real_fetch, real_ingest = loop_b._fetch_chain_bytes, \
            eng_b.ingest_chain

        def timed_fetch(*a, **kw):
            t = time.perf_counter()
            data = real_fetch(*a, **kw)
            fetch.append(((time.perf_counter() - t) * 1e3, len(data)))
            return data

        def timed_ingest(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ok = real_ingest(*a, **kw)
            torch.cuda.synchronize()
            ingest.append(((time.perf_counter() - t) * 1e3, ok))
            return ok

        loop_b._fetch_chain_bytes = timed_fetch
        eng_b.ingest_chain = timed_ingest
        prompts = [system + s for s in suffixes]
        body = [{"prompt": p, "max_new_tokens": PREFIX_NEW,
                 "tenant": "gold", "kv_sources": offer} for p in prompts]
        # the refusals first: no token (never fetched), and a bronze
        # requester offered gold's chain (fetched, refused at ingest)
        http_call(url_b, "/v1/generate", dict(body[0], max_new_tokens=2))
        denied = loop_b.stats()["kv_fabric_pulls"]["pull_denied"]
        import urllib.request
        req = urllib.request.Request(
            url_b + "/v1/generate", data=json.dumps(dict(
                body[0], max_new_tokens=2, tenant="bronze")).encode(),
            headers={"Content-Type": "application/json", **tok},
            method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            r.read()
        refused = eng_b._fabric["ingest_rejected"]
        if denied != 1 or refused != 1:
            raise AssertionError(f"m.2 refusals: pull_denied {denied}, "
                                 f"ingest_rejected {refused}")
        eng_b.drain_ledgers()
        torch.cuda.synchronize()
        replays0, windows0 = eng_b.ticks_dispatched, eng_b.arena_windows
        _kernels.paged_decode.launches = 0      # the main path's count
        ttft, seqs = [None] * 8, [None] * 8

        def client(i):
            ttft[i], seqs[i] = first_frame_ms(url_b, body[i], tok)

        client(0)
        gate = threading.Barrier(4)

        def burst(i):
            gate.wait(timeout=60)
            client(i)

        threads = [threading.Thread(target=burst, args=(i,))
                   for i in range(1, 5)]
        # the first request's pull landed the chain: evict it so the
        # burst of 4 meets a cold prefix and rides one pull
        with loop_b._work:
            eng_b._pindex.clear()
        fetches0 = len(fetch)
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        burst_fetches = len(fetch) - fetches0
        for i in range(5, 8):
            client(i)
        torch.cuda.synchronize()
        launches = _kernels.paged_decode.launches
        replays = eng_b.ticks_dispatched - replays0
        windows = eng_b.arena_windows - windows0
        if launches != L * (replays + windows):
            raise AssertionError(f"replica B: paged launches {launches} != "
                                 f"{L} x ({replays} + {windows})")
        if burst_fetches != 1:
            raise AssertionError(f"m.2: the 4 concurrent requests made "
                                 f"{burst_fetches} fetches (want 1)")
        want = []
        for p in prompts:
            status, raw = http_call(url_a, "/v1/generate", {
                "prompt": p, "max_new_tokens": PREFIX_NEW,
                "tenant": "gold"})
            want.append(json.loads(raw)["tokens"])
        if [list(p) + s for p, s in zip(prompts, seqs)] != want:
            raise AssertionError("m.2: replica B's tokens differ from A's")
        cold = []
        for i in range(8):
            ms, toks = first_frame_ms(url_c, {
                "prompt": prompts[i], "max_new_tokens": PREFIX_NEW,
                "tenant": "gold"}, {})
            cold.append(ms)
        pulls = loop_b.stats()["kv_fabric_pulls"]
        return {"pulls": pulls, "fabric_b": dict(eng_b._fabric),
                "fetches": len(fetch), "burst_requests": 4,
                "burst_fetches": burst_fetches,
                "riders_per_leader": 4 / burst_fetches - 1,
                "bytes_pulled": sum(n for _, n in fetch),
                "fetch_ms": [ms for ms, _ in fetch],
                "ingest_ms": [ms for ms, ok in ingest if ok],
                "ttft_ms_with_pull_p50": float(np.percentile(ttft, 50)),
                "ttft_ms_with_pull_p99": float(np.percentile(ttft, 99)),
                "ttft_ms_without_p50": float(np.percentile(cold, 50)),
                "ttft_ms_without_p99": float(np.percentile(cold, 99)),
                "tokens_equal_a": True, "kernel_launches": launches,
                "graph_replays": replays, "arena_windows": windows}
    finally:
        for httpd, loop in reps:
            httpd.shutdown()
            loop.shutdown()
            httpd.server_close()


def tenant_run(engine, prompts, gold, kv_swap: bool, L: int,
               reclaim: bool) -> dict:
    """(m.3) Bronze fills the 8 slots with ``prompts`` x TENANT_NEW; after
    TENANT_TICKS ticks (on the injected tenant clock, 0.1 s a tick) two
    gold requests arrive (``reclaim``); runs to the end. Returns bronze's
    sequences, the reclaims, gold's TTFT from the ledgers and the paged
    kernel's own count, which must be n_layers x (T x replays + replayed
    tokens)."""
    from nos_tpu_torch.models.tenantquota import TenantQuotaConfig
    from nos_tpu_torch.ops import _kernels

    clock = [0.0]
    tq = TenantQuotaConfig.from_json(
        '{"tenants": {"gold": {"min_rate": 100000}, '
        '"bronze": {"max_rate": 400}}, "window_s": 4.0}')
    eng = engine(kv_swap=kv_swap, tenant_quota=tq,
                 tenant_clock=lambda: clock[0])
    eng.capture_programs()
    torch.cuda.synchronize()
    replays0 = eng.ticks_dispatched
    _kernels.paged_decode.launches = 0          # the main path's count
    rids = [eng.submit(p, TENANT_NEW, tenant="bronze") for p in prompts]
    grids = []
    for tick in range(10 ** 6):
        if not eng.has_work():
            break
        if reclaim and tick == TENANT_TICKS:
            grids = [eng.submit(g, TENANT_NEW, tenant="gold") for g in gold]
        eng.step()
        clock[0] += 0.1
    served = eng.drain()
    torch.cuda.synchronize()
    launches = _kernels.paged_decode.launches
    replays = eng.ticks_dispatched - replays0
    want = L * (replays + eng.replayed_tokens)
    if launches != want:
        raise AssertionError(f"tenant run: paged launches {launches} != "
                             f"{L} x ({replays} + {eng.replayed_tokens})")
    led = [eng.pop_ledger(r) for r in grids]
    out = {"kv_swap": kv_swap, "reclaims": eng.tenant_reclaims,
           "preempts": eng.kv_stats()["preempts"],
           "resume_paths": dict(eng.resume_paths),
           "gold_ttft_ms": [x["ttft_s"] * 1e3 for x in led],
           "kernel_launches": launches, "graph_replays": replays,
           "replayed_tokens": eng.replayed_tokens,
           "tenants": eng.tenant_snapshot(),
           "seqs": [served[r] for r in rids]}
    del eng
    return out


def tenant_binary(engine) -> dict:
    """(m.3, through the binary) A ``ServingLoop`` with tenants (gold
    with SLO objectives, bronze with a max) behind ``make_http_server``:
    bronze over its max on an idle engine is served, then with 8 gold
    requests decoding it gets 429 ``reason: tenant_quota``; /stats has
    ``tenants``, ``slo_budget`` and ``chip_ledger``, and the ledger's
    per-tenant milliseconds add up to its span."""
    import threading

    from nos_tpu_torch.cmd.server import (
        ServerConfig, ServingLoop, make_http_server,
    )
    from nos_tpu_torch.models.tenantquota import TenantQuotaConfig

    quiet_histograms()
    spec = ('{"tenants": {"gold": {"slo": {"ttft_p99_ms": 2000, '
            '"tpot_p99_ms": 200}}, "bronze": {"max_rate": 10}}, '
            '"window_s": 4.0}')
    tq = TenantQuotaConfig.from_json(spec)
    eng = engine(tenant_quota=tq)
    eng.capture_programs()
    loop = ServingLoop(eng, tenant_quota=tq)
    httpd = make_http_server(ServerConfig(
        bf16=True, kv_blocks=1 + 8 * 128, kv_block_size=16, max_batch=8,
        port=0, tenant_config=spec, **FULL), loop, host="127.0.0.1")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    rng = np.random.default_rng(404)

    def body(tenant, n):
        return {"prompt": rng.integers(1, FULL["vocab"], size=64).tolist(),
                "max_new_tokens": n, "tenant": tenant}

    try:
        # 64 tokens in a 4 s window put bronze over its max of 10/s; an
        # idle engine still serves its next request
        idle = [http_call(url, "/v1/generate", body("bronze", 64))[0]]
        over = json.loads(http_call(url, "/stats")[1])["tenants"][
            "bronze"]["over_max"]
        idle.append(http_call(url, "/v1/generate", body("bronze", 8))[0])
        if idle != [200, 200] or not over:
            raise AssertionError(f"idle lending: {idle}, over_max {over}")
        gold = [threading.Thread(target=http_call, args=(
            url, "/v1/generate", body("gold", 256))) for _ in range(8)]
        for t in gold:
            t.start()
        deadline = time.time() + 120
        while time.time() < deadline:
            with loop._work:
                full = not eng._free
            if full:
                break
            time.sleep(0.01)
        status, raw = http_call(url, "/v1/generate", body("bronze", 8))
        reply = json.loads(raw)
        for t in gold:
            t.join(timeout=300)
        if status != 429 or reply.get("reason") != "tenant_quota":
            raise AssertionError(f"bronze under contention: {status} {reply}")
        stats = json.loads(http_call(url, "/stats")[1])
        block = stats["chip_ledger"]
        per = sum(v for ph in block["chip_ms"].values() for v in ph.values())
        if not (stats["tenants"] and stats["slo_budget"]
                and block["conserved"]
                and abs(per - block["wall_ms"]) < 0.01 * len(
                    block["chip_ms"]) + 1e-6):
            raise AssertionError(f"/stats tenancy sections: {stats['tenants']}"
                                 f" {stats['slo_budget']} {block}")
        return {"idle_bronze_status": idle, "contended_bronze_status": status,
                "contended_bronze_reason": reply["reason"],
                "tenants": stats["tenants"],
                "slo_budget_objectives": len(stats["slo_budget"][
                    "objectives"]),
                "chip_ledger": block, "chip_ms_sum": per}
    finally:
        httpd.shutdown()
        loop.shutdown()
        httpd.server_close()


def phase_m(seed: int, card: str) -> dict:
    """(m): the rest of the KV payload at phase (e)'s width, every engine
    a ``DecodeServer`` on one set of ``build_engine`` weights: (1) the
    host tier, (2) the KV fabric's peer pull between two replicas over
    HTTP, (3) tenant quotas with reclaim, at the engine and through the
    binary. Returns the paged kernel's launches of each main-path run."""
    import gc

    from nos_tpu_torch.cmd.server import ServerConfig, build_engine
    from nos_tpu_torch.models.serving import DecodeServer

    torch.cuda.empty_cache()
    eng0 = build_engine(ServerConfig(
        bf16=True, kv_blocks=2, kv_block_size=16, max_batch=1,
        paged_kernel="on", seed=seed, **FULL))
    L = FULL["n_layers"]

    def engine(**kw):
        gc.collect()
        torch.cuda.empty_cache()
        return DecodeServer(eng0.params, eng0.cfg, kv_block_size=16,
                            device=eng0.device, **{
                                "max_batch": 8, "kv_blocks": 1 + 8 * 128,
                                "paged_impl": "kernel", **kw})

    t0 = time.perf_counter()
    out = {"phase": "kv_fabric_tenants", "card": card}
    out["host_tier"], launches = phase_m1(engine, seed, L)
    out["host_tier_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    out["fabric"] = phase_m2(engine, seed, L)
    launches["fabric_replica_b"] = out["fabric"]["kernel_launches"]
    out["fabric_s"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    prompts = full_width_prompts(seed)
    gold = [p[:256] for p in prompts[:2]]
    base = tenant_run(engine, prompts, gold, True, L, reclaim=False)
    runs = []
    for kv_swap in (True, False):
        r = tenant_run(engine, prompts, gold, kv_swap, L, reclaim=True)
        seqs = r.pop("seqs")
        r["bronze_digests_equal_undisturbed"] = sum(
            token_digest([a]) == token_digest([b])
            for a, b in zip(seqs, base["seqs"]))
        if r["reclaims"] != 2 or r["bronze_digests_equal_undisturbed"] != 8:
            raise AssertionError(
                f"m.3 ({'swap' if kv_swap else 'recompute'}): "
                f"{r['reclaims']} reclaims, "
                f"{r['bronze_digests_equal_undisturbed']}/8 bronze digests "
                f"equal the undisturbed run's")
        runs.append(r)
        launches[f"tenant_{'swap' if kv_swap else 'recompute'}"] = \
            r["kernel_launches"]
    out["tenants"] = {"undisturbed_sha256": token_digest(base["seqs"]),
                      "runs": runs, "binary": tenant_binary(engine)}
    out["tenants_s"] = time.perf_counter() - t2
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    del eng0
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase (n): the slot-static engine and speculative decoding
# ---------------------------------------------------------------------------

SPEC_K = 4
# ServerConfig's own draft widths (draft_d_model 256, 2 layers, 4 heads,
# draft_n_kv_heads 0 = the heads, d_ff 704), the target's vocabulary
DRAFT_W = dict(d_model=256, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=704)
DRAFT_SEED = 1
# the token rule: a greedy divergence between two formulations is taken
# only at a step where the plain run's top-2 logit gap is below this
# (bf16 max|dlogit| between formulations read 0.07-0.09, C.10 and C.12)
GAP_TOL = 0.1
# (n.0): the verify window (B 8, S = n_draft, the target's heads) and
# the draft's step (S 1, head_dim 64: the draft's 256 / 4)
VERIFY = dict(b=8, h=32, h_kv=8, d=128, bs=16, nb=128)
DRAFT_STEP = dict(b=8, h=4, h_kv=4, d=64, bs=16, nb=128)
SPEC_POINTS = [(1, 1), (2, 2)]
SPEC_ARMS = ["paged_bf16", "paged_int8", "static"]


def spec_kernel_cases(seed: int, device, flush) -> dict:
    """(n.0): the paged kernel at the speculative engine's shapes against
    its plain version (``check_kernel``'s pins), bit-identical over two
    launches, each row at its own pos spread over 64-1900: the verify
    window and the draft's S 1 step at head_dim 64, each in bf16 and
    int8 (an int8 engine's draft arena is int8 too); timed beside the
    plain version, SDPA over the gathered timeline and the bound."""
    from nos_tpu_torch.ops import _kernels
    from nos_tpu_torch.ops.attention import paged_decode_attention_reference

    rng = np.random.default_rng(seed + 12)
    rows = {}
    for label, shape, s, int8 in (("verify", VERIFY, SPEC_K, False),
                                  ("verify_int8", VERIFY, SPEC_K, True),
                                  ("draft", DRAFT_STEP, 1, False),
                                  ("draft_int8", DRAFT_STEP, 1, True)):
        pos = np.linspace(64, 1900, shape["b"]).round().astype(np.int32)
        case = paged_case(rng, s=s, int8=int8, dtype=torch.bfloat16,
                          device=device, pos=pos, **shape)

        def launch(case=case, d=shape["d"]):
            return _kernels.paged_decode.launch(
                case["q"], case["k_arena"], case["v_arena"], case["table"],
                case["pos"], k_scale=case["k_scale"],
                v_scale=case["v_scale"], scale=d ** -0.5)

        out = launch()
        row = {"phase": "spec_kernel_vs_plain",
               "kernel": "paged_decode_attention", "case": label, "S": s,
               "arena": "int8" if int8 else "bf16", "compute": "bfloat16",
               **shape, "pos": pos.tolist(),
               "live_tokens": int((case["pos"] + s).sum()),
               "splits": _kernels.paged_splits(
                   shape["b"] * shape["h_kv"] * _kernels.paged_row_tiles(
                       shape["h"] // shape["h_kv"] * s),
                   _kernels._sm_count(device)),
               **check_kernel(out, case)}
        if not torch.equal(launch(), out):
            raise AssertionError(f"paged kernel {label}: two launches "
                                 f"gave different bits")
        row["bit_identical_rerun"] = True
        lib = library_call(case)
        row["ms"] = cuda_ms(launch, 100, flush)
        row["plain_ms"] = cuda_ms(
            lambda: paged_decode_attention_reference(**case), 30, flush)
        row["library_ms"] = cuda_ms(lib, 100, flush)
        row["bound_ms"], row["bound_by"] = paged_bound(case)
        emit(row)
        rows[label] = row
        del case, out
    return rows


def plain_gaps(params, cfg, seq: list) -> torch.Tensor:
    """Top-2 logit gaps of ``seq`` teacher-forced through one
    ``forward_with_cache`` pass: entry p is the gap of the logits that
    choose token p + 1."""
    from nos_tpu_torch.models.generate import forward_with_cache, init_cache

    n = len(seq) - 1
    device = params["final_norm"].device
    cache = init_cache(cfg, 1, n, device=device)
    logits, _ = forward_with_cache(
        params, cfg, torch.tensor([seq[:-1]], device=device), cache)
    top2 = logits[0].topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).float().cpu()


def token_rule(label: str, got: list, plain: list, prompts: list, params,
               cfg, gap_at=None, routing=None) -> dict:
    """Hold greedy sequences to the plain run's: equal, or the first
    differing token sits at a step where the plain run's top-2 logit gap
    (teacher-forced; ``gap_at(prompt, seq, j)`` when given, the gap of
    the logits choosing ``seq[j]``) is below ``GAP_TOL``; prints each
    such step and gap and raises on any other divergence, unless the
    two runs route the MoE differently before it: ``routing(i, step)``
    returns the first routing difference of request i before that step
    (its margins held to ``ROUTER_TOL``), or None."""
    if gap_at is None:
        def gap_at(prompt, seq, j):
            return float(plain_gaps(params, cfg, seq)[j - 1])
    diverged = []
    for i, (g, p) in enumerate(zip(got, plain)):
        if g == p:
            continue
        if len(g) != len(p):
            raise AssertionError(f"{label}: request {i} has {len(g)} "
                                 f"tokens, the plain run {len(p)}")
        j = next(k for k in range(len(p)) if g[k] != p[k])
        step = j - len(prompts[i])
        gap = gap_at(prompts[i], p, j) if step >= 0 else float("inf")
        row = {"request": i, "step": step, "gap": gap, "cause": "near_tie"}
        if step >= 0 and gap >= GAP_TOL and routing:
            flip = routing(i, step)
            if flip:
                row.update(cause="routing", routing=flip)
        if step < 0 or (gap >= GAP_TOL and row["cause"] != "routing"):
            raise AssertionError(
                f"{label}: request {i} diverges at step {step} where the "
                f"plain run's top-2 logit gap is {gap} (>= {GAP_TOL})")
        diverged.append(row)
    return {"equal": len(got) - len(diverged), "of": len(got),
            "near_tie": sum(d["cause"] == "near_tie" for d in diverged),
            "routing": sum(d["cause"] == "routing" for d in diverged),
            "diverged": diverged}


def engine_run(eng, prompts, new: int, sampling=None) -> dict:
    """Phase (e)'s traffic on ``eng`` with its programs captured up
    front: each request prefilled at submit, then the decode drain, timed
    on the host clock ending in a sync; the paged kernel's own launches
    over the run (in all and by shape), ticks, decode tokens and, on a
    speculative engine, proposals and acceptances."""
    from nos_tpu_torch.ops import _kernels

    capture_s = eng.capture_programs()
    torch.cuda.synchronize()
    ticks0, tok0 = eng.ticks_dispatched, eng.tokens_emitted
    d0 = getattr(eng, "spec_drafted", 0)
    a0 = getattr(eng, "spec_accepted", 0)
    _kernels.paged_decode.launches = 0          # the main path's count
    t0 = time.perf_counter()
    rids = [eng.submit(p, new, **(sampling[i] if sampling else {}))
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    t = time.perf_counter()
    served = eng.drain()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    ticks = eng.ticks_dispatched - ticks0
    tokens = eng.tokens_emitted - tok0
    out = {"seqs": [served[r] for r in rids], "capture_s": capture_s,
           "prefill_s": prefill_s, "decode_s": decode_s, "ticks": ticks,
           "decode_tokens": tokens,
           "ms_per_tick": decode_s * 1e3 / max(ticks, 1),
           "tokens_per_s": tokens / decode_s,
           "kernel_launches": _kernels.paged_decode.launches,
           "launches_by_shape": {k: n for k, n in _kernels.paged_decode
                                 .launches_by_shape().items() if n}}
    if hasattr(eng, "spec_drafted"):
        drafted = eng.spec_drafted - d0
        windows = drafted // eng.k
        out.update(drafted=drafted, accepted=eng.spec_accepted - a0,
                   windows=windows,
                   acceptance=(eng.spec_accepted - a0) / max(drafted, 1),
                   tokens_per_window=tokens / max(windows, 1),
                   ms_per_round=decode_s * 1e3 / max(
                       ticks * eng.decode_steps, 1))
    return out


def spec_shape_launches(eng, ticks: int) -> dict:
    """The paged kernel's launches the speculative program implies over
    ``ticks`` dispatches, by launch shape (S, head_dim, arena dtype) as
    ``launches_by_shape`` keys them: T rounds a tick, each k draft steps
    (a launch a draft layer at (1, the draft's head_dim)) and one verify
    window (a launch a target layer at (k, the target's)); the
    slot-static arm launches none."""
    if not eng.paged:
        return {}
    arena = str(eng.cache["k"].dtype)[6:]
    rounds = ticks * eng.decode_steps
    out = {}
    for shape, n in (((eng.k, eng.cfg.head_dim, arena),
                      rounds * eng.cfg.n_layers),
                     ((1, eng.draft_cfg.head_dim, arena),
                      rounds * eng.k * eng.draft_cfg.n_layers)):
        out[shape] = out.get(shape, 0) + n
    return out


def hold_spec_launches(label: str, eng, r: dict) -> None:
    """Hold a speculative run's measured launches, shape by shape, to
    the count its program implies (``spec_shape_launches``)."""
    implied = spec_shape_launches(eng, r["ticks"])
    if r["launches_by_shape"] != implied:
        raise AssertionError(f"{label}: launches by shape "
                             f"{r['launches_by_shape']} != implied {implied}")


def static_restart(make, prompts, plain, params, cfg) -> dict:
    """(n.1) Phase (e)'s greedy prompts through ``ServingLoop`` over a
    slot-static engine with an engine factory and a ``FaultInjector``
    error at the 10th tick: every request finishes once; the restored
    requests resume by re-prefilling their committed sequences
    (``_resume_recompute_static``); tokens held to the undisturbed run's
    by the token rule; the recovery seconds."""
    import threading

    from nos_tpu_torch.cmd.server import ServingLoop
    from nos_tpu_torch.models.supervision import FaultInjector

    inj = FaultInjector(schedule={10: "error"})
    built = []

    def factory():
        eng = make()
        built.append(eng)
        return inj.wrap(eng)

    first = factory()
    built[0].capture_programs()
    quiet_histograms()
    loop = ServingLoop(first, engine_factory=factory, restart_budget=1,
                       restart_backoff_s=0.0)
    outs, errors = {}, []

    def client(i):
        try:
            outs[i] = loop.generate(prompts[i], HANDOFF_NEW, timeout=600)
        except BaseException as e:
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors or len(outs) != len(prompts):
            raise AssertionError(f"restart clients failed: {errors}")
        sup = loop._sup.stats()
        if sup["restarts"] != 1 or sup["lost"] \
                or sup["resumed"]["recompute"] < 1:
            raise AssertionError(f"static restart: {sup}")
        seqs = [outs[i] for i in range(len(prompts))]
        return {"restarts": sup["restarts"], "resumed": sup["resumed"],
                "recovery_s": [e["mttr_s"] for e in sup["episodes"]],
                "tokens_vs_undisturbed": token_rule(
                    "static restart", seqs, plain, prompts, params, cfg),
                "tokens_sha256": token_digest(seqs)}
    finally:
        loop.shutdown()
        del built


def serve_http(eng, bodies: list) -> tuple:
    """``bodies`` POSTed one after another to ``ServingLoop(eng)`` behind
    ``make_http_server`` on 127.0.0.1; returns (token lists, /stats,
    /metrics text)."""
    import threading

    from nos_tpu_torch.cmd.server import (
        ServerConfig, ServingLoop, make_http_server,
    )

    quiet_histograms()
    loop = ServingLoop(eng)
    httpd = make_http_server(ServerConfig(port=0, max_batch=8), loop,
                             host="127.0.0.1")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        toks = []
        for body in bodies:
            status, raw = http_call(url, "/v1/generate", body)
            if status != 200:
                raise AssertionError(f"POST /v1/generate: {status} {raw}")
            toks.append(json.loads(raw)["tokens"])
        _, stats = http_call(url, "/stats")
        _, text = http_call(url, "/metrics")
        return toks, json.loads(stats), text.decode()
    finally:
        httpd.shutdown()
        loop.shutdown()
        httpd.server_close()


def phase_n1(seed: int, card: str, eng0, prompts) -> dict:
    """(n.1): the slot-static engine (``build_engine`` with the
    reference's ``kv_blocks`` 0) at phase (e)'s width and traffic."""
    import gc

    from nos_tpu_torch.models.generate import generate
    from nos_tpu_torch.models.serving import DecodeServer

    params, cfg = eng0.params, eng0.cfg
    new = 32

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    out = {"phase": "static_engine", "card": card}
    # greedy and sampled at (1, 1) on the binary's engine, at (2, 2) on
    # a second; the paged engine on the same weights beside them
    runs = {}
    runs["s11_greedy"] = engine_run(eng0, prompts, new)
    runs["s11_sampled"] = engine_run(eng0, prompts, new, SAMPLED)
    again = engine_run(eng0, prompts, new, SAMPLED)["seqs"]
    if again != runs["s11_sampled"]["seqs"]:
        raise AssertionError("static sampled: a rerun gave other tokens")
    prof_static = profile_ticks(eng0, prompts)
    eng = DecodeServer(params, cfg, max_batch=8, pipeline_depth=2,
                       decode_steps=2, device=eng0.device)
    runs["s22_greedy"] = engine_run(eng, prompts, new)
    runs["s22_sampled"] = engine_run(eng, prompts, new, SAMPLED)
    del eng
    free()
    if runs["s22_greedy"]["seqs"] != runs["s11_greedy"]["seqs"] or \
            runs["s22_sampled"]["seqs"] != runs["s11_sampled"]["seqs"]:
        raise AssertionError("static (2, 2) tokens differ from (1, 1)'s")
    eng = DecodeServer(params, cfg, max_batch=8, kv_blocks=1 + 8 * 128,
                       kv_block_size=16, paged_impl="kernel",
                       device=eng0.device)
    runs["paged_greedy"] = engine_run(eng, prompts, new)
    runs["paged_sampled"] = engine_run(eng, prompts, new, SAMPLED)
    prof_paged = profile_ticks(eng, prompts)
    del eng
    free()
    L = cfg.n_layers
    for key in ("s11_greedy", "s11_sampled", "s22_greedy", "s22_sampled"):
        if runs[key]["kernel_launches"] != 0:
            raise AssertionError(f"static {key} launched the paged kernel")
    for key in ("paged_greedy", "paged_sampled"):
        if runs[key]["kernel_launches"] != L * runs[key]["ticks"]:
            raise AssertionError(f"{key}: launches != n_layers x replays")
    static = runs["s11_greedy"]["seqs"]
    out["tokens_vs_paged"] = token_rule(
        "static vs paged", static, runs["paged_greedy"]["seqs"], prompts,
        params, cfg)
    out["sampled_equal_paged"] = sum(
        a == b for a, b in zip(runs["s11_sampled"]["seqs"],
                               runs["paged_sampled"]["seqs"]))
    # generate (B = 1, eager) for the shortest and the longest prompt
    picks = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))
    picks = [picks[0], picks[-1]]
    gen = [generate(params, cfg, [prompts[i]], new,
                    device=eng0.device)[0].tolist() for i in picks]
    out["tokens_vs_generate"] = token_rule(
        "static vs generate", [static[i] for i in picks], gen,
        [prompts[i] for i in picks], params, cfg)
    out["generate_requests"] = picks
    for key, r in runs.items():
        out[key] = {k: r[k] for k in (
            "ms_per_tick", "ticks", "decode_tokens", "tokens_per_s",
            "prefill_s", "capture_s", "kernel_launches")}
        out[key]["tokens_sha256"] = token_digest(r["seqs"])
    for name, prof, run in (("static", prof_static, runs["s11_greedy"]),
                            ("paged", prof_paged, runs["paged_greedy"])):
        out[f"{name}_profile"] = {
            "kernels_per_tick": prof["kernels_per_tick"],
            "device_busy_ms_per_tick": prof["device_busy_ms_per_tick"],
            "device_idle_share": 1 - prof["device_busy_ms_per_tick"]
            / run["ms_per_tick"],
            "paged_kernels_per_tick": prof["paged_kernels_per_tick"],
            "device_ms": prof["device_ms_per_tick"]}

    # phase (k)'s shared 1024-token prompt through the prefix LRU, and
    # the same requests with the LRU empty
    system, suffixes = prefix_traffic(seed)
    eng0.submit(system, PREFIX_NEW, cache_prefix=True)
    eng0.drain()
    eng0.drain_ledgers()
    hits0, saved0 = eng0.prefix_hits, eng0.prefix_tokens_saved
    lru = {}
    for arm in ("lru", "empty"):
        if arm == "empty":
            eng0._prefixes.clear()
        eng0.drain_ledgers()
        rids = [eng0.submit(system + s, PREFIX_NEW) for s in suffixes]
        res = eng0.drain()
        leds = {led["rid"]: led for led in eng0.drain_ledgers()}
        ttft = sorted(leds[r]["ttft_s"] * 1e3 for r in rids)
        lru[arm] = {"seqs": [res[r] for r in rids],
                    "ttft_p50_ms": ttft[len(ttft) // 2],
                    "ttft_max_ms": ttft[-1]}
    out["prefix_lru"] = {
        "hits": eng0.prefix_hits - hits0,
        "tokens_saved": eng0.prefix_tokens_saved - saved0,
        "ttft_p50_ms": lru["lru"]["ttft_p50_ms"],
        "ttft_p50_ms_without": lru["empty"]["ttft_p50_ms"],
        "ttft_max_ms": lru["lru"]["ttft_max_ms"],
        "ttft_max_ms_without": lru["empty"]["ttft_max_ms"],
        "tokens_vs_without": token_rule(
            "prefix LRU vs none", lru["lru"]["seqs"], lru["empty"]["seqs"],
            [system + s for s in suffixes], params, cfg)}
    if out["prefix_lru"]["hits"] != len(suffixes):
        raise AssertionError(f"prefix LRU hits {out['prefix_lru']}")

    # a supervised restart, and the binary over HTTP
    out["restart"] = static_restart(
        lambda: DecodeServer(params, cfg, max_batch=8, device=eng0.device),
        prompts, static, params, cfg)
    free()
    bodies = [{"prompt": prompts[i], "max_new_tokens": new}
              for i in range(3)]
    toks, stats, _ = serve_http(eng0, bodies)
    if stats["kv"] is not None or stats["engine"] != "DecodeServer":
        raise AssertionError(f"static binary /stats: {stats['kv']}")
    out["http"] = token_rule("static over HTTP", toks, static[:3],
                             prompts[:3], params, cfg)
    emit(out)
    return {"paged_run": runs["paged_greedy"],
            "static_run": runs["s11_greedy"]}


def spec_engine(params, cfg, dparams, dcfg, arm: str, depth: int, T: int,
                **kw):
    from nos_tpu_torch.models.spec_serving import SpeculativeDecodeServer

    if arm != "static":
        kw.update(kv_blocks=1 + 8 * 128, kv_block_size=16,
                  kv_dtype="int8" if arm == "paged_int8" else "bf16",
                  paged_impl="kernel")
    return SpeculativeDecodeServer(
        params, cfg, dparams, dcfg, n_draft=SPEC_K, max_batch=8,
        pipeline_depth=depth, decode_steps=T,
        device=params["final_norm"].device, **kw)


def spec_preempt_fork(eng, prompts, L_d: int, L_t: int) -> dict:
    """(n.2) On a paged speculative engine (kv_swap off, every program
    captured up front): every request sampled, one row preempted after
    three ticks by swap and by recompute, its tokens against the
    undisturbed run's and the kernel's launches against the count the
    code implies (rounds, replayed windows and draft tokens); then a
    greedy fork, its tokens against its source's."""
    from nos_tpu_torch.ops import _kernels

    new = 32
    want = engine_run(eng, prompts, new, SAMPLED)["seqs"]
    out = {}
    for mode in ("swap", "recompute"):
        ticks0, w0, d0 = (eng.ticks_dispatched, eng.replayed_windows,
                          eng.replayed_draft_tokens)
        _kernels.paged_decode.launches = 0
        rids = [eng.submit(p, new, **SAMPLED[i])
                for i, p in enumerate(prompts)]
        for _ in range(3):
            eng.step()
        if not eng.preempt(rids[3], mode):
            raise AssertionError(f"spec preempt ({mode}) refused")
        res = eng.drain()
        torch.cuda.synchronize()
        got = [res[r] for r in rids]
        ticks = eng.ticks_dispatched - ticks0
        windows = eng.replayed_windows - w0
        dtoks = eng.replayed_draft_tokens - d0
        # the rounds' launches, each replayed verify window at the
        # window's shape and each replayed draft token at the draft's
        implied = spec_shape_launches(eng, ticks)
        verify, draft = list(implied)
        implied[verify] += windows * L_t
        implied[draft] += dtoks * L_d
        shapes = {k: n for k, n in
                  _kernels.paged_decode.launches_by_shape().items() if n}
        if got != want or shapes != implied:
            raise AssertionError(
                f"spec preempt ({mode}): tokens equal "
                f"{[a == b for a, b in zip(got, want)]}, launches "
                f"{shapes} vs implied {implied}")
        out[mode] = {"tokens_equal_undisturbed": True,
                     "replayed_windows": windows,
                     "replayed_draft_tokens": dtoks,
                     "kernel_launches": sum(shapes.values()),
                     "launches_by_shape": {
                         f"S{s}_D{d}_{a}": n
                         for (s, d, a), n in shapes.items()}}
    r0 = eng.submit(prompts[0], new)
    eng.submit(prompts[1], new)
    for _ in range(2):
        eng.step()
    f0 = eng.fork(r0)
    res = eng.drain()
    if res[f0] != res[r0]:
        raise AssertionError("spec fork: tokens differ from its source's")
    out["fork_equal_source"] = True
    return out


def phase_n2(seed: int, card: str, eng0, prompts, plain: dict) -> dict:
    """(n.2): ``SpeculativeDecodeServer`` at phase (e)'s width, n_draft 4,
    on the paged arm (bf16 and int8 arenas) and the slot-static arm, at
    (1, 1) and (2, 2), with the seeded draft and with draft = target.
    Sampled runs (seeded draft) on every arm: two runs equal, and equal
    across (1, 1) and (2, 2). Returns the kernel's measured launches at
    each speculative shape in the seeded draft's greedy (1, 1) runs."""
    import gc

    from nos_tpu_torch.models import transformer as tfm
    from nos_tpu_torch.models.serving import DecodeServer

    params, cfg = eng0.params, eng0.cfg
    dcfg = tfm.TransformerConfig(vocab=cfg.vocab, max_seq=cfg.max_seq,
                                 dtype=cfg.dtype, **DRAFT_W)
    dparams = tfm.init_params(
        dcfg, torch.Generator(eng0.device).manual_seed(DRAFT_SEED),
        eng0.device)
    drafts = {"seeded": (dparams, dcfg), "target": (params, cfg)}
    new = 32

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # the plain engine of each arm at (1, 1): its greedy tokens and pace
    eng = DecodeServer(params, cfg, max_batch=8, kv_blocks=1 + 8 * 128,
                       kv_block_size=16, kv_dtype="int8",
                       paged_impl="kernel", device=eng0.device)
    int8_plain = engine_run(eng, prompts, new)
    del eng
    free()
    plain_runs = {"paged_bf16": plain["paged_run"],
                  "paged_int8": int8_plain, "static": plain["static_run"]}
    out = {"phase": "speculative", "card": card, "n_draft": SPEC_K,
           "draft": DRAFT_W, "runs": []}
    sampled = {}
    launches = {}
    for arm in SPEC_ARMS:
        base = plain_runs[arm]
        for depth, T in SPEC_POINTS:
            for name, (dp, dc) in drafts.items():
                eng = spec_engine(params, cfg, dp, dc, arm, depth, T)
                r = engine_run(eng, prompts, new)
                label = f"spec {arm} {name} ({depth}, {T})"
                hold_spec_launches(label, eng, r)
                row = {"arm": arm, "draft": name, "pipeline_depth": depth,
                       "decode_steps": T,
                       **{k: r[k] for k in (
                           "ms_per_round", "tokens_per_window",
                           "acceptance", "tokens_per_s", "ticks",
                           "windows", "decode_tokens", "kernel_launches",
                           "capture_s", "prefill_s")},
                       "plain_tokens_per_s": base["tokens_per_s"],
                       "plain_ms_per_tick": base["ms_per_tick"],
                       "tokens_vs_plain": token_rule(
                           label, r["seqs"], base["seqs"], prompts, params,
                           cfg),
                       "tokens_sha256": token_digest(r["seqs"]),
                       "launches_by_shape": {
                           f"S{s}_D{d}_{a}": n for (s, d, a), n in
                           r["launches_by_shape"].items()}}
                if arm != "static" and name == "seeded" \
                        and (depth, T) == (1, 1):
                    # the kernels line's counts: this run's measured
                    # launches at the verify window's shape and the
                    # draft step's
                    suffix = "" if arm == "paged_bf16" else "_int8"
                    arena = "bfloat16" if arm == "paged_bf16" else "int8"
                    launches["verify" + suffix] = r["launches_by_shape"][
                        (SPEC_K, cfg.head_dim, arena)]
                    launches["draft" + suffix] = r["launches_by_shape"][
                        (1, dc.head_dim, arena)]
                if name == "seeded":
                    runs2 = [engine_run(eng, prompts, new, SAMPLED)
                             for _ in range(2)]
                    for i, rs in enumerate(runs2):
                        hold_spec_launches(f"{label} sampled {i}", eng, rs)
                    if runs2[0]["seqs"] != runs2[1]["seqs"]:
                        raise AssertionError(
                            f"{label} sampled: a rerun gave other tokens")
                    sampled[(arm, depth, T)] = runs2[0]["seqs"]
                    row["sampled_tokens_sha256"] = token_digest(
                        runs2[0]["seqs"])
                emit({"phase": "speculative_run", "card": card, **row})
                out["runs"].append(row)
                del eng
                free()
    for arm in SPEC_ARMS:
        if sampled[(arm, 1, 1)] != sampled[(arm, 2, 2)]:
            raise AssertionError(f"spec {arm} sampled tokens differ "
                                 f"between (1, 1) and (2, 2)")
    out["sampled_invariant_to_knobs"] = {
        arm: token_digest(sampled[(arm, 1, 1)]) for arm in SPEC_ARMS}
    # preemption, fork and the loop on the paged bf16 arm, seeded draft
    eng = spec_engine(params, cfg, dparams, dcfg, "paged_bf16", 1, 1,
                      kv_swap=False)
    out["preempt_fork"] = spec_preempt_fork(eng, prompts, dcfg.n_layers,
                                            cfg.n_layers)
    toks, stats, text = serve_http(
        eng, [{"prompt": prompts[0], "max_new_tokens": new}])
    series = {n: metric_line(text, n) for n in (
        "nos_tpu_serve_spec_draft_total",
        "nos_tpu_serve_spec_accepted_total",
        "nos_tpu_serve_spec_accepted_per_window_count")}
    if series["nos_tpu_serve_spec_draft_total"] <= 0 or \
            series["nos_tpu_serve_spec_accepted_per_window_count"] <= 0 \
            or "speculative" not in stats:
        raise AssertionError(f"spec loop series {series}")
    out["loop"] = {"series": series, "stats": stats["speculative"],
                   "tokens_vs_plain": token_rule(
                       "spec over HTTP", toks, plain_runs["paged_bf16"][
                           "seqs"][:1], prompts[:1], params, cfg)}
    del eng
    free()
    emit({k: v for k, v in out.items() if k != "runs"})
    return launches


def phase_n(seed: int, card: str, flush) -> dict:
    """(n): the slot-static engine and speculative decoding: the kernel
    at the speculative shapes (n.0), the slot-static engine (n.1) and
    ``SpeculativeDecodeServer`` (n.2), every engine on the weights of one
    ``build_engine`` with the reference's ``kv_blocks`` 0."""
    from nos_tpu_torch.cmd.server import ServerConfig, build_engine

    t0 = time.perf_counter()
    kernels = spec_kernel_cases(seed, torch.device("cuda"), flush)
    torch.cuda.empty_cache()
    eng0 = build_engine(ServerConfig(
        bf16=True, kv_blocks=0, max_batch=8, prefix_cache_size=4,
        seed=seed, **FULL))
    if eng0.paged:
        raise AssertionError("kv_blocks=0 built a paged engine")
    prompts = full_width_prompts(seed)
    n1 = phase_n1(seed, card, eng0, prompts)
    plain = {"paged_run": n1["paged_run"], "static_run": n1["static_run"]}
    n2 = phase_n2(seed, card, eng0, prompts, plain)
    del eng0
    torch.cuda.empty_cache()
    emit({"phase": "n", "seconds": time.perf_counter() - t0, "card": card})
    return {"kernels": kernels, "launches": n2}



# ---------------------------------------------------------------------------
# phase (o): the Mixture-of-Experts family at Mixtral-8x7B's widths
# ---------------------------------------------------------------------------

# Mixtral-8x7B-v0.1's published widths (vocab 32000, hidden 4096, 32
# query / 8 KV heads, intermediate 14336, 8 experts, top-2), cut to 24 of
# its 32 layers: the experts stay bf16 under int8 weights too (as the
# reference keeps them), 2.82 GB a layer, so 32 layers (90.2 GB) exceed
# the card and 24 hold 70.2 GB; max_seq 2048 as phase (e). The
# reference's capacity factor 1.25 (with drops) and rope theta 10000
# (ServerConfig has no knob for Mixtral's 1e6).
MOE = dict(vocab=32000, d_model=4096, n_layers=24, n_heads=32,
           n_kv_heads=8, d_ff=14336, max_seq=2048, n_experts=8)
MOE_NEW = 32
# what may be resident on the card before the 70 GB model is built
MOE_RESIDENT_MAX = 1 << 30
# a routing difference excuses a divergence past the token rule's gap
# only where it starts at a router near-tie: at the first position the
# runs route apart (``route_apart``), each run's margin is at most twice
# their largest router-logit difference there, which rounding keeps
# small (first flips read 0.0002-0.03 on the H100); a larger one means
# the runs computed other hidden states, not the same ones rounded apart
ROUTER_TOL = 0.05


def resident_bytes() -> int:
    """Bytes the caching allocator holds for live tensors, read as
    torch's own leak check reads them: after a collection, with cuBLAS's
    per-stream workspaces released (cuBLAS keeps one for every stream it
    ran on, each engine's capture stream among them; no graph that
    recorded one is alive when this is called)."""
    import gc

    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def cuda_tensors(top: int = 6) -> dict:
    """The live CUDA tensors the collector can see: their storages'
    gigabytes, and the largest storages' shapes and dtypes."""
    import gc

    seen = {}
    for obj in gc.get_objects():
        if isinstance(obj, torch.Tensor) and obj.is_cuda:
            st = obj.untyped_storage()
            seen[st.data_ptr()] = (st.nbytes(), tuple(obj.shape),
                                   str(obj.dtype))
    big = sorted(seen.values(), reverse=True)[:top]
    return {"gb": sum(n for n, *_ in seen.values()) / 1e9,
            "largest": [{"gb": n / 1e9, "shape": sh, "dtype": dt}
                        for n, sh, dt in big]}


def tree_bytes(tree) -> int:
    """Bytes of a params tree's tensors (a QuantLinear's both planes)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if hasattr(tree, "q"):
        return tree_bytes(tree.q) + tree_bytes(tree.scale)
    return tree.numel() * tree.element_size()


def bucket_prefill(params, cfg, prompt, bs: int = 16) -> tuple:
    """``prompt`` through ``forward_with_cache`` as the paged engine
    admits it, the same call bit for bit: padded to its bucket on a
    one-row scratch cache of the bucket's length (``DecodeServer._row``).
    Returns (logits [1, bucket, vocab], a one-row cache of ``max_seq``
    positions holding the scratch's K/V, pos at the prompt's end)."""
    from nos_tpu_torch.models.generate import forward_with_cache, init_cache
    from nos_tpu_torch.models.serving import _bucket

    device = params["final_norm"].device
    n = len(prompt)
    bucket = min(max(_bucket(n), bs), cfg.max_seq)
    row = init_cache(cfg, 1, bucket, device=device)
    row["pos"] = torch.tensor(0, dtype=torch.int32)
    logits, row = forward_with_cache(params, cfg, torch.tensor(
        [prompt + [0] * (bucket - n)], device=device), row)
    cache = init_cache(cfg, 1, cfg.max_seq, per_row_pos=True, device=device)
    for kv in ("k", "v"):
        cache[kv][:, :, :, :bucket] = row[kv]
    cache["pos"] = torch.full((1,), n, dtype=torch.int32, device=device)
    return logits, cache


def moe_gap_at(params, cfg):
    """``token_rule``'s gap under MoE, read with the plain engine's
    routing: the prompt prefilled in its admission bucket, then one token
    a step (S 1, as a tick routes it). A single full-sequence pass would
    route every token at another capacity."""
    from nos_tpu_torch.models.generate import forward_with_cache

    device = params["final_norm"].device

    def at(prompt, seq, j):
        n = len(prompt)
        logits, cache = bucket_prefill(params, cfg, prompt)
        step = logits[0, n - 1]
        for q in range(n, j):
            logits, cache = forward_with_cache(
                params, cfg, torch.tensor([[seq[q]]], device=device), cache)
            step = logits[0, -1]
        top2 = step.float().topk(2).values
        return float(top2[0] - top2[1])

    return at


def moe_drops(params, cfg, prompts, seqs) -> dict:
    """Share of the real tokens' routing assignments (2 a token and
    layer) that capacity drops: each prompt's tokens in its admission
    bucket (the pads take their top-1 slots too), the first verify
    window after it (S = ``SPEC_K``, the served tokens that follow) and
    one decode step (S 1); counted around ``ops.moe.top2_gating``."""
    from nos_tpu_torch.models.generate import forward_with_cache
    from nos_tpu_torch.models.serving import _bucket
    from nos_tpu_torch.ops import moe

    device = params["final_norm"].device
    tally = {}
    gating = moe.top2_gating

    def counted(logits, capacity):
        combine, dispatch, aux = gating(logits, capacity)
        kept = dispatch.sum(dim=(2, 3))[:, :tally["real"]]
        t = tally.setdefault(tally["what"], [0, 0])
        t[0] += 2 * kept.numel() - int(kept.sum())
        t[1] += 2 * kept.numel()
        return combine, dispatch, aux

    moe.top2_gating = counted
    try:
        for prompt, seq in zip(prompts, seqs):
            n = len(prompt)
            tally.update(what="prefill", real=n)
            _, cache = bucket_prefill(params, cfg, prompt)
            for what, width in (("verify", SPEC_K), ("decode", 1)):
                cache["pos"] = torch.full((1,), n, dtype=torch.int32,
                                          device=device)
                tally.update(what=what, real=width)
                forward_with_cache(params, cfg, torch.tensor(
                    [seq[n:n + width]], device=device), cache)
    finally:
        moe.top2_gating = gating
    out = {}
    for what in ("prefill", "verify", "decode"):
        dropped, assigned = tally[what]
        out[what] = {"dropped": dropped, "assignments": assigned,
                     "share": dropped / assigned}
    out["capacity"] = {
        "prefill_buckets": sorted({moe.expert_capacity(
            min(max(_bucket(len(p)), 16), cfg.max_seq), cfg.n_experts,
            cfg.expert_capacity_factor) for p in prompts}),
        "verify": moe.expert_capacity(SPEC_K, cfg.n_experts,
                                      cfg.expert_capacity_factor),
        "decode": moe.expert_capacity(1, cfg.n_experts,
                                      cfg.expert_capacity_factor)}
    return out


def graph_of(fn):
    """``fn`` captured as a CUDA graph (after a warm-up on a side
    stream), returned as its replay: the tick's launch path."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def moe_split(params, cfg, flush, batch: int = 8) -> dict:
    """Device ms of one layer's MoE FFN at the decode tick's shape (B 8,
    S 1), each part a CUDA graph replayed after the L2 flush, as in the
    tick: the gating (the router's f32 product and ``top2_gating``), the
    experts' three products with their SwiGLU, and the whole
    ``moe_ffn``; dispatch and combine (two batched products and their
    layout copies) are the rest. Per tick: x n_layers."""
    import torch.nn.functional as F

    from nos_tpu_torch.ops import moe

    layer = {k: v[0] for k, v in params["layers"].items()}
    router, wg, wu, wd = (layer[k] for k in ("w_router", "w_gate", "w_up",
                                              "w_down"))
    e, cf = cfg.n_experts, cfg.expert_capacity_factor
    cap = moe.expert_capacity(1, e, cf)
    gen = torch.Generator(wg.device).manual_seed(0)
    h = torch.randn((batch, 1, cfg.d_model), generator=gen,
                    device=wg.device).to(cfg.dtype)
    x = torch.randn((e, batch * cap, cfg.d_model), generator=gen,
                    device=wg.device).to(cfg.dtype)
    parts = {
        "gating": lambda: moe.top2_gating(
            torch.matmul(h.float(), router.float()), cap),
        "experts": lambda: torch.matmul(
            F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu), wd),
        "moe_ffn": lambda: moe.moe_ffn(h, router, wg, wu, wd, cf)}
    layer_ms = {k: cuda_ms(graph_of(fn), 20, flush) for k, fn in
                parts.items()}
    layer_ms["dispatch_combine"] = (layer_ms["moe_ffn"] - layer_ms["gating"]
                                    - layer_ms["experts"])
    L = cfg.n_layers
    expert_bytes = 3 * wg.numel() * wg.element_size()
    return {"layer_ms": layer_ms,
            "tick_ms": {k: v * L for k, v in layer_ms.items()},
            "experts_bound_ms_per_layer": expert_bytes / HBM_BYTES_PER_S
            * 1e3}


def moe_run(eng, prompts, label: str, sampling=None) -> dict:
    """``engine_run`` of phase (o)'s traffic on ``eng``, the paged
    kernel's own count held to n_layers x T x replays (a plain paged
    engine through the kernel; none through the gather), with the
    requests' TTFT from their ledgers."""
    eng.drain_ledgers()
    r = engine_run(eng, prompts, MOE_NEW, sampling)
    leds = {d["rid"]: d for d in eng.drain_ledgers()}
    ttft = sorted(d["ttft_s"] * 1e3 for d in leds.values())
    tpot = [gap * 1e3 / n for d in leds.values() for gap, n in d["tpot"]
            if n]
    r.update(ttft_p50_ms=float(np.percentile(ttft, 50)),
             ttft_p99_ms=float(np.percentile(ttft, 99)),
             tpot_p50_ms=float(np.percentile(tpot, 50)))
    if eng.paged and not hasattr(eng, "spec_drafted"):
        want = (eng.cfg.n_layers * eng.decode_steps * r["ticks"]
                if eng.paged_kernel == "kernel" else 0)
        if r["kernel_launches"] != want:
            raise AssertionError(
                f"{label}: paged launches {r['kernel_launches']} != "
                f"n_layers x T x replays = {want}")
    for i, (p, seq) in enumerate(zip(prompts, r["seqs"])):
        if seq[:len(p)] != p or len(seq) != len(p) + MOE_NEW:
            raise AssertionError(f"{label}: request {i}'s sequence")
    emit({"phase": "moe_run", "run": label, **run_row(r)})
    return r


def run_row(r: dict) -> dict:
    row = {k: r[k] for k in (
        "ms_per_tick", "tokens_per_s", "ticks", "decode_tokens",
        "prefill_s", "capture_s", "kernel_launches", "ttft_p50_ms",
        "ttft_p99_ms", "tpot_p50_ms") if k in r}
    for k in ("ms_per_round", "tokens_per_window", "acceptance", "drafted",
              "accepted", "windows"):
        if k in r:
            row[k] = r[k]
    row["launches_by_shape"] = {f"S{s}_D{d}_{a}": n for (s, d, a), n in
                                r["launches_by_shape"].items()}
    row["tokens_sha256"] = token_digest(r["seqs"])
    return row


def moe_swap(eng, prompts, want) -> dict:
    """One request (the fourth) preempted by swap after 3 ticks: every
    request's tokens equal the undisturbed run's; the kernel's count
    n_layers x replays (a swap replays nothing)."""
    from nos_tpu_torch.ops import _kernels

    eng.capture_programs()
    ticks0 = eng.ticks_dispatched
    _kernels.paged_decode.launches = 0
    rids = [eng.submit(p, MOE_NEW) for p in prompts]
    for _ in range(3):
        eng.step()
    if not eng.preempt(rids[3], "swap"):
        raise AssertionError("moe swap preempt refused")
    res = eng.drain()
    launches = _kernels.paged_decode.launches
    ticks = eng.ticks_dispatched - ticks0
    got = [res[r] for r in rids]
    if got != want:
        raise AssertionError(f"moe swap: tokens equal undisturbed "
                             f"{[a == b for a, b in zip(got, want)]}")
    if launches != eng.cfg.n_layers * ticks:
        raise AssertionError(f"moe swap: launches {launches} != n_layers "
                             f"x {ticks} replays")
    return {"tokens_equal_undisturbed": True, "kernel_launches": launches,
            "ticks": ticks, "preempts": eng.kv_stats()["preempts"]}


def routing_trace(eng, prompts) -> tuple:
    """Phase (o)'s greedy traffic once more on ``eng``, every program
    called directly (a replay runs the same kernels), with the top-3
    router logits of every gating call kept: (calls in order, each
    (top-3 values, top-3 experts) [B, S, 3] on the host; each request's
    slot; the sequences)."""
    from nos_tpu_torch.models.serving import uncaptured
    from nos_tpu_torch.ops import moe

    calls = []
    gating = moe.top2_gating

    def traced(logits, capacity):
        calls.append(logits.topk(3, dim=-1))
        return gating(logits, capacity)

    moe.top2_gating = traced
    try:
        with uncaptured(eng):
            rids = [eng.submit(p, MOE_NEW) for p in prompts]
            slots = {req.rid: s for s, req in eng._active.items()}
            res = eng.drain()
    finally:
        moe.top2_gating = gating
    return ([(v.cpu(), i.cpu()) for v, i in calls],
            [slots[r] for r in rids], [res[r] for r in rids])


def route_apart(va, ia, vb, ib, ordered: bool):
    """Where two traced gating calls (top-3 router logits and experts
    [..., 3] over the same positions) route apart: the top-2 experts
    differ, or with ``ordered`` (a call of S > 1, where the top-1 picks
    take capacity first) the top-1 does. Returns (mask [...], each
    run's margin there [..., 2]: the gap the change had to close, first
    minus second logit where the top-1 moved, else second minus third;
    at most twice the runs' largest logit difference)."""
    top1 = ia[..., 0] != ib[..., 0]
    pairs = (ia[..., :2].sort(dim=-1).values
             != ib[..., :2].sort(dim=-1).values).any(dim=-1)
    apart = pairs | top1 if ordered else pairs
    k = torch.where(ordered & top1, 0, 1)[..., None]

    def gap(v):
        return (v.gather(-1, k) - v.gather(-1, k + 1))[..., 0]

    return apart, torch.stack([gap(va), gap(vb)], dim=-1)


def hold_flip(label: str, flip: dict) -> dict:
    """Raise unless both runs' router margins at ``flip`` (the first
    position they route apart) are within ``ROUTER_TOL``."""
    if max(flip["margins"]) > ROUTER_TOL:
        raise AssertionError(
            f"{label}: the runs first route apart at {flip} where "
            f"a router margin exceeds {ROUTER_TOL}: not a near-tie")
    return flip


def routing_flip(a: tuple, b: tuple, prompts, L: int, label: str):
    """``token_rule``'s ``routing`` for two traced runs (``routing_trace``
    of the same traffic on two engines): the first call, layer and
    position where request i routes apart (``route_apart``) before a
    step (its admission's positions, ordered; then the ticks up to the
    one that chose the step, S 1, where only the top-2 set counts), with
    each run's router margin there, held to ``ROUTER_TOL``
    (``hold_flip``), or None."""
    (ca, slots, _), (cb, slots_b, _) = a, b
    if slots != slots_b or len(ca) != len(cb):
        raise AssertionError("traced runs scheduled their calls apart")
    n = len(prompts)

    def at(i, step):
        # admission: request i's L calls, its prompt's positions; then
        # tick t's L calls (t < step), its slot's row
        spans = [(i * L, (0, slice(0, len(prompts[i]))), "prefill")]
        spans += [((n + t) * L, (slots[i], slice(0, 1)), f"tick {t}")
                  for t in range(step)]
        for first, where, what in spans:
            for layer in range(L):
                (va, ia), (vb, ib) = ca[first + layer], cb[first + layer]
                apart, margins = route_apart(va[where], ia[where], vb[where],
                                             ib[where], what == "prefill")
                if apart.any():
                    m = int(apart.nonzero()[0, 0])
                    return hold_flip(label, {
                        "at": what, "layer": layer,
                        "position": where[1].start + m
                        if what == "prefill" else None,
                        "experts": [ia[where][m, :2].tolist(),
                                    ib[where][m, :2].tolist()],
                        "margins": margins[m].tolist()})
        return None

    return at


def first_flip(ga: list, gb: list, row: int, label: str):
    """The first layer, then position, where two traced calls of the
    same window (each layer's top-3 router logits and experts, row
    ``row`` of ``ga`` against the one row of ``gb``) route apart
    (``route_apart``, ordered: a window's S > 1), held by ``hold_flip``;
    None where they agree."""
    for layer, ((va, ia), (vb, ib)) in enumerate(zip(ga, gb)):
        apart, margins = route_apart(va[row], ia[row], vb[0], ib[0], True)
        if apart.any():
            m = int(apart.nonzero()[0, 0])
            return hold_flip(label, {
                "layer": layer, "position": m,
                "experts": [ia[row, m, :2].tolist(), ib[0, m, :2].tolist()],
                "margins": margins[m].tolist()})
    return None


def verify_windows(eng, prompts, seqs, label: str) -> dict:
    """Hold a greedy speculative run's tokens to a plain computation of
    its own verify windows, teacher-forced on the tokens and on the K/V
    the engine holds. The traffic runs once more with every program
    called directly; at each target window, each live row's K/V before
    the window are read out of the arena into a one-row cache and the
    row's feed goes through ``forward_with_cache`` at S = k (both sides'
    gating calls traced). A window commits the target's argmax at each
    of its positions up to the first rejected proposal; there the run's
    argmax must equal the plain one, or differ where the plain top-2
    logit gap is under ``GAP_TOL``, or after the window's own first
    routing difference from the plain computation, held to
    ``ROUTER_TOL``. A request's last windows, whose tail runs past its
    blocks into the null block (other rows and earlier runs wrote it;
    under MoE it routes the window, C.16), are counted apart, and the
    rerun's tokens equal ``seqs`` up to them."""
    from nos_tpu_torch.models.generate import forward_with_cache, init_cache
    from nos_tpu_torch.models.serving import uncaptured
    from nos_tpu_torch.ops import moe

    params, cfg, k, bs = eng.params, eng.cfg, eng.k, eng.kv_block_size
    if "k_scale" in eng.cache:
        raise AssertionError(f"{label}: a bf16 arena is read as is")
    row = init_cache(cfg, 1, cfg.max_seq, per_row_pos=True,
                     device=eng.device)
    gating, forward = moe.top2_gating, eng._forward
    windows, sink = [], [None]

    def traced(logits, capacity):
        if sink[0] is not None:
            sink[0].append(tuple(t.cpu() for t in logits.topk(3, dim=-1)))
        return gating(logits, capacity)

    def gated(fn, *args):
        sink[0] = []
        try:
            return fn(*args) + (sink[0],)
        finally:
            sink[0] = None

    def window(toks, cache, table):
        if toks.shape[1] != k:
            return forward(toks, cache, table)
        rec = {"feed": toks.cpu(), "pos": cache["pos"].tolist(),
               "keep": eng._keep.tolist(), "plain": {}}
        for b in (b for b, live in enumerate(rec["keep"]) if live):
            p = rec["pos"][b]
            blocks = table[b, :-(-p // bs)]
            for kv in ("k", "v"):
                held = cache[kv][:, blocks].transpose(1, 2)
                row[kv][:, 0, :, :held.shape[2] * bs] = held.flatten(2, 3)
            row["pos"].fill_(p)
            logits, _, g = gated(forward_with_cache, params, cfg,
                                 toks[b:b + 1], row)
            step = logits[0].float()
            rec["plain"][b] = (step.topk(2).values.cpu(),
                               step.argmax(dim=-1).cpu(), g)
        logits, cache, rec["gating"] = gated(forward, toks, cache, table)
        rec["greedy"] = logits.float().argmax(dim=-1).cpu()
        windows.append(rec)
        return logits, cache

    moe.top2_gating, eng._forward = traced, window
    try:
        with uncaptured(eng):
            rids = [eng.submit(p, MOE_NEW) for p in prompts]
            slots = {req.rid: s for s, req in eng._active.items()}
            res = eng.drain()
    finally:
        moe.top2_gating = gating
        del eng._forward

    out = {"windows": 0, "positions": 0, "equal": 0, "near_tie": 0,
           "routing": 0, "past_blocks": 0, "max_flip_margin": 0.0,
           "diverged": []}
    for i, (prompt, want) in enumerate(zip(prompts, seqs)):
        slot, seq = slots[rids[i]], res[rids[i]]
        # positions from here route to the null block
        blocked = -(-(len(seq) - 1) // bs) * bs
        if seq[:blocked - k + 2] != want[:blocked - k + 2]:
            raise AssertionError(f"{label}: request {i}: the directly called "
                                 f"programs gave other tokens than the "
                                 f"replayed graphs")
        for rec in windows:
            p = rec["pos"][slot]
            if not rec["keep"][slot] or p + 1 >= len(seq):
                continue
            if p + k > blocked:
                out["past_blocks"] += 1
                continue
            feed, got = rec["feed"][slot], rec["greedy"][slot]
            values, plain, ref = rec["plain"][slot]
            if int(feed[0]) != seq[p]:
                raise AssertionError(f"{label}: request {i}'s window at "
                                     f"{p} does not feed its sequence")
            # committed: the argmax up to the first rejected proposal
            a = next((m for m in range(k - 1)
                      if int(feed[m + 1]) != int(got[m])), k - 1)
            span = min(a + 1, len(seq) - p - 1)
            if got[:span].tolist() != seq[p + 1:p + 1 + span]:
                raise AssertionError(f"{label}: request {i}'s window at {p} "
                                     f"committed other tokens than it served")
            out["windows"] += 1
            out["positions"] += span
            where = f"{label}, request {i}, window at {p}"
            m = next((m for m in range(span)
                      if int(got[m]) != int(plain[m])), None)
            if m is None:
                out["equal"] += 1
                continue
            row = {"request": i, "pos": p + 1 + m,
                   "gap": float(values[m, 0] - values[m, 1]),
                   "cause": "near_tie"}
            if row["gap"] >= GAP_TOL:
                flip = first_flip(rec["gating"], ref, slot, where)
                if flip is None:
                    raise AssertionError(
                        f"{where}: commits {int(got[m])} where the plain "
                        f"argmax is {int(plain[m])} at a top-2 gap of "
                        f"{row['gap']} (>= {GAP_TOL}), the window routed as "
                        f"the plain computation")
                row.update(cause="routing", routing=flip)
                out["max_flip_margin"] = max(out["max_flip_margin"],
                                             *flip["margins"])
            out[row["cause"]] += 1
            out["diverged"].append(row)
    return out


def moe_gating_exact(seed: int, cfg) -> dict:
    """``top2_gating`` on the card against the CPU's (which the tests
    hold to XLA:CPU's bit for bit) on the same f32 logits: the decode
    tick's [8, 1, E], a verify window's [8, SPEC_K, E] and a 1,024-token
    prefill bucket's [1, 1024, E], drawn at the router's scale (unit
    variance) and again rounded to 1/8 so that gates tie. Combine and
    dispatch are equal bit for bit (every step elementwise and IEEE-
    rounded, the sums over E taken in a fixed order); the aux loss, a
    mean over B x S each device reduces in its own order, within 1e-6
    relative."""
    from nos_tpu_torch.ops import moe

    gen = torch.Generator().manual_seed(seed)
    e, cf = cfg.n_experts, cfg.expert_capacity_factor
    out = {}
    for b, s in ((8, 1), (8, SPEC_K), (1, 1024)):
        cap = moe.expert_capacity(s, e, cf)
        x = torch.randn((b, s, e), generator=gen)
        for kind, logits in (("random", x), ("tied", (x * 8).round() / 8)):
            want = moe.top2_gating(logits, cap)
            got = [t.cpu() for t in moe.top2_gating(logits.cuda(), cap)]
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(
                    f"moe gating [{b}, {s}, {e}] {kind}: the card's combine "
                    f"or dispatch differs from the CPU's")
            rel = float(abs(got[2] - want[2]) / abs(want[2]))
            if rel > 1e-6:
                raise AssertionError(f"moe gating [{b}, {s}, {e}] {kind}: "
                                     f"aux loss {rel} relative apart")
            out[f"{b}x{s}_{kind}"] = {"capacity": cap, "aux_rel_err": rel,
                                      "kept": int(got[1].sum())}
    return out


def moe_f32_exact(seed: int, prompts) -> dict:
    """Phase (o)'s traffic in f32 at 2 layers, the widths otherwise
    phase (o)'s: the engine's tokens through the paged kernel equal
    those through the gather formulation."""
    import gc

    from nos_tpu_torch.cmd.server import ServerConfig, build_engine
    from nos_tpu_torch.models.serving import DecodeServer

    eng = build_engine(ServerConfig(
        bf16=False, kv_blocks=1 + 8 * 128, kv_block_size=16, max_batch=8,
        paged_kernel="on", seed=seed, **dict(MOE, n_layers=2)))
    kern = moe_run(eng, prompts, "f32 kernel")
    gather = DecodeServer(eng.params, eng.cfg, max_batch=8,
                          kv_blocks=1 + 8 * 128, kv_block_size=16,
                          paged_impl="xla", device=eng.device)
    plain = moe_run(gather, prompts, "f32 gather")
    if kern["seqs"] != plain["seqs"]:
        raise AssertionError(
            f"moe f32: kernel tokens differ from the gather formulation's "
            f"{[a == b for a, b in zip(kern['seqs'], plain['seqs'])]}")
    out = {"n_layers": 2, "kernel_equals_gather": True,
           "kernel_launches": kern["kernel_launches"],
           "tokens_sha256": token_digest(kern["seqs"])}
    del eng, gather
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_moe(seed: int, card: str, flush) -> dict:
    """(o): the MoE family served at Mixtral-8x7B's widths (24 layers),
    every engine on the weights of one ``build_engine`` with
    ``n_experts`` 8; returns the paged kernel's launches on the main
    path's greedy run."""
    import gc
    import threading

    from nos_tpu_torch.cmd.server import (
        ServerConfig, ServingLoop, build_engine, make_http_server,
    )
    from nos_tpu_torch.models import transformer as tfm
    from nos_tpu_torch.models.quant import quantize_params
    from nos_tpu_torch.models.serving import DecodeServer, _bucket
    from nos_tpu_torch.ops.quant import QuantLinear

    t0 = time.perf_counter()

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    free()
    cached = torch.cuda.memory_allocated()
    resident = resident_bytes()
    if resident >= MOE_RESIDENT_MAX:
        raise AssertionError(f"{resident / 1e9:.3f} GB resident before the "
                             f"MoE model is built: {cuda_tensors()}")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    eng0 = build_engine(ServerConfig(
        bf16=True, kv_blocks=1 + 8 * 128, kv_block_size=16, max_batch=8,
        paged_kernel="on", seed=seed, **MOE))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    params, cfg = eng0.params, eng0.cfg
    L = cfg.n_layers
    weight_bytes = tree_bytes(params)
    floor_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    prompts = full_width_prompts(seed, MOE["vocab"])
    gap_at = moe_gap_at(params, cfg)
    gating_exact = moe_gating_exact(seed, cfg)

    def engine(**kw):
        free()
        return DecodeServer(params, cfg, max_batch=8, device=eng0.device,
                            **{"kv_blocks": 1 + 8 * 128,
                               "kv_block_size": 16, "paged_impl": "kernel",
                               **kw})

    out = {"phase": "moe", "card": card, **MOE,
           "source": "Mixtral-8x7B-v0.1 widths, 24 of 32 layers",
           "resident_gb_before": resident / 1e9,
           "allocated_gb_before_workspace_release": cached / 1e9,
           "build_s": build_s,
           "weight_gb": weight_bytes / 1e9, "floor_ms_per_tick": floor_ms,
           "gating_card_equals_cpu": gating_exact}
    # what was measured is printed also when a check fails
    try:
        # o.1 the main path: greedy, bf16 arena, (1, 1), through the kernel
        runs = {"greedy_11": moe_run(eng0, prompts, "moe greedy (1, 1)")}
        main_launches = runs["greedy_11"]["kernel_launches"]
        want = runs["greedy_11"]["seqs"]
        prof = profile_ticks(eng0, prompts)
        if prof["paged_kernels_per_tick"] != L:
            raise AssertionError(
                f"moe profile: {prof['paged_kernels_per_tick']} paged "
                f"kernels a tick, not {L}")
        split = moe_split(params, cfg, flush)
        tick = runs["greedy_11"]["ms_per_tick"]
        out["tick"] = {
            "ms_per_tick": tick, "floor_ms_per_tick": floor_ms,
            "tokens_per_s": runs["greedy_11"]["tokens_per_s"],
            "kernels_per_tick": prof["kernels_per_tick"],
            "device_busy_ms_per_tick": prof["device_busy_ms_per_tick"],
            "device_idle_share": 1 - prof["device_busy_ms_per_tick"] / tick,
            "device_ms_by_group": prof["device_ms_per_tick"],
            "moe_part_ms_per_tick": split["tick_ms"],
            "moe_part_ms_per_layer": split["layer_ms"],
            "experts_bound_ms_per_layer": split["experts_bound_ms_per_layer"],
            "top_kernels": prof["top_kernels"]}
        # o.2 (2, 2): the same tokens bit for bit
        eng = engine(pipeline_depth=2, decode_steps=2)
        runs["greedy_22"] = moe_run(eng, prompts, "moe greedy (2, 2)")
        del eng
        if runs["greedy_22"]["seqs"] != want:
            raise AssertionError("moe (2, 2) tokens differ from (1, 1)'s")
        # o.3 sampled, served twice
        runs["sampled"] = moe_run(eng0, prompts, "moe sampled", SAMPLED)
        again = moe_run(eng0, prompts, "moe sampled rerun", SAMPLED)
        if again["seqs"] != runs["sampled"]["seqs"]:
            raise AssertionError("moe sampled: a rerun gave other tokens")
        # o.4 int8 weights (the experts stay bf16) on the int8 arena
        qparams = quantize_params(params)
        for k in ("w_router", "w_gate", "w_up", "w_down"):
            if isinstance(qparams["layers"][k], QuantLinear) \
                    or qparams["layers"][k] is not params["layers"][k]:
                raise AssertionError(f"quantize_params quantized {k}")
        free()
        eng = DecodeServer(qparams, cfg, max_batch=8, kv_blocks=1 + 8 * 128,
                           kv_block_size=16, kv_dtype="int8",
                           paged_impl="kernel", device=eng0.device)
        runs["int8"] = moe_run(eng, prompts, "moe int8")
        out["int8_weight_gb"] = tree_bytes(qparams) / 1e9
        # held to the same int8 weights and arena through the gather
        # formulation (the bf16 arm's logits lie further apart than the
        # token rule's gap: the attention weights are quantized); both
        # traced, so a divergence past the gap must start at a router
        # near-tie
        traces = [routing_trace(eng, prompts)]
        del eng
        free()
        eng = DecodeServer(qparams, cfg, max_batch=8, kv_blocks=1 + 8 * 128,
                           kv_block_size=16, kv_dtype="int8",
                           paged_impl="xla", device=eng0.device)
        traces.append(routing_trace(eng, prompts))
        del eng
        if traces[0][2] != runs["int8"]["seqs"]:
            raise AssertionError("moe int8: the directly called programs "
                                 "gave other tokens than the replayed graphs")
        out["int8_vs_gather"] = token_rule(
            "moe int8 vs gather", traces[0][2], traces[1][2], prompts,
            qparams, cfg, gap_at=moe_gap_at(qparams, cfg),
            routing=routing_flip(traces[0], traces[1], prompts, L,
                                 "moe int8 vs gather"))
        del traces, qparams
        out["int8_equal_bf16"] = sum(a == b for a, b in zip(
            runs["int8"]["seqs"], want))
        # o.5 the slot-static engine (the reference's default), greedy
        free()
        eng = DecodeServer(params, cfg, max_batch=8, device=eng0.device)
        runs["static_11"] = moe_run(eng, prompts, "moe static")
        if runs["static_11"]["kernel_launches"]:
            raise AssertionError("moe static launched the paged kernel")
        static_prof = profile_ticks(eng, prompts)
        del eng
        out["static_profile"] = {
            "kernels_per_tick": static_prof["kernels_per_tick"],
            "device_busy_ms_per_tick": static_prof["device_busy_ms_per_tick"],
            "device_ms_by_group": static_prof["device_ms_per_tick"]}
        # o.6 speculative, n_draft 4, on the bf16 paged arm: the seeded dense
        # draft at ServerConfig's draft widths, and draft = target
        dcfg = tfm.TransformerConfig(vocab=cfg.vocab, max_seq=cfg.max_seq,
                                     dtype=cfg.dtype, **DRAFT_W)
        dparams = tfm.init_params(
            dcfg, torch.Generator(eng0.device).manual_seed(DRAFT_SEED),
            eng0.device)
        out["speculative"] = {}
        for name, (dp, dc) in (("seeded", (dparams, dcfg)),
                               ("target", (params, cfg))):
            free()
            eng = spec_engine(params, cfg, dp, dc, "paged_bf16", 1, 1)
            r = moe_run(eng, prompts, f"moe spec {name}")
            hold_spec_launches(f"moe spec {name}", eng, r)
            runs[f"spec_{name}"] = r
            # a verify window routes at S = n_draft, the plain tick at S 1
            # (C.17): the run is held to its own windows, recomputed
            out["speculative"][name] = {
                "windows_vs_plain": verify_windows(eng, prompts, r["seqs"],
                                                   f"moe spec {name}"),
                "equal_plain_engine": sum(a == b for a, b in zip(
                    r["seqs"], want)),
                "plain_ms_per_tick": tick}
            del eng
        del dparams, dp, dc
        # o.7 a swap and a recompute preemption of one request
        eng = engine(kv_swap=True)
        out["swap"] = moe_swap(eng, prompts, want)
        del eng

        # the victim whose committed sequence crosses into the next
        # bucket, as l.1's second probe
        cross = min((len(p) for p in prompts), key=lambda n: _bucket(n) - n)
        out["recompute"] = recompute_probe(engine, prompts, cross,
                                           _bucket(cross) - cross + 4,
                                           eager=False)
        free()
        # o.8 phase (k)'s shared 1024-token prefix through the prefix cache
        system, suffixes = prefix_traffic(seed, MOE["vocab"])
        eng = engine(prefix_cache_size=4)
        hit = prefix_pass(eng, system, suffixes, L)
        del eng
        eng = engine()
        cold = prefix_pass(eng, system, suffixes, L)
        del eng
        out["prefix"] = {
            **{k: hit[k] for k in ("ttft_p50_ms", "ttft_p99_ms", "hits",
                                   "tokens_saved", "in_arena_windows",
                                   "graph_replays", "kernel_launches")},
            "ttft_p50_ms_without": cold["ttft_p50_ms"],
            "ttft_p99_ms_without": cold["ttft_p99_ms"],
            # a hit routes its suffix in the suffix's bucket, a full prefill
            # the whole prompt in its own: other capacities (C.16)
            "equal_without": sum(a == b for a, b in zip(hit["seqs"],
                                                        cold["seqs"]))}
        if hit["hits"] != len(suffixes):
            raise AssertionError(f"moe prefix hits {hit['hits']}")
        # o.9 the share of routing assignments capacity drops
        out["dropped"] = moe_drops(params, cfg, prompts, want)
        # o.10 the binary: 8 concurrent greedy requests over HTTP
        quiet_histograms()
        loop = ServingLoop(eng0)
        httpd = make_http_server(ServerConfig(port=0, max_batch=8), loop,
                                 host="127.0.0.1")
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            seqs, _, wall = http_pass(
                f"http://127.0.0.1:{httpd.server_address[1]}", prompts,
                MOE_NEW, [{}] * len(prompts))
        finally:
            httpd.shutdown()
            loop.shutdown()
            httpd.server_close()
        if seqs != want:
            raise AssertionError(
                f"moe over HTTP: tokens equal the direct drain "
                f"{[a == b for a, b in zip(seqs, want)]}")
        out["http"] = {"requests": len(seqs), "equal_direct": True,
                       "wall_s": wall}
        # last of the bf16 checks, so a failure here leaves every run above
        # printed. The slot-static engine routes every call at the paged
        # engine's S, but its attention rounds apart from the kernel's, and
        # a router's near-tie may fall the other way: a divergence past the
        # token rule's gap must show such a flip in the two runs' traces
        traces = []
        for eng, seqs in ((DecodeServer(params, cfg, max_batch=8,
                                        device=eng0.device),
                           runs["static_11"]["seqs"]), (engine(), want)):
            traces.append(routing_trace(eng, prompts))
            del eng
            if traces[-1][2] != seqs:
                raise AssertionError("moe: the directly called programs gave "
                                     "other tokens than the replayed graphs")
        out["static_vs_paged"] = token_rule(
            "moe static vs paged", runs["static_11"]["seqs"], want, prompts,
            params, cfg, gap_at=gap_at,
            routing=routing_flip(traces[0], traces[1], prompts, L,
                                 "moe static vs paged"))
        del traces
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["runs"] = {k: {m: r[m] for m in (
            "ms_per_tick", "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms",
            "capture_s", "kernel_launches", "ms_per_round",
            "tokens_per_window", "acceptance") if m in r}
            for k, r in runs.items()}
        # the 70 GB model goes before the f32 one is built: every holder
        # of the engine or its params (the loop, the server, the gap
        # reader's closure) first
        del eng0, params, runs, want, loop, httpd, gap_at
        resident = resident_bytes()
        if resident >= MOE_RESIDENT_MAX:
            raise AssertionError(f"{resident / 1e9:.3f} GB still resident "
                                 f"after the MoE model was freed: "
                                 f"{cuda_tensors()}")
        # o.11 f32 at 2 layers: the kernel's tokens equal the gather's
        out["f32"] = moe_f32_exact(seed, prompts)
    finally:
        out["seconds"] = time.perf_counter() - t0
        emit(out)
    return main_launches


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
# each kernel's outputs among a flash case's checks
FLASH_OUTPUTS = {"flash_attention_fwd": ("o", "lse"),
                 "flash_attention_bwd_preprocess": ("delta",),
                 "flash_attention_bwd_dkdv": ("dk", "dv"),
                 "flash_attention_bwd_dq": ("dq",)}


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
            timed, checks = flash_case(label, shape, causal, dtype, rng,
                                       device, flush, timed=label == "slice"
                                       and dtype == torch.bfloat16)
            rows = timed or rows
            # a row's error is the largest over every case from the slice on
            for name, keys in FLASH_OUTPUTS.items():
                if name in rows:
                    rows[name]["max_abs_err"] = max(
                        rows[name]["max_abs_err"],
                        *(checks[c]["max_abs_err"] for c in keys))
    return rows


def flash_case(label: str, shape: dict, causal: bool, dtype, rng, device,
               flush, timed: bool = False) -> dict:
    """One case of (f): the four kernels against their plain versions
    within ``FLASH_PINS``, the backward bit-identical over two launches;
    prints the case's row. With ``timed``, also times each kernel beside
    its plain version, SDPA and the bound. Returns the kernels-line rows
    keyed by kernel name ({} when not timed) and the checks."""
    from nos_tpu_torch.ops import _kernels
    from nos_tpu_torch.ops.attention import (
        flash_attention_backward_reference, flash_attention_reference,
    )

    q, k, v, do = attn_case(rng, dtype=dtype, device=device, **shape)
    scale = shape["d"] ** -0.5 * (-1 if label == "neg_scale_s1000" else 1)
    pins = FLASH_PINS[dtype]
    kw = dict(causal=causal, scale=scale)
    o, lse = _kernels.flash_fwd.launch(q, k, v, **kw)
    o_ref, lse_ref = flash_attention_reference(q, k, v, **kw)
    mag = flash_attention_reference(q, k, v.abs(), **kw)[0].float()
    checks = {"o": pin_check("flash_attention_fwd O", o, o_ref,
                             *pins["o_rn"], scale=mag),
              "lse": pin_check("flash_attention_fwd LSE", lse, lse_ref,
                               pins["lse"], pins["lse"], scale=1.0)}
    delta = _kernels.flash_bwd_pre.launch(o, do)
    checks["delta"] = pin_check(
        "flash_attention_bwd_preprocess", delta,
        (do.float() * o.float()).sum(-1), *pins["grad"])
    dk, dv = _kernels.flash_bwd_dkdv.launch(q, k, v, do, lse, delta, **kw)
    (dq,) = _kernels.flash_bwd_dq.launch(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    ref = flash_attention_backward_reference(q, k, v, o, lse, do, **kw)
    for nm, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        checks[nm] = pin_check(f"flash_attention_bwd {nm}", got, want,
                               *pins["grad"])
    # no atomics: a second launch gives the same bits
    again = (*_kernels.flash_bwd_dkdv.launch(q, k, v, do, lse, delta, **kw),
             *_kernels.flash_bwd_dq.launch(q, k, v, do, lse, delta, **kw))
    if not all(torch.equal(a, b_) for a, b_ in zip(again, (dk, dv, dq))):
        raise AssertionError(f"{label} {dtype}: dK/dV/dQ differ between "
                             f"two launches")
    checks["bit_identical_rerun"] = True
    del again
    row = {"phase": "flash_vs_plain", "case": label, "causal": causal,
           "compute": str(dtype).split(".")[-1], **shape,
           "pins": {k_: str(v_) for k_, v_ in pins.items()},
           "checks": checks}
    rows = {}
    if timed:
        row["timing"] = time_flash(q, k, v, do, o, lse, delta, kw, flush)
        rows = {name: dict(t, max_abs_err=max(
                    checks[c]["max_abs_err"] for c in FLASH_OUTPUTS[name]))
                for name, t in row["timing"].items()}
    emit(row)
    del q, k, v, do, o, lse, delta, dq, dk, dv, ref, o_ref, mag
    torch.cuda.empty_cache()
    return rows, checks


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


def n_param_leaves(n_experts: int = 0) -> int:
    """Leaves of the decoder's params (one adamw launch each per update),
    counted on a tiny CPU instance: the count does not depend on the
    widths, only on whether the FFN is dense or MoE."""
    from nos_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig(vocab=8, d_model=8, n_layers=1, n_heads=1,
                                d_ff=8, max_seq=8, n_experts=n_experts,
                                dtype=torch.float32)
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


def profile_train(seed: int, device, widths: dict = TRAIN,
                  batch_size: int = TRAIN_BATCH,
                  seq: int = TRAIN_SEQ, remat_policy: str = "full") -> dict:
    """Device breakdown of 2 steady training steps at full width under
    torch.profiler: busy = the sum of kernel times; groups: the flash
    forward, the flash backward (preprocess, dK/dV, dQ), the adamw
    kernel, matmuls, everything else."""
    from torch.profiler import ProfilerActivity, profile
    from nos_tpu_torch.cmd.trainer import TrainerConfig, synthetic_batch
    from nos_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig(**widths, dtype=torch.bfloat16,
                            remat_policy=remat_policy)
    params, step = train_setup(cfg, seed, device)
    tcfg = TrainerConfig(**widths, batch_size=batch_size, seq_len=seq,
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
                                     "flash_bwd": ("flash_bwd",),
                                     "adamw": ("adamw",)})
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
    the phase's row, the main run's launches among it."""
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
    return row


# (p): the MoE family trained on the card at Mixtral-8x7B-v0.1's widths.
# Depth is cut to 1 of 32 layers to bound the disk writes: the phase
# writes three checkpoints (p.1's steps 4 and 8, p.2's step 8; params
# and both moments in bf16, the router in f32), 10.3 GB each at 1
# layer, 19.0 at 2 and 36.4 at 4, and a whole run is kept under 45 GiB
# of writes (PERF.md, section 4)
MOE_TRAIN = dict(vocab=32000, d_model=4096, n_layers=1, n_heads=32,
                 n_kv_heads=8, d_ff=14336, max_seq=2048, n_experts=8)
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 8, 2048
# what the phase's checkpoints may write: a whole run stays under 45 GiB
# of disk writes, with room for the other phases
P_WRITE_MAX = 36 << 30
MOE_TRAIN_STEPS, MOE_CKPT_EVERY = 8, 4
# the flash kernels at (p)'s attention shape: Mixtral's heads, S 2048
P_ATTN = dict(b=8, h=32, h_kv=8, s_q=2048, s_k=2048, d=128)
# p.4: a 2-layer f32 MoE the CPU takes a step of in seconds (head_dim
# 128, the kernel's; 8 experts, top-2; capacity 160 of 512 tokens)
MOE_PARITY = dict(vocab=32000, d_model=1024, n_layers=2, n_heads=8,
                  n_kv_heads=2, d_ff=2048, max_seq=512, n_experts=8)
MOE_PARITY_BATCH = 2


def moe_step_flops(cfg, batch: int, seq: int, remat: bool = False) -> float:
    """The matmul FLOPs one MoE training step runs: per layer the q/k/v/o
    projections, causal attention over the admitted (query, key) pairs,
    the router, the dispatch product [B, E*C, S] x [B, S, d], the
    experts' three products over E x C slots a batch row (every slot,
    filled or dropped), the combine product [B, S, E*C] x [B, E*C, d];
    then the head. Backward is 2x forward; ``remat`` adds the layers'
    forward a second time (full remat re-runs it)."""
    from nos_tpu_torch.ops.moe import expert_capacity

    d, f, e, v = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.vocab
    t = batch * seq
    slots = batch * e * expert_capacity(seq, e, cfg.expert_capacity_factor)
    layer = (2 * t * d * (2 * d + 2 * cfg.kv_dim)
             + 2 * d * batch * seq * (seq + 1)
             + 2 * t * d * e + 2 * 2 * slots * seq * d
             + 3 * 2 * slots * d * f)
    head = 2 * t * d * v
    fwd_layers = cfg.n_layers * layer
    return 3 * (fwd_layers + head) + (fwd_layers if remat else 0)


class CkptLog(logging.Handler):
    """Collects the checkpoint manager's save and restore records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.saves, self.restores = [], []

    def emit(self, record):
        a = record.args
        if record.msg.startswith("saved checkpoint"):
            self.saves.append({"step": a[0], "bytes": a[1], "seconds": a[2],
                               "stall_s": a[3], "snapshot_s": a[4],
                               "committed_at": record.created})
        elif record.msg.startswith("restored checkpoint"):
            self.restores.append({"step": a[0], "bytes": a[1],
                                  "seconds": a[2]})


class logs_to:
    """Attach logging handlers ({logger name: handler}) for a ``with``
    block."""

    def __init__(self, handlers: dict):
        self.pairs = [(logging.getLogger(name), h)
                      for name, h in handlers.items()]

    def __enter__(self):
        for lg, h in self.pairs:
            lg.setLevel(logging.INFO)
            lg.addHandler(h)

    def __exit__(self, *exc):
        for lg, h in self.pairs:
            lg.removeHandler(h)


class captured_params:
    """Within the block, ``train()``'s params as its step function sees
    them (``captured.params``): the trained weights held in process after
    ``train()`` returns."""

    def __enter__(self):
        from nos_tpu_torch.models import transformer as tfm

        self.tfm, self.real, self.params = tfm, tfm.make_train_step, None

        def spy(cfg, optimizer):
            step = self.real(cfg, optimizer)

            def wrapped(params, batch):
                self.params = params
                return step(params, batch)

            return wrapped

        tfm.make_train_step = spy
        return self

    def __exit__(self, *exc):
        self.tfm.make_train_step = self.real


def moe_train_config(seed: int, checkpoint_dir: str):
    from nos_tpu_torch.cmd.trainer import TrainerConfig

    return TrainerConfig(**MOE_TRAIN, batch_size=MOE_TRAIN_BATCH,
                         seq_len=MOE_TRAIN_SEQ, steps=MOE_TRAIN_STEPS,
                         log_every=1, seed=seed, bf16=True,
                         checkpoint_dir=checkpoint_dir,
                         checkpoint_every=MOE_CKPT_EVERY)


def moe_train_run(cfg, label: str, want: dict, device) -> dict:
    """``train(cfg)`` on the card with the training kernels' launches
    counted from 0, held to ``want``; per-step losses and host times,
    the checkpoint records, wall seconds and peak memory."""
    from nos_tpu_torch.cmd.trainer import train

    log, ck = StepLog(), CkptLog()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_train_launches()                       # the main path's count
    t0 = time.perf_counter()
    with logs_to({"nos_tpu_torch.trainer": log,
                  "nos_tpu_torch.checkpoint": ck}):
        final = train(cfg, device=device)
    wall_s = time.perf_counter() - t0
    launches = train_launches()
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} != {want}")
    losses = [loss for _, loss, _ in log.steps]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: losses {losses}")
    return {"final_loss": final, "steps": log.steps, "losses": losses,
            "saves": ck.saves, "restores": ck.restores, "wall_s": wall_s,
            "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def step_times(run: dict) -> list:
    """(step, host ms, a save in flight) for each step after the first:
    a step's time runs from the previous step's loss to its own, and a
    save is in flight over it when one was issued before it began and
    committed after it began."""
    out = []
    steps = run["steps"]
    for (_, _, a), (step, _, b) in zip(steps, steps[1:]):
        busy = any(s["step"] < step and s["committed_at"] > a
                   for s in run["saves"])
        out.append((step, (b - a) * 1e3, busy))
    return out


def same_checkpoint(a: str, b: str) -> dict:
    """Two committed steps' directories hold the same leaves bit for bit:
    the same index (names, shapes, dtypes) and the same bytes in every
    leaf file. Raises on the first difference."""
    with open(os.path.join(a, "index.json")) as f:
        ia = json.load(f)
    with open(os.path.join(b, "index.json")) as f:
        ib = json.load(f)
    if ia["leaves"] != ib["leaves"]:
        raise AssertionError(f"{a} and {b}: the indexes differ")
    t0 = time.perf_counter()
    n = 0
    chunk = 256 << 20
    for leaf in ia["leaves"]:
        with open(os.path.join(a, leaf["file"]), "rb") as fa, \
                open(os.path.join(b, leaf["file"]), "rb") as fb:
            while True:
                x, y = fa.read(chunk), fb.read(chunk)
                if x != y:
                    raise AssertionError(
                        f"{leaf['name']}: the resumed step differs from "
                        f"the uninterrupted one")
                if not x:
                    break
                n += len(x)
    return {"leaves": len(ia["leaves"]), "bytes": n,
            "seconds": time.perf_counter() - t0}


def moe_f32_parity(seed: int, device) -> dict:
    """p.4: one 2-layer f32 MoE train step on the card (the flash and
    adamw kernels) against the same step on the CPU (their plain
    versions): loss within ``TRAIN_LOSS_RTOL``, every gradient within
    ``TRAIN_GRAD_TOL`` of its leaf's largest, the routing equal; the
    params' largest difference after the update is printed."""
    from nos_tpu_torch.cmd.trainer import TrainerConfig, synthetic_batch
    from nos_tpu_torch.models import transformer as tfm
    from nos_tpu_torch.ops import moe
    from nos_tpu_torch.train.optim import build_optimizer

    cfg = tfm.TransformerConfig(**MOE_PARITY, dtype=torch.float32)
    params = tfm.init_params(cfg, torch.Generator(device).manual_seed(seed),
                             device)
    tcfg = TrainerConfig(**MOE_PARITY, batch_size=MOE_PARITY_BATCH,
                         seq_len=MOE_PARITY["max_seq"], seed=seed)
    batch = synthetic_batch(tcfg, 0, device)
    runs = []
    gating = moe.top2_gating
    for where in (device, torch.device("cpu")):
        # copies: the update below writes them in place
        p = {k: (v.to(where, copy=True) if not isinstance(v, dict)
                 else {n: t.to(where, copy=True) for n, t in v.items()})
             for k, v in params.items()}
        leaves = tfm.param_leaves(p)
        for t in leaves:
            t.requires_grad_()
        picks = []

        def traced(logits, capacity):
            out = gating(logits, capacity)
            picks.append(out[1].cpu())
            return out

        moe.top2_gating = traced
        try:
            loss = tfm.loss_fn(p, cfg, {k: v.to(where)
                                        for k, v in batch.items()})
            grads = torch.autograd.grad(loss, leaves)
        finally:
            moe.top2_gating = gating
        for t, g in zip(leaves, grads):
            t.grad = g
        build_optimizer(leaves, 3e-4, 1).step()
        runs.append((float(loss.detach()), [g.cpu() for g in grads],
                     [t.detach().cpu() for t in leaves], picks))
        del p, leaves, grads
    (lk, gk, pk, rk), (lc, gc, pc, rc) = runs
    if not all(torch.equal(a, b) for a, b in zip(rk, rc)):
        raise AssertionError("f32 MoE step: the card routed other tokens "
                             "than the CPU")
    loss_rel = abs(lk - lc) / abs(lc)
    grad_share = max(float((a - b).abs().max() / b.abs().max())
                     for a, b in zip(gk, gc))
    param_err = max(float((a - b).abs().max()) for a, b in zip(pk, pc))
    if not (loss_rel <= TRAIN_LOSS_RTOL and grad_share <= TRAIN_GRAD_TOL):
        raise AssertionError(
            f"f32 MoE step, card vs CPU: loss rel {loss_rel} (tol "
            f"{TRAIN_LOSS_RTOL}), worst grad share {grad_share} (tol "
            f"{TRAIN_GRAD_TOL})")
    return {**MOE_PARITY, "batch": MOE_PARITY_BATCH,
            "loss_card": lk, "loss_cpu": lc, "loss_rel_diff": loss_rel,
            "loss_rtol": TRAIN_LOSS_RTOL, "worst_grad_rel_diff": grad_share,
            "grad_tol": TRAIN_GRAD_TOL, "grads_compared": len(gk),
            "routing_equal": True, "updated_param_max_abs_diff": param_err}


def phase_moe_train(seed: int, card: str, device, flush) -> dict:
    """(p): train, checkpoint, resume and serve the MoE family on the
    card, at Mixtral-8x7B-v0.1's widths (1 of 32 layers). Returns the
    flash kernels' kernels-line rows at (p)'s attention shape, their
    launches those of p.1."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    from nos_tpu_torch.cmd.server import ServerConfig, build_engine
    from nos_tpu_torch.models import transformer as tfm
    from nos_tpu_torch.models.serving import DecodeServer
    from nos_tpu_torch.models.spec_serving import SpeculativeDecodeServer
    from nos_tpu_torch.train.checkpoint import (
        CheckpointManager, model_arch_dict,
    )

    t_phase = time.perf_counter()
    mcfg = tfm.TransformerConfig(**MOE_TRAIN)
    L, steps = mcfg.n_layers, MOE_TRAIN_STEPS
    n_params = sum(t.numel() for t in tfm.param_leaves(
        tfm.abstract_params(mcfg)))
    ckpt_bytes = sum(3 * t.numel() * t.element_size() for t in
                     tfm.param_leaves(tfm.abstract_params(mcfg)))
    root = tempfile.mkdtemp(prefix="chip_smoke_p_")
    free_disk = shutil.disk_usage(root).free
    out = {"phase": "moe_train", "card": card, **MOE_TRAIN,
           "source": "Mixtral-8x7B-v0.1 widths, 1 of 32 layers",
           "batch": MOE_TRAIN_BATCH, "seq": MOE_TRAIN_SEQ, "steps": steps,
           "remat": "full", "dtype": "bf16", "params": n_params,
           "checkpoint_bytes": ckpt_bytes, "disk_free_bytes": free_disk}
    if free_disk < 3.2 * ckpt_bytes:
        raise AssertionError(f"(p) needs 3 checkpoints of {ckpt_bytes} "
                             f"bytes on {root}; {free_disk} are free")
    if 3 * ckpt_bytes > P_WRITE_MAX:
        raise AssertionError(f"(p) would write 3 x {ckpt_bytes} bytes, "
                             f"past {P_WRITE_MAX}")

    def want(n_steps: int) -> dict:
        return {"flash_attention_fwd": 2 * L * n_steps,
                "flash_attention_bwd_preprocess": L * n_steps,
                "flash_attention_bwd_dkdv": L * n_steps,
                "flash_attention_bwd_dq": L * n_steps,
                "adamw": n_param_leaves(MOE_TRAIN["n_experts"]) * n_steps}

    d1 = os.path.join(root, "run")
    try:
        # p.1: 8 steps, an async save at step 4 overlapping steps 5-8,
        # the last at step 8
        with captured_params() as cap:
            p1 = moe_train_run(moe_train_config(seed, d1), "p.1",
                               want(steps), device)
        trained = {k: (v.detach() if not isinstance(v, dict) else
                       {n: t.detach() for n, t in v.items()})
                   for k, v in cap.params.items()}
        del cap
        if not p1["losses"][-1] < p1["losses"][0]:
            raise AssertionError(f"p.1 losses {p1['losses']} do not fall")
        if [s["step"] for s in p1["saves"]] != [MOE_CKPT_EVERY, steps]:
            raise AssertionError(f"p.1 saves {p1['saves']}")
        times = step_times(p1)
        quiet = [ms for s, ms, busy in times if not busy]
        busy = [ms for s, ms, b in times if b]
        quiet_ms = float(np.median(quiet))
        tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
        flops = moe_step_flops(mcfg, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ)
        hw_flops = moe_step_flops(mcfg, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ,
                                  remat=True)
        out["p1"] = {
            "losses": p1["losses"], "final_loss": p1["final_loss"],
            "wall_s": p1["wall_s"], "launches": p1["launches"],
            "step_ms": [[s, ms, b] for s, ms, b in times],
            "step_ms_median_no_save": quiet_ms,
            "step_ms_median_save_in_flight": (float(np.median(busy))
                                              if busy else None),
            "tokens_per_s": tokens / (quiet_ms / 1e3),
            "model_tflops_per_step": flops / 1e12,
            "mfu_pct": 100 * flops / (quiet_ms / 1e3) / BF16_FLOPS,
            "hardware_tflops_per_step": hw_flops / 1e12,
            "hfu_pct": 100 * hw_flops / (quiet_ms / 1e3) / BF16_FLOPS,
            "peak_mem_gb": p1["peak_mem_gb"], "saves": p1["saves"]}
        emit({"phase": "moe_train_p1", **out["p1"]})
        gc.collect()
        torch.cuda.empty_cache()

        # p.2: step 8 set aside, the run resumed from step 4 in the same
        # directory (a job preempted after step 4), its step 8 held to
        # the uninterrupted one's bit for bit
        stash = os.path.join(root, "p1_step8")
        os.rename(os.path.join(d1, str(steps)), stash)
        p2 = moe_train_run(moe_train_config(seed, d1), "p.2",
                           want(steps - MOE_CKPT_EVERY), device)
        if [r["step"] for r in p2["restores"]] != [MOE_CKPT_EVERY]:
            raise AssertionError(f"p.2 restores {p2['restores']}")
        if p2["losses"] != p1["losses"][MOE_CKPT_EVERY:]:
            raise AssertionError(f"p.2 losses {p2['losses']} != p.1's "
                                 f"{p1['losses'][MOE_CKPT_EVERY:]}")
        same = same_checkpoint(stash, os.path.join(d1, str(steps)))
        shutil.rmtree(stash)
        out["p2"] = {"restore_s": p2["restores"][0]["seconds"],
                     "restore_bytes": p2["restores"][0]["bytes"],
                     "losses": p2["losses"], "wall_s": p2["wall_s"],
                     "launches": p2["launches"], "saves": p2["saves"],
                     "step8_bit_equal": same}
        emit({"phase": "moe_train_p2", **out["p2"]})
        gc.collect()
        torch.cuda.empty_cache()
        # where a step's device time goes: 2 steady steps profiled
        out["profile"] = profile_train(seed, device, MOE_TRAIN,
                                       MOE_TRAIN_BATCH, MOE_TRAIN_SEQ)
        gc.collect()
        torch.cuda.empty_cache()

        # p.3: serve the checkpoint, and the in-process params
        prompts = full_width_prompts(seed, MOE_TRAIN["vocab"])
        scfg = ServerConfig(bf16=True, kv_blocks=1 + 8 * 128,
                            kv_block_size=16, max_batch=8,
                            paged_kernel="on", seed=seed, checkpoint_dir=d1,
                            **MOE_TRAIN)
        ck = CkptLog()
        t = time.perf_counter()
        with logs_to({"nos_tpu_torch.checkpoint": ck}):
            eng = build_engine(scfg, device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        if not all(torch.equal(a, b) for a, b in zip(
                tfm.param_leaves(eng.params), tfm.param_leaves(trained))):
            raise AssertionError("p.3: the served params differ from p.1's")
        served = moe_run(eng, prompts, "p.3 checkpoint")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        eng = DecodeServer(trained, mcfg, max_batch=8, kv_blocks=1 + 8 * 128,
                           kv_block_size=16, paged_impl="kernel",
                           device=device)
        inproc = moe_run(eng, prompts, "p.3 in process")
        del eng
        if served["seqs"] != inproc["seqs"]:
            raise AssertionError("p.3: the checkpoint's tokens differ from "
                                 "the in-process params'")
        del trained
        gc.collect()
        torch.cuda.empty_cache()
        # the draft at ServerConfig's draft widths, through
        # draft_checkpoint_dir
        dcfg = tfm.TransformerConfig(
            vocab=mcfg.vocab, d_model=scfg.draft_d_model,
            n_layers=scfg.draft_n_layers, n_heads=scfg.draft_n_heads,
            n_kv_heads=scfg.draft_n_kv_heads, d_ff=scfg.draft_d_ff,
            max_seq=mcfg.max_seq, dtype=mcfg.dtype)
        dparams = tfm.init_params(
            dcfg, torch.Generator(device).manual_seed(DRAFT_SEED), device)
        ddir = os.path.join(root, "draft")
        mgr = CheckpointManager(ddir)
        mgr.write_model_config(model_arch_dict(dcfg))
        mgr.save(1, dparams, {})
        mgr.close()
        t = time.perf_counter()
        with logs_to({"nos_tpu_torch.checkpoint": ck}):
            eng = build_engine(dataclasses.replace(
                scfg, draft_checkpoint_dir=ddir, draft_n_tokens=SPEC_K),
                device)
        torch.cuda.synchronize()
        spec_load_s = time.perf_counter() - t
        if not isinstance(eng, SpeculativeDecodeServer) or not all(
                torch.equal(a, b) for a, b in zip(
                    tfm.param_leaves(eng.draft_params),
                    tfm.param_leaves(dparams))):
            raise AssertionError("p.3: the speculative engine's draft")
        del dparams
        spec = moe_run(eng, prompts, "p.3 speculative")
        hold_spec_launches("p.3 speculative", eng, spec)
        windows = verify_windows(eng, prompts, spec["seqs"],
                                 "p.3 speculative")
        del eng
        out["p3"] = {
            "load_s": load_s, "restores": ck.restores,
            "spec_load_s": spec_load_s,
            "checkpoint_equals_in_process": True,
            "served": run_row(served), "in_process": run_row(inproc),
            "speculative": run_row(spec), "windows_vs_plain": windows,
            "equal_plain": sum(a == b for a, b in zip(spec["seqs"],
                                                      served["seqs"]))}
        emit({"phase": "moe_train_p3", **out["p3"]})
        gc.collect()
        torch.cuda.empty_cache()

        # p.4: the f32 step on the card against the CPU
        out["p4"] = moe_f32_parity(seed, device)
        # the flash kernels at (p)'s shape, held and timed; launches p.1's
        rows, _ = flash_case("moe_train", P_ATTN, True, torch.bfloat16,
                             np.random.default_rng(seed + 11), device, flush,
                             timed=True)
        for name, row in rows.items():
            row["launches"] = p1["launches"][name]
            row["shape"] = P_ATTN
        out["flash"] = rows
        return rows
    finally:
        shutil.rmtree(root, ignore_errors=True)
        out["seconds"] = time.perf_counter() - t_phase
        emit(out)


# (q): the trainer's named remat policies at (g)'s widths and batch, and
# at (p)'s MoE widths; (g)'s run stands for "full"
REMAT_POLICIES = ("full", "dots", "except_mlp", "minimal")
# "dots"' peak at (g)'s widths while it kept the down product's output
# (PERF.md, section 6; NVIDIA H100 80GB HBM3, 700 W)
Q_DOTS_PEAK_BEFORE_GB = 27.05
Q_MOE_STEPS = 4
# a step-1 gradient leaf may differ from "full"'s by this share of the
# leaf's largest value (every policy runs the same ops on the same bits:
# equality is expected)
Q_GRAD_TOL = 1e-3
# q.5 and q.6: a small model on the kernels (head_dim 128)
Q_SMALL = dict(vocab=32000, d_model=512, n_layers=2, n_heads=4,
               n_kv_heads=2, d_ff=1024, max_seq=512)


def flash_fwd_per_layer(policy: str) -> int:
    """Flash forward launches a layer and step: the recompute re-runs it
    unless the policy saves its outputs."""
    return 1 if policy in ("except_mlp", "minimal") else 2


def remat_want(policy: str, n_layers: int, steps: int,
               n_experts: int = 0) -> dict:
    return {"flash_attention_fwd":
            flash_fwd_per_layer(policy) * n_layers * steps,
            "flash_attention_bwd_preprocess": n_layers * steps,
            "flash_attention_bwd_dkdv": n_layers * steps,
            "flash_attention_bwd_dq": n_layers * steps,
            "adamw": n_param_leaves(n_experts) * steps}


def hardware_flops(mcfg, batch: int, seq: int, model_flops: float,
                   attention_layer_flops: float) -> float:
    """HFU's numerator: the model's FLOPs a step plus what the policy's
    recompute re-runs (``remat_rerun_flops``: its products, and its
    attention forwards counted as the model FLOPs count attention)."""
    from nos_tpu_torch.models.transformer import remat_rerun_flops

    r = remat_rerun_flops(mcfg, batch, seq)
    return model_flops + r["products"] + (r["attention_layers"]
                                          * attention_layer_flops)


def remat_train_run(policy: str, seed: int, device) -> dict:
    """q.1: ``train()`` at (g)'s widths under ``policy``, launches
    counted from 0 and held to ``remat_want``; losses, step ms, MFU,
    HFU, peak memory."""
    import gc

    from nos_tpu_torch.cmd.trainer import TrainerConfig, train

    cfg = TrainerConfig(**TRAIN, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                        steps=TRAIN_STEPS, log_every=1, seed=seed, bf16=True,
                        remat_policy=policy)
    log = StepLog()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_train_launches()                       # the main path's count
    t0 = time.perf_counter()
    with logs_to({"nos_tpu_torch.trainer": log}):
        final = train(cfg, device=device)
    wall_s = time.perf_counter() - t0
    launches = train_launches()
    want = remat_want(policy, TRAIN["n_layers"], TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"q.1 {policy}: launches {launches} != {want}")
    losses = [loss for _, loss, _ in log.steps]
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"q.1 {policy}: losses {losses}")
    times = [t for _, _, t in log.steps]
    step_ms = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
    steady_ms = float(np.median(step_ms[1:]))
    return {"remat_policy": policy, "losses": losses, "final_loss": final,
            "wall_s": wall_s, "step_ms": step_ms,
            "step_ms_median_steady": steady_ms,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (steady_ms / 1e3),
            **policy_hfu(policy, steady_ms),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches}


def policy_hfu(policy: str, step_ms: float) -> dict:
    """(g)'s model FLOPs a step, what ``policy`` re-runs, MFU and HFU at
    ``step_ms``."""
    from nos_tpu_torch.models.transformer import TransformerConfig

    mcfg = TransformerConfig(**TRAIN, remat_policy=policy)
    flops = model_flops_per_step(mcfg, TRAIN_BATCH, TRAIN_SEQ)
    # model_flops_per_step counts a layer's attention forward as 4 B S^2 d
    hw = hardware_flops(mcfg, TRAIN_BATCH, TRAIN_SEQ, flops,
                        4 * TRAIN_BATCH * TRAIN_SEQ ** 2 * TRAIN["d_model"])
    return {"model_tflops_per_step": flops / 1e12,
            "rerun_tflops_per_step": (hw - flops) / 1e12,
            "mfu_pct": 100 * flops / (step_ms / 1e3) / BF16_FLOPS,
            "hfu_pct": 100 * hw / (step_ms / 1e3) / BF16_FLOPS}


def leaf_names(tree, prefix: str = "") -> list:
    """``param_leaves``' order, as names."""
    out = []
    for key in sorted(tree):
        v = tree[key]
        out.extend(leaf_names(v, f"{prefix}{key}/") if isinstance(v, dict)
                   else [prefix + key])
    return out


def same_or_close(label: str, got: list, want: list, names: list) -> dict:
    """Tensors (or floats) against a reference's, one by one: how many
    are bit-equal, and for each that is not its largest difference over
    the reference's largest |value|; raises above ``Q_GRAD_TOL``."""
    differ = {}
    for name, a, b in zip(names, got, want):
        if isinstance(a, float):
            if a != b:
                differ[name] = abs(a - b) / max(abs(b), 1e-30)
        elif not torch.equal(a, b):
            differ[name] = float((a.float() - b.float()).abs().max()
                                 / b.float().abs().max().clamp_min(1e-30))
    if any(v > Q_GRAD_TOL for v in differ.values()):
        raise AssertionError(f"{label}: differs from full's past "
                             f"{Q_GRAD_TOL}: {differ}")
    return {"compared": len(names), "bit_equal": len(names) - len(differ),
            "differing": differ}


def remat_grads(seed: int, device) -> dict:
    """q.2: one step's loss and gradients at (g)'s widths from train()'s
    first params and batch, under each policy, against "full"'s."""
    from nos_tpu_torch.cmd.trainer import TrainerConfig, synthetic_batch
    from nos_tpu_torch.models import transformer as tfm

    cfg = tfm.TransformerConfig(**TRAIN, dtype=torch.bfloat16)
    params = tfm.init_params(cfg, torch.Generator(device).manual_seed(seed),
                             device)
    leaves = tfm.param_leaves(params)
    for p in leaves:
        p.requires_grad_()
    names = leaf_names(params)
    batch = synthetic_batch(TrainerConfig(**TRAIN, batch_size=TRAIN_BATCH,
                                          seq_len=TRAIN_SEQ, seed=seed),
                            0, device)
    full = None
    out = {}
    for policy in REMAT_POLICIES:
        c = tfm.TransformerConfig(**TRAIN, dtype=torch.bfloat16,
                                  remat_policy=policy)
        loss = tfm.loss_fn(params, c, batch)
        grads = torch.autograd.grad(loss, leaves)
        loss = float(loss.detach())
        if full is None:
            full = (loss, grads)
            out[policy] = {"loss": loss}
            continue
        out[policy] = {"loss": loss, "loss_equal": loss == full[0],
                       **same_or_close(f"q.2 {policy} gradients",
                                       list(grads), list(full[1]), names)}
        del grads
    del params, leaves, full
    return out


def remat_moe(seed: int, device) -> dict:
    """q.4: (p)'s MoE, 4 steps under each policy; every gating call's
    dispatch held to "full"'s, call by call (the forward's and the
    recompute's in each step)."""
    import gc

    from nos_tpu_torch.cmd.trainer import TrainerConfig
    from nos_tpu_torch.models.transformer import TransformerConfig
    from nos_tpu_torch.ops import moe

    gating = moe.top2_gating
    full_routes, out = [], {}
    L, steps = MOE_TRAIN["n_layers"], Q_MOE_STEPS
    for policy in REMAT_POLICIES:
        calls = {"n": 0, "differ": 0}

        def traced(logits, capacity, policy=policy, calls=calls):
            res = gating(logits, capacity)
            if policy == "full":
                full_routes.append(res[1])
            elif not torch.equal(res[1], full_routes[calls["n"]]):
                calls["differ"] += 1
            calls["n"] += 1
            return res

        cfg = TrainerConfig(**MOE_TRAIN, batch_size=MOE_TRAIN_BATCH,
                            seq_len=MOE_TRAIN_SEQ, steps=steps, log_every=1,
                            seed=seed, bf16=True, remat_policy=policy)
        moe.top2_gating = traced
        try:
            run = moe_train_run(cfg, f"q.4 {policy}",
                                remat_want(policy, L, steps,
                                           MOE_TRAIN["n_experts"]), device)
        finally:
            moe.top2_gating = gating
        if calls["differ"] or calls["n"] != 2 * L * steps:
            raise AssertionError(f"q.4 {policy}: {calls['differ']} of "
                                 f"{calls['n']} gating calls routed apart "
                                 f"from full's")
        ms = [m for _, m, _ in step_times(run)]
        steady_ms = float(np.median(ms[1:]))
        mcfg = TransformerConfig(**MOE_TRAIN, remat_policy=policy)
        flops = moe_step_flops(mcfg, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ)
        # moe_step_flops counts attention over the causal pairs
        hw = hardware_flops(mcfg, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, flops,
                            2 * mcfg.d_model * MOE_TRAIN_BATCH
                            * MOE_TRAIN_SEQ * (MOE_TRAIN_SEQ + 1))
        out[policy] = {"losses": run["losses"], "launches": run["launches"],
                       "step_ms": ms, "step_ms_median_steady": steady_ms,
                       "mfu_pct": 100 * flops / (steady_ms / 1e3)
                       / BF16_FLOPS,
                       "hfu_pct": 100 * hw / (steady_ms / 1e3) / BF16_FLOPS,
                       "rerun_tflops_per_step": (hw - flops) / 1e12,
                       "peak_mem_gb": run["peak_mem_gb"],
                       "gating_calls_equal_full": calls["n"]}
        if policy != "full":
            out[policy]["losses_vs_full"] = same_or_close(
                f"q.4 {policy} losses", run["losses"],
                out["full"]["losses"],
                [f"step {i + 1}" for i in range(steps)])
        gc.collect()
        torch.cuda.empty_cache()
    del full_routes
    return out


def remat_profile_dir(seed: int, device, root: str) -> dict:
    """q.5: ``train()`` with ``profile_dir``: steps 1-2 of 3 traced."""
    from nos_tpu_torch.cmd.trainer import TrainerConfig, train

    d = os.path.join(root, "trace")
    train(TrainerConfig(**Q_SMALL, batch_size=2, seq_len=Q_SMALL["max_seq"],
                        steps=3, seed=seed, bf16=True, profile_dir=d,
                        profile_start=1, profile_steps=2), device=device)
    files = sorted(os.listdir(d))
    if len(files) != 1 or not files[0].startswith("trainer_steps_1-3_"):
        raise AssertionError(f"q.5: trace files {files}")
    with open(os.path.join(d, files[0])) as f:
        text = f.read()
    kernels = [k for k in ("flash_fwd_wgmma_kernel", "flash_bwd_pre_kernel",
                           "flash_bwd_dkdv_wgmma_kernel",
                           "flash_bwd_dq_wgmma_kernel") if k in text]
    if len(kernels) != 4:
        raise AssertionError(f"q.5: the trace names only {kernels} of the "
                             f"four flash kernels")
    return {"files": files, "bytes": len(text), "flash_kernels": kernels}


def remat_metrics_port(seed: int, root: str) -> dict:
    """q.6: the trainer binary's ``main()`` with ``metrics_port`` on a
    free port (its config a JSON file); /metrics and /healthz scraped
    while it trains (after ``train()``, before ``main()`` stops the
    server)."""
    import socket
    import urllib.request

    from nos_tpu_torch.cmd import trainer
    from nos_tpu_torch.utils.metrics import default_registry

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    steps = 3
    path = os.path.join(root, "trainer.json")
    with open(path, "w") as f:
        json.dump(dict(Q_SMALL, batch_size=2, seq_len=Q_SMALL["max_seq"],
                       steps=steps, seed=seed, metrics_port=port), f)
    counter = default_registry().get("nos_tpu_train_steps_total")
    before = counter.total() if counter is not None else 0.0
    url = f"http://127.0.0.1:{port}"
    seen = {}
    real = trainer.train

    def scraped(cfg, *args, **kwargs):
        out = real(cfg, *args, **kwargs)
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            seen["metrics"] = r.read().decode()
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            seen["healthz"] = r.status
        return out

    trainer.train = scraped
    try:
        trainer.main(["--config", path])
    finally:
        trainer.train = real
    series = {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
              for line in seen["metrics"].splitlines()
              if line.startswith("nos_tpu_train_")}
    if series.get("nos_tpu_train_steps_total") != before + steps \
            or seen["healthz"] != 200:
        raise AssertionError(f"q.6: steps_total "
                             f"{series.get('nos_tpu_train_steps_total')} "
                             f"(want {before + steps}), healthz "
                             f"{seen['healthz']}")
    return {"port": port, "healthz": seen["healthz"],
            "steps_total_before": before, "series": series}


def phase_remat(seed: int, card: str, device, g_row) -> dict:
    """(q): the named remat policies on the card. Returns each policy's
    q.1 launches ("full"'s from (g)'s row when (g) ran)."""
    import gc
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    out = {"phase": "remat_policies", "card": card, **TRAIN,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS}
    root = tempfile.mkdtemp(prefix="chip_smoke_q_")
    try:
        # q.1
        runs = {}
        if g_row is not None:
            runs["full"] = {k: g_row[k] for k in (
                "losses", "step_ms_median_steady", "tokens_per_s",
                "mfu_pct", "peak_mem_gb", "launches", "profile")}
            runs["full"]["from_phase"] = "g"
            runs["full"].update(policy_hfu(
                "full", runs["full"]["step_ms_median_steady"]))
        for policy in REMAT_POLICIES:
            if policy in runs:
                continue
            runs[policy] = remat_train_run(policy, seed, device)
            if policy != "full":
                runs[policy]["losses_vs_full"] = same_or_close(
                    f"q.1 {policy} losses", runs[policy]["losses"],
                    runs["full"]["losses"],
                    [f"step {i + 1}" for i in range(TRAIN_STEPS)])
            gc.collect()
            torch.cuda.empty_cache()
            runs[policy]["profile"] = profile_train(
                seed, device, TRAIN, TRAIN_BATCH, TRAIN_SEQ,
                remat_policy=policy)
            emit({"phase": "remat_q1", "card": card, **runs[policy]})
            gc.collect()
            torch.cuda.empty_cache()
        out["q1"] = runs
        # q.2
        out["q2"] = remat_grads(seed, device)
        emit({"phase": "remat_q2", "card": card, **out["q2"]})
        gc.collect()
        torch.cuda.empty_cache()
        # q.3
        peak = {p: runs[p]["peak_mem_gb"] for p in REMAT_POLICIES}
        if not (peak["minimal"] <= peak["except_mlp"] <= peak["dots"]
                and peak["full"] <= peak["except_mlp"]):
            raise AssertionError(f"q.3: peak memory {peak}")
        out["q3_peak_mem_gb"] = peak
        # C.18: under dots the down product's output is not kept (B S d
        # bf16 a layer, 1 GiB over (g)'s 16 layers); keeping it peaked
        # at Q_DOTS_PEAK_BEFORE_GB here
        if not peak["dots"] < Q_DOTS_PEAK_BEFORE_GB:
            raise AssertionError(f"q.3: dots peaks at {peak['dots']} GB, "
                                 f"not below {Q_DOTS_PEAK_BEFORE_GB}")
        out["q3_dots_peak_before_gb"] = Q_DOTS_PEAK_BEFORE_GB
        out["q3_dots_peak_drop_gb"] = Q_DOTS_PEAK_BEFORE_GB - peak["dots"]
        # q.4
        out["q4"] = remat_moe(seed, device)
        emit({"phase": "remat_q4", "card": card, **MOE_TRAIN,
              "batch": MOE_TRAIN_BATCH, "seq": MOE_TRAIN_SEQ, **out["q4"]})
        gc.collect()
        torch.cuda.empty_cache()
        # q.5, q.6
        out["q5"] = remat_profile_dir(seed, device, root)
        out["q6"] = remat_metrics_port(seed, root)
        return {p: r["launches"] for p, r in runs.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        out["seconds"] = time.perf_counter() - t_phase
        emit(out)


# (r): the trainer's lifecycle notice watcher at (g)'s widths
R_NODE = "chip-smoke-node"
# the notice lands after this step's loss is logged; the step in flight
# then ends and is banked
R_NOTICE_AFTER = 4
# the spot grace a preemption notice gives
# (nos_tpu/lifecycle/events.py:9-10, :169): the save must commit in it
R_SPOT_GRACE_S = 30.0


class FinalState:
    """For a ``with`` block, ``CheckpointManager.save`` keeps each saved
    step's leaves as host copies instead of writing them: the resumed and
    the uninterrupted runs' last states are compared in host memory, so
    the phase writes one checkpoint (the preemption's) to the disk."""

    def __init__(self):
        self.steps = {}

    def __enter__(self):
        from nos_tpu_torch.train import checkpoint as ck

        self.ck, self.real = ck, ck.CheckpointManager.save
        store = self.steps

        def save(mgr, step, params, opt_state, wait=True):
            store[step] = [
                (name, t.detach().cpu().clone()
                 if isinstance(t, torch.Tensor) else t)
                for name, t in ck._flatten({"params": params,
                                            "opt_state": opt_state}, "", [])]
            return None

        ck.CheckpointManager.save = save
        return self

    def __exit__(self, *exc):
        self.ck.CheckpointManager.save = self.real


class MainLog(logging.Handler):
    """The trainer binary's records a run is read by: each step's loss
    and time, the preemption stop, the final loss."""

    def __init__(self, on_step=None):
        super().__init__(logging.INFO)
        self.steps, self.on_step = [], on_step
        self.final = self.stopped_at = None

    def emit(self, record):
        if record.msg.startswith("step %d/%d loss"):
            self.steps.append((record.args[0], record.args[2],
                               record.created))
            if self.on_step is not None:
                self.on_step(record.args[0])
        elif record.msg.startswith("stop requested (preemption)"):
            self.stopped_at = (record.args[0], record.created)
        elif record.msg.startswith("training done, final loss"):
            self.final = record.args[0]


def trainer_main(path: str, log: MainLog, ck: "CkptLog") -> dict:
    """``nos_tpu_torch.cmd.trainer.main(["--config", path])`` in this
    process, its training kernels' launches counted from 0: its exit
    code (0 when it returns), launches, wall seconds, peak memory."""
    from nos_tpu_torch.cmd import trainer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name in ("nos_tpu_torch.trainer", "nos_tpu_torch.checkpoint"):
        logging.getLogger(name).setLevel(logging.INFO)
    zero_train_launches()                       # the main path's count
    t0 = time.perf_counter()
    code = 0
    with logs_to({"nos_tpu_torch.trainer": log,
                  "nos_tpu_torch.checkpoint": ck}):
        try:
            trainer.main(["--config", path])
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
    return {"exit_code": code, "launches": train_launches(),
            "wall_s": time.perf_counter() - t0,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def train_want(steps: int) -> dict:
    L = TRAIN["n_layers"]
    return {"flash_attention_fwd": 2 * L * steps,
            "flash_attention_bwd_preprocess": L * steps,
            "flash_attention_bwd_dkdv": L * steps,
            "flash_attention_bwd_dq": L * steps,
            "adamw": n_param_leaves() * steps}


def phase_watcher(seed: int, card: str, g_row) -> dict:
    """(r): the trainer binary at (g)'s widths with ``node_name`` and
    ``lifecycle_api`` pointing at the port's ``ApiHttpServer`` on
    127.0.0.1, which serves the pod's ``Node``. A preemption notice is
    stamped on the node (as the control plane's watcher does) once step
    ``R_NOTICE_AFTER``'s loss is logged: the watcher's stop event, the
    step in flight banked by a synchronous save, exit code 0; then
    ``main()`` resumes from that checkpoint to step 8, and an
    uninterrupted run of 8 steps gives the same 8 losses and every leaf
    of params and optimizer state bit for bit (both last states held in
    host memory); (g)'s losses too when (g) ran. Returns the training
    kernels' launches over the three runs."""
    import shutil
    import tempfile
    import threading

    from nos_tpu_torch.cmd import trainer
    from nos_tpu_torch.kube.apiserver import ApiServer
    from nos_tpu_torch.kube.client import Client
    from nos_tpu_torch.kube.httpapi import ApiHttpServer
    from nos_tpu_torch.kube.objects import Node, ObjectMeta
    from nos_tpu_torch.lifecycle.events import deliver_preemption_notice

    t_phase = time.perf_counter()
    out = {"phase": "lifecycle_watcher", "card": card, **TRAIN,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "notice_after_step": R_NOTICE_AFTER, "node": R_NODE}
    root = tempfile.mkdtemp(prefix="chip_smoke_r_")
    api = ApiServer()
    api.create(Node(metadata=ObjectMeta(name=R_NODE)))
    httpd = ApiHttpServer(api).start()
    base = dict(TRAIN, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                steps=TRAIN_STEPS, log_every=1, seed=seed, bf16=True,
                checkpoint_every=1000)

    def config(name: str, **kw) -> str:
        path = os.path.join(root, f"{name}.json")
        with open(path, "w") as f:
            json.dump(dict(base, **kw), f)
        return path

    seen = {}
    real_train = trainer.train

    def spied(cfg, stop_event=None, device=None):
        # the event main() hands train(): stamped when the watcher sets it
        if stop_event is not None:
            def wait():
                stop_event.wait()
                seen["stop_at"] = time.time()
            threading.Thread(target=wait, daemon=True).start()
        seen["event"] = stop_event
        return real_train(cfg, stop_event=stop_event, device=device)

    def notice(step: int) -> None:
        if step == R_NOTICE_AFTER:
            seen["notice_at"] = time.time()
            deliver_preemption_notice(Client(api), R_NODE,
                                      time.time() + R_SPOT_GRACE_S)

    ckpt_dir = os.path.join(root, "ckpt")
    try:
        # r.1 the notice, the stop, the save, the exit
        trainer.train = spied
        log1, ck1 = MainLog(on_step=notice), CkptLog()
        try:
            run1 = trainer_main(config("watched", checkpoint_dir=ckpt_dir,
                                       node_name=R_NODE,
                                       lifecycle_api=httpd.address),
                                log1, ck1)
        finally:
            trainer.train = real_train
        if seen.get("event") is None or "stop_at" not in seen:
            raise AssertionError("r.1: the watcher never set the stop event")
        if log1.stopped_at is None or len(ck1.saves) != 1:
            raise AssertionError(f"r.1: no preemption save ({ck1.saves})")
        saved = ck1.saves[0]
        banked = saved["step"]
        notice_to_save_s = saved["committed_at"] - seen["notice_at"]
        if not (R_NOTICE_AFTER < banked < TRAIN_STEPS) \
                or run1["exit_code"] != 0 \
                or notice_to_save_s >= R_SPOT_GRACE_S:
            raise AssertionError(
                f"r.1: banked step {banked}, exit code {run1['exit_code']}, "
                f"notice to save {notice_to_save_s} s")
        if run1["launches"] != train_want(banked):
            raise AssertionError(f"r.1: launches {run1['launches']} != "
                                 f"{train_want(banked)}")
        # r.2 the resume to step 8, and the uninterrupted run
        log2, ck2, log3, ck3 = MainLog(), CkptLog(), MainLog(), CkptLog()
        with FinalState() as resumed:
            run2 = trainer_main(config("resumed", checkpoint_dir=ckpt_dir),
                                log2, ck2)
        with FinalState() as straight:
            run3 = trainer_main(config("straight", checkpoint_dir=os.path.join(
                root, "straight")), log3, ck3)
        for label, run, steps in (("r.2 resumed", run2, TRAIN_STEPS - banked),
                                  ("r.2 uninterrupted", run3, TRAIN_STEPS)):
            if run["exit_code"] != 0 or run["launches"] != train_want(steps):
                raise AssertionError(f"{label}: exit {run['exit_code']}, "
                                     f"launches {run['launches']}")
        losses = [x for _, x, _ in log1.steps] + [log1.final] + \
            [x for _, x, _ in log2.steps]
        want = [x for _, x, _ in log3.steps]
        if losses != want:
            raise AssertionError(f"r.2: interrupted + resumed losses "
                                 f"{losses} != uninterrupted {want}")
        if g_row is not None and want != g_row["losses"]:
            raise AssertionError(f"r.2: losses {want} != (g)'s "
                                 f"{g_row['losses']}")
        a, b = resumed.steps[TRAIN_STEPS], straight.steps[TRAIN_STEPS]
        if [n for n, _ in a] != [n for n, _ in b] or not all(
                torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                for (_, x), (_, y) in zip(a, b)):
            raise AssertionError("r.2: the resumed step 8 differs from the "
                                 "uninterrupted one")
        out.update({
            "notice_to_stop_event_ms": (seen["stop_at"] - seen["notice_at"])
            * 1e3,
            "notice_to_save_committed_s": notice_to_save_s,
            "spot_grace_s": R_SPOT_GRACE_S, "banked_step": banked,
            "save_bytes": saved["bytes"], "save_s": saved["seconds"],
            "exit_code": run1["exit_code"],
            "restore_s": ck2.restores[0]["seconds"] if ck2.restores else None,
            "losses": want, "losses_equal_uninterrupted": True,
            "losses_equal_g": g_row is not None,
            "leaves_bit_equal": len(a),
            "leaf_bytes": sum(x.numel() * x.element_size() for _, x in a
                              if isinstance(x, torch.Tensor)),
            "runs": {"watched": run1, "resumed": run2, "uninterrupted": run3},
            "disk_writes_gb": saved["bytes"] / 1e9})
        return {k: run1["launches"][k] + run2["launches"][k]
                + run3["launches"][k] for k in run1["launches"]}
    finally:
        httpd.stop()
        shutil.rmtree(root, ignore_errors=True)
        out["seconds"] = time.perf_counter() - t_phase
        emit(out)


# (s): tensor-parallel serving at (e)'s widths, tp = 2, both shards on
# the one card
TP = 2
TP_NEW = 32
TP_PAGED = dict(max_batch=8, kv_blocks=1 + 8 * 128, kv_block_size=16)
# the largest difference two formulations' logits of this model may show
# in one step (``decode_probe``'s tolerance at these widths)
SAMPLED_LOGIT_TOL = 0.15


def flip_eps(logits: torch.Tensor, sampling: dict, key: torch.Tensor,
             other: int, plain: int, hi: float = 1.0,
             iters: int = 24) -> float:
    """A logit move, in max-abs logits, under which the engine's sampled
    decision on ``logits`` (a plain run's f32 row that draws ``plain``;
    ``_sample``: the tempered row truncated by top-k and top-p, plus the
    gumbel noise of ``key``) draws ``other``: the least eps, found by
    bisection, of three moves of every logit by +-eps, each verified to
    draw ``other``: ``other`` up and the rest down (a near-tie of the
    draw's scores: only ``other`` can enter the truncated set); the
    tokens above ``plain`` up and the rest down (``plain`` falls off the
    top-p edge, the rest keep their order); the tokens above ``other``
    down and the rest up (``other`` climbs into the set). So it is an
    upper bound on the least move: 0 when ``logits`` draw ``other`` as
    they are, inf past ``hi``. For a greedy decision it is half the
    top-2 gap (the token rule's gap of 0.1 is a move of 0.05)."""
    from nos_tpu_torch.models.generate import _truncate_logits_rows
    from nos_tpu_torch.utils import prng

    device = logits.device
    t = torch.full((), sampling["temperature"], device=device)
    top_k = torch.full((1,), sampling.get("top_k", 0), device=device)
    top_p = torch.full((1,), sampling.get("top_p", 0.0), device=device)
    noise = prng.gumbel(key, logits.shape)
    up_mask = [torch.arange(logits.numel(), device=device) == other,
               logits > logits[plain], logits <= logits[other]]

    def draws(eps: float, up: torch.Tensor) -> bool:
        moved = torch.where(up, logits + eps, logits - eps)
        z = _truncate_logits_rows((moved / t)[None], top_k, top_p)[0]
        return int(torch.argmax(z + noise)) == other

    if draws(0.0, up_mask[0]):
        return 0.0
    best = float("inf")
    for up in up_mask:
        if not draws(hi, up):
            continue
        lo, top = 0.0, hi
        for _ in range(iters):
            mid = (lo + top) / 2
            lo, top = (lo, mid) if draws(mid, up) else (mid, top)
        best = min(best, top)
    return best


def sampled_rule(label: str, got: list, plain: list, prompts: list, params,
                 cfg, sampling: list, other_params, mesh) -> dict:
    """The token rule for sampled runs. Sequences are equal, or at the
    first differing token, teacher-forced on the common prefix, with the
    request's temperature, top-k, top-p and the noise of key (seed,
    position) as the engine draws:
    - "unstable": the plain run's own logits draw another token than it
      did (its arithmetic alone moves the draw), or ``flip_eps`` finds a
      move under ``GAP_TOL`` / 2 that draws the other token (the greedy
      rule's gap of 0.1 is such a move); else
    - "own_logits": each run's logits (the plain ``params``, the other
      ``other_params`` on ``mesh``) draw its own token and differ by
      less than ``SAMPLED_LOGIT_TOL`` (a draw near the top-p edge moves
      with many logits at once, which no single move above finds).
    Raises on any other divergence, after every request is read."""
    from nos_tpu_torch.models.generate import (
        _truncate_logits_rows, forward_with_cache, init_cache,
    )
    from nos_tpu_torch.utils import prng

    device = params["final_norm"].device
    diverged, bad = [], []
    for i, (a, b) in enumerate(zip(got, plain)):
        if a == b:
            continue
        j = next(k for k in range(len(b)) if a[k] != b[k])
        step = j - len(prompts[i])
        if step < 0:
            raise AssertionError(f"{label}: request {i} differs in its "
                                 f"prompt")
        s = sampling[i]
        key = prng.fold_in(prng.PRNGKey(s["seed"], device), j)
        t = torch.full((), s["temperature"], device=device)
        noise = prng.gumbel(key, (cfg.vocab,))
        rows, draws = {}, {}
        for name, ps, m in (("plain", params, None),
                            ("other", other_params, mesh)):
            cache = init_cache(cfg, 1, j, device=device, mesh=m)
            logits, _ = forward_with_cache(
                ps, cfg, torch.tensor([b[:j]], device=device), cache)
            rows[name] = logits[0, -1].float()
            z = _truncate_logits_rows(
                (rows[name] / t)[None],
                torch.full((1,), s["top_k"], device=device),
                torch.full((1,), s["top_p"], device=device))[0]
            draws[name] = int(torch.argmax(z + noise))
        eps = flip_eps(rows["plain"], s, key, a[j], b[j])
        diff = float((rows["other"] - rows["plain"]).abs().max())
        row = {"request": i, "step": step, "plain_token": b[j],
               "other_token": a[j], "tf_draw_plain": draws["plain"],
               "tf_draw_other": draws["other"], "flip_eps": eps,
               "tf_max_abs_logit_diff": diff}
        if draws["plain"] != b[j] or eps < GAP_TOL / 2:
            row["cause"] = "unstable"
        elif draws["other"] == a[j] and diff < SAMPLED_LOGIT_TOL:
            row["cause"] = "own_logits"
        else:
            bad.append(row)
        diverged.append(row)
    out = {"equal": len(got) - len(diverged), "of": len(got),
           "diverged": diverged}
    if bad:
        raise AssertionError(f"{label}: divergences no near-tie explains: "
                             f"{bad} (all: {out})")
    return out


def tp_run(eng, prompts, sampling=None) -> dict:
    """``engine_run`` with the run's peak memory: the caching
    allocator's peak since the engine's build."""
    r = engine_run(eng, prompts, TP_NEW, sampling)
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return r


def phase_tp(seed: int, card: str, device=None) -> dict:
    """(s): tensor-parallel serving at phase (e)'s widths, tp = 2 with
    both shards on the one card (``TpMesh([cuda:0, cuda:0])``): phase
    (e)'s traffic greedy on the bf16 and the int8 arena and sampled on
    the bf16 arena through the paged engine, and greedy on the
    slot-static engine, each against the tp = 1 engine on the same
    weights (``build_engine``'s, from the seed) by the token rule
    (sampled: ``sampled_rule``); the paged kernel's own launches twice
    tp = 1's, by shape at (S 1, head_dim 128), n_layers x tp x ticks;
    one handoff from a tp = 1 prefill-role engine adopted by a tp = 2
    decode-role engine, its K/V re-read from the shards byte for byte
    and its tokens by the token rule. Prints ms a tick and peak memory
    beside tp = 1's (captured, and eager as tp = 2 runs): the cost of
    one card computing both shards, not a speed. Returns the paged
    kernel's launches at the shard shape by arena dtype. ``device``
    (default: the card) holds both shards."""
    import gc

    from nos_tpu_torch.cmd.server import ServerConfig, build_engine
    from nos_tpu_torch.models import handoff
    from nos_tpu_torch.models.serving import DecodeServer, uncaptured
    from nos_tpu_torch.models.transformer import shard_params
    from nos_tpu_torch.parallel.mesh import TpMesh

    t_phase = time.perf_counter()
    out = {"phase": "tensor_parallel_serving", "card": card, **FULL,
           "tp": TP, **TP_PAGED, "new_tokens": TP_NEW}
    device = device or torch.device("cuda", 0)
    mesh = TpMesh([device] * TP)
    L = FULL["n_layers"]
    prompts = full_width_prompts(seed, FULL["vocab"])

    def free():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    free()
    eng = build_engine(ServerConfig(
        bf16=True, paged_kernel="on", seed=seed, **TP_PAGED, **FULL),
        device=device)
    params, cfg = eng.params, eng.cfg
    p_gb = tree_bytes(params) / 1e9

    def engine(tp: int, **kw):
        free()
        return DecodeServer(params if tp == 1 else tpp, cfg, device=device,
                            mesh=mesh if tp > 1 else None,
                            paged_impl="kernel", **{**TP_PAGED, **kw})

    runs = {}
    try:
        # s.1 tp = 1 on the weights alone
        runs["greedy_tp1"] = tp_run(eng, prompts)
        with uncaptured(eng):
            runs["greedy_tp1_eager"] = tp_run(eng, prompts)
        runs["sampled_tp1"] = tp_run(eng, prompts, SAMPLED)
        del eng
        runs["int8_tp1"] = tp_run(engine(1, kv_dtype="int8"), prompts)
        runs["static_tp1"] = tp_run(engine(1, kv_blocks=0,
                                           kv_block_size=0), prompts)
        pre = engine(1, role="prefill")
        pre.submit(prompts[0], TP_NEW)
        state = pre.pop_handoffs()[0]
        wire = handoff.encode_handoff(state)
        del pre
        # s.2 tp = 2: the shards beside the tp = 1 weights (the token
        # rule's teacher-forced reads)
        free()
        tpp = shard_params(params, cfg, mesh)
        runs["greedy_tp2"] = tp_run(engine(2), prompts)
        runs["sampled_tp2"] = tp_run(engine(2), prompts, SAMPLED)
        runs["int8_tp2"] = tp_run(engine(2, kv_dtype="int8"), prompts)
        runs["static_tp2"] = tp_run(engine(2, kv_blocks=0, kv_block_size=0),
                                    prompts)
        out["runs"] = {k: {f: r[f] for f in ("ms_per_tick", "ticks",
                                             "kernel_launches", "peak_gb")}
                       for k, r in runs.items()}
        rules = out["token_rule"] = {}
        for arm in ("greedy", "int8", "static"):
            rules[arm] = token_rule(f"s {arm} tp2", runs[f"{arm}_tp2"]["seqs"],
                                    runs[f"{arm}_tp1"]["seqs"], prompts,
                                    params, cfg)
        rules["sampled"] = sampled_rule(
            "s sampled tp2", runs["sampled_tp2"]["seqs"],
            runs["sampled_tp1"]["seqs"], prompts, params, cfg, SAMPLED,
            tpp, mesh)
        shard_launches = {}
        for arm, arena in (("greedy", "bfloat16"), ("sampled", "bfloat16"),
                           ("int8", "int8"), ("static", None)):
            one, two = runs[f"{arm}_tp1"], runs[f"{arm}_tp2"]
            want = {(1, cfg.head_dim, arena): TP * L * two["ticks"]} \
                if arena else {}
            if two["launches_by_shape"] != want or \
                    two["kernel_launches"] != TP * one["kernel_launches"] \
                    or two["ticks"] != one["ticks"]:
                raise AssertionError(
                    f"s {arm}: tp2 launches {two['launches_by_shape']} "
                    f"(want {want}; tp1 {one['kernel_launches']} over "
                    f"{one['ticks']} ticks, tp2 {two['ticks']})")
            if arena:
                shard_launches[arena] = shard_launches.get(arena, 0) + \
                    two["kernel_launches"]
        # s.3 the handoff into a tp = 2 decode engine
        dec = engine(2, role="decode")
        rid = dec.restore(handoff.decode_handoff(wire))
        again = next(st for st in dec.capture_resumable() if st["rid"] == rid)
        handoff.settle(state["swap"])
        planes = [n for n in ("k", "v", "k_scale", "v_scale")
                  if n in state["swap"]]
        same = all(np.asarray(state["swap"][n]).tobytes()
                   == np.asarray(again["swap"][n]).tobytes() for n in planes)
        if not same or handoff.handoff_nbytes(again) != \
                handoff.handoff_nbytes(state):
            raise AssertionError("s.3: the adopted handoff reads back other "
                                 "bytes from the shards")
        adopted = dec.drain()[rid]
        rules["handoff"] = token_rule(
            "s.3 handoff", [adopted], [runs["greedy_tp1"]["seqs"][0]],
            prompts[:1], params, cfg)
        del dec
        keep = ("ms_per_tick", "tokens_per_s", "ticks", "kernel_launches",
                "prefill_s", "peak_gb")
        rows = {k: {f: r[f] for f in keep} for k, r in runs.items()}
        for k, r in rows.items():
            # what the engine itself needs: the other layout's weights
            # (resident beside it) taken out
            r["peak_gb_engine"] = r["peak_gb"] - (p_gb if "tp2" in k else 0)
            r["launches_by_shape"] = {str(s): n for s, n in
                                      runs[k]["launches_by_shape"].items()}
        out.update({"weights_gb": p_gb, "runs": rows,
                    "handoff_bytes": len(wire), "handoff_planes": planes,
                    "handoff_bytes_equal": True,
                    "shard_kernel_launches": shard_launches,
                    "tp2_vs_tp1_eager_ms_per_tick":
                        rows["greedy_tp2"]["ms_per_tick"]
                        / rows["greedy_tp1_eager"]["ms_per_tick"]})
        return shard_launches
    finally:
        free()
        out["seconds"] = time.perf_counter() - t_phase
        emit(out)


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
    # a run that hangs prints every thread's stack and exits non-zero
    # before the 1200 s a run may take
    faulthandler.dump_traceback_later(HANG_S, exit=True)
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
        paged["int8_launches"], served["int8_greedy"] = phase_full_width(
            args.seed, "int8", card)
        paged["sampled_launches"], served["sampled"] = phase_full_width(
            args.seed, "bf16", card, sampled=True)
    if "i" in args.phases:
        paged["http_launches"] = phase_http(args.seed, card, served)
    if "j" in args.phases:
        paged["pipeline_launches"] = {
            f"{r['kv_dtype']}_{r['mode']}_depth{r['pipeline_depth']}"
            f"_T{r['decode_steps']}": r["kernel_launches"]
            for r in phase_pipeline(args.seed, card, served)}
    if "k" in args.phases:
        k = phase_k(args.seed, card, flush)
        paged["prefix_launches"] = k["launches"]
        paged["in_arena_windows"] = k["windows"]
        paged["window"] = {key: k["window"][key] for key in (
            "S", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}
    if "l" in args.phases:
        paged["kv_payload_launches"] = phase_l(args.seed, card, served)
    if "m" in args.phases:
        paged["kv_fabric_tenant_launches"] = phase_m(args.seed, card)
    spec = {}
    if "n" in args.phases:
        spec = phase_n(args.seed, card, flush)
    if "o" in args.phases:
        paged["moe_launches"] = phase_moe(args.seed, card, flush)
    adamw = {}
    g_row = None
    if "g" in args.phases:
        g_row = phase_train(args.seed, card)
        launches = g_row["launches"]
        for name, row in flash.items():
            row["launches"] = launches[name]
        adamw = check_adamw(args.seed, device, flush)
        adamw["launches"] = launches["adamw"]
    moe_flash = {}
    if "p" in args.phases:
        moe_flash = phase_moe_train(args.seed, card, device, flush)
    if "q" in args.phases:
        # each flash kernel's launches in (q.1)'s run of every policy
        by_policy = phase_remat(args.seed, card, device, g_row)
        for name, row in flash.items():
            row["launches_by_remat_policy"] = {
                p: r[name] for p, r in by_policy.items()}
    if "r" in args.phases:
        # the training kernels' launches over (r)'s three runs
        watched = phase_watcher(args.seed, card, g_row)
        for name, row in flash.items():
            row["launches_lifecycle_watcher"] = watched[name]
        if adamw:
            adamw["launches_lifecycle_watcher"] = watched["adamw"]
    tp_launches = {}
    if "s" in args.phases:
        tp_launches = phase_tp(args.seed, card)
    del flush
    emit({"phase": "done", "seconds": time.perf_counter() - t_all,
          "card": card})
    if set(PHASES) - set(args.phases):
        return 0
    tp_shard = paged.pop("tp_shard")
    kernels = [paged]
    # phase (s)'s shape of the same kernel: one shard's heads at tp = 2
    # (16 query / 4 kv heads), its launches (s)'s tp = 2 paged runs'
    for arena, dtype in (("bf16", "bfloat16"), ("int8", "int8")):
        row = tp_shard[arena]
        kernels.append({
            "name": f"paged_decode_attention_tp_shard_{arena}",
            "route": "cuda",
            "source": "nos_tpu_torch/csrc/paged_decode_attention.cu",
            "replaces": "nos_tpu/ops/attention.py:430",
            "shape": {k: row[k] for k in ("b", "h", "h_kv", "d", "S",
                                          "arena")},
            "launches": tp_launches[dtype],
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}})
    # phase (n)'s shapes of the same kernel: the speculative engine's
    # verify window and the draft's step, each in bf16 and int8, their
    # launches counted by shape in (n.2)'s greedy (1, 1) runs of the
    # paged bf16 and int8 arms with the seeded draft
    for label, row in spec["kernels"].items():
        kernels.append({
            "name": f"paged_decode_attention_{label}", "route": "cuda",
            "source": "nos_tpu_torch/csrc/paged_decode_attention.cu",
            "replaces": "nos_tpu/ops/attention.py:430",
            "shape": {k: row[k] for k in ("b", "h", "h_kv", "d", "S",
                                          "arena")},
            "launches": spec["launches"][label],
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}})
    # phase (p)'s attention shape of the same kernels (Mixtral's heads),
    # their launches p.1's through MoE layers
    for suffix, rows in (("", flash), ("_moe_train", moe_flash)):
        for name, row in rows.items():
            kernels.append({"name": name + suffix, "route": "cuda",
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
