"""Continuous-batching decode serving (port of
``nos_tpu/models/serving.py``): the slot-static engine (``kv_blocks``
0, the reference's default) and the paged one.

Requests occupy rows ("slots") of one decode batch. On the slot-static
engine each slot owns a ``[max_len]`` row of one cache with a per-row
``pos`` (``init_cache(per_row_pos=True)``): a prompt prefills over a
bucket-sized scratch row that is installed whole into the slot's row,
the decode tick runs ``forward_with_cache`` over every row, and a
prefix cache (``prefix_cache_size`` entries, LRU) keeps published
prompts' K/V rows, which a later prompt sharing their head copies into
its scratch row. It has no preemption, no fork, no int8 KV and no
handoff roles, as the reference's has none; a supervised restart
re-prefills a restored request's committed sequence
(``_resume_recompute_static``).

On the paged engine (``kv_blocks`` > 0) a slot's KV lives in a
pooled arena mapped per slot by block tables. ``submit`` admits a
request to a free slot and prefills it at once over a scratch row
(``forward_with_cache``, the prompt padded to a power-of-two bucket),
then installs the row into the slot's freshly allocated blocks —
quantizing into an int8 arena when ``kv_dtype="int8"``. Greedy requests
are token-identical to ``generate_paged``. Every slot carries its own
sampling params (temperature, top-k, top-p, seed), and a sampled token
is keyed by (seed, absolute position), so a request's stream depends
neither on what else shares the batch nor on how ticks are fused.

Admission, as the reference runs it under paging:

- ``prefix_cache_size`` > 0 keeps a block-granular prefix index
  (``PrefixBlockIndex``): a ``cache_prefix`` prompt publishes its full
  blocks, and a later prompt that starts with them shares them by
  refcount. With the kernel formulation a prefix hit prefills its
  suffix IN the arena: one bucketed S > 1 window of
  ``forward_paged`` over a one-row view, which scatters the suffix's
  K/V into fresh blocks and attends over the shared head through the
  block table; with the gather formulation the shared blocks seed a
  scratch row. A shared block is copied before its first write
  (copy-on-write, scale planes included), and ``fork`` shares an
  active request's whole table.
- ``prefill_chunk`` > 0 prefills a long suffix one chunk per tick,
  interleaved with decode ticks, over the full block table reserved at
  admission; ``prefill_budget`` > 0 spends at most that many prompt
  tokens a tick, picking chunks earliest-deadline-first on TTFT slack
  and clamping to zero while a decoding slot is out of TPOT slack.
  Scheduling changes only when a chunk runs, never its contents.

The decode tick is one program over the engine's persistent device
buffers (``_decode_program``): ``decode_steps`` = T copies of the
reference's fused step (the keep-masked table, ``forward_paged``, pos
frozen for inactive rows, argmax, the sampling ops when a slot samples,
the next feed tokens), writing ``pos``, the feed tokens and a
``[max_batch, T]`` token buffer in place. On the card each program
(greedy, sampled) is captured once into a CUDA graph, the counterpart
of the reference's jitted program, and every tick is one replay; the
first capture per key is accounted as the reference accounts a compile.
On the CPU the program is called directly. Slots still prefilling ride
the tick as rows outside the keep mask, into the null block.

A tick is three phases, as in the reference, so a serving loop can run
the one blocking wait outside its lock: ``step_begin`` dispatches ticks
until ``pipeline_depth`` are in flight, each followed by a non-blocking
copy of its tokens into its own pinned host buffer behind a CUDA event;
``step_wait`` blocks on the oldest's event only; ``step_finish``
consumes it (appending up to T tokens a slot, stopping at ``done``),
runs the prefill chunks, retires completions and admits. A completion
observed late (pipelining) or mid-burst (fused steps) has
over-decoded; the overrun is never appended, and resetting the slot's
pos rolls it back. Every change of the batch (admission, ``cancel``,
``fork``) first consumes the whole window (the reference's barrier
``_flush``), block frees wait for the window to drain, and every write
to a device buffer the program reads (a table row, a copy-on-write, an
install, an in-arena window) is queued on the engine's stream behind
the ticks in flight. Each request keeps the reference's latency ledger
(``pop_ledger``), read by the serving loop's TTFT/TPOT histograms.

Under block pressure the engine frees blocks in the reference's order:
flush the window, land deferred frees, evict one LRU prefix chain, then
preempt the lowest-priority (then youngest) decoding slot, re-enqueued
at the front of the queue. ``kv_swap`` picks how it resumes: swap (the
slot's committed blocks copied to host and restored byte for byte) or
recompute (``prompt + out[:-1]`` re-prefilled over a scratch row; under
the kernel formulation the prompt alone is re-prefilled, in its
admission's bucket, and the committed output tokens are replayed through
the paged kernel at the tick's width, one step a token, so every
rewritten position is the arithmetic that first wrote it). The same payload
carries a supervised restart (``capture_resumable`` / ``restore``) and
the prefill->decode handoff: ``role="prefill"`` parks each request after
its first token as a handoff state (``pop_handoffs``), and a
``role="decode"`` engine adopts one through ``restore``. The payload
keeps the reference's layout and dtype names (``models/handoff.py``), so
JAX and torch engines adopt each other's.

A recompute resume under the kernel formulation repeats what the
request's admission did (recorded on the request): a prefix hit re-takes
its shared head and re-runs the same S > 1 window, a chunked admission
re-runs the same chunks, a one-shot admission re-prefills in the same
bucket. Each writes the prompt's K/V with the arithmetic that first
wrote it; a head evicted meanwhile falls back to the one-shot re-prefill.

The KV fabric rides the same payload. ``host_tier`` (a
``HostTierStore``) catches a prefix chain the index evicts (demote) and
hands it back on a later miss (promote, through the restore scatter,
bit-exact); ``export_chain_begin``/``export_chain_finish`` serve a chain
by its fleet-wide digest from the arena or the host tier, and
``ingest_chain`` adopts a peer's chain into this engine's prefix index,
inside the requester's tenant scope. Every payload plane crosses the
link through a pinned staging pool (``models/staging.py``): swap-out,
capture, the handoff, demotion and export copy the device planes into a
pinned slab behind an event on the engine's stream (for swap-out, the
handoff and demotion the copy on to pageable memory finishes on the
pool's worker, and a reader settles on its event first), and swap-in,
promotion and ingest copy host planes into a slab and up from there.

``tenant_quota`` (a ``TenantQuotaConfig``) turns the admission queue
into the reference's weighted pick over tenants: guaranteed tenants
first, borrowers by their fair share, a tenant over its max shed at
``submit`` under contention (``TenantQuotaExceeded``), and a guaranteed
tenant waiting with no slot or no blocks reclaims the most-over-quota
tenant's youngest slot through ``_preempt_slot``. Prefix chains are
scoped by the resolved tenant unless the config shares them. With SLO
objectives in the config the engine keeps the per-tenant chip-second
ledger (``chip``) the serving loop reads.

With ``mesh`` (a ``parallel.mesh.TpMesh`` of tp devices) the engine
serves tensor-parallel, single-controller as the reference's does: the
params split over the mesh (``transformer.shard_params``; plain params
are split here), the arena, its scale planes and the slot-static cache
split along the head axis (``HeadShards``: ``[L, NB, Hkv/tp, bs, D]`` a
shard), and one host state (block tables, ``pos``, the allocator, every
scheduling decision) whose device rows live on shard 0's device. Every
forward runs shard by shard (``models/generate.py``), and every engine
op on the arena (the scatter, a COW copy, swap out and in, the replay,
handoff capture and restore, demotion and promotion, fabric export and
ingest) reads and writes each shard through ``HeadShards``' indexing,
whose reads gather the heads in shard order: a payload's bytes are the
reference's layout at any tp, so a tp = 2 engine adopts a tp = 1
engine's handoff and the other way round. Under a mesh the programs run
eagerly (no CUDA graph is captured), and each shard's paged kernel takes
the kernel's own split scratch.

What the reference engine has and this slice does not yet port raises
a ``ValueError`` naming the knob: a mesh under the MoE family or the
speculative engine.
"""
from __future__ import annotations

import contextlib
import gc
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nos_tpu_torch.device import DeviceLike, resolve_device
from nos_tpu_torch.kvfabric.codec import (
    chain_digest, decode_chain, encode_chain,
)
from nos_tpu_torch.models.errors import (
    DEFAULT_TENANT, Infeasible, NotPorted, QueueFull, TenantQuotaExceeded,
)
from nos_tpu_torch.models.generate import (
    Cache, _tempered, _truncate_logits_rows, check_mesh, forward_paged,
    forward_with_cache, init_cache, init_paged_cache,
)
from nos_tpu_torch.models.handoff import (
    BF16, READY, handoff_nbytes, plane_bits, plane_dtype, settle,
)
from nos_tpu_torch.models.staging import PinnedStaging
from nos_tpu_torch.models.tenantquota import (
    TenantQuotaConfig, TenantScheduler,
)
from nos_tpu_torch.models.kvblocks import (
    BlockAllocator, NoFreeBlocks, PrefixBlockIndex, ScaleLedger,
    blocks_for,
)
from nos_tpu_torch.models.transformer import (
    Params, TpParams, TransformerConfig, shard_params,
)
from nos_tpu_torch.obs.slo import ChipLedger
from nos_tpu_torch.ops import _kernels
from nos_tpu_torch.ops.attention import (
    check_paged_kernel_head_dim, dequantize_kv, effective_paged_impl,
    quantize_kv,
)
from nos_tpu_torch.utils import prng

__all__ = ["DecodeServer", "QueueFull", "Infeasible"]


def _bucket(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


def _not_ported(knob: str, what: str) -> NotPorted:
    return NotPorted(
        f"{knob} is not ported to the torch engine yet ({what}); the "
        f"JAX engine nos_tpu.models.serving.DecodeServer serves it")


def reject_unported(*, mesh=None, n_experts: int = 0,
                    draft: bool = False) -> None:
    """Raise a ValueError naming the first engine knob set outside this
    slice (a mesh under the MoE family or the speculative engine);
    ``build_engine`` calls it before loading any weights."""
    if mesh is not None and n_experts > 0:
        raise _not_ported("n_experts under a mesh",
                          "tensor-parallel MoE serving")
    if mesh is not None and draft:
        raise _not_ported("a draft under a mesh",
                          "tensor-parallel speculative decoding: the "
                          "draft and target arenas in lockstep")


def _dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype under numpy's (and the reference payload's) name:
    ``torch.bfloat16`` -> ``"bfloat16"``."""
    return str(dtype).rsplit(".", 1)[-1]


class _Ledger:
    """Per-request lifecycle stamps on the host monotonic clock
    (time.perf_counter), as the reference keeps them: submitted ->
    admitted-to-slot -> prefill start/end -> first token observed ->
    per-arrival token batches -> done. The serving loop turns a finished
    ledger into the TTFT / TPOT / queue / e2e histograms. TPOT is stored
    as ``(gap_s, n_tokens)`` pairs, one clock read per consumed arrival;
    the first token only arms ``t_last``."""

    __slots__ = ("t_submit", "t_admit", "t_prefill_start", "t_prefill_end",
                 "t_first", "t_last", "t_done", "outcome", "tpot")

    def __init__(self, now: float):
        self.t_submit = now
        self.t_admit = 0.0
        self.t_prefill_start = 0.0
        self.t_prefill_end = 0.0
        self.t_first = 0.0          # first token observed on the host
        self.t_last = 0.0           # most recent token observation
        self.t_done = 0.0
        self.outcome: Optional[str] = None
        self.tpot: List[Tuple[float, int]] = []     # (gap_s, tokens)

    def note_tokens(self, n: int, now: float) -> None:
        """Attribute ``n`` tokens observed at host instant ``now``."""
        last = self.t_last
        if last:
            self.tpot.append((max(0.0, now - last), n))
        self.t_last = now

    def snapshot(self, req: "_Request") -> dict:
        """The finished-request record the serving loop reads.
        ``ttft_s`` is None for a request that never produced a token
        (cancelled while pending)."""
        admitted = self.t_admit > 0.0
        return {
            "rid": req.rid,
            "tenant": req.tenant,
            "outcome": self.outcome or "finished",
            "prompt_tokens": len(req.prompt),
            "output_tokens": min(len(req.out), req.max_new_tokens),
            "queue_s": (self.t_admit if admitted else self.t_done)
            - self.t_submit,
            "prefill_s": (self.t_prefill_end - self.t_prefill_start
                          if self.t_prefill_end else None),
            "ttft_s": (self.t_first - self.t_submit
                       if self.t_first else None),
            "e2e_s": self.t_done - self.t_submit,
            "tpot": list(self.tpot),
        }


@dataclass
class _Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    seed: int = 0
    out: List[int] = field(default_factory=list)
    slot: int = -1
    cache_prefix: bool = False
    stop_tokens: tuple = ()
    led: Optional[_Ledger] = None
    # under block pressure the lowest priority (then the youngest) slot
    # is preempted; a preempted request waits at the front of the queue
    # with its committed tokens, and a swapped one with the host copy of
    # its KV blocks (its resume goes through restore or recompute, not a
    # fresh prefill)
    priority: int = 0
    tenant: str = DEFAULT_TENANT
    preempted: bool = False
    swap_state: Optional[dict] = None
    # paged admission plumbing: prefix blocks claimed for this request
    # (refcounts already bumped) and the full block table reserved at a
    # chunked or in-arena admission
    shared_blocks: List[int] = field(default_factory=list)
    reserved_blocks: Optional[List[int]] = None
    # absolute completion deadline on the engine's slack clock (None =
    # none): budgeted prefill orders chunk work by the slack left
    # against it
    deadline: Optional[float] = None
    # how the prompt's K/V was written, for a recompute resume to repeat
    # it under the kernel formulation: ("window", m, sbucket) for a
    # prefix hit's in-arena window, ("chunked", m, bucket) for chunks
    # over a scratch row, None for a one-shot prefill
    admission: Optional[tuple] = None
    # the speculative engine: True when the draft prefilled in chunks,
    # and each committed round as (start position, tokens committed),
    # so that a recompute resume repeats what wrote the K/V
    draft_chunked: bool = False
    rounds: List[Tuple[int, int]] = field(default_factory=list)

    def note_token(self) -> None:
        """After each appended token: a stop token ends the request (the
        stop token is part of the output) by truncating
        ``max_new_tokens`` to what was produced."""
        if self.stop_tokens and self.out[-1] in self.stop_tokens:
            self.max_new_tokens = len(self.out)

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new_tokens


class _InFlight:
    """One dispatched, unconsumed decode tick: its own host buffer of
    ``[max_batch, T]`` tokens (pinned on the card), the event that marks
    the copy into it done (None on the CPU, where the copy is
    synchronous), the slots it decoded, and (once fetched) the tokens as
    lists. ``consumed`` makes consumption idempotent, so a barrier flush
    racing ``step_finish`` processes the tick exactly once."""

    __slots__ = ("buf", "event", "slots", "host", "consumed")

    def __init__(self, buf: torch.Tensor, event, slots: Tuple[int, ...]):
        self.buf = buf
        self.event = event
        self.slots = slots
        self.host: Optional[List[List[int]]] = None
        self.consumed = False


class _Graph:
    """One captured program (a decode tick, or the replay step): the
    graph, its output (the last step's logits, rewritten by every
    replay), the paged kernel's scratch tensors its launches recorded
    (held so they outlive any replacement), and its memory pool's
    reserved bytes at capture."""

    __slots__ = ("graph", "logits", "scratch", "pool_bytes")

    def __init__(self, graph, logits: torch.Tensor, scratch: tuple,
                 pool_bytes: int):
        self.graph = graph
        self.logits = logits
        self.scratch = scratch
        self.pool_bytes = pool_bytes

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        return self.logits


def install_row(cache: Cache, slot: int, row: Cache, pos: int) -> None:
    """A prefilled one-row scratch cache into ``slot``'s row of a
    slot-static cache, the whole row (only pos decides what exists), and
    the slot's pos set; queued behind the ticks in flight."""
    n = row["k"].shape[3]
    cache["k"][:, slot, :, :n] = row["k"][:, 0]
    cache["v"][:, slot, :, :n] = row["v"][:, 0]
    cache["pos"][slot].fill_(pos)


@contextlib.contextmanager
def uncaptured(engine: "DecodeServer") -> Iterator[None]:
    """Within the block, ``engine`` runs every captured program (each
    key of ``_program_for``) directly on its device instead of replaying
    its graph: the comparison that ``chip_smoke.py`` and the tests make,
    not a mode to serve in."""
    engine._launch_graph = lambda key: engine._program_for(key)[0]()
    try:
        yield
    finally:
        del engine._launch_graph


class DecodeServer:
    """Continuous-batching engine over ``max_batch`` slots and a paged
    arena of ``kv_blocks`` x ``kv_block_size`` tokens.

    ``submit`` enqueues (and, with a slot free, admits and prefills) a
    request; ``step`` decodes one token for every active slot (or
    ``step_begin`` / ``step_wait`` / ``step_finish`` in turn); ``drain``
    runs to completion and returns {rid: prompt + generated} for the
    requests finished since the last drain. ``preempt`` vacates a slot
    (swap or recompute), ``capture_resumable`` / ``restore`` carry live
    requests into a rebuilt engine, and ``role`` ("prefill", "decode")
    splits prefill from decode through ``pop_handoffs`` / ``restore``.
    Runs on ``device`` (default: the card; the CPU only when asked).
    ``paged_impl`` picks the paged attention formulation, "kernel" or
    "xla" (the gather); None reads ``effective_paged_impl()``. ``mesh``
    (a ``TpMesh``) serves tensor-parallel over its devices."""

    # the speculative engine (a subclass) sets it: a mesh is refused there
    _speculative = False

    def __init__(self, params: Params, cfg: TransformerConfig,
                 max_batch: int = 8, max_len: Optional[int] = None,
                 prefix_cache_size: int = 0, mesh=None,
                 prefill_chunk: int = 0, max_pending: int = 0,
                 pipeline_depth: int = 1, decode_steps: int = 1,
                 kv_block_size: int = 0, kv_blocks: int = 0,
                 kv_swap: bool = True, hbm_admit_frac: float = 0.0,
                 kv_dtype: str = "bf16",
                 tenant_quota: Optional[TenantQuotaConfig] = None,
                 tenant_clock=None, role: str = "colocated",
                 host_tier=None,
                 prefill_budget: int = 0, slack_clock=None,
                 device: DeviceLike = None,
                 paged_impl: Optional[str] = None):
        # the reference's own validation first, same messages
        if prefill_budget < 0:
            raise ValueError(
                f"prefill_budget must be >= 0, got {prefill_budget}")
        if prefill_chunk and (prefill_chunk < 8
                              or prefill_chunk & (prefill_chunk - 1)):
            raise ValueError(
                f"prefill_chunk must be 0 or a power of two >= 8, got "
                f"{prefill_chunk} (chunks are compiled shapes; the final "
                f"partial chunk pads to a power-of-two bucket that must "
                f"not exceed the chunk)")
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if decode_steps < 1:
            raise ValueError(
                f"decode_steps must be >= 1, got {decode_steps}")
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"kv_dtype must be bf16|int8, got {kv_dtype!r}")
        self.paged = kv_blocks > 0
        if kv_dtype == "int8" and not self.paged:
            raise ValueError(
                "kv_dtype=int8 requires the paged KV cache (set "
                "kv_blocks/kv_block_size): the slot-static engine has "
                "no per-block scale storage — run bf16, or enable "
                "paging to use int8 KV")
        if role not in ("colocated", "prefill", "decode"):
            raise ValueError(
                f"role must be colocated|prefill|decode, got {role!r}")
        if role != "colocated" and not self.paged:
            raise ValueError(
                f"role={role} requires the paged KV cache (set "
                f"kv_blocks/kv_block_size): the handoff payload is the "
                f"swap format — quantized blocks + per-block scales — "
                f"which only the paged engine stores")
        reject_unported(mesh=mesh, n_experts=cfg.n_experts,
                        draft=self._speculative)
        # tensor-parallel serving: the cache's head axis over the mesh,
        # the params in the matching split, the control rows on shard
        # 0's device
        self.mesh = mesh
        if mesh is not None:
            check_mesh(mesh)
            if cfg.kv_heads % mesh.tp:
                raise ValueError(
                    f"paged KV on this mesh: kv_heads {cfg.kv_heads} "
                    f"not divisible by tp={mesh.tp} — the block arena "
                    f"shards its head axis over tp (paged_cache_shardings)"
                    f" and cannot split a head; use a tp that divides "
                    f"kv_heads or run kv_blocks=0" if self.paged else
                    f"kv_heads {cfg.kv_heads} not divisible by "
                    f"tp={mesh.tp}; the cache head axis cannot shard "
                    f"evenly")
            if not isinstance(params, TpParams):
                params = shard_params(params, cfg, mesh)
            device = mesh.devices[0]
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len or cfg.max_seq
        self.kv_block_size = bs = kv_block_size if self.paged else 0
        self.kv_dtype = kv_dtype if self.paged else "bf16"
        self.kv_swap = bool(kv_swap)
        self.hbm_admit_frac = float(hbm_admit_frac or 0.0)
        if self.max_len > cfg.max_seq:
            raise ValueError(
                f"cache max_len {self.max_len} exceeds the rope "
                f"table (cfg.max_seq {cfg.max_seq})")
        if self.paged and (bs < 8 or bs & (bs - 1)):
            raise ValueError(
                f"kv_block_size must be a power of two >= 8, got "
                f"{bs} (blocks are compiled copy shapes, and "
                f"power-of-two sizes keep them bucket-aligned)")
        if self.paged and self.max_len % bs:
            raise ValueError(
                f"max_len {self.max_len} must be a multiple of "
                f"kv_block_size {bs}: the gathered per-row timeline "
                f"(blocks_per_slot x block_size) must equal max_len "
                f"exactly so paged attention stays bit-identical to "
                f"the slot-static program")
        # the paged attention formulation, fixed ONCE at build: a later
        # env change cannot flip what this engine runs (None on the
        # slot-static engine, which has no paged attention)
        if paged_impl not in (None, "kernel", "xla"):
            raise ValueError(
                f"paged_impl must be kernel|xla, got {paged_impl!r}")
        self.paged_kernel = ((paged_impl or effective_paged_impl())
                             if self.paged else None)
        self._scales: Optional[ScaleLedger] = None
        self._prefix_max = prefix_cache_size
        # the slot-static prefix cache: (scope, prompt tuple) -> the
        # prompt's K/V rows ([L, 1, Hkv, plen, D] each), LRU in insertion
        # order, at most ``prefix_cache_size`` entries
        self._prefixes: Dict[tuple, tuple] = {}
        if self.paged:
            check_paged_kernel_head_dim(cfg.head_dim, self.device,
                                        self.paged_kernel)
            self._nbs = self.max_len // bs
            self._alloc = BlockAllocator(kv_blocks, bs)
            self.cache = init_paged_cache(cfg, kv_blocks, bs, max_batch,
                                          kv_dtype=kv_dtype,
                                          device=self.device, mesh=mesh)
            if kv_dtype == "int8":
                # per-block scale lifecycle rides the allocator: the
                # decref that frees a block drops its ledger entry
                self._scales = ScaleLedger()
                self._alloc.scale_ledger = self._scales
            # the block-granular prefix index (None = no prefix cache)
            self._pindex = (PrefixBlockIndex(self._alloc,
                                             prefix_cache_size)
                            if prefix_cache_size > 0 else None)
        else:
            # every slot owns a [max_len] row, its pos a vector entry
            self._nbs = 0
            self._alloc = None
            self.cache = init_cache(cfg, max_batch, self.max_len,
                                    per_row_pos=True, device=self.device,
                                    mesh=mesh)
            self._pindex = None
        # the host tier under the arena (a HostTierStore): the index's
        # eviction demotes a chain's payload into it, a later miss that
        # matches a stored chain promotes it back (bit-exact), and the
        # fabric exports from it; every payload crosses the link through
        # the pinned staging pool
        if host_tier is not None and self._pindex is None:
            raise ValueError(
                "host_tier requires the paged KV cache with a prefix "
                "index (kv_blocks/kv_block_size + prefix_cache_size): "
                "the tier stores demoted prefix chains, which only the "
                "paged prefix index produces")
        self._host_tier = host_tier
        self._fabric = {"demote": 0, "promote": 0,
                        "ingest": 0, "ingest_rejected": 0}
        self._digests: Dict[tuple, str] = {}    # chain key -> digest
        self._blk_nbytes: Optional[int] = None
        if self._host_tier is not None:
            self._pindex.on_evict = self._demote_chain
        self._staging = PinnedStaging(self.device)
        # request-level elastic quota (tenant_quota set = on): the
        # weighted tenant pick over the admission queue, the over-max
        # shed at submit, reclaim by preemption, tenant-scoped prefix
        # chains (unless the config shares them), and, when the config
        # carries SLO objectives, the per-tenant chip-second ledger;
        # ``tenant_clock`` injects the rate clock for deterministic runs
        self._tq = (TenantScheduler(tenant_quota)
                    if tenant_quota is not None else None)
        self._tq_clock = tenant_clock or time.perf_counter
        self._prefix_scoped = (tenant_quota is not None
                               and not tenant_quota.share_prefix)
        self.chip = (ChipLedger()
                     if tenant_quota is not None
                     and tenant_quota.slo_enabled() else None)
        self._chip_work: Dict[Tuple[str, str], int] = {}
        self.tenant_reclaims = 0
        self._table = torch.zeros((max_batch, self._nbs), dtype=torch.int32,
                                  device=self.device)
        self._tables: List[List[int]] = [[] for _ in range(max_batch)]
        self._last = torch.zeros((max_batch, 1), dtype=torch.long,
                                 device=self.device)
        # per-slot sampling params, rows the decode tick reads
        self._temp = torch.zeros((max_batch,), dtype=torch.float32,
                                 device=self.device)
        self._topk = torch.zeros((max_batch,), dtype=torch.long,
                                 device=self.device)
        self._topp = torch.zeros((max_batch,), dtype=torch.float32,
                                 device=self.device)
        self._seed = torch.zeros((max_batch,), dtype=torch.long,
                                 device=self.device)
        # the decode program's other static buffers: the rows that decode
        # (copied in when the active-slot set changes, outside the
        # program), the tokens of its T steps, and the paged kernel's
        # split-merge scratch, which this engine owns so that nothing
        # else can replace what its graphs replay
        self._keep = torch.zeros((max_batch,), dtype=torch.bool,
                                 device=self.device)
        self._keep_for: Optional[Tuple[int, ...]] = None
        self._toks = torch.zeros((max_batch, decode_steps), dtype=torch.long,
                                 device=self.device)
        self._scratch = _kernels.PagedScratch()
        # the replay program's static buffers (a recompute resume under
        # the kernel formulation): one decode step at the tick's width,
        # only the resumed row's table live, every other row on the null
        # block, so each replayed position sees the tick's shapes
        self._rtoks = torch.zeros((max_batch, 1), dtype=torch.long,
                                  device=self.device)
        self._rpos = torch.zeros((max_batch,), dtype=torch.int32,
                                 device=self.device)
        self._rtable = torch.zeros((max_batch, self._nbs),
                                   dtype=torch.int32, device=self.device)
        # captured programs by key (``sampling`` for the decode tick,
        # "replay" for the replay step) and the side stream they are
        # captured on
        self._graphs: Dict[object, _Graph] = {}
        self._capture_stream = None
        self.max_pending = max_pending
        self._free: Deque[int] = deque(range(max_batch))
        self._active: Dict[int, _Request] = {}      # slot -> request
        self._pending: Deque[_Request] = deque()
        self._done: Dict[int, _Request] = {}
        self._admit_blocked = False
        self._next_rid = 0
        # the surface the serving loop reads, with the reference's names
        # and the values the reference engine has when these features
        # are off
        self.role = role
        self.pipeline_depth = pipeline_depth
        self.decode_steps = decode_steps
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        # copy-on-write block copies issued (fork and prefix sharing) and
        # in-arena prefill windows run (prefix hits under the kernel)
        self.cow_copies = 0
        self.arena_windows = 0
        # preemptions by resume mode, and committed tokens replayed
        # through the replay program by recompute resumes
        self.preempts = {"swap": 0, "recompute": 0}
        self.replayed_tokens = 0
        # recompute resumes by the path that rewrote the prompt's K/V:
        # the admission's own ("oneshot", "window", "chunked"), or the
        # one-shot re-prefill when a window's or chunked admission's
        # shared head is gone ("fallback")
        self.resume_paths = {"oneshot": 0, "window": 0, "chunked": 0,
                             "fallback": 0}
        # role="prefill": requests that finished prefill park here as
        # handoff states (the swap-payload format) until the serving loop
        # ships them, in admission order; the counters feed /stats and
        # the loop's handoff metrics
        self._handoffs: Dict[int, dict] = {}
        self.handoffs = 0
        self.handoff_payload_bytes = 0
        self.handoff_capture_s = 0.0
        # chunked prefill (prefill_chunk > 0): a long suffix prefills one
        # chunk per tick, interleaved with decode ticks. Entries: {"req",
        # "row" (the scratch row mid-prefill), "todo" (the remaining
        # token chunks), "step" (the last position's logits, once
        # done)}; the request holds its slot and its reserved blocks
        self._prefill_chunk = prefill_chunk
        self._prefilling: Deque[dict] = deque()
        # per-tick prefill budget in prompt tokens (0 = one chunk a tick
        # for the head entry): credit capped at max(budget, chunk), EDF
        # on TTFT slack, clamped while a decoding slot is out of TPOT
        # slack, one TTFT-critical overdraw a tick
        self.prefill_budget = prefill_budget
        self._prefill_credit = 0.0
        # the clock every deadline is read on (submit stamps, EDF, the
        # clamp); injectable so tests schedule deterministically
        self._slack_clock = slack_clock or time.monotonic
        # rolling cost model: host seconds per prefill prompt token
        # (around each chunk forward) and per decode tick (the serving
        # loop's tick phases, or step()'s own reading); the hints pin
        # the estimates
        self._chunk_tok_s: Deque[float] = deque(maxlen=64)
        self.prefill_tok_s_hint: Optional[float] = None
        self.tick_s_hint: Optional[float] = None
        self.prefill_chunk_tokens = 0       # every chunk-forward token
        self.prefill_budget_spent = 0       # tokens charged to a budget
        self.prefill_budget_clamped = 0     # ticks clamped for TPOT slack
        self.prefill_budget_overrides = 0   # TTFT-critical overdraws
        # admission-time device-memory snapshot (the HBM gauges' source
        # between the loop's interval samples); None on the CPU
        self.hbm: Optional[dict] = None
        self._hbm_next = 0.0
        # the in-flight window (up to pipeline_depth ticks, consumed in
        # dispatch order), block frees parked while it is not empty, and
        # tokens a barrier flush consumed, credited to the next
        # step_finish
        self._inflight: Deque[_InFlight] = deque()
        self._deferred: List[int] = []
        self._flush_emitted = 0
        self.ticks = 0
        # dispatch economics: time with no tick in flight while slots
        # could decode, host time blocked in dispatch and fetch, the last
        # step_begin's assembly share
        self.dispatch_gap_s = 0.0
        self.host_block_s = 0.0
        self.ticks_dispatched = 0
        self.pipeline_flushes = 0
        self.tokens_emitted = 0
        self._idle_since: Optional[float] = None
        self.last_assemble_s = 0.0
        self._begin_dispatch_s = 0.0
        self._tick_s: Deque[float] = deque(maxlen=64)
        # request-level latency ledgers, FIFO-capped until popped
        self.ledger_enabled = True
        self.ledger_cap = 4096
        self._ledgers: Dict[int, dict] = {}
        # compile accounting: the first capture of each program on the
        # card (the CPU captures nothing)
        self.compiles = 0
        self.compile_s = 0.0
        self.compile_events: List[float] = []

    # ------------------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 0.0, seed: Optional[int] = None,
               cache_prefix: bool = False,
               stop_tokens: Optional[List[int]] = None,
               priority: int = 0, tenant: Optional[str] = None,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue a request; returns its id. ``temperature`` 0 is greedy;
        > 0 samples, optionally truncated by ``top_k``/``top_p``.
        ``seed`` keys the request's sample stream (default: the request
        id): the same (prompt, params, seed) gives the same tokens
        whatever else shares the batch. A token in ``stop_tokens`` ends
        the request (it is part of the output). ``cache_prefix``
        publishes the prompt's full blocks to the prefix cache (ignored
        without one). ``deadline_s`` is the request's remaining budget
        in seconds: budgeted prefill orders chunk work by the slack left
        against it (enforcement stays with the serving loop).
        ``priority`` orders preemption under block pressure: the
        lowest priority (then the youngest) slot yields first;
        ``tenant`` names the request's quota under a tenant config (its
        prefix scope, its rate; ignored without one).
        ``Infeasible`` (a ValueError) when it can never fit this server,
        ``QueueFull`` when ``max_pending`` requests already wait,
        ``TenantQuotaExceeded`` (a QueueFull) when the tenant is at its
        max rate while the engine is under contention."""
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(prompt) + max_new_tokens > self.max_len:
            raise Infeasible(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds cache length {self.max_len}")
        # total KV the request can ever need: positions
        # [0, plen + max_new - 1)
        need = (blocks_for(len(prompt) + max_new_tokens - 1,
                           self.kv_block_size) if self.paged else 0)
        if self.paged and need > self._alloc.capacity:
            raise Infeasible(
                f"request needs {need} KV blocks at its full length "
                f"but the pool only has {self._alloc.capacity} "
                f"(kv_blocks={self._alloc.num_blocks}, "
                f"kv_block_size={self.kv_block_size}); no amount of "
                f"retrying can serve it")
        if temperature <= 0 and (top_k or top_p):
            raise ValueError(
                "top_k/top_p only apply when sampling — set temperature "
                "> 0 (greedy decoding ignores truncation)")
        if top_k < 0 or not (0.0 <= top_p <= 1.0):
            raise ValueError(
                f"top_k must be >= 0 and top_p in [0, 1]: got "
                f"top_k={top_k}, top_p={top_p}")
        if self._tq is not None:
            now = self._tq_clock()
            busy = bool(not self._free or self._pending
                        or self._prefilling)
            if busy and self._tq.over_max(tenant, now):
                # the ladder's last rung: at or over its max rate while
                # the engine has contention, the tenant backs off on ITS
                # quota; an idle engine keeps lending past max
                self._tq.note_shed(tenant)
                spec = self._tq.cfg.spec(tenant)
                raise TenantQuotaExceeded(
                    f"tenant {self._tq.cfg.resolve(tenant)!r} is at "
                    f"{self._tq.rate(tenant, now):.1f} tokens/s, "
                    f"max {spec.max_rate:.1f}, with the engine under "
                    f"contention; back off until the window drains")
        if self.max_pending and len(self._pending) >= self.max_pending:
            if not self._free:
                raise QueueFull(
                    f"{len(self._pending)} requests already waiting "
                    f"(max_pending={self.max_pending}); shed load and "
                    f"retry")
            if self._admit_blocked:
                raise QueueFull(
                    f"{len(self._pending)} requests already waiting "
                    f"(max_pending={self.max_pending}) on KV-block/HBM "
                    f"headroom; shed load and retry",
                    reason="hbm_admission")
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append(_Request(
            rid, [int(t) for t in prompt], max_new_tokens,
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p),
            seed=(rid if seed is None else int(seed)) & 0xFFFFFFFF,
            cache_prefix=bool(cache_prefix) and self._prefix_max > 0,
            stop_tokens=tuple(int(t) for t in stop_tokens or ()),
            led=_Ledger(time.perf_counter()), priority=int(priority),
            tenant=(str(tenant) if tenant else DEFAULT_TENANT),
            deadline=(self._slack_clock() + float(deadline_s)
                      if deadline_s else None)))
        self._admit()
        return rid

    def _admit(self) -> None:
        self._admit_blocked = False
        if self._pending and self._free:
            # barrier: an install changes the batch, and an unconsumed
            # tick still reads the old slot -> request binding
            self._flush()
        while self._pending:
            if not self._free:
                # a guaranteed tenant waiting with every slot busy may
                # reclaim the most-over-quota tenant's youngest slot;
                # otherwise the queue waits for a completion
                if not self._reclaim_for(
                        self._pending[self._pick_pending()]):
                    break
                continue
            i = self._pick_pending()
            req = self._pending[i]
            if self.paged and not self._admit_headroom(req):
                # free slots, but the picked request waits for KV-block
                # or device-memory headroom that completions free; a
                # guaranteed tenant reclaims blocks as it reclaims slots
                if self._reclaim_for(req):
                    continue
                self._admit_blocked = True
                break
            del self._pending[i]
            req.slot = self._free.popleft()
            self._active[req.slot] = req
            # a preempted (or restored) request resumes through its swap
            # payload or by recompute instead of a fresh prefill
            req.led.t_admit = req.led.t_prefill_start = time.perf_counter()
            if req.swap_state is not None:
                self._resume_swapped(req)
            elif req.preempted:
                self._resume_recompute(req)
            else:
                self._prefill_slot(req)

    def _pick_pending(self) -> int:
        """Index of the next request to admit: FIFO without a tenant
        scheduler; with one, the weighted tenant pick (guaranteed
        tenants first, borrowers by their fair share, over-max tenants
        last), arrival order within a tenant."""
        if self._tq is None or len(self._pending) <= 1:
            return 0
        t = self._tq.pick((r.tenant for r in self._pending),
                          self._tq_clock())
        for i, r in enumerate(self._pending):
            if self._tq.cfg.resolve(r.tenant) == t:
                return i
        return 0

    def _reclaim_for(self, req: _Request) -> bool:
        """Quota reclaim for ``req``'s tenant: when a GUARANTEED tenant
        (under its min rate) waits with no free slot or no block
        headroom, preempt the most-over-quota tenant's youngest slot
        (swap or recompute per ``kv_swap``, re-enqueued at the front of
        the queue). Never a tenant within its min, never the requester's
        own, never on the slot-static engine (it has no preemption).
        True when it made progress (a preemption, or a flush that freed
        a slot)."""
        if self._tq is None or not self.paged:
            return False
        now = self._tq_clock()
        if not self._tq.under_min(req.tenant, now):
            return False
        me = self._tq.cfg.resolve(req.tenant)

        def victims():
            pre = {e["req"].slot for e in self._prefilling}
            out = []
            for s, r in self._active.items():
                if s in pre or r.done or not r.out:
                    continue
                vt = self._tq.cfg.resolve(r.tenant)
                if vt == me or not self._tq.over_min(r.tenant, now):
                    continue
                out.append((s, r, vt))
            return out

        # scan before paying the flush barrier: with nothing preemptible
        # this runs on every _admit, and a flush each time would
        # serialize the pipelined decode for nothing
        if not victims():
            return False
        free0 = len(self._free)
        self._flush()       # barrier: preemption needs a drained window
        if len(self._free) > free0:
            return True     # a late completion freed a slot
        cands = victims()
        if not cands:
            return False
        # most over quota first (over-rate by fair borrow share), the
        # youngest slot within it; one shares build for the ranking
        shares = self._tq.borrow_shares(now)
        ratios = {vt: self._tq.over_quota_ratio(vt, now, shares)
                  for _, _, vt in cands}
        s, _r, _vt = max(
            cands, key=lambda c: (ratios[c[2]], c[1].led.t_admit))
        self._preempt_slot(s, "swap" if self.kv_swap else "recompute")
        self.tenant_reclaims += 1
        return True

    def _prefix_scope(self, req: _Request) -> Optional[str]:
        """The prefix-cache partition this request may share K/V with:
        its RESOLVED tenant under a tenant-scoped cache, one global
        scope (None) otherwise (no tenancy, or ``share_prefix``)."""
        return self.prefix_scope_for(req.tenant)

    def prefix_scope_for(self, tenant: Optional[str]) -> Optional[str]:
        """The ``_prefix_scope`` rule for a raw tenant label (the
        peer-pull ingest resolves the requester's scope before any
        pulled chain enters the cache)."""
        if not self._prefix_scoped:
            return None
        return self._tq.cfg.resolve(tenant)

    def _hbm_sample(self) -> Optional[dict]:
        """The card's memory in use by PyTorch and its capacity, sampled
        at most twice a second, as the reference's ``hbm`` snapshot;
        None on the CPU."""
        if self.device.type != "cuda":
            return None
        now = time.perf_counter()
        if self.hbm is None or now >= self._hbm_next:
            self._hbm_next = now + 0.5
            self.hbm = {
                "device": str(self.device if self.device.index is not None
                              else torch.device("cuda", 0)),
                "in_use": int(torch.cuda.memory_allocated(self.device)),
                "limit": int(torch.cuda.mem_get_info(self.device)[1])}
        return self.hbm

    def _admit_headroom(self, req: _Request) -> bool:
        """Memory-aware admission: the request's install blocks plus one
        block of growth headroom (capped at its full-length need) must
        be free, and the card's memory below ``hbm_admit_frac``. Cached
        prefix chains are the cheapest memory: LRU chains are evicted
        for a waiting head rather than stall it (with no slot decoding,
        nothing else would ever free a block)."""
        plen = len(req.prompt)
        if req.swap_state is not None:
            base_need = req.swap_state["nblk"]
        elif req.preempted:
            base_need = blocks_for(plen + len(req.out) - 1,
                                   self.kv_block_size)
        else:
            base_need = blocks_for(plen, self.kv_block_size)
        cap_blocks = blocks_for(plen + req.max_new_tokens - 1,
                                self.kv_block_size)
        need = min(base_need + 1, max(base_need, cap_blocks))
        hbm = self._hbm_sample()
        if self.hbm_admit_frac and hbm and hbm["limit"] \
                and hbm["in_use"] / hbm["limit"] > self.hbm_admit_frac:
            return False
        if need <= self._alloc.free_count:
            return True
        if self._pindex is not None:
            self._pindex.evict_lru(need - self._alloc.free_count)
            return need <= self._alloc.free_count
        return False

    def _tokens(self, toks: List[int]) -> torch.Tensor:
        """One row of token ids on the device, queued behind the ticks
        in flight (a chunk may run while ticks are in flight)."""
        return self._to_device(torch.tensor([toks], dtype=torch.long))

    def _row(self, bucket: int, pos: int) -> Cache:
        """A one-row scratch cache of ``bucket`` positions in the model's
        dtype (an int8 arena quantizes only at install). Its write
        position is a host scalar, so a chunk forward reads it without
        waiting for the device."""
        row = init_cache(self.cfg, 1, bucket, device=self.device,
                         mesh=self.mesh)
        row["pos"] = torch.tensor(pos, dtype=torch.int32)
        return row

    def _prefill_slot(self, req: _Request) -> None:
        """Paged admission: prefill over a bucket-sized scratch row, then
        land it in the slot's blocks. A block-granular prefix match
        skips the shared head's compute (a suffix-only forward) and its
        storage (the matched blocks are refcount-shared, not copied);
        with the kernel formulation the suffix prefills in the arena.
        With ``prefill_chunk`` set and a suffix longer than one chunk,
        the forwards are left to the ticks, one chunk each."""
        if not self.paged:
            return self._static_prefill_slot(req)
        bs = self.kv_block_size
        plen = len(req.prompt)
        m, mkey = (self._pindex.match(req.prompt, plen - 1,
                                      self._prefix_scope(req))
                   if self._pindex is not None else (0, None))
        if self._host_tier is not None:
            # a miss (or a shorter hit) may still be a host-tier hit:
            # promote the demoted chain before the checks judge the match
            m, mkey = self._promote_from_host(req, m, mkey, plen)
        # profitability: the reuse must also save prefill compute (fewer
        # query tokens per bucket tier), or a trivial shared head would
        # route every request through the prefix path for nothing
        if m > 0 and _bucket(plen - m) >= _bucket(plen):
            m = 0
        # fit: prefix + padded suffix must land inside max_len; shrink
        # by whole blocks (a partial block cannot be shared)
        guard = 0
        while m > 0 and m + _bucket(plen - m) > self.max_len \
                and guard < 64:
            m = (max(0, self.max_len - _bucket(plen - m)) // bs) * bs
            guard += 1
        if m > 0 and m + _bucket(plen - m) > self.max_len:
            m = 0
        if self._prefill_chunk and plen - m > self._prefill_chunk \
                and self._start_chunked(req, m, mkey):
            return
        sbucket = _bucket(plen - m)
        # scratch rounded up to the block size so whole blocks copy out
        bucket = min(max(_bucket(max(plen, m + sbucket)), bs),
                     self.max_len)
        shared = self._pindex.take(mkey, m) if m > 0 else []
        req.shared_blocks = shared
        self._sync_prefix_stats()
        if m > 0 and self.paged_kernel == "kernel":
            return self._prefill_in_arena(req, m, sbucket)
        row = self._row(bucket, m)
        if m > 0:
            self._seed_scratch(row, shared)
            suffix = req.prompt[m:]
            toks = self._tokens(suffix + [0] * (sbucket - len(suffix)))
            logits, row = forward_with_cache(self.params, self.cfg, toks,
                                             row)
            step = logits[0, len(suffix) - 1]
        else:
            toks = self._tokens(req.prompt + [0] * (bucket - plen))
            logits, row = forward_with_cache(self.params, self.cfg, toks,
                                             row)
            step = logits[0, plen - 1]
        self._chip_add(req.tenant, "prefill", plen - m)
        self._finish_prefill(req, row, step)

    def _prefix_match(self, prompt: List[int],
                      scope: Optional[str]) -> Tuple[int, Optional[tuple]]:
        """The slot-static prefix cache's lookup: (m, key) of the
        longest common head between ``prompt`` and an entry in
        ``scope``, capped at plen - 1 (one suffix token must run for
        the next token's logits). No side effects: the caller decides
        whether the match is used before the stats and the LRU order
        move."""
        cap = len(prompt) - 1
        best, best_key = 0, None
        for key in self._prefixes:
            if key[0] != scope:
                continue        # another tenant's prefix: invisible
            m = 0
            for a, b in zip(key[1], prompt[:cap]):
                if a != b:
                    break
                m += 1
            if m > best:
                best, best_key = m, key
        return best, best_key

    def _publish_prefix(self, prompt: List[int], rk: torch.Tensor,
                        rv: torch.Tensor, scope: Optional[str]) -> None:
        """Keep a prompt's K/V rows (copies, trimmed to the prompt) as a
        reusable prefix in ``scope``, evicting least recently used
        entries past the cap. Re-publishing moves an entry to the back
        of the LRU order."""
        key = (scope, tuple(prompt))
        plen = len(prompt)
        self._prefixes.pop(key, None)
        self._prefixes[key] = (rk[:, :, :, :plen].clone(),
                               rv[:, :, :, :plen].clone())
        while len(self._prefixes) > self._prefix_max:
            self._prefixes.pop(next(iter(self._prefixes)))

    def _take_prefix(self, mkey: tuple, m: int) -> None:
        """A used prefix match: refresh its LRU place and count the
        hit."""
        self._prefixes[mkey] = self._prefixes.pop(mkey)
        self.prefix_hits += 1
        self.prefix_tokens_saved += m

    def _seed_prefix_rows(self, row: Cache, mkey: tuple, m: int) -> None:
        """Copy a cached prefix's first ``m`` K/V rows into a scratch
        row."""
        pk, pv = self._prefixes[mkey]
        row["k"][:, :, :, :m] = pk[:, :, :, :m]
        row["v"][:, :, :, :m] = pv[:, :, :, :m]

    def _static_prefill_slot(self, req: _Request) -> None:
        """Slot-static admission, the reference's: prefill the prompt
        over a bucket-sized scratch row and install the row whole into
        the slot's cache row. A cached prefix skips its share of the
        forward (its rows seed the scratch row and only the suffix
        runs); with ``prefill_chunk`` set and a suffix longer than one
        chunk the forwards are left to the ticks, one chunk each."""
        plen = len(req.prompt)
        m, mkey = (self._prefix_match(req.prompt, self._prefix_scope(req))
                   if self._prefixes else (0, None))
        if self._prefill_chunk and self._start_chunked_static(req, m,
                                                              mkey):
            return
        # fit: the padded suffix must land inside max_len after the
        # prefix (a clamped write would overwrite the prefix's K/V);
        # shrink the match rather than drop it
        while m > 0 and m + _bucket(plen - m) > self.max_len:
            m = max(0, self.max_len - _bucket(plen - m))
        # profitability: the reuse must make the suffix forward cheaper
        # (fewer query tokens per bucket tier)
        if m > 0 and _bucket(plen - m) >= _bucket(plen):
            m = 0
        sbucket = _bucket(plen - m)
        if m > 0:
            self._take_prefix(mkey, m)
        bucket = min(_bucket(max(plen, m + sbucket)), self.max_len)
        row = self._row(bucket, m)
        if m > 0:
            self._seed_prefix_rows(row, mkey, m)
            suffix = req.prompt[m:]
            toks = self._tokens(suffix + [0] * (sbucket - len(suffix)))
            logits, row = forward_with_cache(self.params, self.cfg, toks,
                                             row)
            step = logits[0, len(suffix) - 1]
        else:
            toks = self._tokens(req.prompt + [0] * (bucket - plen))
            logits, row = forward_with_cache(self.params, self.cfg, toks,
                                             row)
            step = logits[0, plen - 1]
        self._chip_add(req.tenant, "prefill", plen - m)
        self._finish_prefill(req, row, step)

    def _start_chunked_static(self, req: _Request, m: int, mkey) -> bool:
        """Slot-static chunk-at-a-time admission (the ticks drive it);
        False falls back to the one-shot path: the suffix fits one
        chunk, or the chunk-padded span cannot fit ``max_len``."""
        chunk = self._prefill_chunk
        plen = len(req.prompt)

        def span(m_: int) -> int:
            # full chunks are exact; the last pads to its own bucket
            full, rem = divmod(plen - m_, chunk)
            return m_ + full * chunk + (_bucket(rem) if rem else 0)

        # profitability first (shrinking only lowers m), then fit
        if m > 0 and -(-(plen - m) // chunk) >= -(-plen // chunk):
            m = 0
        guard = 0
        while m > 0 and span(m) > self.max_len and guard < 64:
            m = max(0, self.max_len - (span(m) - m))
            guard += 1
        if plen - m <= chunk or span(m) > self.max_len:
            return False
        if m > 0:
            self._take_prefix(mkey, m)
        bucket = min(_bucket(max(plen, span(m))), self.max_len)
        row = self._row(bucket, m)
        if m > 0:
            self._seed_prefix_rows(row, mkey, m)
        suffix = req.prompt[m:]
        todo = deque(suffix[i:i + chunk]
                     for i in range(0, len(suffix), chunk))
        self._prefilling.append({"req": req, "row": row, "todo": todo})
        return True

    def _static_install(self, slot: int, row: Cache, pos: int,
                        feed: int) -> None:
        """Install a prefilled scratch row into ``slot``'s cache row and
        set the slot's pos and feed token (``install_row``)."""
        install_row(self.cache, slot, row, pos)
        self._last[slot, 0].fill_(feed)

    def _prefill_in_arena(self, req: _Request, m: int,
                          sbucket: int) -> None:
        """Prefix-hit admission through the kernel: reserve the slot's
        full table (the shared head plus fresh blocks), then run ONE
        bucketed S > 1 window of ``forward_paged`` over a one-row view of
        the arena at pos m with the slot's table row. The K/V scatter
        lands in the fresh blocks (quantized under int8, as a decode
        step's), and attention reads the shared head through the table.
        Padding past the suffix lands in the null block or past pos in
        the last fresh block: only pos decides what exists. The window
        takes the kernel's per-stream scratch, never the engine's, so
        the tensors the decode graphs recorded are never replaced."""
        plen = len(req.prompt)
        shared = req.shared_blocks
        table = shared + self._alloc.alloc_many(
            blocks_for(plen, self.kv_block_size) - len(shared))
        step = self._arena_window(req, table, len(shared), m, sbucket)
        req.reserved_blocks = table
        req.admission = ("window", m, sbucket)
        self._chip_add(req.tenant, "prefill", plen - m)
        self._finish_prefill(req, None, step, installed=True)

    def _arena_window(self, req: _Request, table: List[int], nshared: int,
                      m: int, sbucket: int) -> torch.Tensor:
        """Point the slot's table row at ``table`` (its first ``nshared``
        blocks the shared head) and run the prompt's suffix from ``m`` as
        ONE S = ``sbucket`` window of ``forward_paged`` over a one-row
        view of the arena; returns the last real position's logits."""
        s = req.slot
        self._tables[s] = table
        self._set_table_row(s)
        if self._scales is not None:
            for blk in table[nshared:]:
                self._scales.note_write(blk)
        suffix = req.prompt[m:]
        toks = self._tokens(suffix + [0] * (sbucket - len(suffix)))
        view = {k: v for k, v in self.cache.items() if k != "pos"}
        view["pos"] = self._to_device(torch.tensor([m], dtype=torch.int32))
        logits, _ = forward_paged(self.params, self.cfg, toks, view,
                                  self._table[s:s + 1],
                                  paged_impl=self.paged_kernel)
        self.arena_windows += 1
        return logits[0, len(suffix) - 1]

    def _start_chunked(self, req: _Request, m: int, mkey) -> bool:
        """Chunk-at-a-time admission. The slot's FULL block table is
        reserved here (the shared prefix plus fresh blocks): prefill
        spans several ticks during which other slots grow, and an
        install that found the pool empty would have no good answer.
        False falls back to the one-shot path (the suffix fits one
        chunk, the padded span does not fit, or the pool cannot hold the
        reservation, in which case the prefix claim is rolled back)."""
        bs = self.kv_block_size
        chunk = self._prefill_chunk
        plen = len(req.prompt)
        suffix = plen - m
        full, rem = divmod(suffix, chunk)
        span = m + full * chunk + (_bucket(rem) if rem else 0)
        bucket = min(max(_bucket(max(plen, span)), bs), self.max_len)
        if suffix <= chunk or span > bucket:
            return False
        shared = self._pindex.take(mkey, m) if m > 0 else []
        try:
            fresh = self._alloc.alloc_many(
                blocks_for(plen, bs) - len(shared))
        except NoFreeBlocks:
            for b in shared:            # undo the claim, fall back
                self._alloc.decref(b)
            if m > 0:
                # one admission, one hit: the fallback takes again
                self._pindex.hits -= 1
                self._pindex.tokens_saved -= m
            return False
        req.shared_blocks = shared
        req.reserved_blocks = shared + fresh
        req.admission = ("chunked", m, bucket)
        self._sync_prefix_stats()
        row = self._row(bucket, m)
        if m > 0:
            self._seed_scratch(row, shared)
        tail = req.prompt[m:]
        todo = deque(tail[i:i + chunk] for i in range(0, suffix, chunk))
        self._prefilling.append({"req": req, "row": row, "todo": todo})
        return True

    def _seed_scratch(self, row: Cache, shared: List[int]) -> None:
        """Copy a shared prefix's arena blocks into the scratch row (the
        reference's ``scratch_from_block``, one indexed read per plane):
        an int8 arena dequantizes to the row's dtype, so the suffix
        forward attends to the values a decode-path gather reads."""
        bs = self.kv_block_size
        n = len(shared)
        idx = self._to_device(torch.tensor(shared, dtype=torch.long))
        for name in ("k", "v"):
            blk = self.cache[name][:, idx]          # [L, n, Hkv, bs, D]
            if self.kv_dtype == "int8":
                blk = dequantize_kv(blk, self.cache[f"{name}_scale"][:, idx],
                                    row[name].dtype)
            L, _, h_kv, _, d = blk.shape
            row[name][:, 0, :, :n * bs] = blk.permute(0, 2, 1, 3, 4).reshape(
                L, h_kv, n * bs, d).to(row[name].dtype)

    def _prefill_tick(self) -> int:
        """Advance the head prefilling request by one chunk (the
        unbudgeted rule); returns tokens emitted (1 when its admission
        finished, else 0)."""
        return self._advance_entry(0)

    def _advance_entry(self, idx: int) -> int:
        """Run ONE chunk forward for ``self._prefilling[idx]``, timed on
        the host clock (the budget's cost model reads it; no sync is
        added, so on the card this is dispatch time), and finish the
        admission when its chunks are exhausted. Returns tokens emitted
        (1 on completion, else 0)."""
        ent = self._prefilling[idx]
        cost = self._chunk_cost(ent)
        t0 = time.perf_counter()
        done = self._prefill_advance(ent)
        dt = time.perf_counter() - t0
        self.prefill_chunk_tokens += cost
        self._chip_add(ent["req"].tenant, "prefill", cost)
        if cost > 0:
            self._chunk_tok_s.append(dt / cost)
        if not done:
            return 0
        del self._prefilling[idx]
        self._finish_prefill(ent["req"], ent["row"], ent["step"])
        return 1

    def _chunk_cost(self, ent: dict) -> int:
        """Prompt tokens the entry's NEXT chunk forward processes: the
        unit the per-tick budget is counted in."""
        return len(ent["todo"][0])

    def _prefill_remaining(self, ent: dict) -> int:
        """Prompt tokens the entry still has to prefill."""
        return sum(len(c) for c in ent["todo"])

    def _est_prefill_tok_s(self) -> float:
        """Estimated seconds per prefill prompt token: the hint when one
        is set, else the rolling median, 0.0 before the first chunk (the
        slack checks stand down rather than guess)."""
        if self.prefill_tok_s_hint is not None:
            return self.prefill_tok_s_hint
        if not self._chunk_tok_s:
            return 0.0
        s = sorted(self._chunk_tok_s)
        return s[len(s) // 2]

    def _est_tick_s(self) -> float:
        """Estimated seconds per decode tick: hint, else rolling median,
        else 0.0."""
        if self.tick_s_hint is not None:
            return self.tick_s_hint
        if not self._tick_s:
            return 0.0
        s = sorted(self._tick_s)
        return s[len(s) // 2]

    def prefill_backlog(self) -> int:
        """Prompt tokens queued in chunked-prefill entries."""
        return sum(self._prefill_remaining(e) for e in self._prefilling)

    def prefill_backlog_s(self) -> float:
        """Estimated seconds of chunk forwards in the backlog (0.0 when
        idle or the cost model is cold): the serving loop adds it to
        its admission-time estimate, so a deadline that cannot survive
        the chunk queue ahead of it sheds at submit."""
        return self.prefill_backlog() * self._est_prefill_tok_s()

    def _ttft_slack(self, ent: dict, now: float, tok_s: float) -> float:
        """Seconds before the entry's deadline if its remaining chunks
        ran back to back; +inf with no deadline (so deadline-less work
        sorts last, in arrival order)."""
        req = ent["req"]
        if req.deadline is None:
            return float("inf")
        return (req.deadline - now) - self._prefill_remaining(ent) * tok_s

    def _prefill_sched(self) -> int:
        """One tick of chunked prefill. With no budget, one chunk for the
        head entry. With one, spend at most ``prefill_budget`` prompt
        tokens (plus banked credit, capped at max(budget, chunk)) on
        chunk forwards, entries taken earliest TTFT slack first
        (re-ranked every pick); clamp to zero when a decoding slot is
        out of TPOT slack; allow ONE over-budget chunk when the most
        urgent prefill's slack is inside one tick; and with nothing
        decoding, advance one chunk free. The schedule decides only
        WHEN chunks run, so tokens equal the unbudgeted run's."""
        if not self._prefilling:
            return 0
        if self.prefill_budget <= 0:
            return self._prefill_tick()
        now = self._slack_clock()
        tok_s = self._est_prefill_tok_s()
        tick_s = self._est_tick_s()
        budget = float(self.prefill_budget)
        decode_slots = [s for s in self._active_slots()
                        if not self._active[s].done]
        if tick_s > 0:
            for s in decode_slots:
                r = self._active[s]
                if r.deadline is None:
                    continue
                rem_out = max(0, r.max_new_tokens - len(r.out))
                if (r.deadline - now) - rem_out * tick_s < 0:
                    # a decoding slot is out of TPOT slack: decode
                    # drains first, prefill rides its banked credit
                    budget = 0.0
                    self.prefill_budget_clamped += 1
                    break
        clamped = budget == 0.0
        cap = float(max(self.prefill_budget, self._prefill_chunk))
        self._prefill_credit = min(self._prefill_credit + budget, cap)
        emitted = 0
        advanced = 0
        overrode = False
        while self._prefilling:
            # re-ranked every pick: a finished admission can admit a new
            # chunked entry, and slack shifts as work runs
            idx = min(range(len(self._prefilling)),
                      key=lambda i: (self._ttft_slack(
                          self._prefilling[i], now, tok_s), i))
            cost = self._chunk_cost(self._prefilling[idx])
            if self._prefill_credit >= cost:
                self._prefill_credit -= cost
                self.prefill_budget_spent += cost
            elif (not clamped and not overrode
                  and self._ttft_slack(self._prefilling[idx], now,
                                       tok_s) < max(tick_s, 0.0)):
                # TTFT-critical overdraw, once a tick, paid back later
                self._prefill_credit -= cost
                self.prefill_budget_spent += cost
                self.prefill_budget_overrides += 1
                overrode = True
            elif advanced == 0 and not decode_slots:
                # liveness: nothing decodes and no credit is banked, so
                # one free advance a tick (the unbudgeted pace)
                pass
            else:
                break
            emitted += self._advance_entry(idx)
            advanced += 1
        return emitted

    def _prefill_advance(self, ent: dict) -> bool:
        """Run ONE chunk forward for ``ent``; the last chunk pads to its
        bucket. On the last chunk, keep the last real position's logits
        in ``ent["step"]`` and return True."""
        toks_list = ent["todo"].popleft()
        rem = len(toks_list)
        rbucket = _bucket(rem) if not ent["todo"] else rem
        toks = self._tokens(toks_list + [0] * (rbucket - rem))
        logits, ent["row"] = forward_with_cache(self.params, self.cfg, toks,
                                                ent["row"])
        if ent["todo"]:
            return False
        ent["step"] = logits[0, rem - 1]
        return True

    def _finish_prefill(self, req: _Request, row: Optional[Cache],
                        step: torch.Tensor, *,
                        installed: bool = False) -> None:
        """The admission tail: pick the first token from the last
        position's logits, set the slot's sampling rows, install the KV
        (``installed``: an in-arena window already wrote it), and stamp
        the ledger."""
        plen = len(req.prompt)
        if req.cache_prefix and not self.paged:
            # the paged engine publishes at install, where the slot's
            # block table (the thing shared) exists
            self._publish_prefix(req.prompt, row["k"], row["v"],
                                 self._prefix_scope(req))
        if req.temperature > 0:
            # the token at absolute index plen: the decode tick's
            # (seed, index) keying, so prefill and decode are seamless
            key = prng.fold_in(prng.PRNGKey(req.seed, self.device), plen)
            trunc = _truncate_logits_rows(
                _tempered(step, max(req.temperature, 1e-6))[None, :],
                torch.full((1,), req.top_k, device=self.device),
                torch.full((1,), req.top_p, dtype=torch.float32,
                           device=self.device))
            first = int(prng.categorical(key, trunc[0]))
        else:
            first = int(torch.argmax(step))
        self._set_sampling_rows(req)
        if self.paged:
            self._paged_install(req, row, plen, first, installed=installed)
        else:
            self._static_install(req.slot, row, plen, first)
        req.out.append(first)
        req.note_token()
        self._note_tenant_tokens(req, 1)
        # the first token is observed here (its argmax or draw was a host
        # sync): TTFT's far stamp, and the TPOT clock's arm
        req.led.t_prefill_end = req.led.t_first = req.led.t_last = \
            time.perf_counter()
        if self.role == "prefill" and not req.done:
            # a prefill-role engine never decodes: the request leaves now
            # as a handoff state (its prompt KV and first token), and the
            # freed slot admits the next prefill
            return self._handoff_slot(req)
        self._finish_if_done(req)

    def _note_tenant_tokens(self, req: _Request, n: int) -> None:
        """Tenant token-rate accounting, one scheduler note per arrival:
        the currency the weighted pick, the max-rate shed and reclaim
        decide on."""
        if self._tq is not None and n:
            self._tq.note_tokens(req.tenant, n, self._tq_clock())

    def _chip_add(self, tenant: Optional[str], phase: str,
                  n: int) -> None:
        """Accumulate ``n`` tokens of this quantum's work weight for the
        chip-second split (decode tokens emitted, prefill prompt tokens
        advanced), charged to the RESOLVED tenant; one attribute check
        when SLO accounting is off."""
        if self.chip is None or n <= 0:
            return
        key = (self._tq.cfg.resolve(tenant), phase)
        self._chip_work[key] = self._chip_work.get(key, 0) + n

    def _chip_kv_bytes(self) -> Dict[str, int]:
        """Resident device K/V bytes per tenant, from the arena's block
        tables: each active slot charges its resolved tenant, each prefix
        chain its scope (``_shared`` for an unscoped cache); a shared
        block charges every holder. Empty on the slot-static engine (a
        fixed allocation, not per tenant)."""
        if not self.paged:
            return {}
        nb = self._chain_block_nbytes()
        out: Dict[str, int] = {}
        for s, req in self._active.items():
            blocks = len(self._tables[s])
            if blocks:
                t = self._tq.cfg.resolve(req.tenant)
                out[t] = out.get(t, 0) + nb * blocks
        if self._pindex is not None:
            for (scope, _toks), blocks in self._pindex.chain_items():
                t = scope if scope is not None else "_shared"
                out[t] = out.get(t, 0) + nb * len(blocks)
        return out

    def chip_note_quantum(self, t0: float, t1: float) -> None:
        """Charge one engine quantum ``[t0, t1]`` to the chip ledger,
        draining the accumulated token weights: the serving loop calls it
        with the two tick-profiler clock reads it already takes; ``step``
        charges itself. No-op when SLO accounting is off."""
        if self.chip is None:
            return
        work = self._chip_work
        self._chip_work = {}
        self.chip.note_quantum(t0, t1, work, self._chip_kv_bytes())

    def _paged_install(self, req: _Request, row: Optional[Cache], plen: int,
                       first: int, *, installed: bool = False) -> None:
        """Land the prefilled scratch row in the slot's blocks past the
        shared prefix (quantized per token under int8, the decode
        scatter's rule; one indexed write per plane, in place), into the
        blocks a chunked admission reserved or fresh ones; ``installed``
        skips the copy. Then set the slot's table row, pos and feed
        token, and publish a ``cache_prefix`` prompt's full blocks."""
        bs = self.kv_block_size
        shared = req.shared_blocks
        req.shared_blocks = []
        n_total = blocks_for(plen, bs)
        if req.reserved_blocks is not None:
            table = req.reserved_blocks
            req.reserved_blocks = None
        else:
            table = shared + self._alloc.alloc_many(n_total - len(shared))
        if not installed:
            self._write_rows(row, table[:n_total], len(shared))
        s = req.slot
        self._tables[s] = table
        self._set_table_row(s)
        self.cache["pos"][s].fill_(plen)
        self._last[s, 0].fill_(first)
        if req.cache_prefix and self._pindex is not None:
            self._pindex.publish(req.prompt, table, self._prefix_scope(req))
            self._sync_prefix_stats()

    def _write_rows(self, row: Cache, blocks: List[int], lo: int, *,
                    cache: Optional[Cache] = None,
                    scales: Optional[ScaleLedger] = None) -> None:
        """Land a scratch row's positions ``[lo*bs, len(blocks)*bs)`` in
        ``blocks[lo:]`` of the arena (``cache`` and its scale ledger
        when given: the speculative engine's draft arena), quantized per
        token under int8, the decode scatter's rule; one indexed write
        per plane, in place."""
        if cache is None:
            cache, scales = self.cache, self._scales
        bs = self.kv_block_size
        hi = len(blocks)
        if hi <= lo:
            return
        idx = self._to_device(torch.tensor(blocks[lo:hi], dtype=torch.long))
        for name in ("k", "v"):
            r = row[name][:, 0, :, lo * bs:hi * bs]
            L, h_kv, _, d = r.shape
            blk = r.reshape(L, h_kv, hi - lo, bs, d).permute(0, 2, 1, 3, 4)
            if self.kv_dtype == "int8":
                blk, sc = quantize_kv(blk)
                cache[f"{name}_scale"][:, idx] = sc
            cache[name][:, idx] = blk.to(cache[name].dtype)
        if scales is not None:
            for b in blocks[lo:hi]:
                scales.note_write(b)

    def _sync_prefix_stats(self) -> None:
        if self._pindex is not None:
            self.prefix_hits = self._pindex.hits
            self.prefix_tokens_saved = self._pindex.tokens_saved

    def _set_sampling_rows(self, req: _Request) -> None:
        """Install one request's sampling params in its slot's rows: the
        one place they land."""
        s = req.slot
        self._temp[s].fill_(req.temperature)
        self._topk[s].fill_(req.top_k)
        self._topp[s].fill_(req.top_p)
        self._seed[s].fill_(req.seed)

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        """A host tensor on the engine's device. On the card it is copied
        from pinned memory, queued on the engine's stream behind the
        ticks in flight, so the host does not wait for them."""
        if self.device.type != "cuda":
            return host.to(self.device)
        return host.pin_memory().to(self.device, non_blocking=True)

    def _set_table_row(self, slot: int) -> None:
        """Mirror one slot's host block table into the device table
        (unassigned logical blocks -> the null block 0); the write lands
        after the ticks in flight, which still read the old row."""
        row = np.zeros((self._nbs,), np.int32)
        blocks = self._tables[slot]
        row[:len(blocks)] = blocks
        self._table[slot].copy_(self._to_device(torch.from_numpy(row)))

    def _finish_if_done(self, req: _Request, admit: bool = True) -> None:
        """Completion: free the slot's blocks, reset its pos, close the
        ledger, and (unless the caller is consuming an arrival, and
        admits once after the window) admit."""
        if req.done and req.slot >= 0:
            s = req.slot
            del self._active[s]
            if self.paged:
                self._free_slot_blocks(s)
            # the rollback: pos alone decides what exists, so the overrun
            # of ticks that decoded past the request's end is discarded
            self.cache["pos"][s].fill_(0)
            self._free.append(s)
            req.slot = -1
            self._done[req.rid] = req
            self._record_ledger(req)
            if not self._active:
                # nothing left to decode: an idle engine is not
                # host-blocked, so the dispatch-gap clock stops
                self._idle_since = None
            if admit:
                self._admit()

    def _record_ledger(self, req: _Request,
                       outcome: Optional[str] = None) -> None:
        """Close the request's ledger and park its snapshot for
        ``pop_ledger``, FIFO-capped at ``ledger_cap``."""
        led = req.led
        if outcome is not None and led.outcome is None:
            led.outcome = outcome
        led.t_done = time.perf_counter()
        self._ledgers[req.rid] = led.snapshot(req)
        while len(self._ledgers) > self.ledger_cap:
            del self._ledgers[next(iter(self._ledgers))]

    def pop_ledger(self, rid: int) -> Optional[dict]:
        """The finished request's latency ledger, handed out once; None
        while it runs (or once popped)."""
        return self._ledgers.pop(rid, None)

    def drain_ledgers(self) -> List[dict]:
        """Every uncollected finished-request ledger, cleared."""
        out = list(self._ledgers.values())
        self._ledgers.clear()
        return out

    def _free_slot_blocks(self, slot: int) -> None:
        """Release a finished or cancelled slot's blocks. With ticks in
        flight the frees park: those ticks still write through this
        table, and a block reallocated before they land would be
        overwritten. ``_drain_deferred`` lands them once the window is
        empty."""
        table, self._tables[slot] = self._tables[slot], []
        if self._inflight:
            self._deferred.extend(table)
        else:
            for b in table:
                self._alloc.decref(b)

    def _drain_deferred(self) -> None:
        if self._deferred and not self._inflight:
            for b in self._deferred:
                self._alloc.decref(b)
            self._deferred.clear()

    def _dispatch_span(self) -> int:
        """The most KV positions ONE decode dispatch writes per slot:
        ``decode_steps`` here; the speculative engine writes a verify
        window per fused round."""
        return self.decode_steps

    def _ensure_blocks(self, active: List[int]) -> None:
        """Each decoding slot's next ``decode_steps`` write positions,
        past those the ticks in flight already cover, must land in blocks
        it owns EXCLUSIVELY: growth allocates, a shared block is copied
        first (``_grow_slot_blocks``). Positions past the request's
        terminal length stay unallocated and route to the null block.
        Raises NoFreeBlocks under pool pressure."""
        span = self._dispatch_span()
        for s in active:
            req = self._active[s]
            pending = sum(1 for ent in self._inflight
                          if not ent.consumed and s in ent.slots)
            start = len(req.prompt) + len(req.out) - 1 + pending * span
            end = min(start + span, len(req.prompt) + req.max_new_tokens - 1)
            if start >= end:
                continue
            self._grow_slot_blocks(s, start, end)

    def _grow_slot_blocks(self, s: int, start: int, end: int) -> None:
        """Make slot ``s`` own every block covering write positions
        [start, end) exclusively: copy shared blocks (copy-on-write),
        allocate growth; the device table row follows whatever changed,
        also when an allocation raises midway."""
        bs = self.kv_block_size
        table = self._tables[s]
        changed = False
        try:
            for j in range(start // bs, (end - 1) // bs + 1):
                if j < len(table):
                    if not self._alloc.writable(table[j]):
                        fresh = self._alloc.alloc()
                        self._cow_block(table[j], fresh)
                        if self._scales is not None:
                            self._scales.note_copy(table[j], fresh)
                        self._alloc.decref(table[j])
                        table[j] = fresh
                        changed = True
                else:
                    while len(table) <= j:
                        table.append(self._alloc.alloc())
                        changed = True
                if self._scales is not None:
                    # data and scales this dispatch's scatter writes
                    self._scales.note_write(table[j])
        finally:
            if changed:
                self._set_table_row(s)

    def _cow_block(self, src: int, dst: int) -> None:
        """Copy-on-write: block ``src`` into ``dst`` in every layer, the
        scale planes of an int8 arena in the same step, queued on the
        engine's stream after the ticks in flight (which may still
        write positions the copy must carry)."""
        for name in ("k", "v", "k_scale", "v_scale"):
            plane = self.cache.get(name)
            if plane is not None:
                plane[:, dst] = plane[:, src]
        self.cow_copies += 1

    def _pre_dispatch(self, active: List[int]) -> bool:
        """Block discipline before a dispatch. True: dispatch ``active``
        as it is. False: the pool ran dry and pressure relief ran
        (``_relieve_pressure``); recompute and retry. The slot-static
        engine has nothing to allocate."""
        if not self.paged:
            return True
        try:
            self._ensure_blocks(active)
            return True
        except NoFreeBlocks:
            self._relieve_pressure()
            return False

    def _relieve_pressure(self) -> None:
        """Free KV blocks, cheapest first, in the reference's order. Each
        step makes progress or the next runs, so the step_begin retry
        loop ends: 1) flush the window (late completions and their
        deferred frees land); 2) land deferred frees and evict one LRU
        prefix chain; 3) preempt the lowest-priority (then youngest)
        decoding slot, swapped or dropped for recompute per ``kv_swap``
        and re-enqueued at the front of the queue; 4) nothing left:
        raise (the pool cannot hold even one slot, a sizing error)."""
        if self._inflight:
            self._flush()
            return
        self._drain_deferred()
        if self._pindex is not None and self._pindex.evict_lru(1) > 0:
            return
        if self._preempt_victim():
            return
        raise NoFreeBlocks(
            "KV block pool exhausted with nothing left to reclaim (no "
            "in-flight ticks, no cached prefixes, no preemptible slot); "
            "size kv_blocks to hold at least one full-length request")

    def _preempt_victim(self) -> bool:
        """Preempt one decoding slot: the lowest priority, then the
        youngest admitted. The sole decoder cannot steal from itself,
        unless a chunked admission holds reserved blocks: vacating the
        decoder lets that admission finish and the pool drain."""
        pre = {ent["req"].slot for ent in self._prefilling}
        cands = [s for s in self._active if s not in pre]
        if len(cands) <= 1 and not self._prefilling:
            return False
        if not cands:
            return False
        victim = min(cands, key=lambda s: (self._active[s].priority,
                                           -self._active[s].led.t_admit))
        self._preempt_slot(victim, "swap" if self.kv_swap else "recompute")
        return True

    def preempt(self, rid: int, mode: Optional[str] = None) -> bool:
        """Preempt an active request's slot now (``mode`` swap or
        recompute, default per ``kv_swap``), re-enqueuing it at the front
        of the queue. False for a request that is not an active, fully
        prefilled slot (or that the barrier flush finished). The
        slot-static engine has no preemption (RuntimeError)."""
        if not self.paged:
            raise RuntimeError("preempt requires paged KV (kv_blocks > 0)")
        mode = mode or ("swap" if self.kv_swap else "recompute")
        if mode not in ("swap", "recompute"):
            raise ValueError(f"mode must be swap|recompute, got {mode!r}")
        if any(e["req"].rid == rid for e in self._prefilling):
            return False
        slot = next((s for s, r in self._active.items() if r.rid == rid),
                    None)
        if slot is None:
            return False
        self._flush()       # barrier: may even finish the request
        req = self._active.get(slot)
        if req is None or req.rid != rid or req.done:
            return False
        self._preempt_slot(slot, mode)
        return True

    def _preempt_slot(self, slot: int, mode: str) -> None:
        """Vacate ``slot`` (the window must be flushed): keep its resume
        state (swap: the host copy of its committed blocks; recompute:
        the tokens alone), free its blocks, and re-enqueue the request
        at the front of the queue."""
        assert not self._inflight, "preemption requires a flushed window"
        req = self._active.pop(slot)
        base = len(req.prompt) + len(req.out) - 1
        nblk = blocks_for(base, self.kv_block_size)
        table = self._tables[slot]
        if mode == "swap":
            req.swap_state = self._swap_payload(table, nblk, later=True)
        self._tables[slot] = []
        for b in table:
            self._alloc.decref(b)
        self.cache["pos"][slot].fill_(0)
        self._free.append(slot)
        req.slot = -1
        req.preempted = True
        self._pending.appendleft(req)
        self.preempts[mode] += 1
        if self._tq is not None:
            self._tq.note_preempt(req.tenant, mode)
        if not self._active:
            self._idle_since = None

    def _swap_download(self, blocks: Sequence[int]):
        """Queue the copy of ``blocks``' planes (K/V, and the f32 scale
        planes of an int8 arena, each ``[L, n, ...]``) into a pinned
        staging slab on the engine's stream, behind an event; returns
        the staging ``Download`` (nothing waits here)."""
        idx = self._to_device(torch.tensor(list(blocks), dtype=torch.long))
        return self._staging.download({
            name: self.cache[name][:, idx]
            for name in ("k", "v", "k_scale", "v_scale")
            if self.cache.get(name) is not None})

    def _swap_payload(self, table: List[int], nblk: int,
                      later: bool = False) -> dict:
        """Host copies of a slot's first ``nblk`` committed blocks, the
        one payload preemption, restart capture, demotion and the handoff
        share: ``[L, nblk, Hkv, bs, D]`` K/V planes (bf16 as uint16
        bits, named by ``"dtype"``) plus, for int8, the f32 scale planes
        ``[L, nblk, Hkv, bs]``, in pageable memory. They cross the link
        through the pinned staging pool. With ``later`` the copy out of
        the slab finishes on the pool's worker, off the caller's path,
        and the payload carries the event a reader settles on
        (``handoff.settle``: the restore scatter and the codec do)."""
        payload: dict = {"nblk": nblk}
        dl = self._swap_download(table[:nblk])
        if later:
            planes, ready = dl.arrays_later()
            if not ready.is_set():
                payload[READY] = ready
        else:
            planes = dl.arrays()
        payload.update(planes)
        if self.cache["k"].dtype == torch.bfloat16:
            payload["dtype"] = BF16
        return payload

    def _restore_blocks(self, swap: dict, blocks: List[int]) -> None:
        """Swap-in: a payload's planes scatter into ``blocks`` (one
        indexed write per plane, queued on the engine's stream behind
        the ticks in flight), the int8 scales with their bytes, so the
        restored slot continues on the same timeline byte for byte. The
        planes go up through a pinned staging slab: no pageable copy, no
        pin per plane."""
        settle(swap)
        idx = self._to_device(torch.tensor(blocks, dtype=torch.long))
        names = [n for n in ("k", "v", "k_scale", "v_scale") if n in swap]
        dev = self._staging.upload(
            {n: plane_bits(swap[n]) for n in names},
            {n: self.cache[n].dtype for n in names})
        for n in names:
            self.cache[n][:, idx] = dev[n]
        if self._scales is not None:
            for b in blocks:
                self._scales.note_write(b)

    def _resume_swapped(self, req: _Request) -> None:
        """Swap-in resume: the preempted request's KV bytes into fresh
        blocks, bit-exact by construction (the bytes never changed)."""
        st = req.swap_state
        req.swap_state = None
        req.preempted = False
        blocks = self._alloc.alloc_many(st["nblk"])
        self._restore_blocks(st, blocks)
        self._tables[req.slot] = blocks
        self._set_table_row(req.slot)
        self._resume_draft(req)
        self._resume_row(req)

    def _resume_draft(self, req: _Request) -> None:
        """Resume hook for an engine with a sibling cache (the
        speculative engine's draft): rebuild it for ``req``'s committed
        sequence. Nothing to do here."""

    def _resume_recompute_static(self, req: _Request) -> None:
        """Slot-static recompute resume, the supervised restart's path
        (the slot-static engine never preempts, but a rebuilt engine
        re-admits requests with committed tokens): re-prefill ``prompt +
        out[:-1]`` over a scratch row in its bucket and install it with
        pos the committed length and the feed token the last committed
        one, not yet fed."""
        req.preempted = False
        seq = req.prompt + req.out[:-1]
        n = len(seq)
        bucket = min(_bucket(n), self.max_len)
        row = self._row(bucket, 0)
        _logits, row = forward_with_cache(
            self.params, self.cfg, self._tokens(seq + [0] * (bucket - n)),
            row)
        self._set_sampling_rows(req)
        self._static_install(req.slot, row, n, req.out[-1])
        self._resume_draft(req)
        req.led.t_prefill_end = time.perf_counter()

    def _resume_recompute(self, req: _Request) -> None:
        """Recompute resume: rewrite the committed sequence's K/V and set
        the slot's row state. Under the gather formulation that is the
        reference's one-shot re-prefill of ``prompt + out[:-1]`` (the
        last committed token is not yet fed). Under the kernel
        formulation the prompt's K/V is rewritten by the path its
        admission took (``_reprefill_prompt``) and ``_replay_committed``
        rewrites the committed output span with the decode ticks'
        arithmetic, so every position is the arithmetic that first wrote
        it. On the card another bucket or another path gives other bits
        (ROADMAP C.10, C.12). The slot-static engine takes its own path
        (``_resume_recompute_static``)."""
        if not self.paged:
            return self._resume_recompute_static(req)
        req.preempted = False
        bs = self.kv_block_size
        total = blocks_for(len(req.prompt) + len(req.out) - 1, bs)
        if self.paged_kernel == "kernel":
            self._reprefill_prompt(req, total)
            if len(req.out) > 1:
                self._replay_committed(req)
        else:
            seq = req.prompt + req.out[:-1]
            blocks = self._alloc.alloc_many(total)
            self._oneshot_into(seq, blocks)
            self._tables[req.slot] = blocks
            self._set_table_row(req.slot)
        self._resume_draft(req)
        self._resume_row(req)

    def _oneshot_into(self, seq: List[int], blocks: List[int]) -> None:
        """Prefill ``seq`` one-shot over a scratch row in its bucket and
        land it in ``blocks`` (whose tail past ``seq`` the caller's
        writes fill)."""
        bs = self.kv_block_size
        n = len(seq)
        bucket = min(max(_bucket(n), bs), self.max_len)
        row = self._row(bucket, 0)
        _logits, row = forward_with_cache(
            self.params, self.cfg, self._tokens(seq + [0] * (bucket - n)),
            row)
        self._write_rows(row, blocks[:blocks_for(n, bs)], 0)
        if self._scales is not None:
            for b in blocks[blocks_for(n, bs):]:
                self._scales.note_write(b)      # the replay writes them

    def _reprefill_prompt(self, req: _Request, total: int) -> None:
        """Rewrite the prompt's K/V into ``total`` fresh (or re-shared)
        blocks the way the admission wrote it: a prefix hit re-takes its
        shared head and re-runs the same S > 1 window, a chunked
        admission re-runs the same chunks over a scratch row of the same
        bucket, a one-shot admission re-prefills in the same bucket. A
        window's or chunked admission's shared head that no chain holds
        any more falls back to the one-shot re-prefill."""
        bs = self.kv_block_size
        plen = len(req.prompt)
        adm = req.admission
        m = adm[1] if adm is not None else 0
        shared = self._reshare_head(req, m, total) if m > 0 else []
        if m > 0 and not shared:
            adm = None
            self.resume_paths["fallback"] += 1
        if adm is not None and adm[0] == "window":
            table = shared + self._alloc.alloc_many(total - len(shared))
            self._arena_window(req, table, len(shared), m, adm[2])
            self.resume_paths["window"] += 1
            return
        if adm is not None and adm[0] == "chunked":
            ent = {"row": self._row(adm[2], m), "todo": deque(
                req.prompt[i:i + self._prefill_chunk]
                for i in range(m, plen, self._prefill_chunk))}
            if m:
                self._seed_scratch(ent["row"], shared)
            while not self._prefill_advance(ent):
                pass
            table = shared + self._alloc.alloc_many(total - len(shared))
            self._write_rows(ent["row"], table[:blocks_for(plen, bs)],
                             len(shared))
            if self._scales is not None:
                for b in table[blocks_for(plen, bs):]:
                    self._scales.note_write(b)
            self.resume_paths["chunked"] += 1
        else:
            table = self._alloc.alloc_many(total)
            self._oneshot_into(req.prompt, table)
            if req.admission is None:
                self.resume_paths["oneshot"] += 1
        self._tables[req.slot] = table
        self._set_table_row(req.slot)

    def _reshare_head(self, req: _Request, m: int, total: int) -> List[int]:
        """The first ``m`` tokens' blocks of a prefix chain in the
        request's scope, claimed again for its resume (refcounts bumped,
        not counted as a hit); a chain demoted to the host tier is
        promoted back when the pool holds it and the resume's own
        blocks. [] when no chain holds them."""
        bs = self.kv_block_size
        plen = len(req.prompt)
        scope = self._prefix_scope(req)
        got, key = self._pindex.match(req.prompt, plen - 1, scope)
        if got < m and self._host_tier is not None:
            hkey = self._host_tier.match(scope, req.prompt,
                                         ((plen - 1) // bs) * bs)
            if hkey is not None and len(hkey[1]) >= m and \
                    self._alloc.free_count >= len(hkey[1]) // bs + total:
                got, key = self._promote_from_host(req, got, key, plen)
        if got < m:
            return []
        chain = dict(self._pindex.chain_items())[key]
        return self._alloc.fork(chain[:m // bs])

    def _replay_committed(self, req: _Request) -> None:
        """Rewrite a recompute resume's committed output span with the
        arithmetic the undisturbed run wrote it with: each committed
        token (but the last, not yet fed) through the replay program,
        one decode step at the tick's width (the paged kernel's split
        count and every matmul's shape are the tick's), the resumed
        row's table live at its own slot and every other row on the null
        block. On the card the step is one captured graph, replayed once
        a token."""
        s = req.slot
        n0 = len(req.prompt)
        toks = self._to_device(torch.tensor(req.out[:-1], dtype=torch.long))
        self._rtable[s].copy_(self._table[s])
        for i in range(len(req.out) - 1):
            self._rtoks[s, 0].copy_(toks[i])
            self._rpos[s].fill_(n0 + i)
            self._launch_replay()
        self._rtable[s].zero_()
        self._rpos[s].zero_()
        self.replayed_tokens += len(req.out) - 1

    def _replay_program(self) -> torch.Tensor:
        """One decode step of the replay program on its static buffers:
        ``forward_paged`` of ``_rtoks`` at ``_rpos`` through ``_rtable``
        on the engine's arena and split scratch. Writes the arena only;
        returns the step's logits."""
        view = {k: v for k, v in self.cache.items() if k != "pos"}
        view["pos"] = self._rpos
        logits, _ = forward_paged(self.params, self.cfg, self._rtoks, view,
                                  self._rtable, paged_impl=self.paged_kernel,
                                  scratch=self._program_scratch())
        return logits[:, -1].float()

    def _launch_replay(self) -> torch.Tensor:
        """Run the replay program (``_launch_graph``)."""
        return self._launch_graph("replay")

    def _request_state(self, req: _Request) -> dict:
        """The resumable description of one request: the schema
        ``restore`` consumes, shared by restart capture and the
        handoff."""
        return {
            "rid": req.rid,
            "prompt": list(req.prompt),
            "out": list(req.out[:req.max_new_tokens]),
            "max_new_tokens": req.max_new_tokens,
            "temperature": req.temperature,
            "top_k": req.top_k,
            "top_p": req.top_p,
            "seed": req.seed,
            "stop_tokens": list(req.stop_tokens),
            "priority": req.priority,
            "tenant": req.tenant,
            "cache_prefix": req.cache_prefix,
        }

    def _handoff_slot(self, req: _Request) -> None:
        """Vacate a freshly prefilled slot into a handoff state: the
        committed KV (the prompt's positions; the first token's KV is
        written by the decode step that feeds it, on the decode engine)
        swapped to host, the blocks freed, the state parked for
        ``pop_handoffs``."""
        t0 = time.perf_counter()
        s = req.slot
        base = len(req.prompt) + len(req.out) - 1
        nblk = blocks_for(base, self.kv_block_size)
        state = self._request_state(req)
        state["swap"] = self._swap_payload(self._tables[s], nblk,
                                           later=True)
        state["handoff"] = True
        del self._active[s]
        self._free_slot_blocks(s)
        self.cache["pos"][s].fill_(0)
        self._free.append(s)
        req.slot = -1
        self._handoffs[req.rid] = state
        self.handoffs += 1
        self.handoff_payload_bytes += handoff_nbytes(state)
        self.handoff_capture_s += time.perf_counter() - t0
        self._record_ledger(req, outcome="handoff")
        if not self._active:
            self._idle_since = None
        self._admit()

    def pop_handoffs(self) -> List[dict]:
        """The parked handoff states, in admission order, cleared: the
        serving loop ships each to a decode-role replica."""
        out = list(self._handoffs.values())
        self._handoffs.clear()
        return out

    def capture_resumable(self, device_ok: bool = True) -> List[dict]:
        """Resumable states of every request this engine still owes an
        answer, in arrival (rid) order: active slots (a mid-prefill one
        restarts its admission), the pending queue (swap payloads kept),
        parked handoffs, and finished but unpopped results. Host
        bookkeeping only, except the swap-to-host of an active slot's
        committed blocks under ``kv_swap``; a device read that raises
        leaves that slot to recompute, and ``device_ok=False`` (a card
        declared wedged) skips every device read."""
        pre = {ent["req"].rid for ent in self._prefilling}
        states = []
        live = list(self._active.values()) + list(self._pending)
        for req in sorted(live, key=lambda r: r.rid):
            st = self._request_state(req)
            if req.rid in pre:
                st["out"] = []          # mid-prefill: restart admission
            elif req.swap_state is not None:
                st["swap"] = req.swap_state     # already on the host
            elif device_ok and self.paged and self.kv_swap \
                    and req.slot >= 0 and req.out:
                base = len(req.prompt) + len(req.out) - 1
                nblk = blocks_for(base, self.kv_block_size)
                table = self._tables[req.slot]
                if nblk and len(table) >= nblk:
                    try:
                        st["swap"] = self._swap_payload(table, nblk)
                    except Exception:   # device gone: recompute instead
                        pass
            states.append(st)
        states.extend(dict(st) for st in self._handoffs.values())
        for rid, req in list(self._done.items()):
            states.append({
                "rid": rid,
                "prompt": list(req.prompt),
                "out": list(req.out[:req.max_new_tokens]),
                "max_new_tokens": req.max_new_tokens,
                "tenant": req.tenant,
                "done": True,
            })
        return states

    def restore(self, state: dict) -> int:
        """Re-admit one captured (or handed-off) request into this engine
        with its committed tokens, returning its new rid. A ``done``
        state parks in the result table; a handoff state on a
        prefill-role engine re-parks for the loop's push. Committed
        output resumes through the preemption machinery: the swap
        payload restored byte for byte when the state carries one (its
        geometry and dtype must match this arena: ``Infeasible``
        otherwise), recompute otherwise."""
        prompt = [int(t) for t in state["prompt"]]
        max_new = int(state["max_new_tokens"])
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(
            rid, prompt, max_new,
            temperature=float(state.get("temperature", 0.0)),
            top_k=int(state.get("top_k", 0)),
            top_p=float(state.get("top_p", 0.0)),
            seed=int(state.get("seed", rid)) & 0xFFFFFFFF,
            cache_prefix=bool(state.get("cache_prefix", False))
            and self._prefix_max > 0,
            stop_tokens=tuple(int(t) for t in state.get("stop_tokens")
                              or ()),
            priority=int(state.get("priority", 0)),
            tenant=str(state.get("tenant") or DEFAULT_TENANT),
            led=_Ledger(time.perf_counter()))
        req.out = [int(t) for t in state.get("out") or []]
        if state.get("done"):
            self._done[rid] = req
            return rid
        if state.get("handoff") and self.role == "prefill":
            st = dict(state)
            st["rid"] = rid
            self._handoffs[rid] = st
            return rid
        if len(prompt) + max_new > self.max_len:
            raise Infeasible(
                f"restored prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new}) exceeds cache length {self.max_len}")
        if self.paged:
            need = blocks_for(len(prompt) + max_new - 1,
                              self.kv_block_size)
            if need > self._alloc.capacity:
                raise Infeasible(
                    f"restored request needs {need} KV blocks but the "
                    f"pool only has {self._alloc.capacity}")
        if req.out:
            swap = state.get("swap")
            if self.paged and swap is not None:
                want = tuple(self.cache["k"].shape[i] for i in (0, 2, 3, 4))
                got = tuple(np.asarray(swap["k"]).shape[i]
                            for i in (0, 2, 3, 4))
                want_dt = _dtype_name(self.cache["k"].dtype)
                got_dt = plane_dtype(swap, "k")
                if want != got or want_dt != got_dt or \
                        (("k_scale" in swap) != (self.kv_dtype == "int8")):
                    raise Infeasible(
                        f"KV payload geometry [L,Hkv,bs,D]={got} "
                        f"dtype={got_dt} does not match this engine's "
                        f"arena {want} dtype={want_dt} "
                        f"kv_dtype={self.kv_dtype}; handoff/restore "
                        f"requires identical kv_block_size, kv_dtype "
                        f"and model geometry on both ends")
                req.swap_state = dict(swap)
            req.preempted = True
        self._pending.append(req)
        self._admit()
        return rid

    def step(self) -> int:
        """One scheduling quantum, the three phases in a row: dispatch
        until the window is full, wait for the oldest tick, consume it,
        run the prefill chunks; returns the tokens emitted (0 when
        idle). Under a prefill budget a caller without a serving loop
        feeds the cost model itself: each tick's dispatch and wait, on
        ticks that captured no graph."""
        c0, t0 = self.compiles, time.perf_counter()
        handle = self.step_begin()
        self.step_wait(handle)
        if handle is not None and self.prefill_budget > 0 \
                and self.compiles == c0:
            self.note_tick_seconds(time.perf_counter() - t0)
        emitted = self.step_finish(handle)
        if self.chip is not None:
            # no serving loop pays the tick-profiler reads here: charge
            # the quantum with one tail clock read
            self.chip_note_quantum(t0, time.perf_counter())
        return emitted

    def _active_slots(self) -> List[int]:
        """The slots that decode: active and not still prefilling."""
        pre = {ent["req"].slot for ent in self._prefilling}
        return sorted(s for s in self._active if s not in pre)

    def step_begin(self) -> Optional[_InFlight]:
        """Dispatch phase: ticks back to back until ``pipeline_depth``
        are in flight (the program feeds itself its next tokens on the
        device, so tick N+1 never waits for tick N's), each after its
        block growth and with its token copy to the host started.
        Returns the oldest unconsumed tick without waiting (None when
        idle)."""
        t_begin = time.perf_counter()
        self._begin_dispatch_s = 0.0
        active = self._active_slots()
        while active and len(self._inflight) < self.pipeline_depth:
            if not self._pre_dispatch(active):
                active = self._active_slots()
                continue
            self._dispatch_tick(active)
        # everything outside _dispatch_tick is assembly
        self.last_assemble_s = max(
            0.0, time.perf_counter() - t_begin - self._begin_dispatch_s)
        return self._inflight[0] if self._inflight else None

    def _set_keep(self, active: Tuple[int, ...]) -> None:
        """Point the program's keep mask at ``active``: copied into the
        static buffer behind the ticks in flight, and only when the set
        changed (sets repeat for whole decode phases)."""
        if active == self._keep_for:
            return
        host = torch.zeros((self.max_batch,), dtype=torch.bool)
        host[list(active)] = True
        self._keep.copy_(self._to_device(host))
        self._keep_for = active

    def _dispatch_tick(self, active: List[int]) -> None:
        """Run one decode program for ``active`` slots (one replay on the
        card) and start the copy of its ``[max_batch, T]`` tokens into
        the tick's own host buffer; no host sync."""
        self._set_keep(tuple(active))
        sampling = any(self._active[s].temperature > 0 for s in active)
        t0 = time.perf_counter()
        if self._idle_since is not None:
            # the dispatch gap ends when a tick is in flight again
            self.dispatch_gap_s += t0 - self._idle_since
            self._idle_since = None
        self._launch(sampling)
        if self.device.type == "cuda":
            buf = torch.empty(tuple(self._toks.shape), dtype=torch.long,
                              pin_memory=True)
            buf.copy_(self._toks, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            buf, event = self._toks.clone(), None
        self.ticks += 1
        self.ticks_dispatched += 1
        dt = time.perf_counter() - t0
        self.host_block_s += dt
        self._begin_dispatch_s += dt
        self._inflight.append(_InFlight(buf, event, tuple(active)))

    def _forward(self, toks: torch.Tensor, cache: Cache,
                 table: Optional[torch.Tensor]) -> Tuple[torch.Tensor,
                                                         Cache]:
        """The target model over ``cache``: ``forward_with_cache`` on
        the slot-static engine, ``forward_paged`` through ``table`` (the
        engine's formulation and split scratch) on the paged one."""
        if not self.paged:
            return forward_with_cache(self.params, self.cfg, toks, cache)
        return forward_paged(self.params, self.cfg, toks, cache, table,
                             paged_impl=self.paged_kernel,
                             scratch=self._program_scratch())

    def _program_scratch(self) -> Optional[_kernels.PagedScratch]:
        """The split scratch the programs pass the paged kernel: the
        engine's own, which its graphs record; None under a mesh, whose
        programs run eagerly and whose shards' launches take the
        kernel's scratch per device."""
        return self._scratch if self.mesh is None else None

    def _keep_table(self, table: Optional[torch.Tensor]):
        """A block table with the rows outside ``_keep`` on the null
        block (None on the slot-static engine)."""
        if not self.paged:
            return None
        return torch.where(self._keep[:, None], table,
                           torch.zeros_like(table))

    def _decode_program(self, sampling: bool) -> torch.Tensor:
        """The decode tick on the engine's static buffers: ``T =
        decode_steps`` copies of the reference's ``decode_one`` (its
        ``lax.scan``, unrolled). Reads the cache, ``pos``, ``_table``,
        ``_last``, ``_keep`` and the sampling rows; writes the cache,
        ``pos``, ``_last`` and ``_toks`` in place. Rows outside ``_keep``
        keep their pos and feed token; on the paged engine they decode
        into the null block, on the slot-static one into their own row
        at their frozen pos, which only pos decides is not there. A
        sampled token is keyed by (seed, its absolute index pos + 1), so
        streams do not depend on T. Returns the last step's logits."""
        keep = self._keep
        pos = self.cache["pos"]
        table = self._keep_table(self._table)
        toks = self._last
        for j in range(self.decode_steps):
            logits, out = self._forward(toks, self.cache, table)
            step = logits[:, -1].float()
            nxt = torch.argmax(step, dim=-1)
            if sampling:
                nxt = self._sample(step, pos, nxt)
            pos.copy_(torch.where(keep, out["pos"], pos))
            self._toks[:, j].copy_(nxt)
            toks = torch.where(keep[:, None], nxt[:, None], toks)
        self._last.copy_(toks)
        return step

    def _launch(self, sampling: bool) -> torch.Tensor:
        """Run the decode program (``_launch_graph``); returns the last
        step's logits."""
        return self._launch_graph(sampling)

    def _launch_graph(self, key) -> torch.Tensor:
        """Run the program captured under ``key`` (``_program_for``): on
        the card, replay its graph, captured at the first run that needs
        it; on the CPU or under a mesh, call it."""
        if self.device.type != "cuda" or self.mesh is not None:
            return self._program_for(key)[0]()
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = self._capture(key)
        return graph.replay()

    def capture_programs(self) -> Dict[str, float]:
        """Capture the decode programs (greedy, sampled) that are not yet
        captured, now instead of at the first tick that needs each, so
        no tick pays a capture, and the replay program too when this
        engine resumes by recompute through the kernel; returns
        {"greedy"|"sampled"|"replay": seconds} for those captured. Needs
        an idle engine. The CPU, and an engine on a mesh, capture
        nothing."""
        if self.device.type != "cuda" or self.mesh is not None:
            return {}
        if self.has_work() or self._inflight:
            raise RuntimeError("capture_programs needs an idle engine")
        keys = [False, True]
        if not self.kv_swap and self.paged_kernel == "kernel":
            keys.append("replay")
        out = {}
        for key in keys:
            if key not in self._graphs:
                t0 = self.compile_s
                self._graphs[key] = self._capture(key)
                name = key if key == "replay" else (
                    "sampled" if key else "greedy")
                out[name] = self.compile_s - t0
        return out

    def _program_for(self, key) -> tuple:
        """(program, the buffer its null warm-up run clears) of a
        captured key: the replay step for "replay", else the decode tick
        for ``key`` = sampling."""
        if key == "replay":
            return self._replay_program, self._rtable
        return (lambda: self._decode_program(key)), self._keep

    def _graph_scratch(self) -> tuple:
        """The paged kernel's scratch tensors a captured graph records."""
        return (self._scratch.part, self._scratch.ticket)

    def _capture(self, key) -> _Graph:
        """Capture one program into a CUDA graph, on a side stream after
        everything queued on the engine's stream: the decode program for
        ``key`` = sampling, the replay step for ``key == "replay"``. A
        warm-up run first loads the kernels and sizes the paged kernel's
        scratch and launch counter (neither may be allocated inside a
        capture), as a null run: the keep mask (the replay table)
        cleared, so it writes only the null block and leaves pos and the
        feed tokens as they were. The graph reads nothing that is keyed
        by the side stream. Errors raise; the time is accounted as the
        reference accounts a compile."""
        t0 = time.perf_counter()
        program, null = self._program_for(key)
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        side = self._capture_stream
        main = torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            saved = null.clone()
            null.zero_()
            program()
            null.copy_(saved)
        main.wait_stream(side)
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            logits = program()
        out = _Graph(graph, logits, self._graph_scratch(),
                     torch.cuda.memory_reserved(self.device) - reserved)
        dt = time.perf_counter() - t0
        self.compiles += 1
        self.compile_s += dt
        self.compile_events.append(dt)
        return out

    def step_wait(self, ent: Optional[_InFlight]) -> None:
        """Block until ``ent``'s tokens are on the host: the event's
        ``synchronize``, which releases the interpreter lock. A no-op for
        None or a tick already consumed."""
        if ent is None or ent.consumed:
            return
        self._fetch(ent)

    def _fetch(self, ent: _InFlight) -> None:
        """The tick's tokens as host lists. Two threads may fetch one
        tick at once: the ticker in ``step_wait`` (unlocked) and a
        barrier flush; the buffer stays on the tick, so both read the
        same tokens."""
        if ent.host is not None:
            return
        t0 = time.perf_counter()
        if ent.event is not None:
            ent.event.synchronize()
        ent.host = ent.buf.tolist()
        self.host_block_s += time.perf_counter() - t0

    def step_finish(self, ent: Optional[_InFlight]) -> int:
        """Host phase: consume ``ent`` (append tokens, retire
        completions), run the prefill chunks, and admit into freed
        slots. Returns the tokens
        emitted, those of any barrier flush since the last step_finish
        included."""
        emitted = self._flush_emitted
        self._flush_emitted = 0
        if ent is not None and not ent.consumed:
            # arrivals are consumed in dispatch order; ent is the window
            # head unless a flush got there first
            assert self._inflight and self._inflight[0] is ent
            self._inflight.popleft()
            emitted += self._consume(ent)
        if self._prefilling:
            emitted += self._prefill_sched()
        self._admit()
        if not self._active and not self._pending and self._inflight:
            # the burst ended with overrun ticks in flight: consume them
            # now (nothing appends), so no frees linger while idle
            self._flush()
        self._drain_deferred()
        self._note_window_empty()
        return emitted

    def _consume(self, ent: _InFlight) -> int:
        """Append one tick's tokens ([max_batch, T]) to its requests in
        order, once, stopping at each request's end: the overrun after a
        stop token or ``max_new_tokens`` is never appended (and earns no
        ledger stamp). A slot whose request finished meanwhile
        contributes nothing. One clock read stamps the arrival."""
        if ent.consumed:
            return 0
        ent.consumed = True
        self._fetch(ent)
        now = time.perf_counter() if self.ledger_enabled else 0.0
        emitted = self._consume_payload(ent, ent.host, now)
        self.tokens_emitted += emitted
        return emitted

    def _consume_payload(self, ent: _InFlight, toks: List[List[int]],
                         now: float) -> int:
        """Append one tick's host tokens ``[max_batch, T]`` to the
        requests of ``ent.slots``, stopping at each one's end; returns
        the tokens appended."""
        emitted = 0
        for s in ent.slots:
            req = self._active.get(s)
            if req is None or req.done:
                continue
            n = 0
            for t in toks[s]:
                req.out.append(t)
                req.note_token()
                n += 1
                if req.done:
                    break
            emitted += n
            if now:
                req.led.note_tokens(n, now)
            self._note_tenant_tokens(req, n)
            self._chip_add(req.tenant, "decode", n)
            self._finish_if_done(req, admit=False)
        return emitted

    def _flush(self) -> int:
        """Barrier: consume every tick in flight, in dispatch order,
        before the batch changes; their tokens are credited to the next
        step_finish, and the parked block frees land."""
        emitted = 0
        if self._inflight:
            self.pipeline_flushes += 1
        while self._inflight:
            emitted += self._consume(self._inflight.popleft())
        self._flush_emitted += emitted
        self._drain_deferred()
        return emitted

    def _note_window_empty(self) -> None:
        """Start the dispatch-gap clock when no tick is in flight while
        slots could decode (a slot still prefilling cannot)."""
        if not self._inflight and self._idle_since is None \
                and len(self._active) > len(self._prefilling):
            self._idle_since = time.perf_counter()

    def reset_dispatch_stats(self) -> None:
        """Zero the dispatch-economics counters and the gap clock (a
        measurement window's fence)."""
        self.dispatch_gap_s = 0.0
        self.host_block_s = 0.0
        self.ticks_dispatched = 0
        self.pipeline_flushes = 0
        self._idle_since = None

    def note_tick_seconds(self, seconds: float) -> None:
        """Feed one measured decode-tick duration into the budgeted
        prefill's TPOT cost model (the serving loop's tick phases;
        ``step`` measures its own)."""
        if seconds > 0:
            self._tick_s.append(seconds)

    def _sample(self, step: torch.Tensor, pos0: torch.Tensor,
                greedy: torch.Tensor) -> torch.Tensor:
        """The sampled tick's choice per slot: the token being produced
        sits at absolute index pos0 + 1, and (seed, index) keys its
        draw; greedy slots keep their argmax."""
        keys = prng.fold_in(prng.PRNGKey(self._seed), pos0 + 1)
        trunc = _truncate_logits_rows(
            step / torch.clamp_min(self._temp, 1e-6)[:, None], self._topk,
            self._topp)
        sampled = prng.categorical(keys, trunc)
        return torch.where(self._temp > 0, sampled, greedy)

    def pop_result(self, rid: int) -> Optional[List[int]]:
        """The finished sequence (prompt + generated) for ``rid``, handed
        out once; None while it is pending or active."""
        req = self._done.pop(rid, None)
        if req is None:
            return None
        return req.prompt + req.out[:req.max_new_tokens]

    def cancel(self, rid: int) -> bool:
        """Stop a request now: a pending one leaves the queue, an active
        one is truncated at its current output and its slot recycled.
        It lands in the done-table (maybe with a partial output) for the
        caller to pop. False for an unknown or finished rid."""
        for i, req in enumerate(self._pending):
            if req.rid == rid:
                del self._pending[i]
                self._done[rid] = req
                self._record_ledger(req, outcome="cancelled")
                return True
        if not any(req.rid == rid for req in self._active.values()):
            return False
        # barrier: the ticks in flight land first (they may even finish
        # the request, which then is no longer active below)
        self._flush()
        for i, ent in enumerate(self._prefilling):
            if ent["req"].rid == rid:
                # drop the chunk queue first (no later chunk may install
                # into the freed slot); its reserved blocks, shared
                # prefix references included, never reached the device
                # table, so they are released here directly
                del self._prefilling[i]
                for b in ent["req"].reserved_blocks or []:
                    self._alloc.decref(b)
                ent["req"].reserved_blocks = None
                ent["req"].shared_blocks = []
                break
        for req in self._active.values():
            if req.rid == rid:
                req.max_new_tokens = len(req.out)
                req.led.outcome = "cancelled"
                self._finish_if_done(req)
                return True
        return False

    def progress(self, rid: int) -> Optional[tuple]:
        """(generated tokens so far, done); None for an unknown rid."""
        req = self._done.get(rid)
        if req is not None:
            return list(req.out[:req.max_new_tokens]), True
        for req in list(self._active.values()) + list(self._pending):
            if req.rid == rid:
                return list(req.out), False
        return None

    def occupancy(self) -> tuple:
        """(active slots, waiting requests)."""
        return len(self._active), len(self._pending)

    def _resume_row(self, req: _Request) -> None:
        """A fork's tail: sampling rows, the slot's pos (the committed KV
        length) and feed token (the last committed, not yet fed)."""
        s = req.slot
        self._set_sampling_rows(req)
        self.cache["pos"][s].fill_(len(req.prompt) + len(req.out) - 1)
        self._last[s, 0].fill_(req.out[-1])
        req.led.t_prefill_end = time.perf_counter()

    def fork(self, rid: int, *, max_new_tokens: Optional[int] = None,
             temperature: Optional[float] = None,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             seed: Optional[int] = None) -> int:
        """Copy-on-write fork of an active request: the new request
        shares every block of the source's committed context by refcount
        and diverges from its next token on; a shared block is copied
        only before its first write. A greedy fork continues
        bit-identically to the source's own continuation; another
        ``seed`` (or temperature, top-k, top-p) branches a sampled
        stream. Needs a free slot (QueueFull otherwise) and an active,
        fully prefilled source (ValueError otherwise); returns the new
        request's id. The slot-static engine has no fork
        (RuntimeError)."""
        if not self.paged:
            raise RuntimeError("fork requires paged KV (kv_blocks > 0)")
        if any(e["req"].rid == rid for e in self._prefilling):
            raise ValueError(f"request {rid} is still prefilling")
        src = next((r for r in self._active.values() if r.rid == rid),
                   None)
        if src is None:
            raise ValueError(f"request {rid} is not active")
        self._flush()       # barrier: the batch changes below
        if src.done or src.slot < 0:
            raise ValueError(
                f"request {rid} finished during the fork barrier")
        # after the barrier: a completion in an unconsumed tick frees
        # its slot during the flush
        if not self._free:
            raise QueueFull(
                "no free slot to fork into; retry after a completion")
        new_max = src.max_new_tokens if max_new_tokens is None \
            else int(max_new_tokens)
        if new_max <= len(src.out):
            raise ValueError(
                f"max_new_tokens {new_max} <= tokens already produced "
                f"({len(src.out)}); nothing left to decode")
        if len(src.prompt) + new_max > self.max_len:
            raise Infeasible(
                f"prompt ({len(src.prompt)}) + max_new_tokens "
                f"({new_max}) exceeds cache length {self.max_len}")
        fork_cap = blocks_for(len(src.prompt) + new_max - 1,
                              self.kv_block_size)
        if fork_cap > self._alloc.capacity:
            raise Infeasible(
                f"fork needs {fork_cap} KV blocks at its full length "
                f"but the pool only has {self._alloc.capacity}")
        nrid = self._next_rid
        self._next_rid += 1
        req = _Request(
            nrid, list(src.prompt), new_max,
            temperature=(src.temperature if temperature is None
                         else float(temperature)),
            top_k=src.top_k if top_k is None else int(top_k),
            top_p=src.top_p if top_p is None else float(top_p),
            seed=(src.seed if seed is None else int(seed)) & 0xFFFFFFFF,
            stop_tokens=src.stop_tokens, priority=src.priority,
            tenant=src.tenant, led=_Ledger(time.perf_counter()))
        req.out = list(src.out)
        # the fork's prompt K/V is the source's, written by its admission
        req.admission = src.admission
        now = time.perf_counter()
        req.led.t_admit = req.led.t_prefill_start = now
        req.led.t_first = req.led.t_last = now
        slot = self._free.popleft()
        req.slot = slot
        self._active[slot] = req
        nblk = blocks_for(len(src.prompt) + len(src.out) - 1,
                          self.kv_block_size)
        self._tables[slot] = self._alloc.fork(self._tables[src.slot][:nblk])
        self._set_table_row(slot)
        self._resume_row(req)
        return nrid

    def kv_stats(self) -> dict:
        """Block-pool accounting, the formulation this engine runs, the
        prefix index, preemptions and the admission-time memory
        snapshot, under the reference's keys; None on the slot-static
        engine."""
        if not self.paged:
            return None
        return {
            "block_size": self.kv_block_size,
            "dtype": self.kv_dtype,
            "kernel": self.paged_kernel,
            "scaled_blocks": (self._scales.count
                              if self._scales is not None else None),
            "blocks_total": self._alloc.capacity,
            "blocks_free": self._alloc.free_count,
            "blocks_used": self._alloc.used_count,
            "cow_shared": self._alloc.shared_count(),
            "deferred_frees": len(self._deferred),
            "prefix": (self._pindex.stats()
                       if self._pindex is not None else None),
            "preempts": dict(self.preempts),
            "tenant_reclaims": self.tenant_reclaims,
            "swapped_pending": sum(1 for r in self._pending
                                   if r.swap_state is not None),
            "hbm": self.hbm,
        }

    # ------------------------------------------------------------------
    # the KV fabric: the host tier's demote/promote under the arena, and
    # chain export/ingest across replicas. Everything moves the swap
    # payload preemption and the handoff move, so a tier transition is
    # bit-exact by construction.
    # ------------------------------------------------------------------
    def _demote_chain(self, key: tuple, blocks: Tuple[int, ...]) -> bool:
        """``PrefixBlockIndex.on_evict``: offer an evicting chain to the
        host tier. Runs BEFORE the chain's refcounts drop, so its blocks
        are still live to copy (the copy is queued ahead of any later
        write to them on the engine's stream). True = demoted; False
        falls through to a plain drop. The host copy of the planes
        finishes on the staging pool's worker, off the admission that
        evicted the chain."""
        scope, tokens = key
        swap = self._swap_payload(list(blocks), len(blocks), later=True)
        if not self._host_tier.put(scope, tokens, swap):
            return False
        self._fabric["demote"] += 1
        return True

    def _promote_from_host(self, req: _Request, m: int, mkey,
                           plen: int) -> Tuple[int, Optional[tuple]]:
        """Admission-time promotion: if the host tier holds a strictly
        longer prefix of ``req.prompt`` than the index matched, scatter
        it back into fresh arena blocks, republish it, and re-match. The
        chain moves tiers (its host entry popped); best-effort, never
        required for correctness."""
        bs = self.kv_block_size
        scope = self._prefix_scope(req)
        cap = ((plen - 1) // bs) * bs
        key = self._host_tier.match(scope, req.prompt, cap)
        if key is None or len(key[1]) <= m:
            return m, mkey
        ent = self._host_tier.get(key)
        if ent is None:
            return m, mkey
        if self._ingest_swap(key[1], ent["swap"], scope):
            self._host_tier.pop(key)
            self._fabric["promote"] += 1
        # re-match after any ingest attempt: a failed one may still have
        # evicted chains (mkey's own among them) making room
        return self._pindex.match(req.prompt, plen - 1, scope)

    def _ingest_swap(self, tokens: tuple, swap: dict,
                     scope: Optional[str]) -> bool:
        """Land a chain payload in the arena as a published prefix
        chain: the restore scatter (bit-exact), then ``publish`` so the
        next match shares it. Only LRU prefix chains are reclaimed to
        make room, never live work; False = no room or a payload whose
        geometry or dtype is not this arena's (bf16 arrives as uint16
        bits named "bfloat16"), and the caller prefills."""
        nblk = int(swap.get("nblk") or 0)
        if nblk <= 0 or nblk * self.kv_block_size != len(tokens) \
                or nblk > self._alloc.capacity:
            return False
        want = tuple(self.cache["k"].shape[i] for i in (0, 2, 3, 4))
        got = tuple(np.asarray(swap["k"]).shape[i] for i in (0, 2, 3, 4))
        if want != got \
                or _dtype_name(self.cache["k"].dtype) != plane_dtype(swap, "k") \
                or ("k_scale" in swap) != (self.kv_dtype == "int8"):
            return False
        if nblk > self._alloc.free_count:
            self._pindex.evict_lru(nblk - self._alloc.free_count)
            if nblk > self._alloc.free_count:
                return False
        blocks = self._alloc.alloc_many(nblk)
        self._restore_blocks(swap, blocks)
        self._pindex.publish(list(tokens), blocks, scope)
        for b in blocks:    # the index holds its own references now
            self._alloc.decref(b)
        return True

    def ingest_chain(self, data: bytes, tenant: Optional[str] = None,
                     expect_digest: Optional[str] = None) -> bool:
        """Adopt a fabric chain payload pulled from a peer replica.
        Rejections are counted, never raised (a failed pull falls back to
        prefill): undecodable bytes, a payload scope that is not the
        requester's own resolved scope, a digest that does not match the
        payload's recomputed identity, or no arena room."""
        if self._pindex is None:
            return False
        try:
            state = decode_chain(data)
        except ValueError:
            self._fabric["ingest_rejected"] += 1
            return False
        scope = state.get("scope")
        tokens = tuple(int(t) for t in state.get("tokens") or ())
        if scope != self.prefix_scope_for(tenant) \
                or (expect_digest is not None
                    and chain_digest(tokens, scope) != expect_digest) \
                or not self._ingest_swap(tokens, state["swap"], scope):
            self._fabric["ingest_rejected"] += 1
            return False
        self._fabric["ingest"] += 1
        return True

    def export_chain_begin(self, digest: str) -> Optional[tuple]:
        """Phase 1 of a peer-pull export (under the serving loop's lock):
        find ``digest``'s chain and queue the copy of its blocks into a
        pinned staging slab on the engine's stream. A chain's blocks are
        never written in place (copy-on-write), and any later write to a
        freed block is queued behind this copy, so the snapshot is the
        chain's bytes whatever decodes after the lock drops. A host-tier
        hit hands out its stored payload. Returns a handle for
        ``export_chain_finish``, or None (not here)."""
        if self._pindex is None:
            return None
        for key, chain in self._pindex.chain_items():
            if self._chain_digest(key) == digest:
                swap = {"nblk": len(chain),
                        "_download": self._swap_download(chain)}
                if self.cache["k"].dtype == torch.bfloat16:
                    swap["dtype"] = BF16
                return key[0], key[1], swap
        if self._host_tier is not None:
            hit = self._host_tier.find(digest)
            if hit is not None:
                key, ent = hit
                return key[0], key[1], ent["swap"]
        return None

    @staticmethod
    def export_chain_finish(handle: tuple) -> bytes:
        """Phase 2 (outside the loop's lock): wait for the snapshot's
        copy, encode the chain from the pinned slab, return the slab."""
        scope, tokens, swap = handle
        dl = swap.get("_download")
        if dl is None:
            settle(swap)
            return encode_chain(scope, tokens, swap)
        try:
            out = {k: v for k, v in swap.items() if k != "_download"}
            out.update(dl.views())
            return encode_chain(scope, tokens, out)
        finally:
            dl.release()

    def export_chain(self, digest: str) -> Optional[bytes]:
        """One chain's fabric payload by its fleet-wide digest (the
        ``GET /v1/kvchain/<digest>`` surface), begin and finish in one
        call, for callers with no lock to shed."""
        handle = self.export_chain_begin(digest)
        if handle is None:
            return None
        return self.export_chain_finish(handle)

    def _chain_digest(self, key: tuple) -> str:
        d = self._digests.get(key)
        if d is None:
            d = self._digests[key] = chain_digest(key[1], key[0])
        return d

    def _chain_block_nbytes(self) -> int:
        """Host bytes one arena block snapshots to (K/V planes, plus the
        scale planes of an int8 arena)."""
        if self._blk_nbytes is None:
            tot = 0
            for name in ("k", "v", "k_scale", "v_scale"):
                arr = self.cache.get(name)
                if arr is not None:
                    tot += arr.element_size() * arr.shape[0] * int(
                        np.prod(arr.shape[2:]))
            self._blk_nbytes = tot
        return self._blk_nbytes

    def prefix_index_snapshot(self) -> Optional[dict]:
        """The /stats ``prefix_index`` section the gateway's fleet index
        reads: eviction tiers, the fabric counters, the host tier's
        occupancy, and every resident chain as (digest, token length,
        tier, bytes, scope); None without a prefix index."""
        if self._pindex is None:
            return None
        per_blk = self._chain_block_nbytes()
        chains, live = [], set()
        for key, blks in self._pindex.chain_items():
            live.add(key)
            chains.append({"digest": self._chain_digest(key),
                           "len": len(key[1]), "tier": "hbm",
                           "nbytes": per_blk * len(blks),
                           "scope": key[0]})
        self._digests = {k: v for k, v in self._digests.items()
                         if k in live}
        host = None
        if self._host_tier is not None:
            host = self._host_tier.stats()
            for row in self._host_tier.digests():
                chains.append(dict(row, tier="host"))
        return {"evicted": dict(self._pindex.evicted),
                "fabric": dict(self._fabric),
                "host_tier": host,
                "chains": chains}

    def stats(self) -> dict:
        """Live introspection for ``/stats``, the reference's engine
        half: per-slot state, queue, the prefill scheduler, the
        in-flight window, the prefix cache and index, compile
        accounting, the block pool."""
        now = time.perf_counter()
        prefilling = {e["req"].rid for e in self._prefilling}
        slots = []
        for s in sorted(self._active):
            req = self._active[s]
            slots.append({
                "slot": s,
                "rid": req.rid,
                "tenant": req.tenant,
                "age_s": round(now - (req.led.t_admit
                                      or req.led.t_submit), 6),
                "pos": len(req.prompt) + len(req.out),
                "tokens_out": len(req.out),
                "max_new_tokens": req.max_new_tokens,
                "prefilling": req.rid in prefilling,
                "sampling": {"temperature": req.temperature,
                             "top_k": req.top_k, "top_p": req.top_p,
                             "seed": req.seed},
            })
        oldest = (now - self._pending[0].led.t_submit
                  if self._pending else 0.0)
        return {
            "engine": type(self).__name__,
            "role": self.role,
            # the disaggregation surface (None unless role=prefill):
            # parked payloads waiting for the loop's push, cumulative
            # handoffs and bytes
            "handoff": ({
                "ready": len(self._handoffs),
                "total": self.handoffs,
                "payload_bytes": self.handoff_payload_bytes,
                "capture_s": round(self.handoff_capture_s, 6),
            } if self.role == "prefill" else None),
            "max_batch": self.max_batch,
            "max_len": self.max_len,
            "slots": slots,
            "pending": {"depth": len(self._pending),
                        "oldest_wait_s": round(oldest, 6)},
            "prefill_sched": ({
                "budget": self.prefill_budget,
                "credit": round(self._prefill_credit, 3),
                "backlog_tokens": self.prefill_backlog(),
                "chunk_tokens": self.prefill_chunk_tokens,
                "budget_spent_tokens": self.prefill_budget_spent,
                "clamped_ticks": self.prefill_budget_clamped,
                "overrides": self.prefill_budget_overrides,
                "est_prefill_tok_s": round(self._est_prefill_tok_s(), 9),
                "est_tick_s": round(self._est_tick_s(), 9),
            } if self._prefill_chunk else None),
            "pipeline": {"depth": self.pipeline_depth,
                         "decode_steps": self.decode_steps,
                         "in_flight": len(self._inflight),
                         "flushes": self.pipeline_flushes,
                         "ticks_dispatched": self.ticks_dispatched},
            "prefix_cache": (
                {"capacity_blocks": self._pindex.max_blocks,
                 "entries": self._pindex.stats()["chains"],
                 "blocks": self._pindex.block_count,
                 "hits": self._pindex.hits,
                 "tokens_saved": self._pindex.tokens_saved}
                if self._pindex is not None else
                {"capacity": self._prefix_max,
                 "entries": len(self._prefixes),
                 "hits": self.prefix_hits,
                 "tokens_saved": self.prefix_tokens_saved}),
            "prefix_index": self.prefix_index_snapshot(),
            "kv": self.kv_stats(),
            "tenants": self.tenant_snapshot(),
            "compiles": {"count": self.compiles,
                         "seconds": round(self.compile_s, 6)},
            "tokens_emitted": self.tokens_emitted,
        }

    def tenant_snapshot(self) -> Optional[dict]:
        """Per-tenant quota accounting for /stats and the serving loop's
        gauge mirror (rate, shares, sheds, preempts, pending and active
        requests); None when tenancy is off."""
        if self._tq is None:
            return None
        snap = self._tq.snapshot(self._tq_clock())
        pending_by, active_by = {}, {}
        for r in self._pending:
            t = self._tq.cfg.resolve(r.tenant)
            pending_by[t] = pending_by.get(t, 0) + 1
        for r in self._active.values():
            t = self._tq.cfg.resolve(r.tenant)
            active_by[t] = active_by.get(t, 0) + 1
        for name, row in snap.items():
            row["pending"] = pending_by.get(name, 0)
            row["active"] = active_by.get(name, 0)
        return snap

    def free_device_memory(self, free_cache: bool = True) -> None:
        """Drop this engine's device tensors (weights, arena, tables, the
        captured graphs and their memory pools) so a supervised rebuild
        does not need twice the card's memory; the host bookkeeping
        (progress, stats) stays readable. The engine cannot tick again.
        ``free_cache`` also returns the freed blocks to the device (not
        done for a device declared wedged: freeing would wait on it)."""
        self.params = self.cache = self._table = self._last = None
        self._temp = self._topk = self._topp = self._seed = None
        self._keep = self._toks = self._scratch = None
        self._rtoks = self._rpos = self._rtable = None
        for ent in self._prefilling:
            ent["row"] = None
        self._graphs = {}
        self._capture_stream = None
        self._inflight = deque()
        self._staging.close()
        if free_cache and self.device.type == "cuda":
            torch.cuda.empty_cache()

    def has_work(self) -> bool:
        return bool(self._active or self._pending)

    def drain(self) -> Dict[int, List[int]]:
        """Run until every submitted request completes; returns
        {rid: prompt + generated} for requests finished since the last
        drain, and forgets them."""
        while self._active or self._pending:
            if not self._active:
                self._admit()
                if not self._active:
                    raise RuntimeError(
                        "pending requests with no active slots")
            self.step()
        self._flush()
        self._flush_emitted = 0
        out = {r.rid: r.prompt + r.out[:r.max_new_tokens]
               for r in self._done.values()}
        self._done.clear()
        return out
