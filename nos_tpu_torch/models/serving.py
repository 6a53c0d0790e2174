"""Continuous-batching decode serving over the paged KV cache (port of
the paged core of ``nos_tpu/models/serving.py``).

Requests occupy rows ("slots") of one decode batch; their KV lives in a
pooled arena mapped per slot by block tables. ``submit`` admits a
request to a free slot and prefills it at once over a scratch row
(``forward_with_cache``, the prompt padded to a power-of-two bucket),
then installs the row into the slot's freshly allocated blocks —
quantizing into an int8 arena when ``kv_dtype="int8"``. Greedy requests
are token-identical to ``generate_paged``. Every slot carries its own
sampling params (temperature, top-k, top-p, seed), and a sampled token
is keyed by (seed, absolute position), so a request's stream depends
neither on what else shares the batch nor on how ticks are fused.

The decode tick is one program over the engine's persistent device
buffers (``_decode_program``): ``decode_steps`` = T copies of the
reference's fused step (the keep-masked table, ``forward_paged``, pos
frozen for inactive rows, argmax, the sampling ops when a slot samples,
the next feed tokens), writing ``pos``, the feed tokens and a
``[max_batch, T]`` token buffer in place. On the card each program
(greedy, sampled) is captured once into a CUDA graph, the counterpart
of the reference's jitted program, and every tick is one replay; the
first capture per key is accounted as the reference accounts a compile.
On the CPU the program is called directly.

A tick is three phases, as in the reference, so a serving loop can run
the one blocking wait outside its lock: ``step_begin`` dispatches ticks
until ``pipeline_depth`` are in flight, each followed by a non-blocking
copy of its tokens into its own pinned host buffer behind a CUDA event;
``step_wait`` blocks on the oldest's event only; ``step_finish``
consumes it (appending up to T tokens a slot, stopping at ``done``),
retires completions and admits. A completion observed late (pipelining)
or mid-burst (fused steps) has over-decoded; the overrun is never
appended, and resetting the slot's pos rolls it back. Every change of
the batch (admission, ``cancel``) first consumes the whole window (the
reference's barrier ``_flush``), block frees wait for the window to
drain, and every host write to a device buffer the program reads is
queued on the engine's stream behind the ticks in flight. Each request
keeps the reference's latency ledger (``pop_ledger``), read by the
serving loop's TTFT/TPOT histograms.

What the reference engine has and this slice does not yet port raises
a ``ValueError`` naming the knob: the prefix cache, chunked and
budgeted prefill, meshes, tenant quotas, the host tier, prefill/decode
roles, the slot-static engine (``kv_blocks == 0``) and preemption, with
its capture and restore. ``cache_prefix`` and ``tenant`` are accepted
and ignored, as the reference engine ignores them with no prefix cache
and no quota.
"""
from __future__ import annotations

import contextlib
import gc
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from nos_tpu_torch.device import DeviceLike, resolve_device
from nos_tpu_torch.models.errors import (
    DEFAULT_TENANT, Infeasible, NotPorted, QueueFull,
)
from nos_tpu_torch.models.generate import (
    Cache, _tempered, _truncate_logits_rows, forward_paged,
    forward_with_cache, init_cache, init_paged_cache,
)
from nos_tpu_torch.models.kvblocks import (
    BlockAllocator, NoFreeBlocks, blocks_for,
)
from nos_tpu_torch.models.transformer import Params, TransformerConfig
from nos_tpu_torch.ops import _kernels
from nos_tpu_torch.ops.attention import (
    check_paged_kernel_head_dim, effective_paged_impl, quantize_kv,
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


def reject_unported(*, kv_blocks: int, prefix_cache_size: int = 0,
                    prefill_chunk: int = 0, prefill_budget: int = 0,
                    mesh=None, tenant_quota=None, host_tier=None,
                    role: str = "colocated", kv_swap: bool = True) -> None:
    """Raise a ValueError naming the first engine knob set outside this
    slice; ``build_engine`` calls it before loading any weights."""
    for knob, on, what in (
            ("kv_blocks=0", kv_blocks <= 0, "the slot-static engine"),
            ("prefix_cache_size", prefix_cache_size, "prefix cache"),
            ("prefill_chunk", prefill_chunk, "chunked prefill"),
            ("prefill_budget", prefill_budget, "budgeted prefill"),
            ("mesh", mesh is not None, "tensor-parallel serving"),
            ("tenant_quota", tenant_quota is not None, "tenant quotas"),
            ("host_tier", host_tier is not None, "host KV tier"),
            (f"role={role}", role != "colocated", "disaggregation"),
            ("kv_swap=False", not kv_swap, "recompute preemption")):
        if on:
            raise _not_ported(knob, what)


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
    stop_tokens: tuple = ()
    led: Optional[_Ledger] = None
    # stored as the reference stores them: priority orders preemption
    # (not ported), the deadline orders budgeted prefill (not ported)
    priority: int = 0
    tenant: str = DEFAULT_TENANT
    deadline: Optional[float] = None

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
    """One captured decode program: the graph, its output (the last
    step's logits, rewritten by every replay), the paged kernel's
    scratch tensors its launches recorded (held so they outlive any
    replacement), and its memory pool's reserved bytes at capture."""

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


@contextlib.contextmanager
def uncaptured(engine: "DecodeServer") -> Iterator[None]:
    """Within the block, ``engine`` runs its decode program directly on
    its device instead of replaying its captured graph: the comparison
    that ``chip_smoke.py`` and the tests make, not a mode to serve in."""
    engine._launch = engine._decode_program
    try:
        yield
    finally:
        del engine._launch


class DecodeServer:
    """Continuous-batching engine over ``max_batch`` slots and a paged
    arena of ``kv_blocks`` x ``kv_block_size`` tokens.

    ``submit`` enqueues (and, with a slot free, admits and prefills) a
    request; ``step`` decodes one token for every active slot (or
    ``step_begin`` / ``step_wait`` / ``step_finish`` in turn); ``drain``
    runs to completion and returns {rid: prompt + generated} for the
    requests finished since the last drain. Runs on ``device`` (default:
    the card; the CPU only when asked). ``paged_impl`` picks the paged
    attention formulation, "kernel" or "xla" (the gather); None reads
    ``effective_paged_impl()``."""

    def __init__(self, params: Params, cfg: TransformerConfig,
                 max_batch: int = 8, max_len: Optional[int] = None,
                 prefix_cache_size: int = 0, mesh=None,
                 prefill_chunk: int = 0, max_pending: int = 0,
                 pipeline_depth: int = 1, decode_steps: int = 1,
                 kv_block_size: int = 0, kv_blocks: int = 0,
                 kv_swap: bool = True, hbm_admit_frac: float = 0.0,
                 kv_dtype: str = "bf16", tenant_quota=None,
                 role: str = "colocated", host_tier=None,
                 prefill_budget: int = 0, device: DeviceLike = None,
                 paged_impl: Optional[str] = None):
        # the reference's own validation first, same messages
        if prefill_budget < 0:
            raise ValueError(
                f"prefill_budget must be >= 0, got {prefill_budget}")
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if decode_steps < 1:
            raise ValueError(
                f"decode_steps must be >= 1, got {decode_steps}")
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"kv_dtype must be bf16|int8, got {kv_dtype!r}")
        if role not in ("colocated", "prefill", "decode"):
            raise ValueError(
                f"role must be colocated|prefill|decode, got {role!r}")
        reject_unported(
            kv_blocks=kv_blocks, prefix_cache_size=prefix_cache_size,
            prefill_chunk=prefill_chunk, prefill_budget=prefill_budget,
            mesh=mesh, tenant_quota=tenant_quota, host_tier=host_tier,
            role=role, kv_swap=kv_swap)
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len or cfg.max_seq
        self.kv_block_size = bs = kv_block_size
        self.kv_dtype = kv_dtype
        self.hbm_admit_frac = float(hbm_admit_frac or 0.0)
        if self.max_len > cfg.max_seq:
            raise ValueError(
                f"cache max_len {self.max_len} exceeds the rope "
                f"table (cfg.max_seq {cfg.max_seq})")
        if bs < 8 or bs & (bs - 1):
            raise ValueError(
                f"kv_block_size must be a power of two >= 8, got "
                f"{bs} (blocks are compiled copy shapes, and "
                f"power-of-two sizes keep them bucket-aligned)")
        if self.max_len % bs:
            raise ValueError(
                f"max_len {self.max_len} must be a multiple of "
                f"kv_block_size {bs}: the gathered per-row timeline "
                f"(blocks_per_slot x block_size) must equal max_len "
                f"exactly so paged attention stays bit-identical to "
                f"the slot-static program")
        # the paged attention formulation, fixed ONCE at build: a later
        # env change cannot flip what this engine runs
        if paged_impl not in (None, "kernel", "xla"):
            raise ValueError(
                f"paged_impl must be kernel|xla, got {paged_impl!r}")
        self.paged_kernel = paged_impl or effective_paged_impl()
        check_paged_kernel_head_dim(cfg.head_dim, self.device,
                                    self.paged_kernel)
        self._nbs = self.max_len // bs
        self._alloc = BlockAllocator(kv_blocks, bs)
        self.cache = init_paged_cache(cfg, kv_blocks, bs, max_batch,
                                      kv_dtype=kv_dtype, device=self.device)
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
        # captured programs by ``sampling`` and the side stream they are
        # captured on
        self._graphs: Dict[bool, _Graph] = {}
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
        self.paged = True
        self.role = role
        self.pipeline_depth = pipeline_depth
        self.decode_steps = decode_steps
        self.prefill_budget = prefill_budget
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
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
        the request (it is part of the output). ``priority`` and
        ``deadline_s`` are stored for the schedulers that read them
        (preemption, budgeted prefill: not ported); ``cache_prefix`` and
        ``tenant`` are accepted and ignored, as the reference ignores them
        with no prefix cache and no tenant quota. ``Infeasible`` (a
        ValueError) when it can never fit this server, ``QueueFull``
        when ``max_pending`` requests already wait."""
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
        need = blocks_for(len(prompt) + max_new_tokens - 1,
                          self.kv_block_size)
        if need > self._alloc.capacity:
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
        now = time.perf_counter()
        self._pending.append(_Request(
            rid, [int(t) for t in prompt], max_new_tokens,
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p),
            seed=(rid if seed is None else int(seed)) & 0xFFFFFFFF,
            stop_tokens=tuple(int(t) for t in stop_tokens or ()),
            led=_Ledger(now), priority=int(priority),
            tenant=(str(tenant) if tenant else DEFAULT_TENANT),
            deadline=(now + float(deadline_s) if deadline_s else None)))
        self._admit()
        return rid

    def _admit(self) -> None:
        self._admit_blocked = False
        if self._pending and self._free:
            # barrier: an install changes the batch, and an unconsumed
            # tick still reads the old slot -> request binding
            self._flush()
        while self._pending and self._free:
            req = self._pending[0]
            if not self._admit_headroom(req):
                # free slots, but the head waits for KV-block/HBM
                # headroom that completions free
                self._admit_blocked = True
                break
            self._pending.popleft()
            req.slot = self._free.popleft()
            self._active[req.slot] = req
            req.led.t_admit = req.led.t_prefill_start = time.perf_counter()
            self._prefill_slot(req)

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
        be free, and the card's memory below ``hbm_admit_frac``."""
        plen = len(req.prompt)
        base_need = blocks_for(plen, self.kv_block_size)
        cap_blocks = blocks_for(plen + req.max_new_tokens - 1,
                                self.kv_block_size)
        need = min(base_need + 1, max(base_need, cap_blocks))
        hbm = self._hbm_sample()
        if self.hbm_admit_frac and hbm and hbm["limit"] \
                and hbm["in_use"] / hbm["limit"] > self.hbm_admit_frac:
            return False
        return need <= self._alloc.free_count

    def _prefill_slot(self, req: _Request) -> None:
        """Fresh-prompt prefill over a bucket-sized scratch row, then the
        first token and the install into the slot's blocks."""
        plen = len(req.prompt)
        bucket = min(max(_bucket(plen), self.kv_block_size), self.max_len)
        cfg = self.cfg
        row = init_cache(cfg, 1, bucket, device=self.device)
        toks = torch.tensor([req.prompt + [0] * (bucket - plen)],
                            dtype=torch.long, device=self.device)
        logits, row = forward_with_cache(self.params, cfg, toks, row)
        step = logits[0, plen - 1]
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
        self._paged_install(req, row, first)
        req.out.append(first)
        req.note_token()
        # the first token is observed here (its argmax or draw was a host
        # sync): TTFT's far stamp, and the TPOT clock's arm
        req.led.t_prefill_end = req.led.t_first = req.led.t_last = \
            time.perf_counter()
        self._finish_if_done(req)

    def _paged_install(self, req: _Request, row: Cache, first: int) -> None:
        """Land the prefilled scratch row in freshly allocated arena
        blocks (quantized per token under int8 — the same rule as the
        decode scatter), then set the slot's table row, pos and feed
        token. One indexed write per plane, in place."""
        bs = self.kv_block_size
        plen = len(req.prompt)
        n = blocks_for(plen, bs)
        table = self._alloc.alloc_many(n)
        idx = self._to_device(torch.tensor(table, dtype=torch.long))
        for name in ("k", "v"):
            r = row[name][:, 0, :, :n * bs]             # [L, Hkv, n*bs, D]
            L, h_kv, _, d = r.shape
            blk = r.reshape(L, h_kv, n, bs, d).permute(0, 2, 1, 3, 4)
            if self.kv_dtype == "int8":
                blk, sc = quantize_kv(blk)
                self.cache[f"{name}_scale"][:, idx] = sc
            self.cache[name][:, idx] = blk.to(self.cache[name].dtype)
        s = req.slot
        self._tables[s] = table
        self._set_table_row(s)
        self.cache["pos"][s].fill_(plen)
        self._last[s, 0].fill_(first)

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

    def _ensure_blocks(self, active: List[int]) -> None:
        """Each decoding slot's next ``decode_steps`` write positions,
        past those the ticks in flight already cover, must land in blocks
        it owns: growth allocates. Positions past the request's terminal
        length stay unallocated and route to the null block. Blocks are
        never shared in this slice (no prefix cache, no fork), so no
        copy-on-write is needed."""
        bs, span = self.kv_block_size, self.decode_steps
        for s in active:
            req = self._active[s]
            pending = sum(1 for ent in self._inflight
                          if not ent.consumed and s in ent.slots)
            start = len(req.prompt) + len(req.out) - 1 + pending * span
            end = min(start + span, len(req.prompt) + req.max_new_tokens - 1)
            if start >= end:
                continue
            table = self._tables[s]
            grown = False
            while len(table) <= (end - 1) // bs:
                table.append(self._alloc.alloc())
                grown = True
            if grown:
                self._set_table_row(s)

    def _pre_dispatch(self, active: List[int]) -> bool:
        """Block discipline before a dispatch. True: dispatch ``active``
        as it is. False: the pool ran dry and the window was flushed
        (late completions and their frees landed); recompute and retry.
        Dry with nothing in flight raises."""
        try:
            self._ensure_blocks(active)
            return True
        except NoFreeBlocks as e:
            if self._inflight:
                self._flush()
                return False
            raise NoFreeBlocks(
                f"{e}; preemption is not ported to the torch engine yet "
                f"— size kv_blocks for the load") from e

    def step(self) -> int:
        """One scheduling quantum, the three phases in a row: dispatch
        until the window is full, wait for the oldest tick, consume it;
        returns the tokens emitted (0 when idle)."""
        handle = self.step_begin()
        self.step_wait(handle)
        return self.step_finish(handle)

    def step_begin(self) -> Optional[_InFlight]:
        """Dispatch phase: ticks back to back until ``pipeline_depth``
        are in flight (the program feeds itself its next tokens on the
        device, so tick N+1 never waits for tick N's), each after its
        block growth and with its token copy to the host started.
        Returns the oldest unconsumed tick without waiting (None when
        idle)."""
        t_begin = time.perf_counter()
        self._begin_dispatch_s = 0.0
        active = sorted(self._active)
        while active and len(self._inflight) < self.pipeline_depth:
            if not self._pre_dispatch(active):
                active = sorted(self._active)
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

    def _decode_program(self, sampling: bool) -> torch.Tensor:
        """The decode tick on the engine's static buffers: ``T =
        decode_steps`` copies of the reference's ``decode_one`` (its
        ``lax.scan``, unrolled). Reads the arena, ``pos``, ``_table``,
        ``_last``, ``_keep`` and the sampling rows; writes the arena,
        ``pos``, ``_last`` and ``_toks`` in place. Rows outside ``_keep``
        decode into the null block with their pos and feed token frozen.
        A sampled token is keyed by (seed, its absolute index pos + 1),
        so streams do not depend on T. Returns the last step's logits."""
        keep = self._keep
        pos = self.cache["pos"]
        table = torch.where(keep[:, None], self._table,
                            torch.zeros_like(self._table))
        toks = self._last
        for j in range(self.decode_steps):
            logits, out = forward_paged(self.params, self.cfg, toks,
                                        self.cache, table,
                                        paged_impl=self.paged_kernel,
                                        scratch=self._scratch)
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
        """Run the decode program: on the card, replay its graph
        (captured at the first tick that needs it); on the CPU, call it.
        Returns the last step's logits."""
        if self.device.type != "cuda":
            return self._decode_program(sampling)
        graph = self._graphs.get(sampling)
        if graph is None:
            graph = self._graphs[sampling] = self._capture(sampling)
        return graph.replay()

    def capture_programs(self) -> Dict[str, float]:
        """Capture the decode programs (greedy, sampled) that are not yet
        captured, now instead of at the first tick that needs each, so
        no tick pays a capture; returns {"greedy"|"sampled": seconds}
        for those captured. Needs an idle engine. The CPU captures
        nothing."""
        if self.device.type != "cuda":
            return {}
        if self.has_work() or self._inflight:
            raise RuntimeError("capture_programs needs an idle engine")
        out = {}
        for sampling in (False, True):
            if sampling not in self._graphs:
                t0 = self.compile_s
                self._graphs[sampling] = self._capture(sampling)
                out["sampled" if sampling else "greedy"] = \
                    self.compile_s - t0
        return out

    def _capture(self, sampling: bool) -> _Graph:
        """Capture one decode program into a CUDA graph, on a side stream
        after everything queued on the engine's stream. A warm-up run
        first loads the kernels and sizes the paged kernel's scratch and
        launch counter (neither may be allocated inside a capture), as a
        null tick: every row outside the keep mask, so it writes only
        the null block and leaves pos and the feed tokens as they were.
        The graph reads nothing that is keyed by the side stream. Errors
        raise; the time is accounted as the reference accounts a
        compile."""
        t0 = time.perf_counter()
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        side = self._capture_stream
        main = torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            keep = self._keep.clone()
            self._keep.zero_()
            self._decode_program(sampling)
            self._keep.copy_(keep)
        main.wait_stream(side)
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            logits = self._decode_program(sampling)
        out = _Graph(graph, logits,
                     (self._scratch.part, self._scratch.ticket),
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
        completions) and admit into freed slots. Returns the tokens
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
        toks = ent.host
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
            self._finish_if_done(req, admit=False)
        self.tokens_emitted += emitted
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
        slots could decode."""
        if not self._inflight and self._idle_since is None \
                and self._active:
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
        """A measured decode-tick duration, kept for the budgeted-prefill
        cost model (not ported)."""
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

    def kv_stats(self) -> dict:
        """Block-pool accounting, the formulation this engine runs, and
        the admission-time memory snapshot, under the reference's keys
        (what is not ported reads as the reference reads with it off)."""
        return {
            "block_size": self.kv_block_size,
            "dtype": self.kv_dtype,
            "kernel": self.paged_kernel,
            "scaled_blocks": None,
            "blocks_total": self._alloc.capacity,
            "blocks_free": self._alloc.free_count,
            "blocks_used": self._alloc.used_count,
            "cow_shared": 0,            # no prefix cache, no fork
            "deferred_frees": len(self._deferred),
            "prefix": None,
            "preempts": {"swap": 0, "recompute": 0},   # not ported
            "tenant_reclaims": 0,
            "swapped_pending": 0,
            "hbm": self.hbm,
        }

    def stats(self) -> dict:
        """Live introspection for ``/stats``, the reference's engine
        half: per-slot state, queue, the in-flight window, the prefix
        cache and compile accounting (zero here), the block pool."""
        now = time.perf_counter()
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
                "prefilling": False,
                "sampling": {"temperature": req.temperature,
                             "top_k": req.top_k, "top_p": req.top_p,
                             "seed": req.seed},
            })
        oldest = (now - self._pending[0].led.t_submit
                  if self._pending else 0.0)
        return {
            "engine": type(self).__name__,
            "role": self.role,
            "handoff": None,
            "max_batch": self.max_batch,
            "max_len": self.max_len,
            "slots": slots,
            "pending": {"depth": len(self._pending),
                        "oldest_wait_s": round(oldest, 6)},
            "prefill_sched": None,
            "pipeline": {"depth": self.pipeline_depth,
                         "decode_steps": self.decode_steps,
                         "in_flight": len(self._inflight),
                         "flushes": self.pipeline_flushes,
                         "ticks_dispatched": self.ticks_dispatched},
            "prefix_cache": {"capacity": 0, "entries": 0,
                             "hits": self.prefix_hits,
                             "tokens_saved": self.prefix_tokens_saved},
            "prefix_index": None,
            "kv": self.kv_stats(),
            "tenants": None,
            "compiles": {"count": self.compiles,
                         "seconds": round(self.compile_s, 6)},
            "tokens_emitted": self.tokens_emitted,
        }

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
        self._graphs = {}
        self._capture_stream = None
        self._inflight = deque()
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
