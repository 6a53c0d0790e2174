"""Continuous-batching decode serving over the paged KV cache (port of
the host-serial, paged core of ``nos_tpu/models/serving.py``).

Requests occupy rows ("slots") of one decode batch; their KV lives in a
pooled arena mapped per slot by block tables. ``submit`` admits a
request to a free slot and prefills it at once over a scratch row
(``forward_with_cache``, the prompt padded to a power-of-two bucket),
then installs the row into the slot's freshly allocated blocks —
quantizing into an int8 arena when ``kv_dtype="int8"``. A decode tick
runs every active slot through ``forward_paged`` (inactive slots ride
along with their table rows zeroed to the null block and their ``pos``
frozen) and appends each slot's token. Greedy requests are
token-identical to ``generate_paged``. Every slot carries its own
sampling params (temperature, top-k, top-p, seed), and a sampled token
is keyed by (seed, absolute position), so a request's stream does not
depend on what else shares the batch; a tick in which no active slot
samples runs none of the sampling ops.

A tick is three phases, as in the reference, so a serving loop can run
the one blocking wait outside its lock: ``step_begin`` dispatches the
tick's device work and starts a non-blocking copy of its tokens into a
pinned host buffer behind a CUDA event; ``step_wait`` blocks on that
event only; ``step_finish`` appends the tokens, retires completions and
admits. ``step`` is the three in a row. Every change of the batch while
a tick is in flight (admission, ``cancel``) first consumes that tick
(the reference's barrier ``_flush``), so ``step_finish`` is idempotent
on a flushed tick. Each request keeps the reference's latency ledger
(``pop_ledger``), read by the serving loop's TTFT/TPOT histograms.

What the reference engine has and this slice does not yet port raises
a ``ValueError`` naming the knob: the prefix cache, chunked and
budgeted prefill, ``pipeline_depth > 1``, ``decode_steps > 1``, meshes,
tenant quotas, the host tier, prefill/decode roles, the slot-static
engine (``kv_blocks == 0``) and preemption, with its capture and
restore. ``cache_prefix`` and ``tenant`` are accepted and ignored, as
the reference engine ignores them with no prefix cache and no quota.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

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
                    pipeline_depth: int = 1, decode_steps: int = 1,
                    mesh=None, tenant_quota=None, host_tier=None,
                    role: str = "colocated", kv_swap: bool = True) -> None:
    """Raise a ValueError naming the first engine knob set outside this
    slice; ``build_engine`` calls it before loading any weights."""
    for knob, on, what in (
            ("kv_blocks=0", kv_blocks <= 0, "the slot-static engine"),
            ("prefix_cache_size", prefix_cache_size, "prefix cache"),
            ("prefill_chunk", prefill_chunk, "chunked prefill"),
            ("prefill_budget", prefill_budget, "budgeted prefill"),
            ("pipeline_depth", pipeline_depth > 1, "pipelined decode"),
            ("decode_steps", decode_steps > 1, "fused decode steps"),
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
    """One dispatched, unconsumed decode tick: the host buffer its
    tokens are copied into, the event that marks the copy done (None on
    the CPU, where the copy is synchronous), the slots it decoded, and
    (once fetched) the tokens as a list. ``consumed`` makes consumption
    idempotent, so a barrier flush racing ``step_finish`` processes the
    tick exactly once."""

    __slots__ = ("buf", "event", "slots", "host", "consumed")

    def __init__(self, buf: torch.Tensor, event, slots: Tuple[int, ...]):
        self.buf = buf
        self.event = event
        self.slots = slots
        self.host: Optional[List[int]] = None
        self.consumed = False


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
            pipeline_depth=pipeline_depth, decode_steps=decode_steps,
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
        # the one in-flight tick (pipeline_depth 1) and the pinned host
        # buffer its tokens land in; tokens a barrier flush consumed are
        # credited to the next step_finish
        self._inflight: Optional[_InFlight] = None
        self._host_toks: Optional[torch.Tensor] = None
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
        # eager torch compiles nothing: no compile events, ever
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
        idx = torch.tensor(table, dtype=torch.long, device=self.device)
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
        self.cache["pos"][s] = plen
        self._last[s, 0] = first

    def _set_sampling_rows(self, req: _Request) -> None:
        """Install one request's sampling params in its slot's rows: the
        one place they land."""
        s = req.slot
        self._temp[s] = req.temperature
        self._topk[s] = req.top_k
        self._topp[s] = req.top_p
        self._seed[s] = req.seed

    def _set_table_row(self, slot: int) -> None:
        """Mirror one slot's host block table into the device table
        (unassigned logical blocks -> the null block 0)."""
        row = np.zeros((self._nbs,), np.int32)
        blocks = self._tables[slot]
        row[:len(blocks)] = blocks
        self._table[slot] = torch.from_numpy(row).to(self.device)

    def _finish_if_done(self, req: _Request, admit: bool = True) -> None:
        """Completion: free the slot's blocks, reset its pos, close the
        ledger, and (unless the caller admits once after a whole tick)
        admit."""
        if req.done and req.slot >= 0:
            s = req.slot
            del self._active[s]
            for b in self._tables[s]:
                self._alloc.decref(b)
            self._tables[s] = []
            self.cache["pos"][s] = 0
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

    def _ensure_blocks(self, active: List[int]) -> None:
        """Each decoding slot's next write position must land in a block
        it owns: growth allocates. Positions past the request's terminal
        length stay unallocated and route to the null block. Blocks are
        never shared in this slice (no prefix cache, no fork), so no
        copy-on-write is needed."""
        bs = self.kv_block_size
        for s in active:
            req = self._active[s]
            start = len(req.prompt) + len(req.out) - 1
            if start >= len(req.prompt) + req.max_new_tokens - 1:
                continue
            table = self._tables[s]
            if start // bs >= len(table):
                try:
                    table.append(self._alloc.alloc())
                except NoFreeBlocks as e:
                    raise NoFreeBlocks(
                        f"{e}; preemption is not ported to the torch "
                        f"engine yet — size kv_blocks for the load") from e
                self._set_table_row(s)

    def step(self) -> int:
        """One decode tick for every active slot, the three phases in a
        row; returns the tokens emitted (0 when idle)."""
        handle = self.step_begin()
        self.step_wait(handle)
        return self.step_finish(handle)

    def step_begin(self) -> Optional[_InFlight]:
        """Dispatch phase: grow block tables, dispatch the tick's device
        work (``forward_paged``, argmax, the sampling ops when a slot
        samples), update ``_last`` and ``pos``, and start a non-blocking
        copy of the ``[max_batch]`` tokens into a pinned host buffer
        behind a CUDA event. Returns the in-flight tick without waiting
        (None when idle); with a tick already in flight it dispatches
        nothing and returns that one."""
        t_begin = time.perf_counter()
        self._begin_dispatch_s = 0.0
        if self._inflight is None:
            active = sorted(self._active)
            if active:
                self._ensure_blocks(active)
                self._dispatch_tick(active)
        # everything outside _dispatch_tick is assembly
        self.last_assemble_s = max(
            0.0, time.perf_counter() - t_begin - self._begin_dispatch_s)
        return self._inflight

    def _dispatch_tick(self, active: List[int]) -> None:
        t0 = time.perf_counter()
        if self._idle_since is not None:
            # the dispatch gap ends when a tick is in flight again
            self.dispatch_gap_s += t0 - self._idle_since
            self._idle_since = None
        keep = torch.zeros((self.max_batch,), dtype=torch.bool,
                           device=self.device)
        keep[active] = True
        # inactive rows decode too, into the null block, pos frozen
        table = torch.where(keep[:, None], self._table,
                            torch.zeros_like(self._table))
        pos0 = self.cache["pos"].clone()
        logits, self.cache = forward_paged(
            self.params, self.cfg, self._last, self.cache, table,
            paged_impl=self.paged_kernel)
        self.cache["pos"] = torch.where(keep, self.cache["pos"], pos0)
        step = logits[:, -1].float()
        nxt = torch.argmax(step, dim=-1)
        if any(self._active[s].temperature > 0 for s in active):
            nxt = self._sample(step, pos0, nxt)
        self._last = torch.where(keep[:, None], nxt[:, None], self._last)
        if self.device.type == "cuda":
            if self._host_toks is None:
                self._host_toks = torch.empty(
                    (self.max_batch,), dtype=torch.long, pin_memory=True)
            # one buffer serves every tick: a tick is consumed before the
            # next is dispatched
            self._host_toks.copy_(nxt, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            buf = self._host_toks
        else:
            buf, event = nxt, None        # already on the host
        self.ticks += 1
        self.ticks_dispatched += 1
        dt = time.perf_counter() - t0
        self.host_block_s += dt
        self._begin_dispatch_s += dt
        self._inflight = _InFlight(buf, event, tuple(active))

    def step_wait(self, ent: Optional[_InFlight]) -> None:
        """Block until ``ent``'s tokens are on the host: the event's
        ``synchronize``, which releases the interpreter lock. A no-op for
        None or a tick already consumed."""
        if ent is None or ent.consumed:
            return
        self._fetch(ent)

    def _fetch(self, ent: _InFlight) -> None:
        """The tick's tokens as a host list. Two threads may fetch one
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
            assert self._inflight is ent
            self._inflight = None
            emitted += self._consume(ent)
        self._admit()
        self._note_window_empty()
        return emitted

    def _consume(self, ent: _InFlight) -> int:
        """Append one tick's tokens to its requests, once. A slot whose
        request finished meanwhile contributes nothing."""
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
            req.out.append(toks[s])
            req.note_token()
            emitted += 1
            if now:
                req.led.note_tokens(1, now)
            self._finish_if_done(req, admit=False)
        self.tokens_emitted += emitted
        return emitted

    def _flush(self) -> int:
        """Barrier: consume the in-flight tick before the batch changes;
        its tokens are credited to the next step_finish."""
        ent, self._inflight = self._inflight, None
        if ent is None:
            return 0
        self.pipeline_flushes += 1
        emitted = self._consume(ent)
        self._flush_emitted += emitted
        return emitted

    def _note_window_empty(self) -> None:
        """Start the dispatch-gap clock when no tick is in flight while
        slots could decode."""
        if self._inflight is None and self._idle_since is None \
                and self._active:
            self._idle_since = time.perf_counter()

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
        # barrier: the in-flight tick lands first (it may even finish
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
            "deferred_frees": 0,
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
                         "in_flight": int(self._inflight is not None),
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
        """Drop this engine's device tensors (weights, arena, tables) so
        a supervised rebuild does not need twice the card's memory; the
        host bookkeeping (progress, stats) stays readable. The engine
        cannot tick again. ``free_cache`` also returns the freed blocks
        to the device (not done for a device declared wedged: freeing
        would wait on it)."""
        self.params = self.cache = self._table = self._last = None
        self._temp = self._topk = self._topp = self._seed = None
        self._inflight = None
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
