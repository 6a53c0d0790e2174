"""Continuous-batching decode serving over the paged KV cache (port of
the greedy, host-serial, paged core of ``nos_tpu/models/serving.py``).

Requests occupy rows ("slots") of one decode batch; their KV lives in a
pooled arena mapped per slot by block tables. ``submit`` admits a
request to a free slot and prefills it at once over a scratch row
(``forward_with_cache``, the prompt padded to a power-of-two bucket),
then installs the row into the slot's freshly allocated blocks —
quantizing into an int8 arena when ``kv_dtype="int8"``. ``step`` runs
one decode tick for every active slot through ``forward_paged``
(inactive slots ride along with their table rows zeroed to the null
block and their ``pos`` frozen) and appends each slot's token. Greedy
requests are token-identical to ``generate_paged``. Every slot carries
its own sampling params (temperature, top-k, top-p, seed), and a
sampled token is keyed by (seed, absolute position), so a request's
stream does not depend on what else shares the batch; a tick in which
no active slot samples runs none of the sampling ops.

What the reference engine has and this slice does not yet port raises
a ``ValueError`` naming the knob: the prefix cache, chunked and
budgeted prefill, ``pipeline_depth > 1``, ``decode_steps > 1``, meshes,
tenant quotas, the host tier, prefill/decode roles, the slot-static
engine (``kv_blocks == 0``) and preemption.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from nos_tpu_torch.device import DeviceLike, resolve_device
from nos_tpu_torch.models.errors import Infeasible, QueueFull
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


def _not_ported(knob: str, what: str) -> ValueError:
    return ValueError(
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

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new_tokens


class DecodeServer:
    """Continuous-batching engine over ``max_batch`` slots and a paged
    arena of ``kv_blocks`` x ``kv_block_size`` tokens.

    ``submit`` enqueues (and, with a slot free, admits and prefills) a
    request; ``step`` decodes one token for every active slot;
    ``drain`` runs to completion and returns {rid: prompt + generated}
    for the requests finished since the last drain. Runs on ``device``
    (default: the card; the CPU only when asked). ``paged_impl`` picks
    the paged attention formulation, "kernel" or "xla" (the gather);
    None reads ``effective_paged_impl()``."""

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
        self._hbm: Optional[float] = None
        self._hbm_next = 0.0
        self.ticks = 0
        self.tokens_emitted = 0

    # ------------------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 0.0, seed: Optional[int] = None) -> int:
        """Enqueue a request; returns its id. ``temperature`` 0 is greedy;
        > 0 samples, optionally truncated by ``top_k``/``top_p``.
        ``seed`` keys the request's sample stream (default: the request
        id): the same (prompt, params, seed) gives the same tokens
        whatever else shares the batch. ``Infeasible`` (a ValueError)
        when it can never fit this server, ``QueueFull`` when
        ``max_pending`` requests already wait."""
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
        self._pending.append(_Request(
            rid, [int(t) for t in prompt], max_new_tokens,
            temperature=float(temperature), top_k=int(top_k),
            top_p=float(top_p),
            seed=(rid if seed is None else int(seed)) & 0xFFFFFFFF))
        self._admit()
        return rid

    def _admit(self) -> None:
        self._admit_blocked = False
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
            self._prefill_slot(req)

    def _hbm_frac(self) -> Optional[float]:
        """Share of the card's memory in use by PyTorch tensors, sampled
        at most twice a second; None on the CPU."""
        if self.device.type != "cuda":
            return None
        now = time.perf_counter()
        if self._hbm is None or now >= self._hbm_next:
            self._hbm_next = now + 0.5
            total = torch.cuda.get_device_properties(self.device).total_memory
            self._hbm = torch.cuda.memory_allocated(self.device) / total
        return self._hbm

    def _admit_headroom(self, req: _Request) -> bool:
        """Memory-aware admission: the request's install blocks plus one
        block of growth headroom (capped at its full-length need) must
        be free, and the card's memory below ``hbm_admit_frac``."""
        plen = len(req.prompt)
        base_need = blocks_for(plen, self.kv_block_size)
        cap_blocks = blocks_for(plen + req.max_new_tokens - 1,
                                self.kv_block_size)
        need = min(base_need + 1, max(base_need, cap_blocks))
        frac = self._hbm_frac() if self.hbm_admit_frac else None
        if frac is not None and frac > self.hbm_admit_frac:
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
        """Completion: free the slot's blocks, reset its pos, and (unless
        the caller admits once after a whole tick) admit."""
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
            if admit:
                self._admit()

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
        """One decode tick for every active slot; returns the tokens
        emitted (0 when idle)."""
        active = sorted(self._active)
        if not active:
            return 0
        self._ensure_blocks(active)
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
        toks = nxt.cpu().tolist()
        self.ticks += 1
        emitted = 0
        for s in active:
            req = self._active[s]
            req.out.append(toks[s])
            emitted += 1
            self._finish_if_done(req, admit=False)
        self.tokens_emitted += emitted
        self._admit()
        return emitted

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

    def progress(self, rid: int) -> Optional[tuple]:
        """(generated tokens so far, done); None for an unknown rid."""
        req = self._done.get(rid)
        if req is not None:
            return list(req.out[:req.max_new_tokens]), True
        for req in list(self._active.values()) + list(self._pending):
            if req.rid == rid:
                return list(req.out), False
        return None

    def kv_stats(self) -> dict:
        """Block-pool accounting and the formulation this engine runs."""
        return {
            "block_size": self.kv_block_size,
            "dtype": self.kv_dtype,
            "kernel": self.paged_kernel,
            "blocks_total": self._alloc.capacity,
            "blocks_free": self._alloc.free_count,
            "blocks_used": self._alloc.used_count,
        }

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
        out = {r.rid: r.prompt + r.out[:r.max_new_tokens]
               for r in self._done.values()}
        self._done.clear()
        return out
