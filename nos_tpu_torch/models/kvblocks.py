"""Paged KV-cache block accounting (a copy of
``nos_tpu/models/kvblocks.py``): the host half of the paged serving
engine, torch-free.

- ``BlockAllocator``: a refcounted free list over the physical blocks.
  Block 0 is RESERVED as the null block: unassigned block-table entries
  point at it, so writes by inactive rows and over-decode past a
  request's length land somewhere harmless. It is never allocated and
  never freed.
- copy-on-write: ``fork`` bumps refcounts (a fork or a shared system
  prompt costs table entries, not device memory); ``writable`` says
  whether a block may be written in place (refcount 1). A holder about
  to write a shared block allocates a fresh one, copies the contents
  on the device, and drops its reference.
- ``PrefixBlockIndex``: block-granular prefix reuse. Full blocks of a
  published prompt are shared by refcount with every later request
  whose prompt starts with the same tokens, LRU-evicted under a block
  budget.
- ``ScaleLedger``: which blocks of an int8 arena carry valid scales,
  dropped in the same decref that frees a block.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

__all__ = ["BlockAllocator", "PrefixBlockIndex", "ScaleLedger",
           "NoFreeBlocks", "NULL_BLOCK", "blocks_for"]

# physical block 0: the reserved null/scratch block every unassigned
# block-table entry points at (see module docstring)
NULL_BLOCK = 0


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` KV entries (ceil division)."""
    return -(-max(0, tokens) // block_size)


class NoFreeBlocks(RuntimeError):
    """The pool has no free block to hand out RIGHT NOW — a transient
    condition the caller resolves by flushing deferred frees, evicting
    prefix blocks, or preempting a slot (never by crashing)."""


class BlockAllocator:
    """Refcounted free-list allocator over ``num_blocks`` physical KV
    blocks of ``block_size`` tokens each. Block ``NULL_BLOCK`` is
    reserved and never enters the free list.

    Invariants:
    - every referenced block has refcount >= 1, every free block 0;
    - free + referenced + reserved == num_blocks (no lost blocks);
    - decref below zero (double free) raises;
    - a block is ``writable`` iff exactly one holder references it.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(
                f"kv_blocks must be >= 2 (one reserved null block plus "
                f"at least one usable), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"kv_block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._refs: List[int] = [0] * num_blocks
        self._free: Deque[int] = deque(range(1, num_blocks))
        # blocks at refcount > 1, maintained incrementally: the gauge
        # mirror reads this per request under the serving-loop lock,
        # so it must not scan a production-sized pool
        self._shared = 0
        # int8-KV engines attach a ScaleLedger so per-block
        # quantization-scale bookkeeping drops in LOCKSTEP with block
        # frees — whoever decrefs the last reference (slot teardown,
        # prefix eviction, preemption), the scale entry dies with the
        # block, never from a parallel code path that could drift
        self.scale_ledger: Optional["ScaleLedger"] = None

    # -- core ----------------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    @property
    def capacity(self) -> int:
        """Usable blocks (the reserved null block excluded)."""
        return self.num_blocks - 1

    def ref(self, block: int) -> int:
        return self._refs[block]

    def alloc(self) -> int:
        """One fresh block at refcount 1, or NoFreeBlocks."""
        if not self._free:
            raise NoFreeBlocks(
                f"all {self.capacity} KV blocks referenced")
        b = self._free.popleft()
        assert self._refs[b] == 0
        self._refs[b] = 1
        return b

    def alloc_many(self, n: int) -> List[int]:
        """``n`` fresh blocks, all-or-nothing (a partial allocation
        would leak on the error path)."""
        if n > len(self._free):
            raise NoFreeBlocks(
                f"need {n} KV blocks, {len(self._free)} free "
                f"(of {self.capacity})")
        return [self.alloc() for _ in range(n)]

    def incref(self, block: int) -> None:
        if block == NULL_BLOCK:
            raise ValueError("the reserved null block cannot be referenced")
        if self._refs[block] < 1:
            raise ValueError(f"incref of unreferenced block {block}")
        self._refs[block] += 1
        if self._refs[block] == 2:
            self._shared += 1

    def decref(self, block: int) -> bool:
        """Drop one reference; True when this freed the block."""
        if block == NULL_BLOCK:
            raise ValueError("the reserved null block cannot be freed")
        if self._refs[block] < 1:
            raise ValueError(f"double free of block {block}")
        self._refs[block] -= 1
        if self._refs[block] == 1:
            self._shared -= 1
        elif self._refs[block] == 0:
            self._free.append(block)
            if self.scale_ledger is not None:
                self.scale_ledger.note_free(block)
            return True
        return False

    # -- COW -----------------------------------------------------------
    def fork(self, blocks: Sequence[int]) -> List[int]:
        """Share ``blocks`` with a second holder: refcount bump per
        block, no data movement — the returned table is the caller's
        own (COW: a holder must ``writable``-check before mutating)."""
        for b in blocks:
            self.incref(b)
        return list(blocks)

    def writable(self, block: int) -> bool:
        """True iff exactly one holder references ``block`` — the COW
        gate: a shared block must be copied before its first write."""
        return self._refs[block] == 1

    def shared_count(self) -> int:
        """Blocks currently referenced by more than one holder — the
        COW-sharing win the ``nos_tpu_serve_kv_blocks_cow_shared``
        gauge reports (each such block would otherwise be a copy).
        O(1): maintained in incref/decref."""
        return self._shared


class PrefixBlockIndex:
    """Block-granular prefix reuse: full KV blocks of published prompts,
    keyed by their token content, shared by refcount with any request
    whose prompt starts with the same tokens.

    An entry is a CHAIN: the ordered full blocks of one published
    prompt, stored as (token tuple, block ids). ``match`` returns the
    longest block-aligned common head over all chains — block j of a
    chain is only valid together with blocks 0..j-1 (its KV attends to
    them), so sharing is always a chain prefix, never a mid-chain
    block. The index holds one reference per block per chain
    (``allocator.fork`` on publish); eviction is LRU whole-chain under
    ``max_blocks``. Capacity pressure from live slots calls
    ``evict_lru`` before any slot is preempted — cached prefixes are
    the cheapest memory to reclaim.

    Chains are SCOPE-partitioned: ``match`` / ``publish`` take an
    opaque ``scope`` (the serving engine passes the request's resolved
    tenant under a tenant quota, None otherwise), and a chain only ever
    matches prompts in
    its own scope. Cross-tenant KV block sharing is a timing
    side-channel (an adversary probing whether another tenant's prompt
    is cached by watching its own TTFT) and an isolation hole once a
    shared block is COW-relied on — two tenants publishing identical
    prompts therefore get DISJOINT chains unless the operator opts
    into sharing (``TenantQuotaConfig.share_prefix``), which collapses
    every scope to the default ``None``."""

    def __init__(self, allocator: BlockAllocator, max_blocks: int):
        self.alloc = allocator
        self.max_blocks = max_blocks
        # insertion-ordered LRU: (scope, full token tuple) -> block ids
        self._chains: Dict[tuple, List[int]] = {}
        self.hits = 0
        self.tokens_saved = 0
        # eviction observability and the host tier's demotion hook:
        # every evicted chain counts under exactly one tier, "demote"
        # when ``on_evict`` (the engine's host-tier capture, called with
        # the chain's key and block ids BEFORE the refcounts drop, so the
        # arena bytes are still live to read) accepted it, "drop"
        # otherwise (no hook, hook refused, or hook failed)
        self.evicted = {"drop": 0, "demote": 0}
        self.on_evict: Optional[
            Callable[[tuple, Tuple[int, ...]], bool]] = None

    @property
    def block_count(self) -> int:
        return sum(len(c) for c in self._chains.values())

    def match(self, prompt: Sequence[int], cap: int,
              scope: Optional[str] = None
              ) -> Tuple[int, Optional[tuple]]:
        """(m, chain_key) for the longest block-aligned common head
        between ``prompt`` and any chain IN ``scope``, with m <= cap
        (the caller passes plen-1: at least one suffix token must run
        to produce logits). (0, None) when nothing matches. Pure
        lookup — the caller decides whether the match is used before
        ``take`` moves refcounts and LRU order. Linear scan over
        chains: the index is operator-capped small (system prompts,
        not pages)."""
        bs = self.alloc.block_size
        best, best_key = 0, None
        for key in self._chains:
            if key[0] != scope:
                continue        # another tenant's chain: invisible
            m = 0
            for a, b in zip(key[1], prompt):
                if a != b:
                    break
                m += 1
            m = (min(m, cap) // bs) * bs
            if m > best:
                best, best_key = m, key
        return best, best_key

    def take(self, key: tuple, m: int) -> List[int]:
        """Claim the first ``m`` tokens' blocks of chain ``key`` for a
        new holder: refcount bump per block (COW share), LRU refresh.
        Returns the shared block ids in logical order."""
        bs = self.alloc.block_size
        assert m % bs == 0
        chain = self._chains.pop(key)       # pop-then-set: LRU refresh
        self._chains[key] = chain
        shared = self.alloc.fork(chain[:m // bs])
        self.hits += 1
        self.tokens_saved += m
        return shared

    def publish(self, prompt: Sequence[int], blocks: Sequence[int],
                scope: Optional[str] = None) -> None:
        """Register ``prompt``'s full blocks as a reusable chain in
        ``scope`` (the holder keeps its own references; the index
        takes one more per block), then LRU-evict past the block
        budget."""
        bs = self.alloc.block_size
        full = len(prompt) // bs
        if full == 0 or self.max_blocks <= 0:
            return
        key = (scope, tuple(prompt[:full * bs]))
        if key in self._chains:
            self._chains[key] = self._chains.pop(key)   # LRU refresh
            return
        self._chains[key] = self.alloc.fork(list(blocks[:full]))
        while self.block_count > self.max_blocks and len(self._chains) > 1:
            self._evict_one()
        # a single over-budget chain stays: evicting the chain we just
        # published would make cache_prefix a silent no-op

    def _evict_one(self) -> int:
        key = next(iter(self._chains))
        chain = self._chains.pop(key)
        tier = "drop"
        if self.on_evict is not None:
            # a failed demotion degrades to the plain drop, never aborts
            # pressure relief midway
            try:
                if self.on_evict(key, tuple(chain)):
                    tier = "demote"
            except Exception:
                tier = "drop"
        self.evicted[tier] += 1
        freed = 0
        for b in chain:
            if self.alloc.decref(b):
                freed += 1
        return freed

    def evict_lru(self, need_blocks: int) -> int:
        """Free chains (oldest first) until >= ``need_blocks`` blocks
        were actually returned to the pool (a still-shared block frees
        nothing) or the index is empty. Returns blocks freed."""
        freed = 0
        while self._chains and freed < need_blocks:
            freed += self._evict_one()
        return freed

    def clear(self) -> None:
        while self._chains:
            self._evict_one()

    def chain_items(self) -> List[Tuple[tuple, List[int]]]:
        """(key, block ids) snapshot in LRU order, oldest first — the
        KV-fabric export/snapshot surface (read-only by contract)."""
        return list(self._chains.items())

    def stats(self) -> dict:
        return {"chains": len(self._chains),
                "blocks": self.block_count,
                "capacity_blocks": self.max_blocks,
                "hits": self.hits,
                "tokens_saved": self.tokens_saved,
                "evicted": dict(self.evicted)}


class ScaleLedger:
    """Host mirror of the int8 arena's per-block quantization scales:
    which PHYSICAL blocks currently carry valid scale entries, and a
    monotone data version per block so the property tests can prove
    the lockstep lifecycle the device arrays rely on:

    - a WRITE into a block stamps (or re-stamps) its scale version —
      the device-side quantize-on-scatter writes data and scale in one
      program, so host bookkeeping treats them as one event;
    - a COW copy duplicates the source's version onto the fresh block
      (the engine's ``_cow_block`` copies data AND scale planes together);
    - a FORK shares the block id itself, so the scale entry is shared
      by construction — nothing to track;
    - the block's FREE drops the entry, driven by the allocator's
      decref (``BlockAllocator.scale_ledger``), so a reused block can
      never present a stale scale as fresh data's.

    Pure host accounting: the engine keeps it for /stats
    (``scaled_blocks``)."""

    def __init__(self) -> None:
        self._ver: Dict[int, int] = {}      # physical block -> version
        self._next = 0

    def note_write(self, block: int) -> None:
        """Data (and therefore scales) written into ``block``."""
        self._ver[block] = self._next
        self._next += 1

    def note_copy(self, src: int, dst: int) -> None:
        """COW: ``dst`` now holds a byte-copy of ``src``'s data and
        scale planes — same version, distinct block."""
        if src in self._ver:
            self._ver[dst] = self._ver[src]

    def note_free(self, block: int) -> None:
        self._ver.pop(block, None)

    def version(self, block: int) -> Optional[int]:
        return self._ver.get(block)

    @property
    def count(self) -> int:
        """Blocks currently carrying valid scales (the /stats
        ``scaled_blocks`` figure)."""
        return len(self._ver)
