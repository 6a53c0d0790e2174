"""Paged KV-cache block accounting (a copy of the allocator of
``nos_tpu/models/kvblocks.py`` as far as this slice uses it; sharing —
``incref``/``fork``/``writable`` — the prefix index and the int8 scale
ledger come back with the prefix-cache slice).

Block 0 is RESERVED as the null block: unassigned block-table entries
point at it, so writes by inactive rows and over-decode past a
request's length land somewhere harmless. It is never allocated and
never freed.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List

__all__ = ["BlockAllocator", "NoFreeBlocks", "NULL_BLOCK", "blocks_for"]

NULL_BLOCK = 0


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` KV entries (ceil division)."""
    return -(-max(0, tokens) // block_size)


class NoFreeBlocks(RuntimeError):
    """The pool has no free block to hand out RIGHT NOW."""


class BlockAllocator:
    """Refcounted free-list allocator over ``num_blocks`` physical KV
    blocks of ``block_size`` tokens each. Block ``NULL_BLOCK`` is
    reserved and never enters the free list.

    Invariants: every referenced block has refcount >= 1, every free
    block 0; free + referenced + reserved == num_blocks; decref below
    zero raises."""

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
        """``n`` fresh blocks, all-or-nothing."""
        if n > len(self._free):
            raise NoFreeBlocks(
                f"need {n} KV blocks, {len(self._free)} free "
                f"(of {self.capacity})")
        return [self.alloc() for _ in range(n)]

    def decref(self, block: int) -> bool:
        """Drop one reference; True when this freed the block."""
        if block == NULL_BLOCK:
            raise ValueError("the reserved null block cannot be freed")
        if self._refs[block] < 1:
            raise ValueError(f"double free of block {block}")
        self._refs[block] -= 1
        if self._refs[block] == 0:
            self._free.append(block)
            return True
        return False
