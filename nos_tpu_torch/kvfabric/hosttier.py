"""The host-RAM KV tier (a copy of ``nos_tpu/kvfabric/hosttier.py``
for the port; torch-free): a bounded, LRU byte store for demoted prefix
chains.

Sits UNDER a replica's device arena in the demotion ladder
(device → host → drop): when block pressure evicts an LRU prefix chain,
the engine's eviction hook offers the chain's swap payload here
instead of dropping it; a later prefix miss that matches a stored
chain promotes it back into the arena via the batched restore
scatter, bit-exact (the bytes never changed). The store also backs
the ``GET /v1/kvchain/<digest>`` peer-pull endpoint, so a chain
demoted on one replica can still warm a peer.

Capacity is charged in PAYLOAD bytes (``chain_nbytes`` — KV planes +
scale planes), bounded by ``capacity_bytes``; inserting past the
bound evicts oldest-first, and a single chain larger than the whole
store is rejected outright (it could never be admitted). Thread-safe:
the serving loop demotes/promotes under its own lock while HTTP
handler threads serve peer pulls concurrently.

Scoping: entries are keyed ``(scope, tokens)`` exactly like
``PrefixBlockIndex`` chains, and ``match`` is scope-filtered — a
tenant's demoted chain is invisible to every other scope's misses,
the same side-channel rule the device index enforces.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from nos_tpu_torch.kvfabric.codec import chain_digest, chain_nbytes

__all__ = ["HostTierStore"]


class HostTierStore:
    """Bounded host-RAM LRU of demoted prefix chains, keyed
    ``(scope, token tuple)``; every entry carries its payload bytes
    count and fleet-wide digest (computed once at insert)."""

    def __init__(self, capacity_bytes: int):
        if capacity_bytes < 1:
            raise ValueError(
                f"host-tier capacity_bytes must be >= 1, got "
                f"{capacity_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        # insertion-ordered LRU: (scope, tokens) -> entry dict
        self._chains: Dict[tuple, dict] = {}
        self._bytes = 0
        self._lock = threading.Lock()
        self.counts = {"demoted": 0, "evicted": 0, "rejected": 0}

    # -- write side ----------------------------------------------------
    def put(self, scope: Optional[str], tokens: Sequence[int],
            swap: dict) -> bool:
        """Store one demoted chain; True iff it was admitted (False =
        larger than the whole store — the eviction that offered it
        falls through to a plain drop). Re-demoting a key that is
        already stored refreshes its LRU position without copying."""
        key = (scope, tuple(int(t) for t in tokens))
        nbytes = chain_nbytes(swap)
        with self._lock:
            if nbytes > self.capacity_bytes:
                self.counts["rejected"] += 1
                return False
            if key in self._chains:
                ent = self._chains.pop(key)     # pop-then-set: LRU refresh
                self._chains[key] = ent
                return True
            while self._chains and self._bytes + nbytes > self.capacity_bytes:
                self._evict_one_locked()
            self._chains[key] = {
                "swap": dict(swap),
                "nbytes": nbytes,
                "digest": chain_digest(key[1], scope),
            }
            self._bytes += nbytes
            self.counts["demoted"] += 1
            return True

    def _evict_one_locked(self) -> None:
        key = next(iter(self._chains))
        ent = self._chains.pop(key)
        self._bytes -= ent["nbytes"]
        self.counts["evicted"] += 1

    # -- read side -----------------------------------------------------
    def match(self, scope: Optional[str], prompt: Sequence[int],
              cap: int) -> Optional[tuple]:
        """Key of the LONGEST stored chain in ``scope`` whose tokens
        are a prefix of ``prompt`` with length <= ``cap`` (the caller
        passes its block-aligned usable bound), or None. Linear scan:
        the store holds at most a handful of system-prompt chains —
        same reasoning as ``PrefixBlockIndex.match``."""
        head = tuple(int(t) for t in prompt[:max(0, cap)])
        best: Optional[tuple] = None
        with self._lock:
            for key in self._chains:
                kscope, toks = key
                if kscope != scope:
                    continue        # another tenant's chain: invisible
                n = len(toks)
                if n > len(head) or (best is not None
                                     and n <= len(best[1])):
                    continue
                if head[:n] == toks:
                    best = key
        return best

    def get(self, key: tuple) -> Optional[dict]:
        """The entry for ``key`` (LRU refresh), or None."""
        with self._lock:
            ent = self._chains.pop(key, None)
            if ent is None:
                return None
            self._chains[key] = ent
            return ent

    def pop(self, key: tuple) -> Optional[dict]:
        """Remove and return ``key``'s entry (promotion back to the device —
        the chain lives in exactly one tier at a time)."""
        with self._lock:
            ent = self._chains.pop(key, None)
            if ent is not None:
                self._bytes -= ent["nbytes"]
            return ent

    def find(self, digest: str) -> Optional[Tuple[tuple, dict]]:
        """(key, entry) for the chain named ``digest`` (the peer-pull
        endpoint's lookup), or None."""
        with self._lock:
            for key, ent in self._chains.items():
                if ent["digest"] == digest:
                    return key, ent
        return None

    def clear(self) -> None:
        with self._lock:
            self._chains.clear()
            self._bytes = 0

    # -- introspection -------------------------------------------------
    @property
    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._chains)

    def digests(self) -> List[dict]:
        """Per-chain rows for the ``/stats`` ``prefix_index`` section
        (digest + length + bytes + scope; the caller tags the tier)."""
        with self._lock:
            return [{"digest": ent["digest"], "len": len(key[1]),
                     "nbytes": ent["nbytes"], "scope": key[0]}
                    for key, ent in self._chains.items()]

    def stats(self) -> dict:
        with self._lock:
            return {"chains": len(self._chains),
                    "bytes": self._bytes,
                    "capacity_bytes": self.capacity_bytes,
                    **self.counts}
