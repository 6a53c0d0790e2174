"""KV-fabric chain identity and wire format (a copy of
``nos_tpu/kvfabric/codec.py`` for the port; torch-free).

A fabric *chain* is one prefix-cache entry in transit: the scope +
token content that key it (``PrefixBlockIndex`` chains are keyed
``(scope, tokens)``) plus the swap payload of its KV blocks — the
``_swap_payload`` schema (``nblk`` + k/v planes, per-block scale
planes under int8) that preemption, supervised restart and the
prefill→decode handoff already move byte-exactly. Reusing the
``models/handoff.py`` codec verbatim means the fabric inherits its
properties: deterministic bytes for a deterministic chain, equal to the
reference's, and bit-exact adoption through the engine's restore
scatter. A bf16 chain's planes are uint16 bits named by
``swap["dtype"] = "bfloat16"``, as in every port payload.

``chain_digest`` is the chain's fleet-wide name: blake2b-16 over the
scope and the token content, mirroring the gateway's affinity
``prefix_key`` arithmetic (``scope + \\x00 + comma-joined tokens``).
The scope is INSIDE the hash on purpose — two tenants publishing the
same system prompt get different digests, so no lookup table anywhere
in the fleet can alias one tenant's chain to another's, even before
the ingest path's explicit scope check.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional, Sequence

import numpy as np

from nos_tpu_torch.models.handoff import (
    decode_handoff, encode_handoff, handoff_nbytes,
)

__all__ = ["FABRIC_TOKEN_HEADER", "chain_digest", "chain_nbytes",
           "decode_chain", "encode_chain"]

# The fleet-internal trust marker for the fabric's HTTP surfaces: the
# gateway stamps it on dispatches carrying ``kv_sources`` offers, and
# replicas require it both to HONOR an offer (kv_sources steers the
# replica's outbound fetcher and seeds its prefix cache — a client-
# supplied offer would be blind SSRF plus cache poisoning) and to
# SERVE ``GET /v1/kvchain/<digest>`` (digests are public arithmetic
# over scope + tokens, so an open export would hand any client another
# tenant's KV bytes and a cache-residency oracle). The value is the
# shared ``--kv-fabric-token`` secret.
FABRIC_TOKEN_HEADER = "X-NOS-KV-Fabric-Token"


def chain_digest(tokens: Sequence[int], scope: Optional[str] = None) -> str:
    """The chain's fleet-wide identity: blake2b-16 over scope + token
    content — the same construction as ``ring.prefix_key`` so the two
    surfaces cannot drift, but over the FULL chain (a digest names one
    exact chain, not an affinity bucket)."""
    toks = b",".join(str(int(t)).encode() for t in tokens)
    if scope is not None:
        toks = scope.encode() + b"\x00" + toks
    return hashlib.blake2b(toks, digest_size=16).hexdigest()


def chain_nbytes(swap: Dict[str, np.ndarray]) -> int:
    """Structural size of one chain payload: the swap arrays' bytes
    (KV planes + int8 scale planes), independent of wire framing —
    the unit ``HostTierStore``'s capacity bound is charged in."""
    return handoff_nbytes({"swap": swap})


def encode_chain(scope: Optional[str], tokens: Sequence[int],
                 swap: Dict[str, np.ndarray]) -> bytes:
    """Serialize one chain for the host tier's disk-shape or the
    ``GET /v1/kvchain/<digest>`` peer-pull hop. Deterministic bytes
    (uncompressed ``np.savez``, sorted meta) — the bench pins
    byte-identical reruns on this."""
    return encode_handoff({
        "fabric": 1,
        "scope": scope,
        "tokens": [int(t) for t in tokens],
        "swap": dict(swap),
    })


def decode_chain(data: bytes) -> dict:
    """Inverse of ``encode_chain``. Raises ``ValueError`` on anything
    that is not a fabric chain payload (a handoff state, junk bytes) —
    the ingest path treats that as a rejected pull, never a crash."""
    try:
        state = decode_handoff(data)
    except Exception as exc:
        raise ValueError(f"not a KV-fabric chain payload: {exc}") from exc
    if state.get("fabric") != 1 or "swap" not in state \
            or not isinstance(state.get("tokens"), list):
        raise ValueError("not a KV-fabric chain payload")
    return state
