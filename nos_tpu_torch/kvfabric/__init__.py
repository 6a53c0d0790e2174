"""The KV fabric (a copy of ``nos_tpu/kvfabric/`` for the port;
torch-free): tiered prefix caching under and across serving replicas.

- ``codec``    — a prefix chain's fleet-wide identity (``chain_digest``
  over its scope + token content) and its wire payload
  (``encode_chain``/``decode_chain`` over the ``models/handoff.py``
  swap codec, whose bytes equal the reference's);
- ``hosttier`` — ``HostTierStore``: the bounded host-RAM tier under a
  replica's device arena. Prefix-chain eviction under block pressure
  DEMOTES the LRU chain's bytes (and int8 scale planes) here instead of
  dropping them; a later prefix miss that hits the store PROMOTES the
  chain back through the engine's restore scatter, bit-exact.

The gateway's fleet index (``FleetPrefixIndex``) belongs to the control
plane and is not copied: it reads a replica's ``/stats``
``prefix_index`` section, which the port's engine publishes in the
reference's shape.

Tenant scoping holds end to end: chains are keyed ``(scope, tokens)``,
the digest embeds the scope, and the ingest path re-derives the
requester's scope before a pulled chain enters a cache. A replica
honors a ``kv_sources`` offer, and serves ``GET /v1/kvchain/<digest>``,
only with the fleet's shared ``--kv-fabric-token`` secret in
``FABRIC_TOKEN_HEADER``.
"""
from nos_tpu_torch.kvfabric.codec import (
    FABRIC_TOKEN_HEADER, chain_digest, chain_nbytes, decode_chain,
    encode_chain,
)
from nos_tpu_torch.kvfabric.hosttier import HostTierStore

__all__ = [
    "FABRIC_TOKEN_HEADER", "HostTierStore", "chain_digest",
    "chain_nbytes", "decode_chain", "encode_chain",
]
