"""Prefill→decode KV-handoff wire format (a copy of
``nos_tpu/models/handoff.py`` for the port; torch-free as well).

A handoff state is the resumable request description the serving
engine's preemption/restart machinery produces
(``DecodeServer._request_state`` + the ``_swap_payload`` KV snapshot:
quantized blocks plus their per-block scale planes under int8 — which
is why int8 arenas ship roughly half the bytes per request). This
module turns that dict into bytes and back for the POST /v1/handoff
hop between a prefill-role and a decode-role server, plus the
structural byte model the ``nos_tpu_serve_handoff_bytes`` histogram
reports.

Format: one uncompressed ``np.savez`` archive — deterministic bytes for
a deterministic state — holding the swap arrays under fixed keys and
the jsonable metadata as one UTF-8 plane. The bytes equal the
reference's for an equal state, so either framework adopts the other's
handoffs.

numpy has no bfloat16 of its own (the reference's engine swaps out
``ml_dtypes.bfloat16`` arrays, a package the port does not use). The
port carries a bf16 plane as its raw bits, a ``uint16`` array, with
``swap["dtype"] = "bfloat16"`` beside it; on the wire the plane is the
same bytes under the same dtype name, ``"bfloat16"``.
"""
from __future__ import annotations

import io
import json
from typing import Dict

import numpy as np

__all__ = ["encode_handoff", "decode_handoff", "handoff_nbytes",
           "plane_dtype", "plane_bits", "settle", "BF16", "READY"]

#: the swap-payload array planes, in serialization order
_ARRAY_KEYS = ("k", "v", "k_scale", "v_scale")

#: the wire name of a bfloat16 plane
BF16 = "bfloat16"

#: the key under which a payload whose host copy is still in progress
#: carries the ``threading.Event`` that copy sets (the engine's pinned
#: staging finishes it off the serving path), until ``settle``
READY = "_ready"


def settle(swap: dict) -> None:
    """Wait until a payload's planes are on the host, raise the error
    their copy met, if any, and drop the event, leaving the payload's
    own keys: every host read of a payload's bytes comes after this."""
    ready = swap.get(READY)
    if ready is not None:
        ready.wait()
        error = getattr(ready, "error", None)
        if error is not None:
            raise RuntimeError(
                f"KV payload copy to the host failed: {error}") from error
        swap.pop(READY, None)


def plane_dtype(swap: dict, key: str) -> str:
    """The dtype name of one payload plane as the wire writes it: a
    ``uint16`` K/V plane under ``swap["dtype"] == "bfloat16"`` is bf16
    bits; an ``ml_dtypes`` array (a reference engine's payload) names
    itself."""
    name = str(np.asarray(swap[key]).dtype)
    if key in ("k", "v") and name == "uint16" and swap.get("dtype") == BF16:
        return BF16
    return name


def plane_bits(arr) -> np.ndarray:
    """A plane as a numpy array of a dtype numpy knows: bf16 (an
    ``ml_dtypes`` array) as its uint16 bits, anything else as it is."""
    arr = np.asarray(arr)
    return arr.view(np.uint16) if str(arr.dtype) == BF16 else arr


def handoff_nbytes(state: dict) -> int:
    """Structural payload size of one handoff state: the swap arrays'
    bytes (KV planes + int8 scale planes) — array bytes, not wire
    framing, so it is independent of the transport."""
    swap = state.get("swap") or {}
    return sum(int(swap[k].nbytes) for k in _ARRAY_KEYS if k in swap)


def encode_handoff(state: dict) -> bytes:
    """Serialize one handoff state for the wire. ``state`` is the
    ``capture_resumable``/``pop_handoffs`` schema: jsonable fields plus
    a ``swap`` dict of numpy arrays. Arrays travel as raw bytes with
    (shape, dtype-name) metadata, byte-deterministic for every dtype."""
    swap = dict(state.get("swap") or {})
    settle(swap)
    meta = {k: v for k, v in state.items() if k != "swap"}
    meta["swap_nblk"] = int(swap.get("nblk", 0))
    planes = {}
    arrays: Dict[str, np.ndarray] = {}
    for key in _ARRAY_KEYS:
        if key in swap:
            arr = plane_bits(swap[key])
            planes[key] = {"shape": list(arr.shape),
                           "dtype": plane_dtype(swap, key)}
            # the plane's own bytes, without a copy when it is contiguous
            arrays[key] = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    meta["planes"] = planes
    arrays["meta"] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def decode_handoff(data: bytes) -> dict:
    """Inverse of ``encode_handoff``: bytes -> the state dict
    ``DecodeServer.restore`` adopts bit-exactly (bf16 planes as their
    uint16 bits, named by ``swap["dtype"]``)."""
    with np.load(io.BytesIO(data)) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        raw = {k: z[k] for k in _ARRAY_KEYS if k in z.files}
    state = dict(meta)
    planes = state.pop("planes", {})
    nblk = state.pop("swap_nblk", 0)
    if raw:
        swap = {}
        for key, buf in raw.items():
            spec = planes[key]
            if spec["dtype"] == BF16:
                dtype = np.dtype(np.uint16)
                swap["dtype"] = BF16
            else:
                dtype = np.dtype(spec["dtype"])
            swap[key] = np.ascontiguousarray(buf).view(dtype).reshape(
                spec["shape"])
        swap["nblk"] = int(nblk)
        state["swap"] = swap
    return state
