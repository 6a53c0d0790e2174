"""Wire (de)serialization for API objects (a copy of
``nos_tpu/kube/serial.py`` over the kinds the port carries): a
dataclass to a plain dict with its ``kind``, and back from type hints.
The dicts are the reference's, so its ``ApiHttpServer`` and the port's
client read each other."""
from __future__ import annotations

import dataclasses
from typing import (
    Dict, List, Union, get_args, get_origin, get_type_hints,
)

from nos_tpu_torch.kube.objects import Node, kind_of

KINDS: Dict[str, type] = {c.KIND: c for c in (Node,)}


def to_wire(obj) -> dict:
    d = dataclasses.asdict(obj)
    d["kind"] = kind_of(obj)
    return d


def _coerce(tp, val):
    if val is None:
        return None
    origin = get_origin(tp)
    if origin is Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        return _coerce(args[0], val) if args else val
    if origin in (list, List):
        (item_tp,) = get_args(tp) or (None,)
        return [_coerce(item_tp, v) for v in val]
    if origin in (dict, Dict):
        args = get_args(tp)
        val_tp = args[1] if len(args) == 2 else None
        return {k: _coerce(val_tp, v) for k, v in val.items()}
    if dataclasses.is_dataclass(tp):
        return _from_dict(tp, val)
    return val


def _from_dict(cls: type, data: dict):
    hints = get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = _coerce(hints[f.name], data[f.name])
    return cls(**kwargs)


def from_wire(data: dict):
    kind = data.get("kind")
    cls = KINDS.get(kind or "")
    if cls is None:
        raise ValueError(f"unknown kind {kind!r}")
    body = {k: v for k, v in data.items() if k != "kind"}
    return _from_dict(cls, body)
