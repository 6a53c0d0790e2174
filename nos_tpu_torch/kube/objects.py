"""Typed Kubernetes-style objects (a copy of the ``Node`` slice of
``nos_tpu/kube/objects.py``): the same dataclasses and field names, so
a node read over the reference's wire and written back loses nothing.
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

ResourceList = Dict[str, float]


@dataclass
class OwnerReference:
    kind: str
    name: str
    uid: str = ""
    controller: bool = False


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    uid: str = ""
    resource_version: int = 0
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    owner_references: List[OwnerReference] = field(default_factory=list)


@dataclass
class Taint:
    """Node taint (GKE TPU pools carry google.com/tpu=present:NoSchedule)."""

    key: str = ""
    value: str = ""
    effect: str = "NoSchedule"   # NoSchedule | PreferNoSchedule | NoExecute


@dataclass
class NodeCondition:
    """core/v1 NodeCondition as the lifecycle controller maintains it."""

    type: str = ""
    status: str = ""    # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition: float = 0.0


@dataclass
class NodeStatus:
    capacity: ResourceList = field(default_factory=dict)
    allocatable: ResourceList = field(default_factory=dict)
    conditions: List[NodeCondition] = field(default_factory=list)


@dataclass
class NodeSpec:
    taints: List[Taint] = field(default_factory=list)
    unschedulable: bool = False


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    KIND = "Node"


def kind_of(obj) -> str:
    k = getattr(obj, "KIND", None)
    if k is None:
        raise TypeError(f"object has no KIND: {type(obj)}")
    return k


_ATOMIC = (str, int, float, bool, type(None))


def deep_copy(obj):
    """Deep clone of an API-object graph: dataclasses of atoms, dicts,
    lists and nested dataclasses, no cycles; anything else falls back
    to ``copy.deepcopy``."""
    t = type(obj)
    if t in _ATOMIC:
        return obj
    if t is dict:
        return {k: deep_copy(v) for k, v in obj.items()}
    if t is list:
        return [deep_copy(v) for v in obj]
    if t is tuple:
        return tuple(deep_copy(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type) \
            and hasattr(obj, "__dict__"):
        new = t.__new__(t)
        dst = new.__dict__
        for k, v in obj.__dict__.items():
            dst[k] = deep_copy(v)
        return new
    return copy.deepcopy(obj)
