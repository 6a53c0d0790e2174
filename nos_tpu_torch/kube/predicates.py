"""Watch-event predicates (the ``matching_name`` of
``nos_tpu/kube/predicates.py``: the notice watcher sees only its own
node's events)."""
from __future__ import annotations

from typing import Callable

from nos_tpu_torch.kube.apiserver import WatchEvent

Predicate = Callable[[WatchEvent], bool]


def matching_name(name: str) -> Predicate:
    def pred(ev: WatchEvent) -> bool:
        return ev.obj.metadata.name == name
    return pred
