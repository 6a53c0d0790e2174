"""Client facade over the API server (a copy of
``nos_tpu/kube/client.py``): controllers are written against it, and
both the in-process ``ApiServer`` and ``httpapi.RemoteApiServer`` sit
behind it."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple


class Client:
    def __init__(self, server):
        self.server = server

    def create(self, obj):
        return self.server.create(obj)

    def get(self, kind: str, name: str, namespace: str = ""):
        return self.server.get(kind, name, namespace)

    def try_get(self, kind: str, name: str, namespace: str = ""):
        return self.server.try_get(kind, name, namespace)

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[Dict[str, str]] = None,
             index: Optional[Tuple[str, str]] = None) -> List[object]:
        return self.server.list(kind, namespace, label_selector, index)

    def update(self, obj):
        return self.server.update(obj)

    def patch(self, kind: str, name: str, namespace: str,
              mutate: Callable[[object], None]):
        return self.server.patch(kind, name, namespace, mutate)

    def delete(self, kind: str, name: str, namespace: str = ""):
        return self.server.delete(kind, name, namespace)
