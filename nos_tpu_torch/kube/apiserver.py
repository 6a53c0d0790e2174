"""In-process Kubernetes API server double (a copy of
``nos_tpu/kube/apiserver.py`` without admission hooks and field
indexes, which the watcher never registers): typed object storage with
uid/resourceVersion bookkeeping, optimistic-concurrency updates,
functional patches, label selection and watch streams. The port's
``ApiHttpServer`` serves one for the trainer's tests and the card's
notice phase."""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from nos_tpu_torch.kube.objects import deep_copy, kind_of


class ApiError(Exception):
    pass


class NotFound(ApiError):
    pass


class AlreadyExists(ApiError):
    pass


class Conflict(ApiError):
    pass


class AdmissionDenied(ApiError):
    pass


@dataclass
class WatchEvent:
    type: str           # "ADDED" | "MODIFIED" | "DELETED"
    kind: str
    obj: object         # new object (for DELETED: last state)
    old: Optional[object] = None


class Subscription:
    """A watch stream: the server appends events; consumers pop them."""

    def __init__(self, kinds: Optional[List[str]] = None):
        self.kinds = set(kinds) if kinds else None
        self._events: deque = deque()
        self._lock = threading.Lock()

    def _push(self, ev: WatchEvent) -> None:
        if self.kinds is not None and ev.kind not in self.kinds:
            return
        with self._lock:
            self._events.append(ev)

    def pop(self) -> Optional[WatchEvent]:
        with self._lock:
            return self._events.popleft() if self._events else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


Key = Tuple[str, str]  # (namespace, name); cluster-scoped objects use ns ""


class ApiServer:
    def __init__(self, clock: Callable[[], float] = time.time):
        self._clock = clock
        self._lock = threading.RLock()
        self._store: Dict[str, Dict[Key, object]] = {}
        self._rv = itertools.count(1)
        self._uid = itertools.count(1)
        self._subs: List[Subscription] = []

    # -- watch --------------------------------------------------------------
    def subscribe(self, kinds: Optional[List[str]] = None) -> Subscription:
        sub = Subscription(kinds)
        with self._lock:
            self._subs.append(sub)
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

    def _emit(self, ev: WatchEvent) -> None:
        for sub in self._subs:
            sub._push(ev)

    # -- CRUD ---------------------------------------------------------------
    def create(self, obj) -> object:
        with self._lock:
            kind = kind_of(obj)
            obj = deep_copy(obj)
            key = (obj.metadata.namespace, obj.metadata.name)
            bucket = self._store.setdefault(kind, {})
            if key in bucket:
                raise AlreadyExists(f"{kind} {key} already exists")
            obj.metadata.uid = f"uid-{next(self._uid)}"
            obj.metadata.resource_version = next(self._rv)
            if not obj.metadata.creation_timestamp:
                obj.metadata.creation_timestamp = self._clock()
            bucket[key] = obj
            out = deep_copy(obj)
            self._emit(WatchEvent("ADDED", kind, out))
            return out

    def get(self, kind: str, name: str, namespace: str = "") -> object:
        with self._lock:
            try:
                return deep_copy(self._store[kind][(namespace, name)])
            except KeyError:
                raise NotFound(f"{kind} {namespace}/{name} not found") from None

    def try_get(self, kind: str, name: str,
                namespace: str = "") -> Optional[object]:
        try:
            return self.get(kind, name, namespace)
        except NotFound:
            return None

    def list(self, kind: str, namespace: Optional[str] = None,
             label_selector: Optional[Dict[str, str]] = None,
             index: Optional[Tuple[str, str]] = None) -> List[object]:
        """List objects; ``index`` is the reference's field-index filter,
        which this server has none of."""
        if index is not None:
            raise ApiError(f"no index {index[0]!r} registered for {kind}")
        with self._lock:
            out = []
            for (ns, _name), obj in self._store.get(kind, {}).items():
                if namespace is not None and ns != namespace:
                    continue
                if label_selector and any(
                    obj.metadata.labels.get(k) != v
                    for k, v in label_selector.items()
                ):
                    continue
                out.append(deep_copy(obj))
            out.sort(key=lambda o: (o.metadata.namespace, o.metadata.name))
            return out

    def update(self, obj, *, check_version: bool = True) -> object:
        with self._lock:
            kind = kind_of(obj)
            key = (obj.metadata.namespace, obj.metadata.name)
            bucket = self._store.setdefault(kind, {})
            if key not in bucket:
                raise NotFound(f"{kind} {key} not found")
            current = bucket[key]
            if check_version and obj.metadata.resource_version \
                    != current.metadata.resource_version:
                raise Conflict(
                    f"{kind} {key}: resourceVersion "
                    f"{obj.metadata.resource_version} != "
                    f"{current.metadata.resource_version}")
            obj = deep_copy(obj)
            obj.metadata.uid = current.metadata.uid
            obj.metadata.creation_timestamp = \
                current.metadata.creation_timestamp
            # no-op updates keep the resourceVersion and emit no event
            obj.metadata.resource_version = current.metadata.resource_version
            if obj == current:
                return deep_copy(current)
            obj.metadata.resource_version = next(self._rv)
            bucket[key] = obj
            out = deep_copy(obj)
            self._emit(WatchEvent("MODIFIED", kind, out, current))
            return out

    def patch(self, kind: str, name: str, namespace: str,
              mutate: Callable[[object], None]) -> object:
        """Atomic read-modify-write (a merge PATCH's equivalent)."""
        with self._lock:
            obj = self.get(kind, name, namespace)   # private copy
            rv = obj.metadata.resource_version
            mutate(obj)
            # the mutate fn must not fabricate optimistic-concurrency wins
            obj.metadata.resource_version = rv
            return self.update(obj)

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        with self._lock:
            key = (namespace, name)
            bucket = self._store.get(kind, {})
            if key not in bucket:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            obj = deep_copy(bucket.pop(key))
            self._emit(WatchEvent("DELETED", kind, obj))
