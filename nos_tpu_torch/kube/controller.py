"""Controller runtime: level-triggered reconcilers over watch streams (a
copy of ``nos_tpu/kube/controller.py`` without leader election, which
a per-pod watcher does not run). Semantics kept:

- watch events pass predicates, map to reconcile ``Request``s, and land
  in a de-duplicating work-queue;
- reconcilers are level-triggered: they read current state from the
  client, never from the event;
- a reconcile returning ``Result(requeue=True)`` or raising re-queues
  the request with exponential backoff;
- ``Result(requeue_after=s)`` schedules a delayed requeue and takes
  precedence over ``requeue``;
- adding a controller seeds its queue from an initial LIST of each
  watched kind (informer initial-sync).

``run_until_idle`` pumps events and queues deterministically for
tests; the trainer runs ``run`` on a daemon thread.
"""
from __future__ import annotations

import heapq
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from nos_tpu_torch.kube.apiserver import WatchEvent
from nos_tpu_torch.kube.client import Client

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class Request:
    name: str
    namespace: str = ""


@dataclass
class Result:
    requeue: bool = False
    requeue_after: Optional[float] = None


Reconciler = Callable[[Client, Request], Optional[Result]]
Predicate = Callable[[WatchEvent], bool]
RequestMapper = Callable[[WatchEvent], List[Request]]


def _default_mapper(ev: WatchEvent) -> List[Request]:
    return [Request(name=ev.obj.metadata.name,
                    namespace=ev.obj.metadata.namespace)]


@dataclass
class Watch:
    kind: str
    predicate: Optional[Predicate] = None
    mapper: RequestMapper = field(default=_default_mapper)


class Controller:
    BACKOFF_BASE_S = 0.005
    BACKOFF_MAX_S = 30.0

    def __init__(self, name: str, reconciler: Reconciler,
                 watches: List[Watch]):
        self.name = name
        self.reconciler = reconciler
        self.watches: Dict[str, List[Watch]] = {}
        for w in watches:
            self.watches.setdefault(w.kind, []).append(w)
        self._queue: List[Request] = []
        self._queued: set = set()
        self._retries: Dict[Request, int] = {}
        # heap by due-time
        self._delayed: List[Tuple[float, int, Request]] = []
        self._seq = 0
        self._lock = threading.Lock()

    # -- queue --------------------------------------------------------------
    def enqueue(self, req: Request) -> None:
        with self._lock:
            if req not in self._queued:
                self._queued.add(req)
                self._queue.append(req)

    def enqueue_after(self, req: Request, delay_s: float, now: float) -> None:
        with self._lock:
            self._seq += 1
            heapq.heappush(self._delayed, (now + delay_s, self._seq, req))

    def _promote_due(self, now: float) -> None:
        with self._lock:
            while self._delayed and self._delayed[0][0] <= now:
                _, _, req = heapq.heappop(self._delayed)
                if req not in self._queued:
                    self._queued.add(req)
                    self._queue.append(req)

    def _pop(self) -> Optional[Request]:
        with self._lock:
            if not self._queue:
                return None
            req = self._queue.pop(0)
            self._queued.discard(req)
            return req

    def offer(self, ev: WatchEvent) -> None:
        for watch in self.watches.get(ev.kind, []):
            if watch.predicate is not None and not watch.predicate(ev):
                continue
            for req in watch.mapper(ev):
                self.enqueue(req)

    # -- processing ---------------------------------------------------------
    def process_one(self, client: Client, now: float) -> bool:
        """Process a single queued request. Returns True if work was done."""
        self._promote_due(now)
        req = self._pop()
        if req is None:
            return False
        try:
            result = self.reconciler(client, req) or Result()
        except Exception:
            logger.exception("[%s] reconcile %s failed", self.name, req)
            result = Result(requeue=True)
        if result.requeue_after is not None:
            self._retries.pop(req, None)
            self.enqueue_after(req, result.requeue_after, now)
        elif result.requeue:
            retries = self._retries.get(req, 0) + 1
            self._retries[req] = retries
            delay = min(self.BACKOFF_BASE_S * (2 ** (retries - 1)),
                        self.BACKOFF_MAX_S)
            self.enqueue_after(req, delay, now)
        else:
            self._retries.pop(req, None)
        return True

    def next_due(self) -> Optional[float]:
        with self._lock:
            return self._delayed[0][0] if self._delayed else None


class Manager:
    """Hosts controllers against one API server (in-process, or a
    ``RemoteApiServer``)."""

    def __init__(self, server, clock: Callable[[], float] = time.monotonic):
        self.server = server
        self.client = Client(server)
        self.clock = clock
        self.controllers: List[Controller] = []
        self._sub = server.subscribe()
        self._stop = threading.Event()
        self._running = False

    def add_controller(self, controller: Controller) -> Controller:
        self.controllers.append(controller)
        # initial sync: pre-existing objects are reconciled
        for kind in controller.watches:
            for obj in self.server.list(kind):
                controller.offer(WatchEvent("ADDED", kind, obj))
        return controller

    # -- pumping ------------------------------------------------------------
    def _dispatch_events(self) -> int:
        n = 0
        while True:
            ev = self._sub.pop()
            if ev is None:
                return n
            n += 1
            for c in self.controllers:
                c.offer(ev)

    def run_until_idle(self, max_iterations: int = 10_000,
                       advance_delayed: bool = False) -> int:
        """Pump events and queues until nothing is runnable;
        ``advance_delayed`` also fast-forwards delayed requeues (tests).
        Returns the number of reconciles executed."""
        done = 0
        while True:
            progressed = self._dispatch_events() > 0
            now = self.clock()
            if advance_delayed:
                for c in self.controllers:
                    due = c.next_due()
                    if due is not None:
                        now = max(now, due)
            for c in self.controllers:
                while c.process_one(self.client, now):
                    done += 1
                    if done > max_iterations:
                        raise RuntimeError(
                            "run_until_idle did not converge (reconcile "
                            "livelock?)")
                    progressed = True
                    self._dispatch_events()
            if not progressed:
                return done

    def run(self, poll_interval_s: float = 0.05) -> None:
        """Daemon loop: until ``stop``, which closes the watch stream
        when the loop ends (closed under a running loop, the stream's
        next poll would fail on the thread)."""
        self._running = True
        try:
            while not self._stop.is_set():
                self._dispatch_events()
                now = self.clock()
                worked = False
                for c in self.controllers:
                    worked = c.process_one(self.client, now) or worked
                if not worked:
                    self._stop.wait(poll_interval_s)
        finally:
            self._running = False
            try:
                self.server.unsubscribe(self._sub)
            except Exception:   # an API server gone first: nothing to close
                logger.debug("closing the watch stream failed",
                             exc_info=True)

    def stop(self) -> None:
        self._stop.set()
        if not self._running:
            self.server.unsubscribe(self._sub)
