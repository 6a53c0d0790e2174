"""Lifecycle notices the trainer watches for (a copy of the notice part
of ``nos_tpu/lifecycle/events.py``: the annotation accessors, the
notice producers, and ``preemption_signal_controller``).

Two upstream signals reach a node object as annotations:

- **maintenance notice** — GCE publishes upcoming host maintenance on
  the instance metadata server with lead time; a node-local watcher
  stamps the window start onto the node as
  ``nos.ai/maintenance-window-start``;
- **preemption notice** — spot/preemptible VMs get an ACPI shutdown
  signal ~30s ahead; stamped as ``nos.ai/preemption-deadline``.

Timestamps in the notice annotations are WALL-CLOCK seconds
(``time.time``): the one clock every host shares, which makes
cross-host lead-time arithmetic meaningful.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from nos_tpu_torch import constants
from nos_tpu_torch.kube import predicates
from nos_tpu_torch.kube.apiserver import NotFound
from nos_tpu_torch.kube.controller import Controller, Request, Result, Watch
from nos_tpu_torch.kube.objects import Node

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Notice annotation accessors (node -> parsed signal)
# ---------------------------------------------------------------------------

def _float_annotation(node: Node, key: str) -> Optional[float]:
    raw = node.metadata.annotations.get(key)
    if raw is None:
        return None
    try:
        return float(raw)
    except ValueError:
        return None


def maintenance_start(node: Node) -> Optional[float]:
    """Start of the announced maintenance window, or None. Malformed
    values read as None (an unparseable notice must not wedge the node
    in a half-fenced state — the producer re-stamps on its next poll)."""
    return _float_annotation(node, constants.ANNOTATION_MAINTENANCE_START)


def preemption_deadline(node: Node) -> Optional[float]:
    """Spot-preemption shutdown deadline, or None."""
    return _float_annotation(node, constants.ANNOTATION_PREEMPTION_DEADLINE)


def deliver_maintenance_notice(client, node_name: str, start: float) -> None:
    """Stamp a maintenance window onto a node (what the GCE metadata
    watcher does on a real fleet; the chaos harness uses this too)."""

    def mutate(n: Node):
        n.metadata.annotations[constants.ANNOTATION_MAINTENANCE_START] = \
            repr(float(start))

    client.patch("Node", node_name, "", mutate)


def deliver_preemption_notice(client, node_name: str, deadline: float) -> None:
    """Stamp a spot-preemption deadline onto a node."""

    def mutate(n: Node):
        n.metadata.annotations[constants.ANNOTATION_PREEMPTION_DEADLINE] = \
            repr(float(deadline))

    client.patch("Node", node_name, "", mutate)


# ---------------------------------------------------------------------------
# Workload-side preemption signal (trainer integration)
# ---------------------------------------------------------------------------

def preemption_signal_controller(
    node_name: str,
    stop_event: "threading.Event",
    on_notice: Optional[Callable[[str, float], None]] = None,
    maintenance_lead_s: float = 120.0,
    clock: Callable[[], float] = time.time,
) -> Controller:
    """A controller a gang worker pod runs next to its trainer: when THIS
    pod's node receives a preemption (or imminent maintenance) notice,
    set ``stop_event`` — the very event ``train(cfg, stop_event=...)``
    already consumes to finish the in-flight step, bank a checkpoint, and
    exit inside the grace window. This closes the loop from control-plane
    notice to the trainer's SIGTERM-equivalent checkpoint banking without
    the workload polling the metadata server itself.

    A preemption notice fires immediately (spot grace is ~30s). A
    maintenance notice respects its lead time: the stop only fires once
    the window start is within ``maintenance_lead_s`` — mirroring the
    lifecycle controller's drain lead, so a notice published an hour
    ahead does not idle the slice an hour early; until then the
    controller re-checks on a delayed requeue. ``clock`` must share the
    notice producer's domain (wall clock in daemons; the sim clock in
    the harness).

    ``on_notice(kind, deadline)`` fires once per transition for logging /
    metrics."""
    fired = {"done": False}

    def fire(kind: str, deadline: float) -> None:
        fired["done"] = True
        stop_event.set()
        if on_notice is not None:
            on_notice(kind, deadline)
        logger.info("%s notice for node %s (deadline %.1f): requesting "
                    "graceful stop", kind, node_name, deadline)

    def reconcile(client, req: Request) -> Result:
        if fired["done"]:
            return Result()
        try:
            node = client.get("Node", node_name)
        except NotFound:
            # node object gone: the host is being torn down — same urgency
            fire("node-deleted", 0.0)
            return Result()
        deadline = preemption_deadline(node)
        if deadline is not None:
            fire("preemption", deadline)
            return Result()
        start = maintenance_start(node)
        if start is not None:
            remaining = start - clock()
            if remaining <= maintenance_lead_s:
                fire("maintenance", start)
                return Result()
            # not imminent: wake up when it is (capped so a withdrawn
            # notice is noticed within a lead period)
            return Result(requeue_after=min(remaining - maintenance_lead_s,
                                            maintenance_lead_s))
        return Result()

    return Controller(
        "preemption-signal",
        reconcile,
        [Watch("Node", predicate=predicates.matching_name(node_name))],
    )
