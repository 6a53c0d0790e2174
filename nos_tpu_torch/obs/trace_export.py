"""Perfetto / Chrome trace-event exporter: ``to_chrome_trace`` of
``nos_tpu/obs/trace_export.py``, copied for the port (the serving
binary's ``/debug/profile``; the reference's file-writing helpers serve
its benches and stay there).

Converts recorded spans into the Chrome Trace Event JSON format
(``chrome://tracing`` and https://ui.perfetto.dev both load it
directly): one "complete" (``ph: "X"``) event per span, grouped into one
process row per component, with span events as instant markers.

Timestamps: trace-event ``ts``/``dur`` are microseconds. Span stamps may
be wall-clock epoch seconds or a simulated clock's small floats; either
way the export rebases onto the earliest span so the viewer opens at
t=0 instead of 50 years into the timeline.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List

from nos_tpu_torch.obs.tracing import Span

__all__ = ["to_chrome_trace", "export_chrome_trace", "export_recorder"]


def _us(seconds: float) -> float:
    return round(seconds * 1e6, 3)


def to_chrome_trace(spans: Iterable[Span]) -> Dict[str, Any]:
    """Chrome trace-event JSON object for ``spans`` (open spans are
    skipped — they have no duration to draw)."""
    done = [sp for sp in spans if sp.end_time is not None]
    pids: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    t0 = min((sp.start for sp in done), default=0.0)
    for sp in sorted(done, key=lambda s: (s.start, s.trace_id, s.span_id)):
        pid = pids.setdefault(sp.component, len(pids) + 1)
        args = {
            "trace_id": sp.trace_id,
            "span_id": sp.span_id,
            "parent_id": sp.parent_id or "",
            "status": sp.status,
        }
        args.update({k: str(v) for k, v in sp.attrs.items()})
        if sp.status_message:
            args["status_message"] = sp.status_message
        events.append({
            "name": sp.name,
            "cat": sp.component,
            "ph": "X",
            "ts": _us(sp.start - t0),
            "dur": max(_us(sp.end_time - sp.start), 1.0),
            "pid": pid,
            # one row per trace within the component's process: the
            # pod-journey / episode reads as a lane
            "tid": int(sp.trace_id[:8], 16),
            "args": args,
        })
        for ts, name, attrs in (sp.events or ()):
            events.append({
                "name": name,
                "cat": sp.component,
                "ph": "i",
                "s": "t",            # thread-scoped instant
                "ts": _us(ts - t0),
                "pid": pid,
                "tid": int(sp.trace_id[:8], 16),
                "args": {k: str(v) for k, v in attrs.items()},
            })
    for component, pid in pids.items():
        events.append({
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "args": {"name": component},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
