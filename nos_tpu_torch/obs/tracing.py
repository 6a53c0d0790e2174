"""Zero-dependency distributed tracing (a copy of
``nos_tpu/obs/tracing.py`` for the port, without the pod-annotation
helpers, which belong to the control plane; the span counter
``nos_trace_spans_total`` registers on the port's own metrics registry).

The reference's description follows.

Zero-dependency distributed tracing for the nos-tpu control plane.

Dapper-style (Sigelman et al., 2010) tracing modeled on OpenTelemetry
semantics, but with no external dependency and a cost profile cheap
enough to leave on in production: one trace per *pod journey*, spans for
each control-plane phase the pod passes through (quota admission,
scheduler attempt, gang/JobSet domain search, partitioner plan+actuate,
tpuagent apply, lifecycle eviction -> rebind), and a bounded in-memory
flight recorder of recently completed traces served at ``/debug/traces``
next to ``/metrics`` (nos_tpu/cmd/serve.py).

Cross-process propagation rides a pod annotation
(``nos-tpu/trace-context``, W3C ``traceparent`` syntax) stamped at quota
admission by the scheduler — the first component to touch a pending pod.
Every later component (partitioner, tpuagent, lifecycle) parents its
spans on the annotation's context, and the lifecycle controller's
evict-and-recreate preserves annotations, so a chaos rebind lands in the
SAME trace as the original placement.

Design constraints honored here:

- **hot-path cost**: an unsampled/disabled span is a shared no-op
  singleton (no allocation); a sampled span is one small object + two
  clock reads. No locks on the span itself — a span is owned by one
  attempt.
- **bounded memory**: the flight recorder is a ring of traces
  (``max_traces``) with per-trace span caps; slow/error traces are
  *pinned* so the interesting evidence survives a busy ring (bounded
  pinned set, FIFO demotion).
- **deterministic clocks**: every span accepts explicit
  ``start_time``/``end_time`` so the lifecycle controller and chaos
  harness can stamp simulated-clock instants; the tracer's own clock is
  swappable (``set_clock``) for whole-process simulated time.
"""
from __future__ import annotations

import os
import random
import threading
from collections import OrderedDict
from contextvars import ContextVar
from dataclasses import dataclass
from functools import wraps
from time import time as _wall
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "Span",
    "SpanContext",
    "Tracer",
    "FlightRecorder",
    "tracer",
    "recorder",
    "configure",
    "set_clock",
    "span",
    "start_span",
    "current",
    "traced",
    "device_range",
    "enable_device_ranges",
    "NOOP_RANGE",
]

# dedicated RNG: trace/span ids must not perturb (or be perturbed by)
# seeded simulation RNGs like the chaos harness's random.Random(seed)
_ids = random.Random()

_W3C_VERSION = "00"
_W3C_FLAGS = "01"


def _new_trace_id() -> str:
    return f"{_ids.getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{_ids.getrandbits(64):016x}"


@dataclass(frozen=True)
class SpanContext:
    """The portable identity of a span: what crosses process boundaries."""

    trace_id: str
    span_id: str

    def encode(self) -> str:
        """W3C ``traceparent`` syntax: ``00-<trace>-<span>-01``."""
        return f"{_W3C_VERSION}-{self.trace_id}-{self.span_id}-{_W3C_FLAGS}"

    @staticmethod
    def decode(value: Optional[str]) -> Optional["SpanContext"]:
        """Tolerant parse — ``None`` on anything malformed (a bad
        annotation must never break scheduling)."""
        if not value:
            return None
        parts = value.split("-")
        if len(parts) != 4:
            return None
        _, trace_id, span_id, _ = parts
        if len(trace_id) != 32 or len(span_id) != 16:
            return None
        try:
            int(trace_id, 16)
            int(span_id, 16)
        except ValueError:
            return None
        return SpanContext(trace_id=trace_id, span_id=span_id)


class Span:
    """One timed operation. Not thread-safe by design — a span belongs to
    the single attempt that created it."""

    __slots__ = ("name", "component", "trace_id", "span_id", "parent_id",
                 "start", "end_time", "attrs", "events", "status",
                 "status_message", "_tracer")

    def __init__(self, name: str, component: str, trace_id: str,
                 span_id: str, parent_id: Optional[str], start: float,
                 attrs: Optional[Dict[str, Any]] = None,
                 _tracer: Optional["Tracer"] = None):
        self.name = name
        self.component = component
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end_time: Optional[float] = None
        # callers pass a fresh literal dict (or None); adopting it
        # avoids one dict copy per span on the hot path
        self.attrs: Dict[str, Any] = attrs if attrs is not None else {}
        # lazily allocated: most spans carry no events
        self.events: Optional[List[tuple]] = None
        self.status = "ok"
        self.status_message = ""
        self._tracer = _tracer

    # -- recording ------------------------------------------------------
    @property
    def recording(self) -> bool:
        return True

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attr(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def add_event(self, name: str, ts: Optional[float] = None,
                  **attrs: Any) -> "Span":
        if ts is None:
            ts = self._tracer.clock() if self._tracer else _wall()
        if self.events is None:
            self.events = []
        self.events.append((ts, name, attrs))
        return self

    def set_error(self, message: str = "") -> "Span":
        self.status = "error"
        self.status_message = message
        return self

    def end(self, end_time: Optional[float] = None) -> None:
        """Idempotent: the first end wins (the lifecycle controller and
        the chaos harness may both try to close an episode root)."""
        if self.end_time is not None:
            return
        self.end_time = (end_time if end_time is not None
                         else (self._tracer.clock() if self._tracer
                               else _wall()))
        if self._tracer is not None:
            self._tracer._on_end(self)

    @property
    def duration(self) -> Optional[float]:
        if self.end_time is None:
            return None
        return self.end_time - self.start

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "component": self.component,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "end": self.end_time,
            "duration_s": self.duration,
            "status": self.status,
            "status_message": self.status_message,
            "attrs": self.attrs,
            "events": [
                {"ts": ts, "name": n, "attrs": a}
                for ts, n, a in (self.events or ())
            ],
        }

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r} component={self.component} "
                f"trace={self.trace_id[:8]} span={self.span_id[:8]})")


class _NoopSpan:
    """Shared do-nothing span for unsampled/disabled tracing. All methods
    are no-ops; ``context`` is None so propagation never stamps ids that
    lead nowhere."""

    __slots__ = ()

    recording = False
    context = None
    trace_id = ""
    span_id = ""
    parent_id = None
    duration = None
    status = "ok"

    def set_attr(self, key, value):
        return self

    def add_event(self, name, ts=None, **attrs):
        return self

    def set_error(self, message=""):
        return self

    def end(self, end_time=None):
        pass


NOOP_SPAN = _NoopSpan()

# process-wide "current span" (contextvars: correct across threads and
# any future async use; ~100ns per get/set)
_current: ContextVar[Optional[Span]] = ContextVar("nos_tpu_span",
                                                 default=None)


class _SpanScope:
    """``with tracer.span(...) as sp`` — sets the context-local current
    span on enter (the noop sentinel included: children of an unsampled
    root must inherit the not-sampled decision rather than re-rolling
    sampling as fresh roots), marks error status on exception, ends the
    span on exit."""

    __slots__ = ("span", "_token")

    def __init__(self, span):
        self.span = span

    def __enter__(self):
        self._token = _current.set(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb):
        _current.reset(self._token)
        if exc is not None:
            self.span.set_error(f"{exc_type.__name__}: {exc}")
        self.span.end()
        return False


class FlightRecorder:
    """Bounded in-memory ring of recently *completed* spans, grouped by
    trace. Slow and error traces are pinned so they survive ring churn;
    the pinned set is itself bounded (oldest pinned demotes back to the
    ring). Served as JSON at ``/debug/traces``."""

    def __init__(self, max_traces: int = 256,
                 max_spans_per_trace: int = 512,
                 slow_threshold_s: float = 1.0,
                 max_pinned: int = 64):
        self.max_traces = max_traces
        self.max_spans_per_trace = max_spans_per_trace
        self.slow_threshold_s = slow_threshold_s
        self.max_pinned = max_pinned
        self._lock = threading.Lock()
        # trace_id -> list[Span]; OrderedDict recency = last span end
        self._traces: "OrderedDict[str, List[Span]]" = OrderedDict()
        self._pinned: "OrderedDict[str, str]" = OrderedDict()  # id -> why
        self._dropped_spans = 0
        self._evicted_traces = 0

    # -- ingest ---------------------------------------------------------
    def record(self, sp: Span) -> None:
        # hot path: called once per completed span; the common case is
        # one lock, two dict ops and a float compare
        with self._lock:
            traces = self._traces
            spans = traces.get(sp.trace_id)
            new = spans is None
            if new:
                traces[sp.trace_id] = [sp]
            else:
                traces.move_to_end(sp.trace_id)
                if len(spans) >= self.max_spans_per_trace:
                    self._dropped_spans += 1
                else:
                    spans.append(sp)
            # pin BEFORE evicting: a slow/error span must protect its
            # own trace even when it is the one that filled the ring
            if sp.status == "error":
                self._pin(sp.trace_id, "error")
            elif sp.end_time - sp.start >= self.slow_threshold_s:
                self._pin(sp.trace_id, "slow")
            if new:
                while len(traces) > self.max_traces:
                    self._evict_one()

    def pin(self, trace_id: str, why: str = "manual") -> None:
        """Public pin: protect ``trace_id`` from ring churn for reasons
        the recorder cannot infer from span timing alone — the serving
        loop pins SLO-breaching request traces so the evidence behind a
        breached ``nos_tpu_serve_slo_total`` increment survives to be
        read at ``/debug/traces``. Subject to the same bounded-pinned-set
        FIFO demotion as slow/error pins."""
        with self._lock:
            self._pin(trace_id, why)

    def _pin(self, trace_id: str, why: str) -> None:
        if trace_id in self._pinned:
            self._pinned.move_to_end(trace_id)
            return
        self._pinned[trace_id] = why
        while len(self._pinned) > self.max_pinned:
            self._pinned.popitem(last=False)   # demote oldest pin

    def _evict_one(self) -> None:
        for tid in self._traces:
            if tid not in self._pinned:
                del self._traces[tid]
                self._evicted_traces += 1
                return
        # everything is pinned: demote the oldest pin
        tid, _ = self._pinned.popitem(last=False)
        self._traces.pop(tid, None)
        self._evicted_traces += 1

    # -- read -----------------------------------------------------------
    def trace(self, trace_id: str) -> List[Span]:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def spans(self) -> List[Span]:
        with self._lock:
            return [sp for spans in self._traces.values() for sp in spans]

    def pinned(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._pinned)

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            traces = [
                {
                    "trace_id": tid,
                    "pinned": self._pinned.get(tid),
                    "components": sorted({sp.component for sp in spans}),
                    "spans": [sp.to_dict() for sp in spans],
                }
                for tid, spans in self._traces.items()
            ]
            return {
                "traces": traces,
                "trace_count": len(traces),
                "dropped_spans": self._dropped_spans,
                "evicted_traces": self._evicted_traces,
                "max_traces": self.max_traces,
                "slow_threshold_s": self.slow_threshold_s,
            }

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self._pinned.clear()
            self._dropped_spans = 0
            self._evicted_traces = 0


class Tracer:
    """Creates spans, applies head sampling at trace roots, and feeds
    completed spans to the flight recorder."""

    def __init__(self, recorder: Optional[FlightRecorder] = None,
                 sampling: float = 1.0, enabled: bool = True,
                 clock: Callable[[], float] = _wall):
        self.recorder = recorder
        self.sampling = sampling
        self.enabled = enabled
        self.clock = clock
        self._sampler = random.Random()

    # -- span factory ---------------------------------------------------
    def start_span(self, name: str, component: str = "nos-tpu",
                   parent: Optional[object] = None,
                   attrs: Optional[Dict[str, Any]] = None,
                   start_time: Optional[float] = None):
        """``parent`` may be a Span, a SpanContext, an encoded
        traceparent string, or None (a new root, subject to sampling).
        Falls back to the context-local current span when None."""
        if not self.enabled:
            return NOOP_SPAN
        if parent is None:
            # hot path: inherit the context-local current span
            parent = _current.get()
            if parent is None:
                # head sampling: decided once, at the trace root
                if self.sampling < 1.0 \
                        and self._sampler.random() >= self.sampling:
                    return NOOP_SPAN
                trace_id, parent_id = _new_trace_id(), None
            elif parent.__class__ is Span:
                trace_id, parent_id = parent.trace_id, parent.span_id
            else:       # noop sentinel: inherit the not-sampled decision
                return NOOP_SPAN
        else:
            if isinstance(parent, _NoopSpan):
                return NOOP_SPAN
            if isinstance(parent, str):
                parent = SpanContext.decode(parent)
                if parent is None:
                    trace_id, parent_id = _new_trace_id(), None
                else:
                    trace_id, parent_id = parent.trace_id, parent.span_id
            else:   # Span or SpanContext
                trace_id, parent_id = parent.trace_id, parent.span_id
        return Span(
            name=name, component=component, trace_id=trace_id,
            span_id=_new_span_id(), parent_id=parent_id,
            start=start_time if start_time is not None else self.clock(),
            attrs=attrs, _tracer=self,
        )

    def span(self, name: str, component: str = "nos-tpu",
             parent: Optional[object] = None,
             attrs: Optional[Dict[str, Any]] = None) -> "_SpanScope":
        """Context manager: hand-rolled (not @contextmanager) — this is
        the hot-path entry and a generator-based CM costs ~3x more per
        use than a __slots__ object."""
        return _SpanScope(
            self.start_span(name, component, parent=parent, attrs=attrs))

    def current(self) -> Optional[Span]:
        sp = _current.get()
        return sp if isinstance(sp, Span) else None

    def _on_end(self, sp: Span) -> None:
        if self.recorder is not None:
            self.recorder.record(sp)
        _metrics_on_span_end(sp)

    def set_clock(self, clock: Callable[[], float]) -> None:
        """Swap the time source (the chaos harness points this at its
        simulated clock so every span in the episode shares one
        timeline). Spans created before the swap keep their stamps."""
        self.clock = clock


# ---------------------------------------------------------------------------
# Module-level default tracer + convenience API
# ---------------------------------------------------------------------------

def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


_default_recorder = FlightRecorder(
    max_traces=int(_env_float("NOS_TPU_TRACE_RECORDER_SIZE", 256)),
    slow_threshold_s=_env_float("NOS_TPU_TRACE_SLOW_THRESHOLD_S", 1.0),
)
_default_tracer = Tracer(
    recorder=_default_recorder,
    sampling=_env_float("NOS_TPU_TRACE_SAMPLING", 1.0),
    enabled=os.environ.get("NOS_TPU_TRACING", "1") not in ("0", "false"),
)


def tracer() -> Tracer:
    return _default_tracer


def recorder() -> FlightRecorder:
    return _default_recorder


def configure(sampling: Optional[float] = None,
              enabled: Optional[bool] = None,
              recorder_size: Optional[int] = None,
              slow_threshold_s: Optional[float] = None) -> Tracer:
    """Apply cmd-line/Helm observability settings to the default tracer
    (nos_tpu/cmd/serve.py flags; helm values ``observability.tracing``)."""
    if sampling is not None:
        _default_tracer.sampling = max(0.0, min(1.0, sampling))
    if enabled is not None:
        _default_tracer.enabled = enabled
    if recorder_size is not None:
        _default_recorder.max_traces = max(1, int(recorder_size))
    if slow_threshold_s is not None:
        _default_recorder.slow_threshold_s = slow_threshold_s
    return _default_tracer


def set_clock(clock: Optional[Callable[[], float]]) -> None:
    _default_tracer.set_clock(clock if clock is not None else _wall)


def span(name: str, component: str = "nos-tpu",
         parent: Optional[object] = None,
         attrs: Optional[Dict[str, Any]] = None):
    return _default_tracer.span(name, component, parent=parent, attrs=attrs)


def start_span(name: str, component: str = "nos-tpu",
               parent: Optional[object] = None,
               attrs: Optional[Dict[str, Any]] = None,
               start_time: Optional[float] = None):
    return _default_tracer.start_span(name, component, parent=parent,
                                      attrs=attrs, start_time=start_time)


def current() -> Optional[Span]:
    return _default_tracer.current()


class _NoopRange:
    """Shared do-nothing context manager: ``device_range`` while ranges
    are off or no profiler is running."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NOOP_RANGE = _NoopRange()
_torch_profiler = None
_ranges_on = False


def enable_device_ranges(on: bool = True) -> None:
    """Switch ``device_range`` on (or off) for the process. Off by
    default: torch's profiler also files a device-side copy of each range
    around the kernels launched in it, which a trace reader that takes
    every device event for a kernel would count as device work. Whoever
    starts a profiler that wants the ranges switches them on."""
    global _ranges_on
    _ranges_on = bool(on)


def device_range(name: str):
    """A ``torch.profiler`` range named ``name`` while ranges are on
    (``enable_device_ranges``) and a profiler is running, so a device
    trace files the kernels launched inside it under the range; otherwise
    the shared ``NOOP_RANGE``. The gate is torch's own profiler flag: an
    ungated ``record_function`` costs microseconds a use even with no
    profiler. Torch is imported at the first call with ranges on, which
    keeps this module free of it."""
    global _torch_profiler
    if not _ranges_on:
        return NOOP_RANGE
    prof = _torch_profiler
    if prof is None:
        import torch.autograd.profiler as prof

        _torch_profiler = prof
    if not prof._is_profiler_enabled:
        return NOOP_RANGE
    return prof.record_function(name)


def traced(name: Optional[str] = None, component: str = "nos-tpu"):
    """Decorator form: the wrapped callable runs inside a span named
    after it (or ``name``), parented on the context-local current span."""

    def deco(fn):
        span_name = name or fn.__qualname__

        @wraps(fn)
        def wrapper(*args, **kwargs):
            with _default_tracer.span(span_name, component):
                return fn(*args, **kwargs)

        return wrapper

    return deco


# ---------------------------------------------------------------------------
# Self-metrics (lazy: registered on the port's default registry under the
# reference's name, nos_tpu/observability.py:149)
# ---------------------------------------------------------------------------

# per-component counter children cached flat: Counter.labels() walks a
# lock + dict per call, which is measurable at one inc per span
_span_counter_children: Dict[str, Any] = {}


def _metrics_on_span_end(sp: Span) -> None:
    child = _span_counter_children.get(sp.component)
    if child is None:
        from nos_tpu_torch.utils.metrics import default_registry

        child = default_registry().counter(
            "nos_trace_spans_total",
            "Tracing spans completed in this process, by control-plane "
            "component (scheduler | quota | partitioner | lifecycle | "
            "tpuagent | chaos).",
            ("component",)).labels(sp.component)
        _span_counter_children[sp.component] = child
    child.inc()
