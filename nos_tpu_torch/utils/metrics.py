"""A copy of ``nos_tpu/utils/metrics.py`` for the port: the registry
every ``/metrics`` endpoint of ``nos_tpu_torch`` serves, a global of its
own (``default_registry()``), never the reference's.

Prometheus-style metrics registry (text exposition format).

The reference exposes only stock controller-runtime metrics behind
kube-rbac-proxy (SURVEY §5: metrics.bindAddress in
templates/gpu-partitioner/configmap_gpu-partitioner-config.yaml) and has no
domain metrics — a gap the survey flags as worth closing since the
north-star metrics are utilization and schedule latency. This module is the
registry; domain metrics (plans applied, plan latency, schedule latency,
chip utilization) are registered by the components that own them and served
from the /metrics endpoint of every cmd/ binary.

Thread-safe; no external dependencies. Exposition follows the Prometheus
text format (``# HELP`` / ``# TYPE`` + samples) so a real Prometheus or GKE
managed collection can scrape the binaries unchanged.
"""
from __future__ import annotations

import threading
from time import time as _now
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(names: Sequence[str], values: Sequence[str],
               extra: Sequence[Tuple[str, str]] = ()) -> str:
    pairs = list(zip(names, values)) + list(extra)
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in pairs)
    return "{" + body + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    # -- label handling -------------------------------------------------
    def labels(self, *values, **kw):
        if kw:
            if values:
                raise ValueError("pass label values positionally or by name, not both")
            try:
                values = tuple(str(kw[n]) for n in self.labelnames)
            except KeyError as e:
                raise ValueError(f"missing label {e} for metric {self.name}") from e
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"metric {self.name} expects labels {self.labelnames}, got {values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._new_child()
                self._children[values] = child
            return child

    def _unlabeled(self):
        if self.labelnames:
            raise ValueError(f"metric {self.name} requires labels {self.labelnames}")
        return self.labels()

    def remove(self, *values) -> None:
        """Drop one label series (exact match). No-op if absent."""
        with self._lock:
            self._children.pop(tuple(str(v) for v in values), None)

    def clear_label(self, labelname: str, value: str) -> None:
        """Drop every series whose ``labelname`` equals ``value`` — used when
        the labeled object (e.g. a quota) is deleted, so stale series don't
        export forever."""
        try:
            i = self.labelnames.index(labelname)
        except ValueError:
            return
        with self._lock:
            for key in [k for k in self._children if k[i] == str(value)]:
                del self._children[key]

    def _new_child(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def _family_name(self, openmetrics: bool) -> str:
        """The metric-family name for HELP/TYPE lines. OpenMetrics names
        counter families WITHOUT the ``_total`` suffix (the sample keeps
        it): a strict parser (Prometheus's openmetrics-text reader)
        rejects `# TYPE foo_total counter` followed by a `foo_total`
        sample, which would make the exemplar scrape path unusable."""
        if openmetrics and self.kind == "counter" \
                and self.name.endswith("_total"):
            return self.name[:-len("_total")]
        return self.name

    # -- exposition ------------------------------------------------------
    def collect(self, openmetrics: bool = False) -> List[str]:
        family = self._family_name(openmetrics)
        lines = [
            f"# HELP {family} {_escape_help(self.help)}",
            f"# TYPE {family} {self.kind}",
        ]
        with self._lock:
            children = list(self._children.items())
        for values, child in children:
            lines.extend(self._render_child(values, child, openmetrics))
        return lines

    def _render_child(self, values, child,
                      openmetrics: bool = False) -> List[str]:  # pragma: no cover
        raise NotImplementedError


class _CounterChild:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only increase")
        with self._lock:
            self.value += amount


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._unlabeled().inc(amount)

    def value(self, *label_values) -> float:
        return self.labels(*label_values).value

    def total(self) -> float:
        """Sum over every label series — harness/test convenience for
        'how many, regardless of label' deltas."""
        with self._lock:
            return sum(child.value for child in self._children.values())

    def _render_child(self, values, child, openmetrics: bool = False):
        return [f"{self.name}{_label_str(self.labelnames, values)} "
                f"{_format_value(child.value)}"]


class _GaugeChild:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, v: float) -> None:
        self._unlabeled().set(v)

    def inc(self, amount: float = 1.0) -> None:
        self._unlabeled().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._unlabeled().dec(amount)

    def value(self, *label_values) -> float:
        return self.labels(*label_values).value

    def _render_child(self, values, child, openmetrics: bool = False):
        return [f"{self.name}{_label_str(self.labelnames, values)} "
                f"{_format_value(child.value)}"]


DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


# raw-sample retention cap per histogram child (track_samples=True only):
# enough for any bench run to compute exact percentiles; beyond it the
# buckets remain correct but quantile() answers only over the first
# MAX_HISTOGRAM_SAMPLES samples
MAX_HISTOGRAM_SAMPLES = 1_000_000


class _HistogramChild:
    __slots__ = ("buckets", "counts", "total", "count", "samples",
                 "exemplars", "_lock")

    def __init__(self, buckets: Tuple[float, ...],
                 track_samples: bool = False):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.total = 0.0
        self.count = 0
        # OPT-IN bounded raw-sample buffer backing quantile() —
        # Prometheus exposition ignores it; local consumers
        # (bench_sched) read exact percentiles from it instead of
        # re-deriving timings. Off by default: a long-lived process must
        # not grow a million-float list per hot histogram nobody reads.
        self.samples: Optional[List[float]] = [] if track_samples else None
        # OpenMetrics exemplars: per bucket (+Inf last), the most recent
        # (trace_id, value, unix_ts) observed with a trace attached.
        # Lazily allocated — histograms nobody traces pay nothing.
        self.exemplars: Optional[List[Optional[Tuple[str, float, float]]]] \
            = None
        self._lock = threading.Lock()

    def observe(self, v: float, trace_id: Optional[str] = None,
                count: int = 1) -> None:
        with self._lock:
            self.total += v * count
            self.count += count
            if self.samples is not None:
                room = MAX_HISTOGRAM_SAMPLES - len(self.samples)
                if room > 0:
                    self.samples.extend([v] * min(count, room))
            matched = len(self.buckets)          # +Inf slot
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    self.counts[i] += count
                    matched = i
                    break
            if trace_id:
                if self.exemplars is None:
                    self.exemplars = [None] * (len(self.buckets) + 1)
                self.exemplars[matched] = (trace_id, v, _now())


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_text: str,
                 labelnames: Sequence[str] = (),
                 buckets: Iterable[float] = DEFAULT_BUCKETS,
                 track_samples: bool = False):
        super().__init__(name, help_text, labelnames)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = tuple(bs)
        self.track_samples = bool(track_samples)

    def _new_child(self):
        return _HistogramChild(self.buckets, self.track_samples)

    def enable_sample_tracking(self) -> None:
        """Turn raw-sample retention on at runtime — for measurement
        harnesses (bench_sched) that want exact percentiles from a
        histogram production code registers without retention. New AND
        existing children start buffering from this call on; daemons that
        never call it never grow a buffer."""
        with self._lock:
            self.track_samples = True
            children = list(self._children.values())
        for child in children:
            with child._lock:
                if child.samples is None:
                    child.samples = []

    def observe(self, v: float, trace_id: Optional[str] = None,
                count: int = 1) -> None:
        """Record ``count`` observations of value ``v`` in one bucket
        walk (count > 1: a batch of identical samples — e.g. n tokens
        sharing one arrival gap — pays one lock acquisition instead of
        n). ``trace_id`` (when the caller has an active tracing span)
        attaches an OpenMetrics exemplar to the matched bucket so a slow
        histogram observation links to the concrete trace that produced
        it."""
        self._unlabeled().observe(v, trace_id, count)

    def observations(self, *label_values) -> Tuple[int, float]:
        """(count, sum) of everything observed into this child — the
        cheap always-on aggregate (no sample tracking required). Bench
        harnesses and tests read it to assert a histogram is populated
        and to report means without enabling raw-sample retention."""
        child = self.labels(*label_values)
        with child._lock:
            return child.count, child.total

    def num_samples(self, *label_values) -> int:
        """Length of the retained raw-sample buffer (== observation count
        until MAX_HISTOGRAM_SAMPLES; 0 when track_samples is off). Use as
        the ``since`` mark for quantile() to scope percentiles to one
        measurement window."""
        samples = self.labels(*label_values).samples
        return len(samples) if samples is not None else 0

    def quantile(self, q: float, since: int = 0,
                 *label_values) -> Optional[float]:
        """Exact nearest-rank percentile (q in (0, 1]) over the raw
        samples observed at buffer index >= ``since``. None when the
        window holds no samples or the histogram doesn't retain samples
        (track_samples=False). This is a local-process convenience on top
        of the Prometheus surface — scrapes still see only buckets."""
        import math

        child = self.labels(*label_values)
        with child._lock:
            if child.samples is None:
                return None
            window = child.samples[since:]
        if not window:
            return None
        window.sort()
        rank = min(len(window), max(1, math.ceil(q * len(window))))
        return window[rank - 1]

    @staticmethod
    def _exemplar_suffix(child, i: int, openmetrics: bool) -> str:
        """OpenMetrics exemplar for bucket ``i``: `` # {trace_id="..."}
        value timestamp``. Classic text format has no exemplar syntax, so
        the suffix is only rendered for OpenMetrics scrapes."""
        if not openmetrics or child.exemplars is None:
            return ""
        ex = child.exemplars[i]
        if ex is None:
            return ""
        trace_id, value, ts = ex
        return (f' # {{trace_id="{_escape_label(trace_id)}"}} '
                f"{_format_value(value)} {ts:.3f}")

    def _render_child(self, values, child, openmetrics: bool = False):
        lines = []
        cumulative = 0
        for i, (ub, c) in enumerate(zip(child.buckets, child.counts)):
            cumulative += c
            lines.append(
                f"{self.name}_bucket"
                f"{_label_str(self.labelnames, values, [('le', _format_value(ub))])}"
                f" {cumulative}"
                f"{self._exemplar_suffix(child, i, openmetrics)}")
        lines.append(
            f"{self.name}_bucket"
            f"{_label_str(self.labelnames, values, [('le', '+Inf')])}"
            f" {child.count}"
            f"{self._exemplar_suffix(child, len(child.buckets), openmetrics)}")
        base = _label_str(self.labelnames, values)
        lines.append(f"{self.name}_sum{base} {_format_value(child.total)}")
        lines.append(f"{self.name}_count{base} {child.count}")
        return lines


class Registry:
    """Holds metrics; renders the Prometheus text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if type(existing) is not type(metric) or \
                        existing.labelnames != metric.labelnames or \
                        getattr(existing, "buckets", None) != \
                        getattr(metric, "buckets", None) or \
                        getattr(existing, "track_samples", None) != \
                        getattr(metric, "track_samples", None):
                    raise ValueError(
                        f"metric {metric.name} already registered with a "
                        f"different type, labels, buckets, or sample "
                        f"tracking")
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help_text: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self.register(Counter(name, help_text, labelnames))  # type: ignore[return-value]

    def gauge(self, name: str, help_text: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self.register(Gauge(name, help_text, labelnames))  # type: ignore[return-value]

    def histogram(self, name: str, help_text: str,
                  labelnames: Sequence[str] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS,
                  track_samples: bool = False) -> Histogram:
        return self.register(Histogram(name, help_text, labelnames, buckets,
                                       track_samples))  # type: ignore[return-value]

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def expose(self, openmetrics: bool = False) -> str:
        """Text exposition. ``openmetrics=True`` renders the OpenMetrics
        dialect: histogram buckets carry exemplars (`` # {trace_id=...}
        value ts``) and the body ends with ``# EOF`` — served when a
        scraper sends ``Accept: application/openmetrics-text``."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        out: List[str] = []
        for m in metrics:
            out.extend(m.collect(openmetrics))
        if openmetrics:
            out.append("# EOF")
        return "\n".join(out) + ("\n" if out else "")

    def reset(self) -> None:
        """Drop all samples (keeps registrations). Test helper."""
        with self._lock:
            for m in self._metrics.values():
                with m._lock:
                    m._children.clear()


_default = Registry()


def default_registry() -> Registry:
    return _default
