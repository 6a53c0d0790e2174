"""Per-tenant chip-second attribution + SLO error-budget engine, a copy
of ``nos_tpu/obs/slo.py`` for the port (deliberately jax-free).

Two pieces, both clock-injectable so identical event sequences are
identical verdicts (the determinism bar the quota scheduler and the
bench's byte-identical reruns already hold):

``ChipLedger`` — the attribution ledger. The serving engine feeds it
one call per quantum with the two timestamps the tick profiler already
pays for (one-clock-read discipline: the ledger NEVER reads a clock
itself), plus the quantum's structural work weights: decode tokens
emitted per (tenant, phase) and prefill tokens advanced per tenant.
The measured quantum duration is split across those weights
token-proportionally; time between quanta, and quanta that moved no
tokens, land in an explicit ``_idle`` bucket. All accounting is
INTEGER nanoseconds with the split's rounding residual assigned to the
last bucket, so the conservation invariant

    sum over (tenant, phase) charges  ==  wall engine time

holds EXACTLY — structurally, on any clock, through preempt/resume,
tenant reclaim, handoff adopt and supervised engine swaps (a swap
births a fresh ledger; the serving loop delta-mirrors both into the
same monotone counters, the tenant-counter pattern). KV
residency rides the same call: resident HBM bytes per tenant accrue
byte-seconds over each quantum's full span (residency persists through
idle gaps between quanta).

``SloBudgetEngine`` — per-tenant objectives (TTFT/TPOT p99 targets, a
goodput floor) evaluated as SRE multi-burn-rate windows: a fast window
(~5m) for paging/trip decisions and a slow window (~1h) for budget
remaining. ``burn = bad_fraction / allowed`` where ``allowed`` is the
objective's error budget (0.01 for a p99 target, ``1 - floor`` for
goodput). A fast-window burn at/over the trip threshold fires at most
once per ``capture_interval_s`` per (tenant, objective) — the rate
limit that keeps a sustained breach from wedging the flight recorder.

Neither object registers metrics or spans; the serving loop owns the
export surface (and only builds these when the tenant config carries
``slo`` objectives — unconfigured means zero new per-tick work).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

__all__ = ["IDLE_TENANT", "ChipLedger", "SloBudgetEngine",
           "objectives_from_quota", "aggregate_slo", "P99_ALLOWED"]

#: the bucket un-attributed engine time is charged to — making idle an
#: explicit tenant is what makes the ledger conservation-CHECKABLE
IDLE_TENANT = "_idle"

#: error budget of a p99 objective: 1% of requests may breach
P99_ALLOWED = 0.01

_NS = 1_000_000_000


class ChipLedger:
    """Integer-nanosecond per-(tenant, phase) chip-time charges plus
    per-tenant KV byte-seconds. Phases: ``decode``, ``prefill``,
    ``idle`` (the ``_idle`` tenant only)."""

    def __init__(self):
        # (tenant, phase) -> charged ns; invariant: sum == wall_ns
        self._ns: Dict[Tuple[str, str], int] = {}
        self.wall_ns: int = 0
        self._kv_byte_s: Dict[str, float] = {}
        self._cursor: Optional[float] = None

    def note_quantum(self, t0: float, t1: float,
                     work: Optional[Dict[Tuple[str, str], int]] = None,
                     kv_bytes: Optional[Dict[str, int]] = None) -> None:
        """Charge one engine quantum ``[t0, t1]``. ``work`` maps
        (tenant, phase) to the quantum's token count for that bucket
        (decode tokens emitted / prefill tokens advanced) — the
        structural batch-share weights the measured duration splits
        over. ``kv_bytes`` maps tenant to HBM bytes resident across the
        quantum. Both timestamps come from the caller's existing clock
        reads; this method never reads a clock."""
        if t1 < t0:
            t1 = t0
        if self._cursor is None:
            self._cursor = t0
        gap_ns = max(0, round((t0 - self._cursor) * _NS))
        work_ns = max(0, round((t1 - max(t0, self._cursor)) * _NS))
        span_ns = gap_ns + work_ns
        if kv_bytes and span_ns:
            span_s = span_ns / _NS
            for tenant, nbytes in kv_bytes.items():
                if nbytes:
                    self._kv_byte_s[tenant] = self._kv_byte_s.get(
                        tenant, 0.0) + nbytes * span_s
        idle_ns = gap_ns
        total_w = sum(work.values()) if work else 0
        if total_w > 0 and work_ns > 0:
            # deterministic exact split: sorted buckets take their
            # floored proportional share, the last takes the residual —
            # the quantum's charges sum to work_ns by construction
            items = sorted(work.items())
            remaining = work_ns
            for i, (key, w) in enumerate(items):
                share = remaining if i == len(items) - 1 \
                    else work_ns * w // total_w
                remaining -= share
                if share:
                    self._ns[key] = self._ns.get(key, 0) + share
        else:
            idle_ns += work_ns
        if idle_ns:
            key = (IDLE_TENANT, "idle")
            self._ns[key] = self._ns.get(key, 0) + idle_ns
        self.wall_ns += span_ns
        if self._cursor is None or t1 > self._cursor:
            self._cursor = t1

    # -- introspection ---------------------------------------------------
    def totals_ns(self) -> Dict[Tuple[str, str], int]:
        """Raw charge counters for the loop's delta-mirror."""
        return dict(self._ns)

    def kv_byte_seconds(self) -> Dict[str, float]:
        return dict(self._kv_byte_s)

    def conserved(self) -> bool:
        """The invariant, checkable at any instant: every wall
        nanosecond is attributed to exactly one (tenant, phase)."""
        return sum(self._ns.values()) == self.wall_ns

    def snapshot(self) -> dict:
        """/stats ``chip_ledger`` block (per-engine; the loop overlays
        its swap-surviving cumulative totals)."""
        per: Dict[str, Dict[str, float]] = {}
        for (tenant, phase), ns in sorted(self._ns.items()):
            per.setdefault(tenant, {})[phase] = round(ns / 1e6, 3)
        return {
            "wall_ms": round(self.wall_ns / 1e6, 3),
            "chip_ms": per,
            "kv_byte_seconds": {
                t: round(v, 3)
                for t, v in sorted(self._kv_byte_s.items())},
            "conserved": self.conserved(),
        }


def objectives_from_quota(quota) -> Dict[str, Dict[str, float]]:
    """tenant -> {objective: allowed bad fraction} from a parsed
    ``TenantQuotaConfig`` (tenants without an ``slo`` block contribute
    nothing). Empty result == SLO accounting off."""
    out: Dict[str, Dict[str, float]] = {}
    for name, spec in getattr(quota, "tenants", {}).items():
        slo = getattr(spec, "slo", None)
        if slo is None:
            continue
        objs: Dict[str, float] = {}
        if slo.ttft_p99_ms > 0:
            objs["ttft_p99"] = P99_ALLOWED
        if slo.tpot_p99_ms > 0:
            objs["tpot_p99"] = P99_ALLOWED
        if slo.goodput_floor > 0:
            # rounded: the budget fraction travels through /stats and
            # the bench's byte-identical artifacts
            objs["goodput"] = round(1.0 - slo.goodput_floor, 6)
        if objs:
            out[name] = objs
    return out


class _Window:
    """One rolling (t, bad) event window with O(1) running counts."""

    __slots__ = ("span_s", "events", "total", "bad")

    def __init__(self, span_s: float):
        self.span_s = span_s
        self.events: Deque[Tuple[float, int]] = deque()
        self.total = 0
        self.bad = 0

    def add(self, now: float, bad: bool) -> None:
        self.events.append((now, 1 if bad else 0))
        self.total += 1
        self.bad += 1 if bad else 0
        self.prune(now)

    def prune(self, now: float) -> None:
        cutoff = now - self.span_s
        ev = self.events
        while ev and ev[0][0] <= cutoff:
            _, b = ev.popleft()
            self.total -= 1
            self.bad -= b


class SloBudgetEngine:
    """Multi-window burn-rate evaluation over per-tenant objectives.
    ``note`` returns True when this event fires a (rate-limited)
    fast-window trip — the caller mints the ``slo.breach`` span and
    pins the trace."""

    def __init__(self, objectives: Dict[str, Dict[str, float]],
                 fast_window_s: float = 300.0,
                 slow_window_s: float = 3600.0,
                 burn_threshold: float = 14.4,
                 capture_interval_s: float = 300.0,
                 min_events: int = 10):
        self.objectives = {
            t: dict(objs) for t, objs in objectives.items()}
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.burn_threshold = float(burn_threshold)
        self.capture_interval_s = float(capture_interval_s)
        self.min_events = int(min_events)
        self._fast: Dict[Tuple[str, str], _Window] = {}
        self._slow: Dict[Tuple[str, str], _Window] = {}
        self._last_trip: Dict[Tuple[str, str], float] = {}
        self.trips: Dict[Tuple[str, str], int] = {}

    def tracked(self, tenant: str) -> Dict[str, float]:
        return self.objectives.get(tenant, {})

    def _wins(self, key: Tuple[str, str]) -> Tuple[_Window, _Window]:
        f = self._fast.get(key)
        if f is None:
            f = self._fast[key] = _Window(self.fast_window_s)
            self._slow[key] = _Window(self.slow_window_s)
        return f, self._slow[key]

    @staticmethod
    def _burn(win: _Window, allowed: float) -> float:
        if win.total == 0:
            return 0.0
        return (win.bad / win.total) / max(allowed, 1e-9)

    def note(self, tenant: str, objective: str, bad: bool,
             now: float) -> bool:
        """Record one judged event; True == fast-window trip fired
        (burn over threshold, enough events, rate limit clear)."""
        allowed = self.objectives.get(tenant, {}).get(objective)
        if allowed is None:
            return False
        key = (tenant, objective)
        fast, slow = self._wins(key)
        fast.add(now, bad)
        slow.add(now, bad)
        if not bad or fast.total < self.min_events:
            return False
        if self._burn(fast, allowed) < self.burn_threshold:
            return False
        last = self._last_trip.get(key)
        if last is not None and now - last < self.capture_interval_s:
            return False
        self._last_trip[key] = now
        self.trips[key] = self.trips.get(key, 0) + 1
        return True

    # -- introspection ---------------------------------------------------
    def rows(self, now: float) -> List[dict]:
        """One row per configured (tenant, objective): burn rates per
        window, budget remaining, and the raw window counts the gateway
        re-aggregates fleet-wide."""
        out = []
        for tenant in sorted(self.objectives):
            for objective, allowed in sorted(
                    self.objectives[tenant].items()):
                key = (tenant, objective)
                fast, slow = self._wins(key)
                fast.prune(now)
                slow.prune(now)
                budget = 1.0
                if slow.total:
                    budget = max(0.0, 1.0 - slow.bad
                                 / (allowed * slow.total))
                out.append({
                    "tenant": tenant,
                    "objective": objective,
                    "allowed": allowed,
                    "burn_fast": round(self._burn(fast, allowed), 3),
                    "burn_slow": round(self._burn(slow, allowed), 3),
                    "budget_remaining_ratio": round(budget, 4),
                    "windows": {
                        "fast": {"total": fast.total, "bad": fast.bad},
                        "slow": {"total": slow.total, "bad": slow.bad},
                    },
                    "trips": self.trips.get(key, 0),
                })
        return out

    def snapshot(self, now: float) -> dict:
        """/stats ``slo_budget`` block."""
        return {
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "burn_threshold": self.burn_threshold,
            "capture_interval_s": self.capture_interval_s,
            "min_events": self.min_events,
            "objectives": self.rows(now),
        }


def aggregate_slo(blocks: List[dict],
                  burn_threshold: float = 14.4) -> List[dict]:
    """Fleet roll-up: merge per-replica ``slo_budget`` blocks (their
    ``objectives`` rows) by (tenant, objective), recomputing burn and
    budget remaining from the SUMMED window counts — a fleet-wide bad
    fraction, not an average of ratios."""
    acc: Dict[Tuple[str, str], dict] = {}
    for block in blocks:
        for row in (block or {}).get("objectives", []):
            key = (row["tenant"], row["objective"])
            a = acc.get(key)
            if a is None:
                a = acc[key] = {
                    "tenant": row["tenant"],
                    "objective": row["objective"],
                    "allowed": row["allowed"],
                    "fast_total": 0, "fast_bad": 0,
                    "slow_total": 0, "slow_bad": 0,
                    "trips": 0, "replicas": 0,
                }
            w = row["windows"]
            a["fast_total"] += w["fast"]["total"]
            a["fast_bad"] += w["fast"]["bad"]
            a["slow_total"] += w["slow"]["total"]
            a["slow_bad"] += w["slow"]["bad"]
            a["trips"] += row.get("trips", 0)
            a["replicas"] += 1
    out = []
    for key in sorted(acc):
        a = acc[key]
        allowed = max(a["allowed"], 1e-9)
        burn_fast = (a["fast_bad"] / a["fast_total"] / allowed
                     if a["fast_total"] else 0.0)
        burn_slow = (a["slow_bad"] / a["slow_total"] / allowed
                     if a["slow_total"] else 0.0)
        budget = 1.0
        if a["slow_total"]:
            budget = max(0.0, 1.0 - a["slow_bad"]
                         / (allowed * a["slow_total"]))
        out.append({
            "tenant": a["tenant"],
            "objective": a["objective"],
            "allowed": a["allowed"],
            "burn_fast": round(burn_fast, 3),
            "burn_slow": round(burn_slow, 3),
            "budget_remaining_ratio": round(budget, 4),
            "breaching": burn_fast >= burn_threshold,
            "windows": {
                "fast": {"total": a["fast_total"],
                         "bad": a["fast_bad"]},
                "slow": {"total": a["slow_total"],
                         "bad": a["slow_bad"]},
            },
            "trips": a["trips"],
            "replicas": a["replicas"],
        })
    return out
