"""Request-level elastic quota (a copy of
``nos_tpu/models/tenantquota.py`` for the port; torch-free).

Per-tenant token-rate min/max with borrowing and fair-share preemptive
reclaim. The serving engine's admission queue becomes a weighted pick
over tenants:

- a tenant under its ``min`` token-rate is GUARANTEED: it is admitted
  before any tenant at/over its min (never skipped for a borrower);
- idle capacity is LENT: tenants over their min keep admitting,
  ordered so that borrowed rate stays proportional to each tenant's
  ``guaranteed_overquotas`` share of the unused aggregate min, computed
  by ``QuotaInfos.guaranteed_overquotas`` (the port's copy of that
  arithmetic, ``nos_tpu_torch/quota/info.py``);
- ``max`` is the lending ceiling under contention: a tenant measured
  at/over its max while the engine is busy is shed at submission with
  the ``tenant_quota`` reason (429 + Retry-After). An IDLE engine still
  lends past max (work conservation).

Rates are measured over a sliding window on an injectable clock
(``now`` is always passed in), so the scheduler is deterministic under
a fake clock. The reclaim side (a guaranteed tenant arriving with no
headroom preempting the most-over-quota tenant's youngest slot) lives
in the engine; this module only answers the policy questions.
"""
from __future__ import annotations

import json
import os
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterable, List, Optional, Tuple

from nos_tpu_torch.models.errors import (
    DEFAULT_TENANT, validate_tenant_name,
)
from nos_tpu_torch.quota.info import QuotaInfo, QuotaInfos

__all__ = ["DEFAULT_TENANT", "TenantSloSpec", "TenantSpec",
           "TenantQuotaConfig", "TenantScheduler", "RATE_RESOURCE",
           "validate_tenant_name"]

#: the synthetic ResourceList key tenant token-rates travel under when
#: the shares route through quota/info.py's aggregates
RATE_RESOURCE = "serve_tokens"

#: rates are scaled to milli-tokens/s before entering QuotaInfos:
#: ``_floor_quantity`` floors scalar resources at whole units, and a
#: sub-token/s share must not floor to zero
RATE_SCALE = 1000.0


@dataclass(frozen=True)
class TenantSloSpec:
    """One tenant's SLO objectives: p99 latency targets and
    a goodput floor, all optional (0 = objective not tracked). These
    feed the serving loop's ``SloBudgetEngine``; a config with no
    ``slo`` blocks anywhere runs with SLO accounting OFF (zero new
    per-tick work)."""

    ttft_p99_ms: float = 0.0
    tpot_p99_ms: float = 0.0
    goodput_floor: float = 0.0

    def echo(self) -> dict:
        return {"ttft_p99_ms": self.ttft_p99_ms,
                "tpot_p99_ms": self.tpot_p99_ms,
                "goodput_floor": self.goodput_floor}


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's token-rate quota. ``min_rate`` tokens/s are
    GUARANTEED (admitted first, reclaimed by preemption when necessary);
    ``max_rate`` is the borrowing ceiling under contention (0 =
    unlimited). min <= max is validated at parse time. ``slo`` carries
    the tenant's optional error-budget objectives."""

    name: str
    min_rate: float = 0.0
    max_rate: float = 0.0
    slo: Optional[TenantSloSpec] = None


@dataclass
class TenantQuotaConfig:
    """Parsed ``--tenant-config`` (file path or inline JSON):

        {"default_tenant": "default",
         "window_s": 5.0,
         "share_prefix": false,
         "tenants": {"gold":  {"min_rate": 200, "max_rate": 0},
                     "burst": {"min_rate": 0,   "max_rate": 50}}}

    Unknown tenant names resolve to ``default_tenant``'s quota (and its
    metric label) — identity is the same trust domain as the rest of
    the serving surface, but an unknown label must not mint unbounded
    scheduler/metric state. ``share_prefix`` is the OPT-OUT for
    tenant-scoped prefix-cache keys: by default two tenants with
    identical prompts get disjoint KV chains (cross-tenant block
    sharing is a timing side-channel); trusted single-org fleets may
    turn sharing back on."""

    tenants: Dict[str, TenantSpec] = field(default_factory=dict)
    default_tenant: str = DEFAULT_TENANT
    window_s: float = 5.0
    share_prefix: bool = False

    def __post_init__(self):
        if self.window_s <= 0:
            raise ValueError(
                f"window_s must be > 0, got {self.window_s}")
        if self.default_tenant not in self.tenants:
            # the default tenant always exists (unlabeled traffic needs
            # a ledger row), with unbounded borrowing unless configured
            self.tenants = dict(self.tenants)
            self.tenants[self.default_tenant] = TenantSpec(
                self.default_tenant)
        for name, spec in self.tenants.items():
            if spec.min_rate < 0 or spec.max_rate < 0:
                raise ValueError(
                    f"tenant {name!r}: rates must be >= 0")
            if spec.max_rate and spec.min_rate > spec.max_rate:
                raise ValueError(
                    f"tenant {name!r}: min_rate {spec.min_rate} > "
                    f"max_rate {spec.max_rate}")

    # -- parsing --------------------------------------------------------
    @classmethod
    def load(cls, spec: str) -> Optional["TenantQuotaConfig"]:
        """``--tenant-config`` semantics: empty = tenancy off (None);
        a string starting with ``{`` parses as inline JSON, anything
        else is a file path."""
        if not spec:
            return None
        text = spec
        if not spec.lstrip().startswith("{"):
            if not os.path.exists(spec):
                raise ValueError(
                    f"tenant config {spec!r}: not inline JSON and no "
                    f"such file")
            with open(spec) as f:
                text = f.read()
        return cls.from_json(text)

    @classmethod
    def from_json(cls, text: str) -> "TenantQuotaConfig":
        data = json.loads(text)
        if not isinstance(data, dict):
            raise ValueError("tenant config must be a JSON object")
        known = {"tenants", "default_tenant", "window_s", "share_prefix"}
        unknown = set(data) - known
        if unknown:
            raise ValueError(
                f"unknown tenant config keys {sorted(unknown)}")
        tenants = {}
        for name, body in (data.get("tenants") or {}).items():
            validate_tenant_name(name)
            extra = set(body) - {"min_rate", "max_rate", "slo"}
            if extra:
                raise ValueError(
                    f"tenant {name!r}: unknown keys {sorted(extra)}")
            slo = None
            if body.get("slo") is not None:
                sbody = body["slo"]
                if not isinstance(sbody, dict):
                    raise ValueError(
                        f"tenant {name!r}: slo must be an object")
                sextra = set(sbody) - {"ttft_p99_ms", "tpot_p99_ms",
                                       "goodput_floor"}
                if sextra:
                    raise ValueError(
                        f"tenant {name!r}: unknown slo keys "
                        f"{sorted(sextra)}")
                slo = TenantSloSpec(
                    ttft_p99_ms=float(sbody.get("ttft_p99_ms", 0.0)),
                    tpot_p99_ms=float(sbody.get("tpot_p99_ms", 0.0)),
                    goodput_floor=float(
                        sbody.get("goodput_floor", 0.0)))
                if slo.ttft_p99_ms < 0 or slo.tpot_p99_ms < 0:
                    raise ValueError(
                        f"tenant {name!r}: slo targets must be >= 0")
                if not 0.0 <= slo.goodput_floor < 1.0:
                    raise ValueError(
                        f"tenant {name!r}: goodput_floor must be in "
                        f"[0, 1)")
            tenants[name] = TenantSpec(
                name, min_rate=float(body.get("min_rate", 0.0)),
                max_rate=float(body.get("max_rate", 0.0)), slo=slo)
        return cls(
            tenants=tenants,
            default_tenant=str(data.get("default_tenant",
                                        DEFAULT_TENANT)),
            window_s=float(data.get("window_s", 5.0)),
            share_prefix=bool(data.get("share_prefix", False)))

    # -- identity -------------------------------------------------------
    def resolve(self, tenant: Optional[str]) -> str:
        """Canonical quota identity for a wire tenant: configured names
        pass through, everything else (None included) is the default
        tenant — bounded scheduler state and metric cardinality."""
        if tenant and tenant in self.tenants:
            return tenant
        return self.default_tenant

    def spec(self, tenant: Optional[str]) -> TenantSpec:
        return self.tenants[self.resolve(tenant)]

    def names(self) -> List[str]:
        return sorted(self.tenants)

    def slo_enabled(self) -> bool:
        """True when ANY tenant carries objectives — the single switch
        for the ledger + budget engine (an absent
        config must mean zero new per-tick work)."""
        return any(s.slo is not None for s in self.tenants.values())

    def echo(self) -> dict:
        """Config-echo shape for /stats (fleet drift detection)."""
        out = {
            "default_tenant": self.default_tenant,
            "window_s": self.window_s,
            "share_prefix": self.share_prefix,
            "tenants": {
                n: {"min_rate": s.min_rate, "max_rate": s.max_rate}
                for n, s in sorted(self.tenants.items())},
        }
        for n, s in self.tenants.items():
            if s.slo is not None:
                out["tenants"][n]["slo"] = s.slo.echo()
        return out



class TenantScheduler:
    """The weighted pick over the admission queue, plus the rate ledger
    it decides on. Every method takes ``now`` explicitly (the engine
    reads its own clock), so identical call sequences are identical
    decisions — the determinism the bench's byte-identical reruns and
    the property fuzz pin.

    Pick order (``pick``), the two-layer mirror of the pod scheduler:

    1. tenants UNDER min, most-starved first (lowest rate/min) — the
       guarantee: never skipped for any tenant at/over its min;
    2. tenants at/over min and under max (borrowers), lowest
       borrowed-rate / guaranteed-share first — equalizing that ratio
       is what makes realized borrowing proportional to the
       ``guaranteed_overquotas`` shares (the quota/info.py oracle the
       property fuzz compares against);
    3. tenants at/over max — admitted ONLY when no class-1/2 tenant
       has pending work (work conservation: an idle slot is never held
       back by a ceiling), lowest rate/max first.
    """

    def __init__(self, cfg: TenantQuotaConfig):
        self.cfg = cfg
        # per-tenant (t, tokens) marks inside the sliding window
        self._marks: Dict[str, Deque[Tuple[float, int]]] = {}
        self._window_tokens: Dict[str, int] = {}
        self.tokens_total: Dict[str, int] = {
            n: 0 for n in cfg.tenants}
        self.sheds: Dict[str, int] = {}
        self.preempts: Dict[str, Dict[str, int]] = {}

    # -- the rate ledger -----------------------------------------------
    def note_tokens(self, tenant: Optional[str], n: int,
                    now: float) -> None:
        t = self.cfg.resolve(tenant)
        dq = self._marks.get(t)
        if dq is None:
            dq = self._marks[t] = deque()
        dq.append((now, n))
        self._window_tokens[t] = self._window_tokens.get(t, 0) + n
        self.tokens_total[t] = self.tokens_total.get(t, 0) + n
        self._prune(t, now)

    def _prune(self, tenant: str, now: float) -> None:
        dq = self._marks.get(tenant)
        if not dq:
            return
        cutoff = now - self.cfg.window_s
        while dq and dq[0][0] <= cutoff:
            _, n = dq.popleft()
            self._window_tokens[tenant] -= n

    def rate(self, tenant: Optional[str], now: float) -> float:
        """Tokens/s over the sliding window (fixed divisor: a burst
        decays to zero within one window of going idle)."""
        t = self.cfg.resolve(tenant)
        self._prune(t, now)
        return self._window_tokens.get(t, 0) / self.cfg.window_s

    # -- the quota/info.py mirror --------------------------------------
    def _quota_infos(self, now: float) -> QuotaInfos:
        """Tenant specs + live rates as ``QuotaInfos``, one synthetic
        quota per tenant over the RATE_RESOURCE — the pod layer's own
        accounting objects, so aggregated-min / overquota / guaranteed-
        share questions are answered by pkg-identical code."""
        infos = QuotaInfos()
        for name, spec in self.cfg.tenants.items():
            info = QuotaInfo(
                name=name, namespace=name, namespaces={name},
                min={RATE_RESOURCE: spec.min_rate * RATE_SCALE},
                max=({RATE_RESOURCE: spec.max_rate * RATE_SCALE}
                     if spec.max_rate else None),
                used={RATE_RESOURCE: self.rate(name, now) * RATE_SCALE})
            infos.add(info)
        return infos

    def borrow_shares(self, now: float) -> Dict[str, float]:
        """Each tenant's guaranteed slice of the aggregate UNUSED min
        (tokens/s) — literally ``QuotaInfos.guaranteed_overquotas``
        over the synthetic rate quotas, so this layer's notion of a
        fair borrow share is the pod layer's, floored at the same
        granularity (milli-tokens/s after RATE_SCALE)."""
        infos = self._quota_infos(now)
        return {
            name: infos.guaranteed_overquotas(name).get(
                RATE_RESOURCE, 0.0) / RATE_SCALE
            for name in self.cfg.tenants}

    # -- classification -------------------------------------------------
    def under_min(self, tenant: Optional[str], now: float) -> bool:
        spec = self.cfg.spec(tenant)
        return spec.min_rate > 0 \
            and self.rate(tenant, now) < spec.min_rate

    def over_min(self, tenant: Optional[str], now: float) -> bool:
        """Strictly above the guarantee — the preemptible class: a
        reclaim never victimizes a tenant within its min."""
        return self.rate(tenant, now) > self.cfg.spec(tenant).min_rate

    def over_max(self, tenant: Optional[str], now: float) -> bool:
        spec = self.cfg.spec(tenant)
        return spec.max_rate > 0 \
            and self.rate(tenant, now) >= spec.max_rate

    def over_quota_ratio(self, tenant: Optional[str], now: float,
                         shares: Optional[Dict[str, float]] = None
                         ) -> float:
        """How far past the guarantee a tenant is running, normalized
        by its fair borrow share — the victim-ordering key for reclaim
        (largest ratio = most over quota = preempted first). Pass a
        precomputed ``borrow_shares(now)`` when ranking several
        tenants in one pass; each shares build walks the QuotaInfos
        aggregates and must not be repaid per victim."""
        spec = self.cfg.spec(tenant)
        over = max(0.0, self.rate(tenant, now) - spec.min_rate)
        if shares is None:
            shares = self.borrow_shares(now)
        share = shares.get(self.cfg.resolve(tenant), 0.0)
        return over / max(share, 1e-9)

    # -- the pick -------------------------------------------------------
    def pick(self, candidates: Iterable[str], now: float
             ) -> Optional[str]:
        """Which tenant's request admits next, among tenants with
        pending work. Never None for a non-empty candidate set (work
        conservation); ties break by name for determinism."""
        cands = sorted(set(self.cfg.resolve(c) for c in candidates))
        if not cands:
            return None
        shares = self.borrow_shares(now)

        def key(t: str):
            spec = self.cfg.tenants[t]
            r = self.rate(t, now)
            if spec.min_rate > 0 and r < spec.min_rate:
                return (0, r / spec.min_rate, t)
            if spec.max_rate > 0 and r >= spec.max_rate:
                return (2, r / spec.max_rate, t)
            over = max(0.0, r - spec.min_rate)
            return (1, over / max(shares.get(t, 0.0), 1e-9), t)

        return min(cands, key=key)

    # -- shed/preempt bookkeeping (the engine's counters) ---------------
    def note_shed(self, tenant: Optional[str]) -> None:
        t = self.cfg.resolve(tenant)
        self.sheds[t] = self.sheds.get(t, 0) + 1

    def note_preempt(self, tenant: Optional[str], mode: str) -> None:
        t = self.cfg.resolve(tenant)
        per = self.preempts.setdefault(t, {"swap": 0, "recompute": 0})
        per[mode] = per.get(mode, 0) + 1

    # -- introspection --------------------------------------------------
    def snapshot(self, now: float) -> dict:
        """/stats ``tenants`` section + the loop's gauge mirror: one
        row per configured tenant. The gateway sums ``rate`` across
        replicas for its fleet-wide door admission."""
        shares = self.borrow_shares(now)
        out = {}
        for name, spec in sorted(self.cfg.tenants.items()):
            r = self.rate(name, now)
            out[name] = {
                "rate_tokens_per_s": round(r, 3),
                "min_rate": spec.min_rate,
                "max_rate": spec.max_rate,
                "borrowed_tokens_per_s": round(
                    max(0.0, r - spec.min_rate), 3),
                "borrow_share": round(shares.get(name, 0.0), 3),
                "under_min": bool(spec.min_rate > 0
                                  and r < spec.min_rate),
                "over_max": bool(spec.max_rate > 0
                                 and r >= spec.max_rate),
                "tokens_total": self.tokens_total.get(name, 0),
                "sheds": self.sheds.get(name, 0),
                "preempts": dict(self.preempts.get(
                    name, {"swap": 0, "recompute": 0})),
            }
        return out
