"""Quota accounting arithmetic (a copy of the part of
``nos_tpu/quota/info.py`` that request-level tenant quotas use; torch-
and kube-free).

``QuotaInfos.guaranteed_overquotas(ns)``: the aggregated unused min
across all quotas (sum of max(0, min - used)) split proportionally to
each quota's share of the aggregated min, floored per resource: the
fair-sharing rule that ``TenantScheduler.borrow_shares`` reads, so the
port's notion of a fair borrow share is the reference pod layer's. The
pod bookkeeping (pods, resource calculators, bound comparisons) stays
with the control plane and is not copied.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Set

#: resource name -> quantity
ResourceList = Dict[str, float]

__all__ = ["QuotaInfo", "QuotaInfos", "ResourceList"]


@dataclass
class QuotaInfo:
    """Live accounting for one quota: its bounds and what is used."""

    name: str
    namespace: str                         # namespace the quota object lives in
    namespaces: Set[str] = field(default_factory=set)  # namespaces it covers
    min: ResourceList = field(default_factory=dict)
    max: Optional[ResourceList] = None
    used: ResourceList = field(default_factory=dict)


class QuotaInfos(Dict[str, QuotaInfo]):
    """namespace -> QuotaInfo (one info object may appear under several
    namespaces for composite quotas)."""

    def add(self, info: QuotaInfo) -> None:
        for ns in info.namespaces:
            self[ns] = info

    def _distinct_infos(self):
        seen = set()
        for info in self.values():
            if id(info) not in seen:
                seen.add(id(info))
                yield info

    def aggregated_min(self) -> ResourceList:
        total: ResourceList = {}
        for info in self._distinct_infos():
            for r, v in info.min.items():
                total[r] = total.get(r, 0) + v
        return total

    def aggregated_overquotas(self) -> ResourceList:
        """Sum of max(0, min - used) over quotas: quota headroom
        available for borrowing."""
        total: ResourceList = {}
        for info in self._distinct_infos():
            for r, m in info.min.items():
                unused = m - info.used.get(r, 0)
                if unused > 0:
                    total[r] = total.get(r, 0) + unused
        return total

    def guaranteed_overquotas(self, namespace: str) -> ResourceList:
        """The slice of aggregated overquota guaranteed to ``namespace``'s
        quota: proportional to its share of aggregated min, floored."""
        info = self.get(namespace)
        if info is None:
            raise KeyError(f"no quota covers namespace {namespace!r}")
        total_min = self.aggregated_min()
        overquotas = self.aggregated_overquotas()
        out: ResourceList = {}
        for r, m in info.min.items():
            t = total_min.get(r, 0)
            pct = (m / t) if t > 0 else 0.0
            out[r] = _floor_quantity(r, overquotas.get(r, 0) * pct)
        return out


def _floor_quantity(resource: str, value: float) -> float:
    """Floor at the resource's allocation granularity: cpu at
    millicores, everything else at whole units."""
    if resource == "cpu":
        return math.floor(value * 1000 + 1e-9) / 1000
    return float(math.floor(value + 1e-9))
