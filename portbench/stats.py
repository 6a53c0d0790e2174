"""Percentiles and rates of a run's records."""
from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least q% of the sample at or below it. Infinite values
    (requests that never answered) sort last. None for no sample."""
    if not values:
        return None
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def ttfts(requests: Iterable[dict], t0: float, t1: float) -> List[float]:
    """Time to first token, in seconds, of every request due in [t0, t1),
    timed from its due time; a request that failed, or had no first
    token when the window closed, is infinite."""
    out = []
    for r in requests:
        if not t0 <= r["due"] < t1:
            continue
        first = r["times"][0] if r["times"] else None
        if first is None or first > t1 or r["status"] == "failed":
            out.append(math.inf)
        else:
            out.append(first - r["due"])
    return out


def inter_token_gaps(requests: Iterable[dict], t0: float,
                     t1: float) -> List[float]:
    """Every gap between consecutive output tokens of a request whose
    later token arrived in [t0, t1]; tokens that arrive together have a
    gap of 0."""
    out = []
    for r in requests:
        times = r["times"]
        for a, b in zip(times, times[1:]):
            if t0 <= b <= t1:
                out.append(b - a)
    return out


def tokens_in(requests: Iterable[dict], t0: float, t1: float) -> int:
    """Output tokens that arrived in [t0, t1]."""
    return sum(1 for r in requests for t in r["times"] if t0 <= t <= t1)

