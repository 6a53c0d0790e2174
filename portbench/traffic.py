"""The one request generator: a traffic file's parameters and a seed ->
requests. Requests come in blocks of ``block`` (default 32); every block
holds the same lengths and gaps, the ``block`` mid-quantiles of the
stated distributions, in an order drawn from the file's
``schedule_seed``; the run's seed draws the token ids. So every seed
serves the same schedule of lengths and arrivals with its own tokens:
the seed changes what is computed, not how much or when (two orders of
one Poisson mix spread a p95 TTFT by more than two runs of one order)."""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from statistics import NormalDist
from typing import List


@dataclass
class Request:
    index: int
    due: float              # seconds after the schedule's start
    prompt: List[int]
    max_new: int


def quantile_lengths(spec: dict, n: int) -> List[int]:
    """``n`` lengths at the mid-quantiles (i + 1/2)/n of a lognormal with
    the stated median and sigma, clipped to [min, max]."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    z = NormalDist()
    mu, sigma = math.log(spec["median"]), spec["sigma"]
    return [min(spec["max"], max(spec["min"], round(
        math.exp(mu + sigma * z.inv_cdf((i + 0.5) / n)))))
        for i in range(n)]


def quantile_gaps(rate: float, n: int) -> List[float]:
    """``n`` gaps at the mid-quantiles of an exponential of ``rate``:
    Poisson arrivals' inter-arrival times."""
    return [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]


def request_count(mix: dict, seconds: float) -> int:
    """Requests a run draws: an open loop's arrivals over the lead-in and
    the window; a closed batch's fixed backlog."""
    if mix["arrivals"] == "poisson":
        return math.ceil(mix["rate_per_s"] * (mix["lead_in_s"] + seconds))
    if mix["arrivals"] == "backlog":
        return int(mix["requests"])
    raise ValueError(f"unknown arrivals {mix['arrivals']!r}")


def _blocks(block: List, n: int, rng: random.Random) -> List:
    """``n`` values: ``block`` repeated, each copy shuffled."""
    out = []
    while len(out) < n:
        b = list(block)
        rng.shuffle(b)
        out.extend(b)
    return out[:n]


def generate(mix: dict, seed: int, seconds: float, vocab: int) -> List[Request]:
    """The run's requests in arrival order. ``due`` is the open loop's
    schedule (0 for a backlog, which is queued ahead)."""
    n = request_count(mix, seconds)
    k = mix.get("block", 32)
    order = random.Random(mix.get("schedule_seed", 0))
    prompts = _blocks(quantile_lengths(mix["prompt"], k), n, order)
    outputs = _blocks(quantile_lengths(mix["output"], k), n, order)
    if mix["arrivals"] == "poisson":
        gaps = _blocks(quantile_gaps(mix["rate_per_s"], k), n, order)
        due, t = [], 0.0
        for g in gaps:
            t += g
            due.append(t)
    else:
        due = [0.0] * n
    rng = random.Random(seed)
    return [Request(i, due[i], [rng.randrange(vocab) for _ in range(prompts[i])],
                    outputs[i]) for i in range(n)]
