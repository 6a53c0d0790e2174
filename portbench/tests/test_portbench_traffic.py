"""The generator: deterministic under the seed, the stated lengths and
rates, the same work for every seed."""
from __future__ import annotations

import json
import math
import statistics
from collections import Counter

import pytest

from portbench import traffic
from portbench.spec import PKG

MIXES = ["chat", "backlog"]
# a full queue: the chat lengths, every request queued ahead
BACKLOG = {"arrivals": "backlog", "requests": 1200, "outstanding": 128}


def load(name):
    if name == "backlog":
        return dict(load("chat"), **BACKLOG)
    return json.loads((PKG / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = load(name)
    a = traffic.generate(mix, 2 ** 31 + 12345, 40, 32000)
    b = traffic.generate(mix, 2 ** 31 + 12345, 40, 32000)
    c = traffic.generate(mix, 2 ** 31 + 12346, 40, 32000)
    assert [(r.due, r.prompt, r.max_new) for r in a] == \
        [(r.due, r.prompt, r.max_new) for r in b]
    assert [r.prompt for r in a] != [r.prompt for r in c]


@pytest.mark.parametrize("name", MIXES)
def test_lengths_in_their_clips(name):
    mix = load(name)
    reqs = traffic.generate(mix, 7, 40, 32000)
    for r in reqs:
        assert mix["prompt"]["min"] <= len(r.prompt) <= mix["prompt"]["max"]
        assert mix["output"]["min"] <= r.max_new <= mix["output"]["max"]
        assert all(0 <= t < 32000 for t in r.prompt)
    med = statistics.median(len(r.prompt) for r in reqs)
    assert abs(med / mix["prompt"]["median"] - 1) < 0.1
    med = statistics.median(r.max_new for r in reqs)
    assert abs(med / mix["output"]["median"] - 1) < 0.1


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_same_schedule(name):
    """Seeds draw the tokens; the lengths and arrivals are the file's."""
    mix = load(name)
    a = traffic.generate(mix, 1, 40, 32000)
    b = traffic.generate(mix, 2 ** 31 + 99, 40, 32000)
    assert [(r.due, len(r.prompt), r.max_new) for r in a] == \
        [(r.due, len(r.prompt), r.max_new) for r in b]
    c = traffic.generate(dict(mix, schedule_seed=1), 1, 40, 32000)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in c]


@pytest.mark.parametrize("name", MIXES)
def test_every_block_same_work(name):
    """Each block of ``block`` requests holds the same lengths."""
    mix = load(name)
    k = mix.get("block", 32)
    a = traffic.generate(mix, 1, 40, 32000)
    b = traffic.generate(dict(mix, schedule_seed=7), 1, 40, 32000)
    for lo in range(0, min(len(a), len(b)) - k + 1, k):
        assert Counter(len(r.prompt) for r in a[lo:lo + k]) == \
            Counter(len(r.prompt) for r in b[lo:lo + k])
        assert Counter(r.max_new for r in a[lo:lo + k]) == \
            Counter(r.max_new for r in b[lo:lo + k])


def test_open_loop_rate_and_count():
    mix = load("chat")
    seconds = 40
    reqs = traffic.generate(mix, 3, seconds, 32000)
    n = math.ceil(mix["rate_per_s"] * (mix["lead_in_s"] + seconds))
    assert len(reqs) == n
    dues = [r.due for r in reqs]
    assert dues == sorted(dues)
    # mid-quantile gaps of an exponential: the mean is within a few
    # percent of 1/rate
    gaps = [b - a for a, b in zip([0.0] + dues, dues)]
    assert abs(statistics.mean(gaps) * mix["rate_per_s"] - 1) < 0.05


def test_backlog_is_queued_ahead():
    mix = load("backlog")
    reqs = traffic.generate(mix, 3, 40, 32000)
    assert len(reqs) == mix["requests"]
    assert all(r.due == 0.0 for r in reqs)


def test_quantile_lengths_follow_the_lognormal():
    spec = {"dist": "lognormal", "median": 100, "sigma": 0.5, "min": 1,
            "max": 10 ** 6}
    vals = sorted(traffic.quantile_lengths(spec, 1001))
    assert vals[500] == 100
    assert abs(vals[841] / (100 * math.exp(0.5)) - 1) < 0.02
