"""Percentile and rate arithmetic of the run records."""
from __future__ import annotations

import math

from portbench import readers, stats


def req(due, times, status="finished", prompt=4):
    return {"due": due, "times": list(times), "status": status,
            "prompt": [0] * prompt, "tokens": [1] * len(times)}


def test_nearest_rank_percentile():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile(vals, 50) == 50
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([], 95) is None
    assert stats.percentile([1.0, math.inf], 50) == 1.0
    assert stats.percentile([1.0, math.inf], 95) == math.inf


def test_ttft_from_due_time_and_missing_requests():
    rs = [req(1.0, [1.5, 1.6]), req(2.0, []), req(3.0, [3.2], "failed"),
          req(0.5, [0.7]), req(9.5, [10.5])]
    got = stats.ttfts(rs, 1.0, 10.0)
    assert got[0] == 0.5
    assert got[1:3] == [math.inf, math.inf]
    # due before the window: not counted; due in it, answered after the
    # close: missing
    assert len(got) == 4 and got[3] == math.inf


def test_ttft_reader_counts_missing_as_late():
    rs = [req(1.0 + i * 0.1, [1.0 + i * 0.1 + 0.2]) for i in range(19)]
    rs.append(req(2.0, []))
    run = {"window": (1.0, 11.0), "requests": rs}
    # 20 requests: the 95th percentile is the 19th, an answered one
    assert math.isclose(readers.ttft_p95_ms(run), 200.0, rel_tol=1e-9)
    rs.append(req(2.1, []))
    # 21: the 20th value is a missing request's: it waited from 2.1 to
    # the close (8.9 s) and a whole window more (10 s)
    assert math.isclose(readers.ttft_p95_ms(run), 18900.0, rel_tol=1e-9)


def test_a_stall_lands_in_the_inter_token_tail():
    # 40 requests ticking every 20 ms; one 300 ms stall at t = 5 s
    rs = []
    for i in range(40):
        t, times = 0.0, []
        while t < 10:
            t += 0.02 + (0.3 if 5.0 <= t < 5.02 else 0.0)
            times.append(t)
        rs.append(req(0.0, times))
    gaps = stats.inter_token_gaps(rs, 1.0, 9.0)
    assert stats.percentile(gaps, 50) < 0.021
    assert max(gaps) > 0.3
    # one stall in ~400 gaps a request sits far beyond the 95th
    assert stats.percentile(gaps, 95) < 0.021
    # a stall in every tenth gap is the 95th percentile
    rs = [req(0.0, [i * 0.02 + (i // 10) * 0.3 for i in range(400)])
          for _ in range(10)]
    gaps = stats.inter_token_gaps(rs, 0.0, 1e9)
    assert stats.percentile(gaps, 95) > 0.3


def test_rate_over_the_window():
    rs = [req(0.0, [0.5 + 0.01 * i for i in range(1000)])]
    run = {"window": (1.0, 6.0), "requests": rs}
    # tokens at 1.00 .. 6.00 inclusive: 501
    assert math.isclose(readers.output_tokens_per_s(run), 501 / 5.0)

