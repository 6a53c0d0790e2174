"""Find a serving cell's knee once: the highest Poisson rate at which the
queue does not grow across the window.

    python -m portbench.sweep --workload <cell> --seed <n> \\
        --seconds <s> --rates 4,6,8

One engine serves the cell's traffic at each rate in turn (its lead-in,
then ``--seconds``), with the loop drained between rates. Per rate it
prints one JSON line: the requests waiting for a slot (due, no first
token) at the window's open and close, requests started and tokens
served a second, TTFT and inter-token p50/p95, and how late the
scheduler ran. The sweep stops at the first rate whose queue grew by
more than ``GROWTH`` requests across the window; the rate before it is
the knee. The cell then fixes four fifths of the knee in its traffic
file; the benchmark's runs never search for a rate.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import spec, stats, traffic
from portbench.kinds import serve
from portbench.model import dims_of, make_params

# requests by which the waiting queue may grow across a window and still
# count as steady
GROWTH = 3


def waiting(records, t: float) -> int:
    return sum(1 for r in records if r["due"] <= t
               and not (r["times"] and r["times"][0] <= t))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.find_cell(bench, args.workload)
    cfg = spec.load_config(bench, cell["config"])
    mix = spec.load_traffic(cell["traffic"])
    dev = torch.device(args.device)
    dm = dims_of(cfg)
    params = make_params(dm, args.seed, dev)
    engine, loop = serve.build(cfg, dm, params, dev)
    engine.capture_programs()
    serve.warm_up(loop, mix, dm.vocab, dm.max_seq, args.seed)
    for i, rate in enumerate(float(x) for x in args.rates.split(",")):
        m = dict(mix, rate_per_s=rate)
        reqs = traffic.generate(m, args.seed + i, args.seconds, dm.vocab)
        records = [{"index": r.index, "due": r.due, "prompt": r.prompt,
                    "max_new": r.max_new, "times": [], "tokens": [],
                    "status": "due"} for r in reqs]
        clients = serve.Clients(loop, records)
        t0 = time.perf_counter() + 0.05
        open_at = t0 + m["lead_in_s"]
        close_at = open_at + args.seconds
        sched = serve.open_loop(clients, t0, close_at)
        time.sleep(max(0.0, close_at - time.perf_counter()))
        clients.stopping.set()
        sched.join()
        late = [r["submit"] - r["due"] for r in records if "submit" in r]
        ttft = [v for v in stats.ttfts(records, open_at, close_at)]
        gaps = stats.inter_token_gaps(records, open_at, close_at)
        started = sum(1 for r in records
                      if r["times"] and open_at <= r["times"][0] <= close_at)
        print(json.dumps({
            "rate_per_s": rate,
            "waiting_at_open": waiting(records, open_at),
            "waiting_at_close": waiting(records, close_at),
            "started_per_s": started / args.seconds,
            "tokens_per_s": stats.tokens_in(records, open_at, close_at)
            / args.seconds,
            "ttft_p50_ms": stats.percentile(ttft, 50) * 1e3,
            "ttft_p95_ms": stats.percentile(ttft, 95) * 1e3,
            "itl_p50_ms": stats.percentile(gaps, 50) * 1e3,
            "itl_p95_ms": stats.percentile(gaps, 95) * 1e3,
            "late_p95_ms": stats.percentile(late, 95) * 1e3,
            "requests_due": len(ttft)}), flush=True)
        grew = waiting(records, close_at) - waiting(records, open_at)
        loop.wait_idle(600)
        clients.join(60)
        if grew > GROWTH:
            break
    loop.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
