"""What decides ``correct`` for a served model: a sample of the finished
requests, drawn from the seed with the longest among them, run through
the plain reference over prompt + served tokens. At each served position
the gap is the reference's best logit minus its logit of the served
(greedy) token; the configuration's ``limits`` name the readings of
those gaps that are held (the widest, or the share above a threshold),
each with its limit."""
from __future__ import annotations

import random
from typing import List, Sequence

import torch

from portbench import reference
from portbench.model import Dims


def sample(requests: Sequence[dict], seed: int, tokens: int,
           sequences: int) -> List[dict]:
    """Finished requests: the longest (prompt + output), then others in
    a seeded order until ``tokens`` served tokens or ``sequences``."""
    done = [r for r in requests if r["status"] == "finished"]
    if not done:
        return []
    done.sort(key=lambda r: (len(r["prompt"]) + len(r["tokens"]), r["index"]))
    chosen = [done.pop()]
    random.Random(seed).shuffle(done)
    for r in done:
        if (sum(len(c["tokens"]) for c in chosen) >= tokens
                or len(chosen) >= sequences):
            break
        chosen.append(r)
    return chosen


def _inputs(chosen: Sequence[dict]):
    seqs = [list(r["prompt"]) + list(r["tokens"][:-1]) for r in chosen]
    starts = [len(r["prompt"]) - 1 for r in chosen]
    return seqs, starts


def _gap(ref: torch.Tensor, picks: torch.Tensor) -> torch.Tensor:
    """Per position: the reference's best logit minus its logit of the
    token picked there."""
    return ref.max(dim=-1).values - ref.gather(1, picks[:, None])[:, 0]


SHARES = (0.05, 0.1, 0.25, 0.5, 1.0)


def readings(gaps: torch.Tensor) -> dict:
    """The numbers a limit can hold over the per-position gaps: the
    widest ("logit_gap"), the share above each of ``SHARES``
    ("share_over_<t>"), and quantiles for the record."""
    g = gaps.float().sort().values
    n = g.numel()
    out = {"logit_gap": float(g[-1])}
    out.update({f"share_over_{t}": float((g > t).float().mean())
                for t in SHARES})
    out.update({f"p{p}": float(g[min(n - 1, int(p / 100 * n))])
                for p in (50, 90, 99)})
    return out


def served_gaps(params: dict, dm: Dims, chosen: Sequence[dict],
                controls: Sequence[str] = ()) -> dict:
    """{"program": ``readings`` of the served tokens' gaps, "tokens":
    served tokens compared, "sequences": n} and, for each precision in
    ``controls``, "control_<p>": the ``readings`` of the gaps of the
    tokens the reference in that precision puts first at the same
    positions."""
    if not chosen:
        return {"program": {}, "tokens": 0, "sequences": 0}
    seqs, starts = _inputs(chosen)
    ref = reference.logits(params, dm, seqs, starts)
    device = ref[0].device
    served = [torch.tensor(list(r["tokens"]), device=device) for r in chosen]
    out = {"program": readings(torch.cat([_gap(l, t)
                                          for l, t in zip(ref, served)])),
           "tokens": sum(len(t) for t in served),
           "sequences": len(chosen)}
    for prec in controls:
        ctl = reference.logits(params, dm, seqs, starts, quant=prec)
        out[f"control_{prec}"] = readings(torch.cat(
            [_gap(l, c.argmax(dim=-1)) for l, c in zip(ref, ctl)]))
        del ctl
    return out


def judge(program: dict, limits: dict) -> tuple:
    """({name: {"value", "limit"}} for each limit the configuration
    states, correct): every reading at or under its limit; no limit, or
    no reading, is not correct."""
    checks = {k: {"value": program.get(k), "limit": v}
              for k, v in limits.items()}
    ok = bool(checks) and all(c["value"] is not None
                              and c["value"] <= c["limit"]
                              for c in checks.values())
    return checks, ok
