"""The reductions behind the metric files: each takes the run record a
driver returns and gives one number, or None when the run holds nothing
to read for it. Shares are in percent."""
from __future__ import annotations

import math
from typing import Optional

from portbench import roofline, stats
from portbench.trace import kernel_seconds

PAGED_KERNEL = "paged_decode"


def _window(run):
    return run["window"]


def ttft_p95_ms(run) -> Optional[float]:
    """95th percentile of time to first token over the requests due in
    the window; one with no first token at the close counts as having
    waited until then and a whole window more."""
    t0, t1 = _window(run)
    vals = stats.ttfts(run["requests"], t0, t1)
    dues = [r["due"] for r in run["requests"] if t0 <= r["due"] < t1]
    vals = [v if math.isfinite(v) else (t1 - d) + (t1 - t0)
            for v, d in zip(vals, dues)]
    p = stats.percentile(vals, 95)
    return None if p is None else p * 1e3


def itl_p95_ms(run) -> Optional[float]:
    t0, t1 = _window(run)
    p = stats.percentile(stats.inter_token_gaps(run["requests"], t0, t1), 95)
    return None if p is None else p * 1e3


def output_tokens_per_s(run) -> Optional[float]:
    t0, t1 = _window(run)
    n = stats.tokens_in(run["requests"], t0, t1)
    return n / (t1 - t0) if n else None


def _delta(run, get) -> float:
    """``get(counters)`` summed over the window's untraced segments (a
    traced run's counters leave its profiled slice out)."""
    return sum(get(b) - get(a) for a, b in run["counters"])


def loop_host_ms(run) -> Optional[float]:
    """Host milliseconds a loop tick spends outside the device wait:
    assemble + dispatch + sample (which runs admissions' prefills) +
    bookkeep, over the window."""
    ticks = _delta(run, lambda c: c["ticks"])
    if ticks <= 0:
        return None
    host = _delta(run, lambda c: sum(
        c["phase"][p][1] for p in ("assemble", "dispatch", "sample",
                                   "bookkeep")))
    return host / ticks * 1e3


def _mean_ms(run, key) -> Optional[float]:
    n = _delta(run, lambda c: c[key][0])
    if n <= 0:
        return None
    return _delta(run, lambda c: c[key][1]) / n * 1e3


def tick_ms(run) -> Optional[float]:
    return _mean_ms(run, "tick")


def queue_wait_ms(run) -> Optional[float]:
    return _mean_ms(run, "queue")


def capture_s(run) -> Optional[float]:
    return run.get("capture_s") or None


def _decode_rows(run, t0, t1):
    """The live context of every decode row whose token
    arrived in [t0, t1]: a request's token j >= 1 came from the step that
    fed position plen + j - 1, so it attended plen + j keys."""
    for r in run["requests"]:
        plen = len(r["prompt"])
        for j, t in enumerate(r["times"]):
            if j and t0 <= t <= t1:
                yield plen + j


def serve_mfu(run) -> Optional[float]:
    """The least time the window's work could take on the card, over
    the window (its untraced segments): each decode tick reads the
    weights once and each row its K/V, each prompt is prefilled once; a
    tick's bound and a prefill's are each the larger of operations at
    the bf16 peak and bytes at HBM's."""
    dm = run["dims"]
    least = seconds = 0.0
    for a, b in run["counters"]:
        t0, t1 = a["at"], b["at"]
        ticks = b["dispatched"] - a["dispatched"]
        live = list(_decode_rows(run, t0, t1))
        seconds += t1 - t0
        if ticks <= 0 or not live:
            continue
        flops = roofline.token_flops(dm) * len(live) + \
            4 * dm.n_heads * dm.head_dim * dm.n_layers * sum(live)
        rows = len(live) / ticks
        nbytes = (roofline.weight_bytes(dm, roofline.experts_touched(dm, rows))
                  * ticks + roofline.kv_token_bytes(dm) * sum(live))
        least += ticks * roofline.least_s(flops / ticks, nbytes / ticks)
        for r in run["requests"]:
            if r["times"] and t0 <= r["times"][0] <= t1:
                least += roofline.least_s(
                    *roofline.prefill(dm, len(r["prompt"])))
    return least / seconds * 100 if least else None


def paged_attn_roofline(run) -> Optional[float]:
    """The paged kernel's least time over the live tokens of its calls
    in the traced slice (one call a layer and decode step), over its
    device time there."""
    tr = run.get("trace")
    dev = kernel_seconds(tr, PAGED_KERNEL)
    if dev is None:
        return None
    dm = run["dims"]
    bs = run["config"]["engine"]["kv_block_size"]
    t0, t1 = tr["host_window"]
    live = list(_decode_rows(run, t0, t1))
    if not live:
        return None
    flops, nbytes = roofline.paged_decode_work(
        live, h=dm.n_heads, h_kv=dm.n_kv_heads, d=dm.head_dim, bs=bs)
    return dm.n_layers * roofline.least_s(flops, nbytes) / dev * 100


def idle_share(run) -> Optional[float]:
    tr = run.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return (1.0 - tr["busy_s"] / tr["window_s"]) * 100


# -- training -------------------------------------------------------------

FLASH = {"fwd": "flash_fwd", "bwd_preprocess": "flash_bwd_pre",
         "bwd_dkdv": "flash_bwd_dkdv", "bwd_dq": "flash_bwd_dq"}
ADAMW = "adamw_kernel"


def train_tokens_per_s(run) -> Optional[float]:
    """Tokens of every step the window ran, over the window: from its
    open to the end of its last step."""
    steps = [s for s in run.get("steps", []) if not s[2]]
    if not steps or any(s[2] for s in run["steps"]):
        return None
    t0, t1 = run["window"]
    return len(steps) * run["tokens_per_step"] / (t1 - t0)


def train_mfu(run) -> Optional[float]:
    """A step's operations (6 a parameter and token plus causal
    attention; recomputation left out) at the bf16 peak, over the
    untraced steps' time."""
    steps = [s for s in run.get("steps", []) if not s[2]]
    if not steps:
        return None
    job = run["traffic"]
    flops = roofline.train_step_flops(run["dims"], job["batch"], job["seq"])
    busy = sum(b - a for a, b, _ in steps)
    return len(steps) * flops / roofline.BF16_FLOPS / busy * 100


def flash_roofline(run) -> Optional[float]:
    """The flash kernels' least time over their launches in the trace
    (each launch at the training shape: forward, and remat's forward
    again; preprocess, dK/dV and dQ), over their device time."""
    tr = run.get("trace")
    if not tr:
        return None
    dm, job = run["dims"], run["traffic"]
    work = roofline.flash_work(job["batch"], dm.n_heads, dm.n_kv_heads,
                               job["seq"], dm.head_dim)
    least = dev = 0.0
    for key, pattern in FLASH.items():
        names = [k for k in tr["kernels"] if pattern in k]
        n = sum(tr["launches"][k] for k in names)
        dev += sum(tr["kernels"][k] for k in names)
        least += n * roofline.least_s(*work[key])
    return least / dev * 100 if dev > 0 and least > 0 else None


def adamw_roofline(run) -> Optional[float]:
    """The adamw kernel's least time over the traced steps' updates
    (every leaf once a step), over its device time."""
    tr = run.get("trace")
    dev = kernel_seconds(tr, ADAMW)
    if dev is None:
        return None
    steps = sum(1 for s in run["steps"] if s[2])
    n = run.get("param_elements")
    return roofline.adamw_bytes(n) * steps / roofline.HBM_BYTES_PER_S \
        / dev * 100
