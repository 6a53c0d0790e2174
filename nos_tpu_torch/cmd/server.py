"""nos-tpu-torch-server — the serving binary on the card: the
continuous-batching engine (``models/serving.py``) behind the
reference's HTTP API (port of ``nos_tpu/cmd/server.py``: the colocated,
prefill and decode roles).

    POST /v1/generate   {"prompt": [ids], "max_new_tokens": N,
                         "temperature": T?, "top_k": K?, "top_p": P?,
                         "seed": S?, "stop_tokens": [ids]?,
                         "stream": bool?, "tenant": str?,
                         "kv_sources": [{"url", "digest"}]?}
                        -> {"tokens": [full sequence]}, or SSE frames
    GET  /v1/kvchain/D  one prefix chain's codec payload by digest
                        (the fleet's fabric token in the header)
    POST /v1/handoff    (role=decode) adopt one encoded KV handoff
                        -> {"rid": N}
    GET  /v1/result/N   (role=decode) the adopted request's full
                        sequence; GET /v1/stream/N streams it as SSE
    POST /admin/drain   begin graceful drain (stop admitting, flip
                        /readyz)
    POST /admin/undrain revert a drain (resume admitting)
    GET  /healthz       -> ok          GET /readyz  -> ok | draining
    GET  /metrics       Prometheus text (OpenMetrics + exemplars when
                        Accept asks for it)
    GET  /stats         live JSON snapshot: slots, queue, KV blocks,
                        SLO/goodput, rolling rates, tick phases
    GET  /debug/traces  tracing flight recorder
    GET  /debug/profile Chrome trace of the last decode ticks' phases

Requests batch continuously: concurrent POSTs share the engine's decode
ticks, each blocking only until its own slot completes. The ticker runs
the engine's one blocking wait (``step_wait``, a CUDA event) outside the
loop's lock, so handlers submit, stream and cancel while the card
computes; every wait of a handler is on the loop's condition. With
``--pipeline-depth k`` and ``--decode-steps T`` a tick is T fused
decode steps, one CUDA graph replay on the card, and up to k of them
are in flight, so SSE frames coarsen to about k x T tokens, as the
reference's do.

Usage:
    python -m nos_tpu_torch.cmd.server --kv-blocks 1025 \\
        --kv-block-size 16 --port 8000

``--prefix-cache-size``, ``--prefill-chunk`` and ``--prefill-budget``
serve as the reference's engine knobs do (a request's ``cache_prefix``
publishes its prompt to the prefix cache); ``--kv-swap off`` resumes a
preempted slot by recompute instead of swap. ``--role prefill`` answers
each request with a handoff descriptor after its first token, once the
KV handoff has been shipped round-robin to ``--decode-pool``;
``--role decode`` adopts handoffs (the same wire bytes as the
reference's, so the two frameworks serve either end of a pair).
``--kv-host-tier-bytes`` keeps a host-RAM tier under the arena for
demoted prefix chains; ``--kv-fabric-token`` opens the KV fabric
between replicas sharing the secret (``GET /v1/kvchain/<digest>``
serves a chain, a POST carrying ``kv_sources`` pulls one before it
prefills); ``--tenant-config`` turns on tenant quotas (429
``reason: tenant_quota``, reclaim, scoped prefix chains, and with SLO
objectives the ``slo_budget`` and ``chip_ledger`` sections of /stats).
With the reference's defaults (``kv_blocks`` 0) the binary serves the
slot-static engine; ``--kv-blocks`` > 0 serves the paged one.
``build_engine`` validates a config with the reference's messages
before any weights are made; ``--tp`` serves every engine (the MoE
family, a draft) tensor-parallel over the first tp visible cards.
``--checkpoint-dir`` serves a trainer's checkpoint (the port's format,
``train/checkpoint.py``; the stamp is validated first), and
``--draft-checkpoint-dir`` turns on speculative decoding with the draft
model restored from its checkpoint at the config's draft widths
(``models.spec_serving.SpeculativeDecodeServer``), as the reference's
binary does.
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import threading
import time
from collections import deque
from dataclasses import dataclass, fields
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import torch

from nos_tpu_torch.cmd.serve import metrics_payload
from nos_tpu_torch.device import DeviceLike, resolve_device
from nos_tpu_torch.kvfabric import FABRIC_TOKEN_HEADER, HostTierStore
from nos_tpu_torch.models.errors import (
    DeadlineExceeded, DeadlineUnmeetable, EngineRecovering, Infeasible,
    QueueFull,
)
from nos_tpu_torch.models.supervision import EngineSupervisor
from nos_tpu_torch.models.tenantquota import (
    TenantQuotaConfig, validate_tenant_name,
)
from nos_tpu_torch.obs import tracing
from nos_tpu_torch.obs.tracing import device_range
from nos_tpu_torch.obs.slo import (
    IDLE_TENANT, SloBudgetEngine, objectives_from_quota,
)
from nos_tpu_torch.ops.attention import check_paged_kernel_head_dim
from nos_tpu_torch.utils.metrics import default_registry

logger = logging.getLogger("nos_tpu_torch.server")

def observability_flags(parser: argparse.ArgumentParser) -> None:
    """The shared structured-logging + tracing flags
    (``nos_tpu/cmd/serve.py::observability_flags``)."""
    parser.add_argument(
        "--log-format", choices=("text", "json"), default="text",
        help="log line format; json emits one object per line with "
             "trace_id/span_id injected when a tracing span is active",
    )
    parser.add_argument(
        "--trace-sampling", type=float, default=None,
        help="fraction of new pod-journey traces to record (0 disables, "
             "1 records all; default from NOS_TPU_TRACE_SAMPLING or 1.0)",
    )
    parser.add_argument(
        "--trace-recorder-size", type=int, default=None,
        help="flight-recorder capacity: recently completed traces kept "
             "in memory for /debug/traces (default 256)",
    )
    parser.add_argument(
        "--trace-slow-threshold", type=float, default=None,
        help="seconds over which a completed span pins its whole trace "
             "in the flight recorder (default 1.0)",
    )


# terminal request outcomes: every request that enters the serving loop
# leaves through exactly ONE of these, incrementing
# nos_tpu_serve_requests_total{outcome} exactly once (pinned by tests).
# ``deadline`` covers both shed-at-admission (rolling estimates said the
# deadline could not be met) and cancelled-mid-flight expiry.
OUTCOMES = ("finished", "cancelled", "abandoned", "rejected", "failed",
            "deadline")

# TTFT spans prefill (ms on warm buckets) through queueing storms (s);
# TPOT is per-token (sub-ms fused to ~100ms on big models); compiles
# (none in eager torch; the buckets are the reference's) run seconds to
# minutes
TTFT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                5.0, 10.0, 30.0)
TPOT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0)
COMPILE_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                   120.0, 300.0)

# rolling-rate window for the /stats snapshot
RATE_WINDOW_S = 60.0

# decode-tick phases, in tick order: assemble (admission + batch
# assembly inside step_begin), dispatch (device dispatch of the decode
# program), wait (host blocked on the in-flight step + result fetch),
# sample (consume/commit in step_finish), bookkeep (ledger, rates,
# gauges, deadline sweep). Non-split engines can't separate the first
# four — their whole step lands under ``dispatch``.
TICK_PHASES = ("assemble", "dispatch", "wait", "sample", "bookkeep")

# sub-ms phase buckets: a healthy pipelined tick spends microseconds on
# its host phases, so the default request-scale buckets would flatline
TICK_PHASE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                      0.01, 0.025, 0.05, 0.1, 0.25, 1.0)

# bound on the recovery capture phase: swap snapshots are device->host
# copies that can HANG (not just raise) on a lost device — the capture
# runs on a helper thread joined with this timeout, and on expiry the
# recovery falls back to a host-only capture (every slot resumes by
# recompute). Capture is read-only, so the abandoned hung thread races
# nothing.
CAPTURE_TIMEOUT_S = 10.0

# deadline-shed probe cadence: every Nth CONSECUTIVE estimate-based
# shed is admitted anyway. The EWMA estimates only update on completed
# requests, so an estimate inflated past every deadline would otherwise
# shed 100% of traffic forever (zero admissions -> zero completions ->
# no estimate decay); the probe's completion is the decay path.
DEADLINE_PROBE_EVERY = 8


@dataclass
class ServerConfig:
    # model (must match the checkpoint's training config)
    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 0
    d_ff: int = 1408
    max_seq: int = 512
    n_experts: int = 0
    bf16: bool = True
    checkpoint_dir: str = ""
    int8: bool = False
    # serving
    max_batch: int = 8
    # admission bound (0 = unbounded): beyond max_batch active slots, at
    # most this many requests wait; past it, POST /v1/generate answers
    # 429 so clients shed load instead of queueing into timeouts
    max_pending: int = 0
    # tensor-parallel serving: split params (transformer.shard_params,
    # int8 scales with their weights) and the KV cache (KV heads over
    # tp; a paged arena splits the same head axis, scale planes
    # included) across the first ``tp`` visible CUDA devices
    # (parallel.mesh.TpMesh; ``build_engine(device="cpu")`` puts every
    # shard on the CPU). 0/1 = single device. Sampling decisions run on
    # the gathered f32 logit row, so the sampled stream is the single-
    # device one; requires kv_heads % tp == 0 (and the draft's kv heads
    # under a draft, whose params and arena split in lockstep); the MoE
    # family splits each expert's d_ff.
    tp: int = 0
    # prefill/decode disaggregation role: "colocated" (default — one
    # engine prefills and decodes), "prefill" (requests leave after
    # their first token as a KV handoff shipped to a decode replica;
    # requires kv_blocks > 0 and a decode_pool), "decode" (adopts
    # handoffs via POST /v1/handoff and serves /v1/result//v1/stream;
    # requires kv_blocks > 0 with the SAME kv_block_size/kv_dtype/
    # model geometry as its prefill peers — restore validates and
    # rejects mismatches). int8 KV halves the handoff bytes over DCN.
    # The gateway routes new requests to prefill replicas and streams
    # from the decode replica after handoff.
    role: str = "colocated"
    # comma-separated decode-replica base URLs a prefill-role server
    # round-robins its handoffs across (e.g.
    # "http://decode-0:8000,http://decode-1:8000"); required (non-empty)
    # when role=prefill, ignored otherwise
    decode_pool: str = ""
    # pusher health memory: after a failed handoff push the target
    # decode replica is skipped for this many seconds before the
    # round-robin retries it (0 disables — every push re-probes dead
    # replicas and eats the connect timeout on the serving thread).
    # Skips are counted in nos_tpu_serve_handoff_skipped_total; if the
    # whole pool is cooling down the pusher ignores the cooldown
    # rather than dropping the handoff
    handoff_cooldown_s: float = 5.0
    # prefill-side decode-pool health view (role=prefill; 0 = off): at
    # most every this-many seconds the handoff pusher refreshes a
    # health snapshot of the decode pool from each target's /stats
    # (queue depth, draining/recovering flags) and prefers healthy,
    # least-loaded replicas — a draining replica is skipped BEFORE the
    # first failed attempt instead of being discovered by one. Off,
    # the pusher is the blind round-robin with only the failure
    # cooldown above.
    handoff_health_interval_s: float = 0.0
    # prefix cache (0 = off). Slot-static KV: ENTRIES — each holds one
    # prompt's KV on device (flagship: ~64 MB per 1k tokens). Paged KV
    # (kv_blocks > 0): BLOCKS — the budget for block-granular prefix
    # chains shared by refcount, so size it in units of kv_block_size
    # tokens (a 512-token system prompt at kv_block_size=16 needs 32).
    prefix_cache_size: int = 0
    # chunked prefill (0 = off): power-of-two chunk size; a long
    # prompt's prefill interleaves with decode ticks one chunk per tick,
    # bounding the latency hit admission inflicts on active requests
    # (under speculative decoding the draft cache chunks alongside the
    # target: one target chunk + one cheap draft chunk per tick).
    prefill_chunk: int = 0
    # per-tick chunked-prefill budget in prompt tokens (0 = the
    # unconditional one-chunk-per-tick rule; requires prefill_chunk):
    # each decode tick the engine spends at most this many prompt
    # tokens on chunk forwards, picking WHICH chunked admissions
    # advance by deadline slack (EDF on estimated TTFT; the budget
    # clamps to zero while any decode slot's TPOT slack is negative),
    # so N concurrent long prompts can no longer multiply every decode
    # tick by N chunk forwards. Outputs stay token-identical to the
    # unbudgeted run for every budget (scheduling changes WHEN a chunk
    # runs, never its contents). Config-echoed for fleet drift
    # detection; see docs/workload-plane/performance-tuning.md
    # "Stall-free colocated serving".
    prefill_budget: int = 0
    # pipelined decode dispatch: up to this many decode ticks in flight
    # before the host blocks on a token fetch (1 = host-serial). Greedy
    # outputs stay bit-identical to generate() at any depth; streaming
    # granularity coarsens to ~depth*decode_steps tokens per SSE frame.
    # The speculative engine pins this to 1 (its verify burst already
    # amortizes dispatch overhead).
    pipeline_depth: int = 1
    # fused multi-step decode: this many decode steps compiled into ONE
    # dispatch (lax.scan), [batch, decode_steps] tokens per device sync.
    # Pays in decode-bound phases; 1 = off. Pinned to 1 under
    # speculative decoding.
    decode_steps: int = 1
    # paged KV cache (kv_blocks > 0 = on): KV lives in one pooled HBM
    # arena of kv_blocks x kv_block_size tokens mapped per slot by
    # block tables, instead of max_batch x max_seq worst-case rows —
    # concurrency is then bound by tokens in use, with COW
    # block-granular prefix sharing and memory-aware admission.
    # kv_block_size must be a power of two >= 8 dividing max_seq.
    # Budget: kv_blocks * kv_block_size tokens of KV resident; size it
    # to HBM after weights (docs/workload-plane/performance-tuning.md
    # "Paged KV cache"). Pinned off under speculative decoding.
    kv_block_size: int = 0
    kv_blocks: int = 0
    # under block-pool pressure the lowest-priority slot is preempted:
    # kv_swap true = swap its KV to host RAM and restore byte-exact;
    # false = drop the KV and recompute it from the tokens on resume
    # (no host RAM, more FLOPs). Both are bit-exact.
    kv_swap: bool = True
    # paged-KV storage dtype: bf16 (the model dtype) or int8 —
    # quantized on the paged scatter with per-block scales, dequantized
    # on the gather. int8 roughly halves KV bytes per token, so a fixed
    # HBM budget holds ~2x the blocks and sustains ~2x the concurrent
    # slots; greedy serving stays self-consistent (token-identical to a
    # reference generate through the same int8 KV path — tested), at a
    # small bounded numeric delta vs bf16. Requires kv_blocks > 0: the
    # slot-static engine has no per-block scale storage and the server
    # rejects the combination with a clear error.
    kv_dtype: str = "bf16"
    # paged attention formulation: "on" = the hand-written CUDA kernel
    # (ops.attention.paged_decode_attention, csrc/), "off" = the gather
    # formulation, the escape hatch and the parity oracle. Passed to the
    # engine as its paged_impl (nothing is written to the environment).
    # Inert without kv_blocks.
    paged_kernel: str = "on"
    # HBM backstop on admission (0 = off): defer admitting while
    # device bytes_in_use / bytes_limit exceeds this fraction, per the
    # same memory_stats() the HBM gauges sample (backends without
    # memory stats skip the check)
    kv_hbm_admit_frac: float = 0.95
    # host-RAM KV tier (0 = off): bytes of host RAM bounding
    # the kvfabric HostTierStore under the HBM arena. With it on,
    # prefix-chain eviction under block pressure DEMOTES the LRU
    # chain's swap payload (quantized bytes + scales) to host RAM
    # instead of dropping it, and a later prefix miss that matches the
    # stored chain PROMOTES it back bit-exactly — re-prefill chip-
    # seconds traded for one host-RAM round trip. Requires kv_blocks
    # AND prefix_cache_size > 0 (the tier stores prefix chains, which
    # only the paged prefix index produces); the store empties on a
    # supervised engine rebuild (host RAM is replica-local state, not
    # durable). Size it a few multiples of the hot system prompts'
    # payload bytes; the demotion ladder is HBM -> host -> drop.
    kv_host_tier_bytes: int = 0
    # shared fleet secret gating the KV fabric's HTTP surfaces ("" =
    # fabric HTTP disabled): a replica only HONORS a kv_sources
    # peer-pull offer and only SERVES GET /v1/kvchain/<digest> when
    # the request carries this value in the X-NOS-KV-Fabric-Token
    # header. kv_sources steers the replica's outbound fetcher and
    # seeds its prefix cache, and chain digests are public arithmetic
    # over scope + tokens — without the gate, any client reaching the
    # serving port gets blind SSRF, cross-tenant KV exfiltration and
    # prefix-cache poisoning. Set the SAME value on every replica and
    # on the gateway (--kv-fabric-token); the host tier itself
    # (demote/promote on this replica) needs no token.
    kv_fabric_token: str = ""
    # speculative decoding (draft_checkpoint_dir set = on): a smaller
    # draft model proposes draft_n_tokens per tick, the target verifies
    # them in one wide forward. Greedy requests stay bit-identical to
    # plain decoding; sampled requests keep the exact target
    # distribution (accept-reject). The speculative engine rides the
    # FULL dispatch template: pipeline_depth/decode_steps/paged-KV/
    # kv_dtype all apply (a fused dispatch commits up to
    # decode_steps * draft_n_tokens tokens per slot, accept/reject
    # resolves in-graph so pipelined windows never wait on the host).
    # Draft dims below must match the draft checkpoint's training
    # config.
    draft_checkpoint_dir: str = ""
    draft_d_model: int = 256
    draft_n_layers: int = 2
    draft_n_heads: int = 4
    draft_n_kv_heads: int = 0
    draft_d_ff: int = 704
    draft_n_tokens: int = 4
    default_max_new_tokens: int = 64
    port: int = 8000
    seed: int = 0
    log_level: str = "info"
    # request-level SLO targets (0 = unset): a completed request meets
    # its SLO when TTFT (submit -> first token observed) and mean TPOT
    # (inter-token, first token excluded) are within these bounds.
    # Feeds nos_tpu_serve_slo_total{slo,outcome} and the goodput gauge;
    # a breach pins the request's trace in the flight recorder.
    slo_ttft_ms: float = 0.0
    slo_tpot_ms: float = 0.0
    # per-tenant SLO error budgets (active only when the
    # tenant config below carries ``slo`` objectives): SRE
    # multi-burn-rate windows — the fast window pages/trips breach
    # capture, the slow window measures budget remaining. A fast-window
    # burn at/over the threshold emits an slo.breach span and pins the
    # breaching request's trace, at most once per capture interval per
    # (tenant, objective).
    slo_fast_window_s: float = 300.0
    slo_slow_window_s: float = 3600.0
    slo_burn_threshold: float = 14.4
    slo_capture_interval_s: float = 300.0
    # request-level elastic quota (empty = off): per-tenant token-rate
    # min/max with borrowing — a file path or inline JSON (see
    # models/tenantquota.TenantQuotaConfig). With it set, requests
    # carry a tenant (JSON field ``tenant`` / header ``X-Tenant``;
    # unlabeled traffic is the default tenant), admission is the
    # weighted tenant pick instead of FIFO, a guaranteed tenant
    # reclaims slots by bit-exact preemption (paged engines), tenants
    # at/over max shed 429 reason=tenant_quota under contention, and
    # the prefix cache is tenant-scoped (share_prefix opts out).
    tenant_config: str = ""
    # device-runtime telemetry cadence (seconds; 0 disables): samples
    # device.memory_stats() into the HBM gauges at most this often —
    # guarded, so backends without memory stats (CPU) just skip.
    device_stats_interval_s: float = 10.0
    # supervised engine restarts (0 = off, engine failure is terminal as
    # before): on a decode-tick failure the serving loop captures every
    # live request's resumable state (committed tokens; swap-to-host KV
    # snapshot on a paged engine, recompute re-prefill otherwise — both
    # bit-exact), rebuilds the engine (fresh compile) after exponential
    # backoff + jitter, and re-admits the captured requests at the
    # front of the queue. The budget bounds TOTAL rebuild attempts over
    # the process lifetime; once exhausted, the next failure is
    # terminal (/healthz flips) and orchestration restarts the pod.
    restart_budget: int = 2
    restart_backoff_s: float = 0.5
    restart_backoff_max_s: float = 10.0
    # stuck-tick watchdog (0 = off): a dispatched decode tick blocked
    # in its device wait longer than this with no arrival consumed
    # counts as an engine failure and takes the same supervised-restart
    # path (the blocked thread is superseded and exits when it
    # unblocks). Dispatch-time compiles do NOT count — the clock
    # arms after dispatch returns — so size it above the slowest
    # expected device WAIT, not compile time.
    watchdog_s: float = 0.0
    # default per-request deadline in seconds (0 = none): a request
    # must finish within this budget of submission or it is shed at
    # admission (rolling TTFT/TPOT estimates say it cannot make it —
    # 429 + Retry-After) or cancelled at the next tick barrier
    # (terminal outcome ``deadline``, HTTP 504). Per-request override:
    # JSON field ``deadline_s`` / header ``X-Request-Deadline-S``.
    default_deadline_s: float = 0.0
    # SIGTERM → stop admitting (503 + readyz flips so the Service pulls
    # this endpoint), let in-flight requests finish up to this budget,
    # then exit — the Kubernetes termination contract. Keep it under
    # the pod's terminationGracePeriodSeconds.
    drain_timeout_s: float = 30.0
    # per-socket read/write timeout. daemon_threads=False means process
    # exit JOINS handler threads; without a socket timeout a thread
    # blocked reading a stalled client's request body would outlive the
    # drain budget indefinitely (only SIGKILL would end it). Any blocking
    # socket op now fails within this bound, so exit is bounded by
    # drain_timeout_s + socket_timeout_s.
    socket_timeout_s: float = 30.0

    @classmethod
    def from_yaml_file(cls, path: str) -> "ServerConfig":
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        known = {f.name for f in fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(
                f"{path}: unknown server config keys {sorted(unknown)}")
        return cls(**data)


class DrainingError(RuntimeError):
    """Submission refused because the server is draining for termination
    (its own error type so the HTTP layer can answer 503, not 500)."""


class ServingLoop:
    """Thread-safe wrapper around DecodeServer: handlers submit and wait;
    one background thread ticks the engine whenever there is work.

    With an ``engine_factory`` and restart budget, a tick failure (a
    CUDA error, device loss, a wedged allocator) is not terminal: the
    loop captures every live request's resumable state from the dead
    engine, releases the dead engine's device memory, rebuilds it
    through the factory (exponential backoff + seeded jitter between
    attempts), and re-admits the captured requests at the front of the
    fresh queue: swap-restored byte for byte, or re-prefilled by
    recompute, so a greedy request's tokens are the undisturbed run's.
    A request the capture misses or the restore refuses is accounted
    ``failed`` exactly once. While recovery is in flight, submissions
    get ``EngineRecovering`` (HTTP 503 + Retry-After) and /readyz
    reports ``degraded``; /healthz flips only on TERMINAL failure. A
    stuck-tick watchdog (``watchdog_s``) counts a tick in flight past the
    threshold as a failure and takes the same path. The faults it
    recovers from are those a rebuilt engine can get past: a sticky CUDA
    error poisons the process's CUDA context, and the rebuild then fails
    too, which ends in the terminal path.

    Requests may carry a deadline (``deadline_s``; ``default_deadline_s``
    otherwise): unmeetable deadlines are shed at admission against
    rolling TTFT/TPOT estimates, and expired ones are cancelled at the
    next tick barrier — either way the request's one terminal outcome
    is ``deadline``.

    Disaggregation: a ``role="prefill"`` loop answers each request with
    a handoff descriptor once a pusher thread has shipped its KV
    (``handoff_send``, round-robin over ``handoff_targets`` with a
    failure cooldown and an optional /stats health view); a
    ``role="decode"`` loop adopts handoffs (``adopt``) and serves them
    through ``result``/``watch``, cancelling one whose consumer never
    attaches within ``adopt_ttl_s``.

    Tenancy (``tenant_quota``): per-tenant token, shed, preempt,
    goodput and borrowed-rate series, and, with SLO objectives in the
    config, the per-(tenant, objective) error budgets
    (``SloBudgetEngine``) and the engine's chip-second ledger mirrored
    into cumulative totals that survive a supervised rebuild. The KV
    fabric (``fabric_token``): ``export_chain`` serves a chain by digest
    to a peer (the lookup and the copy's enqueue under the lock, the
    wait and encoding outside it), and ``prefetch_chain`` pulls a
    gateway-offered chain before a request submits: fetched outside the
    lock, single-flight per digest, ingested under it."""

    def __init__(self, engine, slo_ttft_ms: float = 0.0,
                 slo_tpot_ms: float = 0.0,
                 device_stats_interval_s: float = 0.0,
                 engine_factory=None, restart_budget: int = 2,
                 restart_backoff_s: float = 0.5,
                 restart_backoff_max_s: float = 10.0,
                 watchdog_s: float = 0.0,
                 default_deadline_s: float = 0.0, seed: int = 0,
                 config_echo: Optional[dict] = None,
                 tenant_quota: Optional[TenantQuotaConfig] = None,
                 role: str = "colocated",
                 handoff_targets: Optional[list] = None,
                 handoff_send=None,
                 handoff_cooldown_s: float = 5.0,
                 handoff_health_interval_s: float = 0.0,
                 adopt_ttl_s: float = 600.0,
                 fabric_token: str = "",
                 slo_fast_window_s: float = 300.0,
                 slo_slow_window_s: float = 3600.0,
                 slo_burn_threshold: float = 14.4,
                 slo_capture_interval_s: float = 300.0,
                 slo_min_events: int = 10,
                 slo_clock=None):
        reg = default_registry()
        # register() is idempotent per (name, type, labels) and raises on
        # a mismatched re-registration — exactly what we want at startup
        self.m_requests = reg.counter(
            "nos_tpu_serve_requests_total",
            "Requests leaving the serving loop, by terminal outcome "
            "(finished | cancelled | abandoned | rejected | failed); "
            "every request increments exactly one outcome exactly once",
            ("outcome",))
        self.m_tokens = reg.counter(
            "nos_tpu_serve_tokens_total", "Tokens emitted by decode ticks")
        self.m_ticks = reg.counter(
            "nos_tpu_serve_ticks_total", "Decode ticks executed")
        self.g_active = reg.gauge(
            "nos_tpu_serve_active_slots", "Slots decoding right now")
        self.g_pending = reg.gauge(
            "nos_tpu_serve_pending_requests",
            "Requests waiting for a slot")
        self.m_prefix_hits = reg.gauge(
            "nos_tpu_serve_prefix_hits",
            "Prefill requests served from the prefix cache")
        self.m_prefix_saved = reg.gauge(
            "nos_tpu_serve_prefix_tokens_saved",
            "Prompt tokens whose prefill was skipped via the prefix cache")
        # per-tick economics: service time is the whole quantum
        # (dispatch + wait + bookkeeping); the dispatch gap mirrors the
        # engine's dispatch_gap_s — time with NO decode tick in flight
        # while decodable slots existed, i.e. the card host-blocked
        self.h_tick = reg.histogram(
            "nos_tpu_serve_tick_seconds",
            "Serving-loop tick service time (dispatch + wait + host "
            "bookkeeping)")
        self.h_gap = reg.histogram(
            "nos_tpu_serve_dispatch_gap_seconds",
            "Per-tick dispatch gap: time the engine had no decode tick "
            "in flight while decodable slots existed (the accelerator "
            "host-blocked behind bookkeeping)")
        # decode-tick phase profiler: assemble, dispatch, wait, sample,
        # bookkeep, derived from the clock reads the loop already takes
        self.h_tick_phase = reg.histogram(
            "nos_tpu_serve_tick_phase_seconds",
            "Serving-loop tick time decomposed by phase",
            labelnames=("phase",), buckets=TICK_PHASE_BUCKETS)
        for _ph in TICK_PHASES:
            self.h_tick_phase.labels(_ph)
        # rolling per-tick phase samples for /stats and /debug/profile:
        # (tick start on the tracer's clock, {phase: seconds})
        self._tick_phases: deque = deque(maxlen=256)
        # the request path's waits: the loop's lock, asked for by a
        # submitting entry (stream, prefill, adopt) or by the ticker (a
        # quantum's first acquisition with work waiting, and the
        # re-acquisition after the device wait, which ``sample`` holds
        # too); each prefill's seconds; the engine's first-token stamp
        # to the stream's first yield of it
        self.h_lock_wait = reg.histogram(
            "nos_tpu_serve_lock_wait_seconds",
            "Time from asking for the serving loop's lock to holding it, "
            "by waiter (submit | ticker)",
            labelnames=("waiter",), buckets=TICK_PHASE_BUCKETS)
        self._submit_wait = self.h_lock_wait.labels("submit")
        self._ticker_wait = self.h_lock_wait.labels("ticker")
        self.h_prefill = reg.histogram(
            "nos_tpu_serve_prefill_seconds",
            "Per prefill (a resume's included): prefill start -> end on "
            "the engine's ledger (admission -> first token on the host "
            "for an eager prefill)")
        self.h_first_delivery = reg.histogram(
            "nos_tpu_serve_first_token_delivery_seconds",
            "Engine's first-token stamp -> the stream's first yield of "
            "that token", buckets=TICK_PHASE_BUCKETS)
        # request-level latency ledger surface (engine stamps, this loop
        # observes at completion; buckets carry trace exemplars of the
        # request's serve.request span when sampled)
        self.h_queue = reg.histogram(
            "nos_tpu_serve_queue_seconds",
            "Submit -> admitted-to-slot wait per request")
        self.h_ttft = reg.histogram(
            "nos_tpu_serve_ttft_seconds",
            "Time to first token: submit -> first token observed on the "
            "host (includes queueing and prefill)",
            buckets=TTFT_BUCKETS)
        self.h_tpot = reg.histogram(
            "nos_tpu_serve_tpot_seconds",
            "Time per output token (inter-token, first token excluded); "
            "tokens observed in one arrival share the arrival gap evenly",
            buckets=TPOT_BUCKETS)
        self.h_e2e = reg.histogram(
            "nos_tpu_serve_e2e_seconds",
            "Submit -> terminal per request (finished or cancelled)")
        self.m_slo = reg.counter(
            "nos_tpu_serve_slo_total",
            "Completed requests judged against the configured SLO "
            "targets, by slo (ttft | tpot) and outcome (met | breached)",
            ("slo", "outcome"))
        self.g_goodput = reg.gauge(
            "nos_tpu_serve_goodput_ratio",
            "Fraction of completed requests meeting every configured "
            "SLO target (0 until the first completion; absent when no "
            "SLO is configured)")
        # paged-KV block pool (registered only when the engine pages)
        self._preempt_seen = {"swap": 0, "recompute": 0}
        if getattr(engine, "paged", False):
            self.g_kv_free = reg.gauge(
                "nos_tpu_serve_kv_blocks_free",
                "Paged-KV blocks currently unreferenced (admission "
                "headroom)")
            self.g_kv_used = reg.gauge(
                "nos_tpu_serve_kv_blocks_used",
                "Paged-KV blocks referenced by at least one holder "
                "(slot tables + prefix index)")
            self.g_kv_shared = reg.gauge(
                "nos_tpu_serve_kv_blocks_cow_shared",
                "Paged-KV blocks referenced by MORE than one holder — "
                "each is a cache copy COW sharing avoided")
            self.m_preempt = reg.counter(
                "nos_tpu_serve_preempt_total",
                "Slots preempted under KV block pressure, by mode "
                "(swap = KV swapped to host and restored byte-exact; "
                "recompute = KV re-prefilled from the tokens)",
                ("mode",))
            for mode in ("swap", "recompute"):
                self.m_preempt.labels(mode).inc(0)
        # prefix-chain evictions and the KV fabric, registered whenever
        # the engine has a prefix index (a replica serves and adopts
        # peer chains without a host tier of its own). Engine-side
        # events mirror as deltas of the engine's counts; pull_hit,
        # pull_miss and pull_denied are counted here in prefetch_chain.
        self._prefix_evict_seen = {"drop": 0, "demote": 0}
        self._fabric_seen = {"demote": 0, "promote": 0}
        if getattr(engine, "_pindex", None) is not None:
            self.m_prefix_evict = reg.counter(
                "nos_tpu_serve_prefix_evict_total",
                "Prefix chains evicted from the HBM index under block "
                "pressure, by tier (drop = thrown away — the next hit "
                "re-prefills; demote = swap payload captured into the "
                "host-RAM KV tier for bit-exact promotion later)",
                ("tier",))
            for tier in ("drop", "demote"):
                self.m_prefix_evict.labels(tier).inc(0)
            self.m_kvfabric = reg.counter(
                "nos_tpu_serve_kvfabric_total",
                "KV-fabric tier transitions, by event (demote = chain "
                "captured into the host tier instead of dropped; "
                "promote = chain scattered back into the arena on a "
                "prefix miss, bit-exact; pull_hit / pull_miss = "
                "gateway-offered peer chains adopted vs failed/"
                "rejected; pull_denied = kv_sources offers without "
                "the fleet's fabric token, never honored)",
                ("event",))
            for ev in ("demote", "promote", "pull_hit", "pull_miss",
                       "pull_denied"):
                self.m_kvfabric.labels(ev).inc(0)
        # speculative decoding, registered only on a speculative engine:
        # proposals drafted and accepted (their ratio is the live
        # acceptance rate) and the accepted count of each verify window
        self._spec_seen = {"drafted": 0, "accepted": 0}
        if hasattr(engine, "spec_drafted"):
            self.m_spec_draft = reg.counter(
                "nos_tpu_serve_spec_draft_total",
                "Draft-model proposals submitted to verify windows "
                "(n_draft per round per active slot)")
            self.m_spec_accepted = reg.counter(
                "nos_tpu_serve_spec_accepted_total",
                "Draft proposals accepted by target verification; "
                "divided by nos_tpu_serve_spec_draft_total this is the "
                "live acceptance rate")
            self.h_spec_window = reg.histogram(
                "nos_tpu_serve_spec_accepted_per_window",
                "Accepted proposals per verify window (0..n_draft); "
                "mass near n_draft means speculation is paying, mass "
                "at 0 means the draft is guessing wrong",
                buckets=(0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0))
            self.m_spec_draft.inc(0)
            self.m_spec_accepted.inc(0)
        # request-level elastic quota, registered only with tenancy on;
        # labels are the CONFIGURED tenant names (unknown wire tenants
        # resolve to the default tenant)
        self._tenant_cfg = tenant_quota
        self._tenant_of: dict = {}          # loop rid -> tenant label
        self._tenant_goodput: dict = {}     # label -> [judged, good]
        self._tenant_preempt_seen: dict = {}
        if tenant_quota is not None:
            self.m_tenant_tokens = reg.counter(
                "nos_tpu_serve_tenant_tokens_total",
                "Output tokens delivered per tenant — the goodput "
                "numerator the quota's min/max rates govern",
                ("tenant",))
            self.m_tenant_shed = reg.counter(
                "nos_tpu_serve_tenant_shed_total",
                "Admission sheds per tenant by machine-readable reason "
                "(tenant_quota = the tenant is at/over its own max "
                "token-rate under contention; queue_full / "
                "hbm_admission / deadline_unmeetable = the shared "
                "capacity reasons, attributed to the tenant that hit "
                "them)",
                ("tenant", "reason"))
            self.m_tenant_preempt = reg.counter(
                "nos_tpu_serve_tenant_preempt_total",
                "Slots preempted per (victim) tenant by mode (swap | "
                "recompute) — quota reclaim for a guaranteed tenant "
                "and block-pool pressure both count; every preemption "
                "resumes bit-exactly",
                ("tenant", "mode"))
            self.g_tenant_goodput = reg.gauge(
                "nos_tpu_serve_tenant_goodput_ratio",
                "Per-tenant goodput: finished-and-SLO-met requests "
                "over all server-judged terminal outcomes (finished, "
                "failed, deadline — client cancels excluded); with no "
                "SLO configured, finished requests count as good",
                ("tenant",))
            self.g_tenant_borrowed = reg.gauge(
                "nos_tpu_serve_tenant_borrowed_tokens_per_s",
                "Token-rate each tenant currently runs ABOVE its "
                "guaranteed min — the lent idle capacity the elastic "
                "quota exists to hand out (and reclaim)",
                ("tenant",))
            for t in tenant_quota.names():
                self.m_tenant_tokens.labels(t).inc(0)
                for mode in ("swap", "recompute"):
                    self.m_tenant_preempt.labels(t, mode).inc(0)
        # per-tenant SLO error budgets and chip-second attribution: on
        # only when the tenant config carries ``slo`` objectives (the
        # engine's ledger is None otherwise)
        self.slo_engine = None
        self._slo_clock = slo_clock or time.monotonic
        self._chip_cum_ns: dict = {}        # (tenant, phase) -> ns
        self._chip_seen_ns: dict = {}       # current engine's mirror
        self._chip_cum_kvbs: dict = {}      # tenant -> byte-seconds
        self._chip_seen_kvbs: dict = {}
        self._chip_cum_wall_ns = 0
        self._chip_seen_wall_ns = 0
        self._slo_targets: dict = {}        # tenant -> TenantSloSpec
        if tenant_quota is not None and tenant_quota.slo_enabled():
            self._slo_targets = {
                n: sp.slo for n, sp in tenant_quota.tenants.items()
                if sp.slo is not None}
            self.slo_engine = SloBudgetEngine(
                objectives_from_quota(tenant_quota),
                fast_window_s=slo_fast_window_s,
                slow_window_s=slo_slow_window_s,
                burn_threshold=slo_burn_threshold,
                capture_interval_s=slo_capture_interval_s,
                min_events=slo_min_events)
            self.g_slo_budget = reg.gauge(
                "nos_tpu_serve_slo_budget_remaining_ratio",
                "Slow-window error budget left per (tenant, "
                "objective): 1 = untouched, 0 = exhausted "
                "(bad-event fraction at/over the objective's allowance)",
                ("tenant", "objective"))
            self.g_slo_burn = reg.gauge(
                "nos_tpu_serve_slo_burn_rate",
                "SRE multi-window burn rate per (tenant, objective, "
                "window = fast | slow): bad-event fraction over the "
                "window divided by the objective's error-budget "
                "allowance; a fast-window burn at/over the trip "
                "threshold emits an slo.breach span and pins the "
                "breaching request's trace",
                ("tenant", "objective", "window"))
            self.m_chip_ms = reg.counter(
                "nos_tpu_serve_tenant_chip_ms_total",
                "Engine wall milliseconds attributed per (tenant, "
                "phase = decode | prefill | idle): each quantum's "
                "measured duration split over its structural token "
                "weights, idle time under the _idle tenant — the "
                "ledger conserves (sum over series == engine wall "
                "time), across supervised engine swaps too "
                "(delta-mirrored)",
                ("tenant", "phase"))
            self.m_kv_byte_s = reg.counter(
                "nos_tpu_serve_tenant_kv_byte_seconds_total",
                "HBM byte-seconds of paged-KV residency per tenant "
                "(block-table + prefix-chain references; _shared = "
                "unscoped prefix chains), accrued over each engine "
                "quantum",
                ("tenant",))
            for t, objs in sorted(self.slo_engine.objectives.items()):
                for obj in sorted(objs):
                    self.g_slo_budget.labels(t, obj).set(1.0)
                    for w in ("fast", "slow"):
                        self.g_slo_burn.labels(t, obj, w).set(0.0)
            for t in tenant_quota.names():
                for ph in ("decode", "prefill"):
                    self.m_chip_ms.labels(t, ph).inc(0)
                self.m_kv_byte_s.labels(t).inc(0)
            self.m_chip_ms.labels(IDLE_TENANT, "idle").inc(0)
        # prefill/decode disaggregation (registered only on a
        # prefill-role loop — colocated and decode servers must not
        # export dead zero series): handoffs shipped to the decode
        # pool by outcome, payload bytes per handoff (the int8-halves-
        # the-wire claim is readable straight off this histogram), and
        # capture+ship wall time per handoff
        self.role = role
        self._handoff_targets = list(handoff_targets or [])
        self._handoff_send = handoff_send
        self._handoff_rr = 0
        self._handoff_done: dict = {}       # loop rid -> descriptor
        self._handoff_gone: set = set()     # client departed pre-push
        # pusher health memory: a decode replica that refused/failed a
        # push is skipped for this cooldown window before being
        # retried (blind round-robin would keep burning an attempt on
        # a dead replica every lap). target url -> abs monotonic the
        # cooldown ends; cleared on the next successful push. When the
        # WHOLE pool is cooling the pusher falls back to probing every
        # target — a cooldown degrades to blind round-robin, never to
        # dropping the handoff.
        self._handoff_cooldown_s = handoff_cooldown_s or 0.0
        self._handoff_unhealthy: dict = {}  # target -> abs monotonic
        # pusher health VIEW (beyond the reactive cooldown above): at
        # a bounded cadence the pusher scrapes each decode target's
        # /stats so pushes prefer healthy, least-loaded replicas and a
        # draining/recovering replica is skipped BEFORE the first
        # failed attempt. ``pool_stats_fetch`` is the injectable
        # fetcher (target url -> parsed stats dict) so tests drive the
        # view without sockets; None = the urllib default.
        self._handoff_health_interval_s = handoff_health_interval_s \
            or 0.0
        self.pool_stats_fetch = None
        self._pool_health: dict = {}    # target -> health row
        self._pool_health_at: Optional[float] = None
        # prefill-side deadline carry: the prefill server doesn't
        # ENFORCE deadlines (phase 1 is short; the decode side owns
        # expiry) but must not DROP them — the pusher attaches the
        # remaining seconds at ship time so the adopting decode
        # replica can shed expired phase-2 work early.
        self._prefill_deadlines: dict = {}  # loop rid -> abs monotonic
        # trace carry over the same seam: the prefill-side request
        # span's encoded context ships in the handoff meta plane so the
        # adopting decode replica's serve.request parents into the SAME
        # journey instead of minting a fresh trace_id
        self._prefill_traceparents: dict = {}   # loop rid -> traceparent
        # adopted-request TTL (decode role): an adopted handoff whose
        # consumer never shows up — the gateway crashed mid-resume, or
        # phase 2 exhausted its attempts — must not decode-and-park
        # forever. adopt() arms rid -> abs monotonic expiry here; a
        # consumer attach (result/watch) disarms it (the consumer's
        # own timeout/disconnect discipline owns the lifecycle from
        # there); _reap_orphans cancels whatever expires unclaimed.
        self._handoff_deadline: dict = {}   # loop rid -> abs monotonic
        self._adopt_ttl_s = adopt_ttl_s
        self._adopted: dict = {}            # loop rid -> prompt tokens
        # finished adopted results kept for re-fetch (same TTL): a
        # gateway retry of /v1/result after a socket timeout races the
        # abandoned first handler for the single engine pop — the
        # winner parks the tokens here so the loser still answers
        # instead of failing a fully-decoded request as "vanished"
        self._adopted_final: dict = {}      # loop rid -> full tokens
        # live _deltas consumers per rid: only the LAST one's teardown
        # forgets the request — an abandoned handler timing out must
        # not cancel the rid a retried resume is still attached to
        self._watchers: dict = {}           # loop rid -> consumer count
        if role == "prefill":
            self.m_handoff = reg.counter(
                "nos_tpu_serve_handoff_total",
                "Prefill->decode handoffs leaving this prefill-role "
                "server, by outcome (sent = adopted by a decode "
                "replica | failed = every decode-pool target refused "
                "or was unreachable; the request's one terminal "
                "outcome follows it)",
                ("outcome",))
            self.h_handoff_bytes = reg.histogram(
                "nos_tpu_serve_handoff_bytes",
                "KV payload bytes per handoff (quantized blocks + "
                "per-block scales under int8 — roughly half the bf16 "
                "bytes per request over DCN)",
                buckets=(1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9))
            self.h_handoff = reg.histogram(
                "nos_tpu_serve_handoff_seconds",
                "Wall time per handoff: KV swap-out capture plus the "
                "ship to the decode replica")
            self.m_handoff_skipped = reg.counter(
                "nos_tpu_serve_handoff_skipped_total",
                "Decode-pool targets skipped by the pusher: cooling "
                "down after a failed push (--handoff-cooldown-s) or "
                "reported draining/recovering by the scraped health "
                "view (--handoff-health-interval-s — skipped BEFORE "
                "the first failed attempt); a sustained rate means "
                "part of the decode pool is down or rolling")
            for outcome in ("sent", "failed"):
                self.m_handoff.labels(outcome).inc(0)
            self.m_handoff_skipped.inc(0)
        # budgeted chunked prefill, registered only when the engine runs
        # a per-tick budget (an unbudgeted loop exports no dead series)
        if getattr(engine, "prefill_budget", 0) > 0:
            self.m_psched_spent = reg.counter(
                "nos_tpu_serve_prefill_budget_tokens_total",
                "Prompt tokens of chunked prefill charged against the "
                "per-tick budget (--prefill-budget), including "
                "TTFT-critical overdraws")
            self.m_psched_clamp = reg.counter(
                "nos_tpu_serve_prefill_clamp_total",
                "Ticks the prefill budget clamped to zero because an "
                "active decode slot's TPOT slack went negative — "
                "decode drains first, prefill rides its banked credit")
            self.m_psched_override = reg.counter(
                "nos_tpu_serve_prefill_override_total",
                "Over-budget chunk forwards granted to a prefill "
                "whose TTFT slack was inside one decode tick (at most "
                "one per tick; the overdraw pays back from later "
                "budget)")
            self.m_psched_spent.inc(0)
            self.m_psched_clamp.inc(0)
            self.m_psched_override.inc(0)
        self._psched_seen = {"spent": 0, "clamped": 0, "overrides": 0}
        self.m_compiles = reg.counter(
            "nos_tpu_serve_compiles_total",
            "XLA compiles observed by the engine (first dispatch per "
            "shape: prefill buckets, decode program variants)")
        self.h_compile = reg.histogram(
            "nos_tpu_serve_compile_seconds",
            "Wall time of each first-dispatch-per-shape call (traces + "
            "compiles synchronously)",
            buckets=COMPILE_BUCKETS)
        # supervised-restart surface (registered only when a factory
        # makes restarts possible)
        self._sup: Optional[EngineSupervisor] = None
        if engine_factory is not None:
            self._sup = EngineSupervisor(
                engine_factory, restart_budget=restart_budget,
                backoff_s=restart_backoff_s,
                backoff_max_s=restart_backoff_max_s, seed=seed)
            self.m_restarts = reg.counter(
                "nos_tpu_serve_engine_restarts_total",
                "Supervised engine restarts begun, by cause "
                "(step_error = a decode tick raised; watchdog = a tick "
                "exceeded --watchdog-s in flight)",
                ("cause",))
            self.m_resumed = reg.counter(
                "nos_tpu_serve_requests_resumed_total",
                "Requests resumed across an engine restart, by mode "
                "(swap = KV snapshot restored byte-exact; recompute = "
                "re-prefilled from the committed tokens — both "
                "bit-exact)",
                ("mode",))
            self.m_lost = reg.counter(
                "nos_tpu_serve_requests_lost_total",
                "Requests that could NOT be resumed across an engine "
                "restart (capture or restore failed); each is drained "
                "as outcome=failed exactly once")
            for cause in ("step_error", "watchdog"):
                self.m_restarts.labels(cause).inc(0)
            for mode in ("swap", "recompute"):
                self.m_resumed.labels(mode).inc(0)
            self.m_lost.inc(0)
        if watchdog_s > 0:
            # registered exactly when a trip is possible (a trip without
            # a supervisor is a terminal failure)
            self.m_watchdog = reg.counter(
                "nos_tpu_serve_watchdog_trips_total",
                "Stuck-tick watchdog trips: a decode tick stayed "
                "blocked in its device wait past --watchdog-s with no "
                "arrival consumed (counted only when the trip is "
                "validated and starts the failure path)")
            self.m_watchdog.inc(0)
        self.engine = engine
        self._started = time.monotonic()
        self._config_echo = dict(config_echo) if config_echo else None
        self._slo_ttft_s = (slo_ttft_ms or 0.0) / 1e3
        self._slo_tpot_s = (slo_tpot_ms or 0.0) / 1e3
        self._goodput_done = 0
        self._goodput_good = 0
        self._spans: dict = {}          # rid -> serve.request span
        self._failed_drained: set = set()   # rids accounted as failed
        # rolling request/token rates for /stats: (monotonic t,
        # tokens_cum, finished_cum), pruned to the last RATE_WINDOW_S
        self._rates: deque = deque()
        self._tokens_cum = 0
        self._finished_cum = 0
        # rolling TTFT samples over recent completions (/stats p99)
        self._ttfts: deque = deque(maxlen=256)
        self._dev_interval = device_stats_interval_s or 0.0
        self._dev_next = 0.0
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._stop = False
        self._stop_event = threading.Event()    # wakes backoff/monitor
        self._draining = False
        self._failed: Optional[BaseException] = None
        self._abandoned: set = set()        # rids whose client timed out
        # recovery/deadline bookkeeping, keyed by the rid a client holds
        self._recovering = False
        self._gen = 0               # ticker generation: bumped per
        #                             recovery so superseded (stuck)
        #                             ticker threads exit untouched
        self._tick_started: Optional[float] = None  # watchdog's clock
        self._watchdog_s = watchdog_s or 0.0
        # the LOOP owns the rid namespace a client holds: a rebuilt
        # engine restarts its own counter
        self._next_rid = 0
        self._rid_map: dict = {}            # loop rid -> engine rid
        self._live: set = set()             # admitted, not yet terminal
        self._lost_rids: set = set()        # dropped in a restart
        self._default_deadline_s = default_deadline_s or 0.0
        self._deadlines: dict = {}          # orig rid -> abs monotonic
        self._deadline_hit: set = set()     # accounted outcome=deadline
        self._deadline_shed = 0             # shed at admission
        self._deadline_expired = 0          # cancelled mid-flight
        self._shed_streak = 0               # consecutive estimate sheds
        # rolling completion estimates feeding deadline admission (EWMA
        # over finished requests' ledgers; None until the first)
        self._est_ttft_s: Optional[float] = None
        self._est_tpot_s: Optional[float] = None
        self._est_out_tokens: Optional[float] = None
        # KV-fabric peer pull: an injectable fetcher (url -> payload
        # bytes; None = urllib in _fetch_chain_bytes), single-flight per
        # digest, outcomes counted here (the engine sees payloads only)
        self.chain_fetch = None
        self.chain_fetch_timeout_s = 2.0
        self.fabric_token = fabric_token or ""
        self._pull_lock = threading.Lock()
        self._pull_inflight: dict = {}      # digest -> flight record
        self._pull_counts = {"pull_hit": 0, "pull_miss": 0,
                             "pull_denied": 0}
        for outcome in OUTCOMES:        # export 0s, not absent series
            self.m_requests.labels(outcome).inc(0)
        self._mirror_engine_gauges()
        self._sample_device_stats()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self._handoff_thread: Optional[threading.Thread] = None
        if role == "prefill" and self._handoff_send is not None:
            self._handoff_thread = threading.Thread(
                target=self._push_handoffs, daemon=True)
            self._handoff_thread.start()
        self._monitor_thread: Optional[threading.Thread] = None
        if self._watchdog_s > 0:
            self._monitor_thread = threading.Thread(
                target=self._monitor, daemon=True)
            self._monitor_thread.start()
        self._orphan_thread: Optional[threading.Thread] = None
        if role == "decode" and adopt_ttl_s > 0:
            self._orphan_thread = threading.Thread(
                target=self._reap_orphans, daemon=True)
            self._orphan_thread.start()

    @property
    def healthy(self) -> bool:
        return self._failed is None

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def recovering(self) -> bool:
        """True while the supervisor is mid-restart: submissions get
        503 + Retry-After and /readyz reports ``degraded``."""
        return self._recovering

    def begin_drain(self) -> None:
        """Stop admitting; in-flight requests keep decoding (SIGTERM ->
        readiness flips -> new submits 503 -> wait_idle -> exit)."""
        with self._work:
            self._draining = True
            self._work.notify_all()

    def cancel_drain(self) -> None:
        """Resume admitting after a drain not followed by termination."""
        with self._work:
            self._draining = False
            self._work.notify_all()

    def wait_idle(self, timeout: float) -> bool:
        """Block until the engine has no queued or decoding work (or
        ``timeout``/loop death). Returns True when fully drained."""
        deadline = time.monotonic() + timeout
        with self._work:
            while self.engine.has_work():
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._failed is not None \
                        or self._stop:
                    return not self.engine.has_work()
                self._work.wait(timeout=min(remaining, 1.0))
            return True

    def _fail(self, e: BaseException) -> None:
        """Mark the loop TERMINALLY dead (caller holds the lock):
        /healthz flips BEFORE the single notify_all, so every waiter
        observes healthy == False when it returns. Abandoned requests
        are drained as ``failed`` here: the ticker that would have
        reaped them is the thing dying."""
        logger.error("serving loop terminally failed: %s", e,
                     exc_info=e)
        self._failed = e
        for rid in self._abandoned:
            erid = self._rid_map.get(rid)
            self._account(rid, "failed",
                          self._pop_ledger(erid)
                          if erid is not None else None)
            self._failed_drained.add(rid)
        self._abandoned.clear()
        self._work.notify_all()

    # -- request-level accounting (the latency ledger's consumer) -------
    def _pop_ledger(self, rid: int) -> Optional[dict]:
        pop = getattr(self.engine, "pop_ledger", None)
        return pop(rid) if pop is not None else None

    def _account(self, rid: int, outcome: str,
                 ledger: Optional[dict]) -> None:
        """Terminal accounting for ONE request (caller holds the lock):
        exactly one requests_total outcome, the TTFT/TPOT/queue/e2e
        histograms from the engine's ledger, the SLO verdicts, and the
        request's serve.request span closed (a breach pins its trace)."""
        self.m_requests.labels(outcome).inc()
        self._live.discard(rid)
        self._deadlines.pop(rid, None)
        self._prefill_deadlines.pop(rid, None)
        self._prefill_traceparents.pop(rid, None)
        self._rid_map.pop(rid, None)
        # an adopted (decode-role) request's prompt leaves with its
        # terminal outcome: the streaming attach never calls result()
        self._adopted.pop(rid, None)
        self._handoff_deadline.pop(rid, None)
        sp = self._spans.pop(rid, None)
        tid = (sp.trace_id or None) if sp is not None else None
        breaches = []
        decode_tokens = 0
        gap_sum = 0.0
        if ledger:
            if ledger.get("queue_s") is not None:
                self.h_queue.observe(max(0.0, ledger["queue_s"]),
                                     trace_id=tid)
            ttft = ledger.get("ttft_s")
            if ttft is not None:
                self.h_ttft.observe(ttft, trace_id=tid)
                if outcome == "finished":
                    self._ttfts.append(ttft)
            for gap, n in ledger.get("tpot") or ():
                # one weighted observe per arrival
                self.h_tpot.observe(gap / n, trace_id=tid, count=n)
                decode_tokens += n
                gap_sum += gap
            if ledger.get("e2e_s") is not None:
                self.h_e2e.observe(ledger["e2e_s"], trace_id=tid)
            if outcome == "finished":
                # rolling completion estimates for deadline admission
                if ttft is not None:
                    self._est_ttft_s = ttft if self._est_ttft_s is None \
                        else 0.8 * self._est_ttft_s + 0.2 * ttft
                if decode_tokens:
                    tpot = gap_sum / decode_tokens
                    self._est_tpot_s = tpot if self._est_tpot_s is None \
                        else 0.8 * self._est_tpot_s + 0.2 * tpot
                out_toks = ledger.get("output_tokens") or 0
                if out_toks:
                    self._est_out_tokens = float(out_toks) \
                        if self._est_out_tokens is None \
                        else 0.8 * self._est_out_tokens + 0.2 * out_toks
            if outcome == "finished" \
                    and (self._slo_ttft_s or self._slo_tpot_s):
                good = True
                if self._slo_ttft_s and ttft is not None:
                    met = ttft <= self._slo_ttft_s
                    self.m_slo.labels(
                        "ttft", "met" if met else "breached").inc()
                    if not met:
                        good = False
                        breaches.append("ttft")
                if self._slo_tpot_s and decode_tokens:
                    met = gap_sum / decode_tokens <= self._slo_tpot_s
                    self.m_slo.labels(
                        "tpot", "met" if met else "breached").inc()
                    if not met:
                        good = False
                        breaches.append("tpot")
                self._goodput_done += 1
                if good:
                    self._goodput_good += 1
                self.g_goodput.set(
                    self._goodput_good / self._goodput_done)
        slo_trips: list = []
        slo_tenant = None
        if self._tenant_cfg is not None:
            t = self._tenant_of.pop(
                rid, self._tenant_cfg.default_tenant)
            slo_tenant = t
            slo_trips = self._judge_tenant_slo(
                t, outcome, ledger, decode_tokens, gap_sum)
            if ledger and ledger.get("output_tokens"):
                self.m_tenant_tokens.labels(t).inc(
                    ledger["output_tokens"])
            if outcome in ("finished", "failed", "deadline"):
                # per-tenant goodput over server-judged outcomes (a
                # client walking away is not a verdict on the quota);
                # with no SLO targets, finishing is good
                gp = self._tenant_goodput.setdefault(t, [0, 0])
                gp[0] += 1
                if outcome == "finished" and not breaches:
                    gp[1] += 1
                self.g_tenant_goodput.labels(t).set(gp[1] / gp[0])
        if sp is not None and sp.recording:
            sp.set_attr("outcome", outcome)
            if ledger:
                if ledger.get("ttft_s") is not None:
                    sp.set_attr("ttft_ms",
                                round(ledger["ttft_s"] * 1e3, 3))
                if ledger.get("queue_s") is not None:
                    sp.set_attr(
                        "queue_ms",
                        round(max(0.0, ledger["queue_s"]) * 1e3, 3))
                sp.set_attr("output_tokens",
                            ledger.get("output_tokens", 0))
            if breaches:
                sp.set_attr("slo_breach", ",".join(breaches))
                tracing.recorder().pin(sp.trace_id, "slo")
            if slo_trips:
                # a fast-window burn trip: one slo.breach span under the
                # breaching request, its trace pinned once (the budget
                # engine's capture interval rate-limits this)
                for obj in slo_trips:
                    bsp = tracing.start_span(
                        "slo.breach", component="server", parent=sp,
                        attrs={"tenant": slo_tenant, "objective": obj,
                               "burn_threshold":
                                   self.slo_engine.burn_threshold})
                    bsp.end()
                rec = tracing.tracer().recorder
                if rec is not None:
                    rec.pin(sp.trace_id, "slo_burn")
            sp.end()
        if outcome in ("finished", "abandoned"):
            self._finished_cum += 1
            self._note_rates()

    def _judge_tenant_slo(self, tenant: str, outcome: str,
                          ledger: Optional[dict], decode_tokens: int,
                          gap_sum: float) -> list:
        """Feed one terminal request into the tenant's error-budget
        windows and refresh its burn and budget gauges: TTFT and TPOT
        objectives judge finished requests against the tenant's p99
        targets, goodput judges every server-decided outcome. Returns
        the objectives whose fast window tripped on this event."""
        if self.slo_engine is None:
            return []
        targets = self._slo_targets.get(tenant)
        tracked = self.slo_engine.tracked(tenant)
        if targets is None or not tracked:
            return []
        now = self._slo_clock()
        trips = []
        judged = False
        if outcome == "finished" and ledger:
            ttft = ledger.get("ttft_s")
            if "ttft_p99" in tracked and ttft is not None:
                bad = ttft > targets.ttft_p99_ms / 1e3
                if self.slo_engine.note(tenant, "ttft_p99", bad, now):
                    trips.append("ttft_p99")
                judged = True
            if "tpot_p99" in tracked and decode_tokens:
                bad = gap_sum / decode_tokens \
                    > targets.tpot_p99_ms / 1e3
                if self.slo_engine.note(tenant, "tpot_p99", bad, now):
                    trips.append("tpot_p99")
                judged = True
        if "goodput" in tracked \
                and outcome in ("finished", "failed", "deadline"):
            bad = outcome != "finished"
            if self.slo_engine.note(tenant, "goodput", bad, now):
                trips.append("goodput")
            judged = True
        if judged:
            for row in self.slo_engine.rows(now):
                if row["tenant"] != tenant:
                    continue
                obj = row["objective"]
                self.g_slo_budget.labels(tenant, obj).set(
                    row["budget_remaining_ratio"])
                self.g_slo_burn.labels(tenant, obj, "fast").set(
                    row["burn_fast"])
                self.g_slo_burn.labels(tenant, obj, "slow").set(
                    row["burn_slow"])
        return trips

    def _note_rates(self) -> None:
        """Append a (t, tokens, requests) mark and prune the window."""
        now = time.monotonic()
        self._rates.append((now, self._tokens_cum, self._finished_cum))
        cutoff = now - RATE_WINDOW_S
        while len(self._rates) > 1 and self._rates[0][0] < cutoff:
            self._rates.popleft()

    def _note_tick_phases(self, start: float, t0: float, t1: float,
                          t2: float, t3: float, t4: float, eng) -> None:
        """Decompose one tick into TICK_PHASES (caller holds the lock).
        ``start`` is the tick's start on the tracer's clock, ``t0``..``t4``
        its boundaries on the monotonic clock. ``eng`` is the
        split-protocol engine — its ``last_assemble_s`` splits step_begin
        into assemble vs dispatch — or None for step()-only engines,
        whose whole step lands under ``dispatch``. ``sample`` covers
        step_finish plus the lock reacquisition after the device wait
        (that reacquisition is also the ticker's second
        ``nos_tpu_serve_lock_wait_seconds`` observation)."""
        if eng is not None:
            begin = max(0.0, t1 - t0)
            assemble = max(
                0.0, float(getattr(eng, "last_assemble_s", 0.0) or 0.0))
            assemble = min(assemble, begin)
            phases = {
                "assemble": assemble,
                "dispatch": begin - assemble,
                "wait": max(0.0, t2 - t1),
                "sample": max(0.0, t3 - t2),
                "bookkeep": max(0.0, t4 - t3),
            }
            if getattr(eng, "prefill_budget", 0) > 0:
                # the budgeted prefill's TPOT cost model samples the
                # decode half of the tick (assemble + dispatch + wait);
                # step_finish, which runs the chunks, stays out of it
                eng.note_tick_seconds(max(0.0, t2 - t0))
        else:
            phases = {
                "assemble": 0.0,
                "dispatch": max(0.0, t1 - t0),
                "wait": 0.0,
                "sample": 0.0,
                "bookkeep": max(0.0, t4 - t1),
            }
        for ph, v in phases.items():
            self.h_tick_phase.labels(ph).observe(v)
        self._tick_phases.append((start, phases))

    def _tick_phase_snapshot(self) -> dict:
        """Rolling per-phase totals over the ring window for /stats
        (caller holds the lock)."""
        totals = {ph: 0.0 for ph in TICK_PHASES}
        for _t, phases in self._tick_phases:
            for ph, v in phases.items():
                totals[ph] += v
        return {
            "window": len(self._tick_phases),
            "seconds": {ph: round(v, 6) for ph, v in totals.items()},
        }

    def profile_trace(self, last_n: int = 64) -> dict:
        """Chrome trace-event JSON of the last N decode ticks, each tick
        a slice with its phase children — the /debug/profile payload.
        The synthesized spans share ONE fixed valid-hex trace id so every
        tick lands on the same lane, and none feed the flight recorder."""
        from nos_tpu_torch.obs.trace_export import to_chrome_trace
        from nos_tpu_torch.obs.tracing import Span, _new_span_id
        with self._lock:
            ticks = list(self._tick_phases)[-max(1, int(last_n)):]
        if not ticks:
            return {"traceEvents": [],
                    "displayTimeUnit": "ms"}
        tid = "70726f66696c6500" + "0" * 16   # "profile" in hex, padded
        spans = []
        for i, (t0, phases) in enumerate(ticks):
            root = Span("serve.tick", "server", tid, _new_span_id(),
                        None, t0, attrs={"tick": i}, _tracer=None)
            cursor = t0
            for ph in TICK_PHASES:
                dur = phases.get(ph, 0.0)
                if dur <= 0.0:
                    continue
                child = Span("tick." + ph, "server", tid,
                             _new_span_id(), root.span_id, cursor,
                             _tracer=None)
                child.end(end_time=cursor + dur)
                cursor += dur
                spans.append(child)
            root.end(end_time=max(cursor, t0))
            spans.append(root)
        return to_chrome_trace(spans)

    def _drain_compile_events(self) -> None:
        """Engine-side compile accounting -> metrics (caller holds the
        lock): on the card, the first capture of each decode program."""
        events = getattr(self.engine, "compile_events", None)
        if events:
            self.engine.compile_events = []
            for dt in events:
                self.m_compiles.inc()
                self.h_compile.observe(dt)

    def _drain_prefill_events(self) -> None:
        """Each prefill the engine finished since the last drain ->
        ``nos_tpu_serve_prefill_seconds`` (caller holds the lock)."""
        events = getattr(self.engine, "prefill_events", None)
        while events:
            self.h_prefill.observe(events.popleft())

    def _set_device_gauges(self, label: str, in_use: int,
                           limit: int) -> None:
        reg = default_registry()
        reg.gauge(
            "nos_tpu_device_hbm_bytes_in_use",
            "Device memory (HBM) bytes currently allocated, per "
            "local device (absent on backends without "
            "memory_stats, e.g. CPU)",
            ("device",)).labels(label).set(in_use)
        if limit:
            reg.gauge(
                "nos_tpu_device_hbm_bytes_limit",
                "Device memory (HBM) byte capacity, per local device",
                ("device",)).labels(label).set(limit)

    def _sample_device_stats(self) -> None:
        """Bounded-cadence device telemetry: bytes in use and capacity
        of the engine's card, from ``torch.cuda.memory_stats`` and
        ``torch.cuda.mem_get_info``, into the reference's gauges. An
        engine on the CPU never exports them; a telemetry failure never
        takes the loop down."""
        if self._dev_interval <= 0:
            return
        now = time.monotonic()
        if now < self._dev_next:
            return
        self._dev_next = now + self._dev_interval
        device = getattr(self.engine, "device", None)
        if getattr(device, "type", None) != "cuda":
            self._dev_interval = 0.0    # no card: stop trying
            return
        try:
            index = device.index if device.index is not None \
                else torch.cuda.current_device()
            stats = torch.cuda.memory_stats(index)
            limit = torch.cuda.mem_get_info(index)[1]
        except Exception:
            return
        in_use = stats.get("allocated_bytes.all.current")
        if in_use is not None:
            self._set_device_gauges(f"cuda:{index}", in_use, limit)

    def stats(self) -> dict:
        """The /stats snapshot: the engine's live introspection plus
        loop-level health, SLO/goodput state and rolling rates."""
        with self._work:
            engine_stats = getattr(self.engine, "stats", None)
            snap = dict(engine_stats()) if engine_stats is not None \
                else {}
            if "slots" not in snap:
                occupancy = getattr(self.engine, "occupancy", None)
                if occupancy is not None:
                    active, pending = occupancy()
                    snap["active_slots"] = active
                    snap["pending"] = {"depth": pending}
            elif "active_slots" not in snap:
                snap["active_slots"] = len(snap["slots"])
            # rates age against NOW, not the last mark
            now = time.monotonic()
            window = [m for m in self._rates
                      if m[0] >= now - RATE_WINDOW_S]
            if window and now > window[0][0]:
                dt = now - window[0][0]
                rates = {
                    "window_s": round(dt, 3),
                    "tokens_per_s": round(
                        (self._tokens_cum - window[0][1]) / dt, 3),
                    "requests_per_s": round(
                        (self._finished_cum - window[0][2]) / dt, 3),
                }
            else:
                rates = {"window_s": 0.0, "tokens_per_s": 0.0,
                         "requests_per_s": 0.0}
            snap.update({
                "healthy": self.healthy,
                "draining": self._draining,
                "recovering": self._recovering,
                "uptime_s": round(now - self._started, 3),
                "config": self._config_echo or {},
                "per_request": {
                    "window": len(self._ttfts),
                    "ttft_p99_s": (
                        round(sorted(self._ttfts)[
                            min(len(self._ttfts) - 1,
                                math.ceil(0.99 * len(self._ttfts)) - 1)],
                            6)
                        if self._ttfts else None),
                },
                "supervisor": (
                    dict(self._sup.stats(),
                         watchdog_s=self._watchdog_s)
                    if self._sup is not None else None),
                "deadline": {
                    "default_s": self._default_deadline_s,
                    "active": len(self._deadlines),
                    "shed": self._deadline_shed,
                    "expired": self._deadline_expired,
                    "est_ttft_s": (round(self._est_ttft_s, 6)
                                   if self._est_ttft_s is not None
                                   else None),
                    "est_tpot_s": (round(self._est_tpot_s, 6)
                                   if self._est_tpot_s is not None
                                   else None),
                },
                "slo": {
                    "ttft_ms": round(self._slo_ttft_s * 1e3, 3),
                    "tpot_ms": round(self._slo_tpot_s * 1e3, 3),
                    "completed": self._goodput_done,
                    "goodput": (round(self._goodput_good
                                      / self._goodput_done, 4)
                                if self._goodput_done else None),
                },
                "rates": rates,
                # KV-fabric peer-pull outcomes (loop-side: the engine
                # only sees decoded payloads, never fetches)
                "kv_fabric_pulls": dict(self._pull_counts),
                "tick_phases": self._tick_phase_snapshot(),
                # None when SLO accounting is off
                "slo_budget": (
                    self.slo_engine.snapshot(self._slo_clock())
                    if self.slo_engine is not None else None),
                "chip_ledger": self._chip_ledger_block(),
            })
        return snap

    def _run(self) -> None:
        """Ticker thread: one ``_run_quantum`` per scheduling quantum
        until stopped, terminally failed, superseded by a recovery
        (generation bump), or handed off INTO a recovery."""
        with self._work:
            gen = self._gen
        while self._run_quantum(gen):
            pass

    def _take_lock(self) -> float:
        """Acquire the loop's lock inside a ``serve.lock_wait`` range;
        returns the seconds spent waiting for it."""
        t = time.monotonic()
        with device_range("serve.lock_wait"):
            self._work.acquire()
        return time.monotonic() - t

    def _run_quantum(self, gen: int) -> bool:
        # engines exposing the split-step protocol (DecodeServer) run
        # the blocking device wait OUTSIDE the condition lock, so
        # handlers submit/stream/cancel while the card computes;
        # step()-only engines (test stubs) tick under the lock. The
        # engine reference is snapshotted per quantum: a watchdog
        # recovery swaps self.engine while this thread is blocked in
        # step_wait, and a superseded thread must only ever touch the
        # OLD engine — then exit on the generation check. Each phase
        # runs inside a profiler range of its own (``device_range``: a
        # no-op unless a profiler runs), at the t0..t4 boundaries.
        failure = None
        waited = self._take_lock()
        try:
            if self._gen != gen or self._failed is not None:
                return False
            while not self._stop and not self.engine.has_work():
                waited = None   # idle: waiting for work is no contention
                self._work.wait()
                if self._gen != gen or self._failed is not None:
                    return False
            if self._stop:
                return False
            if waited is not None:
                self._ticker_wait.observe(waited)
            eng = self.engine
            split = hasattr(eng, "step_begin") \
                and hasattr(eng, "step_wait") \
                and hasattr(eng, "step_finish")
            t0 = time.monotonic()
            start = tracing.tracer().clock()
            handle = None
            emitted = 0
            gap0 = getattr(eng, "dispatch_gap_s", None)
            try:
                with device_range("serve.step_begin"):
                    if split:
                        handle = eng.step_begin()
                    else:
                        emitted = eng.step()
                t1 = time.monotonic()
                if split:
                    # the watchdog arms for the BLOCKING wait phase only
                    self._tick_started = t1
            except BaseException as e:
                self._tick_started = None
                failure = e
        finally:
            self._work.release()
        if failure is not None:
            self._recover(failure, "step_error", gen)
            return False
        t2 = t1
        if split:
            # the only blocking device wait — lock released, so a
            # concurrent submit's barrier flush may consume the handle
            # under us (step_finish is idempotent on it)
            try:
                with device_range("serve.wait"):
                    eng.step_wait(handle)
            except BaseException as e:
                with self._work:
                    if self._gen != gen:
                        return False    # superseded while blocked
                    self._tick_started = None
                self._recover(e, "step_error", gen)
                return False
            t2 = time.monotonic()
        waited = self._take_lock()
        try:
            if self._gen != gen or self._failed is not None:
                # superseded while blocked: this tick belongs to the
                # discarded engine and must not touch loop state
                return False
            if split:
                self._ticker_wait.observe(waited)
            t3 = t2
            try:
                if split:
                    with device_range("serve.step_finish"):
                        emitted = eng.step_finish(handle)
                    t3 = time.monotonic()
                with device_range("serve.bookkeep"):
                    if split and gap0 is not None:
                        self.h_gap.observe(eng.dispatch_gap_s - gap0)
                    self._bookkeep(emitted)
            except BaseException as e:
                self._tick_started = None
                failure = e
            else:
                t4 = time.monotonic()
                self.h_tick.observe(t4 - t0)
                chip_note = getattr(eng, "chip_note_quantum", None)
                if chip_note is not None:
                    # the chip ledger charges the quantum with the same
                    # two clock reads the tick profiler takes (a no-op
                    # unless SLO accounting is configured)
                    chip_note(t0, t4)
                self._note_tick_phases(start, t0, t1, t2, t3, t4,
                                       eng if split else None)
                self._work.notify_all()  # wake waiters to check results
        finally:
            self._work.release()
        if failure is not None:
            self._recover(failure, "step_error", gen)
            return False
        return True

    def _bookkeep(self, emitted: int) -> None:
        """A tick's host bookkeeping after its tokens landed (caller
        holds the lock): counters, rates, gauges, the deadline sweep, and
        the reaping of results whose client already gave up."""
        self._tick_started = None
        self.m_ticks.inc()
        self.m_tokens.inc(emitted)
        self._tokens_cum += emitted
        self._note_rates()
        self._mirror_engine_gauges()
        self._sample_device_stats()
        self._sweep_deadlines()
        # reap results whose client already gave up. Inside the tick's
        # try: a failure here must flip /healthz like any other tick
        # failure, not kill the ticker silently
        for rid in list(self._abandoned):
            # no identity fallback: once _account popped the map, the
            # bare rid may alias another request
            erid = self._rid_map.get(rid)
            if erid is None:
                self._abandoned.discard(rid)
                continue
            ledger = self._pop_ledger(erid)
            if self.engine.pop_result(erid) is not None:
                self._abandoned.discard(rid)
                self._account(rid, "abandoned", ledger)
            elif self.engine.progress(erid) is None:
                # the engine dropped it outright: resolve NOW
                self._abandoned.discard(rid)
                self._account(rid, "cancelled", ledger)

    # -- supervised recovery ---------------------------------------------
    def _recover(self, exc: BaseException, cause: str, gen: int,
                 stuck_since: Optional[float] = None) -> None:
        """Safety shell around the recovery state machine: anything
        escaping it flips /healthz, never strands the loop with
        ``_recovering`` stuck True behind a green liveness probe."""
        try:
            self._do_recover(exc, cause, gen, stuck_since)
        except BaseException as e:  # noqa: BLE001 — see docstring
            with self._work:
                self._recovering = False
                if self._failed is None:
                    self._fail(e)
            raise

    def _do_recover(self, exc: BaseException, cause: str, gen: int,
                    stuck_since: Optional[float] = None) -> None:
        """Engine failure -> supervised restart, or terminal _fail when
        out of budget / no supervisor / shutting down. Runs on the
        failing ticker thread (step_error) or the watchdog monitor
        (cause=watchdog); on success it spawns a FRESH ticker thread.
        The lock is dropped around capture, release, backoff and
        rebuild: handlers keep answering (503 + Retry-After)."""
        with self._work:
            if self._gen != gen or self._failed is not None:
                return                  # superseded / already terminal
            if stuck_since is not None \
                    and self._tick_started != stuck_since:
                return  # the "stuck" tick landed meanwhile
            if cause == "watchdog":
                self.m_watchdog.inc()
            if self._sup is None or self._stop \
                    or not self._sup.can_restart():
                self._fail(exc)
                return
            t_fail = time.monotonic()
            self._gen += 1
            gen = self._gen
            self._recovering = True
            self._tick_started = None
            self.m_restarts.labels(cause).inc()
            attempt = self._sup.note_attempt()
            logger.warning(
                "engine failure (%s: %s); supervised restart, attempt "
                "%d/%d", cause, exc, attempt + 1,
                self._sup.restart_budget)
            # engine-rid -> loop-rid, snapshotted while every live
            # captured request still has its map entry
            cur_to_orig = {v: k for k, v in self._rid_map.items()}
            eng = self.engine
            self._work.notify_all()
        # -- no lock: capture (read-only; a device declared wedged by the
        # watchdog is not read at all), bounded by CAPTURE_TIMEOUT_S
        if cause == "watchdog":
            captured = self._sup.capture(eng, device_ok=False)
        else:
            box: dict = {}

            def _cap():
                box["states"] = self._sup.capture(eng, device_ok=True)

            ct = threading.Thread(target=_cap, daemon=True)
            ct.start()
            ct.join(timeout=CAPTURE_TIMEOUT_S)
            captured = box.get("states")
            if captured is None:
                logger.warning(
                    "swap capture hung > %.0fs (device lost?); "
                    "falling back to host-only capture — every "
                    "slot resumes by recompute", CAPTURE_TIMEOUT_S)
                captured = self._sup.capture(eng, device_ok=False)
        # -- the dead engine's device memory goes before the rebuild
        # (the card cannot hold two engines' weights); its host
        # bookkeeping stays readable for handlers meanwhile
        free = getattr(eng, "free_device_memory", None)
        if free is not None:
            free(free_cache=cause != "watchdog")
        # -- no lock: backoff, then rebuild ------------------------------
        new_engine = None
        while True:
            self._stop_event.wait(self._sup.backoff_delay(attempt))
            if self._stop:
                break
            try:
                new_engine = self._sup.build()
                break
            except Exception:
                logger.exception("engine rebuild failed")
                if not self._sup.can_restart():
                    break
                attempt = self._sup.note_attempt()
        with self._work:
            if new_engine is None or self._stop:
                # budget exhausted — or shutdown() cancelled the
                # recovery: drain every captured request as ``failed``
                # exactly once, then die terminally
                for st in captured:
                    orig = cur_to_orig.get(st["rid"], st["rid"])
                    if st.get("done") or orig not in self._live \
                            or orig in self._failed_drained \
                            or orig in self._deadline_hit:
                        continue
                    self._failed_drained.add(orig)
                    self._abandoned.discard(orig)
                    self._account(orig, "failed", None)
                self._recovering = False
                self._fail(exc)
                return
            self.engine = new_engine
            # the rebuilt engine's counts start at 0: reset the mirrors,
            # or their deltas would go negative and freeze the counters
            self._preempt_seen = {"swap": 0, "recompute": 0}
            self._spec_seen = {"drafted": 0, "accepted": 0}
            self._psched_seen = {"spent": 0, "clamped": 0,
                                 "overrides": 0}
            self._prefix_evict_seen = {"drop": 0, "demote": 0}
            self._fabric_seen = {"demote": 0, "promote": 0}
            self._tenant_preempt_seen = {}
            # the rebuilt engine's chip ledger restarts at zero (the
            # cumulative totals keep the old engine's charges)
            self._chip_seen_ns = {}
            self._chip_seen_kvbs = {}
            self._chip_seen_wall_ns = 0
            resumed = {"swap": 0, "recompute": 0}
            lost = 0
            seen = set()
            now = time.monotonic()
            for st in captured:
                orig = cur_to_orig.get(st["rid"], st["rid"])
                seen.add(orig)
                self._rid_map.pop(orig, None)
                if orig not in self._live \
                        or orig in self._deadline_hit \
                        or orig in self._failed_drained:
                    continue        # already terminally accounted
                if orig in self._abandoned and not st.get("done"):
                    # the client walked away mid-recovery
                    self._abandoned.discard(orig)
                    self._account(orig, "cancelled", None)
                    continue
                dl = self._deadlines.get(orig)
                if dl is not None and now > dl and not st.get("done"):
                    # its deadline expired during the outage
                    self._deadline_hit.add(orig)
                    self._deadline_expired += 1
                    self._account(orig, "deadline", None)
                    continue
                try:
                    nrid, mode = self._sup.restore(new_engine, st)
                except Exception as e:
                    logger.warning("request %s lost in engine restart: "
                                   "%s", orig, e)
                    self._lost_rids.add(orig)
                    self.m_lost.inc()
                    lost += 1
                    self._abandoned.discard(orig)
                    self._account(orig, "failed", None)
                    continue
                self._rid_map[orig] = nrid
                if st.get("done"):
                    continue            # a parked result, not a resume
                resumed[mode] += 1
                self.m_resumed.labels(mode).inc()
                sp = self._spans.get(orig)
                if sp is not None and sp.recording:
                    rsp = tracing.start_span(
                        "serve.recover", component="server", parent=sp,
                        attrs={"cause": cause, "mode": mode,
                               "restart": self._sup.restarts + 1})
                    rsp.end()
                    tracing.recorder().pin(sp.trace_id, "recover")
            for orig in sorted(self._live - seen):
                # live at failure time but absent from the capture (an
                # engine whose capture raised): lost, drained as
                # ``failed``, exactly once
                self._lost_rids.add(orig)
                self.m_lost.inc()
                lost += 1
                self._abandoned.discard(orig)
                self._account(orig, "failed", None)
            self._recovering = False
            self._sup.note_recovered(cause, t_fail, resumed, lost)
            self._mirror_engine_gauges()
            logger.info(
                "engine restarted (%s): %d resumed (%d swap / %d "
                "recompute), %d lost, mttr %.3fs", cause,
                sum(resumed.values()), resumed["swap"],
                resumed["recompute"], lost,
                self._sup.episodes[-1]["mttr_s"])
            self._work.notify_all()
            t = threading.Thread(target=self._run, daemon=True)
            self._thread = t
            t.start()

    def _monitor(self) -> None:
        """Stuck-tick watchdog: a decode tick in flight longer than
        ``watchdog_s`` counts as an engine failure — the same recovery
        path, run on THIS thread (the stuck ticker exits via the
        generation check whenever it unblocks)."""
        period = max(0.02, self._watchdog_s / 4.0)
        while not self._stop_event.wait(period):
            with self._work:
                if self._failed is not None:
                    return
                if self._recovering or self._tick_started is None:
                    continue
                started = self._tick_started
                dt = time.monotonic() - started
                if dt <= self._watchdog_s:
                    continue
                gen = self._gen
                exc: BaseException = TimeoutError(
                    f"watchdog: decode tick in flight {dt:.2f}s "
                    f"(> --watchdog-s {self._watchdog_s:.2f}s) with no "
                    f"arrival consumed")
            self._recover(exc, "watchdog", gen, stuck_since=started)

    # -- request deadlines ----------------------------------------------
    def _estimate_completion_s(self, max_new_tokens: int) -> tuple:
        """Rolling estimate of submit -> finished for a fresh request,
        as (seconds, expected tokens): EWMA TTFT plus EWMA TPOT per
        expected token, the expected length min(ceiling, 2 x EWMA actual
        output). (None, tokens) until the first completion."""
        tokens = float(max_new_tokens)
        if self._est_out_tokens is not None:
            tokens = min(tokens, 2.0 * self._est_out_tokens)
        if self._est_ttft_s is None:
            return None, tokens
        return (self._est_ttft_s
                + (self._est_tpot_s or 0.0) * max(0.0, tokens - 1),
                tokens)

    def _sweep_deadlines(self) -> None:
        """Cancel every live request whose deadline has passed (caller
        holds the lock; runs each tick quantum — the tick barrier of the
        deadline contract — and from stream waiters)."""
        if not self._deadlines:
            return
        now = time.monotonic()
        for rid, dl in list(self._deadlines.items()):
            if now > dl and rid not in self._deadline_hit:
                self._expire_deadline(rid)

    def _expire_deadline(self, rid: int) -> None:
        """Terminal ``deadline`` outcome for one request, exactly once
        (caller holds the lock). A request that FINISHED before the
        sweep keeps its ``finished`` outcome."""
        erid = self._rid_map.get(rid)
        prog = self.engine.progress(erid) if erid is not None else None
        if prog is None or prog[1]:
            self._deadlines.pop(rid, None)
            return
        # a dead or mid-recovery engine is not asked to mutate its batch
        cancel = getattr(self.engine, "cancel", None)
        if cancel is not None and self._failed is None \
                and not self._recovering:
            cancel(erid)
        ledger = self._pop_ledger(erid)
        self.engine.pop_result(erid)
        self._deadline_hit.add(rid)
        self._deadline_expired += 1
        self._abandoned.discard(rid)
        self._account(rid, "deadline", ledger)
        self._mirror_engine_gauges()
        self._work.notify_all()     # the stream raises DeadlineExceeded

    # -- disaggregation ------------------------------------------------
    def _fetch_pool_stats(self, target: str) -> dict:
        """Default /stats scraper for the pusher's decode-pool health
        view; ``pool_stats_fetch`` overrides it (tests, benches)."""
        import urllib.request

        with urllib.request.urlopen(
                target.rstrip("/") + "/stats", timeout=2) as resp:
            return json.loads(resp.read())

    def _refresh_pool_health(self, targets) -> None:
        """Refresh the pusher's health view of the decode pool from
        each target's /stats, at most every
        --handoff-health-interval-s. A target whose scrape fails goes
        UNKNOWN (dropped from the view), not unhealthy — the push
        attempt itself owns failure cooldowns."""
        now = time.monotonic()
        if self._pool_health_at is not None and \
                now - self._pool_health_at \
                < self._handoff_health_interval_s:
            return
        self._pool_health_at = now
        fetch = self.pool_stats_fetch or self._fetch_pool_stats
        health = {}
        for t in targets:
            try:
                st = fetch(t)
            except Exception:   # noqa: BLE001 — scrape is best-effort
                continue
            pending = st.get("pending")
            depth = pending.get("depth", 0) \
                if isinstance(pending, dict) else 0
            health[t] = {
                "queue": int(depth or 0),
                "draining": bool(st.get("draining")),
                "recovering": bool(st.get("recovering")),
            }
        self._pool_health = health

    def _order_pool(self, pool: list) -> list:
        """Order push candidates by the health view: draining or
        recovering targets are dropped (skipped BEFORE a failed
        attempt — counted in nos_tpu_serve_handoff_skipped_total),
        healthy ones sort by scraped queue depth ascending with the
        round-robin cursor breaking ties, unknown targets (scrape
        failed) sort after every known-healthy one. An empty result
        (whole pool draining) falls back to the unordered pool —
        the health view degrades to blind round-robin, never to
        dropping the handoff."""
        if not self._pool_health:
            return pool
        keep, skipped = [], 0
        for t in pool:
            h = self._pool_health.get(t)
            if h is not None and (h["draining"] or h["recovering"]):
                skipped += 1
                continue
            keep.append(t)
        if skipped:
            self.m_handoff_skipped.inc(skipped)
        if not keep:
            return pool
        rank = {t: i for i, t in enumerate(keep)}
        rr = self._handoff_rr

        def key(t):
            h = self._pool_health.get(t)
            return ((0, h["queue"]) if h is not None else (1, 0)) \
                + ((rank[t] - rr) % len(keep),)

        return sorted(keep, key=key)

    def _push_handoffs(self) -> None:
        """Pusher thread (prefill role): drain the engine's parked
        handoff states and ship each to a decode-pool target —
        round-robin, next target on failure, two laps before the
        handoff (and its request) fails. Encoding and the network send
        run OUTSIDE the loop lock; only the bookkeeping (result map,
        terminal accounting, metrics) re-enters it."""
        from nos_tpu_torch.models.handoff import encode_handoff, handoff_nbytes
        while True:
            with self._work:
                while not self._stop and self._failed is None \
                        and not getattr(self.engine, "_handoffs", None):
                    self._work.wait(timeout=0.25)
                if self._stop or self._failed is not None:
                    return
                states = self.engine.pop_handoffs()
                # reverse map BEFORE releasing the lock: a recovery
                # could remap rids while we ship
                rev = {erid: lrid
                       for lrid, erid in self._rid_map.items()}
            for st in states:
                with self._work:
                    lrid0 = rev.get(st["rid"])
                    if lrid0 is not None \
                            and lrid0 in self._handoff_gone:
                        # the client departed while the payload was
                        # parked: don't ship KV nobody will read —
                        # resolve the request as cancelled here
                        self._handoff_gone.discard(lrid0)
                        self._account(lrid0, "cancelled",
                                      self._pop_ledger(st["rid"]))
                        self._work.notify_all()
                        continue
                    dl = (self._prefill_deadlines.get(lrid0)
                          if lrid0 is not None else None)
                    tp = (self._prefill_traceparents.get(lrid0)
                          if lrid0 is not None else None)
                if tp is not None:
                    # the journey context rides the same JSON meta
                    # plane as deadline_s: the adopting decode
                    # replica's serve.request parents into it
                    st["traceparent"] = tp
                if dl is not None:
                    # carry the REMAINING seconds, computed at ship
                    # time: wall budgets survive the hop without any
                    # cross-host clock sync. An already-negative carry
                    # still ships — adopt() arms it in the past and
                    # the decode side's next sweep sheds the expired
                    # work instead of decoding an answer nobody waits
                    # for. The descriptor key rides the handoff's JSON
                    # meta plane (models/handoff.py round-trips
                    # non-array keys verbatim).
                    st["deadline_s"] = dl - time.monotonic()
                t0 = time.monotonic()
                data = encode_handoff(st)
                sent, last_err = None, None
                targets = self._handoff_targets
                now = time.monotonic()
                pool = [t for t in targets
                        if self._handoff_unhealthy.get(t, 0.0) <= now]
                if len(pool) < len(targets):
                    self.m_handoff_skipped.inc(len(targets) - len(pool))
                ordered = None
                if not pool:
                    pool = targets      # whole pool cooling: probe all
                elif self._handoff_health_interval_s > 0:
                    # health view: skip draining/recovering targets
                    # before the first attempt, try the least-loaded
                    # healthy replica first (RR breaks ties)
                    self._refresh_pool_health(pool)
                    ordered = self._order_pool(pool)
                for i in range(max(1, 2 * len(pool))):
                    if ordered:
                        target = ordered[i % len(ordered)]
                    else:
                        target = pool[self._handoff_rr % len(pool)]
                    self._handoff_rr += 1
                    try:
                        remote_rid = self._handoff_send(target, data)
                        sent = {"target": target, "rid": int(remote_rid)}
                        self._handoff_unhealthy.pop(target, None)
                        break
                    except Exception as e:  # noqa: BLE001 — next target
                        last_err = e
                        if self._handoff_cooldown_s > 0:
                            self._handoff_unhealthy[target] = \
                                time.monotonic() + self._handoff_cooldown_s
                with self._work:
                    lrid = rev.get(st["rid"])
                    ledger = self._pop_ledger(st["rid"])
                    self.h_handoff_bytes.observe(handoff_nbytes(st))
                    self.h_handoff.observe(time.monotonic() - t0)
                    if sent is not None:
                        self.m_handoff.labels("sent").inc()
                        if lrid is not None:
                            if lrid in self._handoff_gone:
                                # departed mid-ship: the decode side
                                # owns an orphan now, but THIS loop's
                                # outcome is exactly-once cancelled
                                # and no descriptor parks unclaimed
                                self._handoff_gone.discard(lrid)
                                self._account(lrid, "cancelled",
                                              ledger)
                            else:
                                self._handoff_done[lrid] = sent
                                self._account(lrid, "finished", ledger)
                    else:
                        logger.error("handoff for rid %s failed on "
                                     "every decode target: %s",
                                     st["rid"], last_err)
                        self.m_handoff.labels("failed").inc()
                        if lrid is not None:
                            self._handoff_done[lrid] = {
                                "error": f"handoff failed: {last_err}"}
                            self._account(lrid, "failed", ledger)
                    self._work.notify_all()

    def prefill(self, prompt, max_new_tokens, timeout: float = 300.0,
                deadline_s: Optional[float] = None,
                traceparent: Optional[str] = None, **sampling):
        """Prefill-role request path: submit, wait for the handoff to
        land on a decode replica, return its descriptor
        ``{"handoff": {"target", "rid"}}`` — the gateway (or client)
        then streams/fetches from the decode replica. A request whose
        first token already completes it (max_new_tokens == 1) never
        hands off: its tokens come back directly, same wire shape as
        a colocated answer.

        ``deadline_s`` is not ENFORCED here (phase 1 is short; expiry
        is the decode side's job) but it is no longer dropped: the
        pusher ships the remaining budget inside the handoff
        descriptor and the adopting replica arms it, so expired
        phase-2 work is shed early instead of decoding unread
        tokens."""
        dl_s = deadline_s if deadline_s is not None \
            else (self._default_deadline_s or None)
        if dl_s is not None:
            dl_s = float(dl_s)
            # same finite-only discipline as stream(): NaN passes every
            # comparison as a never-expiring ghost deadline
            if not math.isfinite(dl_s) or dl_s < 0:
                raise ValueError(
                    f"deadline_s must be a finite number >= 0, "
                    f"got {dl_s}")
            if dl_s == 0:       # an EXPLICIT 0 opts out of the default
                dl_s = None
        t_ask = time.perf_counter()
        with self._work:
            self._submit_wait.observe(time.perf_counter() - t_ask)
            if self._failed is not None:
                raise RuntimeError(f"serving loop failed: {self._failed}")
            if self._recovering:
                self.m_requests.labels("rejected").inc()
                raise EngineRecovering(
                    "engine restarting after a fault; retry shortly")
            if self._draining:
                raise DrainingError(
                    "server is draining (terminating); retry elsewhere")
            if dl_s is not None:
                # the budgeted prefill scheduler orders waiting chunk
                # work by TTFT slack even on a prefill-role engine;
                # engines without it just see an extra kwarg
                sampling["deadline_s"] = dl_s
            try:
                erid = self.engine.submit(prompt, max_new_tokens,
                                          **sampling)
            except QueueFull:
                self.m_requests.labels("rejected").inc()
                raise
            rid = self._next_rid
            self._next_rid += 1
            self._rid_map[rid] = erid
            self._live.add(rid)
            if dl_s is not None:
                self._prefill_deadlines[rid] = time.monotonic() + dl_s
            # the prefill side of a disaggregated request records its
            # own serve.request span (role=prefill, closed by _account
            # when the handoff ships or the request completes locally)
            # and STASHES a context for the pusher: the encoded child
            # context when recording, else the raw inbound header —
            # tracing-off prefill replicas still forward the journey
            # untouched to the decode side
            sp = tracing.start_span(
                "serve.request", component="server", parent=traceparent,
                attrs={"prompt_tokens": len(prompt),
                       "max_new_tokens": max_new_tokens,
                       "role": "prefill"})
            if sp.recording:
                self._spans[rid] = sp
                self._prefill_traceparents[rid] = sp.context.encode()
            elif traceparent:
                self._prefill_traceparents[rid] = traceparent
            self._mirror_engine_gauges()
            self._work.notify_all()
            deadline = time.monotonic() + timeout
            while True:
                done = self._handoff_done.pop(rid, None)
                if done is not None:
                    if "error" in done:
                        raise RuntimeError(done["error"])
                    return {"handoff": done}
                cur = self._rid_map.get(rid)
                prog = self.engine.progress(cur) \
                    if cur is not None else None
                if prog is not None and prog[1]:
                    # completed locally (max_new_tokens == 1): the
                    # ordinary unary answer
                    ledger = self._pop_ledger(cur)
                    self.engine.pop_result(cur)
                    self._account(rid, "finished", ledger)
                    return {"tokens": list(prompt) + prog[0]}
                if self._failed is not None:
                    raise RuntimeError(
                        f"serving loop failed: {self._failed}")
                if self._stop:
                    raise RuntimeError(
                        f"request {rid} unfinished at server shutdown")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._forget_locked(rid)
                    raise TimeoutError(f"request {rid} timed out "
                                       f"awaiting handoff")
                self._work.wait(timeout=min(remaining, 1.0))

    def _forget_locked(self, rid: int) -> None:
        """_forget's body expects to take the lock itself; this is the
        already-locked twin for the prefill wait path."""
        self._work.release()
        try:
            self._forget(rid)
        finally:
            self._work.acquire()

    def adopt(self, data: bytes) -> int:
        """Decode-role ingest: decode one handoff payload and restore
        it into the engine — byte-exact resume of the prefilled KV plus
        the committed first token. Returns the loop rid ``result`` /
        ``watch`` serve. Geometry mismatches (block size, kv_dtype,
        model dims) raise Infeasible from the engine's restore."""
        from nos_tpu_torch.models.handoff import decode_handoff
        state = decode_handoff(data)
        # deadline carried through the handoff (remaining seconds at
        # ship time): popped before restore — it is loop bookkeeping,
        # not engine KV state
        carried_dl = state.pop("deadline_s", None)
        # trace context carried the same way: the decode side's
        # serve.request span parents into the prefill side's, so one
        # trace_id spans the disaggregated pair
        carried_tp = state.pop("traceparent", None)
        t_ask = time.perf_counter()
        with self._work:
            self._submit_wait.observe(time.perf_counter() - t_ask)
            if self._failed is not None:
                raise RuntimeError(f"serving loop failed: {self._failed}")
            if self._recovering:
                raise EngineRecovering(
                    "engine restarting after a fault; retry shortly")
            if self._draining:
                raise DrainingError(
                    "server is draining (terminating); retry elsewhere")
            erid = self.engine.restore(state)
            rid = self._next_rid
            self._next_rid += 1
            self._rid_map[rid] = erid
            self._live.add(rid)
            self._adopted[rid] = list(state["prompt"])
            if self._adopt_ttl_s > 0:
                self._handoff_deadline[rid] = \
                    time.monotonic() + self._adopt_ttl_s
            if carried_dl is not None:
                # arm the carried request deadline in the SAME ledger
                # stream()'s deadlines live in: _deltas raises
                # DeadlineExceeded and _sweep_deadlines sheds it
                # mid-decode exactly like a locally-submitted request.
                # A non-positive carry (expired in transit) arms in
                # the past and the next sweep cancels it before it
                # burns a decode tick quantum.
                self._deadlines[rid] = \
                    time.monotonic() + float(carried_dl)
            sp = tracing.start_span(
                "serve.request", component="server",
                parent=carried_tp if isinstance(carried_tp, str)
                else None,
                attrs={"prompt_tokens": len(state["prompt"]),
                       "role": "decode", "adopted": True})
            if sp.recording:
                self._spans[rid] = sp
            self._mirror_engine_gauges()
            self._work.notify_all()
        return rid

    def export_chain(self, digest: str) -> Optional[bytes]:
        """KV-fabric peer-pull serve (``GET /v1/kvchain/<digest>``): one
        chain's codec payload from this replica's prefix index or host
        tier, or None. The lock is held only for the lookup and the
        enqueue of the chain's copy into a pinned slab
        (``export_chain_begin``); the wait for it and the encoding run
        outside, so peer pulls never stall ticks or admission."""
        begin = getattr(self.engine, "export_chain_begin", None)
        if begin is not None:
            with self._work:
                if self._failed is not None or self._recovering:
                    return None
                handle = begin(digest)
            if handle is None:
                return None
            return self.engine.export_chain_finish(handle)
        # engines without the two-phase surface: the whole export under
        # the lock
        export = getattr(self.engine, "export_chain", None)
        if export is None:
            return None
        with self._work:
            if self._failed is not None or self._recovering:
                return None
            return export(digest)

    def _fetch_chain_bytes(self, url: str, timeout_s: float = 2.0,
                           traceparent: Optional[str] = None) -> bytes:
        import urllib.parse
        import urllib.request
        if urllib.parse.urlsplit(url).scheme not in ("http", "https"):
            # an offer names a fleet peer's HTTP surface and nothing
            # else: file:// and friends never reach urlopen
            raise ValueError(f"kvchain fetch: non-http url {url!r}")
        req = urllib.request.Request(url)
        if self.fabric_token:
            # peer /v1/kvchain exports are token-gated (fleet-internal)
            req.add_header(FABRIC_TOKEN_HEADER, self.fabric_token)
        if traceparent:
            # the holder's kvfabric.serve span parents into this pull
            req.add_header("traceparent", traceparent)
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            if resp.status != 200:
                raise RuntimeError(f"kvchain fetch {url}: {resp.status}")
            return resp.read()

    def note_pull_denied(self, digest: Optional[str] = None,
                         parent: Optional[str] = None) -> None:
        """A ``kv_sources`` offer arrived without the fleet's fabric
        token (or none is configured): never honored (it would steer
        this replica's outbound fetcher and seed its prefix cache), only
        counted, and filed as a kvfabric.pull span into the request's
        trace when it carries one."""
        self._count_pull("pull_denied")
        if parent:
            dsp = tracing.start_span(
                "kvfabric.pull", component="kvfabric", parent=parent,
                attrs={"outcome": "pull_denied",
                       "digest": digest or ""})
            dsp.end()

    def _count_pull(self, ev: str) -> None:
        self._pull_counts[ev] += 1
        if hasattr(self, "m_kvfabric"):
            self.m_kvfabric.labels(ev).inc()

    def prefetch_chain(self, sources, tenant: Optional[str] = None,
                       deadline_s: Optional[float] = None,
                       parent: Optional[str] = None) -> bool:
        """Best-effort adoption of gateway-offered peer chains BEFORE a
        request submits: fetch the codec payload from the named peer
        (outside the lock: a slow peer must not stall the loop), then
        ingest it under the lock so the request's own prefix match hits
        warm. Offers without a digest are ignored (the digest binds the
        pull to one (scope, tokens) identity, which ingest re-checks).
        Every failure returns False (counted pull_miss) and the request
        prefills."""
        ok = False
        for src in sources if isinstance(sources, list) else ():
            if not isinstance(src, dict):
                continue
            url, digest = src.get("url"), src.get("digest")
            if not isinstance(url, str) or not url \
                    or not isinstance(digest, str) or not digest:
                continue
            psp = tracing.start_span(
                "kvfabric.pull", component="kvfabric", parent=parent,
                attrs={"digest": digest, "url": url})
            adopted = self._pull_single_flight(
                url, digest, tenant, deadline_s,
                traceparent=(psp.context.encode() if psp.recording
                             else None))
            outcome = "pull_hit" if adopted else "pull_miss"
            psp.set_attr("outcome", outcome)
            psp.end()
            self._count_pull(outcome)
            ok = ok or adopted
        return ok

    def _pull_single_flight(self, url: str, digest: str,
                            tenant: Optional[str],
                            deadline_s: Optional[float],
                            traceparent: Optional[str] = None) -> bool:
        """One fetch and ingest per digest at a time: concurrent
        requests sharing one cold prefix ride the leader's pull, and
        when it lands each rider's own prefix match hits warm."""
        with self._pull_lock:
            flight = self._pull_inflight.get(digest)
            leader = flight is None
            if leader:
                flight = {"done": threading.Event(), "adopted": False}
                self._pull_inflight[digest] = flight
        if not leader:
            flight["done"].wait(
                timeout=self.chain_fetch_timeout_s + 5.0)
            return flight["adopted"]
        try:
            flight["adopted"] = self._pull_once(url, digest, tenant,
                                                deadline_s, traceparent)
        finally:
            with self._pull_lock:
                self._pull_inflight.pop(digest, None)
            flight["done"].set()
        return flight["adopted"]

    def _pull_once(self, url: str, digest: str,
                   tenant: Optional[str],
                   deadline_s: Optional[float],
                   traceparent: Optional[str] = None) -> bool:
        timeout = self.chain_fetch_timeout_s
        if deadline_s is not None:
            # never wait on a peer longer than the request's own budget
            timeout = max(0.1, min(timeout, float(deadline_s)))
        try:
            if self.chain_fetch is not None:
                data = self.chain_fetch(url)
            else:
                data = self._fetch_chain_bytes(url, timeout_s=timeout,
                                               traceparent=traceparent)
            with self._work:
                if self._failed is not None or self._recovering:
                    raise RuntimeError("loop not serving")
                return bool(self.engine.ingest_chain(
                    data, tenant, expect_digest=digest))
        except Exception as exc:
            logger.debug("kvfabric pull failed: %s", exc)
            return False

    def watch(self, rid: int, timeout: float = 300.0):
        """Attach to an adopted request's token stream (the decode-side
        SSE surface after a handoff): yields newly-decoded token lists
        exactly like ``stream``, for a request that entered via
        ``adopt`` instead of ``submit``."""
        with self._work:
            if self._rid_map.get(rid) is None:
                raise ValueError(f"unknown request {rid}")
            # a consumer owns the lifecycle now (its disconnect runs
            # _forget): the unclaimed-orphan TTL stands down
            self._handoff_deadline.pop(rid, None)
        return _Stream(self, rid, self._deltas(rid, timeout))

    def result(self, rid: int, timeout: float = 300.0):
        """Block for an adopted request's full sequence (prompt +
        generated) — the decode-side unary surface after a handoff.
        Idempotent once finished (until the re-fetch TTL expires): a
        gateway retrying after a socket timeout gets the same tokens
        its abandoned first attempt drained."""
        with self._work:
            final = self._adopted_final.get(rid)
            if final is not None:
                return list(final)
            prompt = self._adopted.get(rid)
            if prompt is None:
                raise ValueError(f"unknown request {rid}")
            self._handoff_deadline.pop(rid, None)   # consumer attached
        out = list(prompt)
        try:
            for delta in self._deltas(rid, timeout):
                out.extend(delta)
        except RuntimeError:
            # "request N vanished": a concurrent result() handler for
            # the same rid (an abandoned attempt the client timed out
            # on) won the engine pop — its parked final answers us.
            # Brief recheck window: the winner's pop (inside _deltas)
            # and its park below are two lock acquisitions apart.
            end = time.monotonic() + 2.0
            with self._work:
                while True:
                    final = self._adopted_final.get(rid)
                    if final is not None:
                        return list(final)
                    if time.monotonic() >= end:
                        break
                    self._work.wait(timeout=0.05)
            raise
        with self._work:
            self._adopted_final[rid] = list(out)
            if self._adopt_ttl_s > 0:
                # re-fetch grace window; _reap_orphans drops it after
                self._handoff_deadline[rid] = \
                    time.monotonic() + self._adopt_ttl_s
            self._adopted.pop(rid, None)
            self._work.notify_all()
        return out

    def generate(self, prompt, max_new_tokens, timeout: float = 300.0,
                 deadline_s: Optional[float] = None,
                 traceparent: Optional[str] = None, **sampling):
        """Unary request: expressed over ``stream`` so there is exactly
        one waiting/abandon/metrics implementation."""
        out = list(prompt)
        for delta in self.stream(prompt, max_new_tokens, timeout,
                                 deadline_s=deadline_s,
                                 traceparent=traceparent, **sampling):
            out.extend(delta)
        return out

    def _forget(self, rid: int) -> None:
        """Idempotently drop a request in whatever state it is: pop it if
        resolvable (accounting the terminal outcome), mark it abandoned
        if still decoding (the ticker reaps it), no-op if already handed
        out. ``cancelled`` for a client that walked away, ``failed`` when
        the pop happens during an engine-failure or shutdown drain."""
        with self._work:
            # None (no map entry): already terminally accounted; the bare
            # rid must NOT be used against the engine
            erid = self._rid_map.get(rid)
            if rid in self._deadline_hit or rid in self._lost_rids:
                # already terminally accounted: clear leftovers, never
                # account twice (the tombstone survives a recovery)
                if not self._recovering:
                    self._deadline_hit.discard(rid)
                    self._lost_rids.discard(rid)
                self._abandoned.discard(rid)
                return
            if erid is None or self.engine.progress(erid) is None:
                # prefill role: the request may be parked as, or already
                # shipped as, a handoff. Drop any unclaimed descriptor,
                # and mark a still-live rid so the pusher resolves a
                # departed client's handoff as cancelled
                self._handoff_done.pop(rid, None)
                if self.role == "prefill" and rid in self._live:
                    self._handoff_gone.add(rid)
                self._abandoned.discard(rid)    # already popped
                return
            draining_out = self._failed is not None or self._stop
            # stop burning ticks on output nobody will read: cancel frees
            # the slot now (a dead or recovering engine is not asked)
            cancel = getattr(self.engine, "cancel", None)
            if cancel is not None and self._failed is None \
                    and not self._recovering:
                cancel(erid)
            ledger = self._pop_ledger(erid)
            if self.engine.pop_result(erid) is not None:
                self._account(rid, "failed" if draining_out
                              else "cancelled", ledger)
                self._abandoned.discard(rid)
            elif draining_out:
                # no tick will ever finish this request: account it NOW
                if rid not in self._failed_drained:
                    self._failed_drained.add(rid)
                    self._account(rid, "failed", ledger)
                self._abandoned.discard(rid)
            elif self.engine.progress(erid) is None:
                # cancel dropped it outright and the engine may be idle
                self._account(rid, "cancelled", ledger)
                self._abandoned.discard(rid)
            else:
                self._abandoned.add(rid)
            # cancel mutated occupancy and an idle server may never tick
            self._mirror_engine_gauges()

    def _mirror_engine_gauges(self) -> None:
        """Engine-held stats (prefix cache, occupancy, block pool) ->
        gauges, from every path that mutates them and once at start."""
        hits = getattr(self.engine, "prefix_hits", None)
        if hits is not None:
            self.m_prefix_hits.set(hits)
            self.m_prefix_saved.set(self.engine.prefix_tokens_saved)
        tenant_snap = getattr(self.engine, "tenant_snapshot", None)
        if self._tenant_cfg is not None and tenant_snap is not None:
            snap = tenant_snap()
            for t, row in (snap or {}).items():
                self.g_tenant_borrowed.labels(t).set(
                    row.get("borrowed_tokens_per_s", 0.0))
                for mode, n in (row.get("preempts") or {}).items():
                    seen = self._tenant_preempt_seen.get((t, mode), 0)
                    if n > seen:
                        self.m_tenant_preempt.labels(t, mode).inc(
                            n - seen)
                        self._tenant_preempt_seen[(t, mode)] = n
        pindex = getattr(self.engine, "_pindex", None)
        if pindex is not None and hasattr(self, "m_prefix_evict"):
            for tier, n in pindex.evicted.items():
                delta = n - self._prefix_evict_seen.get(tier, 0)
                if delta > 0:
                    self.m_prefix_evict.labels(tier).inc(delta)
                    self._prefix_evict_seen[tier] = n
            for ev, n in getattr(self.engine, "_fabric", {}).items():
                if ev not in self._fabric_seen:
                    continue    # ingest counts ride pull_hit/pull_miss
                delta = n - self._fabric_seen[ev]
                if delta > 0:
                    self.m_kvfabric.labels(ev).inc(delta)
                    self._fabric_seen[ev] = n
        if hasattr(self, "m_psched_spent"):
            for attr, key, m in (
                    ("prefill_budget_spent", "spent",
                     self.m_psched_spent),
                    ("prefill_budget_clamped", "clamped",
                     self.m_psched_clamp),
                    ("prefill_budget_overrides", "overrides",
                     self.m_psched_override)):
                n = getattr(self.engine, attr, 0)
                delta = n - self._psched_seen[key]
                if delta > 0:
                    m.inc(delta)
                    self._psched_seen[key] = n
        self._mirror_chip_ledger()
        occupancy = getattr(self.engine, "occupancy", None)
        if occupancy is not None:
            active, pending = occupancy()
            self.g_active.set(active)
            self.g_pending.set(pending)
        drafted = getattr(self.engine, "spec_drafted", None)
        if drafted is not None and hasattr(self, "m_spec_draft"):
            for key, n, m in (
                    ("drafted", drafted, self.m_spec_draft),
                    ("accepted", self.engine.spec_accepted,
                     self.m_spec_accepted)):
                delta = n - self._spec_seen[key]
                if delta > 0:
                    m.inc(delta)
                    self._spec_seen[key] = n
            events = self.engine.spec_window_events
            if events:
                self.engine.spec_window_events = []
                for a in events:
                    self.h_spec_window.observe(float(a))
        kv_stats = getattr(self.engine, "kv_stats", None)
        kv = kv_stats() if kv_stats is not None else None
        if kv:
            self.g_kv_free.set(kv["blocks_free"])
            self.g_kv_used.set(kv["blocks_used"])
            self.g_kv_shared.set(kv["cow_shared"])
            for mode, n in kv["preempts"].items():
                delta = n - self._preempt_seen.get(mode, 0)
                if delta > 0:
                    self.m_preempt.labels(mode).inc(delta)
                    self._preempt_seen[mode] = n
            # the engine's admission-time memory snapshot feeds the same
            # gauges the interval sampler owns
            hbm = kv.get("hbm")
            if hbm and hbm.get("in_use") is not None:
                self._set_device_gauges(hbm["device"], hbm["in_use"],
                                        hbm.get("limit"))
        self._drain_compile_events()
        self._drain_prefill_events()

    def _mirror_chip_ledger(self) -> None:
        """Delta-mirror the engine's chip ledger into the chip-ms and
        kv-byte-seconds counters and the loop's cumulative totals, which
        survive a supervised engine swap (``_do_recover`` resets the
        seen dicts when a rebuilt engine restarts its ledger)."""
        chip = getattr(self.engine, "chip", None)
        if chip is None or self.slo_engine is None:
            return
        for key, ns in chip.totals_ns().items():
            delta = ns - self._chip_seen_ns.get(key, 0)
            if delta > 0:
                self._chip_seen_ns[key] = ns
                self._chip_cum_ns[key] = \
                    self._chip_cum_ns.get(key, 0) + delta
                self.m_chip_ms.labels(*key).inc(delta / 1e6)
        delta = chip.wall_ns - self._chip_seen_wall_ns
        if delta > 0:
            self._chip_seen_wall_ns = chip.wall_ns
            self._chip_cum_wall_ns += delta
        for t, bs in chip.kv_byte_seconds().items():
            d = bs - self._chip_seen_kvbs.get(t, 0.0)
            if d > 0:
                self._chip_seen_kvbs[t] = bs
                self._chip_cum_kvbs[t] = \
                    self._chip_cum_kvbs.get(t, 0.0) + d
                self.m_kv_byte_s.labels(t).inc(d)

    def _chip_ledger_block(self) -> Optional[dict]:
        """/stats ``chip_ledger``: the loop's cumulative attribution
        totals (None = SLO accounting off). Conservation is judged on
        the cumulative integers, so it holds across engine swaps."""
        if self.slo_engine is None:
            return None
        self._mirror_chip_ledger()
        per: dict = {}
        for (t, ph), ns in sorted(self._chip_cum_ns.items()):
            per.setdefault(t, {})[ph] = round(ns / 1e6, 3)
        return {
            "wall_ms": round(self._chip_cum_wall_ns / 1e6, 3),
            "chip_ms": per,
            "kv_byte_seconds": {
                t: round(v, 3)
                for t, v in sorted(self._chip_cum_kvbs.items())},
            "conserved": (sum(self._chip_cum_ns.values())
                          == self._chip_cum_wall_ns),
        }

    def stream(self, prompt, max_new_tokens, timeout: float = 300.0,
               deadline_s: Optional[float] = None,
               tenant: Optional[str] = None,
               traceparent: Optional[str] = None, **sampling):
        """Streaming primitive: submits EAGERLY (validation errors raise
        here, before the caller commits response headers) and returns an
        iterator yielding lists of newly-decoded tokens as ticks land.
        ``close()`` at ANY point drops the request via ``_forget``.

        ``deadline_s`` (default: the loop's ``default_deadline_s``; 0 /
        None = none): shed at admission when the rolling estimates say it
        cannot be met (DeadlineUnmeetable, HTTP 429), cancelled at the
        next tick barrier once expired (the iterator raises
        DeadlineExceeded). ``tenant`` is the request-level quota
        identity: it rides to the engine's weighted admission and keys
        the per-tenant goodput, shed and preempt accounting here."""
        tlabel = (self._tenant_cfg.resolve(tenant)
                  if self._tenant_cfg is not None else None)
        # the request's entry: its span starts here, before the lock
        t_entry = time.perf_counter()
        start = tracing.tracer().clock()
        with self._work:
            t_locked = time.perf_counter()
            self._submit_wait.observe(t_locked - t_entry)
            if self._failed is not None:
                raise RuntimeError(f"serving loop failed: {self._failed}")
            if self._recovering:
                # shed at the door: the request's one outcome is
                # ``rejected``
                self.m_requests.labels("rejected").inc()
                raise EngineRecovering(
                    "engine restarting after a fault; retry shortly")
            if self._draining:
                raise DrainingError(
                    "server is draining (terminating); retry elsewhere")
            dl_s = deadline_s if deadline_s is not None \
                else (self._default_deadline_s or None)
            if dl_s is not None:
                dl_s = float(dl_s)
                # finite-only: NaN would pass every comparison below as
                # a never-expiring ghost deadline
                if not math.isfinite(dl_s) or dl_s < 0:
                    raise ValueError(
                        f"deadline_s must be a finite number >= 0, "
                        f"got {dl_s}")
                if dl_s == 0:
                    # an EXPLICIT 0 opts out of the server default
                    dl_s = None
            if dl_s is not None:
                est, est_tokens = self._estimate_completion_s(
                    max_new_tokens)
                # the chunk queue ahead of this request delays its TTFT:
                # its estimated seconds count at admission, the earliest
                # layer that can know the deadline is dead
                backlog_fn = getattr(self.engine, "prefill_backlog_s",
                                     None)
                backlog_s = float(backlog_fn() or 0.0) \
                    if backlog_fn is not None else 0.0
                if est is not None:
                    est += backlog_s
                if est is not None and est > dl_s \
                        and (self._shed_streak + 1) \
                        % DEADLINE_PROBE_EVERY != 0:
                    # shed EARLY; every DEADLINE_PROBE_EVERY'th
                    # consecutive shed is admitted as a probe whose
                    # completion refreshes the estimates
                    self.m_requests.labels("deadline").inc()
                    self._deadline_shed += 1
                    self._shed_streak += 1
                    if tlabel is not None:
                        self.m_tenant_shed.labels(
                            tlabel, "deadline_unmeetable").inc()
                    raise DeadlineUnmeetable(
                        f"deadline {dl_s:.3f}s cannot be met: rolling "
                        f"estimates put completion at {est:.3f}s "
                        f"(ttft ~{self._est_ttft_s:.3f}s, ~"
                        f"{max(0.0, est_tokens - 1):.0f} expected "
                        f"tokens at "
                        f"~{(self._est_tpot_s or 0.0) * 1e3:.1f}ms "
                        f"each"
                        + (f", plus ~{backlog_s:.3f}s of chunked "
                           f"prefill queued ahead" if backlog_s else "")
                        + "); retry with a longer deadline or when "
                        "load drops")
            if tenant is not None:
                sampling["tenant"] = tenant
            if dl_s is not None:
                sampling["deadline_s"] = dl_s
            try:
                erid = self.engine.submit(prompt, max_new_tokens,
                                          **sampling)
            except QueueFull as e:
                self.m_requests.labels("rejected").inc()
                if tlabel is not None:
                    # the tenant's own ceiling and the shared capacity
                    # reasons alike, attributed to the tenant
                    self.m_tenant_shed.labels(
                        tlabel, getattr(e, "reason", "queue_full")).inc()
                raise
            rid = self._next_rid
            self._next_rid += 1
            self._rid_map[rid] = erid
            self._live.add(rid)
            if tlabel is not None:
                self._tenant_of[rid] = tlabel
            self._shed_streak = 0       # an admission ends the streak
            if dl_s is not None:
                self._deadlines[rid] = time.monotonic() + dl_s
            # one span per REQUEST, from its entry, closed by _account;
            # an inbound ``traceparent`` is adopted instead of minting a
            # fresh trace
            sp = tracing.start_span(
                "serve.request", component="server", parent=traceparent,
                attrs={"prompt_tokens": len(prompt),
                       "max_new_tokens": max_new_tokens},
                start_time=start)
            if sp.recording:
                self._spans[rid] = sp
            self._mirror_engine_gauges()
            self._work.notify_all()

        entry = (sp, start, t_entry, t_locked) if sp.recording else None
        return _Stream(self, rid, self._deltas(rid, timeout, entry))

    def _deltas(self, rid: int, timeout: float, entry=None):
        """The one token-delta generator behind ``stream`` and ``watch``:
        yields newly-decoded token lists until the request finishes,
        waiting on the loop's condition (never polling). The first yield
        observes the first token's delivery and, with ``entry`` (the
        request's recording span, its entry on the tracer's clock and on
        the ledger's, and the moment it held the lock), closes the span's
        children up to the first token."""
        sent = 0
        finished = False
        stamps = None
        deadline = time.monotonic() + timeout
        with self._work:
            self._watchers[rid] = self._watchers.get(rid, 0) + 1
        try:
            while True:
                with self._work:
                    # own-deadline check first: expiry beats both
                    # further waiting and the vanished error
                    dl = self._deadlines.get(rid)
                    if dl is not None and time.monotonic() > dl \
                            and rid not in self._deadline_hit:
                        self._expire_deadline(rid)
                    if rid in self._deadline_hit:
                        raise DeadlineExceeded(
                            f"request {rid} exceeded its deadline")
                    if rid in self._lost_rids:
                        raise RuntimeError(
                            f"request {rid} lost in engine restart")
                    erid = self._rid_map.get(rid)
                    prog = self.engine.progress(erid) \
                        if erid is not None else None
                    if prog is None:
                        if self._recovering:
                            # mid-restore: wait for the rebuilt engine
                            self._work.wait(timeout=0.05)
                            continue
                        if self._failed is not None:
                            raise RuntimeError(
                                f"serving loop failed: {self._failed}")
                        # reaped out from under us (shutdown race)
                        raise RuntimeError(f"request {rid} vanished")
                    toks, done = prog
                    delta = toks[sent:]
                    if delta and not sent:
                        # before a finished request's result is popped
                        get = getattr(self.engine, "first_token_stamps",
                                      None)
                        stamps = get(erid) if get is not None else None
                    if done:
                        ledger = self._pop_ledger(erid)
                        self.engine.pop_result(erid)
                        self._account(rid, "finished", ledger)
                        finished = True
                    elif not delta:
                        if self._failed is not None:
                            raise RuntimeError(
                                f"serving loop failed: {self._failed}")
                        if self._stop:
                            # no tick will ever finish this request
                            raise RuntimeError(
                                f"request {rid} unfinished at server "
                                "shutdown")
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise TimeoutError(
                                f"request {rid} timed out")
                        self._work.wait(timeout=min(remaining, 1.0))
                        continue
                if delta:
                    if not sent and stamps is not None:
                        self._first_yield(stamps, entry)
                    sent += len(delta)
                    yield delta
                if finished:
                    return
        finally:
            with self._work:
                left = self._watchers.get(rid, 0) - 1
                if left > 0:
                    self._watchers[rid] = left
                else:
                    self._watchers.pop(rid, None)
            if not finished and left <= 0:
                # timeout / failure / client gone, and no OTHER consumer
                self._forget(rid)

    def _first_yield(self, stamps: tuple, entry) -> None:
        """A request's first token reaches its stream: observe the
        delivery, and with ``entry`` tile its span up to now with
        ``serve.lock_wait`` (entry -> lock held), ``engine.queue``
        (submit -> admission), ``engine.prefill`` (admission -> first
        token on the host) and ``serve.first_token`` (-> this yield),
        each stamp moved onto the tracer's clock."""
        t_submit, t_admit, t_first = stamps
        now = time.perf_counter()
        self.h_first_delivery.observe(max(0.0, now - t_first))
        if entry is None:
            return
        sp, start, t_entry, t_locked = entry
        t_admit = min(max(t_admit, t_submit), t_first)
        for name, a, b in (("serve.lock_wait", t_entry, t_locked),
                           ("engine.queue", t_submit, t_admit),
                           ("engine.prefill", t_admit, t_first),
                           ("serve.first_token", t_first, now)):
            child = tracing.start_span(name, component="server",
                                       parent=sp,
                                       start_time=start + (a - t_entry))
            child.end(end_time=start + (b - t_entry))

    def _forget_if_unwatched(self, rid: int) -> None:
        """_Stream.close()'s forget: skipped while another consumer is
        still attached to the rid."""
        with self._work:
            if self._watchers.get(rid, 0) > 0:
                return
        self._forget(rid)

    def _reap_orphans(self) -> None:
        """Decode-role reaper thread: an adopted handoff whose consumer
        never attached (the gateway crashed mid-resume, or phase 2
        exhausted its retries — the pusher's 'decode side owns an
        orphan now' case) would otherwise decode to completion and park
        its result, ledger and rid maps forever. Whatever is still
        armed in _handoff_deadline past its TTL is dropped: unclaimed
        live requests are cancelled out of the engine (terminal
        ``cancelled``, exactly once), consumed finals just leave the
        re-fetch cache."""
        period = min(5.0, max(0.1, self._adopt_ttl_s / 4.0))
        while not self._stop_event.wait(period):
            expired: list = []
            with self._work:
                if not self._handoff_deadline:
                    continue
                now = time.monotonic()
                for rid, dl in list(self._handoff_deadline.items()):
                    if now <= dl:
                        continue
                    self._handoff_deadline.pop(rid, None)
                    if self._adopted_final.pop(rid, None) is not None:
                        self._adopted.pop(rid, None)
                    else:
                        expired.append(rid)
            for rid in expired:
                self._forget(rid)

    def shutdown(self) -> None:
        """Stop the loop deterministically, INCLUDING during an
        in-progress recovery (which then drains its captured requests as
        ``failed`` and fails the loop terminally)."""
        with self._work:
            self._stop = True
            self._work.notify_all()
        self._stop_event.set()
        self._thread.join(timeout=5)
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=5)
        if self._handoff_thread is not None:
            self._handoff_thread.join(timeout=5)
        if self._orphan_thread is not None:
            self._orphan_thread.join(timeout=5)


class _Stream:
    """Iterator over a streamed request whose ``close()`` is safe in
    every state: a started generator runs its finally; a NEVER-started
    one gets the explicit idempotent ``_forget``."""

    def __init__(self, loop: "ServingLoop", rid: int, gen):
        self._loop = loop
        self.rid = rid
        self._gen = gen

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self) -> None:
        self._gen.close()
        self._loop._forget_if_unwatched(self.rid)



def build_engine(cfg: ServerConfig, device: DeviceLike = None):
    """Make params (restored from ``cfg.checkpoint_dir`` or seeded, int8
    twin when ``cfg.int8``) and build the continuous-batching engine on
    ``device`` (default: the card): a ``SpeculativeDecodeServer`` with
    the draft restored from ``cfg.draft_checkpoint_dir`` when that is
    set, else a ``DecodeServer``. The paged attention formulation goes
    to the engine as its ``paged_impl``; nothing is written to the
    environment."""
    from nos_tpu_torch.cmd.generate import GenerateConfig, load_params
    from nos_tpu_torch.models.serving import DecodeServer

    # config errors must fire BEFORE the (multi-GB) weights are made
    if cfg.prefill_chunk and (cfg.prefill_chunk < 8 or
                              cfg.prefill_chunk & (cfg.prefill_chunk - 1)):
        raise ValueError(
            f"prefill_chunk must be 0 or a power of two >= 8, got "
            f"{cfg.prefill_chunk}")
    if cfg.prefill_budget < 0:
        raise ValueError(
            f"prefill_budget must be >= 0, got {cfg.prefill_budget}")
    if cfg.prefill_budget and not cfg.prefill_chunk:
        raise ValueError(
            "prefill_budget requires chunked prefill (set "
            "prefill_chunk): the budget schedules chunk forwards, and "
            "without chunking there is nothing to budget")
    if cfg.pipeline_depth < 1:
        raise ValueError(
            f"pipeline_depth must be >= 1, got {cfg.pipeline_depth}")
    if cfg.decode_steps < 1:
        raise ValueError(
            f"decode_steps must be >= 1, got {cfg.decode_steps}")
    if cfg.kv_dtype not in ("bf16", "int8"):
        raise ValueError(
            f"kv_dtype must be bf16|int8, got {cfg.kv_dtype!r}")
    if cfg.kv_dtype == "int8" and not cfg.kv_blocks:
        raise ValueError(
            "kv_dtype=int8 requires the paged KV cache: set "
            "kv_blocks/kv_block_size (the slot-static engine has no "
            "per-block scale storage, so int8 KV is not supported "
            "there) — or run kv_dtype=bf16")
    if cfg.paged_kernel not in ("on", "off"):
        raise ValueError(
            f"paged_kernel must be on|off, got {cfg.paged_kernel!r}")
    # the kernel walks per-slot block tables, so without kv_blocks
    # "on" is inert
    paged_impl = ("kernel" if cfg.paged_kernel == "on" and cfg.kv_blocks
                  else "xla")
    if cfg.draft_checkpoint_dir and cfg.draft_n_tokens < 1:
        raise ValueError(
            f"draft_n_tokens must be >= 1, got {cfg.draft_n_tokens}")
    if cfg.kv_blocks:
        bs = cfg.kv_block_size
        if bs < 8 or bs & (bs - 1):
            raise ValueError(
                f"kv_block_size must be a power of two >= 8 when "
                f"kv_blocks is set, got {bs}")
        if cfg.max_seq % bs:
            raise ValueError(
                f"max_seq {cfg.max_seq} must be a multiple of "
                f"kv_block_size {bs}")
        if cfg.kv_blocks < 2:
            raise ValueError(
                f"kv_blocks must be >= 2 (one reserved null block plus "
                f"at least one usable), got {cfg.kv_blocks}")
    if cfg.role not in ("colocated", "prefill", "decode"):
        raise ValueError(
            f"role must be colocated|prefill|decode, got {cfg.role!r}")
    if cfg.role != "colocated" and not cfg.kv_blocks:
        raise ValueError(
            f"role={cfg.role} requires the paged KV cache (set "
            f"kv_blocks/kv_block_size): the prefill->decode handoff "
            f"payload is the paged swap format — quantized blocks + "
            f"per-block scales — which the slot-static engine cannot "
            f"produce or adopt")
    if cfg.role == "prefill" and not cfg.decode_pool.strip():
        raise ValueError(
            "role=prefill requires --decode-pool (comma-separated "
            "decode-replica base URLs): a prefill server with nowhere "
            "to ship its handoffs would strand every request after "
            "its first token")
    if cfg.role == "prefill" and cfg.draft_checkpoint_dir:
        raise ValueError(
            "role=prefill with speculative decoding is pointless: a "
            "prefill replica never decodes, so the draft would only "
            "burn HBM — run the draft on the decode side "
            "(role=decode re-prefills it from each adopted handoff) "
            "or colocated")
    if cfg.kv_host_tier_bytes < 0:
        raise ValueError(
            f"kv_host_tier_bytes must be >= 0, got "
            f"{cfg.kv_host_tier_bytes}")
    if cfg.kv_host_tier_bytes and not (cfg.kv_blocks
                                       and cfg.prefix_cache_size):
        raise ValueError(
            "kv_host_tier_bytes requires the paged KV cache with a "
            "prefix cache (set kv_blocks/kv_block_size AND "
            "prefix_cache_size): the host tier stores demoted prefix "
            "chains, which only the paged prefix index produces — "
            "without one there is nothing to demote")
    # the mesh's checks, still before any weights
    mesh = _serving_mesh(cfg, device)
    # parsed here so the supervisor's rebuild factory re-creates a
    # tenant-aware engine from the same config
    tenant_quota = TenantQuotaConfig.load(cfg.tenant_config)
    # the host tier is built per engine: a rebuilt engine starts with an
    # empty one, and demotions refill it
    host_tier = (HostTierStore(cfg.kv_host_tier_bytes)
                 if cfg.kv_host_tier_bytes else None)
    device = mesh.devices[0] if mesh is not None else resolve_device(device)
    if cfg.kv_blocks:
        check_paged_kernel_head_dim(cfg.d_model // cfg.n_heads, device,
                                    paged_impl)
    gcfg = GenerateConfig(
        vocab=cfg.vocab, d_model=cfg.d_model, n_layers=cfg.n_layers,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
        max_seq=cfg.max_seq, n_experts=cfg.n_experts, bf16=cfg.bf16,
        checkpoint_dir=cfg.checkpoint_dir, int8=cfg.int8, seed=cfg.seed)
    model_cfg, params = load_params(gcfg, device)
    if cfg.draft_checkpoint_dir:
        from nos_tpu_torch.models.spec_serving import SpeculativeDecodeServer

        # the draft at its own widths, from its checkpoint (never int8)
        dcfg_in = GenerateConfig(
            vocab=cfg.vocab, d_model=cfg.draft_d_model,
            n_layers=cfg.draft_n_layers, n_heads=cfg.draft_n_heads,
            n_kv_heads=cfg.draft_n_kv_heads, d_ff=cfg.draft_d_ff,
            max_seq=cfg.max_seq, bf16=cfg.bf16,
            checkpoint_dir=cfg.draft_checkpoint_dir, seed=cfg.seed)
        draft_cfg, draft_params = load_params(dcfg_in, device)
        # the engine splits both models over the mesh, as the
        # reference's device_put of each by its param_shardings
        return SpeculativeDecodeServer(
            params, model_cfg, draft_params, draft_cfg,
            n_draft=cfg.draft_n_tokens, max_batch=cfg.max_batch,
            prefix_cache_size=cfg.prefix_cache_size, mesh=mesh,
            prefill_chunk=cfg.prefill_chunk, max_pending=cfg.max_pending,
            # the speculative engine rides the full dispatch template:
            # pipelined windows, fused rounds, paged + int8 KV all apply
            pipeline_depth=cfg.pipeline_depth,
            decode_steps=cfg.decode_steps,
            kv_block_size=cfg.kv_block_size, kv_blocks=cfg.kv_blocks,
            kv_swap=cfg.kv_swap, hbm_admit_frac=cfg.kv_hbm_admit_frac,
            kv_dtype=cfg.kv_dtype, tenant_quota=tenant_quota,
            role=cfg.role, host_tier=host_tier,
            prefill_budget=cfg.prefill_budget, device=device,
            paged_impl=paged_impl)
    return DecodeServer(params, model_cfg, max_batch=cfg.max_batch,
                        prefix_cache_size=cfg.prefix_cache_size,
                        prefill_chunk=cfg.prefill_chunk,
                        prefill_budget=cfg.prefill_budget,
                        max_pending=cfg.max_pending,
                        pipeline_depth=cfg.pipeline_depth,
                        decode_steps=cfg.decode_steps,
                        kv_block_size=cfg.kv_block_size,
                        kv_blocks=cfg.kv_blocks, kv_swap=cfg.kv_swap,
                        hbm_admit_frac=cfg.kv_hbm_admit_frac,
                        kv_dtype=cfg.kv_dtype, tenant_quota=tenant_quota,
                        role=cfg.role, host_tier=host_tier, mesh=mesh,
                        device=device, paged_impl=paged_impl)


def _serving_mesh(cfg: ServerConfig, device: DeviceLike):
    """``cfg.tp`` > 1: the ``TpMesh`` of the first tp visible CUDA
    devices (tp CPU shards under ``device="cpu"``), after the
    reference's checks; else None."""
    if cfg.tp <= 1:
        return None
    from nos_tpu_torch.parallel.mesh import TpMesh

    if device is not None and torch.device(device).type == "cpu":
        devs = ["cpu"] * cfg.tp
    else:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < cfg.tp:
            raise ValueError(
                f"tp={cfg.tp} but only {n} devices visible")
        devs = [f"cuda:{i}" for i in range(cfg.tp)]
    kv = cfg.n_kv_heads or cfg.n_heads
    if kv % cfg.tp:
        raise ValueError(
            f"kv_heads {kv} not divisible by tp={cfg.tp}; the "
            f"cache head axis cannot shard evenly")
    if cfg.draft_checkpoint_dir:
        dkv = cfg.draft_n_kv_heads or cfg.draft_n_heads
        if dkv % cfg.tp:
            raise ValueError(
                f"draft kv_heads {dkv} not divisible by tp={cfg.tp}; "
                f"the draft cache head axis cannot shard evenly")
    return TpMesh(devs)


def make_http_server(cfg: ServerConfig, loop: ServingLoop,
                     host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """The reference's HTTP surface over ``loop`` on ``host:cfg.port``:
    the same endpoints, status codes, headers, JSON and SSE framing."""

    class Handler(BaseHTTPRequestHandler):
        # a stalled read/write raises TimeoutError instead of pinning a
        # non-daemon handler thread past the drain window
        timeout = cfg.socket_timeout_s or None

        def log_message(self, fmt, *args):      # route through logging
            logger.debug("http: " + fmt, *args)

        def _reply(self, code: int, body: dict, headers=()) -> None:
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            for name, value in headers:
                self.send_header(name, value)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                ok = loop.healthy
                self._reply(200 if ok else 500,
                            {"status": "ok" if ok else "unhealthy"})
            elif self.path == "/readyz":
                # draining flips readiness first; a supervised recovery
                # reports ``degraded`` (also 503) while /healthz stays
                # green
                if loop.draining:
                    self._reply(503, {"status": "draining"})
                elif loop.recovering:
                    self._reply(503, {"status": "degraded"},
                                headers=[("Retry-After", "1")])
                else:
                    self._reply(200, {"status": "ok"})
            elif self.path == "/metrics":
                text, ctype = metrics_payload(
                    self.headers.get("Accept", ""))
                body = text.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/stats":
                self._reply(200, loop.stats())
            elif self.path.startswith("/v1/result/"):
                # decode-role unary attach: the full sequence of an
                # adopted handoff once it finishes
                try:
                    rid = int(self.path.rsplit("/", 1)[1].split("?")[0])
                    tokens = loop.result(rid, timeout=cfg.drain_timeout_s
                                         + 270.0)
                except ValueError as e:
                    self._reply(404, {"error": str(e),
                                      "reason": "unknown_rid"})
                    return
                except DeadlineExceeded as e:
                    self._reply(504, {"error": str(e),
                                      "deadline_exceeded": True})
                    return
                except TimeoutError as e:
                    self._reply(503, {"error": str(e),
                                      "reason": "timeout"})
                    return
                except Exception as e:  # noqa: BLE001 — JSON 500
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                self._reply(200, {"tokens": tokens})
            elif self.path.startswith("/v1/stream/"):
                # streaming attach by rid: SSE over the remaining tokens
                try:
                    rid = int(self.path.rsplit("/", 1)[1].split("?")[0])
                    gen = loop.watch(rid)
                except ValueError as e:
                    self._reply(404, {"error": str(e),
                                      "reason": "unknown_rid"})
                    return
                self._stream_sse(gen)
            elif self.path.startswith("/v1/kvchain/"):
                # KV-fabric peer pull: one prefix chain's codec payload
                # by fleet digest, served raw (octet-stream: it is the
                # handoff wire format) from the prefix index or the host
                # tier; 404 when it aged out (the puller prefills).
                # Digests are public arithmetic over scope + tokens, so
                # the export is gated by the fleet's shared token and
                # closed when none is set.
                digest = self.path.rsplit("/", 1)[1].split("?")[0]
                # the holder's side of a peer pull, recorded only when
                # the pull carries a trace
                inbound_tp = self.headers.get("traceparent")
                ssp = tracing.start_span(
                    "kvfabric.serve", component="kvfabric",
                    parent=inbound_tp,
                    attrs={"digest": digest}) if inbound_tp \
                    else tracing.NOOP_SPAN
                if not cfg.kv_fabric_token or self.headers.get(
                        FABRIC_TOKEN_HEADER) != cfg.kv_fabric_token:
                    ssp.set_attr("outcome", "denied")
                    ssp.end()
                    self._reply(403, {"error": "kv fabric token "
                                      "required",
                                      "reason": "fabric_token"})
                    return
                try:
                    data = loop.export_chain(digest)
                except Exception as e:  # noqa: BLE001 — JSON 500
                    ssp.set_attr("outcome", "error")
                    ssp.set_error(str(e))
                    ssp.end()
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                if data is None:
                    ssp.set_attr("outcome", "miss")
                    ssp.end()
                    self._reply(404, {"error": "unknown chain",
                                      "digest": digest})
                    return
                ssp.set_attr("outcome", "served")
                ssp.set_attr("nbytes", len(data))
                ssp.end()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path == "/debug/traces":
                self._reply(200, tracing.recorder().to_json())
            elif self.path.startswith("/debug/traces/"):
                tid = self.path.rsplit("/", 1)[1]
                spans = tracing.recorder().trace(tid)
                if not spans:
                    self._reply(404, {"error": "unknown trace",
                                      "trace_id": tid})
                else:
                    self._reply(200, {
                        "trace_id": tid,
                        "spans": [sp.to_dict() for sp in spans],
                    })
            elif self.path.startswith("/debug/profile"):
                # Chrome trace of the last N decode ticks decomposed into
                # phases; ?ticks=N bounds the window (default 64)
                n = 64
                if "?" in self.path:
                    try:
                        from urllib.parse import parse_qs, urlsplit
                        q = parse_qs(urlsplit(self.path).query)
                        n = int(q.get("ticks", ["64"])[0])
                    except (ValueError, IndexError):
                        self._reply(400, {"error": "ticks must be an "
                                          "integer"})
                        return
                self._reply(200, loop.profile_trace(last_n=n))
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def _stream_sse(self, gen) -> None:
            """Server-sent events: one ``data: {"tokens": [...]}`` frame
            per decode batch, ``data: [DONE]`` terminator. Mid-stream
            failures become an SSE error frame (the 200 is already on
            the wire). Every exit path closes the stream, and nothing
            escapes to do_POST."""
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                for delta in gen:
                    self.wfile.write(
                        b"data: " + json.dumps({"tokens": delta}).encode()
                        + b"\n\n")
                    self.wfile.flush()
                self.wfile.write(b"data: [DONE]\n\n")
            except OSError:             # client went away (BrokenPipe, reset)
                pass
            except (TimeoutError, RuntimeError) as e:
                # in-band error frame, then the normal terminator
                try:
                    self.wfile.write(
                        b"data: " + json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}).encode()
                        + b"\n\ndata: [DONE]\n\n")
                except OSError:
                    pass
            finally:
                gen.close()

        def do_POST(self):
            if self.path == "/admin/drain":
                # the fleet controller's graceful scale-down hook
                loop.begin_drain()
                self._reply(200, {"status": "draining"})
                return
            if self.path == "/admin/undrain":
                loop.cancel_drain()
                self._reply(200, {"status": "ok"})
                return
            if self.path == "/v1/handoff":
                # decode-role ingest: one encoded handoff payload ->
                # adopted rid (restored byte for byte into the engine)
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    rid = loop.adopt(self.rfile.read(length))
                except Infeasible as e:
                    self._reply(400, {"error": f"{type(e).__name__}: {e}",
                                      "infeasible": True,
                                      "reason": e.reason})
                    return
                except EngineRecovering as e:
                    self._reply(503, {"error": str(e),
                                      "reason": "recovering"},
                                headers=[("Retry-After", "1")])
                    return
                except DrainingError as e:
                    self._reply(503, {"error": str(e),
                                      "reason": "draining"})
                    return
                except Exception as e:  # noqa: BLE001 — JSON 500
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                self._reply(200, {"rid": rid})
                return
            if self.path != "/v1/generate":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                prompt = [int(t) for t in body["prompt"]]
                n = int(body.get("max_new_tokens",
                                 cfg.default_max_new_tokens))
                sampling = {}
                if "temperature" in body:
                    sampling["temperature"] = float(body["temperature"])
                if "top_k" in body:
                    sampling["top_k"] = int(body["top_k"])
                if "top_p" in body:
                    sampling["top_p"] = float(body["top_p"])
                if "seed" in body:
                    sampling["seed"] = int(body["seed"])
                if "stop_tokens" in body:
                    sampling["stop_tokens"] = [
                        int(t) for t in body["stop_tokens"]]
                if "priority" in body:
                    sampling["priority"] = int(body["priority"])
                if "cache_prefix" in body:
                    # strict type check: bool("false") is True
                    if not isinstance(body["cache_prefix"], bool):
                        raise ValueError(
                            "cache_prefix must be a JSON boolean")
                    sampling["cache_prefix"] = body["cache_prefix"]
                # request-level tenant identity: body field wins,
                # X-Tenant header second; validated, then ignored by an
                # engine without a tenant quota
                tenant = body.get("tenant",
                                  self.headers.get("X-Tenant"))
                if tenant is not None:
                    sampling["tenant"] = validate_tenant_name(
                        str(tenant))
                # per-request completion deadline: body field wins,
                # header second, server default last
                deadline = body.get(
                    "deadline_s", self.headers.get("X-Request-Deadline-S"))
                if deadline is not None:
                    sampling["deadline_s"] = float(deadline)
                inbound_tp = self.headers.get("traceparent")
                if inbound_tp:
                    sampling["traceparent"] = inbound_tp
                if body.get("kv_sources"):
                    # gateway-attached KV-fabric peer offers: pull the
                    # named chain(s) BEFORE submit so this request's
                    # prefix match hits warm; best-effort (a failure is
                    # a normal prefill). Honored ONLY with the fleet's
                    # shared token: a client-supplied offer is counted
                    # and dropped.
                    if cfg.kv_fabric_token and self.headers.get(
                            FABRIC_TOKEN_HEADER) == cfg.kv_fabric_token:
                        loop.prefetch_chain(
                            body["kv_sources"], sampling.get("tenant"),
                            deadline_s=sampling.get("deadline_s"),
                            parent=sampling.get("traceparent"))
                    else:
                        srcs = body["kv_sources"]
                        loop.note_pull_denied(
                            digest=(srcs[0].get("digest")
                                    if isinstance(srcs, list) and srcs
                                    and isinstance(srcs[0], dict)
                                    else None),
                            parent=sampling.get("traceparent"))
                if cfg.role == "prefill":
                    # the answer is a handoff descriptor ({"handoff":
                    # {"target", "rid"}}) the client follows to the
                    # decode replica's /v1/result or /v1/stream, or plain
                    # tokens when the first token completed the request
                    self._reply(200, loop.prefill(prompt, n, **sampling))
                    return
                if body.get("stream"):
                    # stream() submits eagerly: validation errors land in
                    # the except arms below as a clean JSON 4xx
                    gen = loop.stream(prompt, n, **sampling)
                    self._stream_sse(gen)
                    return
                tokens = loop.generate(prompt, n, **sampling)
            except Infeasible as e:
                # permanent: 400 with no Retry-After
                self._reply(400, {"error": f"{type(e).__name__}: {e}",
                                  "infeasible": True,
                                  "reason": e.reason})
                return
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}",
                                  "reason": "bad_request"})
                return
            except QueueFull as e:
                # transient: 429 + Retry-After; ``reason`` splits the
                # shed causes machine-readably
                self._reply(429, {"error": str(e), "reason": e.reason},
                            headers=[("Retry-After", "1")])
                return
            except DeadlineExceeded as e:
                self._reply(504, {"error": str(e),
                                  "deadline_exceeded": True})
                return
            except EngineRecovering as e:
                self._reply(503, {"error": str(e),
                                  "reason": "recovering"},
                            headers=[("Retry-After", "1")])
                return
            except DrainingError as e:
                self._reply(503, {"error": str(e),
                                  "reason": "draining"})
                return
            except TimeoutError as e:
                self._reply(503, {"error": str(e),
                                  "reason": "timeout"})
                return
            except Exception as e:  # decode-loop death → JSON 500, not a dropped conn
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply(200, {"tokens": tokens})

    class Server(ThreadingHTTPServer):
        # non-daemon handler threads: interpreter exit waits for the
        # write delivering a final response; bounded by loop.shutdown()
        # and Handler.timeout
        daemon_threads = False
        # listen backlog: socketserver's default of 5 resets concurrent
        # connects on a host that aborts on accept-queue overflow while
        # the ticker holds the interpreter and the accept thread waits
        # (8 clients at once on the H100 host); the reference keeps 5
        request_queue_size = 128

    return Server((host, cfg.port), Handler)


def main(argv: Optional[Sequence[str]] = None,
         device: DeviceLike = None) -> None:
    parser = argparse.ArgumentParser(prog="nos-tpu-torch-server",
                                     description=__doc__)
    parser.add_argument("--config", default="", help="server config YAML")
    parser.add_argument("--checkpoint-dir", default="")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument(
        "--pipeline-depth", type=int, default=None,
        help="decode ticks in flight before the host blocks on a token "
             "fetch (1 = host-serial; overrides config)")
    parser.add_argument(
        "--decode-steps", type=int, default=None,
        help="decode steps fused into one dispatch (1 = off; overrides "
             "config)")
    # beyond the reference's flag set: its main reaches the same field
    # through --config only (test_main_serves_admission_flags)
    parser.add_argument(
        "--prefix-cache-size", type=int, default=None,
        help="prefix-cache budget in KV blocks for block-granular "
             "prefix chains (0 = off [default]; requires --kv-blocks; "
             "overrides config)")
    parser.add_argument(
        "--prefill-chunk", type=int, default=None,
        help="chunked prefill chunk size in prompt tokens (0 = off "
             "[default]; power of two >= 8; overrides config)")
    parser.add_argument(
        "--prefill-budget", type=int, default=None,
        help="per-tick chunked-prefill budget in prompt tokens (0 = "
             "the unconditional one-chunk-per-tick rule [default]; "
             "requires --prefill-chunk; overrides config)")
    parser.add_argument(
        "--kv-block-size", type=int, default=None,
        help="paged-KV block size in tokens (power of two >= 8 "
             "dividing max_seq; only meaningful with --kv-blocks; "
             "overrides config)")
    parser.add_argument(
        "--kv-blocks", type=int, default=None,
        help="paged-KV pool size in blocks (0 = slot-static KV; the "
             "resident KV budget is kv_blocks * kv_block_size tokens; "
             "overrides config)")
    parser.add_argument(
        "--kv-swap", choices=("on", "off"), default=None,
        help="block-pressure preemption mode: on = swap the victim's "
             "KV to host and restore byte-exact, off = recompute it "
             "from the tokens on resume (overrides config)")
    parser.add_argument(
        "--kv-dtype", choices=("bf16", "int8"), default=None,
        help="paged-KV storage dtype (overrides config): int8 "
             "quantizes KV on write with per-block scales and requires "
             "--kv-blocks")
    parser.add_argument(
        "--kv-host-tier-bytes", type=int, default=None,
        help="host-RAM KV tier capacity in bytes (0 = off [default]; "
             "overrides config; requires --kv-blocks and a prefix "
             "cache)")
    parser.add_argument(
        "--kv-fabric-token", default=None,
        help="shared fleet secret gating the KV fabric's HTTP "
             "surfaces (empty = disabled [default]; overrides config)")
    parser.add_argument(
        "--paged-kernel", choices=("on", "off"), default=None,
        help="paged attention formulation (overrides config): on "
             "[default] = the hand-written CUDA kernel (inert without "
             "--kv-blocks), off = the gather formulation (the escape "
             "hatch and the parity oracle); echoed in /stats config")
    parser.add_argument(
        "--role", choices=("colocated", "prefill", "decode"),
        default=None,
        help="prefill/decode disaggregation role (overrides config): "
             "colocated = one engine prefills and decodes (default); "
             "prefill = requests leave after their first token as a "
             "KV handoff shipped round-robin to --decode-pool "
             "(requires --kv-blocks; int8 KV halves handoff bytes); "
             "decode = adopts handoffs via POST /v1/handoff and "
             "serves /v1/result//v1/stream (requires --kv-blocks and "
             "the same kv geometry as the prefill peers). Echoed in "
             "/stats config for fleet drift detection")
    parser.add_argument(
        "--decode-pool", default=None,
        help="comma-separated decode-replica base URLs a prefill-role "
             "server ships handoffs to (required with --role=prefill; "
             "overrides config)")
    parser.add_argument(
        "--handoff-cooldown-s", type=float, default=None,
        help="seconds a decode replica is skipped by the handoff "
             "pusher after a failed push (overrides config)")
    parser.add_argument(
        "--handoff-health-interval-s", type=float, default=None,
        help="decode-pool health-view refresh cadence in seconds for "
             "a --role=prefill server's handoff pusher (0 = off "
             "[default]; overrides config)")
    parser.add_argument(
        "--draft-checkpoint-dir", default=None,
        help="enable speculative decoding: checkpoint of the draft "
             "model (overrides config)")
    parser.add_argument(
        "--draft-n-tokens", type=int, default=None,
        help="speculative proposals per verify window (>= 1; only "
             "meaningful with --draft-checkpoint-dir; overrides config)")
    parser.add_argument(
        "--slo-ttft-ms", type=float, default=None,
        help="time-to-first-token SLO target in ms (0 = unset; feeds "
             "nos_tpu_serve_slo_total and the goodput gauge; overrides "
             "config)")
    parser.add_argument(
        "--slo-tpot-ms", type=float, default=None,
        help="mean time-per-output-token SLO target in ms (0 = unset; "
             "overrides config)")
    parser.add_argument(
        "--slo-fast-window-s", type=float, default=None,
        help="fast burn-rate window in seconds for per-tenant SLO "
             "error budgets (active only with tenant SLO objectives; "
             "overrides config)")
    parser.add_argument(
        "--slo-slow-window-s", type=float, default=None,
        help="slow burn-rate window in seconds (overrides config)")
    parser.add_argument(
        "--slo-burn-threshold", type=float, default=None,
        help="fast-window burn rate at/over which a breach trip fires "
             "(overrides config)")
    parser.add_argument(
        "--slo-capture-interval-s", type=float, default=None,
        help="minimum seconds between breach-capture trips per "
             "(tenant, objective) (overrides config)")
    parser.add_argument(
        "--device-stats-interval", type=float, default=None,
        help="seconds between device memory samples into the HBM "
             "gauges (0 disables; overrides config)")
    parser.add_argument(
        "--restart-budget", type=int, default=None,
        help="supervised engine restarts allowed over the process "
             "lifetime (0 = engine failure is terminal; overrides "
             "config)")
    parser.add_argument(
        "--watchdog-s", type=float, default=None,
        help="stuck-tick watchdog threshold in seconds (0 = off; "
             "overrides config): a decode tick blocked in its device "
             "wait longer than this counts as an engine failure")
    parser.add_argument(
        "--tenant-config", default=None,
        help="request-level elastic quota, as a file path or inline "
             "JSON (empty = tenancy off; overrides config)")
    parser.add_argument(
        "--default-deadline-s", type=float, default=None,
        help="default per-request completion deadline in seconds "
             "(0 = none; overrides config; per-request override via "
             "the deadline_s field / X-Request-Deadline-S header)")
    observability_flags(parser)
    args = parser.parse_args(argv)

    cfg = ServerConfig.from_yaml_file(args.config) if args.config \
        else ServerConfig()
    for name in ("checkpoint_dir", "port", "pipeline_depth",
                 "decode_steps", "prefix_cache_size", "prefill_chunk",
                 "prefill_budget", "kv_block_size", "kv_blocks", "kv_dtype",
                 "kv_host_tier_bytes", "kv_fabric_token", "paged_kernel",
                 "role", "decode_pool", "handoff_cooldown_s",
                 "handoff_health_interval_s", "draft_checkpoint_dir",
                 "draft_n_tokens", "slo_ttft_ms", "slo_tpot_ms",
                 "slo_fast_window_s", "slo_slow_window_s",
                 "slo_burn_threshold", "slo_capture_interval_s",
                 "restart_budget", "watchdog_s", "default_deadline_s",
                 "tenant_config"):
        value = getattr(args, name)
        # --checkpoint-dir overrides only when non-empty, as the
        # reference's does
        if value is not None and (name != "checkpoint_dir" or value):
            setattr(cfg, name, value)
    if args.kv_swap is not None:
        cfg.kv_swap = args.kv_swap == "on"
    if args.device_stats_interval is not None:
        cfg.device_stats_interval_s = args.device_stats_interval
    if cfg.restart_budget < 0:
        raise ValueError(
            f"restart_budget must be >= 0, got {cfg.restart_budget}")
    if cfg.watchdog_s < 0 or cfg.default_deadline_s < 0:
        raise ValueError(
            "watchdog_s and default_deadline_s must be >= 0")
    from nos_tpu_torch.cmd import setup_logging
    setup_logging(0, args.log_format,
                  numeric_level=getattr(logging, cfg.log_level.upper(), 20))
    tracing.configure(
        sampling=args.trace_sampling,
        recorder_size=args.trace_recorder_size,
        slow_threshold_s=args.trace_slow_threshold)

    # the supervisor's rebuild path: a fresh engine from the same
    # config; None when restarts are disabled
    factory = (lambda: build_engine(cfg, device)) \
        if cfg.restart_budget > 0 else None
    # parsed once more for the loop's accounting half (the engine half
    # parses inside build_engine, so the rebuild factory carries it)
    tenant_quota = TenantQuotaConfig.load(cfg.tenant_config)
    engine = build_engine(cfg, device)

    def _http_handoff_send(target: str, data: bytes) -> int:
        """Ship one encoded handoff to a decode replica; returns the
        decode-side rid. Errors propagate: the pusher tries the next
        pool target."""
        import urllib.request

        req = urllib.request.Request(
            target.rstrip("/") + "/v1/handoff", data=data,
            headers={"Content-Type": "application/octet-stream"},
            method="POST")
        with urllib.request.urlopen(req, timeout=30) as resp:
            return int(json.loads(resp.read())["rid"])

    decode_pool = [u.strip() for u in cfg.decode_pool.split(",")
                   if u.strip()]
    loop = ServingLoop(
        engine, slo_ttft_ms=cfg.slo_ttft_ms,
        role=cfg.role, handoff_targets=decode_pool,
        handoff_send=(_http_handoff_send if cfg.role == "prefill"
                      else None),
        handoff_cooldown_s=cfg.handoff_cooldown_s,
        handoff_health_interval_s=cfg.handoff_health_interval_s,
        slo_tpot_ms=cfg.slo_tpot_ms,
        device_stats_interval_s=cfg.device_stats_interval_s,
        engine_factory=factory, restart_budget=cfg.restart_budget,
        restart_backoff_s=cfg.restart_backoff_s,
        restart_backoff_max_s=cfg.restart_backoff_max_s,
        watchdog_s=cfg.watchdog_s,
        default_deadline_s=cfg.default_deadline_s, seed=cfg.seed,
        tenant_quota=tenant_quota,
        fabric_token=cfg.kv_fabric_token,
        slo_fast_window_s=cfg.slo_fast_window_s,
        slo_slow_window_s=cfg.slo_slow_window_s,
        slo_burn_threshold=cfg.slo_burn_threshold,
        slo_capture_interval_s=cfg.slo_capture_interval_s,
        # /stats config echo, the reference's keys: what a fleet
        # controller compares across replicas to catch config drift
        config_echo={
            "max_batch": cfg.max_batch,
            "pipeline_depth": cfg.pipeline_depth,
            "decode_steps": cfg.decode_steps,
            "prefill_chunk": cfg.prefill_chunk,
            "prefill_budget": cfg.prefill_budget,
            "kv_block_size": cfg.kv_block_size,
            "kv_blocks": cfg.kv_blocks,
            "kv_swap": cfg.kv_swap,
            "kv_dtype": cfg.kv_dtype,
            "kv_host_tier_bytes": cfg.kv_host_tier_bytes,
            "kv_fabric_auth": bool(cfg.kv_fabric_token),
            "paged_kernel": cfg.paged_kernel,
            "speculative": bool(cfg.draft_checkpoint_dir),
            "draft_n_tokens": (cfg.draft_n_tokens
                               if cfg.draft_checkpoint_dir else 0),
            "max_seq": cfg.max_seq,
            "role": cfg.role,
            "mesh": {"tp": cfg.tp if cfg.tp and cfg.tp > 1 else 0},
            "tenant_quota": (tenant_quota.echo()
                             if tenant_quota is not None else None),
            "slo_accounting": {
                "enabled": bool(tenant_quota is not None
                                and tenant_quota.slo_enabled()),
                "fast_window_s": cfg.slo_fast_window_s,
                "slow_window_s": cfg.slo_slow_window_s,
                "burn_threshold": cfg.slo_burn_threshold,
                "capture_interval_s": cfg.slo_capture_interval_s,
            },
        })
    httpd = make_http_server(cfg, loop)

    def _finish_drain():
        drained = loop.wait_idle(cfg.drain_timeout_s)
        logger.info("drain %s; shutting down",
                    "complete" if drained else
                    f"timed out after {cfg.drain_timeout_s:.0f}s")
        httpd.shutdown()        # must come from another thread

    def _on_sigterm(*_):
        logger.info("SIGTERM: draining (budget %.0fs)", cfg.drain_timeout_s)
        loop.begin_drain()
        threading.Thread(target=_finish_drain, daemon=True).start()

    if threading.current_thread() is threading.main_thread():
        import signal

        signal.signal(signal.SIGTERM, _on_sigterm)
    logger.info("serving on :%d (max_batch=%d)", cfg.port, cfg.max_batch)
    try:
        httpd.serve_forever()
    finally:
        # shutting the loop first fails any still-waiting handler, then
        # server_close joins handler threads and releases the socket
        loop.shutdown()
        httpd.server_close()


if __name__ == "__main__":
    main()
