"""Serving-plane exception types, a copy of ``nos_tpu/models/errors.py``
for the port (torch-free as well as jax-free: ``cmd/server.py`` imports
it at module load), with the wire-level tenant-name guard of
``nos_tpu/models/tenantquota.py`` beside them.

The admission-refusal types encode the permanent/transient split the
HTTP layer relies on: ``Infeasible`` means THIS request can never be
served by THIS server (HTTP 400 — retrying is useless), ``QueueFull``
means the server is out of capacity RIGHT NOW (HTTP 429 + Retry-After —
shed load and come back). Every refusal carries a machine-readable
``reason`` slug the HTTP layer copies into the 429/400 body
(``queue_full`` / ``deadline_unmeetable`` / ``hbm_admission`` /
``tenant_quota`` / ``infeasible``)."""

# tenant names become metric labels and prefix-key scopes
DEFAULT_TENANT = "default"
MAX_TENANT_LEN = 128


class QueueFull(RuntimeError):
    """Admission refused on TRANSIENT capacity: the pending queue is at
    ``max_pending`` (or, under paged KV, the block pool cannot hold
    another waiting request right now). Its own type so the HTTP layer
    can answer 429 + Retry-After (shed load, retry) rather than a
    generic 500. ``reason`` refines the cause on the wire:
    ``queue_full`` (slots/queue exhausted) vs ``hbm_admission`` (free
    slots exist but KV-block/HBM headroom is blocking admission)."""

    reason = "queue_full"

    def __init__(self, *args, reason: str = None):
        super().__init__(*args)
        if reason is not None:
            self.reason = reason


class Infeasible(ValueError):
    """Admission refused PERMANENTLY: the request can never run on this
    server's configuration — prompt + max_new_tokens exceeds the cache
    length, or needs more KV blocks than the whole pool. Subclasses
    ValueError (the HTTP layer's 400 arm, and what library callers
    already catch); distinct so callers can tell "fix the request"
    from "retry later" without string-matching."""

    reason = "infeasible"


class EngineRecovering(RuntimeError):
    """Submission refused because the engine supervisor is mid-restart
    (captured requests are being restored into a rebuilt engine). As
    transient as QueueFull and travels the same wire shape — HTTP 503 +
    Retry-After — but its own type: 503 says "the SERVER is briefly
    degraded", 429 says "YOU are over capacity", and load balancers
    treat them differently."""


class DeadlineUnmeetable(QueueFull):
    """Admission refused because the request's deadline cannot be met:
    the serving loop's rolling TTFT/TPOT estimates put completion past
    ``deadline_s``, so the slot is shed EARLY instead of burning decode
    ticks on an answer the client will discard. Subclasses QueueFull —
    the same transient 429 + Retry-After wire shape — because backing
    off and retrying when load drops is exactly the right client move."""

    reason = "deadline_unmeetable"


class TenantQuotaExceeded(QueueFull):
    """Admission refused because the submitting TENANT is at/over its
    ``max`` token-rate while the engine (or, at the gateway, the fleet)
    is under contention — the last rung of the elastic-quota
    degradation ladder (borrow -> stop lending -> preempt -> shed).
    Subclasses QueueFull — the same transient 429 + Retry-After wire
    shape — because the right client move is to back off until its own
    window drains; scaling the fleet is NOT the answer (the
    ``tenant_quota`` reason is how the autoscaler and the gateway's
    retry policy tell this shed from genuine capacity pressure)."""

    reason = "tenant_quota"


class DeadlineExceeded(RuntimeError):
    """A submitted request's deadline expired before completion: it was
    cancelled at the next tick barrier (or while still queued) and
    accounted under the ``deadline`` terminal outcome. The HTTP layer
    answers 504 — the request was accepted but could not finish in
    time."""


class NotPorted(ValueError):
    """The port's own refusal (no reference counterpart): a knob whose
    engine feature the torch engine does not serve yet. A ValueError, so
    a config check fails before any weights are made; the binary exits
    naming the knob."""

    reason = "not_ported"


def validate_tenant_name(name: str) -> str:
    """Wire-level guard shared by the serving binary and the gateway:
    tenant names become metric labels and prefix-key scopes."""
    if not isinstance(name, str) or not name:
        raise ValueError("tenant must be a non-empty string")
    if len(name) > MAX_TENANT_LEN:
        raise ValueError(
            f"tenant name longer than {MAX_TENANT_LEN} chars")
    if any(c in name for c in "\n\r\"\\"):
        raise ValueError("tenant name contains forbidden characters")
    return name


__all__ = ["QueueFull", "Infeasible", "EngineRecovering",
           "DeadlineUnmeetable", "DeadlineExceeded",
           "TenantQuotaExceeded", "NotPorted", "validate_tenant_name"]
