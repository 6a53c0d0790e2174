"""nos_tpu_torch.obs — tracing and SLO plumbing for the port's serving
binary, copied from the reference's jax-free ``nos_tpu/obs``.

- ``tracing``: zero-dependency spans and the bounded flight recorder
  behind ``/debug/traces``;
- ``trace_export``: Chrome trace-event JSON (``/debug/profile``);
- ``slo``: the per-tenant chip-second ledger and the multi-window SLO
  error-budget engine (the serving loop's ``slo_budget`` and
  ``chip_ledger`` blocks stay None until tenant configs are ported).
"""
from nos_tpu_torch.obs import tracing  # noqa: F401
from nos_tpu_torch.obs.slo import (  # noqa: F401
    IDLE_TENANT,
    ChipLedger,
    SloBudgetEngine,
    aggregate_slo,
    objectives_from_quota,
)
from nos_tpu_torch.obs.tracing import (  # noqa: F401
    FlightRecorder,
    Span,
    SpanContext,
    Tracer,
    configure,
    current,
    recorder,
    span,
    start_span,
    traced,
    tracer,
)
