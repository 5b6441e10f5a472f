"""Run telemetry of the port, the JAX package's pieces over the same files:
``events.jsonl`` records and counters (`events`; a step graph's capture is
its ``compile`` record), the health pack (`health`), the anomaly guard
(`anomaly`), the transfer audit (`audit`), performance attribution (the
step cost's roofline, device-memory gauges, `TraceTrigger`: `profiling`),
the pod layer (`multihost`), spans (`spans`), request tracing (`tracing`),
the lineage graph (`provenance`) and the run tools (`goodput`, `report`,
`monitor`, `slo`, `tower`, `metrics_http`). The package exports what the
JAX package's does, but for its XLA compile bridge (``tracked_jit``,
``jit_cost_fields``, ``compiled_cost_fields``): the port's cost is
`Ensemble.step_cost`, recorded at each capture."""

from sparse_coding__tpu_torch.telemetry.anomaly import AnomalyAbort, AnomalyGuard, AnomalyPolicy
from sparse_coding__tpu_torch.telemetry.audit import TransferViolation, allowed_transfer, transfer_audit
from sparse_coding__tpu_torch.telemetry.events import RunTelemetry, counter_inc_active, read_events, run_fingerprint
from sparse_coding__tpu_torch.telemetry.health import FIRE_EMA_KEY, HealthConfig
from sparse_coding__tpu_torch.telemetry.multihost import (
    check_desync,
    chunk_skew_windows,
    clock_state,
    estimate_clock_offset,
    fingerprint_diff,
    heartbeat,
    process_info,
)
from sparse_coding__tpu_torch.telemetry.profiling import (
    TraceTrigger,
    hbm_watermarks,
    record_hbm_watermarks,
    roofline_summary,
)
from sparse_coding__tpu_torch.telemetry.spans import BADPUT_CATEGORIES, CATEGORIES, GOODPUT_CATEGORIES, Span, span
from sparse_coding__tpu_torch.telemetry.tracing import TraceContext, mint_span_id, mint_trace_id

__all__ = [
    "AnomalyAbort",
    "AnomalyGuard",
    "AnomalyPolicy",
    "BADPUT_CATEGORIES",
    "CATEGORIES",
    "FIRE_EMA_KEY",
    "GOODPUT_CATEGORIES",
    "HealthConfig",
    "RunTelemetry",
    "Span",
    "TraceContext",
    "TraceTrigger",
    "TransferViolation",
    "allowed_transfer",
    "check_desync",
    "chunk_skew_windows",
    "clock_state",
    "counter_inc_active",
    "estimate_clock_offset",
    "fingerprint_diff",
    "hbm_watermarks",
    "heartbeat",
    "mint_span_id",
    "mint_trace_id",
    "process_info",
    "read_events",
    "record_hbm_watermarks",
    "roofline_summary",
    "run_fingerprint",
    "span",
    "transfer_audit",
]
