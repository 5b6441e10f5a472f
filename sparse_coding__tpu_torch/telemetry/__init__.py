"""Run telemetry of the port: ``events.jsonl`` records, spans, provenance,
and the pod layer (`telemetry.multihost`)."""

from sparse_coding__tpu_torch.telemetry.events import RunTelemetry, read_events, run_fingerprint
from sparse_coding__tpu_torch.telemetry.multihost import check_desync, heartbeat
from sparse_coding__tpu_torch.telemetry.spans import span

__all__ = ["RunTelemetry", "check_desync", "heartbeat", "read_events", "run_fingerprint", "span"]
