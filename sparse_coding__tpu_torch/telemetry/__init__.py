"""Run telemetry of the port: ``events.jsonl`` records, spans, provenance."""

from sparse_coding__tpu_torch.telemetry.events import RunTelemetry, read_events, run_fingerprint
from sparse_coding__tpu_torch.telemetry.spans import span

__all__ = ["RunTelemetry", "read_events", "run_fingerprint", "span"]
