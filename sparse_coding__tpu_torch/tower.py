"""CLI shim: ``python -m sparse_coding__tpu_torch.tower run|report|check DIR``.

The control tower: one stdlib-only aggregator over the whole pool —
scrapes every ``/metrics`` endpoint (replicaset port files + static
``tower.json`` targets), aggregates fleet ``.prom`` files and queue
state, tails run-dir events, keeps a retained ring-buffer time-series
store (``series.jsonl``), evaluates declarative burn-rate alert rules
with ``for:`` hysteresis (pending→firing→resolved → ``alerts.jsonl`` +
webhook), snapshots incidents (``incidents/INC-NNNN.json``), and serves
a zero-dependency live dashboard plus the `Tower.pool_state()` sensor
contract. ``check`` exits **1** while any alert fires — the pool's CI
gate. Implementation: `sparse_coding__tpu_torch.telemetry.tower`
(docs/observability.md §11).
"""

from sparse_coding__tpu_torch.telemetry.tower import (
    AlertManager,
    AlertRule,
    SeriesStore,
    Tower,
    load_store,
    main,
    render_tower_report,
    replay_alert_states,
    tower_check,
)

__all__ = [
    "AlertManager",
    "AlertRule",
    "SeriesStore",
    "Tower",
    "load_store",
    "main",
    "render_tower_report",
    "replay_alert_states",
    "tower_check",
]

if __name__ == "__main__":
    raise SystemExit(main())
