"""CLI shim: ``python -m sparse_coding__tpu_torch.monitor <run_dir> [--once]``.

Tails a run directory's event logs (`events.jsonl` / per-process
`events.p<i>.jsonl`) and renders live throughput / health / straggler-skew
lines; ``--once`` prints one snapshot and exits nonzero on malformed event
lines. Implementation: `sparse_coding__tpu_torch.telemetry.monitor`.
"""

from sparse_coding__tpu_torch.telemetry.monitor import (
    EventTail,
    RunMonitor,
    TowerView,
    main,
    render,
    tower_render,
)

__all__ = [
    "EventTail", "RunMonitor", "TowerView", "main", "render", "tower_render",
]

if __name__ == "__main__":
    raise SystemExit(main())
