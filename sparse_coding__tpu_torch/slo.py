"""CLI shim: ``python -m sparse_coding__tpu_torch.slo <run_dir> --config slo.json``.

Evaluates declarative SLOs (availability, latency percentiles, queue
depth, gauge floors, goodput floor) over a run directory, live
``/metrics`` endpoints (``--scrape URL...``), or control-tower history
(``--tower DIR`` — the only live source with real fast/slow burn rates),
with error-budget consumption and multiwindow burn accounting; exits
**1** past budget — the serving tier's CI gate and an
autoscaler's sensor. Implementation: `sparse_coding__tpu_torch.telemetry.slo`
(docs/observability.md §8, §11).
"""

from sparse_coding__tpu_torch.telemetry.slo import (
    evaluate_measured,
    evaluate_run_dir,
    evaluate_scrape,
    evaluate_series,
    load_config,
    main,
    render_slo,
)

__all__ = [
    "evaluate_measured",
    "evaluate_run_dir",
    "evaluate_scrape",
    "evaluate_series",
    "load_config",
    "main",
    "render_slo",
]

if __name__ == "__main__":
    raise SystemExit(main())
