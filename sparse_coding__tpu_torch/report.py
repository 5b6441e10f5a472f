"""CLI shim: ``python -m sparse_coding__tpu_torch.report <run_dir>``.

Renders a run directory's `events.jsonl` + `metrics.jsonl` into a markdown
summary (fingerprint, compile/throughput stats, per-model health table,
anomaly timeline). Implementation: `sparse_coding__tpu_torch.telemetry.report`.
"""

from sparse_coding__tpu_torch.telemetry.report import load_run, main, render_markdown

__all__ = ["load_run", "main", "render_markdown"]

if __name__ == "__main__":
    raise SystemExit(main())
