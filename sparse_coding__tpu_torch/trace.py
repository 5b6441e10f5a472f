"""CLI shim: ``python -m sparse_coding__tpu_torch.trace <run_dir> [--trace-id ID]``.

Rebuilds one request's path through the serving tier (router attempts,
retries and hedges, then the replica and its micro-batch) from the run
directory's merged ``events*.jsonl``; ``--slowest N`` explains the latency
tail by phase. Implementation: `sparse_coding__tpu_torch.telemetry.tracing`.
"""

from sparse_coding__tpu_torch.telemetry.tracing import (
    TraceContext,
    collect_traces,
    main,
    mint_span_id,
    mint_trace_id,
    render_trace,
)

__all__ = ["TraceContext", "collect_traces", "main", "mint_span_id", "mint_trace_id", "render_trace"]

if __name__ == "__main__":
    raise SystemExit(main())
