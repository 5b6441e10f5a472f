"""CLI shim: ``python -m sparse_coding__tpu_torch.lineage explain|blast|check|graph``.

End-to-end artifact lineage over the committed manifests and events:
``explain <artifact|trace-id> ROOT...`` resolves a served response back
through dict generation → export → checkpoint → chunks → harvest config
with digest re-verification; ``blast <artifact> ROOT...`` is the
downstream taint closure (a quarantined chunk names every checkpoint,
export and live serving generation built on it); ``check ROOT...`` is the
exit-coded CI gate (1 while tainted). Implementation:
`sparse_coding__tpu_torch.telemetry.provenance`.
"""

from sparse_coding__tpu_torch.telemetry.provenance import (
    Graph,
    GraphBuilder,
    build_graph,
    checkpoint_digest,
    config_digest,
    export_digest,
    main,
    producer_identity,
    render_blast,
    render_explain,
    render_summary,
    verify_graph,
)

__all__ = [
    "Graph",
    "GraphBuilder",
    "build_graph",
    "checkpoint_digest",
    "config_digest",
    "export_digest",
    "main",
    "producer_identity",
    "render_blast",
    "render_explain",
    "render_summary",
    "verify_graph",
]

if __name__ == "__main__":
    raise SystemExit(main())
