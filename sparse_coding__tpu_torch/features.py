"""CLI shim: ``python -m sparse_coding__tpu_torch.features <run_dir>``.

The dictionary feature surface: top-firing, dead and top-drifting features
from the ``feature_stats.<gen>.npz`` snapshots a run leaves behind, with
``--json`` for machines, ``--diff GEN_A GEN_B`` to compare two snapshot
generations, and ``--threshold X`` as the CI gate (exit **1** when the
drift score reaches X; exit **3** when the run dir holds no snapshots).
Implementation: `sparse_coding__tpu_torch.telemetry.feature_stats`.
"""

from sparse_coding__tpu_torch.telemetry.feature_stats import (
    FeatureSnapshot,
    drift_report,
    load_run_snapshots,
    main,
    render_features,
    summarize_run,
)

__all__ = [
    "FeatureSnapshot",
    "drift_report",
    "load_run_snapshots",
    "main",
    "render_features",
    "summarize_run",
]

if __name__ == "__main__":
    raise SystemExit(main())
