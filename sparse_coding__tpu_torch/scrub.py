"""CLI shim: ``python -m sparse_coding__tpu_torch.scrub <store> [--repair CFG]``.

Offline chunk-store integrity scrub: re-verifies every committed chunk at
the digest tier, quarantines failures, and (``--repair``) re-generates the
exact missing indices from a repair config. Exit 1 while unrepaired loss
remains — the data plane's CI gate, and the producer of the quarantine
ledgers `python -m sparse_coding__tpu_torch.lineage` reads as taint
sources. Implementation: `sparse_coding__tpu_torch.data.scrub`.
"""

from sparse_coding__tpu_torch.data.scrub import (
    RepairRefused,
    main,
    render_scrub_markdown,
    repair_from_config,
    scrub_store,
    store_loss,
)

__all__ = [
    "RepairRefused",
    "main",
    "render_scrub_markdown",
    "repair_from_config",
    "scrub_store",
    "store_loss",
]

if __name__ == "__main__":
    raise SystemExit(main())
