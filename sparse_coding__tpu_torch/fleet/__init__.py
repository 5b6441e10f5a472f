"""Fleet scheduler: sweep-as-a-service on preemptible worker fleets.

Counterpart of `sparse_coding__tpu/fleet/` (docs/FLEET.md): the work-queue
layer above single-run recovery, which shards a sweep into member-group work
items and drives them across many preemptible workers with at-least-once
execution and exactly-once commits:

  - `queue`     — filesystem work queue: atomic `os.replace` claims, lease
                  files with heartbeat renewal, dead-lease reaping, worker
                  quarantine, per-item reassignment lineage
  - `worker`    — claim → (supervised) train on the card → verify the
                  learned-dict export against a size/digest manifest →
                  commit
  - `scheduler` — watermark-aware member packing, expired-lease
                  reassignment, done-export re-verification
  - `report`    — one fleet dashboard: members done/running/orphaned/lost,
                  per-worker health, the reassignment lineage table

The queue's files are the JAX package's, byte for byte: workers and
schedulers of either package serve one fleet directory. Chaos-tested on the
CPU (`tests/test_torch_fleet.py`): a sharded sweep with injected worker
kills, a torn checkpoint and transient read errors finishes with zero lost
members, every member bit-exact against an uninterrupted run.
"""

from sparse_coding__tpu_torch.fleet.queue import LeaseLost, WorkQueue, is_fleet_dir
from sparse_coding__tpu_torch.fleet.report import load_fleet, render_fleet_markdown
from sparse_coding__tpu_torch.fleet.scheduler import (
    FleetScheduler,
    build_sweep_items,
    member_bytes_from_run,
    pack_members,
)
from sparse_coding__tpu_torch.fleet.worker import (
    FleetWorker,
    run_item,
    verify_export,
    write_export_manifest,
)

__all__ = [
    "FleetScheduler",
    "FleetWorker",
    "LeaseLost",
    "WorkQueue",
    "build_sweep_items",
    "is_fleet_dir",
    "load_fleet",
    "member_bytes_from_run",
    "pack_members",
    "render_fleet_markdown",
    "run_item",
    "verify_export",
    "write_export_manifest",
]
