"""Fleet scheduler: pack members into items, reassign dead work, verify done.

``python -m sparse_coding__tpu_torch.fleet.scheduler <fleet_dir>`` is the one
process per fleet that owns *liveness*: workers pull work themselves
(`fleet.worker`), so all the scheduler does on each tick is

  1. **reap expired leases** (`WorkQueue.reap_expired`) — items whose
     holder stopped heartbeating go back to `pending/` with their lineage
     recording who lost them; repeat offenders are quarantined after
     ``--quarantine-after`` strikes so reassignment flows to healthy
     workers instead of crash-looping on a sick host;
  2. **re-verify done items** — every newly done item's learned-dict
     export must match its size/digest manifest (`fleet.worker.
     verify_export`), and ALL done exports are re-verified once more
     before the fleet declares success; post-completion corruption (bit
     rot, a partial overwrite) sends the item back to `pending/` for
     retraining;
  3. emit the reassignment/quarantine/lost events `fleet.report` and the
     monitor's fleet view render.

Packing (`pack_members`) sizes the member groups from HBM-watermark data:
`member_bytes_from_run` reads the ``hbm.*.peak_bytes_in_use`` gauges a
previous run's telemetry recorded (`telemetry.profiling.
record_hbm_watermarks`: the card's peak allocated bytes) and divides by
that run's member count — the empirical per-member footprint, optimizer
moments and temporaries included, which no analytic estimate gets right.
Groups fill a worker's device-memory budget minus a safety reserve; a
thousand-member sweep becomes however many items the fleet's cards can
actually hold.

Counterpart of `sparse_coding__tpu/fleet/scheduler.py`, copied: the port's
drivers write the same ``hbm.d<j>.*`` gauges, so the packing reads a run of
either package.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

from sparse_coding__tpu_torch.fleet.queue import WorkQueue

__all__ = [
    "FleetScheduler",
    "build_sweep_items",
    "member_bytes_from_run",
    "pack_members",
    "main",
]


# -- HBM-aware packing ---------------------------------------------------------

def member_bytes_from_run(run_dir, n_members: int) -> Optional[float]:
    """Empirical per-member HBM footprint from a prior run's watermark
    gauges: max ``hbm.*.peak_bytes_in_use`` across devices / members
    trained. None when the run recorded no watermarks."""
    from sparse_coding__tpu_torch.telemetry.report import _merged_gauges, load_run

    run = load_run(run_dir)
    peaks = [
        v for k, v in _merged_gauges(run).items()
        if k.startswith("hbm.") and k.endswith(".peak_bytes_in_use")
    ]
    if not peaks or n_members <= 0:
        return None
    return max(peaks) / float(n_members)


def pack_members(
    members: Sequence[Any],
    bytes_per_member: Optional[float] = None,
    hbm_budget_bytes: Optional[float] = None,
    reserve_fraction: float = 0.2,
    max_members_per_item: Optional[int] = None,
    watermark_run_dir=None,
    watermark_members: Optional[int] = None,
) -> List[List[Any]]:
    """Split `members` into contiguous groups that fit one worker's HBM.

    Group size = the largest count whose summed per-member bytes fits
    ``hbm_budget_bytes * (1 - reserve_fraction)`` (the reserve absorbs
    temporary spikes the watermark undersells), clamped by
    ``max_members_per_item``. With no sizing information everything lands
    in one item. ``watermark_run_dir`` + ``watermark_members`` derive
    ``bytes_per_member`` from a previous run's recorded HBM peaks."""
    members = list(members)
    if not members:
        return []
    if bytes_per_member is None and watermark_run_dir is not None:
        bytes_per_member = member_bytes_from_run(
            watermark_run_dir, watermark_members or len(members)
        )
    size = len(members)
    if bytes_per_member and hbm_budget_bytes:
        usable = hbm_budget_bytes * (1.0 - reserve_fraction)
        size = max(1, int(math.floor(usable / bytes_per_member)))
    if max_members_per_item is not None:
        size = max(1, min(size, int(max_members_per_item)))
    return [members[i : i + size] for i in range(0, len(members), size)]


def build_sweep_items(
    queue: WorkQueue,
    groups: Sequence[Sequence[float]],
    base_kwargs: Dict[str, Any],
    driver: str = "basic_l1_sweep",
    name_prefix: str = "g",
) -> List[Dict[str, Any]]:
    """Submit one work item per member group of an l1 sweep. Each item's
    payload is the full driver invocation (`fleet.worker.run_item`), so an
    item is self-contained — any worker can run it with nothing but the
    queue directory."""
    items = []
    for i, group in enumerate(groups):
        l1s = [float(a) for a in group]
        items.append(
            queue.submit(
                f"{name_prefix}{i}",
                members=[f"l1_{a:.2e}" for a in l1s],
                payload={"driver": driver,
                         "kwargs": {**base_kwargs, "l1_values": l1s}},
            )
        )
    return items


# -- the scheduler loop --------------------------------------------------------

class FleetScheduler:
    """Owns reaping, quarantine, and done-export re-verification for one
    fleet directory (see module docstring)."""

    def __init__(
        self,
        fleet_dir,
        lease_seconds: float = 30.0,
        max_attempts: Optional[int] = 5,
        quarantine_after: Optional[int] = 3,
        verify_done: bool = True,
        telemetry=None,
    ):
        self.queue = WorkQueue(fleet_dir)
        self.lease_seconds = float(lease_seconds)
        self.max_attempts = max_attempts
        self.quarantine_after = quarantine_after
        self.verify_done = verify_done
        self.telemetry = telemetry
        self._verified_done: set = set()

    def _event(self, etype: str, **fields):
        if self.telemetry is not None:
            self.telemetry.event(etype, **fields)
            if etype in ("lease_expired", "quarantine", "item_lost",
                         "export_corrupt"):
                self.telemetry.counter_inc(f"fleet.{etype}")

    def _verify_done_items(self, actions: List[Dict[str, Any]]) -> None:
        from sparse_coding__tpu_torch.fleet.worker import verify_export

        for item in self.queue.items("done"):
            item_id = item["item"]
            if item_id in self._verified_done:
                continue
            ok, reason = verify_export(self.queue.run_dir(item_id))
            if ok:
                self._verified_done.add(item_id)
                continue
            # post-completion corruption: the member is NOT done — requeue
            # for retraining rather than report a dict nobody can load.
            # Same attempt budget as every other requeue: a disk that rots
            # every export must eventually count the members LOST, not
            # cycle done→pending forever
            moved = self.queue.requeue_done(
                item_id, "export_corrupt", reason, self.max_attempts
            )
            if moved is None:
                continue
            bucket, rec = moved
            actions.append({"kind": "export_corrupt", "item": item_id,
                            "reason": reason, "requeued_to": bucket})
            self._event("export_corrupt", item=item_id, reason=reason,
                        requeued_to=bucket)
            if bucket == "failed":
                actions.append({"kind": "item_lost", "item": item_id,
                                "members": rec.get("members", []),
                                "attempts": rec["attempt"]})
                self._event("item_lost", item=item_id,
                            members=rec.get("members", []),
                            attempts=rec["attempt"])

    def tick(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One maintenance pass; returns the action records (tests assert
        on them, the CLI loop logs them)."""
        actions = self.queue.reap_expired(
            now=now,
            max_attempts=self.max_attempts,
            quarantine_after=self.quarantine_after,
            grace_seconds=self.lease_seconds,
            on_event=lambda kind, fields: self._event(kind, **fields),
        )
        if self.verify_done:
            self._verify_done_items(actions)
        return actions

    def run(
        self,
        poll_every: float = 2.0,
        exit_when_done: bool = True,
        max_seconds: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Tick until the queue finishes (every item done or failed).
        Returns the final `WorkQueue.state()`."""
        t0 = time.time()
        while True:
            self.tick()
            if exit_when_done and self.queue.finished():
                # per-tick verification only checks NEWLY done items (the
                # cache keeps ticks cheap); before declaring success,
                # re-verify every export once — corruption found here
                # requeues the item and the fleet keeps running
                self._verified_done.clear()
                if not self.tick() and self.queue.finished():
                    break
            if max_seconds is not None and time.time() - t0 >= max_seconds:
                break
            time.sleep(poll_every)
        state = self.queue.state()
        self._event(
            "fleet_done",
            items=state["item_counts"],
            members=state["members"],
        )
        return state


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparse_coding__tpu_torch.fleet.scheduler",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("fleet_dir", help="fleet root (holds queue/ and runs/)")
    ap.add_argument("--lease-seconds", type=float, default=30.0,
                    help="grace given to claim-without-lease orphans "
                    "(workers choose their own lease length at claim time)")
    ap.add_argument("--poll", type=float, default=2.0,
                    help="tick period in seconds (default 2)")
    ap.add_argument("--max-attempts", type=int, default=5,
                    help="per-item attempt budget before it counts as lost")
    ap.add_argument("--quarantine-after", type=int, default=3,
                    help="strikes (lost leases) before a worker is excluded")
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="stop ticking after this long even if unfinished")
    ap.add_argument("--no-verify-done", action="store_true",
                    help="skip re-verifying done items' export manifests")
    args = ap.parse_args(argv)

    from sparse_coding__tpu_torch.telemetry import RunTelemetry

    telemetry = RunTelemetry(
        out_dir=args.fleet_dir,
        run_name="fleet_scheduler",
        config={"lease_seconds": args.lease_seconds,
                "max_attempts": args.max_attempts,
                "quarantine_after": args.quarantine_after},
        file_name="scheduler_events.jsonl",
    )
    telemetry.run_start()
    sched = FleetScheduler(
        args.fleet_dir,
        lease_seconds=args.lease_seconds,
        max_attempts=args.max_attempts,
        quarantine_after=args.quarantine_after,
        verify_done=not args.no_verify_done,
        telemetry=telemetry,
    )
    status = "ok"
    try:
        state = sched.run(poll_every=args.poll, max_seconds=args.max_seconds)
        m = state["members"]
        outstanding = (
            state["item_counts"]["pending"] + state["item_counts"]["leased"]
        )
        print(
            f"[fleet] items {state['item_counts']}; members "
            f"{m['done']} done / {m['lost']} lost"
            + (f" / {outstanding} item(s) UNFINISHED (timed out)"
               if outstanding else "")
        )
        # success = the sweep actually finished with nothing lost; a
        # --max-seconds timeout with work outstanding is NOT success
        ok = (
            m["lost"] == 0
            and state["item_counts"]["failed"] == 0
            and outstanding == 0
        )
        return 0 if ok else 1
    except BaseException as e:
        status = f"error: {type(e).__name__}: {e}"
        raise
    finally:
        telemetry.close(status=status)


if __name__ == "__main__":
    sys.exit(main())
