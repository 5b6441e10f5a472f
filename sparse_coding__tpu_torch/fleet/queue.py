"""Filesystem-backed work queue: atomic claims, leases, dead-lease reaping.

The fleet layer (docs/FLEET.md) shards a sweep into member-group *work
items* and drives them across many preemptible workers. This module is the
coordination substrate — plain files on a shared filesystem (the one place
a fleet always agrees on), no database, no extra daemon:

    <fleet_dir>/queue/
        pending/<item>.json    items awaiting a claim
        leased/<item>.json     claimed items (the SAME file, moved)
        leases/<item>.json     who holds it + when the lease expires
        done/<item>.json       verified-complete items
        failed/<item>.json     items whose attempt budget is exhausted
        workers/<worker>.json  per-worker ledger (strikes, quarantine) —
                               written ONLY by the scheduler
        seen/<worker>.json     per-worker liveness stamp — written ONLY by
                               the worker itself

The ledger/liveness split is a single-writer-per-file rule: strikes and
quarantine flags are scheduler-owned, last-seen stamps are worker-owned, so
no unsynchronized read-modify-write can ever erase a quarantine (a worker
re-writing a stale copy of its own ledger while the scheduler strikes it).
Per-worker completion counts are derived from item lineage, not stored.

Correctness rests on two filesystem guarantees and nothing else:

  - **Atomic claim.** A worker claims an item by `os.replace`-ing its file
    from `pending/` into `leased/` — rename is atomic, so exactly one of N
    racing workers wins; the losers see `FileNotFoundError` and move on.
  - **At-least-once, exactly-committed.** A claimed item may be executed
    more than once (a worker can die after training but before
    completion), but it is *committed* exactly once: `complete()` verifies
    lease ownership and `os.replace`s the item into `done/` — the single
    commit point, mirroring the checkpoint protocol in
    `train.checkpoint.save_checkpoint_tree`.

Liveness comes from **leases**: a claim writes a lease file with an expiry;
the worker's heartbeat thread renews it (rewrite via temp + `os.replace`)
while the item trains. A worker that dies stops renewing; the scheduler's
`reap_expired()` moves the item back to `pending/` with its `attempt`
bumped and a lineage entry recording which worker lost it — the
reassignment trail `fleet.report` renders. Renewal is read-verify-write,
so a zombie worker whose lease was reaped gets `LeaseLost` instead of
silently resurrecting it.

Workers that keep losing leases (bad host, sick HBM, flaky NFS mount) are
**quarantined** after `quarantine_after` strikes: their ledger file gains
`quarantined: true` and their own `claim()` calls return nothing — graceful
degradation, not a reassignment stampede onto the same broken machine.

Every item carries its own history: `attempt` (0-based claim count) and
`lineage` (one entry per claim: worker, timestamps, outcome, the
checkpoint it resumed from). The history travels WITH the item file
through every move, so the fleet report needs no join against event logs
to reconstruct who lost what and where it resumed.

Counterpart of `sparse_coding__tpu/fleet/queue.py`, copied (stdlib only):
the layout and every file's JSON are the JAX package's, byte for byte, so a
queue that either package's workers and scheduler share is one queue.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "LeaseLost",
    "WorkQueue",
    "is_fleet_dir",
]

_BUCKETS = ("pending", "leased", "done", "failed")


class LeaseLost(RuntimeError):
    """The caller no longer holds the lease it is acting under (expired and
    reaped, or the item was reassigned/completed by someone else)."""


def _write_json(path: Path, obj: Dict[str, Any]) -> None:
    """Atomic JSON write: same-dir temp + `os.replace` (the idiom every
    commit point in this repo uses — a kill mid-write leaves the previous
    complete file or nothing, never a torn one)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.tmp{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_json(path: Path) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def is_fleet_dir(path) -> bool:
    """Does `path` hold a fleet queue? (`queue/pending/` is created by the
    first `WorkQueue` construction and never removed.)"""
    return (Path(path) / "queue" / "pending").is_dir()


def _check_id(name: str, what: str) -> str:
    if not name or any(c in name for c in "/\\\0") or name.startswith("."):
        raise ValueError(f"invalid {what} id {name!r} (must be a plain file name)")
    return name


class WorkQueue:
    """One fleet's work queue rooted at `<fleet_dir>/queue/`.

    Many processes may hold a `WorkQueue` on the same directory — all
    cross-process coordination is the rename protocol above; the object
    itself keeps no authoritative state.
    """

    def __init__(self, fleet_dir, create: bool = True):
        self.fleet_dir = Path(fleet_dir)
        self.root = self.fleet_dir / "queue"
        if create:
            for b in _BUCKETS + ("leases", "workers", "seen"):
                (self.root / b).mkdir(parents=True, exist_ok=True)
        elif not self.root.is_dir():
            raise FileNotFoundError(f"no fleet queue under {self.fleet_dir}")

    # -- paths ----------------------------------------------------------------

    def _item_path(self, bucket: str, item_id: str) -> Path:
        return self.root / bucket / f"{item_id}.json"

    def _lease_path(self, item_id: str) -> Path:
        return self.root / "leases" / f"{item_id}.json"

    def _worker_path(self, worker_id: str) -> Path:
        return self.root / "workers" / f"{worker_id}.json"

    def _seen_path(self, worker_id: str) -> Path:
        return self.root / "seen" / f"{worker_id}.json"

    def run_dir(self, item_id: str) -> Path:
        """The item's training output directory (`<fleet_dir>/runs/<item>`)
        — checkpoints, learned-dict exports, and events land here, and a
        reassigned item resumes from whatever committed checkpoint the
        previous holder left."""
        return self.fleet_dir / "runs" / _check_id(item_id, "item")

    # -- submission -----------------------------------------------------------

    def submit(
        self,
        item_id: str,
        members: List[str],
        payload: Dict[str, Any],
    ) -> Dict[str, Any]:
        """Enqueue one work item. `members` names the ensemble members the
        item trains (the unit the zero-lost-members guarantee is counted
        in); `payload` tells the worker how to run it (see
        `fleet.worker.run_item`)."""
        _check_id(item_id, "item")
        for bucket in _BUCKETS:
            if self._item_path(bucket, item_id).exists():
                raise FileExistsError(f"item {item_id!r} already exists in {bucket}/")
        item = {
            "item": item_id,
            "members": list(members),
            "payload": dict(payload),
            "attempt": 0,
            "submitted_ts": time.time(),
            "lineage": [],
        }
        _write_json(self._item_path("pending", item_id), item)
        return item

    # -- worker ledger / quarantine -------------------------------------------

    def worker_record(self, worker_id: str) -> Dict[str, Any]:
        """Scheduler-owned ledger (strikes/quarantine) merged with the
        worker-owned liveness stamp. Read-only composition — neither writer
        ever rewrites the other's file."""
        rec = _read_json(self._worker_path(worker_id)) or {
            "worker": worker_id, "strikes": 0, "quarantined": False,
        }
        seen = _read_json(self._seen_path(worker_id))
        if seen and seen.get("last_seen_ts") is not None:
            rec["last_seen_ts"] = float(seen["last_seen_ts"])
        return rec

    def worker_quarantined(self, worker_id: str) -> bool:
        return bool(self.worker_record(worker_id).get("quarantined"))

    def touch_seen(self, worker_id: str) -> None:
        """Worker-side liveness stamp. Deliberately NOT the ledger file:
        the ledger is scheduler-owned, so a concurrent strike/quarantine
        can never be erased by a worker's stale read-modify-write."""
        _write_json(
            self._seen_path(worker_id),
            {"worker": worker_id, "last_seen_ts": time.time()},
        )

    def strike_worker(
        self, worker_id: str, reason: str, quarantine_after: Optional[int] = None
    ) -> Dict[str, Any]:
        """One strike against a worker (an expired or failed lease). After
        `quarantine_after` strikes the worker is quarantined: its own
        `claim()` calls return None, so reassignment flows to healthy
        workers instead of stampeding back onto a repeat offender. Called
        ONLY by the scheduler — the ledger's single writer."""
        rec = _read_json(self._worker_path(worker_id)) or {
            "worker": worker_id, "strikes": 0, "quarantined": False,
        }
        rec["strikes"] = int(rec.get("strikes", 0)) + 1
        rec.setdefault("strike_reasons", []).append(reason)
        if quarantine_after is not None and rec["strikes"] >= quarantine_after:
            rec["quarantined"] = True
        _write_json(self._worker_path(worker_id), rec)
        return self.worker_record(worker_id)

    # -- claim / renew --------------------------------------------------------

    def claim(
        self, worker_id: str, lease_seconds: float = 30.0
    ) -> Optional[Dict[str, Any]]:
        """Claim the first available pending item, or None (empty queue or
        quarantined worker). The rename IS the mutual exclusion; the lease
        file written right after it is the liveness contract."""
        _check_id(worker_id, "worker")
        if self.worker_quarantined(worker_id):
            return None
        self.touch_seen(worker_id)
        now = time.time()
        for src in sorted((self.root / "pending").glob("*.json")):
            if src.name.startswith("."):
                continue  # a writer's temp file
            dst = self.root / "leased" / src.name
            try:
                os.replace(src, dst)  # atomic: exactly one claimer wins
            except FileNotFoundError:
                continue  # lost the race for this item; try the next
            try:
                # rename preserves mtime; stamp the CLAIM time so the
                # reaper's claim-without-lease grace window measures from
                # here, not from however long the item sat in pending/
                os.utime(dst)
            except OSError:
                pass
            item = _read_json(dst)
            if item is None:  # torn submit (should be impossible; be safe)
                continue
            item["lineage"].append(
                {
                    "attempt": int(item.get("attempt", 0)),
                    "worker": worker_id,
                    "claimed_ts": now,
                    "outcome": "running",
                }
            )
            _write_json(dst, item)
            _write_json(
                self._lease_path(item["item"]),
                {
                    "item": item["item"],
                    "worker": worker_id,
                    "claimed_ts": now,
                    "renewed_ts": now,
                    "expires_ts": now + float(lease_seconds),
                    "renewals": 0,
                },
            )
            return item
        return None

    def _owned_lease(self, item_id: str, worker_id: str) -> Dict[str, Any]:
        lease = _read_json(self._lease_path(item_id))
        if lease is None or lease.get("worker") != worker_id:
            raise LeaseLost(
                f"worker {worker_id} no longer holds the lease on {item_id} "
                f"(held by {lease.get('worker') if lease else 'nobody'})"
            )
        return lease

    def renew(
        self, item_id: str, worker_id: str, lease_seconds: float = 30.0
    ) -> Dict[str, Any]:
        """Heartbeat: extend the lease. Read-verify-write, so a reaped lease
        raises `LeaseLost` instead of being silently resurrected by a
        zombie holder."""
        lease = self._owned_lease(item_id, worker_id)
        now = time.time()
        lease.update(
            renewed_ts=now,
            expires_ts=now + float(lease_seconds),
            renewals=int(lease.get("renewals", 0)) + 1,
        )
        _write_json(self._lease_path(item_id), lease)
        return lease

    def note(self, item_id: str, worker_id: str, **fields) -> None:
        """Record fields (e.g. ``resumed_from``) on the current lineage
        entry of a leased item — the reassignment trail the fleet report
        renders."""
        self._owned_lease(item_id, worker_id)
        path = self._item_path("leased", item_id)
        item = _read_json(path)
        if item is None or not item.get("lineage"):
            raise LeaseLost(f"leased item {item_id} vanished")
        item["lineage"][-1].update(fields)
        _write_json(path, item)

    # -- completion / failure -------------------------------------------------

    def complete(
        self, item_id: str, worker_id: str, result: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        """Commit the item as done. Requires a live owned lease; the
        `os.replace` into `done/` is the exactly-once commit point."""
        self._owned_lease(item_id, worker_id)
        src = self._item_path("leased", item_id)
        item = _read_json(src)
        if item is None:
            raise LeaseLost(f"leased item {item_id} vanished")
        item["lineage"][-1].update(outcome="done", completed_ts=time.time())
        if result:
            item["result"] = result
            # the export manifest's content digest: recorded in
            # the lineage entry itself so the provenance graph joins this
            # item to its export by digest even if `result` is later
            # rewritten by a requeue_done round trip
            if result.get("export_digest"):
                item["lineage"][-1]["export_digest"] = result["export_digest"]
        _write_json(src, item)
        os.replace(src, self._item_path("done", item_id))
        self._lease_path(item_id).unlink(missing_ok=True)
        self.touch_seen(worker_id)
        return item

    def _requeue(
        self,
        item: Dict[str, Any],
        src: Path,
        outcome: str,
        max_attempts: Optional[int],
        **fields,
    ) -> str:
        """Move a leased item back to pending (attempt+1) or, past the
        attempt budget, to failed/. Returns the destination bucket."""
        item["lineage"][-1].update(outcome=outcome, released_ts=time.time(), **fields)
        item["attempt"] = int(item.get("attempt", 0)) + 1
        lost = max_attempts is not None and item["attempt"] >= max_attempts
        bucket = "failed" if lost else "pending"
        _write_json(src, item)
        os.replace(src, self._item_path(bucket, item["item"]))
        self._lease_path(item["item"]).unlink(missing_ok=True)
        return bucket

    def fail(
        self,
        item_id: str,
        worker_id: str,
        error: str,
        max_attempts: Optional[int] = None,
        outcome: str = "failed",
    ) -> str:
        """Graceful failure: the worker saw the item's run die and releases
        it for another attempt. Returns the bucket the item landed in
        ('pending' or, budget exhausted, 'failed'). ``outcome`` names the
        lineage entry's terminal mark — e.g. ``input_corrupt`` when the
        admission check found the item's chunk store rotten (mirroring the
        scheduler's post-completion ``export_corrupt`` requeues)."""
        self._owned_lease(item_id, worker_id)
        src = self._item_path("leased", item_id)
        item = _read_json(src)
        if item is None:
            raise LeaseLost(f"leased item {item_id} vanished")
        return self._requeue(item, src, outcome, max_attempts, error=str(error)[:500])

    def release(self, item_id: str, worker_id: str, outcome: str = "released") -> None:
        """Voluntary release WITHOUT an attempt penalty (worker shutting
        down / preempted after committing a resumable checkpoint)."""
        self._owned_lease(item_id, worker_id)
        src = self._item_path("leased", item_id)
        item = _read_json(src)
        if item is None:
            raise LeaseLost(f"leased item {item_id} vanished")
        item["lineage"][-1].update(outcome=outcome, released_ts=time.time())
        _write_json(src, item)
        os.replace(src, self._item_path("pending", item_id))
        self._lease_path(item_id).unlink(missing_ok=True)

    def requeue_done(
        self,
        item_id: str,
        outcome: str,
        error: str,
        max_attempts: Optional[int] = None,
    ) -> Optional[tuple]:
        """Send a done/ item back for retraining (post-completion export
        corruption) through the SAME lineage/attempt/budget protocol as
        every other requeue. Returns (bucket, item) — 'pending' or, budget
        exhausted, 'failed' — or None if the item is no longer in done/."""
        src = self._item_path("done", item_id)
        item = _read_json(src)
        if item is None:
            return None
        item.setdefault("lineage", []).append(
            {"attempt": int(item.get("attempt", 0)), "worker": None}
        )
        bucket = self._requeue(item, src, outcome, max_attempts, error=str(error)[:500])
        return bucket, item

    # -- reaping (scheduler side) ---------------------------------------------

    def reap_expired(
        self,
        now: Optional[float] = None,
        max_attempts: Optional[int] = None,
        quarantine_after: Optional[int] = None,
        grace_seconds: float = 30.0,
        on_event: Optional[Callable[[str, Dict[str, Any]], None]] = None,
    ) -> List[Dict[str, Any]]:
        """Reassign dead work. For every leased item whose lease has
        expired (worker stopped heartbeating — killed, hung, partitioned):
        strike the worker, delete the lease, and requeue the item with its
        lineage recording who lost it. Leased items with NO lease file
        (claimer died between the claim rename and the lease write) are
        requeued after `grace_seconds` of no modification. Returns one
        action record per reassignment; `on_event(kind, fields)` mirrors
        them to telemetry."""
        now = time.time() if now is None else now
        actions: List[Dict[str, Any]] = []

        def emit(kind: str, **fields):
            actions.append({"kind": kind, **fields})
            if on_event is not None:
                on_event(kind, fields)

        # lease files whose item is no longer leased (a completer died
        # between the done-commit rename and the lease unlink) are inert —
        # sweep them so they can't shadow a future claim of the same id
        for stale in sorted((self.root / "leases").glob("*.json")):
            if stale.name.startswith("."):
                continue
            if not self._item_path("leased", stale.stem).exists():
                stale.unlink(missing_ok=True)

        for path in sorted((self.root / "leased").glob("*.json")):
            if path.name.startswith("."):
                continue
            item_id = path.stem
            lease = _read_json(self._lease_path(item_id))
            if lease is not None and float(lease.get("expires_ts", 0)) > now:
                continue  # live lease
            if lease is None:
                # claim rename landed but the lease write never did — only a
                # worker death in that tiny window produces this state
                try:
                    if now - path.stat().st_mtime < grace_seconds:
                        continue
                except OSError:
                    continue
            item = _read_json(path)
            if item is None:
                continue
            if lease is not None:
                worker = lease.get("worker")
            elif item.get("lineage") and item["lineage"][-1].get("outcome") == "running":
                # the claimer died after appending its lineage entry but
                # before the lease write — the entry names it
                worker = item["lineage"][-1].get("worker")
            else:
                # died between the claim rename and the lineage write: the
                # claimer is unknowable — never strike the PREVIOUS
                # attempt's holder for a lease it didn't claim
                worker = None
            if worker:
                rec = self.strike_worker(
                    worker, f"lease_expired:{item_id}", quarantine_after
                )
                if rec.get("quarantined") and rec["strikes"] == quarantine_after:
                    emit("quarantine", worker=worker, strikes=rec["strikes"])
            if not item.get("lineage"):
                item["lineage"].append(
                    {"attempt": int(item.get("attempt", 0)), "worker": worker,
                     "outcome": "running"}
                )
            age = now - float((lease or {}).get("renewed_ts", 0) or 0)
            bucket = self._requeue(
                item, path, "lease_expired", max_attempts,
                lease_age_seconds=round(age, 3) if lease is not None else None,
            )
            emit(
                "lease_expired",
                item=item_id,
                worker=worker,
                attempt=item["attempt"],
                requeued_to=bucket,
            )
            if bucket == "failed":
                emit(
                    "item_lost",
                    item=item_id,
                    members=item.get("members", []),
                    attempts=item["attempt"],
                )
        return actions

    # -- inspection (monitor / report side) ------------------------------------

    def items(self, bucket: str) -> List[Dict[str, Any]]:
        out = []
        for p in sorted((self.root / bucket).glob("*.json")):
            if p.name.startswith("."):
                continue
            item = _read_json(p)
            if item is not None:
                out.append(item)
        return out

    def leases(self) -> List[Dict[str, Any]]:
        out = []
        for p in sorted((self.root / "leases").glob("*.json")):
            if p.name.startswith("."):
                continue
            lease = _read_json(p)
            if lease is not None:
                out.append(lease)
        return out

    def workers(self) -> List[Dict[str, Any]]:
        """Every worker the fleet has heard of: ledger entries (struck or
        quarantined) plus seen-only workers that have claimed cleanly."""
        ids = set()
        for sub in ("workers", "seen"):
            for p in (self.root / sub).glob("*.json"):
                if not p.name.startswith("."):
                    ids.add(p.stem)
        return [self.worker_record(w) for w in sorted(ids)]

    def finished(self) -> bool:
        """No work outstanding: every item is in done/ or failed/."""
        for bucket in ("pending", "leased"):
            for p in (self.root / bucket).glob("*.json"):
                if not p.name.startswith("."):
                    return False
        return True

    def state(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One coherent snapshot for the monitor's fleet view and the fleet
        report: item/member counts per state, per-worker liveness, lease
        ages. Members of leased items split into *running* (live lease) vs
        *orphaned* (expired/missing lease, awaiting reassignment); members
        of failed items are *lost* — the number chaos tests pin to zero."""
        now = time.time() if now is None else now
        leases = {l["item"]: l for l in self.leases()}
        state: Dict[str, Any] = {
            "now": now,
            "items": {b: self.items(b) for b in _BUCKETS},
            "leases": leases,
            "workers": self.workers(),
        }
        members = {"queued": 0, "running": 0, "orphaned": 0, "done": 0, "lost": 0}
        for item in state["items"]["pending"]:
            members["queued"] += len(item.get("members", []))
        for item in state["items"]["done"]:
            members["done"] += len(item.get("members", []))
        for item in state["items"]["failed"]:
            members["lost"] += len(item.get("members", []))
        for item in state["items"]["leased"]:
            lease = leases.get(item["item"])
            live = lease is not None and float(lease.get("expires_ts", 0)) > now
            members["running" if live else "orphaned"] += len(item.get("members", []))
        state["members"] = members
        state["item_counts"] = {b: len(state["items"][b]) for b in _BUCKETS}
        # per-worker completion counts, derived from lineage rather than
        # stored in the ledger (which is scheduler-owned — see touch_seen)
        done_by_worker: Dict[str, int] = {}
        for bucket in _BUCKETS:
            for item in state["items"][bucket]:
                for entry in item.get("lineage", []):
                    if entry.get("outcome") == "done" and entry.get("worker"):
                        w = entry["worker"]
                        done_by_worker[w] = done_by_worker.get(w, 0) + 1
        state["done_by_worker"] = done_by_worker
        return state
