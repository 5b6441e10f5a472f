"""Fleet worker: claim a work item, train it to completion, commit it.

``python -m sparse_coding__tpu_torch.fleet.worker <fleet_dir> --worker-id w0``
loops over `WorkQueue.claim` until the queue drains. Each claimed item:

  1. **Resume detection.** If the item's run dir already holds a committed
     checkpoint (`train.checkpoint.latest_checkpoint` — manifest-verified,
     torn/corrupt dirs skipped), this attempt resumes from it; the lineage
     entry records ``resumed_from`` so the fleet report can show where a
     reassigned item picked up.
  2. **Heartbeat.** A daemon thread renews the lease every
     ``lease_seconds / 3``. If renewal raises `LeaseLost` (the scheduler
     reaped an expired lease — this worker stalled long enough to be
     presumed dead), the thread sets a flag and requests preemption so the
     in-flight driver checkpoints and stops at its next boundary instead of
     racing the item's new holder.
  3. **Run.** ``--mode inprocess`` (default) dispatches the item's payload
     to a driver function in this process; ``--mode supervised`` spawns
     ``python -m sparse_coding__tpu_torch.fleet.worker --run-item`` as a child
     under `supervise.run_supervised`, so exit-75 preemptions restart with
     backoff exactly like a standalone supervised run.
  3b. **Admission check.** When the item's payload names a
     ``dataset_folder``, the worker verifies that chunk store at the
     digest tier BEFORE training (`data.scrub.store_loss` — the input-side
     mirror of export verification): corruption beyond
     ``SC_CHUNK_LOSS_BUDGET`` requeues the item with an ``input_corrupt``
     lineage entry (attempt charged, same budget protocol as the
     scheduler's ``export_corrupt``) so a scrub/repair pass — or a worker
     whose replica of the store is intact — gets it instead of training
     on bad rows; loss *within* the budget proceeds, and the driver's
     degraded mode accounts the skips.
  4. **Verify, then commit.** The learned-dict exports are hashed into
     ``export_manifest.json`` (per-file sizes + sha256 — the same
     size/digest discipline as checkpoint manifests) and re-verified; only
     a verifying export is `complete()`d. A member is *done* when its
     dict's bytes on disk provably match what the trainer wrote.

Failure handling is graceful-by-default: a dying run releases the item for
another attempt (`fail_mode="release"`); ``fail_mode="abandon"`` leaves the
lease for the reaper — the behavior of a SIGKILLed worker, which the
in-process chaos tests use to simulate kills without killing pytest.

Counterpart of `sparse_coding__tpu/fleet/worker.py`. The worker trains on
``device`` (None = the card; without one it raises, it never carries on on
the CPU; ``--device cpu`` / ``device="cpu"`` asks for the CPU): the
built-in ``basic_l1_sweep`` driver gets ``device=``, ``import:`` drivers get
the JAX package's two keywords (``output_folder``, ``resume``), so a
payload written for either package runs in either. A supervised child is
``python -m sparse_coding__tpu_torch.fleet.worker <fleet> --run-item <id>``,
``--device`` forwarded only when one was named. Exit codes and terminal
states are the JAX package's (75 = resumable).
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from sparse_coding__tpu_torch.fleet.queue import LeaseLost, WorkQueue
from sparse_coding__tpu_torch.utils.manifest import (
    sha256_file,
    verify_manifest,
    write_manifest,
)

__all__ = [
    "FleetWorker",
    "run_item",
    "write_export_manifest",
    "verify_export",
    "main",
]

EXPORT_MANIFEST = "export_manifest.json"


# -- learned-dict export verification -----------------------------------------
# The manifest write/verify mechanics live in the shared `utils.manifest`:
# fleet export commits and the serving registry's admission checks consume
# ONE format.

def _export_files(run_dir: Path) -> List[Path]:
    return sorted(run_dir.rglob("learned_dicts.pkl"))


def write_export_manifest(run_dir, extra: Optional[Dict[str, Any]] = None) -> Path:
    """Hash every learned-dict export under the run dir into
    ``export_manifest.json`` (per-file bytes + sha256, committed atomically
    by `utils.manifest.write_manifest`). The manifest is what turns "the
    driver returned" into "the member's dict is provably on disk" —
    completion requires it to verify. ``extra`` merges additional top-level
    keys (e.g. the ``provenance`` producer-identity block) —
    backward compatible: digest-only readers ignore them."""
    run_dir = Path(run_dir)
    files = {str(p.relative_to(run_dir)): p for p in _export_files(run_dir)}
    return write_manifest(run_dir / EXPORT_MANIFEST, files, extra=extra)


def verify_export(run_dir) -> Tuple[bool, str]:
    """Does every export file match the manifest (and does at least one
    export exist)? Returns (ok, reason)."""
    run_dir = Path(run_dir)
    ok, reason = verify_manifest(run_dir / EXPORT_MANIFEST, base_dir=run_dir)
    if not ok and reason == "no manifest":
        reason = "no export manifest"
    if not ok and reason == "manifest lists no files":
        reason = "manifest lists no exports"
    return ok, reason


# -- item execution ------------------------------------------------------------

def run_item(item: Dict[str, Any], run_dir, resume: Optional[bool] = None, device=None) -> Any:
    """Execute one work item's payload in this process.

    Payload contract::

        {"driver": "basic_l1_sweep", "kwargs": {...}}          # built-in
        {"driver": "import:my.module:train_fn", "kwargs": {...}}

    The worker supplies ``output_folder=run_dir`` and ``resume`` (True when
    a committed checkpoint already exists in the run dir — the reassignment
    resume path). Custom ``import:`` drivers take the same two keywords;
    the built-in driver also gets ``device`` (None = the card).
    """
    payload = item.get("payload") or {}
    driver = payload.get("driver")
    kwargs = dict(payload.get("kwargs") or {})
    if resume is None:
        from sparse_coding__tpu_torch.train.checkpoint import latest_checkpoint

        resume = latest_checkpoint(run_dir) is not None
    if driver == "basic_l1_sweep":
        from sparse_coding__tpu_torch.train.basic_l1_sweep import basic_l1_sweep

        return basic_l1_sweep(
            output_folder=str(run_dir), resume=bool(resume), device=device, **kwargs
        )
    if isinstance(driver, str) and driver.startswith("import:"):
        import importlib

        _, mod_name, attr = driver.split(":", 2)
        fn: Callable = getattr(importlib.import_module(mod_name), attr)
        return fn(output_folder=str(run_dir), resume=bool(resume), **kwargs)
    raise ValueError(f"unknown fleet driver {driver!r} in item {item.get('item')!r}")


class _HeartbeatThread(threading.Thread):
    """Renews the lease on a cadence; on `LeaseLost` flags the loss and
    requests preemption so the driver stops at its next boundary (the item
    has a new holder — keep racing it and two writers share a run dir).
    `on_lost` additionally fires for holders this process's preemption flag
    cannot reach (supervised mode trains in a CHILD process — the parent's
    flag stops nothing there; the hook SIGTERMs the child instead)."""

    def __init__(self, queue: WorkQueue, item_id: str, worker_id: str,
                 lease_seconds: float, every: float,
                 on_lost: Optional[Callable[[], None]] = None):
        super().__init__(daemon=True, name=f"lease-{item_id}")
        self.queue = queue
        self.item_id = item_id
        self.worker_id = worker_id
        self.lease_seconds = lease_seconds
        self.every = every
        self.on_lost = on_lost
        self.lost = False
        self._stop = threading.Event()

    def run(self):
        while not self._stop.wait(self.every):
            try:
                self.queue.renew(self.item_id, self.worker_id, self.lease_seconds)
            except LeaseLost:
                self.lost = True
                from sparse_coding__tpu_torch.train.preemption import request_preemption

                request_preemption()
                if self.on_lost is not None:
                    try:
                        self.on_lost()
                    except Exception:
                        pass  # best-effort: the flag above is the fallback
                return
            except OSError:
                continue  # transient FS hiccup: the next beat retries

    def stop(self):
        self._stop.set()


class FleetWorker:
    """One worker process's claim→run→commit loop (see module docstring)."""

    def __init__(
        self,
        fleet_dir,
        worker_id: str,
        mode: str = "inprocess",
        lease_seconds: float = 30.0,
        heartbeat_every: Optional[float] = None,
        max_attempts: Optional[int] = 5,
        fail_mode: str = "release",
        telemetry=None,
        supervise_kwargs: Optional[Dict[str, Any]] = None,
        admission_check: bool = True,
        device=None,
    ):
        if mode not in ("inprocess", "supervised"):
            raise ValueError(f"unknown worker mode {mode!r}")
        if fail_mode not in ("release", "abandon"):
            raise ValueError(f"unknown fail_mode {fail_mode!r}")
        from sparse_coding__tpu_torch.utils.device import resolve_device

        # None = the card: without one this raises here, before any claim
        resolve_device(device)
        self.device = device
        self.queue = WorkQueue(fleet_dir)
        self.worker_id = worker_id
        self.mode = mode
        self.lease_seconds = float(lease_seconds)
        self.heartbeat_every = (
            float(heartbeat_every)
            if heartbeat_every is not None
            else max(0.05, self.lease_seconds / 3.0)
        )
        self.max_attempts = max_attempts
        self.fail_mode = fail_mode
        self.telemetry = telemetry
        self.supervise_kwargs = supervise_kwargs or {}
        self.admission_check = admission_check
        # (folder, dir mtime) → False (admitted) | error string; see
        # _admission_failure
        self._admission_cache: Dict[Any, Any] = {}

    def _event(self, etype: str, **fields):
        if self.telemetry is not None:
            self.telemetry.event(etype, worker=self.worker_id, **fields)
            if etype == "input_corrupt":
                self.telemetry.counter_inc("fleet.input_corrupt")

    def publish_metrics(self):
        """Publish this worker's counters/gauges as Prometheus text to
        ``<fleet_dir>/metrics/<worker_id>.prom``. Fleet workers
        own no HTTP listener, so the exposition rides a file the fleet
        report aggregates — atomic, so a reader never sees a torn scrape.
        Best-effort: metrics publishing must never fail an item."""
        if self.telemetry is None:
            return
        from sparse_coding__tpu_torch.telemetry.metrics_http import write_metrics_file

        try:
            write_metrics_file(
                self.telemetry,
                Path(self.queue.fleet_dir) / "metrics" / f"{self.worker_id}.prom",
            )
        except OSError:
            pass

    @staticmethod
    def _store_signature(folder: Path):
        """Stat-level fingerprint of a chunk store: (name, size, mtime_ns)
        of every chunk/scale/manifest file, hashed. Far cheaper than the
        digest sweep it gates."""
        import hashlib

        h = hashlib.sha256()
        try:
            for p in sorted(folder.iterdir()):
                if p.name.startswith("."):
                    continue
                try:
                    st = p.stat()
                except OSError:
                    continue
                h.update(f"{p.name}:{st.st_size}:{st.st_mtime_ns};".encode())
        except OSError:
            return None
        return h.hexdigest()

    def _admission_failure(self, item: Dict[str, Any]) -> Optional[str]:
        """Digest-verify the item's chunk store (payload ``dataset_folder``).
        Returns an error string when the store's loss exceeds
        ``SC_CHUNK_LOSS_BUDGET`` (the item must not train), None when the
        store is whole, within budget, or the payload names no store."""
        kwargs = (item.get("payload") or {}).get("kwargs") or {}
        folder = kwargs.get("dataset_folder")
        if not folder or not Path(folder).is_dir():
            return None
        from sparse_coding__tpu_torch.data.integrity import default_loss_budget
        from sparse_coding__tpu_torch.data.scrub import store_loss

        # many items usually share one store: cache the digest sweep per
        # store SIGNATURE — a cheap stat sweep (names, sizes, file mtimes)
        # — so N claims don't re-hash a multi-GB store N times. Any write,
        # repair, quarantine move, or in-place rewrite changes a file stat
        # and invalidates the cache; only writeless media rot between two
        # claims escapes, the same residual the drivers' size tier accepts.
        key = (str(folder), self._store_signature(Path(folder)))
        cached = self._admission_cache.get(key)
        if cached is not None:
            return cached or None
        loss = store_loss(folder, depth="digest")
        verdict: Any = False  # cache sentinel: checked and admitted
        if loss["loss_frac"] > default_loss_budget():
            verdict = (
                f"input store {folder} corrupt beyond budget: "
                f"{len(loss['bad'])}/{loss['total']} chunks unverifiable "
                f"({loss['loss_frac']:.1%} > {default_loss_budget():.1%}); "
                f"bad={loss['bad'][:16]}"
            )
        self._admission_cache[key] = verdict
        return verdict or None

    def _child_cmd(self, item_id: str) -> List[str]:
        return [
            sys.executable, "-m", "sparse_coding__tpu_torch.fleet.worker",
            str(self.queue.fleet_dir), "--run-item", item_id,
            *(["--device", str(self.device)] if self.device is not None else []),
        ]

    def claim_and_run(self) -> str:
        """Claim one item and drive it to a terminal state. Returns one of
        ``idle`` (nothing claimable), ``done``, ``failed``, ``lease_lost``,
        or ``abandoned`` (fail_mode="abandon": lease left for the reaper)."""
        from sparse_coding__tpu_torch.train.checkpoint import latest_checkpoint
        from sparse_coding__tpu_torch.train.preemption import (
            Preempted,
            clear_preemption,
            preemption_signal,
        )

        item = self.queue.claim(self.worker_id, self.lease_seconds)
        if item is None:
            return "idle"
        item_id = item["item"]
        run_dir = self.queue.run_dir(item_id)
        run_dir.mkdir(parents=True, exist_ok=True)
        resumed_from = latest_checkpoint(run_dir)
        if resumed_from is not None:
            try:
                self.queue.note(
                    item_id, self.worker_id, resumed_from=resumed_from.name
                )
            except LeaseLost:
                return "lease_lost"
        self._event(
            "claim", item=item_id, attempt=item.get("attempt", 0),
            resumed_from=None if resumed_from is None else resumed_from.name,
        )
        # input-side admission check (mirror of export verification): the
        # member group's chunk store must be within the loss budget BEFORE
        # chips are spent training on it (docs/DATAPLANE.md)
        if self.admission_check:
            from sparse_coding__tpu_torch.telemetry.spans import span as _span

            with _span(self.telemetry, "export_verify",
                       name="admission_check", item=item_id):
                bad = self._admission_failure(item)
            if bad is not None:
                try:
                    bucket = self.queue.fail(
                        item_id, self.worker_id, error=bad,
                        max_attempts=self.max_attempts,
                        outcome="input_corrupt",
                    )
                except LeaseLost:
                    self._event("lease_lost", item=item_id)
                    return "lease_lost"
                self._event(
                    "input_corrupt", item=item_id, error=bad,
                    requeued_to=bucket,
                )
                return "failed"
        # supervised mode trains in a child process the parent's preemption
        # flag cannot stop: on lease loss the heartbeat SIGTERMs the child
        # (it checkpoints and exits 75) so it stops racing the new holder
        child_ref: Dict[str, Any] = {"proc": None}

        def _sigterm_child():
            proc = child_ref["proc"]
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGTERM)

        beat = _HeartbeatThread(
            self.queue, item_id, self.worker_id,
            self.lease_seconds, self.heartbeat_every,
            on_lost=_sigterm_child if self.mode == "supervised" else None,
        )
        beat.start()
        try:
            if self.mode == "inprocess":
                run_item(item, run_dir, resume=resumed_from is not None, device=self.device)
            else:
                from sparse_coding__tpu_torch.supervise import run_supervised

                sup_outcome: Dict[str, Any] = {}
                rc = run_supervised(
                    self._child_cmd(item_id), run_dir=str(run_dir),
                    telemetry=self.telemetry,
                    on_spawn=lambda p: child_ref.__setitem__("proc", p),
                    should_continue=lambda: not beat.lost,
                    outcome=sup_outcome,
                    **self.supervise_kwargs,
                )
                if rc != 0:
                    reason = sup_outcome.get("reason")
                    if reason in ("supervisor_preempted", "caller_stop"):
                        # not an item failure: either THIS worker is being
                        # preempted (release without penalty, unwind
                        # resumable) or the heartbeat stopped a child whose
                        # lease was reaped (the lease_lost path below) —
                        # both are exactly what Preempted means here
                        raise Preempted(
                            f"supervised item stopped ({reason}, exit {rc})"
                        )
                    raise RuntimeError(
                        f"supervised item run exited {rc}"
                        + (f" ({reason})" if reason else "")
                    )
        except Preempted:
            beat.stop()
            if beat.lost and preemption_signal() is None:
                # not a real preemption: the HEARTBEAT requested the stop
                # because the lease was reaped. The item has a new holder;
                # this worker is healthy — clear the self-inflicted flag
                # and move on to the next claim
                clear_preemption()
                self._event("lease_lost", item=item_id)
                return "lease_lost"
            # THIS worker is being preempted: the driver committed a
            # resumable checkpoint, so hand the item back without an
            # attempt penalty and let the exit-75 unwind continue
            try:
                self.queue.release(item_id, self.worker_id, outcome="preempted")
                self._event("item_released", item=item_id, reason="preempted")
            except LeaseLost:
                pass
            raise
        except (KeyboardInterrupt, SystemExit):
            # worker shutdown (Ctrl-C, sys.exit), not an item failure:
            # hand the item back without an attempt penalty and unwind
            beat.stop()
            try:
                self.queue.release(item_id, self.worker_id, outcome="released")
                self._event("item_released", item=item_id, reason="shutdown")
            except LeaseLost:
                pass
            raise
        except BaseException as e:
            beat.stop()
            if beat.lost:
                if preemption_signal() is None:
                    clear_preemption()
                self._event("lease_lost", item=item_id)
                return "lease_lost"
            if self.fail_mode == "abandon":
                # simulate a hard-killed worker: touch nothing, let the
                # lease expire and the reaper reassign
                self._event("item_abandoned", item=item_id, error=repr(e))
                return "abandoned"
            try:
                bucket = self.queue.fail(
                    item_id, self.worker_id, error=repr(e),
                    max_attempts=self.max_attempts,
                )
            except LeaseLost:
                self._event("lease_lost", item=item_id)
                return "lease_lost"
            self._event(
                "item_failed", item=item_id, error=repr(e), requeued_to=bucket
            )
            return "failed"
        beat.stop()
        if beat.lost:
            # trained to completion but presumed dead meanwhile: the item
            # belongs to someone else now — discard, never double-commit
            if preemption_signal() is None:
                clear_preemption()
            self._event("lease_lost", item=item_id)
            return "lease_lost"
        from sparse_coding__tpu_torch.telemetry.spans import span as _span

        from sparse_coding__tpu_torch.telemetry.events import run_fingerprint
        from sparse_coding__tpu_torch.telemetry.provenance import producer_identity

        with _span(self.telemetry, "export_verify", name="export_verify",
                   item=item_id):
            manifest_path = write_export_manifest(
                run_dir,
                extra={"provenance": producer_identity(
                    config=item.get("payload"),
                    fingerprint=run_fingerprint(),
                    run_dir=str(run_dir),
                )},
            )
            ok, reason = verify_export(run_dir)
        if not ok:
            try:
                bucket = self.queue.fail(
                    item_id, self.worker_id,
                    error=f"export verification failed: {reason}",
                    max_attempts=self.max_attempts,
                )
            except LeaseLost:
                return "lease_lost"
            self._event("item_failed", item=item_id, error=reason,
                        requeued_to=bucket)
            return "failed"
        try:
            # the manifest-bytes digest is the item's lineage join key:
            # `queue.complete` copies it into the
            # item's lineage entry, so fleet-trained dicts join the
            # provenance graph by digest instead of path guessing
            self.queue.complete(
                item_id, self.worker_id,
                result={
                    "export_manifest": EXPORT_MANIFEST, "verified": True,
                    "export_digest": sha256_file(manifest_path),
                },
            )
        except LeaseLost:
            self._event("lease_lost", item=item_id)
            return "lease_lost"
        self._event("item_done", item=item_id,
                    members=item.get("members", []))
        return "done"

    def run_forever(
        self,
        poll_every: float = 1.0,
        max_items: Optional[int] = None,
        idle_exit_seconds: Optional[float] = None,
    ) -> int:
        """Claim-and-run until the queue finishes (or this worker is
        quarantined / idle past `idle_exit_seconds`). Returns the number of
        items this worker completed."""
        done = 0
        idle_since: Optional[float] = None
        while True:
            outcome = self.claim_and_run()
            self.publish_metrics()
            if outcome == "done":
                done += 1
            if max_items is not None and done >= max_items:
                return done
            if outcome == "idle":
                if self.queue.finished():
                    return done
                if self.queue.worker_quarantined(self.worker_id):
                    self._event("worker_quarantined")
                    return done
                now = time.time()
                idle_since = idle_since or now
                if (
                    idle_exit_seconds is not None
                    and now - idle_since >= idle_exit_seconds
                ):
                    return done
                time.sleep(poll_every)
            else:
                idle_since = None


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparse_coding__tpu_torch.fleet.worker",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("fleet_dir", help="fleet root (holds queue/ and runs/)")
    ap.add_argument("--worker-id", default=None,
                    help="stable worker name (default: host-pid)")
    ap.add_argument("--mode", choices=("inprocess", "supervised"),
                    default="inprocess")
    ap.add_argument("--lease-seconds", type=float, default=30.0)
    ap.add_argument("--poll", type=float, default=1.0,
                    help="idle re-claim period (seconds)")
    ap.add_argument("--max-items", type=int, default=None)
    ap.add_argument("--idle-exit", type=float, default=None,
                    help="exit after this many idle seconds (default: wait "
                    "until the queue finishes)")
    ap.add_argument("--max-attempts", type=int, default=5,
                    help="per-item attempt budget on graceful failures")
    ap.add_argument(
        "--run-item", default=None, metavar="ITEM",
        help="internal (supervised mode child): run ONE leased item "
        "in-process and exit with the driver's code",
    )
    ap.add_argument("--device", default=None,
                    help="where items train (default: the CUDA card; 'cpu' "
                    "for the CPU); without a card and without this, exit "
                    "non-zero")
    args = ap.parse_args(argv)

    if args.run_item is not None:
        # child of a supervised-mode worker: the parent holds the lease and
        # the heartbeat; this process only trains
        queue = WorkQueue(args.fleet_dir, create=False)
        from sparse_coding__tpu_torch.fleet.queue import _read_json

        item = _read_json(queue._item_path("leased", args.run_item))
        if item is None:
            print(f"[fleet] leased item {args.run_item!r} not found", file=sys.stderr)
            return 2
        run_item(item, queue.run_dir(args.run_item), device=args.device)
        return 0

    import os
    import socket

    from sparse_coding__tpu_torch.telemetry import RunTelemetry
    from sparse_coding__tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # no card and no --device: raise before any claim
    worker_id = args.worker_id or f"{socket.gethostname()}-{os.getpid()}"

    telemetry = RunTelemetry(
        out_dir=args.fleet_dir,
        run_name=f"fleet_worker_{worker_id}",
        config={"worker": worker_id, "mode": args.mode,
                "lease_seconds": args.lease_seconds},
        file_name=f"worker_{worker_id}_events.jsonl",
    )
    telemetry.run_start()
    worker = FleetWorker(
        args.fleet_dir, worker_id, mode=args.mode,
        lease_seconds=args.lease_seconds, max_attempts=args.max_attempts,
        telemetry=telemetry, device=args.device,
    )
    status = "ok"
    try:
        done = worker.run_forever(
            poll_every=args.poll, max_items=args.max_items,
            idle_exit_seconds=args.idle_exit,
        )
        print(f"[fleet] worker {worker_id}: {done} item(s) completed")
        return 0
    except SystemExit as e:
        status = f"exit {e.code}"
        raise
    except BaseException as e:
        status = f"error: {type(e).__name__}: {e}"
        raise
    finally:
        telemetry.close(status=status)


if __name__ == "__main__":
    sys.exit(main())
