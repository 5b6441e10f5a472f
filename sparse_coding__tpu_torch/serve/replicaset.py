"""Replica supervisor: N serve processes, auto-restart, rolling dict swaps.

Counterpart of the JAX package's `serve/replicaset.py`, with its API, CLI
and records. `ReplicaSet` launches N ``python -m
sparse_coding__tpu_torch.serve.server`` processes (each on an ephemeral
port with its own telemetry dir, each with its own CUDA context on the card
unless ``device`` names another), watches them, and keeps the fronting
`serve.router.Router` pointed at live backends:

  - **Supervision.** A watcher polls every replica process. A dead one is
    classified with `supervise.classify_exit` (killed / crash / preempt) and
    relaunched after `supervise.RestartBudget` backoff, from a bounded
    per-replica budget with a healthy-stretch reset. The router hears of the
    death at once (`mark_down`), and readmits the replica only after the
    relaunched process answers ``/healthz`` (which the server does only
    after its warmup, so a readmitted replica has captured its dispatch
    graphs). The backoff wait is a ``restart_backoff`` span.
  - **Drain-aware rolling dict swaps.** `rolling_swap(new_exports)` walks
    the set one replica at a time: quiesce (the router stops new forwards),
    drain (SIGTERM: the server completes every accepted request and exits
    0), relaunch on the new export with the next ``--dict-generation`` and
    wait for it to warm, readmit. At every instant at least N-1 replicas
    serve, and each response is wholly one replica's bytes, stamped with its
    generation: no client sees a torn rollout.

``device=None`` passes no ``--device``: each replica serves on the card, and
one that cannot take it exits non-zero and is counted as a crash; there is
no CPU fallback. ``device="cpu"`` runs the replicas on the CPU.

CLI::

    python -m sparse_coding__tpu_torch.serve.replicaset out/learned_dicts.pkl \\
        --replicas 2 --run-dir out/serve_tier --port 0 --port-file PF \\
        [--swap-file SW] [--metrics-port 0] [--warmup-topk 32] [--device cpu]

runs replicas, router and supervisor in one process tree; SIGTERM drains
everything and exits 0. ``--swap-file PATH`` arms a rolling-swap trigger:
when PATH appears, its lines (export paths) roll out as the next generation
and PATH is renamed to PATH.done. ``--warmup-topk K`` has every replica
capture its top-k dispatches too before it is admitted. Telemetry lands
under ``--run-dir``: ``replicaset_events.jsonl``, ``router_events.jsonl``
and ``replica<i>/events.jsonl`` (+ ``server.log``).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from sparse_coding__tpu_torch.serve.engine import _emit_span
from sparse_coding__tpu_torch.supervise import RestartBudget, classify_exit

__all__ = ["ReplicaSet", "ReplicaProc", "main"]


class ReplicaProc:
    """One supervised serve replica: its subprocess, rollout generation,
    restart budget, and supervision state (``starting`` / ``running`` /
    ``backoff`` / ``swapping`` / ``dead`` / ``stopped``)."""

    __slots__ = (
        "rid", "dir", "exports", "generation", "proc", "url", "state",
        "relaunch_at", "backoff_started", "ready_deadline", "started_ts",
        "expected_exit", "budget", "down_since", "last_classification",
        "restarts",
    )

    def __init__(self, rid: str, dirpath: Path, exports: List[str],
                 budget: RestartBudget):
        self.rid = rid
        self.dir = dirpath
        self.exports = list(exports)
        self.generation = 0
        self.proc: Optional[subprocess.Popen] = None
        self.url: Optional[str] = None
        self.state = "stopped"
        self.relaunch_at = 0.0
        self.backoff_started = 0.0
        self.ready_deadline = 0.0
        self.started_ts = 0.0
        self.expected_exit = False
        self.budget = budget
        self.down_since: Optional[float] = None
        self.last_classification: Optional[str] = None
        self.restarts = 0

    @property
    def port_file(self) -> Path:
        return self.dir / "port"

    def describe(self) -> Dict[str, Any]:
        return {
            "replica": self.rid, "state": self.state, "url": self.url,
            "generation": self.generation, "restarts": self.restarts,
            "pid": None if self.proc is None else self.proc.pid,
        }


class ReplicaSet:
    """See module docstring. Library lifecycle::

        rs = ReplicaSet([export], n_replicas=3, run_dir=dir, router=router)
        rs.start()                  # spawn + wait ready + register + watch
        rs.rolling_swap([export2])  # drain→swap→warm→readmit, one at a time
        rs.stop()
    """

    def __init__(
        self,
        exports: Sequence[str],
        n_replicas: int = 3,
        run_dir=None,
        *,
        router=None,
        telemetry=None,
        weights: str = "native",
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
        max_restarts: int = 8,
        backoff_base: float = 0.5,
        backoff_max: float = 30.0,
        jitter: float = 0.1,
        restart_healthy_reset: Optional[float] = 30.0,
        ready_timeout: float = 180.0,
        poll_interval: float = 0.2,
        graceful_timeout: float = 60.0,
        probe_timeout: float = 2.0,
        python: str = sys.executable,
        server_args: Sequence[str] = (),
        env: Optional[Dict[str, str]] = None,
        device: Optional[str] = None,
    ):
        if run_dir is None:
            raise ValueError("ReplicaSet needs a run_dir (port files + logs)")
        self.run_dir = Path(run_dir)
        self.router = router
        self.telemetry = telemetry
        self.weights = weights
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.ready_timeout = float(ready_timeout)
        self.poll_interval = float(poll_interval)
        self.graceful_timeout = float(graceful_timeout)
        self.probe_timeout = float(probe_timeout)
        self.python = python
        self.server_args = list(server_args)
        self.env = dict(env or {})
        # None: each replica resolves its own device (the card; a replica
        # that cannot take it exits non-zero, a crash the budget counts)
        self.device = device
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        self.replicas: List[ReplicaProc] = []
        for i in range(int(n_replicas)):
            rid = f"replica{i}"
            d = self.run_dir / rid
            d.mkdir(parents=True, exist_ok=True)
            self.replicas.append(ReplicaProc(
                rid, d, list(exports),
                RestartBudget(
                    max_restarts=max_restarts, backoff_base=backoff_base,
                    backoff_max=backoff_max, jitter=jitter,
                    reset_after=restart_healthy_reset,
                ),
            ))

    # -- telemetry helpers -----------------------------------------------------

    def _event(self, etype: str, **fields) -> None:
        if self.telemetry is not None:
            self.telemetry.event(etype, **fields)

    def _counter(self, name: str, n: int = 1) -> None:
        if self.telemetry is not None:
            self.telemetry.counter_inc(name, n)

    # -- spawn / readiness -----------------------------------------------------

    def _spawn(self, r: ReplicaProc) -> None:
        r.port_file.unlink(missing_ok=True)
        r.url = None
        r.expected_exit = False
        cmd = [
            self.python, "-m", "sparse_coding__tpu_torch.serve.server",
            *r.exports,
            "--port", "0",
            "--port-file", str(r.port_file),
            "--events", str(r.dir),
            "--replica-id", r.rid,
            "--dict-generation", str(r.generation),
            "--max-batch", str(self.max_batch),
            "--max-wait-ms", str(self.max_wait_ms),
            "--weights", self.weights,
            *(["--device", str(self.device)] if self.device is not None else []),
            *self.server_args,
        ]
        env = {**os.environ, **self.env}
        log = open(r.dir / "server.log", "ab")
        r.proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                  env=env)
        log.close()  # the child holds its own handle
        self._event("replica_spawn", replica=r.rid, generation=r.generation,
                    pid=r.proc.pid, exports=list(r.exports))

    def _check_ready(self, r: ReplicaProc) -> Optional[str]:
        """Non-blocking readiness probe: the port file exists (written only
        after warmup) and healthz answers. Returns the base URL or None."""
        if not r.port_file.is_file():
            return None
        try:
            port = int(r.port_file.read_text().strip())
        except (ValueError, OSError):
            return None
        url = f"http://127.0.0.1:{port}"
        try:
            with urllib.request.urlopen(
                url + "/healthz", timeout=self.probe_timeout
            ) as resp:
                body = json.loads(resp.read())
        except Exception:
            return None
        if body.get("status") not in ("ok", "draining"):
            return None
        return url

    def _mark_running(self, r: ReplicaProc, url: str) -> None:
        now = time.time()
        downtime = None if r.down_since is None else round(now - r.down_since, 3)
        with self._lock:
            r.url = url
            r.state = "running"
            r.started_ts = now
            r.down_since = None
        self._event("replica_ready", replica=r.rid, url=url,
                    generation=r.generation, downtime_seconds=downtime)
        if self.router is not None:
            self.router.set_backend(r.rid, url, admit=True)

    # -- supervision -----------------------------------------------------------

    def _on_death(self, r: ReplicaProc, rc: int, classification: str) -> None:
        now = time.time()
        r.last_classification = classification
        r.down_since = now
        self._event("replica_exit", replica=r.rid, exit_code=rc,
                    classification=classification, generation=r.generation)
        self._counter("replicaset.deaths")
        self._counter(f"replicaset.deaths.{classification}")
        if self.router is not None:
            self.router.mark_down(r.rid, reason=classification)
        r.budget.note_healthy(now - r.started_ts if r.started_ts else 0.0)
        if r.budget.exhausted:
            self._event("replica_budget_exhausted", replica=r.rid,
                        restarts=r.budget.attempt)
            r.state = "dead"
            return
        delay = r.budget.next_delay()
        r.backoff_started = now
        r.relaunch_at = now + delay
        r.state = "backoff"

    def tick(self) -> None:
        """One supervision pass over every replica. Non-blocking in two
        senses: backoff waits are scheduled timestamps (never sleeps), and
        readiness HTTP probes run OUTSIDE the set-wide lock — one slow
        healthz probe cannot stall another replica's restart or block
        `states()`/`rolling_swap` callers."""
        now = time.time()
        probes = []
        with self._lock:
            for r in self.replicas:
                if r.state == "running":
                    rc = r.proc.poll() if r.proc is not None else None
                    if rc is None:
                        continue
                    if r.expected_exit:
                        r.state = "stopped"
                        continue
                    self._on_death(r, rc, classify_exit(rc))
                elif r.state == "backoff":
                    if now < r.relaunch_at:
                        continue
                    attempt = r.budget.charge()
                    r.restarts += 1
                    backoff_s = now - r.backoff_started
                    _emit_span(
                        self.telemetry, "restart_backoff", "replica_backoff",
                        r.backoff_started, backoff_s, replica=r.rid,
                    )
                    self._event(
                        "replica_restart", replica=r.rid, attempt=attempt,
                        classification=r.last_classification,
                        backoff_seconds=round(backoff_s, 3),
                    )
                    self._counter("replicaset.restarts")
                    if r.last_classification:
                        self._counter(
                            f"replicaset.restarts.{r.last_classification}"
                        )
                    self._spawn(r)
                    r.state = "starting"
                    r.ready_deadline = now + self.ready_timeout
                elif r.state == "starting":
                    probes.append((r, r.proc))
        for r, proc in probes:
            rc = proc.poll() if proc is not None else None
            if rc is not None:
                with self._lock:
                    if r.state != "starting" or r.proc is not proc:
                        continue  # rolling_swap replaced it meanwhile
                    if r.expected_exit:
                        r.state = "stopped"
                    else:
                        self._on_death(r, rc, classify_exit(rc))
                continue
            url = self._check_ready(r)  # blocking HTTP — lock NOT held
            if url is not None:
                with self._lock:
                    if r.state != "starting" or r.proc is not proc:
                        continue
                self._mark_running(r, url)
            elif time.time() > r.ready_deadline:
                with self._lock:
                    if r.state != "starting" or r.proc is not proc:
                        continue
                    # never came up: kill and charge the budget
                    if proc is not None and proc.poll() is None:
                        proc.kill()
                        proc.wait()
                    self._on_death(r, -signal.SIGKILL, "ready_timeout")

    def _watch_loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            self.tick()

    # -- lifecycle -------------------------------------------------------------

    def start(self, wait_ready: bool = True) -> "ReplicaSet":
        self._event("replicaset_start", replicas=len(self.replicas))
        for r in self.replicas:
            with self._lock:
                self._spawn(r)
                r.state = "starting"
                r.ready_deadline = time.time() + self.ready_timeout
        if wait_ready:
            try:
                self.wait_all_running()
            except BaseException:
                # a failed bring-up must not orphan the replicas that DID
                # come up (start() raising means __exit__ never runs)
                self.stop()
                raise
        self._watch_thread = threading.Thread(
            target=self._watch_loop, daemon=True, name="replicaset-watch"
        )
        self._watch_thread.start()
        return self

    def wait_all_running(self, timeout: Optional[float] = None) -> None:
        deadline = time.time() + (timeout or self.ready_timeout)
        while time.time() < deadline:
            self.tick()
            with self._lock:
                states = [r.state for r in self.replicas]
            if all(s == "running" for s in states):
                return
            if any(s == "dead" for s in states):
                break
            time.sleep(0.1)
        with self._lock:
            states = {r.rid: r.state for r in self.replicas}
        raise TimeoutError(f"replica set never became ready: {states}")

    def urls(self) -> Dict[str, Optional[str]]:
        with self._lock:
            return {r.rid: r.url for r in self.replicas}

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {r.rid: r.state for r in self.replicas}

    def describe(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [r.describe() for r in self.replicas]

    def stop(self) -> None:
        self._stop.set()
        if self._watch_thread is not None:
            self._watch_thread.join(self.poll_interval * 10 + 1)
            self._watch_thread = None
        for r in self.replicas:
            with self._lock:
                r.expected_exit = True
                proc = r.proc
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for r in self.replicas:
            proc = r.proc
            if proc is None:
                continue
            try:
                proc.wait(self.graceful_timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            with self._lock:
                r.state = "stopped"
        self._event("replicaset_stop")

    def __enter__(self) -> "ReplicaSet":
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False

    # -- rolling swap ----------------------------------------------------------

    def rolling_swap(self, new_exports: Sequence[str],
                     to_generation: Optional[int] = None) -> int:
        """Drain-aware rolling dict swap: one replica at a time, quiesce →
        SIGTERM drain (in-flight completes, exit 0) → relaunch on the new
        export with the next generation → wait warm → readmit. Returns the
        new generation. Replicas currently down just have their NEXT
        launch re-pointed — a swap never waits on a dead replica."""
        new_exports = [str(e) for e in new_exports]
        with self._lock:
            from_gen = max(r.generation for r in self.replicas)
        to_gen = from_gen + 1 if to_generation is None else int(to_generation)
        t0 = time.time()
        self._event("rolling_swap_start", from_generation=from_gen,
                    to_generation=to_gen, replicas=len(self.replicas))
        swapped = 0
        for r in self.replicas:
            with self._lock:
                if r.state != "running":
                    # down/dying replica: re-point its next launch and move
                    # on — the watcher relaunches it on the new generation.
                    # A launch already in flight ('starting') is running the
                    # OLD exports: replace it now, or it would warm up,
                    # readmit, and serve stale dicts under the new
                    # generation stamp forever.
                    r.exports = list(new_exports)
                    r.generation = to_gen
                    if (
                        r.state == "starting"
                        and r.proc is not None
                        and r.proc.poll() is None
                    ):
                        stale = r.proc
                        r.expected_exit = True
                        stale.terminate()
                        try:
                            stale.wait(self.graceful_timeout)
                        except subprocess.TimeoutExpired:
                            stale.kill()
                            stale.wait()
                        self._spawn(r)  # resets expected_exit; stays starting
                        r.ready_deadline = time.time() + self.ready_timeout
                    continue
                r.state = "swapping"
                r.expected_exit = True
                proc = r.proc
            if self.router is not None:
                self.router.quiesce(r.rid)
            t_drain = time.time()
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(self.graceful_timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait()
            self._event("replica_drained", replica=r.rid, exit_code=rc,
                        seconds=round(time.time() - t_drain, 3))
            with self._lock:
                r.exports = list(new_exports)
                r.generation = to_gen
                self._spawn(r)
            # blocking warm wait: the swap only advances once this replica
            # is warm and answering — at most one replica is ever out
            deadline = time.time() + self.ready_timeout
            url = None
            proc_died = False
            while time.time() < deadline:
                if r.proc.poll() is not None:
                    proc_died = True
                    break
                url = self._check_ready(r)
                if url is not None:
                    break
                time.sleep(0.1)
            if url is None:
                with self._lock:
                    r.state = "starting"
                    r.ready_deadline = time.time() + self.ready_timeout
                self._event("replica_swap_failed", replica=r.rid,
                            generation=to_gen, died=bool(proc_died))
                if self.router is not None:
                    self.router.readmit(r.rid)
                continue
            self._mark_running(r, url)
            if self.router is not None:
                self.router.readmit(r.rid)
            swapped += 1
            self._event("replica_swapped", replica=r.rid, generation=to_gen)
        self._counter("replicaset.swaps")
        self._event(
            "rolling_swap_done", generation=to_gen, replicas=swapped,
            seconds=round(time.time() - t0, 3),
        )
        return to_gen


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparse_coding__tpu_torch.serve.replicaset",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("exports", nargs="+",
                    help="learned-dict export(s) every replica serves")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--run-dir", required=True,
                    help="telemetry + port files + server logs land here")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8700,
                    help="router port (0 = ephemeral; see --port-file)")
    ap.add_argument("--port-file", default=None,
                    help="write the router's bound port here once ready")
    ap.add_argument("--device", default=None,
                    help="where every replica serves (default: the CUDA "
                    "card; 'cpu' for the CPU)")
    ap.add_argument("--weights", choices=("native", "int8"), default="native")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--warmup-topk", type=int, action="append", default=None,
                    metavar="K",
                    help="every replica also captures the top-k dispatch "
                    "for this k before it is admitted (repeatable; "
                    "serve.server --warmup-topk)")
    ap.add_argument("--max-restarts", type=int, default=8)
    ap.add_argument("--health-interval", type=float, default=1.0)
    ap.add_argument("--dead-after", type=int, default=3)
    ap.add_argument("--hedge-ms", type=float, default=None)
    ap.add_argument("--max-inflight", type=int, default=256)
    ap.add_argument("--swap-file", default=None, metavar="PATH",
                    help="rolling-swap trigger: when PATH appears, its "
                    "lines (export paths) roll out as the next generation "
                    "and PATH is renamed to PATH.done")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve the replicaset supervisor's own counters "
                    "(restarts, deaths, swaps) as Prometheus text on "
                    "http://HOST:PORT/metrics (0 = ephemeral; the router "
                    "and every replica already mount their own /metrics)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from sparse_coding__tpu_torch.serve.router import Router
    from sparse_coding__tpu_torch.telemetry import RunTelemetry
    from sparse_coding__tpu_torch.train import preemption

    rs_tel = RunTelemetry(out_dir=args.run_dir, run_name="replicaset",
                          file_name="replicaset_events.jsonl")
    router_tel = RunTelemetry(out_dir=args.run_dir, run_name="router",
                              file_name="router_events.jsonl")
    rs_tel.run_start(config={
        "exports": list(args.exports), "replicas": args.replicas,
        "weights": args.weights, "max_batch": args.max_batch,
        "device": args.device,
    })
    router_tel.run_start(config={
        "replicas": args.replicas, "hedge_ms": args.hedge_ms,
        "max_inflight": args.max_inflight,
    })
    router = Router(
        telemetry=router_tel, health_interval=args.health_interval,
        dead_after=args.dead_after, hedge_ms=args.hedge_ms,
        max_inflight=args.max_inflight, host=args.host, port=args.port,
        verbose=args.verbose,
    )
    rs = ReplicaSet(
        args.exports, n_replicas=args.replicas, run_dir=args.run_dir,
        router=router, telemetry=rs_tel, weights=args.weights,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        max_restarts=args.max_restarts, device=args.device,
        server_args=[a for k in args.warmup_topk or ()
                     for a in ("--warmup-topk", str(k))],
    )
    rs.start()
    router.start()
    metrics_srv = None
    if args.metrics_port is not None:
        from sparse_coding__tpu_torch.telemetry.metrics_http import serve_metrics_server

        metrics_srv = serve_metrics_server(
            rs_tel, host=args.host, port=args.metrics_port
        )
        print(f"[replicaset] /metrics on {metrics_srv.address}/metrics",
              flush=True)
    if args.port_file:
        Path(args.port_file).write_text(str(router.port))
    print(f"[replicaset] router on {router.address} fronting "
          f"{args.replicas} replica(s): {rs.urls()}", flush=True)

    preemption.install_signal_handlers()
    preemption.poller_started()
    status = "ok"
    try:
        swap_path = Path(args.swap_file) if args.swap_file else None
        while not preemption.preemption_requested():
            if swap_path is not None and swap_path.is_file():
                exports = [
                    line.strip() for line in swap_path.read_text().splitlines()
                    if line.strip()
                ]
                swap_path.rename(Path(str(swap_path) + ".done"))
                if exports:
                    gen = rs.rolling_swap(exports)
                    print(f"[replicaset] rolled out generation {gen}",
                          flush=True)
            time.sleep(0.1)
        print("[replicaset] drain requested — stopping replicas", flush=True)
        rs.stop()
        router.stop()
        status = "drained"
        return 0
    except KeyboardInterrupt:
        rs.stop()
        router.stop()
        status = "drained"
        return 0
    finally:
        if metrics_srv is not None:
            metrics_srv.stop()
        preemption.poller_stopped()
        router_tel.close(status=status)
        rs_tel.close(status=status)


if __name__ == "__main__":
    sys.exit(main())
