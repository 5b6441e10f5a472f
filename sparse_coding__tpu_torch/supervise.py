"""Auto-resume supervisor: keep a training driver alive across preemptions.

Counterpart of `sparse_coding__tpu/supervise.py` (stdlib only), with its
CLI and its records::

    python -m sparse_coding__tpu_torch.supervise [options] -- <command...>

runs the driver command as a subprocess and restarts it when it exits with
the *resumable* code **75** (`train.preemption.RESUMABLE_EXIT_CODE`, what
the port's drivers emit after committing their preemption checkpoint).
Restarted children get ``SC_RESUME=1`` in their environment, which the
drivers' default ``resume=None`` consults, so the same command line resumes
from the latest committed checkpoint::

    python -m sparse_coding__tpu_torch.supervise --run-dir out/sweep1 -- \\
        python -m my_driver out/sweep1 ...

Exit classification (`classify_exit`):

  - ``preempt``        exit code 75: restart (the default policy)
  - ``anomaly-abort``  a nonzero exit whose run dir recorded an ``anomaly``
                       event with ``action="abort"`` after the child started:
                       deterministic, never restarted
  - ``killed``         died on a signal (SIGKILL, OOM): a hard crash
  - ``crash``          any other nonzero exit

``--restart-on any`` also restarts killed/crash exits. Restarts draw from a
bounded budget (``--max-restarts``), spaced by exponential backoff with
jitter (``--backoff-base``, ``--backoff-max``, ``--jitter``); an exhausted
budget exits with the child's last nonzero code. ``--backoff-reset-after
SECS`` replenishes the budget whenever a child survives SECS of healthy
running, so only a crash loop exhausts it.

Every spawn and restart is a record in ``supervisor_events.jsonl`` under
``--run-dir`` (``spawn`` / ``restart`` / ``backoff_reset`` / ``give_up`` /
``budget_exhausted`` / ``supervisor_preempted``, and a ``restart_backoff``
span a wait). The supervisor forwards SIGTERM/SIGINT to the child, waits for
it to checkpoint, and exits with the child's code without restarting.
`RestartBudget` and `classify_exit` are shared with the serving tier's
replica supervisor (`serve.replicaset.ReplicaSet`).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional

from sparse_coding__tpu_torch.train.preemption import RESUMABLE_EXIT_CODE, RESUME_ENV
from sparse_coding__tpu_torch.utils.sync import backoff_delays

__all__ = ["RestartBudget", "classify_exit", "compute_backoff", "run_supervised", "main"]


def compute_backoff(attempt: int, base: float = 1.0, cap: float = 60.0, jitter: float = 0.25,
                    rng: Optional[random.Random] = None) -> float:
    """Exponential backoff with multiplicative jitter: the k-th restart waits
    ``min(base * 2**k, cap) * (1 + jitter * U[0,1))`` seconds, the capped
    schedule being `utils.sync.backoff_delays`'."""
    delay = backoff_delays(max(0, attempt) + 2, base, max_delay=cap)[-1]
    if jitter > 0:
        delay *= 1.0 + jitter * (rng or random).random()
    return delay


class RestartBudget:
    """Bounded-restart bookkeeping shared by this supervisor and the replica
    supervisor: ``max_restarts`` attempts, `compute_backoff` between them,
    and an optional healthy-stretch reset (a child that survived
    ``reset_after`` seconds starts the schedule over).

    Usage: ``note_healthy(seconds)`` after each exit (returns the attempts
    cleared), check ``exhausted``, take ``next_delay()`` for the sleep, then
    ``charge()`` when the restart is taken."""

    def __init__(self, max_restarts: int = 8, backoff_base: float = 1.0, backoff_max: float = 60.0,
                 jitter: float = 0.25, reset_after: Optional[float] = None, rng: Optional[random.Random] = None):
        self.max_restarts = int(max_restarts)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.jitter = float(jitter)
        self.reset_after = reset_after
        self.rng = rng
        self.attempt = 0

    def note_healthy(self, healthy_seconds: float) -> int:
        """Reset the budget when the last run stretch was healthy enough;
        returns the attempts cleared (0 = no reset)."""
        if self.reset_after is not None and self.attempt > 0 and healthy_seconds >= self.reset_after:
            cleared, self.attempt = self.attempt, 0
            return cleared
        return 0

    @property
    def exhausted(self) -> bool:
        return self.attempt >= self.max_restarts

    def next_delay(self) -> float:
        return compute_backoff(self.attempt, self.backoff_base, self.backoff_max, self.jitter, rng=self.rng)

    def charge(self) -> int:
        """Record one taken restart; returns the new attempt count."""
        self.attempt += 1
        return self.attempt


def _recent_abort(run_dir: Optional[str], since_ts: float) -> bool:
    """Did the run dir record an abort-action anomaly after `since_ts`?"""
    if run_dir is None or not Path(run_dir).is_dir():
        return False
    for path in Path(run_dir).rglob("*events*.jsonl"):
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # a torn tail
                    if (rec.get("event") == "anomaly" and rec.get("action") == "abort"
                            and float(rec.get("ts", 0)) >= since_ts):
                        return True
        except OSError:
            continue
    return False


def classify_exit(returncode: int, run_dir: Optional[str] = None, since_ts: float = 0.0) -> str:
    """Classify a child exit: ok | preempt | anomaly-abort | killed | crash."""
    if returncode == 0:
        return "ok"
    if returncode == RESUMABLE_EXIT_CODE:
        return "preempt"
    if returncode < 0:
        return "killed"  # subprocess convention: -signum
    if _recent_abort(run_dir, since_ts):
        return "anomaly-abort"
    return "crash"


def _prior_generations(run_dir: Optional[str]) -> int:
    """How many driver generations already ran in this run dir (``run_start``
    records in its ``events*.jsonl``, max over per-process files): the spawn
    and restart stamps continue this count, as the child's own does."""
    if run_dir is None:
        return 0
    best = 0
    for path in Path(run_dir).glob("events*.jsonl"):
        try:
            with open(path, "r", errors="replace") as f:
                best = max(best, sum(1 for line in f if '"event": "run_start"' in line))
        except OSError:
            continue
    return best


def run_supervised(cmd: List[str], run_dir: Optional[str] = None, max_restarts: int = 8, backoff_base: float = 1.0,
                   backoff_max: float = 60.0, jitter: float = 0.25, restart_on: str = "preempt",
                   backoff_reset_after: Optional[float] = None, telemetry=None, on_spawn=None,
                   should_continue=None, outcome: Optional[dict] = None) -> int:
    """Supervise `cmd`; returns the exit code the supervisor should exit with.
    `telemetry` (a RunTelemetry) is the caller's; None runs silently.

    ``on_spawn(proc)`` fires with each generation's `subprocess.Popen`;
    ``should_continue()`` is consulted before every restart (False stops and
    hands the child's exit code up). ``outcome``, if given, is filled with
    ``{"reason": ...}``: ``ok`` / ``supervisor_preempted`` / ``caller_stop``
    / ``budget_exhausted`` / a give-up classification, since the bare exit
    code 75 can mean either "this process is preempted" or "the child burned
    its budget"."""
    if restart_on not in ("preempt", "any"):
        raise ValueError(f"unknown restart_on {restart_on!r}")
    from sparse_coding__tpu_torch.telemetry.spans import span

    signaled: dict = {"got": None}
    child: dict = {"proc": None}

    def stopped(reason: str) -> None:
        if outcome is not None:
            outcome["reason"] = reason

    def event(etype: str, **fields) -> None:
        if telemetry is not None:
            telemetry.event(etype, **fields)

    def forward(signum, frame):
        signaled["got"] = signum
        proc = child["proc"]
        if proc is not None and proc.poll() is None:
            proc.send_signal(signal.SIGTERM)  # graceful: the driver checkpoints

    prev_handlers = {}
    for s in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[s] = signal.signal(s, forward)
        except (ValueError, OSError):  # not the main thread (tests)
            pass

    budget = RestartBudget(max_restarts=max_restarts, backoff_base=backoff_base, backoff_max=backoff_max,
                           jitter=jitter, reset_after=backoff_reset_after)
    # child generations started, continuing those already in the run dir
    spawned = _prior_generations(run_dir)
    try:
        while True:
            attempt = budget.attempt
            env = dict(os.environ)
            if attempt > 0:
                env[RESUME_ENV] = "1"
            started = time.time()
            event("spawn", attempt=attempt, generation=spawned, run_dir=run_dir, cmd=cmd,
                  resume=attempt > 0 or env.get(RESUME_ENV) == "1")
            proc = subprocess.Popen(cmd, env=env)
            spawned += 1
            child["proc"] = proc
            if on_spawn is not None:
                on_spawn(proc)
            rc = proc.wait()
            child["proc"] = None
            exited = time.time()
            cls = classify_exit(rc, run_dir=run_dir, since_ts=started)
            if cls == "ok":
                stopped("ok")
                return 0
            if signaled["got"] is not None:
                # the supervisor itself is preempted: hand the code up
                event("supervisor_preempted", signum=signaled["got"], child_exit=rc)
                stopped("supervisor_preempted")
                return rc if rc > 0 else RESUMABLE_EXIT_CODE
            restartable = cls == "preempt" or (restart_on == "any" and cls in ("killed", "crash"))
            healthy_seconds = exited - started
            cleared = budget.note_healthy(healthy_seconds)
            if cleared:
                event("backoff_reset", healthy_seconds=round(healthy_seconds, 3), attempts_cleared=cleared)
            rc_out = rc if rc > 0 else 128 + abs(rc)
            if should_continue is not None and not should_continue():
                event("give_up", reason="caller_stop", exit_code=rc)
                stopped("caller_stop")
                return rc_out
            if not restartable:
                event("give_up", reason=cls, exit_code=rc)
                stopped(cls)
                return rc_out
            if budget.exhausted:
                event("budget_exhausted", restarts=budget.attempt, exit_code=rc)
                stopped("budget_exhausted")
                return rc_out
            delay = budget.next_delay()
            with span(telemetry, "restart_backoff", name="backoff", run_dir=run_dir):
                time.sleep(delay)
            if signaled["got"] is not None:
                # preempted during the backoff: spawn nothing more
                event("supervisor_preempted", signum=signaled["got"], child_exit=rc)
                stopped("supervisor_preempted")
                return rc if rc > 0 else RESUMABLE_EXIT_CODE
            taken = budget.charge()
            if telemetry is not None:
                telemetry.event("restart", attempt=taken, generation=spawned, run_dir=run_dir, exit_code=rc,
                                classification=cls, backoff_seconds=round(delay, 3),
                                downtime_seconds=round(time.time() - exited, 3))
                telemetry.counter_inc("restarts")
                telemetry.counter_inc(f"restarts.{cls}")
    finally:
        for s, h in prev_handlers.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError):  # pragma: no cover
                pass


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sparse_coding__tpu_torch.supervise", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--run-dir", default=None,
                    help="the driver's output dir: supervisor events land here and exit classification reads its "
                         "anomaly events")
    ap.add_argument("--max-restarts", type=int, default=8, help="restart budget (default 8)")
    ap.add_argument("--backoff-base", type=float, default=1.0, help="first-restart delay seconds (default 1.0)")
    ap.add_argument("--backoff-max", type=float, default=60.0, help="backoff cap seconds (default 60)")
    ap.add_argument("--jitter", type=float, default=0.25, help="multiplicative jitter fraction (default 0.25)")
    ap.add_argument("--backoff-reset-after", type=float, default=None, metavar="SECS",
                    help="reset the restart budget after a child survives this many seconds (default: never)")
    ap.add_argument("--restart-on", choices=("preempt", "any"), default="preempt",
                    help="restart only on resumable exits (default) or also on crashes")
    ap.add_argument("cmd", nargs=argparse.REMAINDER, help="driver command (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no driver command given (append: -- <command...>)")

    telemetry = None
    if args.run_dir is not None:
        from sparse_coding__tpu_torch.telemetry import RunTelemetry

        telemetry = RunTelemetry(out_dir=args.run_dir, run_name="supervisor", config={
            "cmd": cmd, "max_restarts": args.max_restarts, "backoff_base": args.backoff_base,
            "backoff_max": args.backoff_max, "backoff_reset_after": args.backoff_reset_after,
            "restart_on": args.restart_on}, file_name="supervisor_events.jsonl")
        telemetry.run_start()
    rc = 1
    try:
        rc = run_supervised(cmd, run_dir=args.run_dir, max_restarts=args.max_restarts,
                            backoff_base=args.backoff_base, backoff_max=args.backoff_max, jitter=args.jitter,
                            restart_on=args.restart_on, backoff_reset_after=args.backoff_reset_after,
                            telemetry=telemetry)
        return rc
    finally:
        if telemetry is not None:
            telemetry.close(status="ok" if rc == 0 else f"exit {rc}")


if __name__ == "__main__":
    sys.exit(main())
