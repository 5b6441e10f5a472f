"""Live run monitor: tail a run directory's event logs, render health lines.

``python -m sparse_coding__tpu_torch.monitor <run_dir>`` follows every
``events.jsonl`` / ``events.p<i>.jsonl`` / ``*_events.jsonl`` under the run
directory (new files are picked up as hosts come online) and periodically
renders a compact status block:

    run my_sweep — 2 process(es), 3 event file(s), 14:02:11
      p0  steps 12800  412.3 steps/s  chunks 25  status running  last event 1.2s ago
      p1  steps 12800  411.9 steps/s  chunks 25  status running  last event 1.3s ago
      skew: flush spread 0.42 s (gauge) | worst chunk window 0.51 s
      clock offsets: p1 +0.003 s (±0.001)
      anomalies: 1 — nonfinite@p1 step 640 | desync: none

Throughput is read from consecutive ``heartbeat`` events per host (pod
runs); single-host runs fall back to chunk cadence. ``--once`` renders a
single snapshot and exits — nonzero when any event line is malformed
(instead of crashing mid-parse), which makes it the tier-1 smoke and a
cheap CI gate over archived run dirs.

Follow mode exits 0 once every discovered process has written ``run_end``.
Torn trailing lines (a writer mid-append) are NOT malformed: the tail
buffers them until the newline arrives.

Fleet directories (`fleet.queue.is_fleet_dir` — a `queue/pending/` layout,
docs/FLEET.md) get an extra **fleet view** block: per-worker liveness and
lease ages read straight from the lease/ledger files, plus the member
ledger (done/running/orphaned/queued/lost)::

      fleet: items 3 done / 1 leased / 0 pending / 0 failed | members 6 done / 2 running / 0 orphaned / 0 queued / 0 lost
      workers: w0 lease g3 (age 1.2s, expires in 28.8s); w1 idle 4.1s; w2 QUARANTINED (3 strikes)

``--scrape URL...`` renders live serving tiers from the
``/metrics`` endpoints (`telemetry.metrics_http`) instead of tailing
files: one line per endpoint (serve replicas and routers auto-detected),
latency quantiles read off the scraped histograms, plus tier-wide merged
totals — unreachable endpoints render DOWN instead of crashing.

``--tower URL|DIR`` renders ONE aggregated pool view from a
control tower (`telemetry.tower`) — per-target lines with *windowed*
signals from tower history, fleet idle capacity, training goodput, and
the firing alerts — instead of N history-less ``--scrape`` endpoints. An
unreachable or stale tower renders DOWN with a last-seen age; exit
semantics are unchanged.

Counterpart of `sparse_coding__tpu/telemetry/monitor.py`, copied: it tails
the port's logs and scrapes the port's replicas and routers.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from sparse_coding__tpu_torch.telemetry.multihost import (
    PROC_FILE_RE as _PROC_FILE_RE,
    format_bytes as _bytes,
)

__all__ = [
    "EventTail", "RunMonitor", "TowerView", "fleet_lines", "render",
    "scrape_render", "tower_render", "main",
]

_EVENT_GLOBS = (
    "events.jsonl",
    "events.p*.jsonl",
    "*_events.jsonl",
    "*_events.p*.jsonl",  # per-process form of custom file_name= logs
)


def discover_event_files(run_dir: Path) -> List[Path]:
    found = set()
    for pat in _EVENT_GLOBS:
        found.update(run_dir.rglob(pat))
    return sorted(found)


class EventTail:
    """Incremental reader of one JSONL event file.

    `poll()` returns ``(records, malformed)`` for everything appended since
    the last call. A trailing line without its newline is buffered (the
    writer is mid-append), never reported malformed; a complete line that
    fails to parse is returned in ``malformed`` and skipped — a torn write
    must not kill the monitor mid-parse.
    """

    def __init__(self, path: Path):
        self.path = Path(path)
        self._pos = 0
        self._partial = ""
        m = _PROC_FILE_RE.search(self.path.name)
        self.process_index: Optional[int] = int(m.group(1)) if m else None

    def poll(self) -> Tuple[List[Dict[str, Any]], List[str]]:
        try:
            with open(self.path, "r") as f:
                f.seek(self._pos)
                data = f.read()
                self._pos = f.tell()
        except OSError:
            return [], []
        if not data:
            return [], []
        buf = self._partial + data
        lines = buf.split("\n")
        self._partial = lines.pop()  # torn tail ('' when data ends in \n)
        records, malformed = [], []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                malformed.append(f"{self.path.name}: {line[:120]}")
                continue
            if not isinstance(rec, dict):
                malformed.append(f"{self.path.name}: {line[:120]}")
                continue
            if "process_index" not in rec and self.process_index is not None:
                rec["process_index"] = self.process_index
            records.append(rec)
        return records, malformed


class _ProcState:
    __slots__ = (
        "steps", "chunks", "last_ts", "status", "beats", "hbm_peak",
        "clock_offset", "clock_uncertainty", "steps_per_sec", "data",
    )

    def __init__(self):
        self.steps: Optional[int] = None
        self.chunks = 0
        self.last_ts: Optional[float] = None
        self.status = "running"
        self.beats: List[Tuple[float, int]] = []  # (ts, steps), last 2 kept
        self.hbm_peak: Optional[float] = None
        self.clock_offset: Optional[float] = None
        self.clock_uncertainty: Optional[float] = None
        self.steps_per_sec: Optional[float] = None
        self.data: Dict[str, float] = {}  # last-snapshot data.* counters


class RunMonitor:
    """Aggregates tailed events into per-process + run-level live state."""

    def __init__(self, run_dir):
        self.run_dir = Path(run_dir)
        if not self.run_dir.is_dir():
            raise FileNotFoundError(f"run dir {self.run_dir} does not exist")
        self._tails: Dict[Path, EventTail] = {}
        self.procs: Dict[int, _ProcState] = {}
        self.run_name: Optional[str] = None
        self.anomalies: List[Dict[str, Any]] = []
        self.malformed: List[str] = []
        self.skew_gauge: Optional[float] = None
        self.chunk_ends: List[Dict[str, Any]] = []
        self.events_seen = 0
        # recovery activity (docs/RECOVERY.md): driver preempt/resume events
        # + supervisor restarts
        self.preempts: List[Dict[str, Any]] = []
        self.resumes: List[Dict[str, Any]] = []
        self.restarts: List[Dict[str, Any]] = []
        # data-plane integrity (docs/DATAPLANE.md): live skip events + the
        # remaining-budget gauge; quarantines ride the anomaly list
        self.chunk_skips: List[Dict[str, Any]] = []
        self.budget_remaining: Optional[float] = None
        self.budget_exhausted = False
        # goodput accounting (docs/observability.md §7): per-category span
        # seconds + the earliest run_start for the live wall denominator
        self.span_seconds: Dict[str, float] = {}
        self.first_start_ts: Optional[float] = None
        # serving state (docs/SERVING.md): last-snapshot serve.* counters
        # and gauges + the drain lifecycle events, keyed by the writer's
        # ``replica`` tag ("" = a single un-tagged serve process) so a
        # replica tier renders ONE line per replica
        self.serve_by: Dict[str, Dict[str, Any]] = {}
        # feature surface (docs/observability.md §10): last feature_stats
        # flush summary per scope/replica + flush counts — the features: line
        self.feature_by: Dict[str, Dict[str, Any]] = {}
        # router state (serve/router.py): counters + the live replica-state
        # map from the transition event timeline (per-replica latency
        # gauges are the REPORT's job — the live line stays one-glance)
        self.router_counters: Dict[str, float] = {}
        self.router_states: Dict[str, str] = {}
        self.replica_restarts = 0
        self.swap_events: List[Dict[str, Any]] = []

    # -- ingestion ------------------------------------------------------------

    def poll(self) -> int:
        """Pick up new files + new records; returns the record count."""
        for path in discover_event_files(self.run_dir):
            if path not in self._tails:
                self._tails[path] = EventTail(path)
        n = 0
        for tail in self._tails.values():
            records, malformed = tail.poll()
            self.malformed.extend(malformed)
            for rec in records:
                try:
                    self._ingest(rec)
                except Exception:
                    # valid JSON, impossible fields (ts: null, non-int steps,
                    # …): a bad record must degrade to 'malformed', never
                    # kill the monitor mid-parse
                    self.malformed.append(
                        f"{tail.path.name}: unusable event {str(rec)[:120]}"
                    )
                n += 1
        return n

    @property
    def n_files(self) -> int:
        return len(self._tails)

    def _serve_state(self, rec) -> Dict[str, Any]:
        """Per-replica serve aggregation slot, keyed by the record's
        ``replica`` tag ("" for a plain single-process serve run)."""
        key = str(rec.get("replica") or "")
        if key not in self.serve_by:
            self.serve_by[key] = {
                "counters": {}, "gauges": {}, "draining": False,
                "drained": False,
            }
        return self.serve_by[key]

    def _proc(self, rec) -> _ProcState:
        idx = int(rec.get("process_index", 0))
        if idx not in self.procs:
            self.procs[idx] = _ProcState()
        return self.procs[idx]

    def _ingest(self, rec: Dict[str, Any]):
        self.events_seen += 1
        p = self._proc(rec)
        ts = rec.get("ts")
        if isinstance(ts, (int, float)):
            p.last_ts = max(p.last_ts or 0.0, float(ts))
        kind = rec.get("event")
        if kind == "run_start":
            # the supervisor's own log rides in the same dir: its run_start
            # must not rename the header away from the DRIVER's run name
            name = rec.get("run_name")
            if name and (self.run_name in (None, "supervisor") or name != "supervisor"):
                self.run_name = name
            # a NEW generation appending to the same log (supervised
            # restart after preemption): the process is alive again —
            # without this reset, follow mode would exit at the first
            # generation's run_end and leave the restarted run unwatched
            p.status = "running"
            if rec.get("run_name") != "supervisor" and isinstance(
                ts, (int, float)
            ):
                if self.first_start_ts is None or ts < self.first_start_ts:
                    self.first_start_ts = float(ts)
        elif kind == "span":
            if rec.get("category") is not None and isinstance(
                rec.get("seconds"), (int, float)
            ):
                cat = str(rec["category"])
                self.span_seconds[cat] = (
                    self.span_seconds.get(cat, 0.0) + float(rec["seconds"])
                )
        elif kind == "heartbeat":
            if rec.get("steps") is not None:
                p.steps = int(rec["steps"])
                p.beats = (p.beats + [(float(rec["ts"]), int(rec["steps"]))])[-2:]
                if len(p.beats) == 2 and p.beats[1][0] > p.beats[0][0]:
                    p.steps_per_sec = (p.beats[1][1] - p.beats[0][1]) / (
                        p.beats[1][0] - p.beats[0][0]
                    )
            if rec.get("skew_seconds") is not None:
                self.skew_gauge = float(rec["skew_seconds"])
            if rec.get("clock_offset_seconds") is not None:
                p.clock_offset = float(rec["clock_offset_seconds"])
                p.clock_uncertainty = rec.get("clock_uncertainty_seconds")
        elif kind == "chunk_end":
            p.chunks += 1
            self.chunk_ends.append(rec)
        elif kind == "anomaly":
            self.anomalies.append(rec)
        elif kind == "preempt":
            self.preempts.append(rec)
        elif kind == "resume":
            self.resumes.append(rec)
        elif kind == "restart":
            self.restarts.append(rec)
        elif kind == "chunk_skipped":
            self.chunk_skips.append(rec)
        elif kind == "loss_budget_exhausted":
            self.budget_exhausted = True
        elif kind == "feature_stats":
            scope = str(rec.get("scope", "?"))
            key = scope
            if scope == "serve" and rec.get("replica"):
                key = f"serve[{rec['replica']}]"
            st = self.feature_by.setdefault(key, {"flushes": 0, "last": {}})
            st["flushes"] += 1
            st["last"] = rec
        elif kind == "serve_drain":
            self._serve_state(rec)["draining"] = True
        elif kind == "serve_drained":
            st = self._serve_state(rec)
            st["draining"] = False
            st["drained"] = True
        elif kind == "router_replica_state":
            self.router_states[str(rec.get("replica", "?"))] = str(
                rec.get("to", "?")
            )
        elif kind == "replica_restart":
            self.replica_restarts += 1
        elif kind == "rolling_swap_done":
            self.swap_events.append(rec)
        elif kind == "snapshot":
            counters = rec.get("counters") or {}
            if "train.steps" in counters:
                p.steps = int(counters["train.steps"])
            p.data = {
                k: float(v) for k, v in counters.items() if k.startswith("data.")
            } or p.data
            serve_c = {
                k: float(v) for k, v in counters.items() if k.startswith("serve.")
            }
            if serve_c:
                self._serve_state(rec)["counters"].update(serve_c)
            router_c = {
                k: float(v) for k, v in counters.items()
                if k.startswith("router.")
            }
            if router_c:
                self.router_counters.update(router_c)
            gauges = rec.get("gauges") or {}
            serve_g = {
                k: float(v) for k, v in gauges.items() if k.startswith("serve.")
            }
            if serve_g:
                self._serve_state(rec)["gauges"].update(serve_g)
            if "data.budget_remaining_frac" in gauges:
                self.budget_remaining = float(gauges["data.budget_remaining_frac"])
            if "skew.flush.spread_seconds" in gauges:
                self.skew_gauge = float(gauges["skew.flush.spread_seconds"])
            peaks = [
                v for k, v in gauges.items()
                if k.startswith("hbm.") and k.endswith(".peak_bytes_in_use")
            ]
            if peaks:
                p.hbm_peak = max(peaks)
        elif kind == "run_end":
            p.status = str(rec.get("status", "?"))
            if rec.get("steps") is not None:
                p.steps = int(rec["steps"])
            if rec.get("steps_per_sec") is not None:
                p.steps_per_sec = float(rec["steps_per_sec"])

    # -- derived --------------------------------------------------------------

    @property
    def finished(self) -> bool:
        return bool(self.procs) and all(
            p.status != "running" for p in self.procs.values()
        )

    def worst_chunk_skew(self) -> Optional[Dict[str, Any]]:
        from sparse_coding__tpu_torch.telemetry.multihost import chunk_skew_windows

        windows = chunk_skew_windows(self.chunk_ends)
        if not windows:
            return None
        return max(windows, key=lambda w: w["spread"])


def _age(now: float, ts: Optional[float]) -> str:
    if ts is None:
        return "-"
    dt = now - ts
    if dt < 0:
        return "0s"
    if dt < 120:
        return f"{dt:.1f}s"
    if dt < 7200:
        return f"{dt / 60:.0f}m"
    return f"{dt / 3600:.1f}h"


def fleet_lines(run_dir, now: float) -> List[str]:
    """The fleet view: when the monitored directory holds a fleet
    queue (`fleet.queue.is_fleet_dir`), render per-worker liveness, lease
    ages, and the member ledger — done/running/orphaned/queued/**lost** —
    from the queue files themselves (no events needed, so a fleet whose
    scheduler died still renders). Empty list for ordinary run dirs."""
    from sparse_coding__tpu_torch.fleet.queue import WorkQueue, is_fleet_dir

    if not is_fleet_dir(run_dir):
        return []
    st = WorkQueue(run_dir, create=False).state(now=now)
    c, m = st["item_counts"], st["members"]
    lines = [
        f"  fleet: items {c['done']} done / {c['leased']} leased / "
        f"{c['pending']} pending / {c['failed']} failed | members "
        f"{m['done']} done / {m['running']} running / {m['orphaned']} orphaned"
        f" / {m['queued']} queued / {m['lost']} lost"
        + ("  ⚠ LOST MEMBERS" if m["lost"] else "")
    ]
    by_worker = {l.get("worker"): l for l in st["leases"].values()}
    bits = []
    for w in st["workers"]:
        wid = w.get("worker", "?")
        if w.get("quarantined"):
            bits.append(f"{wid} QUARANTINED ({w.get('strikes', 0)} strikes)")
            continue
        lease = by_worker.get(wid)
        if lease is not None:
            age = now - float(lease.get("renewed_ts", now))
            left = float(lease.get("expires_ts", now)) - now
            state = (
                f"lease {lease.get('item', '?')} (age {age:.1f}s, "
                + (f"expires in {left:.1f}s)" if left > 0 else "EXPIRED)")
            )
            bits.append(f"{wid} {state}")
        else:
            bits.append(f"{wid} idle {_age(now, w.get('last_seen_ts'))}")
    if bits:
        lines.append("  workers: " + "; ".join(bits))
    return lines


def render(mon: RunMonitor, now: Optional[float] = None) -> str:
    """One status block (plain text, terminal-friendly, no cursor games)."""
    now = time.time() if now is None else now
    lines = [
        f"run {mon.run_name or mon.run_dir} — {len(mon.procs)} process(es), "
        f"{mon.n_files} event file(s), {time.strftime('%H:%M:%S', time.localtime(now))}"
    ]
    if not mon.procs:
        lines.append("  (no events yet)")
        lines.extend(fleet_lines(mon.run_dir, now))
        return "\n".join(lines)
    for idx in sorted(mon.procs):
        p = mon.procs[idx]
        # `is not None`: a genuine 0.0 steps/s IS the stalled-host signal
        rate = (
            f"{p.steps_per_sec:.1f} steps/s" if p.steps_per_sec is not None else "-"
        )
        steps = p.steps if p.steps is not None else "-"
        hbm = f"  hbm peak {_bytes(p.hbm_peak)}" if p.hbm_peak is not None else ""
        lines.append(
            f"  p{idx}  steps {steps}  {rate}  chunks {p.chunks}  "
            f"status {p.status}  last event {_age(now, p.last_ts)} ago{hbm}"
        )
    skew_bits = []
    if mon.skew_gauge is not None:
        skew_bits.append(f"flush spread {mon.skew_gauge:.3f} s (gauge)")
    worst = mon.worst_chunk_skew()
    if worst is not None:
        skew_bits.append(f"worst chunk window {worst['spread']:.3f} s")
    if skew_bits:
        lines.append("  skew: " + " | ".join(skew_bits))
    offsets = [
        f"p{idx} {p.clock_offset:+.3f} s"
        + (f" (±{p.clock_uncertainty:.3f})" if p.clock_uncertainty is not None else "")
        for idx, p in sorted(mon.procs.items())
        if p.clock_offset is not None
    ]
    if offsets:
        lines.append("  clock offsets: " + ", ".join(offsets))
    # data-plane integrity line (docs/DATAPLANE.md): summed last-snapshot
    # counters, live skip events, remaining budget — only when the run has
    # any data-integrity activity (ordinary output is a stability contract)
    data: Dict[str, float] = {}
    for p in mon.procs.values():
        for k, v in p.data.items():
            data[k] = data.get(k, 0.0) + v
    n_skips = max(int(data.get("data.chunks_skipped", 0)), len(mon.chunk_skips))
    n_corrupt = max(
        int(data.get("data.corrupt", 0)),
        sum(1 for a in mon.anomalies if a.get("kind") == "chunk_corrupt"),
    )
    if data or n_skips or n_corrupt or mon.budget_exhausted:
        bits = [f"chunks {int(data.get('data.chunks_verified', 0))} verified"]
        bits.append(f"{n_corrupt} quarantined")
        bits.append(
            f"{n_skips} skipped"
            + (
                f" ({int(data['data.rows_skipped'])} rows)"
                if data.get("data.rows_skipped")
                else ""
            )
        )
        line = "  data: " + " / ".join(bits)
        if mon.budget_exhausted:
            line += " | budget EXHAUSTED (exit 75 — scrub/repair the store)"
        elif mon.budget_remaining is not None:
            line += f" | budget {100 * mon.budget_remaining:.1f}% remaining"
        lines.append(line)
    # serving lines (docs/SERVING.md): last-snapshot serve.* counters/gauges
    # + the drain lifecycle, one line per replica tag — only for runs that
    # served (stability contract; a plain serve run keeps the old layout)
    for key in sorted(mon.serve_by):
        st = mon.serve_by[key]
        c, g = st["counters"], st["gauges"]
        if not (c or g or st["draining"] or st["drained"]):
            continue
        bits = [
            f"{int(c.get('serve.requests', 0))} req "
            f"({int(c.get('serve.rows', 0))} rows, "
            f"{int(c.get('serve.batches', 0))} batches)"
        ]
        if g.get("serve.latency_p50_ms") is not None:
            bits.append(
                f"p50 {g['serve.latency_p50_ms']:.1f}ms "
                f"p95 {g.get('serve.latency_p95_ms', 0):.1f}ms "
                f"p99 {g.get('serve.latency_p99_ms', 0):.1f}ms"
            )
        if g.get("serve.queue_depth") is not None:
            bits.append(f"queue {int(g['serve.queue_depth'])}")
        if g.get("serve.batch_occupancy") is not None:
            bits.append(f"occupancy {100 * g['serve.batch_occupancy']:.0f}%")
        rej, err = int(c.get("serve.rejected", 0)), int(c.get("serve.errors", 0))
        if rej or err:
            bits.append(f"{rej} rejected / {err} errors")
        label = "serve" if not key else f"serve[{key}]"
        line = f"  {label}: " + " | ".join(bits)
        if st["draining"]:
            line += " | DRAINING"
        elif st["drained"]:
            line += " | drained clean"
        lines.append(line)
    # feature surface line (docs/observability.md §10): the last flushed
    # window's dictionary health per scope/replica — dead fraction, firing
    # Gini, and the train↔serve drift score with its PSI band
    if mon.feature_by:
        from sparse_coding__tpu_torch.telemetry.feature_stats import drift_band

        bits = []
        for key in sorted(mon.feature_by):
            st = mon.feature_by[key]
            last = st["last"]
            piece = key
            dead = last.get("dead_frac")
            if isinstance(dead, (int, float)) and dead == dead:
                piece += f" dead {100 * dead:.1f}%"
            gini = last.get("gini")
            if isinstance(gini, (int, float)) and gini == gini:
                piece += f" gini {gini:.3f}"
            score = last.get("drift_score")
            if isinstance(score, (int, float)):
                piece += f" drift {score:.2f} [{drift_band(score).upper()}]"
            piece += f" ({st['flushes']} flush(es), {last.get('gen', '?')})"
            bits.append(piece)
        lines.append("  features: " + " | ".join(bits))
    # router line (serve/router.py): routed totals + the live replica-state
    # map — the replica tier's one-glance health view
    if mon.router_counters or mon.router_states:
        c = mon.router_counters
        bits = [
            f"{int(c.get('router.requests', 0))} req "
            f"({int(c.get('router.ok', 0))} ok, "
            f"{int(c.get('router.retried_ok', 0))} retried-ok)"
        ]
        bits.append(
            f"{int(c.get('router.retries', 0))} retries / "
            f"{int(c.get('router.hedges', 0))} hedges / "
            f"{int(c.get('router.sheds', 0))} shed / "
            f"{int(c.get('router.failed', 0))} failed"
        )
        if mon.router_states:
            bits.append(
                "replicas: "
                + ", ".join(
                    f"{rid} {state}"
                    for rid, state in sorted(mon.router_states.items())
                )
            )
        line = "  router: " + " | ".join(bits)
        dead = sum(1 for s in mon.router_states.values() if s == "dead")
        if dead:
            line += f"  ⚠ {dead} DEAD"
        lines.append(line)
        if mon.replica_restarts or mon.swap_events:
            bits = []
            if mon.replica_restarts:
                bits.append(f"{mon.replica_restarts} replica restart(s)")
            for s in mon.swap_events:
                bits.append(
                    f"rolled to gen {s.get('generation', '?')} "
                    f"in {s.get('seconds', '?')}s"
                )
            lines.append("  replicaset: " + ", ".join(bits))
    # live goodput line (docs/observability.md §7): per-category span
    # seconds vs the wall elapsed since the earliest run_start — the full
    # ledger (generation gaps, supervisor backoff) is the timeline CLI's job
    if mon.span_seconds:
        from sparse_coding__tpu_torch.telemetry.spans import (
            GOODPUT_CATEGORIES,
            INNER_CATEGORIES,
        )

        last = max((p.last_ts or 0.0) for p in mon.procs.values())
        elapsed = (
            last - mon.first_start_ts
            if mon.first_start_ts is not None and last > mon.first_start_ts
            else None
        )
        # inner-category spans (checkpoint/preempt_drain inside a step
        # window — big_batch's shape) ride INSIDE step spans: subtract them
        # so the live % tracks the ledger's innermost-wins attribution
        # (approximate — may under-report when such spans fall outside
        # step windows; the offline ledger is exact)
        step = max(
            0.0,
            sum(mon.span_seconds.get(c, 0.0) for c in GOODPUT_CATEGORIES)
            - sum(mon.span_seconds.get(c, 0.0) for c in INNER_CATEGORIES),
        )
        pct = (
            f"{min(100.0, 100.0 * step / elapsed):.1f}%"
            if elapsed
            else "n/a"
        )
        cats = " | ".join(
            f"{c} {s:.1f}s"
            for c, s in sorted(mon.span_seconds.items(), key=lambda kv: -kv[1])
        )
        lines.append(f"  goodput: {pct} — {cats}")
    if mon.preempts or mon.resumes or mon.restarts:
        bits = []
        if mon.preempts:
            last = mon.preempts[-1]
            bits.append(
                f"{len(mon.preempts)} preempt(s) (last cursor "
                f"{last.get('cursor', '?')})"
            )
        if mon.restarts:
            bits.append(f"{len(mon.restarts)} restart(s)")
        if mon.resumes:
            bits.append(f"{len(mon.resumes)} resume(s)")
        lines.append("  recovery: " + ", ".join(bits))
    desync = [a for a in mon.anomalies if a.get("kind") == "desync"]
    if mon.anomalies:
        recent = mon.anomalies[-3:]
        described = ", ".join(
            f"{a.get('kind', '?')}@p{a.get('process_index', 0)}"
            + (f" step {a['step']}" if a.get("step") is not None else "")
            for a in recent
        )
        lines.append(
            f"  anomalies: {len(mon.anomalies)} — {described}"
            f" | desync: {'YES' if desync else 'none'}"
        )
    else:
        lines.append("  anomalies: none | desync: none")
    lines.extend(fleet_lines(mon.run_dir, now))
    if mon.malformed:
        lines.append(
            f"  MALFORMED event lines: {len(mon.malformed)} "
            f"(first: {mon.malformed[0]})"
        )
    return "\n".join(lines)


def _scrape_tier_lines(urls: List[str], timeout: float = 3.0) -> List[str]:
    """The ``--scrape`` view: one line per live ``/metrics``
    endpoint (serve and router tiers auto-detected from the families) plus
    a tier-wide merged totals line. Unreachable endpoints render as DOWN
    instead of killing the monitor — a dead replica is exactly what the
    operator is here to see."""
    from sparse_coding__tpu_torch.telemetry import metrics_http as mh

    lines: List[str] = []
    tot_req = tot_rows = 0.0
    merged_hist: Optional[Dict[str, Any]] = None
    for url in urls:
        try:
            fams = mh.scrape(url, timeout=timeout)
        except Exception as e:
            lines.append(f"  {url}: DOWN ({type(e).__name__})")
            continue
        serve_req = mh.family_value(fams, "serve.requests", "_total")
        router_req = mh.family_value(fams, "router.requests", "_total")
        if router_req is not None:
            bits = [
                f"{int(router_req)} req routed "
                f"({int(mh.family_value(fams, 'router.ok', '_total', 0) or 0)} ok, "
                f"{int(mh.family_value(fams, 'router.retried_ok', '_total', 0) or 0)} retried-ok)",
                f"{int(mh.family_value(fams, 'router.sheds', '_total', 0) or 0)} shed / "
                f"{int(mh.family_value(fams, 'router.failed', '_total', 0) or 0)} failed",
            ]
            live = mh.family_value(fams, "router.live_replicas")
            n = mh.family_value(fams, "router.replicas")
            if live is not None and n is not None:
                bits.append(f"replicas {int(live)}/{int(n)} live")
            lines.append(f"  {url} [router]: " + " | ".join(bits))
            continue
        if serve_req is not None:
            rows = mh.family_value(fams, "serve.rows", "_total", 0) or 0
            tot_req += serve_req
            tot_rows += rows
            bits = [f"{int(serve_req)} req ({int(rows)} rows)"]
            hist = mh.histogram_from_families(fams, "serve.latency_ms")
            if hist and hist["count"]:
                p50 = mh.histogram_quantile(hist, 0.50)
                p99 = mh.histogram_quantile(hist, 0.99)
                bits.append(f"p50 ≤{p50:g}ms p99 ≤{p99:g}ms")
                if merged_hist is None:
                    merged_hist = hist
                elif merged_hist["bounds"] == hist["bounds"]:
                    merged_hist["cumulative"] = [
                        a + b for a, b in
                        zip(merged_hist["cumulative"], hist["cumulative"])
                    ]
                    merged_hist["count"] += hist["count"]
            depth = mh.family_value(fams, "serve.queue_depth")
            if depth is not None:
                bits.append(f"queue {int(depth)}")
            occ = mh.family_value(fams, "serve.batch_occupancy")
            if occ is not None:
                bits.append(f"occupancy {100 * occ:.0f}%")
            draining = mh.family_value(fams, "serve.draining")
            if draining:
                bits.append("DRAINING")
            lines.append(f"  {url}: " + " | ".join(bits))
            continue
        lines.append(f"  {url}: up ({len(fams)} familie(s), no serve/router "
                     "series)")
    if tot_req:
        bits = [f"{int(tot_req)} req ({int(tot_rows)} rows) across the tier"]
        if merged_hist is not None and merged_hist["count"]:
            p99 = mh.histogram_quantile(merged_hist, 0.99)
            bits.append(f"merged p99 ≤{p99:g}ms")
        lines.append("  tier: " + " | ".join(bits))
    return lines


def scrape_render(urls: List[str], now: Optional[float] = None,
                  timeout: float = 3.0) -> str:
    now = time.time() if now is None else now
    lines = [
        f"scrape — {len(urls)} endpoint(s), "
        f"{time.strftime('%H:%M:%S', time.localtime(now))}"
    ]
    lines.extend(_scrape_tier_lines(urls, timeout=timeout))
    return "\n".join(lines)


class TowerView:
    """The ``--tower`` view: ONE aggregated pool snapshot from a
    control tower's ``state.json`` — per-target lines, fleet capacity,
    training goodput, and the firing alerts — instead of N ``--scrape``
    endpoints each carrying no history. ``src`` is a dashboard URL
    (``http://host:port`` → ``/state.json``) or a tower state dir.

    Stateful on purpose: an unreachable tower renders DOWN with the age
    of the last state it DID serve, and a state file whose ``ts`` has
    fallen more than 3 poll intervals behind renders DOWN (stale) — a
    dead tower leaves its last ``state.json`` on disk, and showing it as
    live would be lying about the whole pool at once."""

    def __init__(self, src, timeout: float = 3.0):
        self.src = str(src)
        self.timeout = timeout
        self.last_state: Optional[Dict[str, Any]] = None
        self.last_ok_ts: Optional[float] = None

    def fetch(self) -> Dict[str, Any]:
        if self.src.startswith(("http://", "https://")):
            from urllib.request import urlopen

            url = self.src.rstrip("/") + "/state.json"
            with urlopen(url, timeout=self.timeout) as r:
                state = json.loads(r.read().decode("utf-8"))
        else:
            state = json.loads((Path(self.src) / "state.json").read_text())
        if not isinstance(state, dict):
            raise ValueError("tower state is not a JSON object")
        return state

    def render(self, now: Optional[float] = None) -> str:
        now = time.time() if now is None else now
        try:
            state = self.fetch()
        except Exception as e:
            seen = (
                f"last seen {_age(now, self.last_ok_ts)} ago"
                if self.last_ok_ts is not None else "never seen"
            )
            return f"tower {self.src}: DOWN ({type(e).__name__}) — {seen}"
        ts = state.get("ts")
        interval = float(state.get("interval_seconds") or 5.0)
        stale = (
            isinstance(ts, (int, float)) and now - ts > 3.0 * interval
        )
        if not stale:
            self.last_state, self.last_ok_ts = state, now
        lines = [
            f"tower {self.src}: "
            + (f"DOWN (stale) — last poll {_age(now, ts)} ago" if stale
               else f"{state.get('polls', 0)} poll(s), every {interval:g}s, "
                    f"last {_age(now, ts)} ago")
        ]
        targets = state.get("targets") or {}
        up = sum(1 for t in targets.values() if t.get("up"))
        if targets:
            lines.append(f"  targets: {up}/{len(targets)} up")
        for label in sorted(targets):
            t = targets[label]
            if not t.get("up"):
                lines.append(f"  {label}: DOWN ({t.get('error', '?')})")
                continue
            bits = ["up"]
            if t.get("requests_in_window") is not None:
                bits.append(f"{t['requests_in_window']:g} req (window)")
            if t.get("error_frac_in_window"):
                bits.append(f"{100 * t['error_frac_in_window']:.2f}% err")
            if t.get("latency_p99_ms_in_window") is not None:
                bits.append(f"p99 ≤{t['latency_p99_ms_in_window']:g}ms")
            if t.get("queue_depth") is not None:
                bits.append(f"queue {int(t['queue_depth'])}")
            kind = t.get("kind", "up")
            tag = f" [{kind}]" if kind not in ("up", "serve") else ""
            lines.append(f"  {label}{tag}: " + " | ".join(bits))
        router = state.get("router")
        if router:
            lines.append(
                f"  router: {int(router.get('live_replicas', 0))}/"
                f"{int(router.get('replicas', 0))} replicas live"
            )
        fleet = state.get("fleet")
        if fleet:
            lines.append(
                f"  fleet: {int(fleet.get('idle_workers', 0))} idle / "
                f"{int(fleet.get('busy_workers', 0))} busy workers | "
                f"{int(fleet.get('pending_items', 0))} pending item(s)"
            )
        train = state.get("train")
        if train and train.get("goodput_frac") is not None:
            lines.append(
                f"  train: goodput {100 * train['goodput_frac']:.1f}%"
            )
        alerts = state.get("alerts") or []
        active = [a for a in alerts if a.get("state") != "inactive"]
        if active:
            bits = []
            for a in active:
                word = (
                    a["state"].upper() if a["state"] == "firing"
                    else a["state"]
                )
                bits.append(
                    f"{a.get('rule', '?')} {word} "
                    f"(for {_age(now, a.get('since'))})"
                )
            lines.append("  alerts: " + " | ".join(bits))
        elif alerts:
            lines.append(f"  alerts: {len(alerts)} rule(s), none active")
        return "\n".join(lines)


def tower_render(src, now: Optional[float] = None,
                 timeout: float = 3.0) -> str:
    """One-shot ``--tower`` render (stateless — follow mode keeps a
    `TowerView` so DOWN can carry a last-seen age)."""
    return TowerView(src, timeout=timeout).render(now=now)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparse_coding__tpu_torch.monitor", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("run_dir", nargs="?", default=None,
                    help="directory holding events JSONL file(s) "
                    "(omit with --scrape)")
    ap.add_argument(
        "--once", action="store_true",
        help="render one snapshot and exit (nonzero on malformed event lines)",
    )
    ap.add_argument(
        "--interval", type=float, default=5.0,
        help="refresh period in seconds (follow mode; default 5)",
    )
    ap.add_argument(
        "--refreshes", type=int, default=0,
        help="stop after N refreshes (0 = until every process writes run_end)",
    )
    ap.add_argument(
        "--scrape", nargs="+", default=None, metavar="URL",
        help="render live tiers from /metrics endpoints (serve servers, "
        "routers) instead of tailing a run dir's files",
    )
    ap.add_argument(
        "--tower", default=None, metavar="URL|DIR",
        help="render ONE aggregated pool view from a control tower "
        "(dashboard URL or tower state dir) instead of N --scrape "
        "endpoints",
    )
    args = ap.parse_args(argv)

    if args.tower:
        if args.run_dir is not None or args.scrape:
            ap.error("--tower replaces the run_dir/--scrape — pass one source")
        view = TowerView(args.tower)
        refreshes = 0
        try:
            while True:
                print(view.render())
                refreshes += 1
                if args.once or (args.refreshes and refreshes >= args.refreshes):
                    return 0
                print()
                time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0
    if args.scrape:
        if args.run_dir is not None:
            ap.error("--scrape replaces the run_dir — pass one or the other")
        refreshes = 0
        try:
            while True:
                print(scrape_render(args.scrape))
                refreshes += 1
                if args.once or (args.refreshes and refreshes >= args.refreshes):
                    return 0
                print()
                time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0
    if args.run_dir is None:
        ap.error("need a run_dir (or --scrape URL... / --tower URL|DIR)")
    mon = RunMonitor(args.run_dir)

    if args.once:
        mon.poll()
        print(render(mon))
        if mon.malformed:
            import sys

            for line in mon.malformed:
                print(f"malformed event line: {line}", file=sys.stderr)
            return 1
        return 0

    refreshes = 0
    try:
        while True:
            mon.poll()
            print(render(mon))
            print()
            refreshes += 1
            if mon.finished:
                print("all processes wrote run_end — done")
                return 0
            if args.refreshes and refreshes >= args.refreshes:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
