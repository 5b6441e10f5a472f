"""Control tower: pool-wide time-series aggregation, alerting, incidents.

Every prior observability layer watches ONE surface: `monitor` tails one
run dir, ``--scrape`` reads the instantaneous ``/metrics`` of N endpoints,
`slo` evaluates one source and must report ``burn_rates=None`` on live
tiers because a single scrape carries no history. The tower is the first
layer that sees the whole estate at once — and *remembers* it:

  - **collect** — ``python -m sparse_coding__tpu_torch.tower run DIR`` scrapes
    every ``/metrics`` endpoint (static ``tower.json`` targets plus
    replicaset ``replica*/port`` files, re-discovered every poll so
    restarts and rolling swaps are followed automatically), aggregates
    fleet worker ``.prom`` files + queue state, and tails registered run
    dirs' ``events*.jsonl`` — into a `SeriesStore`: an in-memory
    ring-buffer time-series store with a full-rate *fine* tier and a
    downsampled *coarse* tier under a fixed retention horizon. Every poll
    appends one snapshot line to ``DIR/series.jsonl`` so the store (and
    therefore every burn-rate window) is rebuildable by replay
    (`load_store`).
  - **alert** — declarative rules (``alerts.json``) reuse the `slo.py`
    objective schema verbatim, but each rule is evaluated over tower
    *history* (`slo.evaluate_series`), so fast/slow burn windows are real
    on live tiers. Rules carry ``for_seconds`` hysteresis and walk a
    pending→firing→resolved state machine; every transition is appended
    to ``DIR/alerts.jsonl`` and optionally handed to a webhook command.
  - **correlate** — the pending→firing edge snapshots an incident record
    ``DIR/incidents/INC-NNNN.json``: which replicas the router holds
    dead, the recent replica state transitions, recent anomalies, the
    slowest correlated ``request_trace`` ids, the full SLO verdict over
    tower history, training goodput, and the pool state — everything the
    on-call (or the autoscaler post-mortem) needs in one file. ``tower
    report DIR`` renders them; ``tower check DIR`` is the exit-coded CI
    gate (1 while any alert fires, 0 clean, 3 no data).
  - **serve** — a zero-dependency live dashboard (``--http PORT``: one
    embedded HTML page polling ``/state.json``) plus `Tower.pool_state()`
    — the one structured snapshot (per-target latency/queue burn rates,
    fleet idle capacity, training goodput floor) documented in
    docs/observability.md §11 as the sensor contract an
    autoscaler consumes.

Stdlib only — the tower must run on a bastion host with nothing
installed. Each poll cycle is wrapped in a ``tower_poll`` badput span on
the tower's own telemetry (``DIR/tower_events.jsonl``), so the watcher
is itself watchable.

Counterpart of `sparse_coding__tpu/telemetry/tower.py`, copied: it scrapes
the port's replicas and routers (`telemetry.metrics_http`), reads a fleet
dir's queue state through the port's `fleet.queue`, and lists an incident's
tainted lineage from the port's provenance graph.
"""

from __future__ import annotations

import bisect
import json
import os
import subprocess
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "SeriesStore",
    "AlertRule",
    "AlertManager",
    "Tower",
    "load_store",
    "read_series",
    "replay_alert_states",
    "tower_check",
    "render_tower_report",
    "main",
]

# per-target series are namespaced "<label>::<key>" in the store; merged
# (pool-wide) series use the bare key — `slo.evaluate_series` reads only
# the merged namespace
TARGET_SEP = "::"

DEFAULT_RETENTION_SECONDS = 6 * 3600.0
DEFAULT_FINE_SECONDS = 900.0
DEFAULT_BUCKET_SECONDS = 60.0


def _num(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) and v == v else None


# -- the time-series store ----------------------------------------------------


class SeriesStore:
    """Two-tier ring-buffer time-series store.

    Points land in a full-rate **fine** tier (kept ``fine_seconds``) and
    simultaneously fold into **coarse** buckets of ``bucket_seconds``
    width (kept ``retention_seconds``) holding ``(bucket_ts, last, min,
    max, n)`` — so a 6 h retention at a 5 s poll interval costs ~360
    coarse points per key instead of ~4300, while the recent window the
    fast-burn math reads stays exact. Histograms keep their full samples
    over the fine horizon, then thin to the last sample per coarse bucket
    (cumulative counters: last-per-bucket loses nothing a windowed delta
    needs).

    Three key namespaces — counters, gauges, histograms — so a replayed
    store can hand `slo.evaluate_series` exactly the maps the other
    evaluators build.
    """

    def __init__(
        self,
        retention_seconds: float = DEFAULT_RETENTION_SECONDS,
        fine_seconds: float = DEFAULT_FINE_SECONDS,
        bucket_seconds: float = DEFAULT_BUCKET_SECONDS,
    ):
        self.retention_seconds = float(retention_seconds)
        self.fine_seconds = min(float(fine_seconds), self.retention_seconds)
        self.bucket_seconds = float(bucket_seconds)
        # (kind, key) -> {"fine": [(ts, v)...], "coarse": [[t0, last, mn, mx, n]...]}
        self._points: Dict[Tuple[str, str], Dict[str, list]] = {}
        # key -> [(ts, hist)...]  — telemetry-format hists ({"bounds",
        # "counts" per-bucket + overflow, "sum", "count"})
        self._hists: Dict[str, List[Tuple[float, Dict[str, Any]]]] = {}
        self._t_min: Optional[float] = None
        self._t_max: Optional[float] = None

    # -- write ----------------------------------------------------------------

    def record(self, kind: str, key: str, ts: float, value: float) -> None:
        if kind not in ("counter", "gauge"):
            raise ValueError(f"kind must be counter|gauge, got {kind!r}")
        ts, value = float(ts), float(value)
        slot = self._points.setdefault((kind, key), {"fine": [], "coarse": []})
        slot["fine"].append((ts, value))
        coarse = slot["coarse"]
        t0 = ts - (ts % self.bucket_seconds)
        if coarse and coarse[-1][0] == t0:
            b = coarse[-1]
            b[1] = value
            b[2] = min(b[2], value)
            b[3] = max(b[3], value)
            b[4] += 1
        else:
            coarse.append([t0, value, value, value, 1])
        self._t_min = ts if self._t_min is None else min(self._t_min, ts)
        self._t_max = ts if self._t_max is None else max(self._t_max, ts)
        self._prune(slot)

    def record_hist(self, key: str, ts: float, hist: Dict[str, Any]) -> None:
        ts = float(ts)
        samples = self._hists.setdefault(key, [])
        samples.append((ts, {
            "bounds": list(hist["bounds"]),
            "counts": [float(c) for c in hist["counts"]],
            "sum": float(hist.get("sum", 0.0)),
            "count": float(hist.get("count", sum(hist["counts"]))),
        }))
        self._t_min = ts if self._t_min is None else min(self._t_min, ts)
        self._t_max = ts if self._t_max is None else max(self._t_max, ts)
        self._prune_hists(samples)

    def ingest(self, rec: Dict[str, Any]) -> None:
        """One ``series.jsonl`` poll record back into the store (replay)."""
        ts = _num(rec.get("ts"))
        if ts is None:
            return
        for k, v in (rec.get("counters") or {}).items():
            v = _num(v)
            if v is not None:
                self.record("counter", k, ts, v)
        for k, v in (rec.get("gauges") or {}).items():
            v = _num(v)
            if v is not None:
                self.record("gauge", k, ts, v)
        for k, h in (rec.get("hists") or {}).items():
            if isinstance(h, dict) and h.get("bounds") is not None:
                self.record_hist(k, ts, h)

    def _prune(self, slot: Dict[str, list]) -> None:
        horizon = self._t_max
        if horizon is None:
            return
        fine = slot["fine"]
        cut = horizon - self.fine_seconds
        i = bisect.bisect_left(fine, (cut, float("-inf")))
        if i > 0:
            del fine[:i]
        coarse = slot["coarse"]
        cut = horizon - self.retention_seconds
        j = 0
        while j < len(coarse) and coarse[j][0] + self.bucket_seconds <= cut:
            j += 1
        if j > 0:
            del coarse[:j]

    def _prune_hists(self, samples: List[Tuple[float, Dict[str, Any]]]) -> None:
        horizon = self._t_max
        if horizon is None:
            return
        cut = horizon - self.retention_seconds
        while samples and samples[0][0] < cut:
            samples.pop(0)
        # thin samples older than the fine horizon to last-per-bucket
        fine_cut = horizon - self.fine_seconds
        out: List[Tuple[float, Dict[str, Any]]] = []
        last_bucket = None
        for ts, h in samples:
            if ts >= fine_cut:
                out.append((ts, h))
                continue
            b = ts - (ts % self.bucket_seconds)
            if last_bucket is not None and b == last_bucket and out:
                out[-1] = (ts, h)  # cumulative: keep the latest per bucket
            else:
                out.append((ts, h))
            last_bucket = b
        samples[:] = out

    # -- read -----------------------------------------------------------------

    def keys(self, kind: Optional[str] = None) -> List[str]:
        if kind is None:
            ks = {k for _, k in self._points} | set(self._hists)
        elif kind == "hist":
            ks = set(self._hists)
        else:
            ks = {k for kd, k in self._points if kd == kind}
        return sorted(ks)

    def n_keys(self) -> int:
        return len({k for _, k in self._points} | set(self._hists))

    def span(self) -> Optional[Tuple[float, float]]:
        if self._t_min is None:
            return None
        return (self._t_min, self._t_max)

    def latest(self, kind: str, key: str) -> Optional[Tuple[float, float]]:
        slot = self._points.get((kind, key))
        if not slot:
            return None
        if slot["fine"]:
            return slot["fine"][-1]
        if slot["coarse"]:
            b = slot["coarse"][-1]
            return (b[0], b[1])
        return None

    def value_at(self, kind: str, key: str, t: float) -> Optional[float]:
        """Latest recorded value at-or-before ``t`` (fine first, then the
        last coarse bucket wholly before ``t``)."""
        slot = self._points.get((kind, key))
        if not slot:
            return None
        fine = slot["fine"]
        i = bisect.bisect_right(fine, (t, float("inf")))
        if i > 0:
            return fine[i - 1][1]
        best = None
        for b in slot["coarse"]:
            if b[0] + self.bucket_seconds <= t:
                best = b[1]
            else:
                break
        return best

    def counter_at(self, key: str, t: float) -> float:
        """Cumulative counter at ``t`` — 0.0 baseline when no sample is old
        enough (same honest-baseline convention as `slo._counter_at`)."""
        v = self.value_at("counter", key, t)
        return 0.0 if v is None else v

    def window_delta(self, key: str, t0: float, t1: float) -> float:
        return self.counter_at(key, t1) - self.counter_at(key, t0)

    def series(self, kind: str, key: str,
               since: Optional[float] = None) -> List[Tuple[float, float]]:
        """Merged (ts, value) points: coarse buckets older than the fine
        horizon, then the full-rate fine points."""
        slot = self._points.get((kind, key))
        if not slot:
            return []
        fine = slot["fine"]
        fine_t0 = fine[0][0] if fine else float("inf")
        out: List[Tuple[float, float]] = [
            (b[0], b[1]) for b in slot["coarse"] if b[0] < fine_t0
        ]
        out.extend(fine)
        if since is not None:
            out = [p for p in out if p[0] >= since]
        return out

    def counters_latest(self) -> Dict[str, float]:
        return {
            k: self.latest("counter", k)[1] for k in self.keys("counter")
        }

    def gauges_latest(self) -> Dict[str, float]:
        return {k: self.latest("gauge", k)[1] for k in self.keys("gauge")}

    def hists_latest(self) -> Dict[str, Dict[str, Any]]:
        return {
            k: samples[-1][1]
            for k, samples in self._hists.items() if samples
        }

    def hist_span(self, key: str) -> Optional[Tuple[float, float]]:
        samples = self._hists.get(key)
        if not samples:
            return None
        return (samples[0][0], samples[-1][0])

    def hist_at(self, key: str, t: float) -> Optional[Dict[str, Any]]:
        samples = self._hists.get(key)
        if not samples:
            return None
        best = None
        for ts, h in samples:
            if ts <= t:
                best = h
            else:
                break
        return best

    def hist_delta(self, key: str, t0: float,
                   t1: float) -> Optional[Dict[str, Any]]:
        """Bucket-wise windowed histogram ``h(t1) - h(t0)`` (zero baseline
        when no sample is old enough — the window's delta is then the
        whole recorded history, the same convention counters use). None
        when the key has no sample at-or-before ``t1``."""
        h1 = self.hist_at(key, t1)
        if h1 is None:
            return None
        h0 = self.hist_at(key, t0)
        if h0 is None or list(h0["bounds"]) != list(h1["bounds"]):
            h0 = {"bounds": h1["bounds"],
                  "counts": [0.0] * len(h1["counts"]),
                  "sum": 0.0, "count": 0.0}
        return {
            "bounds": list(h1["bounds"]),
            "counts": [a - b for a, b in zip(h1["counts"], h0["counts"])],
            "sum": h1["sum"] - h0["sum"],
            "count": h1["count"] - h0["count"],
        }


# -- persistence --------------------------------------------------------------


def read_series(tower_dir) -> List[Dict[str, Any]]:
    """All poll records from ``series.jsonl`` (torn tail lines skipped —
    the tower may be mid-append)."""
    path = Path(tower_dir) / "series.jsonl"
    out: List[Dict[str, Any]] = []
    if not path.is_file():
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


def load_store(tower_dir, retention_seconds: Optional[float] = None,
               fine_seconds: Optional[float] = None,
               bucket_seconds: Optional[float] = None) -> SeriesStore:
    """Rebuild a `SeriesStore` by replaying ``DIR/series.jsonl``."""
    store = SeriesStore(
        retention_seconds=retention_seconds or DEFAULT_RETENTION_SECONDS,
        fine_seconds=fine_seconds or DEFAULT_FINE_SECONDS,
        bucket_seconds=bucket_seconds or DEFAULT_BUCKET_SECONDS,
    )
    for rec in read_series(tower_dir):
        store.ingest(rec)
    return store


# -- alert rules + state machine ----------------------------------------------


class AlertRule:
    """One declarative rule: an `slo.py` objective plus ``for_seconds``
    hysteresis and a severity tag."""

    def __init__(self, spec: Dict[str, Any]):
        if "objective" not in spec or not isinstance(spec["objective"], dict):
            raise ValueError(f"alert rule needs an 'objective' dict: {spec}")
        self.objective = dict(spec["objective"])
        self.name = str(
            spec.get("name", self.objective.get("name",
                                                self.objective.get("type")))
        )
        self.for_seconds = float(spec.get("for_seconds", 0.0))
        self.severity = str(spec.get("severity", "page"))

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "for_seconds": self.for_seconds,
                "severity": self.severity, "objective": self.objective}


def load_rules(src) -> Dict[str, Any]:
    """``alerts.json`` (path or dict) → ``{"windows", "rules", "webhook"}``.

    Schema (docs/observability.md §11)::

        {"windows": {"fast_burn_seconds": 300, "slow_burn_seconds": 3600},
         "webhook": ["notify-cmd", "--flag"],
         "rules": [
           {"name": "replicas-live", "for_seconds": 2.0, "severity": "page",
            "objective": {"type": "gauge_min",
                          "gauge": "router.live_replicas", "min_value": 2}},
           {"name": "availability", "for_seconds": 5.0,
            "objective": {"type": "availability", "target": 0.999}}]}
    """
    from sparse_coding__tpu_torch.telemetry.slo import DEFAULT_WINDOWS

    cfg = src if isinstance(src, dict) else json.load(open(src))
    if not isinstance(cfg.get("rules"), list):
        raise ValueError("alert config needs a 'rules' list")
    return {
        "windows": {**DEFAULT_WINDOWS, **(cfg.get("windows") or {})},
        "rules": [AlertRule(r) for r in cfg["rules"]],
        "webhook": cfg.get("webhook"),
    }


class AlertManager:
    """The pending→firing→resolved state machine over a rule set.

    ``evaluate(store, now)`` re-evaluates every rule's objective over the
    store's history; a failing objective (``ok is False``) is a *breach*.
    A breach moves inactive→pending; a breach sustained ``for_seconds``
    moves pending→firing (opening an incident); a clear breach moves
    firing→inactive via a ``resolved`` transition (stamping the incident).
    SKIP results (``ok is None`` — sensor absent) never breach: absence
    of the sensor is the `slo.py` convention for "cannot judge", and an
    alert that fires on missing data would page on every cold start.

    Every transition is appended to ``alerts.jsonl`` and handed to the
    webhook command (argv + one JSON argument), when configured.
    """

    def __init__(self, rules: List[AlertRule],
                 windows: Optional[Dict[str, float]] = None,
                 tower_dir=None,
                 webhook: Optional[List[str]] = None,
                 incident_context: Optional[Callable[..., Dict[str, Any]]] = None):
        from sparse_coding__tpu_torch.telemetry.slo import DEFAULT_WINDOWS

        self.rules = list(rules)
        self.windows = dict(windows or DEFAULT_WINDOWS)
        self.tower_dir = Path(tower_dir) if tower_dir is not None else None
        self.webhook = list(webhook) if webhook else None
        self.webhook_failures = 0
        self.incident_context = incident_context
        self.states: Dict[str, Dict[str, Any]] = {
            r.name: {"state": "inactive", "since": None, "pending_since": None,
                     "firing_since": None, "incident": None, "result": None}
            for r in self.rules
        }
        self._n_incidents = 0
        if self.tower_dir is not None:
            inc_dir = self.tower_dir / "incidents"
            if inc_dir.is_dir():
                self._n_incidents = len(list(inc_dir.glob("INC-*.json")))

    # -- evaluation -----------------------------------------------------------

    def evaluate(self, store: SeriesStore,
                 now: float) -> List[Dict[str, Any]]:
        """One tick; returns the transition records it appended."""
        from sparse_coding__tpu_torch.telemetry.slo import evaluate_series

        transitions: List[Dict[str, Any]] = []
        for rule in self.rules:
            result = evaluate_series(
                store, {"windows": self.windows,
                        "objectives": [rule.objective]},
            )["objectives"][0]
            st = self.states[rule.name]
            st["result"] = result
            breach = result["ok"] is False
            if st["state"] == "inactive" and breach:
                st.update(state="pending", since=now, pending_since=now)
                transitions.append(self._transition(
                    rule, "inactive", "pending", now, result))
            if st["state"] == "pending":
                if not breach:
                    st.update(state="inactive", since=now, pending_since=None)
                    transitions.append(self._transition(
                        rule, "pending", "inactive", now, result))
                elif now - st["pending_since"] >= rule.for_seconds:
                    st.update(state="firing", since=now, firing_since=now)
                    tr = self._transition(rule, "pending", "firing", now,
                                          result)
                    tr["incident"] = self._open_incident(rule, result, now)
                    st["incident"] = tr["incident"]
                    transitions.append(tr)
            elif st["state"] == "firing" and not breach:
                st.update(state="inactive", since=now, firing_since=None)
                tr = self._transition(rule, "firing", "resolved", now, result)
                tr["incident"] = st["incident"]
                self._resolve_incident(st["incident"], now)
                st["incident"] = None
                transitions.append(tr)
        for tr in transitions:
            self._append(tr)
            self._notify(tr)
        return transitions

    def firing(self) -> List[str]:
        return [n for n, st in self.states.items() if st["state"] == "firing"]

    def summary(self) -> List[Dict[str, Any]]:
        out = []
        for rule in self.rules:
            st = self.states[rule.name]
            r = st["result"] or {}
            out.append({
                "rule": rule.name,
                "severity": rule.severity,
                "state": st["state"],
                "since": st["since"],
                "measured": r.get("measured"),
                "detail": r.get("detail"),
                "burn_rates": r.get("burn_rates"),
            })
        return out

    # -- transitions / incidents ----------------------------------------------

    def _transition(self, rule: AlertRule, frm: str, to: str, now: float,
                    result: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "ts": round(now, 6), "rule": rule.name, "severity": rule.severity,
            "from": frm, "to": to,
            "measured": result.get("measured"),
            "detail": result.get("detail"),
            "burn_rates": result.get("burn_rates"),
        }

    def _append(self, tr: Dict[str, Any]) -> None:
        if self.tower_dir is None:
            return
        with open(self.tower_dir / "alerts.jsonl", "a") as f:
            f.write(json.dumps(tr) + "\n")

    def _notify(self, tr: Dict[str, Any]) -> None:
        if not self.webhook:
            return
        try:
            subprocess.run(
                [*self.webhook, json.dumps(tr)],
                timeout=10.0, check=False,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            )
        except Exception:
            # a broken pager must never take the watcher down
            self.webhook_failures += 1

    def _open_incident(self, rule: AlertRule, result: Dict[str, Any],
                       now: float) -> Optional[str]:
        if self.tower_dir is None:
            return None
        self._n_incidents += 1
        inc_id = f"INC-{self._n_incidents:04d}"
        record = {
            "id": inc_id,
            "rule": rule.to_dict(),
            "opened_ts": round(now, 6),
            "resolved_ts": None,
            "alert": result,
        }
        if self.incident_context is not None:
            try:
                record.update(self.incident_context(rule, result, now))
            except Exception as e:
                record["context_error"] = repr(e)
        inc_dir = self.tower_dir / "incidents"
        inc_dir.mkdir(parents=True, exist_ok=True)
        tmp = inc_dir / f".{inc_id}.tmp"
        tmp.write_text(json.dumps(record, indent=1) + "\n")
        os.replace(tmp, inc_dir / f"{inc_id}.json")
        return inc_id

    def _resolve_incident(self, inc_id: Optional[str], now: float) -> None:
        if self.tower_dir is None or not inc_id:
            return
        path = self.tower_dir / "incidents" / f"{inc_id}.json"
        try:
            record = json.loads(path.read_text())
            record["resolved_ts"] = round(now, 6)
            record["duration_seconds"] = round(
                now - float(record.get("opened_ts") or now), 3)
            tmp = path.parent / f".{inc_id}.tmp"
            tmp.write_text(json.dumps(record, indent=1) + "\n")
            os.replace(tmp, path)
        except (OSError, json.JSONDecodeError, ValueError):
            pass


def replay_alert_states(tower_dir) -> Dict[str, Dict[str, Any]]:
    """Current per-rule alert state from ``alerts.jsonl`` replay — what
    ``tower check`` reads, so the gate works on a dead tower's directory.
    ``resolved`` transitions land the rule back in ``inactive``."""
    path = Path(tower_dir) / "alerts.jsonl"
    states: Dict[str, Dict[str, Any]] = {}
    if not path.is_file():
        return states
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                tr = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(tr, dict) or "rule" not in tr:
                continue
            to = tr.get("to")
            states[str(tr["rule"])] = {
                "state": "inactive" if to == "resolved" else to,
                "since": tr.get("ts"),
                "last_transition": tr,
            }
    return states


# -- the tower ----------------------------------------------------------------


class Tower:
    """The aggregator process. See the module docstring for the shape;
    construct with static ``targets`` (URLs or ``{"url"|"port_file",
    "label"}`` dicts), ``replicasets`` (run dirs whose ``replica*/port``
    files are re-scanned every poll), ``run_dirs`` (tailed for events),
    and ``fleets`` (``.prom`` + queue-state aggregation)."""

    def __init__(
        self,
        tower_dir,
        targets: Optional[List[Any]] = None,
        replicasets: Optional[List[Any]] = None,
        run_dirs: Optional[List[Any]] = None,
        fleets: Optional[List[Any]] = None,
        rules: Optional[List[AlertRule]] = None,
        windows: Optional[Dict[str, float]] = None,
        webhook: Optional[List[str]] = None,
        interval: float = 5.0,
        scrape_timeout: float = 2.0,
        retention_seconds: float = DEFAULT_RETENTION_SECONDS,
        fine_seconds: float = DEFAULT_FINE_SECONDS,
        bucket_seconds: float = DEFAULT_BUCKET_SECONDS,
        telemetry=None,
        resume: bool = True,
    ):
        self.tower_dir = Path(tower_dir)
        self.tower_dir.mkdir(parents=True, exist_ok=True)
        self.targets = list(targets or [])
        self.replicasets = [Path(p) for p in (replicasets or [])]
        self.run_dirs = [Path(p) for p in (run_dirs or [])]
        self.fleets = [Path(p) for p in (fleets or [])]
        self.interval = float(interval)
        self.scrape_timeout = float(scrape_timeout)
        self.store = SeriesStore(
            retention_seconds=retention_seconds,
            fine_seconds=fine_seconds,
            bucket_seconds=bucket_seconds,
        )
        if resume:
            for rec in read_series(self.tower_dir):
                self.store.ingest(rec)
        self._own_telemetry = telemetry is None
        if telemetry is None:
            from sparse_coding__tpu_torch.telemetry.events import RunTelemetry

            telemetry = RunTelemetry(
                out_dir=self.tower_dir, run_name="tower",
                file_name="tower_events.jsonl",
            )
        self.telemetry = telemetry
        self.alerts = AlertManager(
            rules or [], windows=windows, tower_dir=self.tower_dir,
            webhook=webhook, incident_context=self._incident_context,
        )
        # correlation state from tailed run dirs
        self._tails: Dict[Path, Any] = {}
        self.replica_states: Dict[str, str] = {}
        self.replica_transitions: deque = deque(maxlen=200)
        self.anomalies: deque = deque(maxlen=200)
        self.traces: deque = deque(maxlen=512)
        self.span_seconds: Dict[str, float] = {}
        self._first_start_ts: Optional[float] = None
        self.polls = 0
        self.last_poll_ts: Optional[float] = None
        self.target_status: Dict[str, Dict[str, Any]] = {}
        self._dash = None

    # -- discovery ------------------------------------------------------------

    def discover_targets(self) -> Dict[str, str]:
        """Label → base URL for every scrape target, re-derived each poll:
        static entries first, then each replicaset's ``replica*/port``
        files (written post-warmup, unlinked on respawn — a restarting
        replica drops out and reappears automatically)."""
        out: Dict[str, str] = {}
        for i, entry in enumerate(self.targets):
            if isinstance(entry, str):
                out[f"target{i}"] = entry
                continue
            label = str(entry.get("label", f"target{i}"))
            url = entry.get("url")
            pf = entry.get("port_file")
            if url is None and pf is not None:
                url = self._url_from_port_file(Path(pf))
                if url is None:
                    continue
            if url is not None:
                out[label] = str(url)
        for rs in self.replicasets:
            for pf in sorted(rs.glob("replica*/port")):
                url = self._url_from_port_file(pf)
                if url is not None:
                    out[pf.parent.name] = url
        return out

    @staticmethod
    def _url_from_port_file(pf: Path) -> Optional[str]:
        try:
            port = int(pf.read_text().strip())
        except (OSError, ValueError):
            return None
        return f"http://127.0.0.1:{port}"

    # -- one poll cycle --------------------------------------------------------

    def poll_once(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Scrape + aggregate + record + evaluate: one full cycle. Returns
        the ``series.jsonl`` record it appended, with the alert
        transitions of this tick attached under ``"transitions"``."""
        from sparse_coding__tpu_torch.telemetry.spans import span

        now = time.time() if now is None else float(now)
        with span(self.telemetry, "tower_poll", "poll", poll=self.polls):
            rec = self._collect(now)
        self.store.ingest(rec)
        self.polls += 1
        self.last_poll_ts = now
        with open(self.tower_dir / "series.jsonl", "a") as f:
            f.write(json.dumps(rec) + "\n")
        transitions = self.alerts.evaluate(self.store, now)
        self.telemetry.counter_inc("tower.polls")
        up = sum(1 for t in self.target_status.values() if t.get("up"))
        self.telemetry.gauge_set("tower.targets_up", up)
        self.telemetry.gauge_set("tower.targets_total",
                                 len(self.target_status))
        self.telemetry.gauge_set("tower.alerts_firing",
                                 len(self.alerts.firing()))
        self.telemetry.gauge_set("tower.series_keys", self.store.n_keys())
        self._write_state(now)
        out = dict(rec)
        out["transitions"] = transitions
        return out

    def _collect(self, now: float) -> Dict[str, Any]:
        from sparse_coding__tpu_torch.telemetry import metrics_http as mh

        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, Dict[str, Any]] = {}
        status: Dict[str, Dict[str, Any]] = {}

        def merge(label: Optional[str], fams) -> None:
            c, g, h = _families_to_maps(fams)
            for k, v in c.items():
                counters[k] = counters.get(k, 0.0) + v
                if label is not None:
                    counters[f"{label}{TARGET_SEP}{k}"] = v
            for k, v in g.items():
                gauges[k] = max(gauges.get(k, float("-inf")), v)
                if label is not None:
                    gauges[f"{label}{TARGET_SEP}{k}"] = v
            for k, hh in h.items():
                cur = hists.get(k)
                if cur is None:
                    hists[k] = {
                        "bounds": list(hh["bounds"]),
                        "counts": list(hh["counts"]),
                        "sum": hh["sum"], "count": hh["count"],
                    }
                elif list(cur["bounds"]) == list(hh["bounds"]):
                    cur["counts"] = [
                        a + b for a, b in zip(cur["counts"], hh["counts"])
                    ]
                    cur["sum"] += hh["sum"]
                    cur["count"] += hh["count"]
                if label is not None:
                    hists[f"{label}{TARGET_SEP}{k}"] = hh

        # 1. live /metrics endpoints
        for label, url in self.discover_targets().items():
            try:
                fams = mh.scrape(url, timeout=self.scrape_timeout)
            except Exception as e:
                status[label] = {"up": False, "url": url,
                                 "error": type(e).__name__}
                self.telemetry.counter_inc("tower.scrape_errors")
                continue
            kind = "up"
            if mh.family_value(fams, "router.requests", "_total") is not None:
                kind = "router"
            elif mh.family_value(fams, "serve.requests", "_total") is not None:
                kind = "serve"
            status[label] = {"up": True, "url": url, "kind": kind}
            merge(label, fams)

        # 2. fleet worker .prom files + queue state
        for fleet_dir in self.fleets:
            for prom in sorted(Path(fleet_dir).glob("metrics/*.prom")):
                try:
                    merge(None, mh.parse_prometheus(prom.read_text()))
                except OSError:
                    continue
            for k, v in _fleet_gauges(fleet_dir, now).items():
                gauges[mh.sanitize_key(k)] = v

        # 3. tailed run dirs (router transitions, traces, anomalies, spans)
        self._poll_run_dirs()
        if self.span_seconds:
            frac = _goodput_frac(self.span_seconds)
            if frac is not None:
                gauges[mh.sanitize_key("train.goodput_frac")] = frac

        self.target_status = status
        return {
            "ts": round(now, 6),
            "counters": {k: round(v, 6) for k, v in sorted(counters.items())},
            "gauges": {k: round(v, 6) for k, v in sorted(gauges.items())},
            "hists": dict(sorted(hists.items())),
            "targets": {
                k: status[k] for k in sorted(status)
            },
        }

    def _poll_run_dirs(self) -> None:
        from sparse_coding__tpu_torch.telemetry.monitor import (
            EventTail,
            discover_event_files,
        )

        for run_dir in self.run_dirs:
            if not run_dir.is_dir():
                continue
            for path in discover_event_files(run_dir):
                if path not in self._tails:
                    self._tails[path] = EventTail(path)
        for tail in self._tails.values():
            records, _malformed = tail.poll()
            for rec in records:
                self._ingest_event(rec)

    def _ingest_event(self, rec: Dict[str, Any]) -> None:
        kind = rec.get("event")
        if kind == "router_replica_state":
            self.replica_states[str(rec.get("replica", "?"))] = str(
                rec.get("to", "?"))
            self.replica_transitions.append({
                "ts": rec.get("ts"), "replica": rec.get("replica"),
                "from": rec.get("frm"), "to": rec.get("to"),
                "reason": rec.get("reason"),
            })
        elif kind == "anomaly":
            self.anomalies.append(rec)
        elif kind == "request_trace":
            if _num(rec.get("latency_ms")) is not None:
                self.traces.append({
                    "ts": rec.get("ts"),
                    "trace_id": rec.get("trace_id"),
                    "latency_ms": float(rec["latency_ms"]),
                    "replica": rec.get("replica"),
                    "dict": rec.get("dict"),
                })
        elif kind == "span":
            cat, sec = rec.get("category"), _num(rec.get("seconds"))
            if cat is not None and sec is not None:
                self.span_seconds[str(cat)] = (
                    self.span_seconds.get(str(cat), 0.0) + sec
                )
        elif kind == "run_start":
            ts = _num(rec.get("ts"))
            if ts is not None and rec.get("run_name") not in (
                "supervisor", "tower"
            ):
                if self._first_start_ts is None or ts < self._first_start_ts:
                    self._first_start_ts = ts

    # -- incident context ------------------------------------------------------

    def _incident_context(self, rule: AlertRule, result: Dict[str, Any],
                          now: float) -> Dict[str, Any]:
        from sparse_coding__tpu_torch.telemetry.slo import evaluate_series

        slowest = sorted(
            self.traces, key=lambda t: -t["latency_ms"]
        )[:5]
        slo_cfg = {
            "windows": self.alerts.windows,
            "objectives": [r.objective for r in self.alerts.rules],
        }
        return {
            "dead_replicas": sorted(
                rid for rid, st in self.replica_states.items()
                if st in ("dead", "suspect")
            ),
            "replica_states": dict(sorted(self.replica_states.items())),
            "replica_transitions": list(self.replica_transitions)[-20:],
            "anomalies": list(self.anomalies)[-10:],
            "slowest_traces": slowest,
            "slo": evaluate_series(self.store, slo_cfg),
            "goodput": {
                "span_seconds": {
                    k: round(v, 3)
                    for k, v in sorted(self.span_seconds.items())
                },
                "goodput_frac": _goodput_frac(self.span_seconds),
            },
            "pool_state": self.pool_state(now),
            "tainted_artifacts": self._tainted_artifacts(),
        }

    def _tainted_artifacts(self) -> List[Dict[str, Any]]:
        """Quarantined-artifact lineage for incident timelines: build the
        provenance graph over the tower's run dirs and list every tainted
        node with its downstream blast size. Best-effort — a torn manifest
        must never block incident opening."""
        if not self.run_dirs:
            return []
        try:
            from sparse_coding__tpu_torch.telemetry.provenance import build_graph

            graph = build_graph([p for p in self.run_dirs if p.exists()])
            out = []
            for node in graph.tainted():
                out.append({
                    "id": node["id"],
                    "reason": node.get("taint_reason"),
                    "downstream": len(graph.closure(node["id"], "down")),
                })
            return out[:10]
        except Exception:
            return []

    # -- the autoscaler sensor contract ---------------------------------------

    def pool_state(self, now: Optional[float] = None) -> Dict[str, Any]:
        """ONE structured snapshot of the whole estate — the sensor
        contract an autoscaler consumes (docs/observability.md
        §11 pins the schema). Per-target latency/queue burn signals come
        from tower history, not the instantaneous scrape."""
        from sparse_coding__tpu_torch.telemetry import metrics_http as mh

        now = time.time() if now is None else float(now)
        fast_w = float(self.alerts.windows.get("fast_burn_seconds", 300.0))
        targets: Dict[str, Any] = {}
        for label, st in sorted(self.target_status.items()):
            targets[label] = {
                "up": bool(st.get("up")),
                "url": st.get("url"),
                "kind": st.get("kind", "up"),
                **self._target_signals(label, fast_w),
            }
        live = self.store.latest("gauge", mh.sanitize_key("router.live_replicas"))
        total = self.store.latest("gauge", mh.sanitize_key("router.replicas"))
        gp = _goodput_frac(self.span_seconds)
        return {
            "ts": self.last_poll_ts,
            "now": round(now, 6),
            "polls": self.polls,
            "interval_seconds": self.interval,
            "targets": targets,
            "router": (
                {"live_replicas": live[1], "replicas": total[1]}
                if live is not None and total is not None else None
            ),
            "fleet": self._fleet_state(),
            "train": (
                {"goodput_frac": gp} if gp is not None else None
            ),
            "alerts": self.alerts.summary(),
            "firing": self.alerts.firing(),
            "series": {
                "keys": self.store.n_keys(),
                "span": list(self.store.span() or ()),
            },
        }

    def _target_signals(self, label: str, window: float) -> Dict[str, Any]:
        """Per-target queue depth, p99, and request/error rates over the
        fast window — read from the per-target series namespace."""
        from sparse_coding__tpu_torch.telemetry import metrics_http as mh

        pre = f"{label}{TARGET_SEP}"
        out: Dict[str, Any] = {}
        depth = self.store.latest("gauge", pre + mh.sanitize_key("serve.queue_depth"))
        if depth is not None:
            out["queue_depth"] = depth[1]
        span = self.store.span()
        if span is None:
            return out
        t1 = span[1]
        t0 = t1 - window
        req = self.store.window_delta(
            pre + mh.sanitize_key("serve.requests"), t0, t1)
        if req:
            out["requests_in_window"] = round(req, 1)
            err = self.store.window_delta(
                pre + mh.sanitize_key("serve.errors"), t0, t1)
            out["error_frac_in_window"] = round(err / max(req + err, 1.0), 6)
        h = self.store.hist_delta(
            pre + mh.sanitize_key("serve.latency_ms"), t0, t1)
        if h is not None and h["count"] > 0:
            from sparse_coding__tpu_torch.telemetry.slo import _hist_quantile

            p99 = _hist_quantile(h, 0.99)
            if p99 is not None:
                out["latency_p99_ms_in_window"] = p99
        return out

    def _fleet_state(self) -> Optional[Dict[str, Any]]:
        from sparse_coding__tpu_torch.telemetry import metrics_http as mh

        idle = self.store.latest("gauge", mh.sanitize_key("fleet.idle_workers"))
        if idle is None:
            return None
        get = lambda k: self.store.latest("gauge", mh.sanitize_key(k))
        out = {"idle_workers": idle[1]}
        for k, name in (("fleet.busy_workers", "busy_workers"),
                        ("fleet.pending_items", "pending_items"),
                        ("fleet.leased_items", "leased_items")):
            v = get(k)
            if v is not None:
                out[name] = v[1]
        return out

    # -- state.json + dashboard ------------------------------------------------

    def _write_state(self, now: float) -> None:
        state = self.pool_state(now)
        tmp = self.tower_dir / ".state.json.tmp"
        tmp.write_text(json.dumps(state, indent=1) + "\n")
        os.replace(tmp, self.tower_dir / "state.json")

    def start_dashboard(self, host: str = "127.0.0.1", port: int = 0):
        """The zero-dependency live dashboard: ``/`` renders an embedded
        HTML page polling ``/state.json``; ``/metrics`` exposes the
        tower's OWN telemetry (the watcher is scrapeable too)."""
        self._dash = _DashboardServer(self, host=host, port=port).start()
        return self._dash

    def close(self) -> None:
        if self._dash is not None:
            self._dash.stop()
            self._dash = None
        if self._own_telemetry:
            self.telemetry.close()


# -- aggregation helpers ------------------------------------------------------


def _families_to_maps(fams) -> Tuple[Dict[str, float], Dict[str, float],
                                     Dict[str, Dict[str, Any]]]:
    """Scraped exposition families → (counters, gauges, hists) keyed by
    the sanitized telemetry key (prefix stripped). Histograms come back
    in telemetry format (per-bucket counts + overflow slot) so they merge
    and window-delta the same way snapshot hists do."""
    from sparse_coding__tpu_torch.telemetry import metrics_http as mh

    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Dict[str, Any]] = {}
    hist_keys = set()
    for name in fams:
        if name.endswith("_bucket") and name.startswith(mh.PREFIX):
            hist_keys.add(name[len(mh.PREFIX):-len("_bucket")])
    for name, samples in fams.items():
        if not name.startswith(mh.PREFIX):
            continue
        base = name[len(mh.PREFIX):]
        if name.endswith("_total"):
            counters[base[:-len("_total")]] = sum(v for _, v in samples)
        elif name.endswith(("_bucket", "_sum", "_count")):
            continue
        else:
            gauges[base] = max(v for _, v in samples)
    for key in hist_keys:
        h = mh.histogram_from_families(fams, key)
        if h is None or not h["cumulative"]:
            continue
        counts = [h["cumulative"][0]] + [
            b - a for a, b in zip(h["cumulative"], h["cumulative"][1:])
        ]
        counts.append(h["count"] - h["cumulative"][-1])
        hists[key] = {"bounds": h["bounds"], "counts": counts,
                      "sum": h["sum"], "count": h["count"]}
    return counters, gauges, hists


def _fleet_gauges(fleet_dir, now: float) -> Dict[str, float]:
    """Queue-state gauges for one fleet dir (idle/busy workers, pending/
    leased items) — the fleet idle-capacity signal `pool_state` exposes."""
    from sparse_coding__tpu_torch.fleet.queue import WorkQueue, is_fleet_dir

    if not is_fleet_dir(fleet_dir):
        return {}
    try:
        st = WorkQueue(fleet_dir, create=False).state(now=now)
    except Exception:
        return {}
    c = st.get("item_counts") or {}
    leases = st.get("leases") or {}
    busy = {l.get("worker") for l in leases.values() if l.get("worker")}
    workers = [
        w for w in (st.get("workers") or []) if not w.get("quarantined")
    ]
    idle = [w for w in workers if w.get("worker") not in busy]
    return {
        "fleet.idle_workers": float(len(idle)),
        "fleet.busy_workers": float(len(busy)),
        "fleet.pending_items": float(c.get("pending", 0)),
        "fleet.leased_items": float(c.get("leased", 0)),
    }


def _goodput_frac(span_seconds: Dict[str, float]) -> Optional[float]:
    """The live goodput approximation over tailed span seconds (the same
    inner-category subtraction `monitor.render` uses — the offline ledger
    is exact; this is the tower's cheap training-health gauge)."""
    from sparse_coding__tpu_torch.telemetry.spans import (
        GOODPUT_CATEGORIES,
        INNER_CATEGORIES,
    )

    total = sum(span_seconds.values())
    if total <= 0:
        return None
    good = max(
        0.0,
        sum(span_seconds.get(c, 0.0) for c in GOODPUT_CATEGORIES)
        - sum(span_seconds.get(c, 0.0) for c in INNER_CATEGORIES),
    )
    return round(min(1.0, good / total), 4)


# -- dashboard ----------------------------------------------------------------

_DASH_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>tower</title><style>
body{font:13px/1.5 monospace;background:#101418;color:#cdd6df;margin:1.5em}
h1{font-size:15px} table{border-collapse:collapse;margin:.6em 0}
td,th{border:1px solid #2a333d;padding:2px 9px;text-align:left}
.up{color:#7bd88f}.down{color:#ff6188}.firing{color:#ff6188;font-weight:bold}
.pending{color:#ffd866}.inactive{color:#7bd88f}small{color:#6b7682}
</style></head><body>
<h1>control tower</h1><div id="meta"><small>loading…</small></div>
<table id="targets"></table><table id="alerts"></table>
<div id="extra"></div>
<script>
function row(cells,tag){return "<tr>"+cells.map(c=>"<"+(tag||"td")+">"+c+"</"+(tag||"td")+">").join("")+"</tr>"}
async function tick(){
 try{
  const s=await (await fetch("state.json")).json();
  const age=s.ts?((s.now-s.ts).toFixed(1)+"s ago"):"never";
  document.getElementById("meta").innerHTML=
    "<small>"+s.polls+" poll(s), every "+s.interval_seconds+"s — last "+age+"</small>";
  let t=[row(["target","state","kind","queue","p99 (window)","req (window)"],"th")];
  for(const [k,v] of Object.entries(s.targets||{}))
   t.push(row([k,v.up?'<span class="up">up</span>':'<span class="down">DOWN</span>',
    v.kind||"-",v.queue_depth??"-",
    v.latency_p99_ms_in_window!=null?("≤"+v.latency_p99_ms_in_window+"ms"):"-",
    v.requests_in_window??"-"]));
  document.getElementById("targets").innerHTML=t.join("");
  let a=[row(["rule","state","measured","burn fast/slow","detail"],"th")];
  for(const al of (s.alerts||[])){
   const b=al.burn_rates?((al.burn_rates.fast??"-")+" / "+(al.burn_rates.slow??"-")):"-";
   a.push(row([al.rule,'<span class="'+al.state+'">'+al.state+"</span>",
    al.measured??"-",b,al.detail||""]))}
  document.getElementById("alerts").innerHTML=a.join("");
  const bits=[];
  if(s.router)bits.push("router: "+s.router.live_replicas+"/"+s.router.replicas+" live");
  if(s.fleet)bits.push("fleet: "+s.fleet.idle_workers+" idle / "+(s.fleet.busy_workers||0)+" busy, "+(s.fleet.pending_items||0)+" pending");
  if(s.train)bits.push("train goodput: "+(100*s.train.goodput_frac).toFixed(1)+"%");
  document.getElementById("extra").innerHTML="<small>"+bits.join(" | ")+"</small>";
 }catch(e){document.getElementById("meta").innerHTML='<span class="down">tower unreachable: '+e+"</span>"}
}
tick();setInterval(tick,2000);
</script></body></html>
"""


class _DashboardServer:
    """Stdlib HTTP listener for the dashboard (same lifecycle shape as
    `metrics_http.MetricsServer`)."""

    def __init__(self, tower: Tower, host: str = "127.0.0.1", port: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # pragma: no cover - quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path in ("/", "/index.html"):
                        self._send(200, _DASH_HTML.encode(),
                                   "text/html; charset=utf-8")
                    elif path == "/state.json":
                        self._send(
                            200,
                            json.dumps(tower.pool_state()).encode(),
                            "application/json",
                        )
                    elif path == "/metrics":
                        from sparse_coding__tpu_torch.telemetry.metrics_http import (
                            CONTENT_TYPE,
                            telemetry_metrics_text,
                        )

                        self._send(
                            200,
                            telemetry_metrics_text(tower.telemetry).encode(),
                            CONTENT_TYPE,
                        )
                    else:
                        self._send(404, json.dumps(
                            {"error": f"no route {path}"}).encode(),
                            "application/json")
                except Exception as e:  # the dashboard must never crash it
                    self._send(500, json.dumps({"error": repr(e)}).encode(),
                               "application/json")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "_DashboardServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self.httpd.serve_forever, daemon=True,
                name="tower-dash",
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self._thread = None


# -- check / report -----------------------------------------------------------


def tower_check(tower_dir, quiet: bool = False) -> int:
    """The CI gate: 1 while any alert is firing, 0 when none is, 3 when
    the directory holds no tower data at all."""
    d = Path(tower_dir)
    lines: List[str] = []
    if not (d / "series.jsonl").is_file():
        lines.append(f"{d}: no tower data (series.jsonl missing)")
        code = 3
    else:
        states = replay_alert_states(d)
        firing = sorted(
            n for n, st in states.items() if st["state"] == "firing"
        )
        for name in sorted(states):
            st = states[name]
            lines.append(f"  {name}: {st['state']}")
        if firing:
            lines.append(f"FIRING: {', '.join(firing)}")
            code = 1
        else:
            lines.append("no alert firing")
            code = 0
    if not quiet:
        for line in lines:
            print(line)
    return code


def _fmt_ts(ts) -> str:
    if not isinstance(ts, (int, float)):
        return "-"
    return time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime(ts)) + "Z"


def read_incidents(tower_dir) -> List[Dict[str, Any]]:
    out = []
    inc_dir = Path(tower_dir) / "incidents"
    if not inc_dir.is_dir():
        return out
    for path in sorted(inc_dir.glob("INC-*.json")):
        try:
            rec = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(rec, dict):
            out.append(rec)
    return out


def render_incidents(incidents: List[Dict[str, Any]]) -> List[str]:
    """Markdown lines for a list of incident records — shared by ``tower
    report`` and the run report's Incidents section."""
    lines = [
        "| incident | rule | opened | resolved | dead replicas | traces |",
        "|---|---|---|---|---|---:|",
    ]
    for inc in incidents:
        rule = (inc.get("rule") or {}).get("name", "?")
        dead = ", ".join(inc.get("dead_replicas") or []) or "-"
        resolved = (
            _fmt_ts(inc["resolved_ts"]) if inc.get("resolved_ts") is not None
            else "**OPEN**"
        )
        lines.append(
            f"| {inc.get('id', '?')} | {rule} | {_fmt_ts(inc.get('opened_ts'))} "
            f"| {resolved} | {dead} | {len(inc.get('slowest_traces') or [])} |"
        )
    for inc in incidents:
        lines.append("")
        lines.append(f"### {inc.get('id', '?')} — {(inc.get('rule') or {}).get('name', '?')}")
        alert = inc.get("alert") or {}
        lines.append(
            f"- alert: measured {alert.get('measured')} — "
            f"{alert.get('detail', '')}"
        )
        if inc.get("duration_seconds") is not None:
            lines.append(f"- duration: {inc['duration_seconds']} s")
        slo = inc.get("slo") or {}
        if slo:
            lines.append(
                f"- SLO at open: **{str(slo.get('verdict', '?')).upper()}** "
                f"({slo.get('n_failed', '?')} objective(s) failed)"
            )
        gp = (inc.get("goodput") or {}).get("goodput_frac")
        if gp is not None:
            lines.append(f"- training goodput: {100 * gp:.1f}%")
        traces = inc.get("slowest_traces") or []
        if traces:
            lines.append("- slowest correlated traces:")
            for t in traces:
                lines.append(
                    f"    - `{str(t.get('trace_id'))[:16]}…` "
                    f"{t.get('latency_ms')} ms"
                    + (f" (replica {t['replica']})" if t.get("replica") else "")
                )
        trs = inc.get("replica_transitions") or []
        if trs:
            lines.append("- replica transitions before open:")
            for t in trs[-5:]:
                lines.append(
                    f"    - {t.get('replica')}: {t.get('from')} → {t.get('to')}"
                    + (f" ({t['reason']})" if t.get("reason") else "")
                )
        tainted = inc.get("tainted_artifacts") or []
        if tainted:
            lines.append("- tainted artifacts at open:")
            for t in tainted:
                lines.append(
                    f"    - `{t.get('id')}` — {t.get('reason', '?')}"
                    f" ({t.get('downstream', 0)} downstream)"
                )
    return lines


def render_tower_report(tower_dir) -> str:
    """``tower report DIR``: pool summary + alert history + incidents."""
    d = Path(tower_dir)
    lines = [f"# Tower report — {d}", ""]
    state = None
    try:
        state = json.loads((d / "state.json").read_text())
    except (OSError, json.JSONDecodeError):
        pass
    series = read_series(d)
    lines.append(
        f"{len(series)} poll(s) recorded"
        + (f", last at {_fmt_ts(series[-1].get('ts'))}" if series else "")
    )
    if state:
        up = sum(1 for t in (state.get("targets") or {}).values()
                 if t.get("up"))
        lines.append(
            f"targets: {up}/{len(state.get('targets') or {})} up | "
            f"firing: {', '.join(state.get('firing') or []) or 'none'}"
        )
    lines.append("")
    lines.append("## Alert history")
    lines.append("")
    path = d / "alerts.jsonl"
    transitions = []
    if path.is_file():
        for line in path.read_text().splitlines():
            try:
                transitions.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    if transitions:
        lines.append("| ts | rule | transition | measured | detail |")
        lines.append("|---|---|---|---:|---|")
        for tr in transitions:
            lines.append(
                f"| {_fmt_ts(tr.get('ts'))} | {tr.get('rule')} "
                f"| {tr.get('from')} → {tr.get('to')} "
                f"| {tr.get('measured') if tr.get('measured') is not None else '-'} "
                f"| {tr.get('detail', '')} |"
            )
    else:
        lines.append("_(no transitions recorded)_")
    incidents = read_incidents(d)
    lines.append("")
    lines.append(f"## Incidents ({len(incidents)})")
    lines.append("")
    if incidents:
        lines.extend(render_incidents(incidents))
    else:
        lines.append("_(none)_")
    return "\n".join(lines) + "\n"


# -- CLI ----------------------------------------------------------------------


def _load_tower_config(path) -> Dict[str, Any]:
    """``tower.json``: the static estate description (docs §11)::

        {"targets": ["http://127.0.0.1:8701",
                     {"port_file": "/runs/tier/router.port", "label": "router"}],
         "replicasets": ["/runs/tier"],
         "run_dirs": ["/runs/tier", "/runs/train0"],
         "fleets": ["/runs/fleet0"],
         "interval_seconds": 5.0,
         "retention_seconds": 21600,
         "rules": "alerts.json"}

    ``rules`` may be a path (relative to the config file) or an inline
    dict in the `load_rules` schema.
    """
    p = Path(path)
    cfg = json.loads(p.read_text())
    if not isinstance(cfg, dict):
        raise ValueError(f"{path}: tower config must be a JSON object")
    rules_src = cfg.get("rules")
    if isinstance(rules_src, str):
        rp = Path(rules_src)
        if not rp.is_absolute():
            rp = p.parent / rp
        cfg["rules"] = load_rules(rp)
    elif isinstance(rules_src, dict):
        cfg["rules"] = load_rules(rules_src)
    return cfg


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m sparse_coding__tpu_torch.tower",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="collect + alert + serve")
    run.add_argument("tower_dir", help="state dir (series/alerts/incidents)")
    run.add_argument("--config", default=None, metavar="tower.json",
                     help="static estate description (targets, run dirs, "
                     "fleets, rules)")
    run.add_argument("--targets", nargs="*", default=[], metavar="URL",
                     help="additional /metrics endpoints")
    run.add_argument("--replicaset", action="append", default=[],
                     metavar="DIR", help="replicaset run dir — replica*/port "
                     "files are re-discovered every poll")
    run.add_argument("--run-dir", action="append", default=[], metavar="DIR",
                     help="run dir to tail for events (traces, anomalies, "
                     "router transitions, spans)")
    run.add_argument("--fleet", action="append", default=[], metavar="DIR",
                     help="fleet dir (.prom + queue-state aggregation)")
    run.add_argument("--rules", default=None, metavar="alerts.json",
                     help="alert rules (slo objectives + for_seconds)")
    run.add_argument("--interval", type=float, default=None,
                     help="poll period in seconds (default 5)")
    run.add_argument("--polls", type=int, default=0,
                     help="stop after N polls (0 = run forever)")
    run.add_argument("--http", type=int, default=None, metavar="PORT",
                     help="serve the live dashboard on PORT (0 = ephemeral)")
    run.add_argument("--webhook", nargs="+", default=None, metavar="CMD",
                     help="command invoked with one JSON arg per alert "
                     "transition")

    rep = sub.add_parser("report", help="render pool + incident report")
    rep.add_argument("tower_dir")

    chk = sub.add_parser("check", help="CI gate: exit 1 while any alert "
                         "fires, 0 clean, 3 no data")
    chk.add_argument("tower_dir")

    args = ap.parse_args(argv)

    if args.cmd == "check":
        return tower_check(args.tower_dir)
    if args.cmd == "report":
        if not Path(args.tower_dir).is_dir():
            print(f"tower dir {args.tower_dir} does not exist")
            return 3
        print(render_tower_report(args.tower_dir), end="")
        return 0

    cfg: Dict[str, Any] = {}
    if args.config:
        cfg = _load_tower_config(args.config)
    rules_cfg = cfg.get("rules") or {}
    if args.rules:
        rules_cfg = load_rules(args.rules)
    tower = Tower(
        args.tower_dir,
        targets=[*(cfg.get("targets") or []), *args.targets],
        replicasets=[*(cfg.get("replicasets") or []), *args.replicaset],
        run_dirs=[*(cfg.get("run_dirs") or []), *args.run_dir],
        fleets=[*(cfg.get("fleets") or []), *args.fleet],
        rules=rules_cfg.get("rules"),
        windows=rules_cfg.get("windows"),
        webhook=args.webhook or rules_cfg.get("webhook"),
        interval=(
            args.interval if args.interval is not None
            else float(cfg.get("interval_seconds", 5.0))
        ),
        retention_seconds=float(
            cfg.get("retention_seconds", DEFAULT_RETENTION_SECONDS)
        ),
    )
    if args.http is not None:
        dash = tower.start_dashboard(port=args.http)
        print(f"dashboard at {dash.address}")
    try:
        n = 0
        while True:
            rec = tower.poll_once()
            for tr in rec["transitions"]:
                print(
                    f"alert {tr['rule']}: {tr['from']} → {tr['to']}"
                    + (f" ({tr['detail']})" if tr.get("detail") else "")
                )
            n += 1
            if args.polls and n >= args.polls:
                break
            time.sleep(tower.interval)
    except KeyboardInterrupt:
        pass
    finally:
        tower.close()
    firing = tower.alerts.firing()
    if firing:
        print(f"FIRING at exit: {', '.join(sorted(firing))}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
