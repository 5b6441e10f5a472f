"""Goodput/badput wall-time ledger: where did a run's seconds actually go?

`build_ledger(run_dir)` merges every ``events*.jsonl`` under a run
directory — across processes (``events.p<i>.jsonl``) AND across resume
generations (a supervised restart appends new ``run_start``/``run_end``
pairs to the same log) plus the supervisor's ``supervisor_events.jsonl`` —
and assigns every second of wall clock to exactly one category:

  goodput   ``step``            fused train-step / harvest-forward windows
  badput    ``compile``         jit compiles (the JAX package's tracked_jit
                                events; the port writes none)
            ``data_wait``       chunk reads, prefetch waits, dataset loads
            ``checkpoint``      checkpoint save/restore, export commits
            ``preempt_drain``   the preemption checkpoint before exit 75
            ``degraded_skip``   quarantined-chunk skip handling
            ``export_verify``   fleet export/admission verification
            ``restart_backoff`` supervisor backoff sleeps (from ``restart``
                                events; the supervisor's own spans confirm)
            ``preempted_down``  inter-generation downtime after a preemption
            ``reassign_gap``    fleet lease-loss → next-claim gaps (lineage)
            ``straggler_idle``  fast hosts waiting on the slowest (derived
                                from cross-host chunk skew windows)
            ``unaccounted``     the honest remainder — never guessed away

Wall time is *process-seconds*: each process's span runs from its first
``run_start`` to its last event (inter-generation gaps included); the
run's total is the sum over processes. Durations prefer monotonic-derived
fields (``seconds``, ``wall_seconds``) over wall-clock subtraction, so an
NTP step cannot mint or destroy time within a generation; inter-generation
gaps necessarily use wall timestamps (two different process lifetimes).

Spans may nest (a dispatch that compiles inside a step window, a periodic
checkpoint inside it, harvest-forward spans inside the sweep's
dataset-init wait): every covered instant is assigned to the *innermost*
active span (`_exclusive_seconds` — an exact sweep line), so nothing is
double-counted.

`to_chrome_trace(ledger)` exports the ledger as Chrome trace-event JSON —
one track per (host, generation), spans colored by category — loadable in
Perfetto / chrome://tracing. `python -m sparse_coding__tpu_torch.timeline` is
the CLI over both (docs/observability.md §7).

Counterpart of `sparse_coding__tpu/telemetry/goodput.py`, copied; a fleet
directory (a fleet queue's lineage) raises: `fleet/` is not ported yet
(ROADMAP A9).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from sparse_coding__tpu_torch.telemetry.multihost import (
    PROC_FILE_RE as _PROC_FILE_RE,
    chunk_skew_windows,
)
from sparse_coding__tpu_torch.telemetry.spans import CATEGORIES, GOODPUT_CATEGORIES

__all__ = [
    "load_streams",
    "build_ledger",
    "build_ledger_from_streams",
    "fleet_reassignment_gaps",
    "is_fleet_dir",
    "to_chrome_trace",
    "render_ledger",
]

_EVENT_GLOBS = (
    "events.jsonl", "events.p*.jsonl", "*_events.jsonl", "*_events.p*.jsonl",
)
# legacy (generation-unstamped) restart records are written between the
# child's exit and the next generation's run_start, i.e. INSIDE the gap;
# this small slack only absorbs clock rounding at the edges
_RESTART_SLACK = 1.0


def _read_jsonl(path: Path) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail — not the ledger's problem
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out


# log streams whose lifetime OVERLAPS the driver generations they manage —
# counting them as driver wall would double every supervised second. The
# supervisor's stream still feeds `restart` records into gap classification.
_ORCH_RUN_NAME_PREFIXES = ("supervisor", "fleet_scheduler", "fleet_worker")
_ORCH_FILE_PREFIXES = ("supervisor", "scheduler_events", "worker_")


def load_streams(run_dir) -> List[Dict[str, Any]]:
    """One entry per event FILE (the per-process, per-writer unit the
    generation splitter needs — a flat cross-file merge cannot tell a
    supervisor ``run_end`` from a driver's)::

        {"file": str, "records": [...], "process_index": int,
         "supervisor": bool}

    ``supervisor`` marks *orchestration* streams (the supervisor, the fleet
    scheduler, fleet workers): their lifetimes overlap the driver
    generations they manage, so they are excluded from driver wall — but
    their ``restart`` records still classify inter-generation gaps.
    """
    d = Path(run_dir)
    if not d.is_dir():
        raise FileNotFoundError(f"run dir {d} does not exist")
    found = set()
    for pat in _EVENT_GLOBS:
        found.update(d.rglob(pat))
    streams = []
    for path in sorted(found):
        records = _read_jsonl(path)
        if not records:
            continue
        m = _PROC_FILE_RE.search(path.name)
        proc = int(m.group(1)) if m else None
        if proc is None:
            tags = [r["process_index"] for r in records if "process_index" in r]
            proc = int(tags[0]) if tags else 0
        run_names = [
            str(r.get("run_name") or "")
            for r in records if r.get("event") == "run_start"
        ]
        orchestration = path.name.startswith(_ORCH_FILE_PREFIXES) or any(
            n.startswith(_ORCH_RUN_NAME_PREFIXES) for n in run_names
        )
        streams.append({
            "file": str(path), "records": records,
            "process_index": proc, "supervisor": orchestration,
        })
    return streams


# -- generation analysis ------------------------------------------------------

def _split_generations(records: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    gens: List[Dict[str, Any]] = []
    cur: Optional[Dict[str, Any]] = None
    for r in records:
        if r.get("event") == "run_start":
            cur = {"run_start": r, "records": []}
            gens.append(cur)
        else:
            if cur is None:
                # leading records without a run_start (torn head): implicit gen
                cur = {"run_start": None, "records": []}
                gens.append(cur)
            cur["records"].append(r)
    return gens


def _num(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) and v == v else None


def _exclusive_seconds(spans: List[Dict[str, Any]]) -> Dict[str, float]:
    """Per-category *exclusive* seconds: every instant covered by ≥1 span is
    assigned to exactly one — the innermost (latest-started; ties go to the
    shorter) active span. This is what makes nesting safe: a compile inside
    a step window counts as compile (and the step window shrinks by exactly
    that much), a harvest-forward ``step`` span inside the sweep's
    ``dataset_init`` data-wait span counts as step. A sweep line over span
    boundaries — O(n log n) with small active sets, exact for partial
    overlaps too."""
    if not spans:
        return {}
    boundary = []  # (time, 0=end first at equal times, span)
    for s in spans:
        if s["seconds"] <= 0:
            continue
        boundary.append((s["start"], 1, s))
        boundary.append((s["start"] + s["seconds"], 0, s))
    boundary.sort(key=lambda e: (e[0], e[1]))
    totals: Dict[str, float] = {}
    active: List[Dict[str, Any]] = []
    prev_t: Optional[float] = None
    for t, kind, s in boundary:
        if prev_t is not None and active and t > prev_t:
            winner = max(active, key=lambda a: (a["start"], -a["seconds"]))
            totals[winner["category"]] = (
                totals.get(winner["category"], 0.0) + (t - prev_t)
            )
        if kind == 1:
            active.append(s)
        else:
            active.remove(s)
        prev_t = t
    return totals


def _analyze_generation(gen: Dict[str, Any], idx: int) -> Dict[str, Any]:
    rs = gen["run_start"]
    records = gen["records"]
    all_ts = [t for t in (_num(r.get("ts")) for r in ([rs] if rs else []) + list(records)) if t is not None]
    start_ts = _num(rs.get("ts")) if rs else None
    if start_ts is None:
        start_ts = min(all_ts) if all_ts else 0.0
    run_end = next((r for r in reversed(records) if r.get("event") == "run_end"), None)
    end_ts = _num(run_end.get("ts")) if run_end else None
    if end_ts is None:
        end_ts = max(all_ts) if all_ts else start_ts
    end_ts = max(end_ts, start_ts)
    wall = _num(run_end.get("wall_seconds")) if run_end else None
    if wall is None:
        wall = end_ts - start_ts
    status = str(run_end.get("status", "running")) if run_end else "running"
    preempted = status.startswith("preempted") or any(
        r.get("event") == "preempt" for r in records
    )
    generation = idx
    if rs is not None and isinstance(rs.get("generation"), int):
        generation = rs["generation"]
    elif run_end is not None and isinstance(run_end.get("generation"), int):
        generation = run_end["generation"]

    spans: List[Dict[str, Any]] = []
    for r in records:
        secs = _num(r.get("seconds"))
        if secs is None:
            continue
        if r.get("event") == "span" and r.get("category") in CATEGORIES:
            start = _num(r.get("ts_start"))
            if start is None:
                start = (_num(r.get("ts")) or start_ts) - secs
            span = {
                "category": r["category"], "start": start, "seconds": secs,
                "name": r.get("name"), "source": "span",
            }
            # trace tags (telemetry.tracing): carried through so the Chrome
            # export can render a per-request track view
            for key in ("trace_id", "traces", "replica"):
                if r.get(key) is not None:
                    span[key] = r[key]
            spans.append(span)
        elif r.get("event") == "compile":
            # compile events double as spans: the tracked_jit wall time of
            # the dispatch that compiled, ending at the record's ts
            end = _num(r.get("ts")) or start_ts
            spans.append({
                "category": "compile", "start": end - secs, "seconds": secs,
                "name": r.get("name"), "source": "compile",
            })
    categories = _exclusive_seconds(spans)
    classified = sum(categories.values())
    categories["unaccounted"] = max(0.0, wall - classified)
    return {
        "generation": generation,
        "start_ts": start_ts,
        "end_ts": end_ts,
        "wall_seconds": wall,
        "status": status,
        "preempted": preempted,
        "spans": spans,
        "categories": categories,
        "overcounted_seconds": max(0.0, classified - wall),
    }


def _run_dir_matches(r: Dict[str, Any], run_dir) -> bool:
    rd = r.get("run_dir")
    if rd is None or run_dir is None:
        return True
    # resolved-path equality when the stamped dir still exists; basename as
    # the relocatable fallback (checked-in golden run dirs are read from a
    # different root than they were stamped in)
    try:
        prd, pld = Path(rd), Path(run_dir)
        return prd.resolve() == pld.resolve() or prd.name == pld.name
    except OSError:
        return True


def _match_restarts(
    restarts, used: set, run_dir, gap_lo: float, gap_hi: float,
    next_generation: Optional[int],
) -> List[Dict[str, Any]]:
    """Supervisor ``restart`` events belonging to ONE inter-generation gap.
    Preferred join: the stamped ``generation`` (of the generation the
    restart spawned) + ``run_dir``. Unstamped legacy
    records fall back to timestamp containment — and ``used`` guarantees a
    record is consumed by at most one gap either way (short crash-loop
    generations put one restart inside several gaps' slack windows)."""
    candidates = [
        r for r in restarts
        if id(r) not in used and _run_dir_matches(r, run_dir)
    ]
    stamped = [
        r for r in candidates
        if isinstance(r.get("generation"), int)
        and r["generation"] == next_generation
    ]
    if not stamped:
        stamped = [
            r for r in candidates
            if not isinstance(r.get("generation"), int)
            and _num(r.get("ts")) is not None
            and gap_lo - _RESTART_SLACK <= r["ts"] <= gap_hi + _RESTART_SLACK
        ]
    for r in stamped:
        used.add(id(r))
    return stamped


def is_fleet_dir(path) -> bool:
    """Does ``path`` hold a fleet queue (``queue/pending/``, the JAX
    package's `fleet.queue` layout)?"""
    return (Path(path) / "queue" / "pending").is_dir()


def refuse_fleet_dir(path, what: str) -> None:
    """Raise on a fleet directory: the fleet views of the run tools wait for
    `fleet/`, which is not ported yet."""
    if is_fleet_dir(path):
        raise NotImplementedError(f"{path} is a fleet directory: {what} reads fleet/, which is not ported yet "
                                  "— ROADMAP A9")


def fleet_reassignment_gaps(fleet_dir) -> List[Dict[str, Any]]:
    """Wall time items spent between losing a lease and being re-claimed,
    from a fleet queue's item lineage: empty for a directory that is not a
    fleet's; a fleet directory raises (`fleet/` is not ported yet, ROADMAP
    A9)."""
    refuse_fleet_dir(fleet_dir, "the goodput ledger")
    return []


def build_ledger_from_streams(
    streams: List[Dict[str, Any]],
    run_dir=None,
    reassignment_gaps: Optional[List[Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """The ledger, from pre-loaded streams (tests) — see `build_ledger`."""
    driver_streams = [s for s in streams if not s["supervisor"]]
    restarts = [
        r
        for s in streams if s["supervisor"]
        for r in s["records"] if r.get("event") == "restart"
    ]

    categories: Dict[str, float] = {}
    spans_out: List[Dict[str, Any]] = []
    processes: Dict[int, Dict[str, Any]] = {}
    n_generations = 0
    used_restarts: set = set()  # each restart record joins at most one gap

    def add(cat: str, secs: float, proc: int):
        categories[cat] = categories.get(cat, 0.0) + secs
        pcat = processes[proc]["categories"]
        pcat[cat] = pcat.get(cat, 0.0) + secs

    for stream in driver_streams:
        proc = int(stream["process_index"])
        pstate = processes.setdefault(proc, {
            "wall_seconds": 0.0, "categories": {}, "generations": [],
        })
        gens = [
            _analyze_generation(g, i)
            for i, g in enumerate(_split_generations(stream["records"]))
        ]
        gens = [g for g in gens if g["wall_seconds"] > 0 or g["spans"]]
        n_generations += len(gens)
        for g in gens:
            pstate["wall_seconds"] += g["wall_seconds"]
            pstate["generations"].append({
                "generation": g["generation"], "status": g["status"],
                "wall_seconds": round(g["wall_seconds"], 3),
                "start_ts": g["start_ts"], "end_ts": g["end_ts"],
            })
            for cat, secs in g["categories"].items():
                add(cat, secs, proc)
            for s in g["spans"]:
                spans_out.append({
                    **s, "process_index": proc, "generation": g["generation"],
                })
        # inter-generation gaps: restart backoff (from the supervisor's
        # stamped restart events) + post-preemption downtime
        for cur, nxt in zip(gens, gens[1:]):
            gap = nxt["start_ts"] - cur["end_ts"]
            if gap <= 0:
                continue
            pstate["wall_seconds"] += gap
            backoff = 0.0
            for r in _match_restarts(
                restarts, used_restarts, run_dir, cur["end_ts"],
                nxt["start_ts"], nxt["generation"],
            ):
                backoff += _num(r.get("backoff_seconds")) or 0.0
            backoff = min(backoff, gap)
            rest = gap - backoff
            down_cat = "preempted_down" if cur["preempted"] else "unaccounted"
            if rest > 0:
                add(down_cat, rest, proc)
                spans_out.append({
                    "category": down_cat, "start": cur["end_ts"],
                    "seconds": rest, "name": "inter-generation downtime",
                    "process_index": proc, "generation": cur["generation"],
                    "derived": True,
                })
            if backoff > 0:
                add("restart_backoff", backoff, proc)
                spans_out.append({
                    "category": "restart_backoff",
                    "start": nxt["start_ts"] - backoff, "seconds": backoff,
                    "name": "supervisor backoff",
                    "process_index": proc, "generation": cur["generation"],
                    "derived": True,
                })

    # straggler idle (pods): the faster hosts' per-window wait on the
    # slowest, shifted out of their unaccounted remainder — never invented
    # beyond what the process's own wall already contains
    all_driver_events = [r for s in driver_streams for r in s["records"]]
    idle: Dict[int, float] = {}
    for w in chunk_skew_windows(all_driver_events):
        for p, secs in w["seconds"].items():
            idle[p] = idle.get(p, 0.0) + (w["max"] - secs)
    for p, secs in idle.items():
        if p not in processes or secs <= 0:
            continue
        shift = min(secs, processes[p]["categories"].get("unaccounted", 0.0))
        if shift <= 0:
            continue
        processes[p]["categories"]["unaccounted"] -= shift
        processes[p]["categories"]["straggler_idle"] = (
            processes[p]["categories"].get("straggler_idle", 0.0) + shift
        )
        categories["unaccounted"] = categories.get("unaccounted", 0.0) - shift
        categories["straggler_idle"] = categories.get("straggler_idle", 0.0) + shift

    # fleet lease-reassignment gaps (item lineage) — fleet dirs only
    gaps = reassignment_gaps or []
    for g in gaps:
        categories["reassign_gap"] = categories.get("reassign_gap", 0.0) + g["seconds"]
        spans_out.append({
            "category": "reassign_gap", "start": g["start_ts"],
            "seconds": g["seconds"],
            "name": f"reassign {g['item']}: {g.get('from_worker')}→{g.get('to_worker')}",
            "process_index": -1, "generation": 0, "derived": True,
        })

    wall = sum(p["wall_seconds"] for p in processes.values())
    wall += sum(g["seconds"] for g in gaps)
    goodput = sum(categories.get(c, 0.0) for c in GOODPUT_CATEGORIES)
    badput = {
        c: round(s, 3) for c, s in sorted(categories.items())
        if c not in GOODPUT_CATEGORIES and s > 0
    }
    top = sorted(
        (s for s in spans_out if s["category"] not in GOODPUT_CATEGORIES),
        key=lambda s: -s["seconds"],
    )[:5]
    # legacy runs predate span instrumentation: 0 step-seconds there means
    # "not measured", never "0% goodput" — renderers and the gate key on
    # this. Compile events and derived gaps don't count: only real span
    # records prove the run was instrumented.
    has_spans = any(s.get("source") == "span" for s in spans_out)
    return {
        "run_dir": None if run_dir is None else str(run_dir),
        "has_spans": has_spans,
        "wall_seconds": round(wall, 3),
        "processes": {
            p: {
                "wall_seconds": round(st["wall_seconds"], 3),
                "categories": {k: round(v, 3) for k, v in sorted(st["categories"].items()) if v > 0},
                "generations": st["generations"],
            }
            for p, st in sorted(processes.items())
        },
        "n_processes": len(processes),
        "n_generations": n_generations,
        "categories": {k: round(v, 3) for k, v in sorted(categories.items()) if v > 0},
        "goodput_seconds": round(goodput, 3),
        "goodput_frac": round(goodput / wall, 4) if wall > 0 else None,
        "badput_seconds": badput,
        "reassignment_gaps": gaps,
        "top_badput_spans": top,
        "spans": spans_out,
    }


def build_ledger(run_dir) -> Dict[str, Any]:
    """Classified wall-time ledger for a run directory (see module doc).
    Fleet directories additionally fold in lease-reassignment gaps from the
    queue's item lineage."""
    return build_ledger_from_streams(
        load_streams(run_dir),
        run_dir=run_dir,
        reassignment_gaps=fleet_reassignment_gaps(run_dir),
    )


# -- Chrome/Perfetto trace export ---------------------------------------------

# chrome://tracing reserved color names per category (Perfetto accepts and
# ignores unknown cnames, so this degrades gracefully)
_CNAME = {
    "step": "thread_state_running",
    "encode": "thread_state_running",
    "compile": "thread_state_runnable",
    "data_wait": "thread_state_iowait",
    "request_wait": "thread_state_iowait",
    "forward": "thread_state_iowait",
    "dequant": "rail_load",
    "checkpoint": "rail_idle",
    "preempt_drain": "terrible",
    "preempted_down": "terrible",
    "restart_backoff": "bad",
    "degraded_skip": "bad",
    "export_verify": "rail_load",
    "straggler_idle": "thread_state_sleeping",
    "reassign_gap": "black",
    "tower_poll": "rail_load",
    "unaccounted": "grey",
}


def to_chrome_trace(ledger: Dict[str, Any]) -> Dict[str, Any]:
    """Chrome trace-event JSON (the Perfetto-loadable legacy format): one
    ``pid`` per host, one ``tid`` per generation (derived downtime spans ride
    the generation they follow), complete ("X") events in microseconds."""
    spans = ledger.get("spans") or []
    starts = [s["start"] for s in spans if _num(s.get("start")) is not None]
    base = min(starts) if starts else 0.0
    events: List[Dict[str, Any]] = []
    seen_tracks = set()
    for s in spans:
        pid = int(s.get("process_index", 0))
        tid = int(s.get("generation", 0))
        if (pid, "p") not in seen_tracks:
            seen_tracks.add((pid, "p"))
            events.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": "fleet" if pid < 0 else f"host p{pid}"},
            })
        if (pid, tid) not in seen_tracks:
            seen_tracks.add((pid, tid))
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": f"gen {tid}"},
            })
        name = s.get("name") or s["category"]
        args = {"category": s["category"], "seconds": round(s["seconds"], 6)}
        span_traces = [s["trace_id"]] if s.get("trace_id") else list(
            s.get("traces") or ()
        )
        if span_traces:
            args["traces"] = span_traces
        events.append({
            "ph": "X",
            "name": str(name),
            "cat": s["category"],
            "pid": pid,
            "tid": tid,
            "ts": round((s["start"] - base) * 1e6, 1),
            "dur": round(s["seconds"] * 1e6, 1),
            "cname": _CNAME.get(s["category"], "grey"),
            "args": args,
        })
    # per-request track view: every trace-tagged span is ALSO
    # emitted on a "requests" process, one thread per trace id, so one
    # request's journey (router forward attempts + the replica batches it
    # rode) reads as one horizontal track in Perfetto
    trace_tids: Dict[str, int] = {}
    request_events: List[Dict[str, Any]] = []
    for s in spans:
        span_traces = [s["trace_id"]] if s.get("trace_id") else list(
            s.get("traces") or ()
        )
        for trace_id in span_traces:
            tid = trace_tids.setdefault(str(trace_id), len(trace_tids))
            name = s.get("name") or s["category"]
            if s.get("replica"):
                name = f"{name}@{s['replica']}"
            request_events.append({
                "ph": "X",
                "name": str(name),
                "cat": s["category"],
                "pid": -2,
                "tid": tid,
                "ts": round((s["start"] - base) * 1e6, 1),
                "dur": round(s["seconds"] * 1e6, 1),
                "cname": _CNAME.get(s["category"], "grey"),
                "args": {"category": s["category"], "trace_id": trace_id,
                         "seconds": round(s["seconds"], 6)},
            })
    if request_events:
        events.append({
            "ph": "M", "name": "process_name", "pid": -2, "tid": 0,
            "args": {"name": "requests (per-trace tracks)"},
        })
        for trace_id, tid in trace_tids.items():
            events.append({
                "ph": "M", "name": "thread_name", "pid": -2, "tid": tid,
                "args": {"name": f"trace {trace_id[:16]}"},
            })
        events.extend(request_events)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "run_dir": ledger.get("run_dir"),
            "goodput_frac": ledger.get("goodput_frac"),
            "trace_base_unix_ts": base,
            "n_traces": len(trace_tids),
        },
    }


# -- rendering ----------------------------------------------------------------

def render_ledger(ledger: Dict[str, Any]) -> str:
    """Markdown-ish ledger summary shared by the timeline CLI and the run
    report's Goodput section."""
    lines: List[str] = []
    wall = ledger["wall_seconds"]
    frac = ledger.get("goodput_frac")
    lines.append(
        f"wall (process-seconds): **{wall:.1f} s** over "
        f"{ledger['n_processes']} process(es), "
        f"{ledger['n_generations']} generation(s)"
    )
    if frac is None:
        lines.append("goodput: n/a (no attributable wall time)")
    elif not ledger.get("has_spans"):
        # a span-less (pre-instrumentation) run: 0 step-seconds is missing
        # data, not a measured 0% — only the derived gap/downtime categories
        # below are real
        lines.append(
            "goodput: n/a (no span instrumentation — only derived "
            "downtime categories are attributed)"
        )
    else:
        lines.append(
            f"goodput: **{100 * frac:.1f}%** "
            f"({ledger['goodput_seconds']:.1f} s productive step compute)"
        )
    badput = ledger.get("badput_seconds") or {}
    if badput:
        lines.append("")
        lines.append("| badput category | seconds | % of wall |")
        lines.append("|---|---:|---:|")
        for cat, secs in sorted(badput.items(), key=lambda kv: -kv[1]):
            pct = 100 * secs / wall if wall > 0 else 0.0
            lines.append(f"| {cat} | {secs:.2f} | {pct:.1f}% |")
    top = ledger.get("top_badput_spans") or []
    if top:
        lines.append("")
        lines.append("Top badput spans:")
        for s in top:
            where = (
                "fleet" if s.get("process_index", 0) < 0
                else f"p{s.get('process_index', 0)} gen {s.get('generation', 0)}"
            )
            lines.append(
                f"- {s['category']} **{s['seconds']:.2f} s** "
                f"({s.get('name') or '-'}, {where})"
            )
    gaps = ledger.get("reassignment_gaps") or []
    if gaps:
        lines.append("")
        lines.append(
            f"Fleet reassignment gaps: {len(gaps)} "
            f"({sum(g['seconds'] for g in gaps):.1f} s total)"
        )
    return "\n".join(lines)
