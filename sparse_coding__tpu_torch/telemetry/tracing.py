"""Request-level tracing for the serving tier.

Counterpart of the JAX package's `telemetry/tracing.py`, in its record
format and its CLI's output:

  - **Headers.** ``X-Trace-Id`` (32 hex chars) names a request,
    ``X-Parent-Span`` (16 hex chars) the caller's hop. The router mints a
    trace id when the client sent none (it is the tier's edge).
  - **Router attempts.** Every forward (first try, retries, hedges) is one
    ``span`` event of category ``forward`` with ``trace_id``, its own
    ``span_id``, ``parent_span``, ``replica``, ``attempt``, ``hedge`` and
    ``status``; its span id travels to the replica as ``X-Parent-Span``.
  - **Replica phases.** The engine writes one ``request_trace`` record per
    traced request with its ``request_wait`` / ``encode`` / ``dequant``
    seconds and the batch's context (``bucket``, ``lanes``, ``n_requests``).

`collect_traces` rebuilds the per-request trees from a run directory's
merged ``events*.jsonl`` (router and replicas in one dir, the
`serve.replicaset` layout); ``python -m sparse_coding__tpu_torch.trace`` is
the CLI: ``--trace-id`` renders one request's tree, ``--slowest N`` the
latency tail by phase, ``--list`` / ``--json`` the inventory. Exit codes: 0,
2 unknown trace id, 3 no run dir or no traced records.
"""

from __future__ import annotations

import json
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional

__all__ = ["TRACE_HEADER", "PARENT_HEADER", "TraceContext", "mint_trace_id", "mint_span_id", "collect_traces",
           "trace_summary", "render_trace", "render_slowest", "main"]

TRACE_HEADER = "X-Trace-Id"
PARENT_HEADER = "X-Parent-Span"


def mint_trace_id() -> str:
    """A fresh 128-bit trace id (32 lowercase hex chars)."""
    return uuid.uuid4().hex


def mint_span_id() -> str:
    """A fresh 64-bit span id (16 lowercase hex chars)."""
    return uuid.uuid4().hex[:16]


class TraceContext:
    """One hop's view of a trace: the trace id, this hop's span id, and the
    parent hop's span id (None at the edge)."""

    __slots__ = ("trace_id", "span_id", "parent_span")

    def __init__(self, trace_id: str, span_id: Optional[str] = None, parent_span: Optional[str] = None):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id) if span_id else mint_span_id()
        self.parent_span = str(parent_span) if parent_span else None

    def child(self) -> "TraceContext":
        """The next hop's context: same trace, fresh span, parented here."""
        return TraceContext(self.trace_id, parent_span=self.span_id)

    def headers(self) -> Dict[str, str]:
        """The propagation headers this hop sends downstream."""
        return {TRACE_HEADER: self.trace_id, PARENT_HEADER: self.span_id}

    @classmethod
    def from_headers(cls, headers) -> Optional["TraceContext"]:
        """The receiver's context for an incoming request's headers (fresh
        span id, parented on the sender's); None without a trace id."""
        trace_id = headers.get(TRACE_HEADER) or headers.get(TRACE_HEADER.lower())
        if not trace_id:
            return None
        parent = headers.get(PARENT_HEADER) or headers.get(PARENT_HEADER.lower())
        return cls(str(trace_id), parent_span=parent)

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id!r}, span={self.span_id!r}, parent={self.parent_span!r})"




# -- reconstruction -----------------------------------------------------------

# the event files of a run dir: the driver's, per-process ones and the
# named writers' (router_events.jsonl, replicaset_events.jsonl, ...)
_EVENT_GLOBS = ("events.jsonl", "events.p*.jsonl", "*_events.jsonl", "*_events.p*.jsonl")


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
                    continue  # a torn tail
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out


def _load_records(run_dir) -> List[Dict[str, Any]]:
    """Every record of every event file under the run dir, file by file in
    sorted path order (router and replica logs in one sweep)."""
    root = Path(run_dir)
    found = set()
    for pat in _EVENT_GLOBS:
        found.update(root.rglob(pat))
    return [r for path in sorted(found) for r in _read_jsonl(path)]


def collect_traces(records) -> Dict[str, Dict[str, Any]]:
    """Group trace-carrying records per trace id::

        {trace_id: {"attempts": [forward span records],
                    "requests": [request_trace records],
                    "batch_spans": [engine batch spans tagging this trace]}}
    """
    traces: Dict[str, Dict[str, Any]] = {}

    def slot(tid: str) -> Dict[str, Any]:
        if tid not in traces:
            traces[tid] = {"attempts": [], "requests": [], "batch_spans": []}
        return traces[tid]

    for r in records:
        kind = r.get("event")
        if kind == "span":
            tid = r.get("trace_id")
            if tid and r.get("category") == "forward":
                slot(str(tid))["attempts"].append(r)
            else:
                for t in r.get("traces") or ():
                    slot(str(t))["batch_spans"].append(r)
        elif kind == "request_trace" and r.get("trace_id"):
            slot(str(r["trace_id"]))["requests"].append(r)
    for t in traces.values():
        t["attempts"].sort(key=lambda a: a.get("ts_start") or 0.0)
        t["requests"].sort(key=lambda a: a.get("ts_start") or 0.0)
    return traces


def _num(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) and v == v else None


def trace_summary(trace_id: str, trace: Dict[str, Any]) -> Dict[str, Any]:
    """Per-phase totals and the end-to-end window of one trace.

    ``total_seconds`` spans the earliest record start to the latest record
    end; ``phases`` sums ``forward`` time across attempts and the replica's
    ``request_wait`` / ``encode`` / ``dequant`` seconds across its records
    (forward windows enclose the replica's phases, so those are subtracted
    from forward); ``gap`` is the rest of the window (retry backoff,
    transport)."""
    spans: List[Dict[str, float]] = []
    phases: Dict[str, float] = {}
    for a in trace["attempts"]:
        t0, secs = _num(a.get("ts_start")), _num(a.get("seconds"))
        if secs is None:
            continue
        phases["forward"] = phases.get("forward", 0.0) + secs
        if t0 is not None:
            spans.append({"start": t0, "end": t0 + secs})
    replica_secs = 0.0
    for r in trace["requests"]:
        for phase, secs in (r.get("phases") or {}).items():
            secs = _num(secs)
            if secs:
                phases[phase] = phases.get(phase, 0.0) + secs
                replica_secs += secs
        t0 = _num(r.get("ts_start"))
        lat = _num(r.get("latency_ms"))
        if t0 is not None and lat is not None:
            spans.append({"start": t0, "end": t0 + lat / 1e3})
    if "forward" in phases:
        phases["forward"] = max(0.0, phases["forward"] - replica_secs)
    total = None
    if spans:
        total = max(s["end"] for s in spans) - min(s["start"] for s in spans)
    covered = sum(phases.values())
    gap = max(0.0, (total or 0.0) - covered)
    replicas = sorted({str(a.get("replica")) for a in trace["attempts"] if a.get("replica")}
                      | {str(r.get("replica")) for r in trace["requests"] if r.get("replica")})
    winner = None
    for a in trace["attempts"]:
        status = a.get("status")
        if isinstance(status, int) and status == 200:
            winner = a.get("replica")
    return {"trace_id": trace_id, "n_attempts": len(trace["attempts"]), "n_requests": len(trace["requests"]),
            "replicas": replicas, "winner": winner, "total_seconds": total,
            "phases": {k: round(v, 6) for k, v in sorted(phases.items())}, "gap_seconds": round(gap, 6)}


def _ms(v: Optional[float]) -> str:
    return "?" if v is None else f"{1e3 * v:.1f} ms"


def render_trace(trace_id: str, trace: Dict[str, Any]) -> str:
    """One request's tree: router attempt(s), then the replica, then the
    batch context."""
    s = trace_summary(trace_id, trace)
    lines = [f"trace {trace_id} — {s['n_attempts']} attempt(s), {s['n_requests']} replica record(s), "
             f"total {_ms(s['total_seconds'])}"]
    # replica records parented on an attempt's span id hang under it;
    # orphans (traffic straight to a server) render at top level
    by_parent: Dict[Optional[str], List[Dict[str, Any]]] = {}
    for r in trace["requests"]:
        by_parent.setdefault(r.get("parent_span"), []).append(r)
    claimed: set = set()

    def request_lines(reqs: List[Dict[str, Any]], indent: str) -> List[str]:
        out = []
        for r in reqs:
            claimed.add(id(r))
            bits = ", ".join(f"{k} {_ms(_num(v))}" for k, v in (r.get("phases") or {}).items() if _num(v)) \
                or "no phases"
            batch = f" [batch b{r.get('bucket', '?')}×g{r.get('lanes', '?')}, {r.get('n_requests', '?')} req]"
            out.append(f"{indent}└─ replica {r.get('replica', '?')} dict {r.get('dict', '?')} "
                       f"({r.get('rows', '?')} rows, {_num(r.get('latency_ms')) or 0:.1f} ms): {bits}{batch}")
        return out

    prev_end = None
    for i, a in enumerate(trace["attempts"]):
        t0, secs = _num(a.get("ts_start")), _num(a.get("seconds")) or 0.0
        if prev_end is not None and t0 is not None and t0 > prev_end:
            lines.append(f"  │  (retry gap {_ms(t0 - prev_end)})")
        tag = "HEDGE " if a.get("hedge") else ""
        lines.append(f"  ├─ {tag}forward attempt {a.get('attempt', i)} → {a.get('replica', '?')}  "
                     f"[{a.get('status', '?')}]  {_ms(secs)}")
        lines.extend(request_lines(by_parent.get(a.get("span_id"), []), "  │    "))
        if t0 is not None:
            prev_end = t0 + secs
    for reqs in by_parent.values():
        reqs = [r for r in reqs if id(r) not in claimed]
        if reqs:
            lines.extend(request_lines(reqs, "  "))
    phase_bits = " | ".join(f"{k} {_ms(v)}" for k, v in s["phases"].items())
    if phase_bits:
        lines.append(f"  phase totals: {phase_bits} | uncovered gap {_ms(s['gap_seconds'])}")
    if s["winner"] is not None:
        lines.append(f"  winner: {s['winner']}")
    return "\n".join(lines)


def _by_total(traces: Dict[str, Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Every trace's summary, slowest first."""
    return sorted((trace_summary(tid, t) for tid, t in traces.items()), key=lambda s: -(s["total_seconds"] or 0.0))


def render_slowest(traces: Dict[str, Dict[str, Any]], n: int) -> str:
    """The latency tail by phase: the N slowest traces by end-to-end window,
    one line each, and the phase totals over exactly that tail."""
    summaries = [s for s in _by_total(traces) if s["total_seconds"] is not None]
    tail = summaries[: max(1, int(n))]
    lines = [f"slowest {len(tail)} of {len(summaries)} traced request(s):", ""]
    for s in tail:
        bits = ", ".join(f"{k} {_ms(v)}" for k, v in s["phases"].items())
        retried = f", {s['n_attempts']} attempts" if s["n_attempts"] > 1 else ""
        lines.append(f"  {s['trace_id'][:16]}…  {_ms(s['total_seconds'])}  "
                     f"({bits or 'no phases'}, gap {_ms(s['gap_seconds'])}{retried})")
    agg: Dict[str, float] = {}
    gap = 0.0
    for s in tail:
        for k, v in s["phases"].items():
            agg[k] = agg.get(k, 0.0) + v
        gap += s["gap_seconds"]
    total = sum(agg.values()) + gap
    if total > 0:
        lines += ["", "tail time by phase:"]
        for k, v in sorted(agg.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k:14s} {_ms(v):>12s}  {100 * v / total:5.1f}%")
        lines.append(f"  {'gap':14s} {_ms(gap):>12s}  {100 * gap / total:5.1f}%")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m sparse_coding__tpu_torch.trace", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("run_dir", help="run dir holding events*.jsonl (router and replica logs merge)")
    ap.add_argument("--trace-id", default=None, help="reconstruct one request's tree (prefix match ok)")
    ap.add_argument("--slowest", type=int, default=None, metavar="N",
                    help="rank the N slowest traces and explain the tail by phase")
    ap.add_argument("--list", action="store_true", help="list every trace id with its total latency")
    ap.add_argument("--json", action="store_true", help="emit machine-readable summaries instead of trees")
    args = ap.parse_args(argv)

    if not Path(args.run_dir).is_dir():
        print(f"run dir {args.run_dir} does not exist")
        return 3
    traces = collect_traces(_load_records(args.run_dir))
    if not traces:
        print(f"no traced records under {args.run_dir} (span[forward] / request_trace events)")
        return 3
    if args.trace_id:
        matches = [t for t in traces if t.startswith(args.trace_id)]
        if not matches:
            print(f"trace {args.trace_id!r} not found ({len(traces)} trace(s) present)")
            return 2
        for tid in matches:
            print(json.dumps(trace_summary(tid, traces[tid]), indent=1) if args.json
                  else render_trace(tid, traces[tid]))
        return 0
    if args.slowest is not None:
        print(json.dumps(_by_total(traces)[: args.slowest], indent=1) if args.json
              else render_slowest(traces, args.slowest))
        return 0
    summaries = _by_total(traces)
    if args.json:
        print(json.dumps(summaries, indent=1))
        return 0
    print(f"{len(summaries)} traced request(s) under {args.run_dir}:")
    for s in summaries:
        print(f"  {s['trace_id']}  {_ms(s['total_seconds'])}  {s['n_attempts']} attempt(s) via "
              f"{'/'.join(s['replicas']) or '?'}")
    return 0
