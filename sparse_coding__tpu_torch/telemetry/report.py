"""Run report: render a run directory's JSONL artifacts into one summary.

``python -m sparse_coding__tpu_torch.report <run_dir>`` reads every
``events.jsonl`` / ``events.p<i>.jsonl`` / ``*_events.jsonl`` and
``metrics.jsonl`` / ``*_metrics.jsonl`` under the run directory and prints
a markdown summary: run fingerprint, compile and throughput stats, a
per-model table of final metric values (loss family, FVU/L0 when logged,
the ``health_*`` pack), and the anomaly timeline. Every bench/parity/sweep
artifact becomes self-describing — no re-running studies to learn what a
run did.

Multi-host run dirs (per-process ``events.p<i>.jsonl``, every record
tagged ``process_index`` — `telemetry.multihost`) merge into ONE summary
with an extra **Pod / multi-host** section: per-host throughput/compile/
HBM rows, flush-window straggler skew, clock offsets, and an offline
fingerprint diff when hosts disagree. Single-host output is unchanged.

Counterpart of `sparse_coding__tpu/telemetry/report.py`, section for
section, over the same event format. Where the port records something else,
its section reads the port's own: the fingerprint shows torch, CUDA and the
device where JAX shows jax, jaxlib and its backend; "Performance
attribution" puts each captured step graph's cost (the ``compile`` events
of `Ensemble` captures: an analytic count, not XLA's cost analysis) on the
card's roofline from the port's peak table (`telemetry.profiling.PEAKS`),
with the step's measured device time where the train loop recorded it
(the ``perf.<entry>.step_ms`` gauges). "Provenance" renders the lineage
graph over the run directory, as JAX's does.

Use ``--out report.md`` to also write the summary next to the artifacts.
"""

from __future__ import annotations

import argparse
import json
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, List, Optional

from sparse_coding__tpu_torch.telemetry.multihost import (
    PROC_FILE_RE as _PROC_FILE_RE,
    format_bytes as _bytes,
)

__all__ = ["load_run", "render_markdown", "main"]

COST_NOTE = ("_Each row is one captured step graph: FLOPs and bytes counted analytically (the kernels' work "
             "at the captured step's code nnz, or FlopCounterMode on the autograd route), not XLA's cost "
             "analysis; the step ms is the train loop's CUDA-event time of a graph step "
             "(`perf.<entry>.step_ms`)._")

# columns shown first when present; any other metric follows alphabetically
_PREFERRED_METRICS = [
    "loss", "l_reconstruction", "l_l1", "fvu", "l0",
    "health_grad_norm", "health_dict_norm", "health_nonfinite",
    "health_dead_frac",
]


def _read_jsonl(path: Path) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    pass  # a torn tail line must not kill the report
    return out


def load_run(run_dir) -> Dict[str, Any]:
    """Collect events + metrics records from a run directory (recursive —
    drivers nest per-epoch subfolders)."""
    d = Path(run_dir)
    if not d.is_dir():
        raise FileNotFoundError(f"run dir {d} does not exist")
    event_files = sorted(
        {
            p
            for p in list(d.rglob("events.jsonl"))
            + list(d.rglob("events.p*.jsonl"))
            + list(d.rglob("*_events.jsonl"))
            # per-process form of custom file_name= logs (bench_events.p0.jsonl)
            + list(d.rglob("*_events.p*.jsonl"))
        }
    )
    metric_files = sorted(
        {p for p in list(d.rglob("metrics.jsonl")) + list(d.rglob("*_metrics.jsonl"))}
    )
    events: List[Dict[str, Any]] = []
    for p in event_files:
        recs = _read_jsonl(p)
        # records normally carry their own process_index tag; the filename
        # backstops logs written by older telemetry versions
        m = _PROC_FILE_RE.search(p.name)
        if m is not None:
            for r in recs:
                r.setdefault("process_index", int(m.group(1)))
        events.extend(recs)
    metrics: List[Dict[str, Any]] = []
    for p in metric_files:
        metrics.extend(_read_jsonl(p))
    return {
        "dir": str(d),
        "event_files": [str(p) for p in event_files],
        "metric_files": [str(p) for p in metric_files],
        "events": events,
        "metrics": metrics,
    }


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        if v != v:  # NaN
            return "nan"
        return f"{v:.4g}"
    return str(v)


def _events_of(run, kind: str) -> List[Dict[str, Any]]:
    return [e for e in run["events"] if e.get("event") == kind]


def _processes(run) -> List[Any]:
    """Distinct process indices present (``[None]`` for single-host logs)."""
    seen: List[Any] = []
    for e in run["events"]:
        p = e.get("process_index")
        if p not in seen:
            seen.append(p)
    return sorted(seen, key=lambda p: (-1 if p is None else int(p)))


def _last_snapshots(run) -> List[Dict[str, Any]]:
    """The final snapshot of each writer (one element single-host). Writers
    are distinguished by ``process_index`` (pods) AND the ``replica`` tag
    (serve replica tiers write one log per replica into the same run dir —
    without the second key, only the last replica's counters would
    survive the merge)."""
    last: "OrderedDict[Any, Dict[str, Any]]" = OrderedDict()
    for s in _events_of(run, "snapshot"):
        last[(s.get("process_index"), s.get("replica"))] = s
    return list(last.values())


def _merged_counters(run) -> Dict[str, float]:
    """Counters summed over each process's last snapshot — single-host this
    is exactly the old snaps[-1] behavior."""
    out: Dict[str, float] = {}
    for s in _last_snapshots(run):
        for k, v in (s.get("counters") or {}).items():
            out[k] = out.get(k, 0) + v
    return out


def _merged_gauges(run) -> Dict[str, float]:
    """Union of each process's last-snapshot gauges. Pod gauges either carry
    a ``p<i>.`` namespace (HBM) or are allgather-identical across hosts
    (``skew.flush.*``), so the union is collision-free."""
    out: Dict[str, float] = {}
    for s in _last_snapshots(run):
        out.update(s.get("gauges") or {})
    return out


def _fingerprint_section(run, lines: List[str]):
    starts = _events_of(run, "run_start")
    lines.append("## Run fingerprint")
    lines.append("")
    if not starts:
        lines.append("_(no run_start event)_")
        lines.append("")
        return
    procs = {s.get("process_index") for s in starts}
    if len(procs) > 1:
        # merged pod logs: one fingerprint per host is noise — show the
        # coordinator's and let the Pod section diff any disagreement
        coord = [s for s in starts if s.get("process_index") in (0, None)]
        starts = coord[:1] or starts[:1]
        lines.append(
            f"_Merged pod run: {len(procs)} processes; coordinator "
            "fingerprint below, cross-host diffs in the Pod section._"
        )
    for s in starts:
        fp = s.get("fingerprint") or {}
        lines.append(f"- **run**: {s.get('run_name', '?')}")
        # the port's torch / cuda / distributed_backend stand where JAX's
        # fingerprint has jax / jaxlib
        for key in (
            "git_sha", "torch", "cuda", "backend", "device_kind",
            "device_count", "process_count", "mesh", "distributed_backend", "python",
        ):
            if key in fp:
                lines.append(f"- **{key}**: {_fmt(fp[key])}")
        cc = fp.get("compile_cache")
        if isinstance(cc, dict):
            lines.append(
                f"- **compile_cache**: enabled={cc.get('enabled')} "
                f"dir={cc.get('dir')} entries={cc.get('entries')}"
            )
        cfg = s.get("config")
        if cfg:
            lines.append(f"- **config**: `{json.dumps(cfg, default=str)[:500]}`")
    lines.append("")


def _compile_section(run, lines: List[str]):
    lines.append("## Compile activity")
    lines.append("")
    compiles = _events_of(run, "compile")
    counters = _merged_counters(run)
    by_name: "OrderedDict[str, Dict[str, float]]" = OrderedDict()
    for c in compiles:
        d = by_name.setdefault(c.get("name", "?"), {"count": 0, "seconds": 0.0})
        d["count"] += 1
        d["seconds"] += float(c.get("seconds", 0.0))
    if by_name:
        lines.append("| entry point | compiles | wall s |")
        lines.append("|---|---:|---:|")
        for name, d in by_name.items():
            lines.append(f"| {name} | {d['count']} | {d['seconds']:.2f} |")
        lines.append("")
    total_n = counters.get("compile.backend.count")
    total_s = counters.get("compile.backend.seconds")
    if total_n is not None:
        lines.append(
            f"Backend compiles: **{int(total_n)}** ({_fmt(total_s)} s total)."
        )
    cache = {
        k.split(".", 1)[1]: int(v)
        for k, v in counters.items()
        if k.startswith("compile_cache.")
    }
    if cache:
        lines.append(
            "Persistent compile cache: "
            + ", ".join(f"{k}={v}" for k, v in sorted(cache.items()))
            + "."
        )
    if not by_name and total_n is None and not cache:
        lines.append("_(no compile events recorded)_")
    lines.append("")


def _perf_section(run, lines: List[str]):
    """Performance attribution: each captured step's cost on the card's
    roofline (with its measured step time where recorded), HBM watermarks
    (+ OOM headroom) and captured trace windows."""
    lines.append("## Performance attribution")
    lines.append("")
    wrote = False

    # device kind (for the peak table) from the run fingerprint
    device_kind = None
    for s in _events_of(run, "run_start"):
        device_kind = (s.get("fingerprint") or {}).get("device_kind") or device_kind

    # latest captured cost per entry point (a recapture overwrites: the last
    # graph is the one the run kept replaying)
    costs: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
    for c in _events_of(run, "compile"):
        if isinstance(c.get("cost"), dict):
            costs[c.get("name", "?")] = c["cost"]
    if costs:
        from sparse_coding__tpu_torch.telemetry.profiling import hbm_gbps, peak_tflops, roofline_summary

        gauges = _merged_gauges(run)
        lines.append(
            "| entry point | GFLOP | HBM MiB | FLOPs/byte | bound | attainable TFLOP/s "
            "| step ms | achieved TFLOP/s | of attainable | graph pool |"
        )
        lines.append("|---|---:|---:|---:|---|---:|---:|---:|---:|---:|")
        for name, cost in costs.items():
            flops = cost.get("flops")
            byts = cost.get("bytes_accessed")
            step_ms = gauges.get(f"perf.{name}.step_ms")
            rl = None
            if flops and byts:
                rl = roofline_summary(flops, byts, device_kind, seconds=step_ms / 1e3 if step_ms else None)
            lines.append(
                f"| {name} "
                f"| {_fmt(flops / 1e9 if flops else None)} "
                f"| {_fmt(byts / 2**20 if byts else None)} "
                f"| {_fmt(rl['arithmetic_intensity'] if rl else None)} "
                f"| {rl['bound'] if rl else '-'} "
                f"| {_fmt(rl['attainable_tflops'] if rl else None)} "
                f"| {_fmt(step_ms)} "
                f"| {_fmt(rl.get('achieved_tflops') if rl else None)} "
                f"| {_fmt(rl.get('achieved_fraction') if rl else None)} "
                f"| {_bytes(cost.get('pool_bytes'))} |"
            )
        lines.append("")
        lines.append(COST_NOTE)
        lines.append("")
        if any(c.get("flops") and c.get("bytes_accessed") for c in costs.values()):
            tf, bw = peak_tflops(device_kind), hbm_gbps(device_kind)
            lines.append(
                f"Roofline peaks for **{device_kind or 'an unnamed device'}**: {tf:.0f} TFLOP/s bf16, "
                f"{bw:.0f} GB/s HBM (ridge at {tf * 1e3 / bw:.0f} FLOPs/byte)."
            )
            lines.append("")
        wrote = True

    # HBM watermarks from the last snapshot's gauges (per process, merged);
    # keys are `hbm.d<i>.<field>` single-host, `hbm.p<i>.d<j>.<field>` pods
    gauges = _merged_gauges(run)
    marks: Dict[str, Dict[str, float]] = {}
    for k, v in gauges.items():
        if k.startswith("hbm."):
            dev, field = k[len("hbm."):].rsplit(".", 1)
            marks.setdefault(dev, {})[field] = v
    if marks:
        lines.append("| device | HBM in use | peak in use | limit | OOM headroom |")
        lines.append("|---|---:|---:|---:|---:|")
        for dev in sorted(marks):
            m = marks[dev]
            peak, limit = m.get("peak_bytes_in_use"), m.get("bytes_limit")
            headroom = (
                f"{_bytes(limit - peak)} ({100 * (limit - peak) / limit:.1f}%)"
                if peak is not None and limit
                else "-"
            )
            lines.append(
                f"| {dev} | {_bytes(m.get('bytes_in_use'))} "
                f"| {_bytes(peak)} | {_bytes(limit)} | {headroom} |"
            )
        lines.append("")
        wrote = True

    traces = _events_of(run, "trace")
    if traces:
        for t in traces:
            lines.append(
                f"- trace captured (`{t.get('reason', '?')}`, steps "
                f"{_fmt(t.get('start_step'))}→{_fmt(t.get('stop_step'))}): "
                f"`{t.get('dir')}`"
            )
        lines.append("")
        wrote = True

    if not wrote:
        lines.append("_(no cost-annotated compile events, HBM gauges, or traces)_")
        lines.append("")


def _pod_section(run, lines: List[str]):
    """Merged multi-host view: per-host rows, straggler skew, clock offsets,
    desync attribution. Emitted ONLY when ≥2 processes appear in the logs —
    single-host report output is a stability contract."""
    procs = [p for p in _processes(run) if p is not None]
    if len(procs) < 2:
        return
    from sparse_coding__tpu_torch.telemetry.multihost import (
        chunk_skew_windows,
        fingerprint_diff,
    )

    lines.append("## Pod / multi-host")
    lines.append("")

    per_snap = {s.get("process_index"): s for s in _last_snapshots(run)}
    ends = {e.get("process_index"): e for e in _events_of(run, "run_end")}
    chunk_ends = _events_of(run, "chunk_end")
    lines.append(
        "| host | steps | steps/s | wall s | chunks | mean chunk s "
        "| backend compiles | compile s | HBM peak | status |"
    )
    lines.append("|---|---:|---:|---:|---:|---:|---:|---:|---:|---|")
    for p in procs:
        end = ends.get(p, {})
        counters = (per_snap.get(p) or {}).get("counters", {})
        gauges = (per_snap.get(p) or {}).get("gauges", {})
        secs = [
            float(c["seconds"])
            for c in chunk_ends
            if c.get("process_index") == p
            and isinstance(c.get("seconds"), (int, float))
        ]
        peaks = [
            v for k, v in gauges.items()
            if k.startswith("hbm.") and k.endswith(".peak_bytes_in_use")
        ]
        steps = end.get("steps", counters.get("train.steps"))
        lines.append(
            f"| p{p} "
            f"| {_fmt(int(steps) if steps is not None else None)} "
            f"| {_fmt(end.get('steps_per_sec'))} "
            f"| {_fmt(end.get('wall_seconds'))} "
            f"| {len(secs)} "
            f"| {_fmt(sum(secs) / len(secs) if secs else None)} "
            f"| {_fmt(counters.get('compile.backend.count'))} "
            f"| {_fmt(counters.get('compile.backend.seconds'))} "
            f"| {_bytes(max(peaks)) if peaks else '-'} "
            f"| {end.get('status', 'running')} |"
        )
    lines.append("")

    lines.append("### Straggler skew")
    lines.append("")
    wrote = False
    gauges = _merged_gauges(run)
    if "skew.flush.spread_seconds" in gauges:
        lines.append(
            f"- last flush window: spread **{_fmt(gauges['skew.flush.spread_seconds'])} s** "
            f"(max {_fmt(gauges.get('skew.flush.max_seconds'))} s, "
            f"min {_fmt(gauges.get('skew.flush.min_seconds'))} s across hosts)"
        )
        wrote = True
    windows = chunk_skew_windows(run["events"])
    if windows:
        spreads = [w["spread"] for w in windows]
        worst = max(windows, key=lambda w: w["spread"])
        by_host = ", ".join(
            f"p{p}={worst['seconds'][p]:.3g}s" for p in sorted(worst["seconds"])
        )
        epoch, chunk, _pos = worst["key"]
        where = f"chunk {chunk}" + ("" if epoch is None else f" (epoch {epoch})")
        lines.append(
            f"- {len(windows)} chunk windows with ≥2 hosts: mean skew "
            f"{sum(spreads) / len(spreads):.3g} s, worst "
            f"**{worst['spread']:.3g} s** at {where} ({by_host})"
        )
        wrote = True
    if not wrote:
        lines.append("_(no skew gauges or multi-host chunk windows recorded)_")
    lines.append("")

    beats: Dict[Any, Dict[str, Any]] = {}
    for h in _events_of(run, "heartbeat"):
        if h.get("clock_offset_seconds") is not None:
            beats[h.get("process_index")] = h
    if beats:
        lines.append(
            "Clock offsets vs coordinator: "
            + ", ".join(
                f"p{p} {beats[p]['clock_offset_seconds']:+.3f} s"
                + (
                    f" (±{beats[p]['clock_uncertainty_seconds']:.3f})"
                    if beats[p].get("clock_uncertainty_seconds") is not None
                    else ""
                )
                for p in sorted(beats)
            )
            + "."
        )
        lines.append("")

    desync_events = [
        a for a in _events_of(run, "anomaly") if a.get("kind") == "desync"
    ]
    diff = fingerprint_diff(_events_of(run, "run_start"))
    if desync_events or diff:
        lines.append(
            f"### ⚠ Desync ({len(desync_events)} event(s) recorded)"
        )
        lines.append("")
        if diff:
            lines.append("Hosts disagree on:")
            lines.append("")
            lines.append("| field | " + " | ".join(f"p{p}" for p in sorted(diff[next(iter(diff))])) + " |")
            lines.append("|---|" + "---|" * len(diff[next(iter(diff))]))
            for field, vals in diff.items():
                lines.append(
                    f"| {field} | "
                    + " | ".join(
                        f"`{json.dumps(vals[p], default=str)[:60]}`"
                        for p in sorted(vals)
                    )
                    + " |"
                )
        else:
            lines.append(
                "_Digest mismatch detected live, but merged run_start "
                "fingerprints agree on the comparable fields — check configs._"
            )
        lines.append("")
    else:
        lines.append("Desync: none — all hosts agree on config/environment.")
        lines.append("")


def _recovery_section(run, lines: List[str]):
    """Restart lineage, checkpoints used, and wall time lost to recovery —
    rendered from driver ``preempt``/``resume`` events plus the
    supervisor's ``restart``/``spawn`` log (docs/RECOVERY.md). Omitted
    entirely for runs that never preempted, resumed, or restarted —
    routine scheduled ``checkpoint`` events alone do NOT trigger it, so
    ordinary single-generation report output is unchanged."""
    preempts = _events_of(run, "preempt")
    resumes = _events_of(run, "resume")
    restarts = _events_of(run, "restart")
    checkpoints = _events_of(run, "checkpoint")
    exhausted = _events_of(run, "budget_exhausted")
    fallbacks = _merged_counters(run).get("checkpoint.fallback")
    if not (preempts or resumes or restarts or exhausted or fallbacks):
        return
    lines.append("## Recovery")
    lines.append("")
    gens = [
        s for s in _events_of(run, "run_start")
        if s.get("run_name") != "supervisor"
    ]
    bits = [f"{len(gens)} driver generation(s)"]
    if preempts:
        bits.append(f"{len(preempts)} preemption(s)")
    if restarts:
        bits.append(f"{len(restarts)} supervisor restart(s)")
    if checkpoints:
        bits.append(f"{len(checkpoints)} checkpoint(s) written")
    lines.append("- " + ", ".join(bits))
    downtime = sum(
        float(r["downtime_seconds"])
        for r in restarts
        if r.get("downtime_seconds") is not None
    )
    if restarts:
        lines.append(
            f"- wall time lost to recovery (exit → respawn, incl. backoff): "
            f"**{downtime:.1f} s**"
        )
    if exhausted:
        e = exhausted[-1]
        lines.append(
            f"- ⚠ restart budget exhausted after {_fmt(e.get('restarts'))} "
            f"restart(s) (last exit code {_fmt(e.get('exit_code'))})"
        )
    if fallbacks:
        # the PR-6 satellite: resume silently skipping torn/corrupt
        # checkpoint dirs must be visible, not just a Python warning
        lines.append(
            f"- ⚠ {int(fallbacks)} checkpoint fallback(s): torn/corrupt "
            "checkpoint dirs skipped during resume (details in the anomaly "
            "timeline)"
        )
    lines.append("")
    if preempts:
        for p in preempts:
            sig = p.get("signum")
            lines.append(
                f"- preempt at cursor {_fmt(p.get('cursor'))}"
                + (f" (signal {sig})" if sig is not None else "")
                + f" → checkpoint `{p.get('checkpoint', '?')}`"
            )
        lines.append("")
    if resumes:
        lines.append("Checkpoints used to resume:")
        lines.append("")
        for r in resumes:
            lines.append(
                f"- `{r.get('checkpoint', '?')}` (cursor "
                f"{json.dumps(r.get('cursor'), default=str)[:80]})"
            )
        lines.append("")
    if restarts:
        lines.append("| restart | exit code | class | backoff s | downtime s |")
        lines.append("|---:|---:|---|---:|---:|")
        for r in restarts:
            lines.append(
                f"| {_fmt(r.get('attempt'))} | {_fmt(r.get('exit_code'))} "
                f"| {r.get('classification', '?')} "
                f"| {_fmt(r.get('backoff_seconds'))} "
                f"| {_fmt(r.get('downtime_seconds'))} |"
            )
        lines.append("")


def _data_section(run, lines: List[str]):
    """Data-plane integrity: chunks verified/quarantined/skipped, rows lost
    to degraded mode, remaining loss budget (docs/DATAPLANE.md). Omitted
    entirely for runs with no data-integrity activity at all — ordinary
    report output is a stability contract."""
    counters = _merged_counters(run)
    gauges = _merged_gauges(run)
    skips = _events_of(run, "chunk_skipped")
    exhausted = _events_of(run, "loss_budget_exhausted")
    verified = counters.get("data.chunks_verified")
    corrupt = counters.get("data.corrupt")
    skipped = counters.get("data.chunks_skipped")
    if not (verified or corrupt or skipped or skips or exhausted):
        return
    lines.append("## Data integrity")
    lines.append("")
    bits = []
    if verified:
        bits.append(f"{int(verified)} chunk load(s) verified")
    if corrupt:
        bits.append(f"**{int(corrupt)} chunk(s) quarantined**")
    if skipped:
        rows = counters.get("data.rows_skipped")
        bits.append(
            f"{int(skipped)} degraded-mode skip(s)"
            + (f" ({int(rows)} rows never trained)" if rows else "")
        )
    if bits:
        lines.append("- " + ", ".join(bits))
    budget = gauges.get("data.budget_remaining_frac")
    if budget is not None:
        lines.append(
            f"- loss budget remaining: **{100 * budget:.1f}%** "
            "(`SC_CHUNK_LOSS_BUDGET`)"
        )
    if exhausted:
        e = exhausted[-1]
        lines.append(
            f"- ⚠ **loss budget EXHAUSTED**: chunks {_fmt(e.get('chunks_lost'))} "
            f"lost ({_fmt(e.get('loss_frac'))} > {_fmt(e.get('budget_frac'))}) "
            "— run exited resumable (75); re-harvest the lost chunks "
            "(`make_activation_dataset(only_chunks=...)`) and resume"
        )
    lines.append("")
    if skips:
        lines.append("| chunk | reason | rows | loss so far |")
        lines.append("|---:|---|---:|---:|")
        for s in skips:
            lines.append(
                f"| {_fmt(s.get('chunk'))} | {s.get('reason', '?')} "
                f"| {_fmt(s.get('rows'))} | {_fmt(s.get('loss_frac'))} |"
            )
        lines.append("")


def _serving_section(run, lines: List[str]):
    """Online-serving stats (docs/SERVING.md): request/row/batch totals,
    latency SLO gauges, span-time attribution (request_wait/encode/dequant),
    registry mutations, and the drain outcome. Omitted entirely for runs
    with no serving activity — ordinary report output is a stability
    contract."""
    counters = _merged_counters(run)
    gauges = _merged_gauges(run)
    serve_counters = {k: v for k, v in counters.items() if k.startswith("serve.")}
    dict_events = [
        e for e in run["events"]
        if e.get("event") in
        ("serve_dict_added", "serve_dict_swapped", "serve_dict_removed")
    ]
    drains = _events_of(run, "serve_drained")
    if not (serve_counters or dict_events or drains):
        return
    lines.append("## Serving")
    lines.append("")
    reqs = int(counters.get("serve.requests", 0))
    rows = int(counters.get("serve.rows", 0))
    batches = int(counters.get("serve.batches", 0))
    bits = [f"**{reqs}** requests ({rows} rows) in {batches} micro-batch(es)"]
    rej = int(counters.get("serve.rejected", 0))
    err = int(counters.get("serve.errors", 0))
    if rej or err:
        bits.append(f"{rej} rejected (retryable), {err} error(s)")
    compiles = counters.get("serve.compiles")
    if compiles:
        bits.append(f"{int(compiles)} compiled step shape(s)")
    lines.append("- " + "; ".join(bits))
    if gauges.get("serve.latency_p50_ms") is not None:
        lines.append(
            f"- latency: p50 **{gauges['serve.latency_p50_ms']:.2f} ms**, "
            f"p95 {gauges.get('serve.latency_p95_ms', 0):.2f} ms, "
            f"p99 {gauges.get('serve.latency_p99_ms', 0):.2f} ms"
        )
    extras = []
    if gauges.get("serve.queue_depth") is not None:
        extras.append(f"queue depth {int(gauges['serve.queue_depth'])}")
    if gauges.get("serve.batch_occupancy") is not None:
        extras.append(
            f"batch occupancy {100 * gauges['serve.batch_occupancy']:.1f}%"
        )
    padded = counters.get("serve.padded_rows")
    if padded:
        extras.append(f"{int(padded)} padded rows dispatched")
    if extras:
        lines.append("- " + ", ".join(extras))
    span_bits = []
    for cat in ("encode", "request_wait", "dequant"):
        secs = counters.get(f"span.{cat}.seconds")
        if secs:
            span_bits.append(f"{cat} {secs:.2f} s")
    if span_bits:
        lines.append("- span time: " + ", ".join(span_bits))
    # wire formats & sparse/fused traffic (docs/SERVING.md):
    # per-format request counts + response bytes, so a dense-JSON-heavy
    # deployment is visible at a glance
    def _kb(v: float) -> str:
        v = float(v)
        for unit in ("B", "KB", "MB", "GB"):
            if v < 1024 or unit == "GB":
                return f"{v:.1f} {unit}" if unit != "B" else f"{int(v)} B"
            v /= 1024
        return f"{v:.1f} GB"

    fmt_bits = []
    for fmt in ("json", "npz", "raw"):
        n = counters.get(f"serve.requests.{fmt}")
        if not n:
            continue
        fmt_bits.append(
            f"{fmt} {int(n)} req / "
            f"{_kb(counters.get(f'serve.bytes_out.{fmt}', 0))} out"
        )
    if fmt_bits:
        lines.append("- wire: " + ", ".join(fmt_bits))
    sparse = int(counters.get("serve.sparse_requests", 0))
    feats = int(counters.get("serve.feature_requests", 0))
    if sparse or feats:
        lines.append(
            f"- sparse top-k responses: {sparse}; fused /features "
            f"requests: {feats}"
        )
    if dict_events:
        lines.append("")
        lines.append("| dict | event | weights | source |")
        lines.append("|---|---|---|---|")
        for e in dict_events:
            lines.append(
                f"| {e.get('dict', '?')} "
                f"| {e.get('event', '?').replace('serve_dict_', '')} "
                f"| {e.get('weights', '-')} | {_fmt(e.get('source'))} |"
            )
    if drains:
        d = drains[-1]
        lines.append("")
        lines.append(
            f"- drained clean (signal {_fmt(d.get('signum'))}) after "
            f"{_fmt(d.get('requests'))} request(s) — zero dropped in-flight"
        )
    lines.append("")


def _feature_section(run, lines: List[str]):
    """Dictionary health (docs/observability.md §10): one row per
    feature-stats flush generation — window rows, dead fraction, firing
    Gini, hot-1% concentration — plus the latest train↔serve drift verdict
    with its top-drifting features. Omitted entirely for runs without
    feature telemetry — report output is a stability contract."""
    flushes = _events_of(run, "feature_stats")
    if not flushes:
        return
    from sparse_coding__tpu_torch.telemetry.feature_stats import drift_band

    lines.append("## Dictionary health")
    lines.append("")
    n_train = sum(1 for f in flushes if f.get("scope") == "train")
    n_serve = sum(1 for f in flushes if f.get("scope") == "serve")
    bits = []
    if n_train:
        bits.append(f"{n_train} train flush(es)")
    if n_serve:
        bits.append(f"{n_serve} serve flush(es)")
    lines.append("- " + ", ".join(bits))
    lines.append("")

    def _pct(v) -> str:
        if not isinstance(v, (int, float)) or v != v:
            return "-"
        return f"{100 * v:.1f}%"

    lines.append("| gen | scope | lanes | rows | dead | gini | hot 1% | drift |")
    lines.append("|---|---|---|---:|---:|---:|---:|---:|")
    for f in flushes:
        names = [str(n) for n in (f.get("names") or [])]
        lane_txt = ",".join(names[:4]) + ("…" if len(names) > 4 else "")
        drift = f.get("drift_score")
        lines.append(
            f"| {f.get('gen', '?')} | {f.get('scope', '?')} "
            f"| {lane_txt or '-'} | {_fmt(f.get('rows'))} "
            f"| {_pct(f.get('dead_frac'))} | {_fmt(f.get('gini'))} "
            f"| {_pct(f.get('hot_frac'))} "
            f"| {_fmt(drift) if isinstance(drift, (int, float)) else '-'} |"
        )
    drifted = [
        f for f in flushes if isinstance(f.get("drift_score"), (int, float))
    ]
    if drifted:
        last = drifted[-1]
        score = float(last["drift_score"])
        lines.append("")
        lines.append(
            f"- drift vs training baseline "
            f"({last.get('drift_method', 'psi')}): **{score:.3f}** "
            f"[{drift_band(score).upper()}]"
        )
        top = last.get("drift_top") or []
        if top:
            lines.append(
                "- top drifting features: "
                + ", ".join(f"{int(ft)} ({d:.2f})" for ft, d in top[:8])
            )
    lines.append("")


def _router_section(run, lines: List[str]):
    """Replica-tier front-end stats (docs/SERVING.md): routed
    totals (retries / hedges / sheds / failures), a per-replica table
    (last known state, forward latency, restarts, state transitions),
    replica supervision outcomes, and rolling-swap rollouts. Omitted for
    runs with no router activity — report output is a stability
    contract."""
    counters = _merged_counters(run)
    gauges = _merged_gauges(run)
    router_counters = {k: v for k, v in counters.items() if k.startswith("router.")}
    state_events = _events_of(run, "router_replica_state")
    swaps = _events_of(run, "rolling_swap_done")
    if not (router_counters or state_events or swaps):
        return
    lines.append("## Router")
    lines.append("")
    reqs = int(counters.get("router.requests", 0))
    ok = int(counters.get("router.ok", 0))
    retried_ok = int(counters.get("router.retried_ok", 0))
    bits = [
        f"**{reqs}** requests routed: {ok} ok "
        f"({retried_ok} after transparent retries), "
        f"{int(counters.get('router.client_errors', 0))} client-error, "
        f"{int(counters.get('router.sheds', 0))} shed, "
        f"{int(counters.get('router.failed', 0))} failed"
    ]
    lines.append("- " + "; ".join(bits))
    lines.append(
        f"- {int(counters.get('router.forwards', 0))} forwards, "
        f"{int(counters.get('router.retries', 0))} retries, "
        f"{int(counters.get('router.hedges', 0))} hedges"
    )
    if gauges.get("router.replicas") is not None:
        lines.append(
            f"- replicas at close: {int(gauges.get('router.live_replicas', 0))}"
            f"/{int(gauges['router.replicas'])} live"
        )
    # per-replica rows: last state from the transition timeline, latency
    # gauges, and supervision outcomes from the replicaset's events
    restarts_by: Dict[str, int] = {}
    for e in _events_of(run, "replica_restart"):
        rid = str(e.get("replica", "?"))
        restarts_by[rid] = restarts_by.get(rid, 0) + 1
    exits_by: Dict[str, List[str]] = {}
    for e in _events_of(run, "replica_exit"):
        rid = str(e.get("replica", "?"))
        exits_by.setdefault(rid, []).append(str(e.get("classification", "?")))
    last_state: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
    transitions: Dict[str, int] = {}
    for e in state_events:
        rid = str(e.get("replica", "?"))
        last_state[rid] = e
        transitions[rid] = transitions.get(rid, 0) + 1
    rids = sorted(
        set(last_state)
        | set(restarts_by)
        | set(exits_by)
        | {
            k.split(".")[2]
            for k in gauges
            if k.startswith("router.replica.") and len(k.split(".")) > 3
        }
    )
    if rids:
        lines.append("")
        lines.append(
            "| replica | state | p50 ms | p99 ms | transitions "
            "| exits | restarts |"
        )
        lines.append("|---|---|---:|---:|---:|---|---:|")
        for rid in rids:
            st = last_state.get(rid, {})
            lines.append(
                f"| {rid} | {st.get('to', '?')} "
                f"| {_fmt(gauges.get(f'router.replica.{rid}.p50_ms'))} "
                f"| {_fmt(gauges.get(f'router.replica.{rid}.p99_ms'))} "
                f"| {transitions.get(rid, 0)} "
                f"| {', '.join(exits_by.get(rid, [])) or '-'} "
                f"| {restarts_by.get(rid, 0)} |"
            )
    downtime = [
        e.get("downtime_seconds")
        for e in _events_of(run, "replica_ready")
        if e.get("downtime_seconds") is not None
    ]
    if restarts_by or downtime:
        lines.append("")
        lines.append(
            f"- replica supervision: {sum(restarts_by.values())} restart(s)"
            + (
                f", {sum(downtime):.1f} s total replica downtime "
                "(router retried traffic around it)"
                if downtime
                else ""
            )
        )
    exhausted = _events_of(run, "replica_budget_exhausted")
    if exhausted:
        lines.append(
            f"- ⚠ **restart budget exhausted** for "
            f"{', '.join(sorted({str(e.get('replica')) for e in exhausted}))}"
            " — replica left dead (escalate)"
        )
    for s in swaps:
        lines.append(
            f"- rolling swap → generation **{_fmt(s.get('generation'))}** "
            f"across {_fmt(s.get('replicas'))} replica(s) in "
            f"{_fmt(s.get('seconds'))} s — drain-aware, zero dropped"
        )
    lines.append("")


def _slo_section(run, lines: List[str]):
    """SLO verdicts (docs/observability.md §8): when the run dir
    carries an ``slo.json``, evaluate it on the spot and render the
    objective table (availability/latency/queue/goodput, error-budget
    consumption, burn rates); ``slo_violation`` events recorded by the slo
    CLI or loadgen render as a timeline either way. Omitted entirely for
    runs with neither — report output is a stability contract."""
    violations = _events_of(run, "slo_violation")
    cfg_path = Path(run["dir"]) / "slo.json"
    if not violations and not cfg_path.is_file():
        return
    lines.append("## SLO")
    lines.append("")
    if cfg_path.is_file():
        from sparse_coding__tpu_torch.telemetry.slo import (
            evaluate_run_dir,
            load_config,
            render_slo,
        )

        try:
            result = evaluate_run_dir(run["dir"], load_config(cfg_path))
            lines.append(render_slo(result))
        except Exception as e:  # a bad config must not kill the report
            lines.append(f"_slo.json present but unevaluable: {e!r}_")
        lines.append("")
    if violations:
        lines.append("| objective | type | measured | budget used | detail |")
        lines.append("|---|---|---:|---:|---|")
        for v in violations:
            consumed = v.get("budget_consumed_frac")
            lines.append(
                f"| {v.get('objective', '?')} "
                f"| {v.get('objective_type', '?')} "
                f"| {_fmt(v.get('measured'))} "
                f"| {'-' if consumed is None else f'{100 * consumed:.1f}%'} "
                f"| {_fmt(v.get('detail'))} |"
            )
        lines.append("")


def _throughput_section(run, lines: List[str]):
    lines.append("## Throughput")
    lines.append("")
    ends = _events_of(run, "run_end")
    chunks = _events_of(run, "chunk_end")
    wrote = False
    for e in ends:
        bits = [f"status **{e.get('status', '?')}**"]
        if e.get("process_index") is not None:
            bits.insert(0, f"**p{e['process_index']}**")
        if e.get("generation") is not None:
            bits.insert(0, f"gen {e['generation']}")
        if "steps" in e:
            bits.append(f"{e['steps']} steps")
        if e.get("steps_per_sec") is not None:
            bits.append(f"{_fmt(e['steps_per_sec'])} steps/s")
        if "wall_seconds" in e:
            bits.append(f"{_fmt(e['wall_seconds'])} s wall")
        timer = e.get("timer")
        if timer:
            bits.append(
                f"StepTimer: {timer.get('steps')} ticks, "
                f"{_fmt(timer.get('steps_per_sec'))} steps/s fenced "
                f"({_fmt(timer.get('mean_step_ms'))} ms/step), "
                f"{_fmt(timer.get('dispatch_steps_per_sec'))} steps/s dispatch"
            )
        lines.append("- " + ", ".join(bits))
        wrote = True
    # a killed-and-resumed run writes one run_end PER GENERATION: the last
    # one's wall is only its own generation, so the honest total is the
    # per-(process, run) sum (under-reported before).
    # Grouping keys on run_name so the supervisor's overlapping lifetime
    # (or another run sharing the directory) is never lumped in, and
    # requires generation-stamped records — legacy logs cannot distinguish
    # a second generation from a second writer, so no total is guessed.
    # ... and on the `replica` tag: a serve replica tier writes one
    # same-named log per replica — their generation-0 run_ends are three
    # WRITERS, not three generations, and must not sum
    by_run: Dict[Any, List[Dict[str, Any]]] = {}
    for e in ends:
        if e.get("run_name") == "supervisor" or e.get("generation") is None:
            continue
        by_run.setdefault(
            (e.get("process_index"), (e.get("run_name"), e.get("replica"))),
            [],
        ).append(e)
    for (p, _name), pe in sorted(
        by_run.items(),
        key=lambda kv: (
            kv[0][0] is None, -1 if kv[0][0] is None else kv[0][0],
            str(kv[0][1]),
        ),
    ):
        if len(pe) < 2:
            continue
        walls = [e["wall_seconds"] for e in pe if e.get("wall_seconds") is not None]
        steps = [e["steps"] for e in pe if e.get("steps") is not None]
        where = "" if p is None else f" (p{p})"
        lines.append(
            f"- **total across {len(pe)} generations{where}**: "
            f"{_fmt(sum(walls))} s wall"
            + (f", {int(sum(steps))} steps" if steps else "")
        )
        wrote = True
    if chunks:
        # seconds=None = chunk_end without a chunk_start (a resumed
        # generation's torn window): honest "n/a", never a fake 0 mean
        secs = [
            float(c["seconds"]) for c in chunks
            if isinstance(c.get("seconds"), (int, float))
        ]
        mean = f"{sum(secs) / len(secs):.2f} s/chunk" if secs else "n/a s/chunk"
        untimed = len(chunks) - len(secs)
        lines.append(
            f"- {len(chunks)} chunks, mean {mean}"
            + (f" ({untimed} untimed)" if untimed else "")
        )
        wrote = True
    if not wrote:
        lines.append("_(no run_end / chunk events)_")
    lines.append("")


def _goodput_section(run, lines: List[str]):
    """Wall-time attribution (`telemetry.goodput`): goodput %, the badput
    breakdown, and the widest badput spans. Only rendered for runs that
    emitted ``span`` events (or multiple generations) — older runs' report
    output is a stability contract."""
    has_spans = any(e.get("event") == "span" for e in run["events"])
    gens = [
        s for s in _events_of(run, "run_start")
        if s.get("run_name") != "supervisor"
    ]
    if not has_spans and len(gens) < 2:
        return
    from sparse_coding__tpu_torch.telemetry.goodput import build_ledger, render_ledger

    try:
        ledger = build_ledger(run["dir"])
    except (OSError, ValueError):
        return
    if ledger["wall_seconds"] <= 0:
        return
    lines.append("## Goodput")
    lines.append("")
    lines.append(render_ledger(ledger))
    lines.append("")
    lines.append(
        "_Full timeline + Perfetto export: `python -m "
        f"sparse_coding__tpu_torch.timeline {run['dir']}` (docs/observability.md §7)._"
    )
    lines.append("")


def final_metric_table(metrics: List[Dict[str, Any]]):
    """(series -> metric -> final value), 'final' = value at max step."""
    latest: Dict[str, Dict[str, tuple]] = {}
    for r in metrics:
        s, m = r.get("series"), r.get("metric")
        if s is None or m is None:
            continue
        step = int(r.get("step", -1))
        cur = latest.setdefault(s, {}).get(m)
        if cur is None or step >= cur[0]:
            latest[s][m] = (step, r.get("value"))
    return {s: {m: v for m, (_, v) in row.items()} for s, row in latest.items()}


def _health_section(run, lines: List[str]):
    lines.append("## Per-model health (final values)")
    lines.append("")
    table = final_metric_table(run["metrics"])
    if not table:
        lines.append("_(no metrics recorded)_")
        lines.append("")
        return
    all_metrics: List[str] = []
    for row in table.values():
        for m in row:
            if m not in all_metrics:
                all_metrics.append(m)
    cols = [m for m in _PREFERRED_METRICS if m in all_metrics] + sorted(
        m for m in all_metrics if m not in _PREFERRED_METRICS
    )
    cols = cols[:12]  # keep the table terminal-renderable
    lines.append("| model | " + " | ".join(cols) + " |")
    lines.append("|---|" + "---:|" * len(cols))
    for series in sorted(table):
        row = table[series]
        lines.append(
            f"| {series} | " + " | ".join(_fmt(row.get(c)) for c in cols) + " |"
        )
    lines.append("")


def _anomaly_section(run, lines: List[str]):
    lines.append("## Anomaly timeline")
    lines.append("")
    anomalies = _events_of(run, "anomaly")
    if not anomalies:
        lines.append("_No anomalies recorded._")
        lines.append("")
        return
    tagged = any(a.get("process_index") is not None for a in anomalies)
    proc_col = "| proc " if tagged else ""
    lines.append(f"{proc_col}| step | kind | models | action | bundle |")
    lines.append(("|---" if tagged else "") + "|---:|---|---|---|---|")
    for a in anomalies:
        proc = (
            f"| p{a.get('process_index', '?')} " if tagged else ""
        )
        lines.append(
            f"{proc}| {_fmt(a.get('step'))} | {a.get('kind', '?')} "
            f"| {_fmt(a.get('model_names') or a.get('models'))} "
            f"| {_fmt(a.get('action'))} | {_fmt(a.get('bundle'))} |"
        )
    lines.append("")


def _incidents_section(run, lines: List[str]):
    """Control-tower incidents: when the reported directory is
    (or contains) a tower state dir, render its ``incidents/INC-*.json``
    records — rule, open/resolve times, the dead replicas, and the
    correlated slowest traces. Omitted entirely when no incidents exist —
    report output is a stability contract."""
    from sparse_coding__tpu_torch.telemetry.tower import (
        read_incidents,
        render_incidents,
    )

    incidents = read_incidents(run["dir"])
    if not incidents:
        return
    lines.append(f"## Incidents ({len(incidents)})")
    lines.append("")
    lines.extend(render_incidents(incidents))
    lines.append("")


def _provenance_section(run, lines: List[str]):
    """Artifact lineage: build the provenance graph over the reported
    directory and render the node/edge census plus any tainted artifacts
    with their blast radius. Omitted when the graph holds nothing beyond the
    run's own event stream."""
    from sparse_coding__tpu_torch.telemetry.provenance import build_graph, render_summary

    try:
        graph = build_graph([run["dir"]])
    except Exception:
        return
    if not any(n["type"] != "training-run" for n in graph.nodes.values()):
        return
    lines.append("## Provenance")
    lines.append("")
    lines.extend(render_summary(graph))
    lines.append("")


def render_markdown(run: Dict[str, Any]) -> str:
    lines: List[str] = [f"# Run report — `{run['dir']}`", ""]
    lines.append(
        f"_{len(run['events'])} events from {len(run['event_files'])} file(s); "
        f"{len(run['metrics'])} metric records from "
        f"{len(run['metric_files'])} file(s)._"
    )
    lines.append("")
    _fingerprint_section(run, lines)
    _pod_section(run, lines)
    _recovery_section(run, lines)
    _goodput_section(run, lines)
    _serving_section(run, lines)
    _feature_section(run, lines)
    _router_section(run, lines)
    _slo_section(run, lines)
    _incidents_section(run, lines)
    _provenance_section(run, lines)
    _data_section(run, lines)
    _compile_section(run, lines)
    _perf_section(run, lines)
    _throughput_section(run, lines)
    _health_section(run, lines)
    _anomaly_section(run, lines)
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparse_coding__tpu_torch.report", description=__doc__
    )
    ap.add_argument("run_dir", help="directory holding events/metrics JSONL")
    ap.add_argument("--out", default=None, help="also write the markdown here")
    args = ap.parse_args(argv)
    run = load_run(args.run_dir)
    md = render_markdown(run)
    print(md)
    if args.out:
        Path(args.out).write_text(md + "\n")
        print(f"\n[written to {args.out}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
