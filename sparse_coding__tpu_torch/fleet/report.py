"""Fleet dashboard: merge a fleet directory into one markdown summary.

``python -m sparse_coding__tpu_torch.fleet.report <fleet_dir>`` extends the
single-run report (`telemetry.report`, which already merges per-process pod
logs) one level up: a fleet directory holds a *queue* plus one run dir per
work item, and the dashboard answers the questions a sweep owner actually
asks after a night of hardware churn:

  - did every member finish? (items/members per state — ``lost`` must be 0)
  - which workers carried the load, which lost leases, which got
    quarantined?
  - the **reassignment lineage**: for every claim of every item — which
    worker held it, how it ended (done / lease_expired / failed /
    preempted), and which committed checkpoint the next holder resumed
    from;
  - per-item training rollups (status, steps, resumes, checkpoints) pulled
    through `telemetry.report.load_run` from each item's own events.

The lineage is read from the item JSONs themselves (it travels with the
files through every queue move — `fleet.queue`), so the report needs no
event-log join and renders correctly even for a fleet whose scheduler died.

Counterpart of `sparse_coding__tpu/fleet/report.py`, copied: it renders the
JAX package's dashboard over a fleet directory that either package wrote.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Dict, List, Optional

from sparse_coding__tpu_torch.fleet.queue import WorkQueue, is_fleet_dir

__all__ = ["load_fleet", "render_fleet_markdown", "main"]


def load_fleet(fleet_dir) -> Dict[str, Any]:
    """Queue state + per-item run summaries for rendering."""
    from sparse_coding__tpu_torch.telemetry.report import load_run

    fleet_dir = Path(fleet_dir)
    if not is_fleet_dir(fleet_dir):
        raise FileNotFoundError(f"{fleet_dir} holds no fleet queue (queue/pending)")
    queue = WorkQueue(fleet_dir, create=False)
    state = queue.state()
    runs: Dict[str, Dict[str, Any]] = {}
    for bucket in ("done", "leased", "failed", "pending"):
        for item in state["items"][bucket]:
            run_dir = queue.run_dir(item["item"])
            if run_dir.is_dir():
                try:
                    runs[item["item"]] = load_run(run_dir)
                except (OSError, FileNotFoundError):
                    pass
    return {"dir": str(fleet_dir), "state": state, "runs": runs}


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _run_rollup(run: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """status / steps / resumes / checkpoints from one item's event log."""
    if run is None:
        return {}
    from sparse_coding__tpu_torch.telemetry.report import _events_of, _merged_counters

    ends = _events_of(run, "run_end")
    counters = _merged_counters(run)
    return {
        "status": ends[-1].get("status") if ends else "running",
        "steps": counters.get("train.steps"),
        "resumes": counters.get("resumes"),
        "checkpoints": counters.get("checkpoints"),
    }


def render_fleet_markdown(fleet: Dict[str, Any]) -> str:
    state = fleet["state"]
    counts, members = state["item_counts"], state["members"]
    lines: List[str] = [f"# Fleet report — `{fleet['dir']}`", ""]
    lines.append(
        f"Items: **{counts['done']} done**, {counts['leased']} leased, "
        f"{counts['pending']} pending, {counts['failed']} failed. "
        f"Members: **{members['done']} done**, {members['running']} running, "
        f"{members['queued']} queued, {members['orphaned']} orphaned, "
        f"**{members['lost']} lost**."
    )
    lines.append("")
    if members["lost"] or counts["failed"]:
        lines.append(
            f"⚠ **{members['lost']} member(s) LOST** — attempt budgets "
            "exhausted; their items sit in `queue/failed/` with full lineage "
            "below."
        )
        lines.append("")

    # -- workers --------------------------------------------------------------
    lines.append("## Workers")
    lines.append("")
    if state["workers"]:
        lines.append("| worker | items done | strikes | quarantined |")
        lines.append("|---|---:|---:|---|")
        done_by_worker = state.get("done_by_worker", {})
        for w in state["workers"]:
            lines.append(
                f"| {w.get('worker', '?')} "
                f"| {_fmt(done_by_worker.get(w.get('worker'), 0))} "
                f"| {_fmt(w.get('strikes', 0))} "
                f"| {'YES' if w.get('quarantined') else '-'} |"
            )
    else:
        lines.append("_(no workers have claimed yet)_")
    lines.append("")

    # -- per-worker /metrics files -------------------------------------------
    # workers publish their telemetry as Prometheus text to
    # metrics/<worker>.prom (telemetry.metrics_http.write_metrics_file);
    # the report sums the counter families into one fleet-wide view
    prom_files = sorted(Path(fleet["dir"]).glob("metrics/*.prom"))
    if prom_files:
        from sparse_coding__tpu_torch.telemetry.metrics_http import parse_prometheus

        summed: Dict[str, float] = {}
        for p in prom_files:
            try:
                fams = parse_prometheus(p.read_text())
            except OSError:
                continue
            for name, samples in fams.items():
                if name.endswith("_total"):
                    summed[name] = summed.get(name, 0.0) + sum(
                        v for _, v in samples
                    )
        lines.append("## Worker metrics")
        lines.append("")
        lines.append(
            f"_{len(prom_files)} worker exposition file(s) under "
            "`metrics/` (Prometheus text — point a file-sd scraper at "
            "them, or read the fleet-wide counter sums below)._"
        )
        lines.append("")
        if summed:
            lines.append("| counter | fleet total |")
            lines.append("|---|---:|")
            for name, v in sorted(summed.items()):
                lines.append(f"| `{name}` | {_fmt(v)} |")
        lines.append("")

    # -- reassignment lineage -------------------------------------------------
    all_items = [
        (bucket, item)
        for bucket in ("done", "leased", "pending", "failed")
        for item in state["items"][bucket]
    ]
    lineage_rows = []
    for bucket, item in sorted(all_items, key=lambda bi: bi[1]["item"]):
        for entry in item.get("lineage", []):
            lineage_rows.append((item["item"], bucket, entry))
    lines.append("## Reassignment lineage")
    lines.append("")
    if lineage_rows:
        lines.append("| item | attempt | worker | outcome | resumed from | error |")
        lines.append("|---|---:|---|---|---|---|")
        for item_id, bucket, e in lineage_rows:
            outcome = e.get("outcome", "?")
            if outcome == "running" and bucket in ("pending", "failed"):
                outcome = "interrupted"  # requeued before any terminal mark
            lines.append(
                f"| {item_id} | {_fmt(e.get('attempt'))} "
                f"| {e.get('worker') or '-'} | {outcome} "
                f"| {e.get('resumed_from') or '-'} "
                f"| {str(e.get('error', ''))[:60] or '-'} |"
            )
    else:
        lines.append("_(no claims recorded)_")
    lines.append("")

    # -- per-item rollup ------------------------------------------------------
    lines.append("## Items")
    lines.append("")
    lines.append(
        "| item | state | members | attempts | run status | steps | resumes "
        "| checkpoints |"
    )
    lines.append("|---|---|---:|---:|---|---:|---:|---:|")
    for bucket, item in sorted(all_items, key=lambda bi: bi[1]["item"]):
        roll = _run_rollup(fleet["runs"].get(item["item"]))
        lines.append(
            f"| {item['item']} | {bucket} | {len(item.get('members', []))} "
            f"| {len(item.get('lineage', []))} "
            f"| {roll.get('status', '-')} | {_fmt(roll.get('steps'))} "
            f"| {_fmt(roll.get('resumes'))} | {_fmt(roll.get('checkpoints'))} |"
        )
    lines.append("")
    lines.append(
        "_Per-item detail: `python -m sparse_coding__tpu_torch.report "
        f"{fleet['dir']}/runs/<item>`._"
    )
    lines.append("")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparse_coding__tpu_torch.fleet.report", description=__doc__
    )
    ap.add_argument("fleet_dir", help="fleet root (holds queue/ and runs/)")
    ap.add_argument("--out", default=None, help="also write the markdown here")
    args = ap.parse_args(argv)
    fleet = load_fleet(args.fleet_dir)
    md = render_fleet_markdown(fleet)
    print(md)
    if args.out:
        Path(args.out).write_text(md + "\n")
        print(f"\n[written to {args.out}]")
    # a dashboard that exits 1 on lost members doubles as a CI gate
    return 1 if fleet["state"]["members"]["lost"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
