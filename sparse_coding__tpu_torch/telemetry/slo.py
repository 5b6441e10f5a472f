"""Declarative SLO engine over the serving tier's telemetry.

The latency/queue/occupancy gauges were write-only until now — nothing
*evaluated* them. This module reads a declarative ``slo.json`` and renders
verdicts with error-budget accounting and multi-window burn rates (the SRE
literature's fast/slow-burn alerting shape), over four sources:

  - a **run directory** (``events*.jsonl`` snapshots + the goodput
    ledger) — the CI gate: ``python -m sparse_coding__tpu_torch.slo <run_dir>
    --config slo.json`` exits **1** past budget;
  - a **live scrape** (``--scrape URL...`` over the new ``/metrics``
    endpoints, merged across replicas) — instantaneous only, so burn
    rates are None;
  - a **tower series** (``--tower DIR`` / `evaluate_series` over a
    control-tower `SeriesStore` — `telemetry.tower`): the retained
    pool-wide history, so fast/slow burn windows are REAL on live tiers
    (windowed counter and histogram deltas over tower retention) — the
    sensor an autoscaler reads;
  - a **loadgen result blob** (``serve.loadgen --slo slo.json``) —
    objectives checked against the measured client-side histogram.

Counterpart of `sparse_coding__tpu/telemetry/slo.py`, copied: the same
schema, verdicts and exit codes over the port's run dirs and endpoints.

``slo.json`` schema (docs/observability.md §8)::

    {"windows": {"fast_burn_seconds": 300, "slow_burn_seconds": 3600},
     "objectives": [
       {"name": "availability", "type": "availability", "target": 0.999,
        "good_counter": "serve.requests", "bad_counter": "serve.errors"},
       {"name": "p99", "type": "latency", "percentile": 0.99,
        "threshold_ms": 50.0, "histogram": "serve.latency_ms"},
       {"name": "queue", "type": "queue_depth", "max_depth": 16},
       {"name": "drift", "type": "feature-drift", "max_score": 0.25},
       {"name": "replicas", "type": "gauge_min",
        "gauge": "router.live_replicas", "min_value": 2},
       {"name": "goodput", "type": "goodput_floor", "floor_frac": 0.3}]}

Semantics:

  - **availability**: measured = good/(good+bad); the error budget is
    ``1 - target`` and ``budget_consumed = (1 - measured)/(1 - target)``
    — past budget at > 1.0. Burn rates divide a *window's* bad fraction
    by the budget: burn 1.0 = consuming exactly the budget; ≫1 fast-burn
    = page. Windows are reconstructed from snapshot deltas (run dir) and
    reported as None when the log is too short to cover them.
  - **latency**: measured percentile from the fixed-bucket histogram
    (conservative upper bound — correct to within one bucket width),
    gauge fallback (``serve.latency_p99_ms``) for histogram-less runs.
  - **queue_depth**: last-snapshot gauge vs ``max_depth``.
  - **feature-drift**: the train↔serve feature-distribution drift score
    (``serve.feature.drift_score``, PSI scale — `telemetry.feature_stats`)
    vs ``max_score``; skipped (not violated) when the tier never computed
    a drift score (no baseline loaded).
  - **gauge_min**: any gauge must stay at-or-above ``min_value`` — e.g.
    ``router.live_replicas`` ≥ N, the liveness objective the tower's
    availability alerting leans on (a router that transparently retries
    around a dead replica shows no error-counter signal).
  - **goodput_floor**: the goodput ledger's goodput fraction vs
    ``floor_frac`` (run-dir source, or the tower's live
    ``train.goodput_frac`` gauge via `evaluate_series`).

Failed objectives emit anomaly-style ``slo_violation`` events when the
caller hands an events sink (``--events DIR``), so reports and monitors
surface them next to the other anomalies.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "DEFAULT_WINDOWS",
    "load_config",
    "evaluate_run_dir",
    "evaluate_scrape",
    "evaluate_series",
    "evaluate_measured",
    "render_slo",
    "main",
]

DEFAULT_WINDOWS = {"fast_burn_seconds": 300.0, "slow_burn_seconds": 3600.0}


def load_config(path) -> Dict[str, Any]:
    with open(path) as f:
        cfg = json.load(f)
    if not isinstance(cfg, dict) or not isinstance(cfg.get("objectives"), list):
        raise ValueError(f"{path}: slo config needs an 'objectives' list")
    windows = {**DEFAULT_WINDOWS, **(cfg.get("windows") or {})}
    return {"windows": windows, "objectives": cfg["objectives"]}


def _num(v) -> Optional[float]:
    return float(v) if isinstance(v, (int, float)) and v == v else None


# -- run-dir source -----------------------------------------------------------


def _snapshots(run_dir) -> List[Dict[str, Any]]:
    from sparse_coding__tpu_torch.telemetry.goodput import load_streams

    snaps = []
    for s in load_streams(run_dir):
        for r in s["records"]:
            if r.get("event") == "snapshot":
                snaps.append(r)
    snaps.sort(key=lambda r: _num(r.get("ts")) or 0.0)
    return snaps


def _writer_key(rec: Dict[str, Any]) -> Tuple:
    return (rec.get("process_index"), rec.get("replica"))


def _merged_last(snaps: List[Dict[str, Any]], field: str) -> Dict[str, float]:
    """Counters summed over each writer's LAST snapshot; gauges take the
    WORST (max) value across writers — an SLO must see the saturated
    replica's queue depth / latency, not whichever replica happened to
    snapshot last (the scrape source merges the same way)."""
    last: Dict[Tuple, Dict[str, float]] = {}
    for s in snaps:
        last[_writer_key(s)] = s.get(field) or {}
    out: Dict[str, float] = {}
    for d in last.values():
        for k, v in d.items():
            v = _num(v)
            if v is None:
                continue
            if field == "counters":
                out[k] = out.get(k, 0.0) + v
            else:
                out[k] = max(out.get(k, float("-inf")), v)
    return out


def _merged_hists(snaps: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Histograms from each writer's last snapshot, bucket-summed (the
    fixed-bucket contract makes plain addition correct)."""
    last: Dict[Tuple, Dict[str, Any]] = {}
    for s in snaps:
        if s.get("hists"):
            last[_writer_key(s)] = s["hists"]
    out: Dict[str, Dict[str, Any]] = {}
    for hists in last.values():
        for name, h in hists.items():
            cur = out.get(name)
            if cur is None or list(cur["bounds"]) != list(h["bounds"]):
                if cur is not None:
                    continue  # mismatched bounds: keep the first writer's
                out[name] = {
                    "bounds": list(h["bounds"]),
                    "counts": list(h["counts"]),
                    "sum": float(h.get("sum", 0.0)),
                    "count": int(h.get("count", 0)),
                }
            else:
                cur["counts"] = [
                    a + b for a, b in zip(cur["counts"], h["counts"])
                ]
                cur["sum"] += float(h.get("sum", 0.0))
                cur["count"] += int(h.get("count", 0))
    return out


def _hist_quantile(h: Dict[str, Any], q: float) -> Optional[float]:
    """Quantile over a telemetry-shaped histogram (per-bucket counts +
    overflow): build the cumulative series and defer to the ONE quantile
    convention in `metrics_http.histogram_quantile`."""
    from sparse_coding__tpu_torch.telemetry.metrics_http import histogram_quantile

    cumulative: List[float] = []
    cum = 0.0
    for n in h["counts"][: len(h["bounds"])]:
        cum += n
        cumulative.append(cum)
    return histogram_quantile({
        "bounds": list(h["bounds"]),
        "cumulative": cumulative,
        "count": sum(h["counts"]),
    }, q)


def _counter_at(snaps, key: str, t: float) -> float:
    """Summed cumulative counter value at time ``t``: each writer's latest
    snapshot at-or-before ``t`` (0 for writers with none yet)."""
    last: Dict[Tuple, float] = {}
    for s in snaps:
        ts = _num(s.get("ts"))
        if ts is None or ts > t:
            continue
        v = _num((s.get("counters") or {}).get(key))
        if v is not None:
            last[_writer_key(s)] = v
    return sum(last.values())


def _availability(obj, counters) -> Dict[str, Any]:
    good_key = obj.get("good_counter", "serve.requests")
    bad_key = obj.get("bad_counter", "serve.errors")
    good = counters.get(good_key, 0.0)
    bad = counters.get(bad_key, 0.0)
    total = good + bad
    target = float(obj["target"])
    budget = 1.0 - target
    if total <= 0:
        return {"ok": None, "measured": None, "target": target,
                "detail": f"no traffic ({good_key}+{bad_key} == 0)"}
    measured = good / total
    consumed = ((1.0 - measured) / budget) if budget > 0 else (
        0.0 if measured >= 1.0 else float("inf")
    )
    return {
        "ok": consumed <= 1.0,
        "measured": round(measured, 6),
        "target": target,
        "budget_consumed_frac": round(consumed, 4),
        "detail": f"{int(bad)} bad / {int(total)} total "
                  f"({good_key} vs {bad_key})",
    }


def _burn_rates(obj, snaps, windows) -> Dict[str, Optional[float]]:
    """Fast/slow window burn rates for an availability objective from
    snapshot deltas. None when the log doesn't cover the window (a short
    run can't pretend to know its hour-long burn)."""
    good_key = obj.get("good_counter", "serve.requests")
    bad_key = obj.get("bad_counter", "serve.errors")
    budget = 1.0 - float(obj["target"])
    ts = [t for t in (_num(s.get("ts")) for s in snaps) if t is not None]
    out: Dict[str, Optional[float]] = {}
    for label, wkey in (("fast", "fast_burn_seconds"),
                        ("slow", "slow_burn_seconds")):
        w = float(windows[wkey])
        if not ts or budget <= 0:
            out[label] = None
            continue
        t_end = max(ts)
        t0 = t_end - w
        span = t_end - min(ts)
        if span <= 0:
            out[label] = None
            continue
        # baseline 0 when the run is younger than the window: the window's
        # delta is then the whole run — honest, and flagged via `covered`
        d_good = _counter_at(snaps, good_key, t_end) - _counter_at(snaps, good_key, t0)
        d_bad = _counter_at(snaps, bad_key, t_end) - _counter_at(snaps, bad_key, t0)
        total = d_good + d_bad
        if total <= 0:
            out[label] = 0.0
            continue
        out[label] = round((d_bad / total) / budget, 4)
        if span < w:
            out[f"{label}_window_covered"] = False
    return out


def _series_burn_rates(obj, store, windows, clean) -> Dict[str, Optional[float]]:
    """Availability burn rates over tower history: windowed counter
    deltas from the `SeriesStore` instead of snapshot replay. Same
    conventions as `_burn_rates` — None when the store holds no span (a
    single poll can't burn), 0.0 on a quiet window, ``*_window_covered:
    False`` when retention is younger than the window."""
    good_key = clean(obj.get("good_counter", "serve.requests"))
    bad_key = clean(obj.get("bad_counter", "serve.errors"))
    budget = 1.0 - float(obj["target"])
    span = store.span()
    out: Dict[str, Optional[float]] = {}
    for label, wkey in (("fast", "fast_burn_seconds"),
                        ("slow", "slow_burn_seconds")):
        w = float(windows[wkey])
        if span is None or budget <= 0 or span[1] - span[0] <= 0:
            out[label] = None
            continue
        t_end = span[1]
        d_good = store.window_delta(good_key, t_end - w, t_end)
        d_bad = store.window_delta(bad_key, t_end - w, t_end)
        total = d_good + d_bad
        if total <= 0:
            out[label] = 0.0
            continue
        out[label] = round((d_bad / total) / budget, 4)
        if span[1] - span[0] < w:
            out[f"{label}_window_covered"] = False
    return out


def _series_latency_burn(obj, store, windows,
                         clean) -> Dict[str, Optional[float]]:
    """Latency burn rates over tower history — the signal neither the
    run-dir nor the scrape source can produce. The budget is the fraction
    of requests ALLOWED over the threshold (``1 - percentile``); the
    window's bad fraction is read from the bucketwise histogram delta
    (counts in buckets whose upper bound exceeds ``threshold_ms``, plus
    the overflow slot). ≥2 polls make this non-None: one poll has no
    history to delta."""
    threshold = float(obj["threshold_ms"])
    budget = 1.0 - float(obj.get("percentile", 0.99))
    hist_key = clean(obj.get("histogram", "serve.latency_ms"))
    hspan = store.hist_span(hist_key)
    out: Dict[str, Optional[float]] = {}
    for label, wkey in (("fast", "fast_burn_seconds"),
                        ("slow", "slow_burn_seconds")):
        w = float(windows[wkey])
        if hspan is None or budget <= 0 or hspan[1] - hspan[0] <= 0:
            out[label] = None
            continue
        t_end = hspan[1]
        h = store.hist_delta(hist_key, t_end - w, t_end)
        if h is None:
            out[label] = None
            continue
        total = sum(h["counts"])
        if total <= 0:
            out[label] = 0.0
            continue
        bad = sum(
            n for b, n in zip(h["bounds"], h["counts"]) if b > threshold
        ) + sum(h["counts"][len(h["bounds"]):])
        out[label] = round((bad / total) / budget, 4)
        if hspan[1] - hspan[0] < w:
            out[f"{label}_window_covered"] = False
    return out


def _latency(obj, gauges, hists) -> Dict[str, Any]:
    q = float(obj.get("percentile", 0.99))
    threshold = float(obj["threshold_ms"])
    hist_key = obj.get("histogram", "serve.latency_ms")
    h = hists.get(hist_key)
    measured = _hist_quantile(h, q) if h else None
    source = "histogram"
    if measured is None:
        gauge_key = obj.get("gauge", f"serve.latency_p{int(round(q * 100))}_ms")
        measured = gauges.get(gauge_key)
        source = f"gauge {gauge_key}"
    if measured is None:
        return {"ok": None, "measured": None, "threshold_ms": threshold,
                "detail": "no latency histogram or gauge recorded"}
    return {
        "ok": measured <= threshold,
        "measured": round(float(measured), 3),
        "threshold_ms": threshold,
        "detail": f"p{q * 100:g} from {source}",
    }


def _queue_depth(obj, gauges) -> Dict[str, Any]:
    gauge_key = obj.get("gauge", "serve.queue_depth")
    max_depth = float(obj["max_depth"])
    measured = gauges.get(gauge_key)
    if measured is None:
        return {"ok": None, "measured": None, "max_depth": max_depth,
                "detail": f"gauge {gauge_key} not recorded"}
    return {
        "ok": measured <= max_depth,
        "measured": float(measured),
        "max_depth": max_depth,
        "detail": f"gauge {gauge_key}",
    }


def _feature_drift(obj, gauges) -> Dict[str, Any]:
    """Train↔serve drift objective: the serving tier's last flushed drift
    score (PSI scale, `telemetry.feature_stats`) must stay under
    ``max_score``. A tier that never computed a score (feature stats off,
    or no baseline loaded) SKIPs — absence of the sensor is not a pass."""
    gauge_key = obj.get("gauge", "serve.feature.drift_score")
    max_score = float(obj["max_score"])
    measured = gauges.get(gauge_key)
    if measured is None:
        return {"ok": None, "measured": None, "max_score": max_score,
                "detail": f"gauge {gauge_key} not recorded (feature stats "
                          "off or no baseline)"}
    return {
        "ok": measured <= max_score,
        "measured": round(float(measured), 6),
        "max_score": max_score,
        "detail": f"gauge {gauge_key} (PSI scale)",
    }


def _gauge_min(obj, gauges) -> Dict[str, Any]:
    """Floor objective on any gauge: measured must stay at-or-above
    ``min_value``. The canonical use is ``router.live_replicas`` ≥ N —
    the router retries transparently around a SIGKILLed replica, so the
    error counters stay flat while capacity is gone; the liveness gauge
    is the honest availability sensor."""
    gauge_key = obj["gauge"]
    floor = float(obj["min_value"])
    measured = gauges.get(gauge_key)
    if measured is None:
        return {"ok": None, "measured": None, "min_value": floor,
                "detail": f"gauge {gauge_key} not recorded"}
    return {
        "ok": measured >= floor,
        "measured": float(measured),
        "min_value": floor,
        "detail": f"gauge {gauge_key}",
    }


def _goodput_floor(obj, run_dir) -> Dict[str, Any]:
    floor = float(obj["floor_frac"])
    if run_dir is None:
        return {"ok": None, "measured": None, "floor_frac": floor,
                "detail": "goodput needs a run dir (not available live)"}
    from sparse_coding__tpu_torch.telemetry.goodput import build_ledger

    ledger = build_ledger(run_dir)
    frac = ledger.get("goodput_frac")
    if frac is None or not ledger.get("has_spans"):
        return {"ok": None, "measured": None, "floor_frac": floor,
                "detail": "no span-instrumented goodput in this run"}
    return {
        "ok": frac >= floor,
        "measured": round(float(frac), 4),
        "floor_frac": floor,
        "detail": f"ledger over {ledger['wall_seconds']:.1f} s wall",
    }


def _finish(config, source: str, objectives: List[Dict[str, Any]],
            emit_to=None) -> Dict[str, Any]:
    evaluated = [o for o in objectives if o["ok"] is not None]
    failed = [o for o in objectives if o["ok"] is False]
    result = {
        "source": source,
        "objectives": objectives,
        "n_evaluated": len(evaluated),
        "n_failed": len(failed),
        "ok": not failed,
        "verdict": "past_budget" if failed else (
            "within_budget" if evaluated else "no_data"
        ),
    }
    if emit_to is not None:
        for o in failed:
            emit_to.counter_inc("slo.violations")
            emit_to.event(
                "slo_violation",
                kind="slo_violation",
                objective=o["name"],
                objective_type=o["type"],
                measured=o.get("measured"),
                detail=o.get("detail"),
                budget_consumed_frac=o.get("budget_consumed_frac"),
            )
    return result


def evaluate_run_dir(run_dir, config: Dict[str, Any],
                     emit_to=None) -> Dict[str, Any]:
    """Evaluate every objective over a run directory's snapshots + ledger.
    ``emit_to`` (a RunTelemetry) receives ``slo_violation`` events for
    failures."""
    snaps = _snapshots(run_dir)
    counters = _merged_last(snaps, "counters")
    gauges = _merged_last(snaps, "gauges")
    hists = _merged_hists(snaps)
    windows = config.get("windows", DEFAULT_WINDOWS)
    out: List[Dict[str, Any]] = []
    for obj in config["objectives"]:
        typ = obj.get("type")
        base = {"name": obj.get("name", typ), "type": typ}
        if typ == "availability":
            r = _availability(obj, counters)
            if r["ok"] is not None:
                r["burn_rates"] = _burn_rates(obj, snaps, windows)
        elif typ == "latency":
            r = _latency(obj, gauges, hists)
        elif typ == "queue_depth":
            r = _queue_depth(obj, gauges)
        elif typ == "feature-drift":
            r = _feature_drift(obj, gauges)
        elif typ == "gauge_min":
            r = _gauge_min(obj, gauges)
        elif typ == "goodput_floor":
            r = _goodput_floor(obj, run_dir)
        else:
            r = {"ok": None, "measured": None,
                 "detail": f"unknown objective type {typ!r}"}
        out.append({**base, **r})
    return _finish(config, f"run_dir:{run_dir}", out, emit_to=emit_to)


def evaluate_scrape(urls: List[str], config: Dict[str, Any],
                    emit_to=None, timeout: float = 3.0) -> Dict[str, Any]:
    """Evaluate objectives against live ``/metrics`` endpoints, merged
    across replicas (counters and histogram buckets sum; gauges take the
    worst — max — value). Burn rates need history and are not computed
    from a single scrape."""
    from sparse_coding__tpu_torch.telemetry import metrics_http as mh

    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Dict[str, Any]] = {}
    for url in urls:
        fams = mh.scrape(url, timeout=timeout)
        for name, samples in fams.items():
            total = sum(v for _, v in samples)
            if name.endswith("_total"):
                key = name[len(mh.PREFIX):-len("_total")]
                counters[key] = counters.get(key, 0.0) + total
            elif not name.endswith(("_bucket", "_sum", "_count")):
                key = name[len(mh.PREFIX):]
                worst = max(v for _, v in samples)
                gauges[key] = max(gauges.get(key, float("-inf")), worst)
        for obj in config["objectives"]:
            if obj.get("type") != "latency":
                continue
            key = obj.get("histogram", "serve.latency_ms")
            h = mh.histogram_from_families(fams, key)
            if h is None or not h["cumulative"]:
                # absent, or a degenerate exposition with only the +Inf
                # bucket: nothing to merge — degrade to the gauge fallback
                # rather than killing the whole evaluation
                continue
            counts = [h["cumulative"][0]] + [
                b - a for a, b in zip(h["cumulative"], h["cumulative"][1:])
            ]
            counts.append(h["count"] - h["cumulative"][-1])
            cur = hists.get(key)
            if cur is None:
                hists[key] = {"bounds": h["bounds"], "counts": counts,
                              "sum": h["sum"], "count": h["count"]}
            elif list(cur["bounds"]) == list(h["bounds"]):
                cur["counts"] = [a + b for a, b in zip(cur["counts"], counts)]
                cur["count"] += h["count"]
                cur["sum"] += h["sum"]
    # exposition names are sanitized (dots → underscores): objective keys
    # written against the telemetry names must map through the SAME
    # sanitizer the exporter used
    clean = mh.sanitize_key

    out: List[Dict[str, Any]] = []
    for obj in config["objectives"]:
        typ = obj.get("type")
        base = {"name": obj.get("name", typ), "type": typ}
        if typ == "availability":
            r = _availability({
                **obj,
                "good_counter": clean(obj.get("good_counter", "serve.requests")),
                "bad_counter": clean(obj.get("bad_counter", "serve.errors")),
            }, counters)
        elif typ == "latency":
            q = float(obj.get("percentile", 0.99))
            r = _latency({
                **obj,
                "gauge": clean(obj.get(
                    "gauge", f"serve.latency_p{int(round(q * 100))}_ms"
                )),
            }, gauges, hists)
        elif typ == "queue_depth":
            r = _queue_depth(
                {**obj, "gauge": clean(obj.get("gauge", "serve.queue_depth"))},
                gauges,
            )
        elif typ == "feature-drift":
            r = _feature_drift(
                {**obj, "gauge": clean(
                    obj.get("gauge", "serve.feature.drift_score")
                )},
                gauges,
            )
        elif typ == "gauge_min":
            r = _gauge_min({**obj, "gauge": clean(obj["gauge"])}, gauges)
        elif typ == "goodput_floor":
            r = _goodput_floor(obj, None)
        else:
            r = {"ok": None, "measured": None,
                 "detail": f"unknown objective type {typ!r}"}
        out.append({**base, **r})
    return _finish(config, f"scrape:{','.join(urls)}", out, emit_to=emit_to)


def evaluate_series(store_or_dir, config: Dict[str, Any],
                    emit_to=None) -> Dict[str, Any]:
    """Evaluate objectives over control-tower history — a `SeriesStore`
    (duck-typed) or a tower directory whose ``series.jsonl`` is replayed
    via `telemetry.tower.load_store`.

    This is the source that closes the gap the scrape source documents:
    burn rates need history, and the tower HAS history. Availability burn
    comes from windowed counter deltas, latency burn from windowed
    histogram deltas (`_series_latency_burn`) — both real on live tiers
    after ≥2 polls. ``goodput_floor`` reads the tower's live
    ``train.goodput_frac`` gauge (the span-tail approximation, not the
    offline ledger). Keys in the store are exposition-sanitized, so
    objective keys map through the same sanitizer the exporter used;
    per-target series (``label::key``) are excluded — objectives judge
    the merged pool."""
    from sparse_coding__tpu_torch.telemetry import metrics_http as mh

    if hasattr(store_or_dir, "counters_latest"):
        store, label = store_or_dir, "store"
    else:
        from sparse_coding__tpu_torch.telemetry.tower import load_store

        store, label = load_store(store_or_dir), str(store_or_dir)
    from sparse_coding__tpu_torch.telemetry.tower import TARGET_SEP

    def merged(d):
        return {k: v for k, v in d.items() if TARGET_SEP not in k}

    counters = merged(store.counters_latest())
    gauges = merged(store.gauges_latest())
    hists = merged(store.hists_latest())
    windows = config.get("windows", DEFAULT_WINDOWS)
    clean = mh.sanitize_key

    out: List[Dict[str, Any]] = []
    for obj in config["objectives"]:
        typ = obj.get("type")
        base = {"name": obj.get("name", typ), "type": typ}
        if typ == "availability":
            r = _availability({
                **obj,
                "good_counter": clean(obj.get("good_counter", "serve.requests")),
                "bad_counter": clean(obj.get("bad_counter", "serve.errors")),
            }, counters)
            if r["ok"] is not None:
                r["burn_rates"] = _series_burn_rates(obj, store, windows, clean)
        elif typ == "latency":
            q = float(obj.get("percentile", 0.99))
            r = _latency({
                **obj,
                "histogram": clean(obj.get("histogram", "serve.latency_ms")),
                "gauge": clean(obj.get(
                    "gauge", f"serve.latency_p{int(round(q * 100))}_ms"
                )),
            }, gauges, hists)
            if r["ok"] is not None:
                r["burn_rates"] = _series_latency_burn(
                    obj, store, windows, clean)
        elif typ == "queue_depth":
            r = _queue_depth(
                {**obj, "gauge": clean(obj.get("gauge", "serve.queue_depth"))},
                gauges,
            )
        elif typ == "feature-drift":
            r = _feature_drift(
                {**obj, "gauge": clean(
                    obj.get("gauge", "serve.feature.drift_score")
                )},
                gauges,
            )
        elif typ == "gauge_min":
            r = _gauge_min({**obj, "gauge": clean(obj["gauge"])}, gauges)
        elif typ == "goodput_floor":
            floor = float(obj["floor_frac"])
            frac = gauges.get(clean("train.goodput_frac"))
            if frac is None:
                r = {"ok": None, "measured": None, "floor_frac": floor,
                     "detail": "tower has no train.goodput_frac gauge "
                               "(no span-instrumented run dir tailed)"}
            else:
                r = {"ok": frac >= floor,
                     "measured": round(float(frac), 4),
                     "floor_frac": floor,
                     "detail": "tower live goodput (span-tail "
                               "approximation, not the offline ledger)"}
        else:
            r = {"ok": None, "measured": None,
                 "detail": f"unknown objective type {typ!r}"}
        out.append({**base, **r})
    return _finish(config, f"series:{label}", out, emit_to=emit_to)


def evaluate_measured(blob: Dict[str, Any], config: Dict[str, Any],
                      emit_to=None) -> Dict[str, Any]:
    """Evaluate objectives against a loadgen result blob (the client's own
    measurements — `serve.loadgen --slo`). Availability counts the
    clean retryable rejections as neither good nor bad unless the config
    says otherwise (``bad_key``)."""
    out: List[Dict[str, Any]] = []
    for obj in config["objectives"]:
        typ = obj.get("type")
        base = {"name": obj.get("name", typ), "type": typ}
        if typ == "availability":
            good = float(blob.get(obj.get("good_key", "requests"), 0))
            bad = float(blob.get(obj.get("bad_key", "errors"), 0))
            r = _availability(
                {"target": obj["target"], "good_counter": "good",
                 "bad_counter": "bad"},
                {"good": good, "bad": bad},
            )
        elif typ == "latency":
            q = float(obj.get("percentile", 0.99))
            key = f"p{int(round(q * 100))}_ms"
            measured = _num(blob.get(key))
            if measured is None and blob.get("histogram"):
                # loadgen's histogram: [{"le_ms": bound|None, "count": n}]
                total = sum(b["count"] for b in blob["histogram"])
                rank, cum, measured = q * total, 0, float("inf")
                for b in blob["histogram"]:
                    cum += b["count"]
                    if cum >= rank:
                        measured = (
                            float("inf") if b["le_ms"] is None
                            else float(b["le_ms"])
                        )
                        break
            if measured is None:
                r = {"ok": None, "measured": None,
                     "threshold_ms": float(obj["threshold_ms"]),
                     "detail": f"loadgen blob has no {key}"}
            else:
                r = {
                    "ok": measured <= float(obj["threshold_ms"]),
                    "measured": round(measured, 3),
                    "threshold_ms": float(obj["threshold_ms"]),
                    "detail": f"measured client-side ({key})",
                }
        else:
            r = {"ok": None, "measured": None,
                 "detail": f"{typ!r} not measurable from a loadgen blob"}
        out.append({**base, **r})
    return _finish(config, "loadgen", out, emit_to=emit_to)


# -- rendering / CLI ----------------------------------------------------------


def render_slo(result: Dict[str, Any]) -> str:
    lines = [
        f"SLO verdict: **{result['verdict'].upper()}** "
        f"({result['n_evaluated']} objective(s) evaluated, "
        f"{result['n_failed']} failed) — {result['source']}",
        "",
        "| objective | type | measured | target | budget used | burn fast/slow | verdict |",
        "|---|---|---:|---:|---:|---:|---|",
    ]
    for o in result["objectives"]:
        target = o.get("target", o.get("threshold_ms", o.get(
            "max_depth", o.get("floor_frac", o.get(
                "max_score", o.get("min_value"))))))
        burn = o.get("burn_rates") or {}
        burn_s = (
            f"{burn.get('fast', '-')} / {burn.get('slow', '-')}"
            if burn else "-"
        )
        consumed = o.get("budget_consumed_frac")
        verdict = (
            "SKIP" if o["ok"] is None else ("ok" if o["ok"] else "**VIOLATED**")
        )
        lines.append(
            f"| {o['name']} | {o['type']} "
            f"| {'-' if o.get('measured') is None else o['measured']} "
            f"| {target} "
            f"| {'-' if consumed is None else f'{100 * consumed:.1f}%'} "
            f"| {burn_s} | {verdict} |"
        )
    notes = [
        f"  - {o['name']}: {o['detail']}"
        for o in result["objectives"] if o.get("detail")
    ]
    if notes:
        lines.append("")
        lines.extend(notes)
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m sparse_coding__tpu_torch.slo",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("run_dir", nargs="?", default=None,
                    help="run dir to evaluate (omit with --scrape)")
    ap.add_argument("--config", required=True, metavar="slo.json",
                    help="declarative objectives (see module docstring)")
    ap.add_argument("--scrape", nargs="+", default=None, metavar="URL",
                    help="evaluate live /metrics endpoints instead of a "
                    "run dir (merged across replicas)")
    ap.add_argument("--tower", default=None, metavar="DIR",
                    help="evaluate control-tower history (DIR/series.jsonl "
                    "replay) — burn rates are real on live tiers")
    ap.add_argument("--events", default=None, metavar="DIR",
                    help="append slo_violation events + a verdict snapshot "
                    "to DIR/slo_events.jsonl")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    n_sources = sum(
        x is not None for x in (args.run_dir, args.scrape, args.tower)
    )
    if n_sources == 0:
        ap.error("need a run_dir, --scrape URL..., or --tower DIR")
    if n_sources > 1:
        # silently preferring one source would change the verdict's meaning
        # (burn-rate and goodput semantics differ per source)
        ap.error("run_dir, --scrape and --tower are exclusive — pass one")
    config = load_config(args.config)

    emit_to = None
    if args.events:
        from sparse_coding__tpu_torch.telemetry.events import RunTelemetry

        emit_to = RunTelemetry(out_dir=args.events, run_name="slo",
                               file_name="slo_events.jsonl")
        emit_to.run_start(config=config)
    try:
        if args.scrape:
            result = evaluate_scrape(args.scrape, config, emit_to=emit_to)
        elif args.tower:
            if not Path(args.tower).is_dir():
                print(f"tower dir {args.tower} does not exist")
                return 3
            result = evaluate_series(args.tower, config, emit_to=emit_to)
        else:
            if not Path(args.run_dir).is_dir():
                print(f"run dir {args.run_dir} does not exist")
                return 3
            result = evaluate_run_dir(args.run_dir, config, emit_to=emit_to)
    finally:
        if emit_to is not None:
            emit_to.close()
    if args.json:
        print(json.dumps(result, indent=1))
    else:
        print(render_slo(result))
    if result["verdict"] == "no_data":
        return 3
    return 0 if result["ok"] else 1
