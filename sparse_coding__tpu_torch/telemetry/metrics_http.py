"""Prometheus text exposition of the telemetry bus.

Counterpart of the exposition half of the JAX package's
`telemetry/metrics_http.py`, in its format: counters as ``sc_<name>_total``,
gauges as ``sc_<name>``, histograms as cumulative ``sc_<name>_bucket{le=...}``
series with ``_sum`` / ``_count``; names sanitized (dots become
underscores), label values escaped, output sorted. ``GET /metrics`` on the
serve server renders `telemetry_metrics_text`. The read side (`scrape`,
`parse_prometheus`), the stand-alone scrape server and the metrics-file
writer are not ported yet (ROADMAP A9) and raise.
"""

from __future__ import annotations

import re
import time
from typing import Any, Dict, List, Optional

__all__ = ["PREFIX", "CONTENT_TYPE", "sanitize_key", "metric_name", "render_prometheus", "telemetry_metrics_text",
           "scrape", "parse_prometheus", "serve_metrics_server", "write_metrics_file"]

PREFIX = "sc_"
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_key(key: str) -> str:
    """Telemetry key to an exposition-safe name fragment."""
    return _NAME_RE.sub("_", str(key))


def metric_name(key: str, suffix: str = "") -> str:
    """``serve.requests`` → ``sc_serve_requests`` + ``suffix``."""
    return PREFIX + sanitize_key(key) + suffix


def _escape_label(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _labels_str(labels: Optional[Dict[str, Any]], extra: Optional[Dict[str, Any]] = None) -> str:
    merged: Dict[str, Any] = {**(labels or {}), **(extra or {})}
    if not merged:
        return ""
    return "{" + ",".join(f'{_NAME_RE.sub("_", str(k))}="{_escape_label(v)}"' for k, v in sorted(merged.items())) + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(counters: Optional[Dict[str, float]] = None, gauges: Optional[Dict[str, float]] = None,
                      hists: Optional[Dict[str, Dict[str, Any]]] = None,
                      labels: Optional[Dict[str, Any]] = None) -> str:
    """The exposition text of one writer's counters, gauges and histograms
    (`RunTelemetry.hists` dicts), sorted by name: byte-stable for fixed inputs."""
    lines: List[str] = []
    for key, v in sorted((counters or {}).items()):
        name = metric_name(key, "_total")
        lines += [f"# TYPE {name} counter", f"{name}{_labels_str(labels)} {_fmt_value(v)}"]
    for key, v in sorted((gauges or {}).items()):
        name = metric_name(key)
        lines += [f"# TYPE {name} gauge", f"{name}{_labels_str(labels)} {_fmt_value(v)}"]
    for key, h in sorted((hists or {}).items()):
        name = metric_name(key)
        lines.append(f"# TYPE {name} histogram")
        cum = 0
        for bound, n in zip(h["bounds"], h["counts"]):
            cum += int(n)
            lines.append(f"{name}_bucket{_labels_str(labels, {'le': _fmt_value(bound)})} {cum}")
        cum += int(h["counts"][len(h["bounds"])])
        lines.append(f"{name}_bucket{_labels_str(labels, {'le': '+Inf'})} {cum}")
        lines.append(f"{name}_sum{_labels_str(labels)} {_fmt_value(h['sum'])}")
        lines.append(f"{name}_count{_labels_str(labels)} {cum}")
    return "\n".join(lines) + ("\n" if lines else "")


def telemetry_metrics_text(telemetry, uptime: bool = True) -> str:
    """One live `RunTelemetry`'s exposition (its ``tags`` as labels on every
    series; ``sc_uptime_seconds`` rides along)."""
    gauges = dict(telemetry.gauges)
    if uptime:
        gauges["uptime_seconds"] = round(time.time() - telemetry._t0, 3)
    return render_prometheus(counters=telemetry.counters, gauges=gauges, hists=telemetry.hists,
                             labels=telemetry.tags or None)


def _not_ported(*_a, **_k):
    raise NotImplementedError("the metrics scrape side, scrape server and metrics files are not ported yet — "
                              "ROADMAP A9")


scrape = parse_prometheus = serve_metrics_server = write_metrics_file = _not_ported
