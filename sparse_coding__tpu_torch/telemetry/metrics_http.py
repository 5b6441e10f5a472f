"""Prometheus text exposition of the telemetry bus, and its read side.

Counterpart of the JAX package's `telemetry/metrics_http.py`, in its format:
counters as ``sc_<name>_total``, gauges as ``sc_<name>``, histograms as
cumulative ``sc_<name>_bucket{le=...}`` series with ``_sum`` / ``_count``;
names sanitized (dots become underscores), label values escaped, output
sorted (a golden-file contract: tests/golden/metrics_exposition.txt).
``GET /metrics`` on the serve server and the router renders
`telemetry_metrics_text`; `MetricsServer` / `serve_metrics_server` mount it
for a process with no HTTP API of its own (the replicaset CLI's
``--metrics-port``), and `write_metrics_file` publishes it to a file.

`parse_prometheus` / `scrape` are the read side: exposition text back into
``{name: [(labels, value), ...]}`` families, with `family_value`,
`histogram_from_families` and `histogram_quantile` merging them across
writers and recovering latency quantiles from the bucket series.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["PREFIX", "CONTENT_TYPE", "sanitize_key", "metric_name", "render_prometheus", "telemetry_metrics_text",
           "write_metrics_file", "parse_prometheus", "scrape", "family_value", "histogram_from_families",
           "histogram_quantile", "MetricsServer", "serve_metrics_server"]

Families = Dict[str, List[Tuple[Dict[str, str], float]]]

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


def write_metrics_file(telemetry, path) -> Path:
    """Atomically publish a telemetry handle's exposition text to ``path``
    (same-dir temp + ``os.replace``: a reader never sees a torn file)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.parent / f".{p.name}.tmp"
    tmp.write_text(telemetry_metrics_text(telemetry))
    os.replace(tmp, p)
    return p


# -- the read side ------------------------------------------------------------

_SAMPLE_RE = re.compile(r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)\s*$")
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
_UNESCAPE_RE = re.compile(r"\\(.)")
_UNESCAPES = {"n": "\n", "\\": "\\", '"': '"'}


def _unescape_label(v: str) -> str:
    # one left-to-right scan: chained replaces would corrupt a literal
    # backslash followed by 'n'
    return _UNESCAPE_RE.sub(lambda m: _UNESCAPES.get(m.group(1), m.group(1)), v)


def parse_prometheus(text: str) -> Families:
    """Exposition text to ``{metric_name: [(labels, value), ...]}``. Comments
    and lines that do not parse are skipped (a scraper tolerates foreign
    families)."""
    out: Families = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        labels = {k: _unescape_label(v) for k, v in _LABEL_RE.findall(m.group("labels") or "")}
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        out.setdefault(m.group("name"), []).append((labels, value))
    return out


def scrape(url: str, timeout: float = 3.0) -> Families:
    """GET a ``/metrics`` endpoint and parse it; a bare server base URL gets
    ``/metrics`` appended."""
    u = url.rstrip("/")
    if not u.endswith("/metrics"):
        u += "/metrics"
    with urllib.request.urlopen(u, timeout=timeout) as resp:
        return parse_prometheus(resp.read().decode("utf-8", errors="replace"))


def family_value(families: Families, key: str, suffix: str = "", default: Optional[float] = None) -> Optional[float]:
    """Sum of a family's samples across label sets (a counter scraped from
    several writers)."""
    samples = families.get(metric_name(key, suffix))
    if not samples:
        return default
    return sum(v for _, v in samples)


def histogram_from_families(families: Families, key: str) -> Optional[Dict[str, Any]]:
    """One histogram from its ``_bucket`` / ``_sum`` / ``_count`` series, the
    bucket counts summed across label sets (N replicas merge into one
    tier-wide histogram); None when absent."""
    buckets = families.get(metric_name(key) + "_bucket")
    if not buckets:
        return None
    by_le: Dict[float, float] = {}
    for labels, v in buckets:
        le = labels.get("le", "+Inf")
        bound = float("inf") if le == "+Inf" else float(le)
        by_le[bound] = by_le.get(bound, 0.0) + v
    bounds = sorted(b for b in by_le if b != float("inf"))
    return {"bounds": bounds, "cumulative": [by_le[b] for b in bounds],
            "count": by_le.get(float("inf"), max(by_le.values()) if by_le else 0.0),
            "sum": family_value(families, key, "_sum", 0.0)}


def histogram_quantile(hist: Dict[str, Any], q: float) -> Optional[float]:
    """The conservative bucket quantile: the upper bound of the first bucket
    whose cumulative count reaches ``q * count`` (the true quantile lies
    within one bucket below it)."""
    count = hist.get("count") or 0
    if count <= 0:
        return None
    rank = q * count
    for bound, cum in zip(hist["bounds"], hist["cumulative"]):
        if cum >= rank:
            return float(bound)
    return float("inf")


# -- the stand-alone listener -------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by design
        pass

    def _send(self, status: int, content_type: str, body: bytes) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path != "/metrics":
            self._send(404, "application/json", json.dumps({"error": f"no route {self.path}"}).encode())
            return
        try:
            body = self.server.render().encode()
        except Exception as e:  # the exporter never takes its process down
            body = f"# render failed: {e!r}\n".encode()
        self._send(200, CONTENT_TYPE, body)


class MetricsServer:
    """A small stand-alone ``GET /metrics`` listener for a process with no
    HTTP API of its own, or a fake scrape endpoint in tests. ``render`` is
    any () -> str callable."""

    def __init__(self, render: Callable[[], str], host: str = "127.0.0.1", port: int = 0):
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.render = render
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "MetricsServer":
        if self._thread is None:
            self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True, name="metrics-http")
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False


def serve_metrics_server(telemetry, host: str = "127.0.0.1", port: int = 0) -> MetricsServer:
    """A started `MetricsServer` exporting one telemetry handle."""
    return MetricsServer(lambda: telemetry_metrics_text(telemetry), host=host, port=port).start()
