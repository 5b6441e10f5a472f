"""Stdlib HTTP front end for the encode engine, with graceful SIGTERM drain.

Counterpart of the JAX package's `serve/server.py`, with its API::

    python -m sparse_coding__tpu_torch.serve.server <export> [--port 0] [--device cpu] ...

loads learned-dict exports into a `DictRegistry` on the card (``--device
cpu`` runs on the CPU; without a card and without it, it raises), captures
the engine's dispatch graphs, and serves:

  - ``POST /encode``: ``{"dict": "<id>", "rows": [[...], ...]}`` → codes, or
    with ``"top_k": k`` sparse ``indices`` + ``values``. Unknown dict →
    404; malformed body or rows → 400; draining → **503 with Retry-After
    and ``{"retryable": true}``**. Bodies and responses ride json, npz or
    raw (`serve.wire`): ``Content-Type`` names the request's format,
    ``Accept`` picks the response's; dtypes travel exactly.
  - ``POST /features``: int ``tokens`` (or ``texts``, which need a
    tokenizer) through the attached subject's capture forward, then the
    dict's encode: codes (dense or top-k) for every token position.
  - ``GET /dicts`` (registry and subjects), ``GET /healthz``, ``GET
    /metrics`` (Prometheus text).

A response's meta carries ``bucket``: the dispatch's padded row count, at
which `EncodeEngine.encode_naive` reproduces its codes bit for bit.

**Drain protocol**: SIGTERM/SIGINT set `train.preemption`'s flag; the serve
loop polls it, then (1) flips the engine to rejecting (new requests get
the retryable 503), (2) completes every request already accepted
(`EncodeEngine.stop(drain=True)`), (3) shuts the listener and exits 0. A
request is never dropped: it returns 200 with its codes or was never
accepted.

`ServeClient` is the stdlib client; `ServeServer` runs the server in
process on an ephemeral port.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from sparse_coding__tpu_torch.serve.engine import EncodeEngine, EngineClosed
from sparse_coding__tpu_torch.serve.registry import DictRegistry

__all__ = ["ServeServer", "ServeClient", "RetryableRejection", "attach_subject_from_spec", "main"]


class _Handler(BaseHTTPRequestHandler):
    # the ThreadingHTTPServer instance carries .serve (ServeServer)
    protocol_version = "HTTP/1.1"
    # an idle keep-alive connection gives its handler up after this long, so
    # closing the listener (which joins every handler) never waits on one
    timeout = 30

    def log_message(self, fmt, *args):  # stdlib default spams stderr
        if self.server.serve.verbose:
            sys.stderr.write(f"[serve] {fmt % args}\n")

    def _json(self, code: int, payload: Dict[str, Any], headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reject_draining(self) -> None:
        self._json(503, {"error": "draining", "retryable": True,
                         "detail": "server is draining for shutdown — retry elsewhere"},
                   headers={"Retry-After": "1"})

    def do_GET(self):
        srv = self.server.serve
        if self.path == "/healthz":
            self._json(200, srv.health())
            return
        if self.path == "/dicts":
            self._json(200, {"dicts": srv.registry.describe(), "subjects": srv.registry.describe_subjects()})
            return
        if self.path == "/metrics":
            from sparse_coding__tpu_torch.telemetry.metrics_http import CONTENT_TYPE

            body = srv.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self._json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        srv = self.server.serve
        if self.path not in ("/encode", "/features"):
            self._json(404, {"error": f"no route {self.path}"})
            return
        if srv.draining:
            self._reject_draining()
            return
        from sparse_coding__tpu_torch.serve import wire
        from sparse_coding__tpu_torch.telemetry.tracing import TraceContext

        fmt_in = wire.format_of_content_type(self.headers.get("Content-Type"))
        fmt_out = wire.negotiate(self.headers.get("Accept"))
        try:
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)
            arrays, meta = wire.decode_payload(fmt_in, raw)
            dict_id = meta["dict"]
            top_k = meta.get("top_k")
            if top_k is not None:
                top_k = int(top_k)
        except (ValueError, KeyError, TypeError) as e:
            self._json(400, {"error": f"bad request: {e}"})
            return
        # an X-Trace-Id'd request gets a server-hop span parented on the
        # caller's X-Parent-Span, threaded into the engine's request_trace
        trace = TraceContext.from_headers(self.headers)
        trace_headers = {"X-Trace-Id": trace.trace_id} if trace is not None else None
        t0 = time.monotonic()
        try:
            if self.path == "/features":
                tokens = self._feature_tokens(srv, arrays, meta)
                req = srv.engine.submit_features(dict_id, tokens, subject=meta.get("subject"), trace=trace,
                                                 top_k=top_k)
            else:
                rows = arrays.get("rows")
                if rows is None:
                    rows = meta.get("rows")  # plain-JSON compat (no __dtypes__)
                if rows is None:
                    raise ValueError("request carries no 'rows'")
                req = srv.engine.submit(dict_id, rows, trace=trace, top_k=top_k)
            out = req.result(srv.request_timeout)
        except EngineClosed:
            self._reject_draining()
            return
        except KeyError as e:
            self._json(404, {"error": f"unknown dict or subject: {e}", "dicts": srv.registry.ids(),
                             "subjects": srv.registry.subjects()}, headers=trace_headers)
            return
        except (ValueError, TypeError) as e:
            self._json(400, {"error": str(e)}, headers=trace_headers)
            return
        except TimeoutError as e:
            self._json(504, {"error": str(e), "retryable": True}, headers=trace_headers)
            return
        if top_k is None:
            out_arrays = {"codes": out}
            n_rows = int(out.shape[0])
        else:
            idx, vals = out
            out_arrays = {"indices": idx, "values": vals}
            n_rows = int(vals.shape[0])
        out_meta = {"dict": dict_id, "n_rows": n_rows, "latency_ms": round((time.monotonic() - t0) * 1e3, 3),
                    "generation": srv.dict_generation, "bucket": req.bucket}
        if top_k is not None:
            out_meta["sparse"] = True
            out_meta["k"] = int(vals.shape[1])
        if trace is not None:
            out_meta["trace_id"] = trace.trace_id
        body = wire.encode_payload(fmt_out, out_arrays, out_meta)
        # booked before the write: a client that has read the response sees
        # it counted
        srv.note_wire(self.path, fmt_in, fmt_out, len(raw), len(body), out_meta["latency_ms"])
        self.send_response(200)
        self.send_header("Content-Type", wire.CONTENT_TYPES[fmt_out])
        self.send_header("Content-Length", str(len(body)))
        for k, v in (trace_headers or {}).items():
            self.send_header(k, v)
        prov = srv.registry.provenance_digest()
        if prov:
            self.send_header("X-Dict-Provenance", prov)
        self.end_headers()
        self.wfile.write(body)

    @staticmethod
    def _feature_tokens(srv, arrays, meta):
        """Token rows of a /features request: int ``tokens`` in any wire
        format, or ``texts`` through the subject's tokenizer with the
        harvest's EOS-joined exact-length chunking."""
        tokens = arrays.get("tokens")
        if tokens is None:
            tokens = meta.get("tokens")  # plain-JSON compat
        if tokens is not None:
            return tokens
        texts = meta.get("texts")
        if texts is None:
            raise ValueError("request carries neither 'tokens' nor 'texts'")
        subj = srv.registry.get_subject(meta.get("subject"))
        if subj.tokenize is None:
            raise ValueError(f"subject {subj.subject_id!r} has no tokenizer attached — send 'tokens' instead of "
                             "'texts'")
        from sparse_coding__tpu_torch.data.activations import chunk_and_tokenize_texts

        toks = chunk_and_tokenize_texts([str(t) for t in texts], subj.tokenize, eos_id=int(meta.get("eos_id", 0)),
                                        max_length=int(meta.get("seq_len", 128)))
        if toks.shape[0] == 0:
            raise ValueError("texts tokenized to fewer than seq_len tokens — nothing to encode (send more text or "
                             "a smaller 'seq_len')")
        return toks


class ServeServer:
    """The serving process object: registry + engine + HTTP listener.

    In-process use::

        with ServeServer(registry) as srv:
            codes = srv.client().encode("d0", rows)

    Process use: `main`, which adds the SIGTERM drain loop.
    """

    def __init__(self, registry: DictRegistry, host: str = "127.0.0.1", port: int = 0,
                 engine: Optional[EncodeEngine] = None, telemetry=None, request_timeout: float = 60.0,
                 verbose: bool = False, dict_generation: int = 0, replica_id: Optional[str] = None,
                 feature_baseline=None, feature_flush_s: float = 30.0, drift_policy=None, **engine_kwargs):
        self.registry = registry
        self.telemetry = telemetry
        self.engine = engine or EncodeEngine(registry, telemetry=telemetry, **engine_kwargs)
        self.request_timeout = float(request_timeout)
        self.verbose = verbose
        # the engine's firing sketch (``feature_stats=True``) flushes on
        # scrapes and at the drain, at least `feature_flush_s` apart, and is
        # drift-checked against `feature_baseline` through an AnomalyGuard;
        # an abort-tier drift sets `drift_abort_requested` (main drains on it)
        self.feature_flush_s = float(feature_flush_s)
        self.feature_guard = None
        self.drift_abort_requested = False
        fs = getattr(self.engine, "feature_stats", None)
        if fs is not None:
            from sparse_coding__tpu_torch.telemetry.anomaly import AnomalyGuard
            from sparse_coding__tpu_torch.telemetry.feature_stats import FeatureSnapshot

            if feature_baseline is not None:
                if not isinstance(feature_baseline, FeatureSnapshot):
                    feature_baseline = FeatureSnapshot.load(feature_baseline)
                fs.set_baseline(feature_baseline)
            out_dir = telemetry.path.parent if telemetry is not None and telemetry.path is not None else None
            self.feature_guard = AnomalyGuard(telemetry=telemetry, out_dir=out_dir, policy=drift_policy,
                                              model_names=registry.ids())
        # the dict rollout generation this replica serves, stamped into every
        # response
        self.dict_generation = int(dict_generation)
        self.replica_id = replica_id
        self.draining = False
        # bytes and requests per wire format (bytes_in under the request's
        # format, the rest under the response's, as the counters book them)
        self._wire_lock = threading.Lock()
        self.wire_stats: Dict[str, Dict[str, float]] = {}
        self._t0 = time.time()
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        # handlers are joined when the listener closes: a response accepted
        # before the drain is written out before the process exits
        self.httpd.daemon_threads = False
        self.httpd.serve = self  # handler back-reference
        self._http_thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ServeServer":
        self.engine.start()
        self._http_thread = threading.Thread(target=self.httpd.serve_forever, daemon=True, name="serve-http")
        self._http_thread.start()
        return self

    def note_wire(self, endpoint: str, fmt_in: str, fmt_out: str, bytes_in: int, bytes_out: int,
                  latency_ms: float) -> None:
        """Per-format wire accounting of one answered request."""
        with self._wire_lock:
            def _slot(fmt):
                return self.wire_stats.setdefault(fmt, {"requests": 0, "bytes_in": 0, "bytes_out": 0})

            out_slot = _slot(fmt_out)
            out_slot["requests"] += 1
            out_slot["bytes_out"] += int(bytes_out)
            _slot(fmt_in)["bytes_in"] += int(bytes_in)
        if self.telemetry is not None:
            self.telemetry.counter_inc(f"serve.requests.{fmt_out}")
            self.telemetry.counter_inc(f"serve.bytes_in.{fmt_in}", int(bytes_in))
            self.telemetry.counter_inc(f"serve.bytes_out.{fmt_out}", int(bytes_out))
            self.telemetry.hist_observe(f"serve.format.{fmt_out}.latency_ms", float(latency_ms))

    def health(self) -> Dict[str, Any]:
        """The healthz body: queue depth, batch occupancy, the registry and
        dict generations, the draining flag, counts and latency."""
        lat = self.engine.latency_snapshot()
        stats = self.engine.stats
        out = {
            "status": "draining" if self.draining else "ok", "draining": self.draining,
            "dicts": len(self.registry), "queue_depth": self.engine.queue_depth,
            "batch_occupancy": self.engine.batch_occupancy, "registry_generation": self.registry.generation,
            "dict_generation": self.dict_generation, "requests": stats["requests"], "rejected": stats["rejected"],
            "errors": stats["errors"], "uptime_seconds": round(time.time() - self._t0, 3),
            "latency_p50_ms": round(lat["p50_ms"], 3), "latency_p99_ms": round(lat["p99_ms"], 3),
            "subjects": self.registry.subjects(), "dict_provenance": self.registry.provenance_digest(),
            "captures": self.engine.captures,
        }
        if self.replica_id is not None:
            out["replica"] = self.replica_id
        return out

    def maybe_flush_features(self, force: bool = False) -> List[Dict[str, Any]]:
        """Flush the engine's firing sketch into ``feature_stats.serveNNNN.npz``
        snapshots and run the drift check: when the engine carries one, a
        run dir exists, and `feature_flush_s` passed since the last flush
        (``force`` overrides the interval)."""
        fs = getattr(self.engine, "feature_stats", None)
        if fs is None or self.telemetry is None or self.telemetry.path is None:
            return []
        if not force and fs.seconds_since_flush < self.feature_flush_s:
            return []
        extra: Dict[str, Any] = {"dict_generation": self.dict_generation}
        if self.replica_id is not None:
            extra["replica"] = self.replica_id
        summaries = fs.flush(self.telemetry, self.telemetry.path.parent, extra=extra)
        if self.feature_guard is not None:
            from sparse_coding__tpu_torch.telemetry.anomaly import AnomalyAbort

            for s in summaries:
                if "drift_score" not in s:
                    continue
                try:
                    self.feature_guard.observe_feature_drift(
                        s["drift_score"], top=s.get("drift_top"), scope="serve",
                        baseline=fs.baseline.gen if fs.baseline else None, current=s["gen"])
                except AnomalyAbort:
                    # never raise into a scrape or drain: the serve loop drains
                    self.drift_abort_requested = True
        return summaries

    def metrics_text(self) -> str:
        """The ``GET /metrics`` body: the telemetry bus with fresh queue and
        occupancy gauges; without telemetry, a minimal set from the
        engine's stats."""
        from sparse_coding__tpu_torch.telemetry.metrics_http import render_prometheus, telemetry_metrics_text

        self.maybe_flush_features()
        if self.telemetry is not None:
            self.telemetry.gauge_set("serve.queue_depth", self.engine.queue_depth)
            self.telemetry.gauge_set("serve.batch_occupancy", self.engine.batch_occupancy)
            self.telemetry.gauge_set("serve.draining", float(self.draining))
            return telemetry_metrics_text(self.telemetry)
        lat = self.engine.latency_snapshot()
        return render_prometheus(
            counters={f"serve.{k}": v for k, v in self.engine.stats.items()},
            gauges={"serve.queue_depth": self.engine.queue_depth, "serve.batch_occupancy": self.engine.batch_occupancy,
                    "serve.latency_p50_ms": lat["p50_ms"], "serve.latency_p95_ms": lat["p95_ms"],
                    "serve.latency_p99_ms": lat["p99_ms"], "serve.draining": float(self.draining)},
            labels={"replica": self.replica_id} if self.replica_id else None)

    def drain(self, timeout: float = 60.0) -> None:
        """Reject new requests (503), complete everything already accepted.
        The listener stays up (503s and health checks) until `close`."""
        self.draining = True
        if self.telemetry is not None:
            self.telemetry.event("serve_drain", queue_depth=self.engine.queue_depth)
        self.engine.stop(drain=True, timeout=timeout)
        self.maybe_flush_features(force=True)

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()

    def stop(self, timeout: float = 60.0) -> None:
        self.drain(timeout=timeout)
        self.close()

    def client(self, timeout: float = 30.0) -> "ServeClient":
        return ServeClient(self.address, timeout=timeout)

    def __enter__(self) -> "ServeServer":
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False


class RetryableRejection(RuntimeError):
    """A clean 503/"draining" hand-back, safe to retry; ``retry_after`` is
    the server's Retry-After hint (seconds, 0.0 when absent)."""

    retry_after: float = 0.0


class ServeClient:
    """Minimal stdlib HTTP client.

    ``retries > 1`` retries clean retryable rejections (draining 503s,
    retryable 504s) through `utils.sync.retry_with_backoff`, the server's
    ``Retry-After`` a floor on each sleep, bumping ``serve.client.retry`` on
    the live telemetry. Connection errors are not retried (against a single
    server they mean it is gone). ``format`` picks the request body's and
    the ``Accept`` wire format; dtypes come back as the server computed
    them; ``top_k=k`` returns ``(indices, values)``. `last_meta` holds the
    latest response's meta (``bucket``, ``generation``, ...) per thread."""

    def __init__(self, base_url: str, timeout: float = 30.0, retries: int = 1, backoff_base: float = 0.05):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.retries = max(1, int(retries))
        self.backoff_base = float(backoff_base)
        self._bytes_lock = threading.Lock()
        self._local = threading.local()
        self.bytes_sent = 0
        self.bytes_received = 0

    @property
    def last_meta(self) -> Optional[Dict[str, Any]]:
        return getattr(self._local, "meta", None)

    def _note_bytes(self, sent: int, received: int) -> None:
        with self._bytes_lock:
            self.bytes_sent += int(sent)
            self.bytes_received += int(received)

    def bytes_snapshot(self) -> Dict[str, int]:
        with self._bytes_lock:
            return {"bytes_sent": self.bytes_sent, "bytes_received": self.bytes_received}

    def _retryable_exc(self, payload: Dict[str, Any], headers: Dict[str, str]) -> RetryableRejection:
        exc = RetryableRejection(payload.get("error", "rejected"))
        try:
            exc.retry_after = float(headers.get("Retry-After", 0) or 0)
        except (TypeError, ValueError):
            exc.retry_after = 0.0
        return exc

    def _request_full(self, method: str, path: str, payload: Optional[Any] = None,
                      headers: Optional[Dict[str, str]] = None, raw: bool = False) -> tuple:
        """One HTTP round trip: (body, response headers). ``payload`` is a
        JSON-able dict or pre-encoded bytes; the success body is parsed JSON
        unless ``raw``; error bodies are JSON."""
        import urllib.error
        import urllib.request

        if isinstance(payload, (bytes, bytearray)):
            data: Optional[bytes] = bytes(payload)
        elif payload is None:
            data = None
        else:
            data = json.dumps(payload).encode()
        req = urllib.request.Request(self.base_url + path, data=data,
                                     headers={"Content-Type": "application/json", **(headers or {})}, method=method)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                body = resp.read()
                self._note_bytes(len(data or b""), len(body))
                if raw:
                    return body, dict(resp.headers.items())
                return json.loads(body), dict(resp.headers.items())
        except urllib.error.HTTPError as e:
            raw_body = e.read()
            self._note_bytes(len(data or b""), len(raw_body))
            try:
                body = json.loads(raw_body)
            except Exception:
                body = {"error": str(e)}
            headers = dict(e.headers.items())
            if e.code in (503, 504) and body.get("retryable"):
                raise self._retryable_exc(body, headers)
            raise RuntimeError(f"HTTP {e.code}: {body.get('error')}") from e

    def _request(self, method: str, path: str, payload: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        return self._request_full(method, path, payload)[0]

    def _with_retries(self, fn):
        if self.retries <= 1:
            return fn()
        from sparse_coding__tpu_torch.telemetry.events import counter_inc_active
        from sparse_coding__tpu_torch.utils.sync import retry_with_backoff

        return retry_with_backoff(lambda _attempt: fn(), attempts=self.retries, base_delay=self.backoff_base,
                                  retry_on=(RetryableRejection,),
                                  on_retry=lambda a, e: counter_inc_active("serve.client.retry"),
                                  delay_floor_from=lambda e: getattr(e, "retry_after", 0.0))

    @staticmethod
    def _trace_headers(trace) -> Optional[Dict[str, str]]:
        """A `TraceContext`, a bare trace id or None, as propagation headers."""
        if trace is None:
            return None
        if isinstance(trace, str):
            from sparse_coding__tpu_torch.telemetry.tracing import TraceContext

            trace = TraceContext(trace)
        return trace.headers()

    def _wire_call(self, path: str, arrays: Dict[str, Any], meta: Dict[str, Any], fmt: str = "json",
                   trace=None) -> tuple:
        """One wire-format POST, the response decoded per its Content-Type:
        (arrays, meta, headers)."""
        from sparse_coding__tpu_torch.serve import wire

        body = wire.encode_payload(fmt, arrays, meta)
        headers = {"Content-Type": wire.CONTENT_TYPES[fmt], "Accept": wire.CONTENT_TYPES[fmt],
                   **(self._trace_headers(trace) or {})}
        out, rheaders = self._with_retries(
            lambda: self._request_full("POST", path, body, headers=headers, raw=True))
        out_arrays, out_meta = wire.decode_payload(wire.format_of_content_type(rheaders.get("Content-Type")), out)
        self._local.meta = out_meta
        return out_arrays, out_meta, rheaders

    @staticmethod
    def _unpack_codes(out_arrays: Dict[str, Any], out_meta: Optional[Dict[str, Any]] = None):
        """Dense codes or ``(indices, values)``; legacy JSON bodies (no
        ``__dtypes__``) fall back to f32."""
        if "codes" in out_arrays:
            return out_arrays["codes"]
        if "indices" in out_arrays:
            return out_arrays["indices"], out_arrays["values"]
        meta = out_meta or {}
        if "codes" in meta:
            return np.asarray(meta["codes"], dtype=np.float32)
        if "indices" in meta:
            return np.asarray(meta["indices"], dtype=np.int32), np.asarray(meta["values"], dtype=np.float32)
        raise KeyError("response carries no codes")

    def encode(self, dict_id: str, rows, trace=None, format: str = "json", top_k: Optional[int] = None):
        meta: Dict[str, Any] = {"dict": dict_id}
        if top_k is not None:
            meta["top_k"] = int(top_k)
        out_arrays, out_meta, _ = self._wire_call("/encode", {"rows": rows}, meta, fmt=format, trace=trace)
        return self._unpack_codes(out_arrays, out_meta)

    def encode_topk(self, dict_id: str, rows, k: int, trace=None, format: str = "json"):
        """Sparse encode: ``(indices int32 [n, k], values [n, k])``."""
        return self.encode(dict_id, rows, trace=trace, format=format, top_k=int(k))

    def encode_features(self, dict_id: str, tokens=None, trace=None, format: str = "json",
                        top_k: Optional[int] = None, subject: Optional[str] = None, texts=None,
                        seq_len: Optional[int] = None):
        """Capture-then-encode of token rows ``[n_seq, seq_len]`` (or
        ``texts``, with a server-side tokenizer): codes for every position."""
        meta: Dict[str, Any] = {"dict": dict_id}
        if top_k is not None:
            meta["top_k"] = int(top_k)
        if subject is not None:
            meta["subject"] = subject
        arrays: Dict[str, Any] = {}
        if tokens is not None:
            arrays["tokens"] = np.asarray(tokens, dtype=np.int32)
        elif texts is not None:
            meta["texts"] = list(texts)
            if seq_len is not None:
                meta["seq_len"] = int(seq_len)
        else:
            raise ValueError("pass tokens or texts")
        out_arrays, out_meta, _ = self._wire_call("/features", arrays, meta, fmt=format, trace=trace)
        return self._unpack_codes(out_arrays, out_meta)

    def dicts(self) -> List[Dict[str, Any]]:
        return self._request("GET", "/dicts")["dicts"]

    def subjects(self) -> List[Dict[str, Any]]:
        return self._request("GET", "/dicts").get("subjects", [])

    def healthz(self) -> Dict[str, Any]:
        return self._request("GET", "/healthz")


def local_tokenizer(path: str):
    """A ``text -> ids`` callable over a tokenizer saved in a local folder,
    loaded on its first call (files only, never the network). It needs the
    `transformers` package: without it a texts request answers 400 naming it."""
    state: Dict[str, Any] = {}

    def tokenize(text: str) -> List[int]:
        if "tok" not in state:
            try:
                import transformers
            except ImportError as e:
                raise ValueError("texts need a tokenizer and the `transformers` package is not installed — "
                                 "send 'tokens' instead") from e
            state["tok"] = transformers.AutoTokenizer.from_pretrained(path, local_files_only=True)
        return state["tok"](text)["input_ids"]

    return tokenize


def attach_subject_from_spec(registry: DictRegistry, spec: str, subject_id: str = "subject", tokenize=None):
    """Attach a subject LM from a CLI spec ``random:<model>:<layer>:<loc>[:seed]``:
    the named architecture (`lm.model.config_for`) initialised from a
    `torch.Generator` on the registry's device seeded ``seed`` (the port's
    stream, not JAX's). Trained weights attach through
    `DictRegistry.attach_subject`."""
    kind, model, layer, rest = (str(spec).split(":", 3) + [""])[:4]
    loc, _, seed = rest.partition(":")
    if kind != "random":
        raise ValueError(f"unknown subject kind {kind!r} (want 'random:...')")
    import torch

    from sparse_coding__tpu_torch.lm import model as lm_model

    lm_cfg = lm_model.config_for(model)
    gen = torch.Generator(device=registry.device).manual_seed(int(seed or 0))
    params = lm_model.init_params(gen, lm_cfg, device=registry.device)
    return registry.attach_subject(subject_id, params, lm_cfg, int(layer), layer_loc=loc or "residual",
                                   tokenize=tokenize, source=spec)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sparse_coding__tpu_torch.serve.server", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("exports", nargs="+", help="learned-dict export(s): learned_dicts.pkl files or directories")
    ap.add_argument("--device", default=None, help="where to serve (default: the CUDA card; 'cpu' for the CPU)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8777, help="0 = ephemeral (see --port-file)")
    ap.add_argument("--port-file", default=None, help="write the bound port here once listening")
    ap.add_argument("--weights", choices=("native", "int8"), default="native",
                    help="weight residency of the loaded dicts (int8: the chunk tier's quantization)")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--events", default=None, metavar="DIR", help="write serve telemetry (events.jsonl) under DIR")
    ap.add_argument("--replica-id", default=None, help="this replica's id (stamped into every telemetry record)")
    ap.add_argument("--dict-generation", type=int, default=0,
                    help="the dict rollout generation this replica serves, stamped into every response")
    ap.add_argument("--no-warmup", action="store_true", help="skip capturing the dispatch menu at startup")
    ap.add_argument("--warmup-topk", type=int, action="append", default=None, metavar="K",
                    help="also capture the top-k dispatch for this k (repeatable); a request's k then "
                         "dispatches at the smallest warmed k-bucket covering it")
    ap.add_argument("--subject", default=None, metavar="SPEC",
                    help="attach a subject LM for POST /features: 'random:<model>:<layer>:<loc>[:seed]'")
    ap.add_argument("--subject-seq-len", type=int, default=32, help="seq_len the /features warmup captures for")
    ap.add_argument("--tokenizer", default=None, metavar="DIR",
                    help="a local tokenizer folder for /features texts (needs `transformers`)")
    ap.add_argument("--feature-stats", action="store_true",
                    help="accumulate the per-feature firing sketch, flushed to feature_stats.serveNNNN.npz")
    ap.add_argument("--feature-baseline", default=None, metavar="NPZ",
                    help="training-baseline feature_stats snapshot to drift-check against (implies --feature-stats)")
    ap.add_argument("--feature-flush-s", type=float, default=30.0, help="min seconds between sketch flushes")
    ap.add_argument("--drift-warn", type=float, default=0.25, help="PSI drift score that warns")
    ap.add_argument("--drift-abort", type=float, default=1.0, help="PSI drift score that drains this replica (exit 1)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    from sparse_coding__tpu_torch.telemetry import RunTelemetry
    from sparse_coding__tpu_torch.telemetry.anomaly import AnomalyPolicy
    from sparse_coding__tpu_torch.train import preemption
    from sparse_coding__tpu_torch.utils.faults import fault_point

    registry = DictRegistry(device=args.device)
    telemetry = RunTelemetry(out_dir=args.events, run_name="serve",
                             tags={"replica": args.replica_id} if args.replica_id else None)
    registry.telemetry = telemetry
    for exp in args.exports:
        ids = registry.load_export(exp, weights=args.weights)
        print(f"[serve] loaded {len(ids)} dict(s) from {exp}: {ids}")
    if args.subject:
        try:
            subj = attach_subject_from_spec(registry, args.subject,
                                            tokenize=local_tokenizer(args.tokenizer) if args.tokenizer else None)
            print(f"[serve] attached subject {args.subject!r} (width {subj.activation_size})")
        except (ValueError, IndexError) as e:
            ap.error(f"bad --subject spec {args.subject!r}: {e}")
    telemetry.run_start(config={
        "exports": list(args.exports), "weights": args.weights, "max_batch": args.max_batch,
        "max_wait_ms": args.max_wait_ms, "dicts": registry.ids(), "replica_id": args.replica_id,
        "dict_generation": args.dict_generation, "subjects": registry.subjects(), "device": str(registry.device),
    })
    feature_stats_on = bool(args.feature_stats or args.feature_baseline)
    srv = ServeServer(
        registry, host=args.host, port=args.port, telemetry=telemetry, max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms, verbose=args.verbose, dict_generation=args.dict_generation,
        replica_id=args.replica_id, feature_stats=feature_stats_on or None, feature_baseline=args.feature_baseline,
        feature_flush_s=args.feature_flush_s,
        drift_policy=AnomalyPolicy(drift_warn=args.drift_warn, drift_abort=args.drift_abort)
        if feature_stats_on else None,
    )
    srv.engine.start()
    if not args.no_warmup:
        n = srv.engine.warmup(topk_ks=args.warmup_topk or ())
        if registry.subjects():
            n += srv.engine.warmup_features(args.subject_seq_len, topk_ks=args.warmup_topk or ())
        print(f"[serve] warmed {n} dispatch(es), {srv.engine.captures} graph capture(s)")
    srv.start()
    if args.port_file:
        Path(args.port_file).write_text(str(srv.port))
    print(f"[serve] listening on {srv.address} ({len(registry)} dict(s), max_batch {args.max_batch}, "
          f"device {registry.device})", flush=True)

    # SIGTERM drain: the preemption flag, polled every loop tick
    preemption.install_signal_handlers()
    preemption.poller_started()
    status = "ok"
    try:
        tick = 0
        while not preemption.preemption_requested():
            # replica-death fault site: `SC_FAULT=kill:serve_loop:tick=N`
            fault_point("serve_loop", tick=tick)
            tick += 1
            srv.maybe_flush_features()
            if srv.drift_abort_requested:
                print("[serve] feature drift past abort threshold — draining replica", flush=True)
                srv.drain()
                telemetry.event("serve_drained", reason="feature_drift", requests=srv.engine.stats["requests"])
                srv.close()
                status = "drift_abort"
                return 1
            time.sleep(0.05)
        sig = preemption.preemption_signal()
        print(f"[serve] drain requested (signal {sig}) — rejecting new requests, completing in-flight", flush=True)
        t0 = time.monotonic()
        srv.drain()
        drain_s = time.monotonic() - t0
        telemetry.event("serve_drained", signum=sig, requests=srv.engine.stats["requests"], drain_s=round(drain_s, 6))
        srv.close()
        status = "drained"
        print(f"[serve] drained clean in {drain_s:.3f} s, listener closed in {time.monotonic() - t0 - drain_s:.3f} s "
              "— exit 0", flush=True)
        return 0
    except KeyboardInterrupt:
        srv.drain()
        srv.close()
        status = "drained"
        return 0
    finally:
        preemption.poller_stopped()
        telemetry.close(status=status)


if __name__ == "__main__":
    sys.exit(main())
