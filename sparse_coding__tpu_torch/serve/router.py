"""Fault-tolerant serving front end: route, retry, hedge, shed.

Counterpart of the JAX package's `serve/router.py`, with its API, headers,
records and counters. A `Router` is a stdlib HTTP front end over N backend
serve replicas (`serve.server` processes) that forwards ``POST /encode`` and
``POST /features`` so that a SIGKILLed replica costs a client latency, not a
failure:

  - **Replica states** ``live`` / ``draining`` / ``suspect`` / ``dead``,
    driven by a background ``/healthz`` poll (every ``health_interval`` s)
    and by request outcomes: one failure makes a replica ``suspect``,
    ``dead_after`` consecutive ones ``dead``, one success readmits it; a
    replica whose healthz says ``draining`` gets no new requests and no
    penalty. Every transition is a ``router_replica_state`` event.
  - **Retry against a different replica** on a connection error, a timeout
    or a 503/504 whose body says ``"retryable": true``, through
    `utils.sync.retry_with_backoff`, a replica's ``Retry-After`` a floor on
    the sleep. Other responses (200, 400, 404) pass through verbatim: the
    router never re-serializes a body, so served bytes are the replica's.
  - **Bounded shedding.** With every replica dead or draining, or
    ``max_inflight`` requests in flight, a request gets a fast retryable
    503 (``"reason": "no_live_replicas" | "saturated"``).
  - **Hedging** (``hedge_ms``): a forward that has not answered after
    ``hedge_ms`` is raced against one more live replica; the first final
    answer wins (encode is pure).
  - **Generation pinning.** A request goes to one replica and comes back as
    that replica's bytes, stamped with the generation it serves, so a
    rolling swap (`serve.replicaset`) never shows a client a torn mix.

Responses gain ``X-Router-Replica`` / ``X-Router-Attempts`` /
``X-Router-Hedged``; `RouterClient` returns them as metadata. The router is
the tier's trace edge: it mints ``X-Trace-Id`` when the client sent none and
writes one ``forward`` span per attempt, whose span id goes to the replica
as ``X-Parent-Span`` (`telemetry.tracing`). ``GET /metrics`` exports the
``router.*`` counters and per-replica gauges (`telemetry.metrics_http`).
The ``router_forward`` fault site (`utils.faults`) fires before each forward.
The router is host code: it touches no device.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Queue
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple, Union

from sparse_coding__tpu_torch.serve.engine import _emit_span, _percentile
from sparse_coding__tpu_torch.serve.server import RetryableRejection, ServeClient
from sparse_coding__tpu_torch.telemetry import tracing as _tracing
from sparse_coding__tpu_torch.utils.faults import fault_point
from sparse_coding__tpu_torch.utils.sync import retry_with_backoff

__all__ = [
    "Replica",
    "Router",
    "RouterClient",
    "ShedRejection",
    "REPLICA_STATES",
]

REPLICA_STATES = ("live", "draining", "suspect", "dead")


class ShedRejection(RetryableRejection):
    """The router's fast 503: all replicas dead/draining or the in-flight
    cap is reached. Retryable by contract — back off and try again."""


class _RetryableForward(Exception):
    """Internal: one forward failed retryably (conn error / timeout /
    retryable 503-504). Carries the Retry-After floor and a description."""

    def __init__(self, desc: str, retry_after: float = 0.0,
                 status: Optional[int] = None):
        super().__init__(desc)
        self.retry_after = float(retry_after)
        self.status = status


class _NoReplica(Exception):
    """Internal: no routable replica for this attempt."""


class _DeadlineExceeded(Exception):
    """Internal: the request's deadline expired before an answer."""


class Replica:
    """Router-side view of one backend serve replica."""

    __slots__ = (
        "rid", "url", "state", "quiesced", "consecutive_failures",
        "in_flight", "forwards", "retries_against", "dict_generation",
        "registry_generation", "latencies", "last_ok_ts", "transitions",
    )

    def __init__(self, rid: str, url: Optional[str]):
        self.rid = str(rid)
        self.url = url.rstrip("/") if url else None
        # a fresh backend starts suspect: it becomes live on its first
        # successful probe/request, so the router never routes to a URL
        # nothing has ever answered on
        self.state = "suspect"
        self.quiesced = False
        self.consecutive_failures = 0
        self.in_flight = 0
        self.forwards = 0
        self.retries_against = 0
        self.dict_generation: Optional[int] = None
        self.registry_generation: Optional[int] = None
        self.latencies: deque = deque(maxlen=512)
        self.last_ok_ts: Optional[float] = None
        self.transitions = 0

    def describe(self) -> Dict[str, Any]:
        lat = sorted(self.latencies)
        return {
            "replica": self.rid,
            "url": self.url,
            "state": self.state,
            "quiesced": self.quiesced,
            "in_flight": self.in_flight,
            "forwards": self.forwards,
            "consecutive_failures": self.consecutive_failures,
            "dict_generation": self.dict_generation,
            "registry_generation": self.registry_generation,
            "latency_p50_ms": round(_percentile(lat, 0.50), 3),
            "latency_p99_ms": round(_percentile(lat, 0.99), 3),
            "transitions": self.transitions,
        }


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        if self.server.router.verbose:
            import sys

            sys.stderr.write(f"[router] {fmt % args}\n")

    def _respond(self, status: int, body: bytes,
                 headers: Optional[Dict[str, str]] = None) -> None:
        # the upstream replica's Content-Type passes through (binary wire
        # formats); json only when nothing upstream set one
        headers = dict(headers or {})
        content_type = None
        for k in list(headers):
            if k.lower() == "content-type":
                content_type = headers.pop(k)
        self.send_response(status)
        self.send_header("Content-Type", content_type or "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _json(self, status: int, payload: Dict[str, Any],
              headers: Optional[Dict[str, str]] = None) -> None:
        self._respond(status, json.dumps(payload).encode(), headers)

    def do_GET(self):
        router = self.server.router
        if self.path == "/healthz":
            self._json(200, router.health())
            return
        if self.path == "/replicas":
            self._json(200, {"replicas": router.describe()})
            return
        if self.path == "/metrics":
            from sparse_coding__tpu_torch.telemetry.metrics_http import CONTENT_TYPE

            body = router.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path == "/dicts":
            status, headers, body = router.forward_get("/dicts")
            self._respond(status, body, headers)
            return
        self._json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        router = self.server.router
        if self.path not in ("/encode", "/features"):
            self._json(404, {"error": f"no route {self.path}"})
            return
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        deadline_ms = self.headers.get("X-Request-Deadline-Ms")
        try:
            deadline_s = (
                float(deadline_ms) / 1e3 if deadline_ms else None
            )
        except ValueError:
            deadline_s = None
        # the router is the tier's trace edge: mint when the client sent no
        # X-Trace-Id; parent every attempt on the client's X-Parent-Span
        trace_id = self.headers.get(_tracing.TRACE_HEADER) or _tracing.mint_trace_id()
        parent_span = self.headers.get(_tracing.PARENT_HEADER)
        status, headers, out = router.route_encode(
            body, deadline_s=deadline_s, trace_id=trace_id,
            parent_span=parent_span, path=self.path,
            content_type=self.headers.get("Content-Type"),
            accept=self.headers.get("Accept"),
        )
        headers = {**headers, _tracing.TRACE_HEADER: trace_id}
        self._respond(status, out, headers)


class Router:
    """See module docstring. Lifecycle: construct over backend URLs →
    ``start()`` (health poller + HTTP listener) → ``stop()``.

    ``backends`` is either a ``{replica_id: url}`` map or a URL sequence
    (ids ``r0..rN-1``). `serve.replicaset.ReplicaSet` mutates the set at
    runtime through `set_backend` / `mark_down` / `quiesce` / `readmit`.
    """

    def __init__(
        self,
        backends: Union[Dict[str, Optional[str]], Sequence[str], None] = None,
        *,
        telemetry=None,
        health_interval: float = 1.0,
        probe_timeout: float = 2.0,
        dead_after: int = 3,
        max_attempts: int = 4,
        retry_backoff: float = 0.05,
        retry_backoff_max: float = 2.0,
        request_deadline: float = 30.0,
        attempt_timeout: float = 30.0,
        max_inflight: int = 256,
        hedge_ms: Optional[float] = None,
        snapshot_every: int = 20,
        host: str = "127.0.0.1",
        port: int = 0,
        verbose: bool = False,
    ):
        self.telemetry = telemetry
        self.health_interval = float(health_interval)
        self.probe_timeout = float(probe_timeout)
        self.dead_after = max(1, int(dead_after))
        self.max_attempts = max(1, int(max_attempts))
        self.retry_backoff = float(retry_backoff)
        self.retry_backoff_max = float(retry_backoff_max)
        self.request_deadline = float(request_deadline)
        self.attempt_timeout = float(attempt_timeout)
        self.max_inflight = int(max_inflight)
        self.hedge_ms = None if hedge_ms is None else float(hedge_ms)
        self.snapshot_every = max(0, int(snapshot_every))
        self.verbose = verbose
        self._lock = threading.Lock()
        self._targets: Dict[str, Replica] = {}
        self._rr = 0  # round-robin tie-breaker
        self._total_inflight = 0
        self._stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self._stats_lock = threading.Lock()
        self.stats = {
            "requests": 0, "ok": 0, "retried_ok": 0, "retries": 0,
            "hedges": 0, "sheds": 0, "failed": 0, "forwards": 0,
            "client_errors": 0,
        }
        if isinstance(backends, dict):
            for rid, url in backends.items():
                self._targets[str(rid)] = Replica(rid, url)
        elif backends:
            for i, url in enumerate(backends):
                self._targets[f"r{i}"] = Replica(f"r{i}", url)
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.router = self
        self._http_thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------------

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def address(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "Router":
        if self._http_thread is not None:
            return self
        # one synchronous probe sweep before accepting traffic: backends
        # that are already up route immediately instead of waiting a tick
        self._probe_all()
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True, name="router-health"
        )
        self._health_thread.start()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True, name="router-http"
        )
        self._http_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._http_thread is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self._http_thread = None
        if self._health_thread is not None:
            self._health_thread.join(self.health_interval * 4 + 1)
            self._health_thread = None
        if self.telemetry is not None:
            self._export_gauges()
            self.telemetry.snapshot()

    def __enter__(self) -> "Router":
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.stop()
        return False

    def client(self, timeout: float = 30.0) -> "RouterClient":
        return RouterClient(self.address, timeout=timeout)

    # -- replica-set mutation (replicaset's admin surface) ---------------------

    def set_backend(self, rid: str, url: str, admit: bool = False) -> None:
        """Add or re-point a backend. ``admit=True`` marks it live
        immediately (the caller verified health itself — the replicaset's
        post-restart readmission); otherwise it starts suspect and the
        next probe admits it."""
        with self._lock:
            t = self._targets.get(rid)
            if t is None:
                t = self._targets[rid] = Replica(rid, url)
            t.url = url.rstrip("/")
            t.consecutive_failures = 0
        if admit:
            self._transition(rid, "live", reason="admitted")
        else:
            self._transition(rid, "suspect", reason="registered")

    def remove_backend(self, rid: str) -> None:
        with self._lock:
            self._targets.pop(rid, None)

    def mark_down(self, rid: str, reason: str = "marked_down") -> None:
        """Immediately stop routing to a replica the caller KNOWS is gone
        (the replicaset saw its process exit) — faster than waiting for
        ``dead_after`` probe failures."""
        self._transition(rid, "dead", reason=reason)

    def quiesce(self, rid: str) -> None:
        """Administratively stop NEW forwards to a replica (rolling-swap
        step 1). In-flight requests complete; health probes continue but
        cannot readmit it until `readmit`."""
        with self._lock:
            t = self._targets.get(rid)
            if t is not None:
                t.quiesced = True
        self._event("router_replica_quiesced", replica=rid)

    def readmit(self, rid: str) -> None:
        with self._lock:
            t = self._targets.get(rid)
            if t is not None:
                t.quiesced = False
        self._event("router_replica_readmitted", replica=rid)

    # -- state machine ---------------------------------------------------------

    def _event(self, etype: str, **fields) -> None:
        if self.telemetry is not None:
            self.telemetry.event(etype, **fields)

    def _counter(self, name: str, n: int = 1) -> None:
        if self.telemetry is not None:
            self.telemetry.counter_inc(name, n)

    def _bump(self, stat: str) -> None:
        """One stats increment + the matching telemetry counter (the stats
        dict is shared across handler threads — must be locked)."""
        with self._stats_lock:
            self.stats[stat] += 1
        self._counter(f"router.{stat}")

    def _transition(self, rid: str, to: str, reason: str) -> None:
        with self._lock:
            t = self._targets.get(rid)
            if t is None or t.state == to:
                return
            frm, t.state = t.state, to
            t.transitions += 1
            if to == "live":
                t.consecutive_failures = 0
        self._counter("router.state_changes")
        self._event(
            "router_replica_state", replica=rid, frm=frm, to=to, reason=reason
        )

    def _note_ok(self, t: Replica, latency_ms: Optional[float] = None,
                 reason: str = "ok") -> None:
        with self._lock:
            t.consecutive_failures = 0
            t.last_ok_ts = time.time()
            if latency_ms is not None:
                t.latencies.append(latency_ms)
        if t.state != "live" and not t.quiesced:
            self._transition(t.rid, "live", reason=reason)

    def _note_failure(self, t: Replica, reason: str) -> None:
        with self._lock:
            t.consecutive_failures += 1
            failures = t.consecutive_failures
        if failures >= self.dead_after:
            self._transition(t.rid, "dead", reason=reason)
        else:
            self._transition(t.rid, "suspect", reason=reason)

    def _note_draining(self, t: Replica) -> None:
        # a draining replica is healthy — rejecting is its JOB; no failure
        # penalty, just no new traffic
        with self._lock:
            t.consecutive_failures = 0
        self._transition(t.rid, "draining", reason="healthz_draining")

    # -- health polling --------------------------------------------------------

    def _probe(self, t: Replica) -> None:
        if t.url is None:
            return
        try:
            with urllib.request.urlopen(
                t.url + "/healthz", timeout=self.probe_timeout
            ) as resp:
                body = json.loads(resp.read())
        except Exception:
            self._note_failure(t, reason="probe_failed")
            return
        with self._lock:
            if body.get("dict_generation") is not None:
                t.dict_generation = int(body["dict_generation"])
            if body.get("registry_generation") is not None:
                t.registry_generation = int(body["registry_generation"])
        if body.get("status") == "draining" or body.get("draining"):
            self._note_draining(t)
        else:
            self._note_ok(t, reason="probe_ok")

    def _probe_all(self) -> None:
        for t in list(self._targets.values()):
            self._probe(t)

    def _export_gauges(self) -> None:
        if self.telemetry is None:
            return
        # snapshot under the lock: forwards append to the latency deques
        # concurrently, and iterating a mutating deque raises
        with self._lock:
            snap = [
                (t.rid, t.state, sorted(t.latencies))
                for t in self._targets.values()
            ]
            inflight = self._total_inflight
        live = sum(1 for _, state, _ in snap if state == "live")
        self.telemetry.gauge_set("router.live_replicas", live)
        self.telemetry.gauge_set("router.replicas", len(snap))
        self.telemetry.gauge_set("router.inflight", inflight)
        for rid, state, lat in snap:
            if lat:
                self.telemetry.gauge_set(
                    f"router.replica.{rid}.p50_ms", _percentile(lat, 0.50)
                )
                self.telemetry.gauge_set(
                    f"router.replica.{rid}.p99_ms", _percentile(lat, 0.99)
                )
            self.telemetry.gauge_set(
                f"router.replica.{rid}.state",
                float(REPLICA_STATES.index(state)),
            )

    def _health_loop(self) -> None:
        tick = 0
        while not self._stop.wait(self.health_interval):
            try:
                self._probe_all()
                self._export_gauges()
                tick += 1
                if (
                    self.telemetry is not None
                    and self.snapshot_every
                    and tick % self.snapshot_every == 0
                ):
                    self.telemetry.snapshot()
            except Exception:  # the health poller must NEVER die
                self._counter("router.health_loop_errors")

    # -- routing ---------------------------------------------------------------

    def _pick(self, exclude: Set[str]) -> Optional[Replica]:
        """Least-in-flight live replica not yet tried; wraps to already-
        tried ones when every live replica was (two replicas, both
        failed once — retrying beats failing); suspects are a last
        resort before shedding."""
        with self._lock:
            self._rr += 1
            rr = self._rr

            def order(t: Replica) -> Tuple:
                return (t.in_flight, (hash(t.rid) ^ rr) & 0xFF)

            def best(pool: List[Replica]) -> Optional[Replica]:
                fresh = [t for t in pool if t.rid not in exclude]
                pool = fresh or pool
                return min(pool, key=order) if pool else None

            live = [
                t for t in self._targets.values()
                if t.state == "live" and not t.quiesced and t.url
            ]
            pick = best(live)
            if pick is None:
                suspects = [
                    t for t in self._targets.values()
                    if t.state == "suspect" and not t.quiesced and t.url
                ]
                pick = best(suspects)
            if pick is not None:
                pick.in_flight += 1
                pick.forwards += 1
                self._total_inflight += 1
            return pick

    def _release(self, t: Replica) -> None:
        with self._lock:
            t.in_flight = max(0, t.in_flight - 1)
            self._total_inflight = max(0, self._total_inflight - 1)

    def _forward_once(
        self, t: Replica, body: bytes, timeout: float,
        extra_headers: Optional[Dict[str, str]] = None,
        path: str = "/encode",
    ) -> Tuple[int, Dict[str, str], bytes]:
        """One HTTP forward; returns (status, headers, body) for ANY HTTP
        status; raises on transport failures (conn refused, timeout). The
        client's Content-Type/Accept ride in ``extra_headers`` so binary
        wire bodies forward untouched (byte-exact passthrough contract)."""
        fault_point("router_forward", replica=t.rid)
        req = urllib.request.Request(
            t.url + path, data=body,
            headers={"Content-Type": "application/json",
                     **(extra_headers or {})},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.status, dict(resp.headers.items()), resp.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers.items()), e.read()

    @staticmethod
    def _retryable_response(status: int, headers: Dict[str, str],
                            body: bytes) -> Optional[float]:
        """None when the response is final; the Retry-After floor (seconds,
        0.0 when absent) when it is the retryable 503/504 contract."""
        if status not in (503, 504):
            return None
        try:
            retryable = bool(json.loads(body).get("retryable"))
        except Exception:
            retryable = False
        if not retryable:
            return None
        try:
            return float(headers.get("Retry-After", 0) or 0)
        except (TypeError, ValueError):
            return 0.0

    def _attempt(
        self, t: Replica, body: bytes, timeout: float, exclude: Set[str],
        trace: Optional[Dict[str, Any]] = None, attempt: int = 0,
        path: str = "/encode",
        wire_headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[int, Dict[str, str], bytes, bool, str]:
        """One (possibly hedged) forward through replica `t`. Returns
        (status, headers, body, hedged, winner_rid) for a final response;
        raises `_RetryableForward` when every raced forward failed
        retryably."""
        if self.hedge_ms is None:
            return (
                *self._forward_locked(t, body, timeout, trace=trace,
                                      attempt=attempt, path=path,
                                      wire_headers=wire_headers),
                False, t.rid,
            )
        results: "Queue[Tuple[Replica, Any]]" = Queue()

        def run(target: Replica, hedge: bool = False) -> None:
            try:
                results.put((target, self._forward_locked(
                    target, body, timeout, trace=trace, attempt=attempt,
                    hedge=hedge, path=path, wire_headers=wire_headers,
                )))
            except _RetryableForward as e:
                results.put((target, e))
            except Exception as e:  # pragma: no cover - defensive
                results.put((target, _RetryableForward(repr(e))))

        threading.Thread(target=run, args=(t,), daemon=True).start()
        launched = 1
        hedged = False
        deadline = time.monotonic() + timeout
        first_wait = self.hedge_ms / 1e3
        pending: List[Tuple[Replica, Any]] = []
        try:
            pending.append(results.get(timeout=first_wait))
        except Empty:
            hedge_t = self._pick(exclude | {t.rid})
            if hedge_t is not None:
                hedged = True
                self._bump("hedges")
                threading.Thread(
                    target=run, args=(hedge_t, True), daemon=True
                ).start()
                launched += 1
        last_exc: Optional[_RetryableForward] = None
        got = len(pending)
        while True:
            if pending:
                target, res = pending.pop()
            else:
                if got >= launched:
                    break
                remaining = deadline - time.monotonic()
                try:
                    target, res = results.get(timeout=max(0.05, remaining))
                except Empty:
                    break
                got += 1
            if isinstance(res, _RetryableForward):
                last_exc = res
                continue
            return (*res, hedged, target.rid)
        raise last_exc or _RetryableForward("hedged forwards timed out")

    def _forward_locked(
        self, t: Replica, body: bytes, timeout: float,
        trace: Optional[Dict[str, Any]] = None, attempt: int = 0,
        hedge: bool = False, path: str = "/encode",
        wire_headers: Optional[Dict[str, str]] = None,
    ) -> Tuple[int, Dict[str, str], bytes]:
        """Forward with in-flight accounting + outcome-driven state. Raises
        `_RetryableForward` on transport failure or a retryable 503/504;
        returns final responses. A traced request gets ONE ``forward``
        span per attempt (retries and hedges included) — the span id
        travels downstream as ``X-Parent-Span``, so the replica's records
        are provably children of THIS attempt (`telemetry.tracing`)."""
        t0 = time.monotonic()
        t0_wall = time.time()
        span_id = None
        extra_headers = dict(wire_headers) if wire_headers else None
        if trace is not None:
            span_id = _tracing.mint_span_id()
            extra_headers = {
                **(extra_headers or {}),
                _tracing.TRACE_HEADER: trace["trace_id"],
                _tracing.PARENT_HEADER: span_id,
            }

        def emit(status) -> None:
            if trace is None:
                return
            _emit_span(
                self.telemetry, "forward", "attempt", t0_wall,
                time.monotonic() - t0,
                trace_id=trace["trace_id"], span_id=span_id,
                parent_span=trace.get("parent_span"),
                replica=t.rid, attempt=attempt, hedge=hedge, status=status,
            )

        self._bump("forwards")
        try:
            try:
                status, headers, out = self._forward_once(
                    t, body, timeout, extra_headers=extra_headers, path=path
                )
            except Exception as e:
                emit(f"error:{type(e).__name__}")
                self._note_failure(t, reason=type(e).__name__)
                raise _RetryableForward(
                    f"replica {t.rid}: {type(e).__name__}: {e}"
                ) from None
        finally:
            self._release(t)
        emit(status)
        floor = self._retryable_response(status, headers, out)
        if floor is not None:
            # a clean retryable hand-back (draining / saturated): not a
            # health failure — refresh state from the body's intent
            if status == 503:
                try:
                    if json.loads(out).get("error") == "draining":
                        self._note_draining(t)
                except Exception:
                    pass
            raise _RetryableForward(
                f"replica {t.rid}: retryable {status}", retry_after=floor,
                status=status,
            )
        self._note_ok(t, latency_ms=(time.monotonic() - t0) * 1e3)
        return status, headers, out

    def route_encode(
        self, body: bytes, deadline_s: Optional[float] = None,
        trace_id: Optional[str] = None, parent_span: Optional[str] = None,
        path: str = "/encode", content_type: Optional[str] = None,
        accept: Optional[str] = None,
    ) -> Tuple[int, Dict[str, str], bytes]:
        """Route one encode/features request: pick → forward → (on
        retryable failure) retry against a different replica with backoff,
        bounded by ``max_attempts`` and the request deadline; shed fast
        when no replica is routable or the router is saturated.
        ``trace_id`` / ``parent_span`` (the HTTP handler's
        X-Trace-Id/X-Parent-Span) make every attempt a trace-tagged
        ``forward`` span. ``content_type``/``accept`` forward the client's
        wire-format negotiation untouched — request AND response bodies
        pass through byte-exact in every format."""
        self._bump("requests")
        trace = (
            {"trace_id": str(trace_id), "parent_span": parent_span}
            if trace_id else None
        )
        wire_headers: Dict[str, str] = {}
        if content_type:
            wire_headers["Content-Type"] = content_type
        if accept:
            wire_headers["Accept"] = accept
        with self._lock:
            saturated = self._total_inflight >= self.max_inflight
        if saturated:
            return self._shed("saturated")
        deadline = time.monotonic() + (
            self.request_deadline if deadline_s is None else deadline_s
        )
        tried: Set[str] = set()
        state = {"attempts": 0, "hedged": False, "replica": None}

        def one_attempt(attempt: int) -> Tuple[int, Dict[str, str], bytes]:
            if time.monotonic() >= deadline:
                raise _DeadlineExceeded()
            t = self._pick(tried)
            if t is None:
                raise _NoReplica()
            state["attempts"] += 1
            if attempt > 0:
                with self._lock:
                    t.retries_against += 1
            timeout = min(self.attempt_timeout, deadline - time.monotonic())
            try:
                status, headers, out, hedged, winner = self._attempt(
                    t, body, max(0.05, timeout), tried, trace=trace,
                    attempt=attempt, path=path,
                    wire_headers=wire_headers or None,
                )
            except _RetryableForward:
                tried.add(t.rid)
                raise
            state["hedged"] = state["hedged"] or hedged
            state["replica"] = winner
            return status, headers, out

        def on_retry(attempt: int, exc: BaseException) -> None:
            self._bump("retries")

        try:
            status, headers, out = retry_with_backoff(
                one_attempt,
                attempts=self.max_attempts,
                base_delay=self.retry_backoff,
                max_delay=self.retry_backoff_max,
                retry_on=(_RetryableForward,),
                give_up_on=(_NoReplica, _DeadlineExceeded),
                on_retry=on_retry,
                delay_floor_from=lambda e: getattr(e, "retry_after", 0.0),
            )
        except _NoReplica:
            if state["attempts"] == 0:
                return self._shed("no_live_replicas")
            return self._give_up(503, "no replica left to retry", state)
        except _DeadlineExceeded:
            return self._give_up(504, "request deadline exceeded", state)
        except _RetryableForward as e:
            return self._give_up(503, f"all attempts failed: {e}", state)
        if status == 200:
            self._bump("ok")
            if state["attempts"] > 1:
                self._bump("retried_ok")
        else:
            # a final non-200 passthrough (400/404 — the CLIENT's error):
            # counted so requests == ok + client_errors + sheds + failed
            # and the Router report's accounting always adds up
            self._bump("client_errors")
        fwd_headers = {
            k: v for k, v in headers.items()
            if k.lower() in ("retry-after", "content-type")
        }
        fwd_headers.update(self._meta_headers(state))
        return status, fwd_headers, out

    def _meta_headers(self, state: Dict[str, Any]) -> Dict[str, str]:
        out = {
            "X-Router-Attempts": str(state["attempts"]),
            "X-Router-Hedged": "1" if state["hedged"] else "0",
        }
        if state.get("replica"):
            out["X-Router-Replica"] = str(state["replica"])
        return out

    def _shed(self, reason: str) -> Tuple[int, Dict[str, str], bytes]:
        self._bump("sheds")
        body = json.dumps({
            "error": "shed", "reason": reason, "retryable": True,
            "detail": "router shed this request — back off and retry",
        }).encode()
        return 503, {"Retry-After": "1", "X-Router-Shed": reason}, body

    def _give_up(
        self, status: int, detail: str, state: Dict[str, Any]
    ) -> Tuple[int, Dict[str, str], bytes]:
        self._bump("failed")
        body = json.dumps({
            "error": "upstream_failed", "retryable": status == 503,
            "detail": detail, "attempts": state["attempts"],
        }).encode()
        return status, {"Retry-After": "1", **self._meta_headers(state)}, body

    def forward_get(self, path: str) -> Tuple[int, Dict[str, str], bytes]:
        """Forward a read-only GET (``/dicts``) to any routable replica."""
        t = self._pick(set())
        if t is None:
            return self._shed("no_live_replicas")
        try:
            try:
                with urllib.request.urlopen(
                    t.url + path, timeout=self.probe_timeout
                ) as resp:
                    return resp.status, dict(resp.headers.items()), resp.read()
            except urllib.error.HTTPError as e:
                return e.code, dict(e.headers.items()), e.read()
            except Exception:
                self._note_failure(t, reason="get_failed")
                return self._shed("forward_failed")
        finally:
            self._release(t)

    # -- introspection ---------------------------------------------------------

    def describe(self) -> List[Dict[str, Any]]:
        # held across t.describe(): it sorts the latency deques, which
        # forwards mutate under this same lock
        with self._lock:
            targets = sorted(self._targets.values(), key=lambda t: t.rid)
            return [t.describe() for t in targets]

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {t.rid: t.state for t in self._targets.values()}

    def metrics_text(self) -> str:
        """The ``GET /metrics`` body: the router's counters and per-replica
        gauges in Prometheus text exposition.
        With telemetry, the full bus after a fresh gauge export; without,
        a minimal set from the stats dict + live replica states."""
        from sparse_coding__tpu_torch.telemetry.metrics_http import (
            render_prometheus,
            telemetry_metrics_text,
        )

        if self.telemetry is not None:
            self._export_gauges()
            return telemetry_metrics_text(self.telemetry)
        with self._stats_lock:
            counters = {f"router.{k}": v for k, v in self.stats.items()}
        states = self.states()
        gauges: Dict[str, float] = {
            "router.replicas": float(len(states)),
            "router.live_replicas": float(
                sum(1 for s in states.values() if s == "live")
            ),
            "router.inflight": float(self._total_inflight),
        }
        for rid, state in states.items():
            gauges[f"router.replica.{rid}.state"] = float(
                REPLICA_STATES.index(state)
            )
        return render_prometheus(counters=counters, gauges=gauges)

    def health(self) -> Dict[str, Any]:
        desc = self.describe()
        live = sum(1 for d in desc if d["state"] == "live")
        if live and live == len(desc):
            status = "ok"
        elif live:
            status = "degraded"
        else:
            status = "unavailable"
        return {
            "status": status,
            "live": live,
            "replicas": {d["replica"]: d["state"] for d in desc},
            "inflight": self._total_inflight,
            "stats": dict(self.stats),
        }


class RouterClient(ServeClient):
    """`ServeClient` plus the router's response metadata: attempts/hedged/
    replica headers and the body's dict generation — what loadgen's
    per-outcome accounting (ok / retried-ok / shed / failed) reads. A
    router shed raises `ShedRejection` (a `RetryableRejection`); the
    inherited ``retries=`` client-side retry policy applies to both
    `encode` and `encode_with_meta`."""

    def _retryable_exc(self, payload, headers):
        if headers.get("X-Router-Shed"):
            exc = ShedRejection(payload.get("reason", "shed"))
            try:
                exc.retry_after = float(headers.get("Retry-After", 0) or 0)
            except (TypeError, ValueError):
                exc.retry_after = 0.0
            return exc
        return super()._retryable_exc(payload, headers)

    def encode_with_meta(self, dict_id: str, rows, trace=None,
                         format: str = "json",
                         top_k=None) -> Tuple[Any, Dict[str, Any]]:
        req_meta: Dict[str, Any] = {"dict": dict_id}
        if top_k is not None:
            req_meta["top_k"] = int(top_k)
        out_arrays, out_meta, headers = self._wire_call(
            "/encode", {"rows": rows}, req_meta, fmt=format, trace=trace
        )
        meta = {
            "attempts": int(headers.get("X-Router-Attempts", 1) or 1),
            "hedged": headers.get("X-Router-Hedged") == "1",
            "replica": headers.get("X-Router-Replica"),
            "generation": out_meta.get("generation"),
            "dict": out_meta.get("dict"),
            "trace_id": headers.get("X-Trace-Id"),
        }
        return self._unpack_codes(out_arrays, out_meta), meta

    def encode(self, dict_id: str, rows, trace=None, format: str = "json",
               top_k=None):
        return self.encode_with_meta(dict_id, rows, trace=trace,
                                     format=format, top_k=top_k)[0]
