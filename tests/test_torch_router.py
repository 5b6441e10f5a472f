"""The port's router (`serve/router.py`) held against the JAX package's, on
the CPU, and the port's router in front of port servers.

Each of JAX's router scenarios (`tests/test_router.py`) runs on the same
scriptable stub replicas (small stdlib HTTP servers) through both packages'
`Router`, and the results are compared: status codes, the ``X-Router-*``
headers, the body bytes, the `stats` dict, the ``router.*`` counters and
the ``router_replica_state`` transition sequence. Exact equality, except
where a scenario's outcome rests on host timing (the deadline: the number
of attempts that fit before it), where both are held to the same outcome
and bounds. `ServeClient(retries=N)` rides the shared backoff in both
packages alike.

Then the port's own tier on the CPU: the router in front of two in-process
port `ServeServer`s (``device="cpu"``). The router never re-serializes a
body, so each response keeps the serving bit contract: it equals the engine's
stack of one (`encode_naive`) at the response's ``bucket``. On the CPU that
is the contract to hold, not the unpadded ``ld.encode`` the JAX tests
compare with: a row's bits can depend on the padded batch there (ROADMAP §C,
"Serving"). Last, the load generator's per-outcome accounting
(`serve.loadgen`) against JAX's `scripts/loadgen.py`.
"""

import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from contextlib import redirect_stdout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from sparse_coding__tpu.serve import router as jrouter
from sparse_coding__tpu.serve import server as jserver
from sparse_coding__tpu.telemetry import RunTelemetry as JRunTelemetry
from sparse_coding__tpu.utils import faults as jfaults
from sparse_coding__tpu_torch.models.learned_dict import TiedSAE
from sparse_coding__tpu_torch.serve import router as trouter
from sparse_coding__tpu_torch.serve import server as tserver
from sparse_coding__tpu_torch.serve.registry import DictRegistry
from sparse_coding__tpu_torch.telemetry import RunTelemetry
from sparse_coding__tpu_torch.utils import faults as tfaults

pytestmark = pytest.mark.serve

REPO = Path(__file__).resolve().parents[1]
D, N = 16, 64
PACKAGES = {
    "jax": dict(router=jrouter, server=jserver, telemetry=JRunTelemetry, faults=jfaults),
    "port": dict(router=trouter, server=tserver, telemetry=RunTelemetry, faults=tfaults),
}


class StubReplica:
    """A scriptable fake serve backend (as JAX's tests have it): ``/healthz``
    answers ok (or draining); ``/encode`` replays a script of (delay_s,
    status, retryable, retry_after) steps, then repeats the last one. The
    200 body names the stub, so a response shows which replica served it."""

    def __init__(self, script, name: str = "stub"):
        self.script = list(script)
        self.name = name
        self.hits = 0
        self.draining = False
        self._lock = threading.Lock()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _json(self, status, payload, headers=None):
                body = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._json(200, {"status": "draining" if stub.draining else "ok", "dict_generation": 0})

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                with stub._lock:
                    step = stub.script[min(stub.hits, len(stub.script) - 1)]
                    stub.hits += 1
                delay, status, retryable, retry_after = step
                if delay:
                    time.sleep(delay)
                if status == 200:
                    self._json(200, {"dict": "d0", "n_rows": 1, "codes": [[1.0, 2.0]], "generation": 0,
                                     "served_by": stub.name})
                else:
                    headers = {} if retry_after is None else {"Retry-After": str(retry_after)}
                    self._json(status, {"error": "scripted", "retryable": retryable}, headers)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    @property
    def address(self):
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


DEAD_URL = "http://127.0.0.1:9"  # nothing listens there: connection refused


def _post(url: str, rows=((0.0, 0.0),), timeout: float = 30.0):
    """One raw POST /encode: (status, the X-Router-* headers, body bytes)."""
    body = json.dumps({"dict": "d0", "rows": [list(r) for r in rows]}).encode()
    req = urllib.request.Request(url + "/encode", data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            status, headers, out = resp.status, dict(resp.headers.items()), resp.read()
    except urllib.error.HTTPError as e:
        status, headers, out = e.code, dict(e.headers.items()), e.read()
    keep = {k: v for k, v in headers.items() if k.startswith("X-Router") or k in ("Retry-After", "Content-Type")}
    assert len(headers.get("X-Trace-Id", "")) == 32  # the router minted one
    return status, keep, out


def _run(pkg: str, tmp_path, backends, setup=None, drive=None, **router_kw):
    """One scenario through one package's router: start it over
    ``backends`` (name -> stub or URL), apply ``setup(router)``, call
    ``drive(router)`` (default: one raw POST), and collect what the two
    packages are compared on."""
    mods = PACKAGES[pkg]
    urls = {k: (v if isinstance(v, str) else v.address) for k, v in backends.items()}
    tel_dir = tmp_path / pkg
    tel = mods["telemetry"](out_dir=tel_dir, run_name="router", file_name="router_events.jsonl")
    router = mods["router"].Router(urls, telemetry=tel, **{"health_interval": 30.0, **router_kw}).start()
    try:
        if setup is not None:
            setup(router)
        result = (drive or (lambda r: _post(r.address)))(router)
        stats = dict(router.stats)
        states = router.states()
        counters = {k: v for k, v in tel.counters.items() if k.startswith("router.")}
    finally:
        router.stop()
        tel.close()
    recs = [json.loads(line) for line in (tel_dir / "router_events.jsonl").read_text().splitlines()]
    transitions = [(r["replica"], r["frm"], r["to"], r["reason"]) for r in recs
                   if r["event"] == "router_replica_state"]
    admin = [(r["event"], r["replica"]) for r in recs if r["event"].startswith("router_replica_") and "frm" not in r]
    return {"result": result, "stats": stats, "states": states, "counters": counters, "transitions": transitions,
            "admin": admin}


def _both(tmp_path, make_backends, **kw):
    """The scenario through both routers, each over fresh stubs; returns
    (port, jax) and asserts they agree."""
    out = {}
    for pkg in ("port", "jax"):
        backends = make_backends()
        try:
            out[pkg] = _run(pkg, tmp_path, backends, **kw)
        finally:
            for b in backends.values():
                if not isinstance(b, str):
                    b.close()
    assert out["port"] == out["jax"]
    return out["port"]


def _force_live(rid, busy=None):
    def setup(router):
        router._targets[rid].state = "live"
        router._targets[rid].consecutive_failures = 0
        if busy is not None:
            router._targets[busy].in_flight = 1
    return setup


# -- JAX's scenarios, both routers --------------------------------------------------

def test_passthrough_is_bit_identical(tmp_path):
    got = _both(tmp_path, lambda: {"r0": StubReplica([(0, 200, False, None)], "a")})
    status, headers, body = got["result"]
    assert body == json.dumps({"dict": "d0", "n_rows": 1, "codes": [[1.0, 2.0]], "generation": 0,
                               "served_by": "a"}).encode()  # the stub's bytes
    assert status == 200 and headers["X-Router-Replica"] == "r0" and headers["X-Router-Attempts"] == "1"
    assert headers["X-Router-Hedged"] == "0"
    assert got["stats"]["ok"] == 1 and got["stats"]["retries"] == 0
    assert got["transitions"] == [("r0", "suspect", "live", "probe_ok")]


def test_client_errors_pass_through_and_are_not_retried(tmp_path):
    got = _both(tmp_path, lambda: {"r0": StubReplica([(0, 404, False, None)])})
    status, _, body = got["result"]
    assert status == 404 and json.loads(body)["error"] == "scripted"
    assert got["stats"]["client_errors"] == 1 and got["stats"]["retries"] == 0


def test_retry_lands_on_a_different_replica(tmp_path):
    got = _both(tmp_path, lambda: {"r0": DEAD_URL, "r1": StubReplica([(0, 200, False, None)], "b")},
                setup=_force_live("r0", busy="r1"), max_attempts=3, retry_backoff=0.01)
    status, headers, body = got["result"]
    assert status == 200 and json.loads(body)["served_by"] == "b"
    assert headers["X-Router-Attempts"] == "2" and headers["X-Router-Replica"] == "r1"
    assert got["stats"]["retries"] == 1 and got["stats"]["retried_ok"] == 1
    assert got["states"] == {"r0": "suspect", "r1": "live"}
    assert ("r0", "live", "suspect", "URLError") in got["transitions"]


@pytest.mark.parametrize("reason", ["no_live_replicas", "saturated"])
def test_sheds_fast(tmp_path, reason):
    if reason == "no_live_replicas":
        kw = dict(setup=lambda r: setattr(r._targets["r0"], "state", "dead"), max_attempts=2)
        make = lambda: {"r0": DEAD_URL}  # noqa: E731
    else:
        kw = dict(max_inflight=0)
        make = lambda: {"r0": StubReplica([(0, 200, False, None)])}  # noqa: E731
    t0 = time.monotonic()
    got = _both(tmp_path, make, **kw)
    assert time.monotonic() - t0 < 5.0, "shed must be fast, not queued"
    status, headers, body = got["result"]
    assert status == 503 and headers["X-Router-Shed"] == reason and headers["Retry-After"] == "1"
    assert json.loads(body) == {"error": "shed", "reason": reason, "retryable": True,
                                "detail": "router shed this request — back off and retry"}
    assert got["stats"]["sheds"] == 1


def test_gives_up_after_bounded_attempts(tmp_path):
    hits = {}

    def make():
        stub = StubReplica([(0, 503, True, None)])
        hits.setdefault("stubs", []).append(stub)
        return {"r0": stub}

    got = _both(tmp_path, make, setup=_force_live("r0"), max_attempts=3, retry_backoff=0.01)
    status, headers, body = got["result"]
    assert status == 503 and json.loads(body)["retryable"] is True and json.loads(body)["attempts"] == 3
    assert got["stats"]["failed"] == 1 and got["stats"]["retries"] == 2
    assert [s.hits for s in hits["stubs"]] == [3, 3]


def test_request_deadline_504(tmp_path):
    """How many attempts fit in the 0.25 s deadline rests on host timing, so
    the two routers are held to the same outcome, not the same count."""
    out = {}
    for pkg in ("port", "jax"):
        stub = StubReplica([(0.6, 200, False, None)])
        try:
            out[pkg] = _run(pkg, tmp_path, {"r0": stub}, setup=_force_live("r0"), max_attempts=4,
                            request_deadline=0.25, attempt_timeout=0.2, retry_backoff=0.01)
        finally:
            stub.close()
    for got in out.values():
        status, headers, body = got["result"]
        payload = json.loads(body)
        assert status == 504 and payload["error"] == "upstream_failed" and payload["retryable"] is False
        assert payload["detail"] == "request deadline exceeded" and 1 <= payload["attempts"] <= 3
        assert got["stats"]["failed"] == 1 and got["stats"]["ok"] == 0


def test_retry_after_is_a_floor_on_the_backoff(tmp_path, monkeypatch):
    sleeps = {"cur": []}
    monkeypatch.setattr(time, "sleep", lambda s: sleeps["cur"].append(s))
    seen = {}
    for pkg in ("port", "jax"):
        sleeps["cur"] = []
        stub = StubReplica([(0, 503, True, "0.7"), (0, 503, True, "0.7"), (0, 200, False, None)])
        try:
            got = _run(pkg, tmp_path, {"r0": stub}, setup=_force_live("r0"), max_attempts=3, retry_backoff=0.01)
        finally:
            stub.close()
        seen[pkg] = (got["result"][0], got["stats"], [s for s in sleeps["cur"] if s >= 0.7])
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == 200 and seen["port"][2] == [0.7, 0.7]


def test_hedge_races_a_slow_replica(tmp_path):
    def drive(router):
        t0 = time.monotonic()
        out = _post(router.address)
        return out, time.monotonic() - t0 < 0.7

    got = _both(tmp_path, lambda: {"slow": StubReplica([(0.8, 200, False, None)], "slow"),
                                   "fast": StubReplica([(0, 200, False, None)], "fast")},
                setup=lambda r: setattr(r._targets["fast"], "in_flight", 5), drive=drive, hedge_ms=40.0,
                attempt_timeout=3.0)
    (status, headers, body), fast_enough = got["result"]
    assert fast_enough and status == 200 and json.loads(body)["served_by"] == "fast"
    assert headers["X-Router-Hedged"] == "1" and headers["X-Router-Replica"] == "fast"
    assert got["stats"]["hedges"] == 1


def test_quiesce_readmit_and_draining(tmp_path):
    stubs = {}

    def make():
        stubs["a"], stubs["b"] = StubReplica([(0, 200, False, None)], "a"), StubReplica([(0, 200, False, None)], "b")
        return dict(stubs)

    def drive(router):
        router.quiesce("a")
        before = router._targets["a"].forwards
        served = [json.loads(_post(router.address)[2])["served_by"] for _ in range(6)]
        quiet = router._targets["a"].forwards == before
        router.readmit("a")
        stubs["a"].draining = True
        router._probe_all()
        return served, quiet, router._targets["a"].consecutive_failures

    got = _both(tmp_path, make, drive=drive)
    served, quiet, failures = got["result"]
    assert served == ["b"] * 6 and quiet and failures == 0
    assert got["states"]["a"] == "draining"
    assert got["admin"] == [("router_replica_quiesced", "a"), ("router_replica_readmitted", "a")]
    assert got["transitions"][-1] == ("a", "live", "draining", "healthz_draining")


def test_fault_site_grammar_matches():
    for spec in ("kill:tick=3", "io_error:router_forward:replica=r1", "kill:serve_loop:tick=40:times=1"):
        ours, theirs = tfaults.parse_faults(spec)[0], jfaults.parse_faults(spec)[0]
        assert (ours.action, ours.site, ours.params) == (theirs.action, theirs.site, theirs.params)
    assert tfaults.parse_faults("kill:tick=3")[0].site == "serve_loop"


def test_router_forward_fault_is_retried_elsewhere(tmp_path, monkeypatch):
    monkeypatch.setenv(tfaults.FAULT_ENV, "io_error:router_forward:replica=r0:persist=1")
    tfaults.reset()
    jfaults.reset()
    try:
        got = _both(tmp_path, lambda: {"r0": StubReplica([(0, 200, False, None)], "a"),
                                       "r1": StubReplica([(0, 200, False, None)], "b")},
                    setup=lambda r: setattr(r._targets["r1"], "in_flight", 1), max_attempts=3, retry_backoff=0.01)
    finally:
        tfaults.reset()
        jfaults.reset()
    status, headers, body = got["result"]
    assert status == 200 and json.loads(body)["served_by"] == "b" and headers["X-Router-Attempts"] == "2"
    assert got["stats"]["retries"] == 1 and got["states"]["r0"] == "suspect"
    assert ("r0", "live", "suspect", "OSError") in got["transitions"]


def test_serve_client_retries_ride_the_shared_backoff(monkeypatch):
    sleeps = {"cur": []}
    monkeypatch.setattr(time, "sleep", lambda s: sleeps["cur"].append(s))
    seen = {}
    for pkg in ("port", "jax"):
        mods = PACKAGES[pkg]
        sleeps["cur"] = []
        stub = StubReplica([(0, 503, True, "0.4"), (0, 200, False, None)])
        stub2 = StubReplica([(0, 503, True, None)])
        try:
            with mods["telemetry"](out_dir=None, run_name="client") as tel:
                codes = mods["server"].ServeClient(stub.address, retries=3, backoff_base=0.01).encode("d0", [[0.0, 0.0]])
                retried = tel.counters.get("serve.client.retry")
            with pytest.raises(mods["server"].RetryableRejection):
                mods["server"].ServeClient(stub2.address, retries=2, backoff_base=0.0).encode("d0", [[0.0, 0.0]])
        finally:
            stub.close()
            stub2.close()
        seen[pkg] = (np.asarray(codes).tolist(), retried, [s for s in sleeps["cur"] if s >= 0.4], stub.hits, stub2.hits)
    assert seen["port"] == seen["jax"] == ([[1.0, 2.0]], 1, [0.4], 2, 2)


def test_router_client_raises_like_the_jax_client(tmp_path):
    """A shed is a `ShedRejection` (a `RetryableRejection`), a retryable
    give-up a `RetryableRejection`, a 504 a RuntimeError, in both."""
    for pkg in ("port", "jax"):
        mods = PACKAGES[pkg]
        router = mods["router"].Router({"r0": DEAD_URL}, health_interval=30.0, max_attempts=2).start()
        stub = StubReplica([(0, 503, True, None)])
        router2 = mods["router"].Router({"r0": stub.address}, health_interval=30.0, max_attempts=2,
                                        retry_backoff=0.01).start()
        try:
            router._targets["r0"].state = "dead"
            with pytest.raises(mods["router"].ShedRejection) as e:
                router.client().encode("d0", [[0.0, 0.0]])
            assert isinstance(e.value, mods["server"].RetryableRejection) and e.value.retry_after == 1.0
            assert router.health()["status"] == "unavailable"
            with pytest.raises(mods["server"].RetryableRejection) as e:
                router2.client().encode("d0", [[0.0, 0.0]])
            assert not isinstance(e.value, mods["router"].ShedRejection)
        finally:
            router.stop()
            router2.stop()
            stub.close()


# -- the port's router in front of port servers -------------------------------------

def _tied(seed: int) -> TiedSAE:
    rng = np.random.default_rng(seed)
    return TiedSAE(torch.from_numpy(rng.standard_normal((N, D), dtype=np.float32)),
                   torch.from_numpy(rng.standard_normal(N, dtype=np.float32) * 0.1))


def _registry(n: int = 2) -> DictRegistry:
    reg = DictRegistry(device="cpu")
    for i in range(n):
        reg.add(f"d{i}", _tied(i))
    return reg


def _rows(seed: int, n: int = 4) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


@pytest.fixture()
def two_servers():
    a = tserver.ServeServer(_registry(), max_batch=64, max_wait_ms=1.0).start()
    b = tserver.ServeServer(_registry(), max_batch=64, max_wait_ms=1.0).start()
    yield a, b
    for s in (a, b):
        if not s.draining:
            s.stop()
        else:
            s.close()


@pytest.mark.parametrize("fmt", ["json", "npz", "raw"])
def test_router_in_front_of_port_servers_keeps_the_bucket_contract(two_servers, fmt):
    a, b = two_servers
    with trouter.Router({"a": a.address, "b": b.address}, health_interval=30.0) as router:
        client = router.client()
        for i, n in enumerate((1, 4, 9, 33)):
            X = _rows(i, n)
            for k in (None, 5):
                got, meta = client.encode_with_meta(f"d{i % 2}", X, format=fmt, top_k=k)
                bucket = client.last_meta["bucket"]
                server = {"a": a, "b": b}[meta["replica"]]
                want = server.engine.encode_naive(f"d{i % 2}", X, top_k=k, bucket=bucket)
                if k is None:
                    np.testing.assert_array_equal(got, want)
                else:
                    for x, y in zip(got, want):
                        np.testing.assert_array_equal(x, y)
                assert meta["attempts"] == 1 and meta["generation"] == 0 and len(meta["trace_id"]) == 32
        # the body through the router is a server's body: the same codes and
        # meta as straight from a server, but for its latency and trace id
        body = json.dumps({"dict": "d0", "rows": _rows(7, 3).tolist()}).encode()
        via, direct = (json.loads(urllib.request.urlopen(urllib.request.Request(
            url + "/encode", data=body, method="POST")).read()) for url in (router.address, a.address))
        assert {k: v for k, v in via.items() if k not in ("latency_ms", "trace_id")} == \
            {k: v for k, v in direct.items() if k != "latency_ms"}
        assert json.loads(urllib.request.urlopen(router.address + "/dicts").read())["dicts"]
        with pytest.raises(RuntimeError, match="404"):
            client.encode("nope", _rows(0))
        assert router.stats["retries"] == 0 and router.stats["client_errors"] == 1


def test_drained_servers_move_traffic_then_shed(two_servers):
    a, b = two_servers
    with trouter.Router({"a": a.address, "b": b.address}, health_interval=30.0) as router:
        client = router.client()
        a.drain()  # a's healthz says draining, its /encode answers retryable 503s
        router._targets["b"].in_flight = 1  # the first pick is a: its 503 is retried on b
        _, meta = client.encode_with_meta("d0", _rows(9))
        router._targets["b"].in_flight = 0
        assert meta["replica"] == "b" and meta["attempts"] == 2
        for i in range(6):
            _, meta = client.encode_with_meta("d0", _rows(i))
            assert meta["replica"] == "b"
        assert router.states()["a"] == "draining"
        b.drain()
        router._probe_all()
        t0 = time.monotonic()
        with pytest.raises(trouter.ShedRejection, match="no_live_replicas"):
            client.encode("d0", _rows(0))
        assert time.monotonic() - t0 < 1.0
        assert router.health()["status"] == "unavailable"


# -- the load generator's accounting --------------------------------------------------

def _jax_loadgen():
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import loadgen
    finally:
        sys.path.remove(str(REPO / "scripts"))
    return loadgen


def test_loadgen_accounting_matches_the_jax_script():
    """`run_load` over the same scripted encode function (ok, retried ok,
    a shed, a retryable rejection, an error, by request index): the same
    counts and the same result keys; `latency_stats`/`latency_histogram`
    equal on the same sample."""
    from sparse_coding__tpu_torch.serve import loadgen as tl

    jl = _jax_loadgen()

    class ShedRejection(Exception):
        pass

    class RetryableRejection(Exception):
        pass

    def make_fn():
        lock, n = threading.Lock(), {"i": 0}

        def fn(did, rows):
            with lock:
                n["i"] += 1
                i = n["i"]
            if i % 7 == 0:
                raise ShedRejection("shed")
            if i % 11 == 0:
                raise RetryableRejection("drain")
            if i % 13 == 0:
                raise ValueError("boom")
            return rows, {"attempts": 2 if i % 5 == 0 else 1}
        return fn

    kw = dict(n_clients=3, requests_per_client=20, rows_per_request=2, width=D, with_meta=True, histogram=True)
    ours = tl.run_load(make_fn(), ["d0", "d1"], **kw)
    theirs = jl.run_load(make_fn(), ["d0", "d1"], **kw)
    assert set(ours) == set(theirs)
    counts = ("clients", "requests", "retried_ok", "rejected", "shed", "errors", "rows", "n")
    assert {k: ours[k] for k in counts} == {k: theirs[k] for k in counts}
    # i = 1..60: every 7th a shed, every other 11th a rejection, every other 13th an error
    assert (ours["requests"], ours["shed"], ours["rejected"], ours["errors"]) == (43, 8, 5, 4)
    sample = list(np.random.default_rng(0).exponential(5.0, size=257))
    assert tl.latency_stats(sample) == jl.latency_stats(sample)
    assert tl.latency_stats([]) == jl.latency_stats([])
    assert tl.latency_histogram(sample) == jl.latency_histogram(sample)


def test_loadgen_targets_cli_against_port_servers(two_servers, tmp_path):
    """``--targets`` through an in-process router over two port servers, by
    the port's load generator and by JAX's script (whose router forwards
    the same bytes): the same JSON keys and the same clean accounting; then
    ``--url`` with ``--slo`` by both: the same objectives and verdicts (a
    generous SLO passes, exit 0; an impossible one fails, exit 1)."""
    from sparse_coding__tpu_torch.serve import loadgen as tl

    a, b = two_servers
    argv = ["--targets", a.address, b.address, "--clients", "2", "--requests", "3", "--rows", "2", "--top-k", "5",
            "--format", "npz"]
    outs = {}
    for name, main in (("port", tl.main), ("jax", _jax_loadgen().main)):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = main(argv)
        assert rc == 0
        outs[name] = json.loads(buf.getvalue())
    assert set(outs["port"]) == set(outs["jax"])
    for out in outs.values():
        assert (out["requests"], out["errors"], out["shed"], out["rows"]) == (6, 0, 0, 12)
        assert out["replica_states"] == {"r0": "live", "r1": "live"} and out["router"]["ok"] == 6
    for threshold_ms, want_rc in ((60_000.0, 0), (0.0, 1)):
        slo = tmp_path / "slo.json"
        slo.write_text(json.dumps({"objectives": [
            {"name": "availability", "type": "availability", "target": 0.5},
            {"name": "p99", "type": "latency", "percentile": 0.99, "threshold_ms": threshold_ms}]}))
        verdicts = {}
        for name, main in (("port", tl.main), ("jax", _jax_loadgen().main)):
            buf = io.StringIO()
            with redirect_stdout(buf):
                rc = main(["--url", a.address, "--clients", "1", "--requests", "2", "--rows", "2", "--slo", str(slo)])
            assert rc == want_rc, name
            got = json.loads(buf.getvalue())["slo"]
            verdicts[name] = (got["verdict"], [(o["name"], o["ok"]) for o in got["objectives"]])
        assert verdicts["port"] == verdicts["jax"]


def test_loadgen_outcomes_through_a_dead_router():
    from sparse_coding__tpu_torch.serve import loadgen as tl

    with trouter.Router({"r0": DEAD_URL}, health_interval=30.0) as router:
        router._targets["r0"].state = "dead"
        out = tl.run_load(router.client().encode_with_meta, ["d0"], n_clients=2, requests_per_client=3,
                          rows_per_request=1, width=D, with_meta=True)
    assert (out["shed"], out["errors"], out["requests"]) == (6, 0, 0)
