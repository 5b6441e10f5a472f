"""The port's metrics read side and listener (`telemetry/metrics_http.py`)
held against the JAX package's on the same inputs, on the CPU.

`parse_prometheus` on the golden exposition and on text the exposition
writes (escapes, round trips), `family_value`, `histogram_from_families`
(the merge across writers) and `histogram_quantile`: equal to JAX's, exactly
(the same stdlib regexes and float sums). `MetricsServer` + `scrape` of a
live handle, the port's and JAX's scraper on each other's listener;
`write_metrics_file`'s atomic replace; the router's ``GET /metrics`` with and
without telemetry.
"""

import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from sparse_coding__tpu.telemetry import metrics_http as jm
from sparse_coding__tpu_torch.telemetry import RunTelemetry
from sparse_coding__tpu_torch.telemetry import metrics_http as tm

pytestmark = pytest.mark.serve

GOLDEN = Path(__file__).parent / "golden" / "metrics_exposition.txt"
D, N = 16, 64

LABELS = ["C:\\new", "a\\\\nb", 'q"uo\\te', "line\nbreak", "\\", "plain", ""]


def test_golden_parses_like_the_jax_package():
    text = GOLDEN.read_text()
    fams = tm.parse_prometheus(text)
    assert fams == jm.parse_prometheus(text)
    assert fams["sc_serve_requests_total"] == [({"replica": 'we"ird\\repl\nica'}, 120.0)]
    h = tm.histogram_from_families(fams, "serve.latency_ms")
    assert h == jm.histogram_from_families(fams, "serve.latency_ms")
    assert h["bounds"] == [0.25, 0.5, 1.0] and h["cumulative"] == [1.0, 1.0, 3.0] and h["count"] == 4.0
    for q in (0.0, 0.25, 0.5, 0.75, 0.99, 1.0):
        assert tm.histogram_quantile(h, q) == jm.histogram_quantile(h, q)
    assert tm.histogram_quantile(h, 0.99) == float("inf")
    assert tm.histogram_quantile({"count": 0}, 0.5) is None


@pytest.mark.parametrize("value", LABELS)
def test_label_escapes_round_trip_like_the_jax_package(value):
    text = tm.render_prometheus(counters={"x": 1, "y.z": 2.5}, gauges={"g": -3}, labels={"p": value, "q": "1"})
    assert text == jm.render_prometheus(counters={"x": 1, "y.z": 2.5}, gauges={"g": -3}, labels={"p": value, "q": "1"})
    fams = tm.parse_prometheus(text)
    assert fams == jm.parse_prometheus(text)
    assert fams["sc_x_total"][0][0] == {"p": value, "q": "1"}


def test_foreign_and_malformed_lines_are_skipped_alike():
    text = ("# HELP foo something\nfoo_bar 1\nnot a sample line at all\nbad{le=\"1\"} notanumber\n"
            "ok{a=\"b\"} 2.5e3\n  spaced 4  \n\nweird{x=\"y\",z=\"w\\\\\"} +Inf\n")
    fams = tm.parse_prometheus(text)
    assert fams == jm.parse_prometheus(text)
    assert fams["ok"] == [({"a": "b"}, 2500.0)] and "bad" not in fams and fams["weird"][0][1] == float("inf")


def test_family_value_and_histogram_merge_across_writers_match():
    rng = np.random.default_rng(0)
    text = ""
    for w in range(3):
        counts = [int(c) for c in rng.integers(0, 9, size=5)]
        text += tm.render_prometheus(
            counters={"serve.requests": int(rng.integers(1, 100))}, gauges={"serve.queue_depth": float(w)},
            hists={"serve.latency_ms": {"bounds": [0.5, 1.0, 2.0, 4.0], "counts": counts,
                                        "sum": float(rng.random() * 50), "count": sum(counts)}},
            labels={"replica": f"r{w}"})
    fams = tm.parse_prometheus(text)
    for key, suffix in (("serve.requests", "_total"), ("serve.queue_depth", ""), ("absent", "")):
        assert tm.family_value(fams, key, suffix) == jm.family_value(fams, key, suffix)
    assert tm.family_value(fams, "absent", default=-1.0) == -1.0
    h = tm.histogram_from_families(fams, "serve.latency_ms")
    assert h == jm.histogram_from_families(fams, "serve.latency_ms")
    assert h["count"] == sum(v for lab, v in fams["sc_serve_latency_ms_bucket"] if lab["le"] == "+Inf")
    assert [tm.histogram_quantile(h, q) for q in np.linspace(0, 1, 21)] == \
        [jm.histogram_quantile(h, q) for q in np.linspace(0, 1, 21)]
    assert tm.histogram_from_families(fams, "absent") is None


def test_metrics_server_scraped_by_both_packages():
    tel = RunTelemetry(out_dir=None, run_name="t", tags={"replica": "r0"})
    tel.counter_inc("serve.requests", 9)
    tel.hist_observe("serve.latency_ms", 3.0)
    try:
        with tm.serve_metrics_server(tel) as srv:
            fams = tm.scrape(srv.address)
            assert tm.family_value(fams, "serve.requests", "_total") == 9.0
            assert "sc_uptime_seconds" in fams
            theirs = jm.scrape(srv.address + "/metrics")
            assert {k for k in theirs if k != "sc_uptime_seconds"} == {k for k in fams if k != "sc_uptime_seconds"}
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(srv.address + "/nope")
            assert e.value.code == 404
        # a render that raises answers a comment, never takes the process down
        with tm.MetricsServer(lambda: 1 / 0) as bad:
            body = urllib.request.urlopen(bad.address + "/metrics").read().decode()
            assert body.startswith("# render failed") and tm.parse_prometheus(body) == {}
        # the JAX listener, read by the port's scraper
        with jm.MetricsServer(lambda: GOLDEN.read_text()) as theirs_srv:
            assert tm.scrape(theirs_srv.address) == tm.parse_prometheus(GOLDEN.read_text())
    finally:
        tel.close()


def test_write_metrics_file_replaces_atomically(tmp_path):
    with RunTelemetry(out_dir=None, run_name="t") as tel:
        tel.counter_inc("x", 1)
        p = tm.write_metrics_file(tel, tmp_path / "m" / "w.prom")
        first = p.read_text()
        tel.counter_inc("x", 1)
        assert tm.write_metrics_file(tel, p) == p
        second = p.read_text()
    assert "sc_x_total 1\n" in first and "sc_x_total 2\n" in second
    assert not list((tmp_path / "m").glob(".*.tmp"))
    assert tm.family_value(jm.parse_prometheus(second), "x", "_total") == 2.0


def test_router_mounts_metrics(tmp_path):
    from sparse_coding__tpu_torch.models.learned_dict import TiedSAE
    from sparse_coding__tpu_torch.serve.registry import DictRegistry
    from sparse_coding__tpu_torch.serve.router import Router
    from sparse_coding__tpu_torch.serve.server import ServeServer

    reg = DictRegistry(device="cpu")
    rng = np.random.default_rng(0)
    for i in range(2):
        reg.add(f"d{i}", TiedSAE(torch.from_numpy(rng.standard_normal((N, D), dtype=np.float32)), torch.zeros(N)))
    tel = RunTelemetry(out_dir=tmp_path, run_name="router", file_name="router_events.jsonl")
    srv = ServeServer(reg, max_batch=64, max_wait_ms=1.0).start()
    router = Router({"r0": srv.address}, telemetry=tel, health_interval=30.0).start()
    try:
        client = router.client()
        for _ in range(4):
            client.encode("d0", rng.standard_normal((2, D)).astype(np.float32))
        fams = tm.scrape(router.address)
        assert tm.family_value(fams, "router.requests", "_total") == 4.0
        assert tm.family_value(fams, "router.ok", "_total") == 4.0
        assert tm.family_value(fams, "router.live_replicas") == 1.0
        assert tm.family_value(fams, "router.replica.r0.state") == 0.0  # live
        with Router({"r0": srv.address}, health_interval=30.0) as bare:
            fams2 = tm.scrape(bare.address)
            assert tm.family_value(fams2, "router.replicas") == 1.0
            assert tm.family_value(fams2, "router.requests", "_total") == 0.0
    finally:
        router.stop()
        srv.stop()
        tel.close()
