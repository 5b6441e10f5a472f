"""The port's trace collectors and renderers (`telemetry/tracing.py`, the
``python -m sparse_coding__tpu_torch.trace`` CLI) held against the JAX
package's on the records of the golden run dirs, on the CPU.

The records loaded from `tests/golden/traced_run` and `tests/golden/router_run`
(the JAX loader's, `goodput.load_streams`), `collect_traces`, `trace_summary`
per trace, `render_trace` per trace, `render_slowest` for every N and the CLI's
stdout and exit code for every mode: equal to JAX's, exactly (string output
of the same stdlib arithmetic). The CLI shim is run once as a module.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from sparse_coding__tpu.telemetry import tracing as jt
from sparse_coding__tpu.telemetry.goodput import load_streams
from sparse_coding__tpu_torch.telemetry import tracing as tt

pytestmark = pytest.mark.serve

REPO = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).parent / "golden"
RUNS = ["traced_run", "router_run"]
TRACE_RETRIED = "aaaa1111aaaa1111aaaa1111aaaa1111"


def _jax_records(run_dir):
    return [r for s in load_streams(run_dir) for r in s["records"]]


@pytest.mark.parametrize("run", RUNS)
def test_records_and_traces_match_the_jax_package(run):
    records = tt._load_records(GOLDEN / run)
    assert records == _jax_records(GOLDEN / run)
    traces = tt.collect_traces(records)
    assert traces == jt.collect_traces(records)
    for tid, t in traces.items():
        assert tt.trace_summary(tid, t) == jt.trace_summary(tid, t)
        assert tt.render_trace(tid, t) == jt.render_trace(tid, t)
    for n in (0, 1, 2, 3, 10):
        assert tt.render_slowest(traces, n) == jt.render_slowest(traces, n)
    if run == "traced_run":
        assert len(traces) == 3
        s = tt.trace_summary(TRACE_RETRIED, traces[TRACE_RETRIED])
        assert s["replicas"] == ["replica0", "replica1"] and s["winner"] == "replica1" and s["n_attempts"] == 2
        out = tt.render_trace(TRACE_RETRIED, traces[TRACE_RETRIED])
        assert "forward attempt 0 → replica0  [error:ConnectionResetError]" in out and "retry gap 50.0 ms" in out
    else:
        assert traces == {}  # the router fixture predates tracing


def test_orphans_hedges_and_missing_fields_render_alike():
    """Records off the golden path: a hedge, a replica record with no
    parent (direct traffic), one with no phases, a NaN field, a span with no
    seconds."""
    records = [
        {"event": "span", "category": "forward", "trace_id": "t1", "span_id": "s1", "replica": "r0", "attempt": 0,
         "hedge": False, "status": "error:TimeoutError", "ts_start": 10.0, "seconds": 0.2},
        {"event": "span", "category": "forward", "trace_id": "t1", "span_id": "s2", "replica": "r1", "attempt": 0,
         "hedge": True, "status": 200, "ts_start": 10.04, "seconds": 0.05},
        {"event": "request_trace", "trace_id": "t1", "parent_span": "s2", "replica": "r1", "dict": "d0", "rows": 3,
         "latency_ms": 40.0, "ts_start": 10.045, "phases": {"request_wait": 0.01, "encode": 0.02, "dequant": float("nan")},
         "bucket": 8, "lanes": 2, "n_requests": 3},
        {"event": "request_trace", "trace_id": "t2", "parent_span": None, "replica": "r0", "dict": "d1", "rows": 1,
         "latency_ms": 5.0, "ts_start": 11.0, "phases": {}},
        {"event": "span", "category": "forward", "trace_id": "t3", "span_id": "s3", "replica": "r0", "status": 503},
        {"event": "span", "category": "encode", "traces": ["t1", "t2"], "ts_start": 10.05, "seconds": 0.02},
        {"event": "request_trace", "trace_id": None},
    ]
    traces = tt.collect_traces(records)
    assert set(traces) == {"t1", "t2", "t3"}
    for tid, t in traces.items():
        assert tt.render_trace(tid, t) == jt.render_trace(tid, t)
        assert tt.trace_summary(tid, t) == jt.trace_summary(tid, t)
    assert tt.render_slowest(traces, 5) == jt.render_slowest(traces, 5)
    assert "HEDGE forward attempt 0 → r1" in tt.render_trace("t1", traces["t1"])


ARGVS = [["--trace-id", "aaaa"], ["--trace-id", "ffff"], ["--trace-id", "aaaa", "--json"], ["--slowest", "2"],
         ["--slowest", "3", "--json"], [], ["--list"], ["--json"]]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "inventory")
@pytest.mark.parametrize("run", RUNS)
def test_cli_output_and_exit_codes_match_the_jax_package(run, argv, capsys):
    rc = tt.main([str(GOLDEN / run), *argv])
    ours = capsys.readouterr().out
    want_rc = jt.main([str(GOLDEN / run), *argv])
    assert (rc, ours) == (want_rc, capsys.readouterr().out)
    if run == "router_run":
        assert rc == 3 and "no traced records" in ours
    elif argv[:2] == ["--trace-id", "ffff"]:
        assert rc == 2
    else:
        assert rc == 0


def test_cli_exit_codes_on_missing_and_empty_dirs(tmp_path, capsys):
    assert tt.main([str(tmp_path / "absent")]) == 3
    (tmp_path / "empty").mkdir()
    assert tt.main([str(tmp_path / "empty")]) == 3
    assert "no traced records" in capsys.readouterr().out


def test_trace_module_runs_as_a_cli():
    res = subprocess.run([sys.executable, "-m", "sparse_coding__tpu_torch.trace", str(GOLDEN / "traced_run"),
                          "--trace-id", "aaaa", "--json"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout)["winner"] == "replica1"
