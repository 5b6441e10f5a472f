"""The port's supervisor (`sparse_coding__tpu_torch/supervise.py`) held against
the JAX package's `supervise.py` on the same inputs, on the CPU.

Exit classification, the backoff schedule with the same seeded
`random.Random`, `RestartBudget` through the same `note_healthy` sequence,
and `run_supervised` over the same trivial children (75 twice then 0, an
always-crashing one, a healthy-stretch reset): the same exit codes, outcomes
and the same sequence of supervisor records. Equality is exact: the modules
are stdlib arithmetic. Then the port's CLI end to end in a subprocess.
"""

import json
import os
import random
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from sparse_coding__tpu import supervise as jsup
from sparse_coding__tpu.telemetry import RunTelemetry as JRunTelemetry
from sparse_coding__tpu_torch import supervise as tsup
from sparse_coding__tpu_torch.telemetry import RunTelemetry

REPO = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": (jsup, JRunTelemetry), "port": (tsup, RunTelemetry)}


@pytest.mark.parametrize("rc", [0, 75, -9, -15, 1, 2])
def test_classify_exit_matches_the_jax_package(tmp_path, rc):
    assert tsup.classify_exit(rc) == jsup.classify_exit(rc)
    assert tsup.classify_exit(rc, run_dir=str(tmp_path)) == jsup.classify_exit(rc, run_dir=str(tmp_path))


def test_classify_exit_reads_an_abort_in_the_run_dir(tmp_path):
    (tmp_path / "sub").mkdir()
    with open(tmp_path / "sub" / "events.jsonl", "w") as f:
        f.write(json.dumps({"seq": 1, "ts": 100.0, "event": "anomaly", "kind": "nonfinite", "action": "abort"}) + "\n")
        f.write('{"torn": \n')
    for since, want in ((50.0, "anomaly-abort"), (200.0, "crash")):
        for rc in (1, 2):
            got = [m.classify_exit(rc, run_dir=str(tmp_path), since_ts=since) for m in (tsup, jsup)]
            assert got == [want, want]
    # a signal death and a preemption never read the run dir
    assert tsup.classify_exit(-9, run_dir=str(tmp_path), since_ts=50.0) == "killed"
    assert tsup.classify_exit(75, run_dir=str(tmp_path), since_ts=50.0) == "preempt"


@pytest.mark.parametrize("jitter", [0.0, 0.25, 0.5])
def test_compute_backoff_matches_the_jax_package(jitter):
    for base, cap in ((1.0, 60.0), (0.05, 2.0), (0.5, 30.0)):
        a, b = random.Random(7), random.Random(7)
        got = [tsup.compute_backoff(k, base=base, cap=cap, jitter=jitter, rng=a) for k in range(10)]
        want = [jsup.compute_backoff(k, base=base, cap=cap, jitter=jitter, rng=b) for k in range(10)]
        assert got == want
    assert [tsup.compute_backoff(k, jitter=0.0) for k in range(8)] == [1, 2, 4, 8, 16, 32, 60, 60]


def test_restart_budget_matches_the_jax_package():
    """The same charge / note_healthy sequence through both budgets: the
    same delays, exhaustion and clears at every step."""
    seq = ["delay", "charge", "healthy:3", "delay", "charge", "exhausted", "healthy:12", "delay", "charge",
           "healthy:9.99", "charge", "charge", "exhausted", "healthy:10", "delay"]

    def trace(mod):
        b = mod.RestartBudget(max_restarts=3, backoff_base=0.5, backoff_max=30.0, jitter=0.1, reset_after=10.0,
                              rng=random.Random(3))
        out = []
        for op in seq:
            if op == "delay":
                out.append(b.next_delay())
            elif op == "charge":
                out.append(b.charge())
            elif op == "exhausted":
                out.append(b.exhausted)
            else:
                out.append(b.note_healthy(float(op.split(":")[1])))
            out.append(b.attempt)
        return out

    assert trace(tsup) == trace(jsup)
    b = tsup.RestartBudget(max_restarts=1, reset_after=None)
    b.charge()
    assert b.note_healthy(1e9) == 0 and b.exhausted


def _child(tmp_path, name: str, body: str) -> list:
    script = tmp_path / f"{name}.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys, time
        state = {str(tmp_path / (name + '.state'))!r}
        n = int(open(state).read()) if os.path.exists(state) else 0
        open(state, "w").write(str(n + 1))
        assert (os.environ.get("SC_RESUME") == "1") == (n > 0), "resume env wiring"
    """) + textwrap.dedent(body))
    return [sys.executable, str(script)]


_RECORD_KEYS = {
    "spawn": ("attempt", "generation", "resume"),
    "restart": ("attempt", "generation", "exit_code", "classification", "backoff_seconds"),
    "backoff_reset": ("attempts_cleared",),
    "give_up": ("reason", "exit_code"),
    "budget_exhausted": ("restarts", "exit_code"),
}


def _supervise(tmp_path, pkg: str, body: str, **kw):
    """One `run_supervised` run of a child through one package: (rc,
    outcome, the child's generations, the supervisor records' deterministic
    fields)."""
    mod, tel_cls = PACKAGES[pkg]
    run_dir = tmp_path / pkg / "run"
    (tmp_path / pkg).mkdir()
    cmd = _child(tmp_path / pkg, "child", body)
    tel = tel_cls(out_dir=str(run_dir), run_name="supervisor", file_name="supervisor_events.jsonl")
    outcome: dict = {}
    try:
        rc = mod.run_supervised(cmd, run_dir=str(run_dir), backoff_base=0.01, jitter=0.0, telemetry=tel,
                                outcome=outcome, **kw)
    finally:
        tel.close()
    recs = [json.loads(line) for line in (run_dir / "supervisor_events.jsonl").read_text().splitlines()]
    seq = [(r["event"], *(r.get(k) for k in _RECORD_KEYS[r["event"]])) for r in recs if r["event"] in _RECORD_KEYS]
    spans = [r["category"] for r in recs if r["event"] == "span"]
    return rc, outcome.get("reason"), int((tmp_path / pkg / "child.state").read_text()), seq, spans


@pytest.mark.parametrize("case", ["preempt_twice_then_ok", "always_crashes", "crash_restarted_on_any",
                                  "budget_exhausted", "healthy_reset"])
def test_run_supervised_matches_the_jax_package(tmp_path, case):
    body, kw = {
        "preempt_twice_then_ok": ("sys.exit(75 if n < 2 else 0)", {}),
        "always_crashes": ("sys.exit(3)", {}),
        "crash_restarted_on_any": ("sys.exit(3 if n < 1 else 0)", {"restart_on": "any"}),
        "budget_exhausted": ("sys.exit(75)", {"max_restarts": 2}),
        "healthy_reset": ("time.sleep(0.3)\nsys.exit(75 if n < 3 else 0)", {"max_restarts": 2,
                                                                           "backoff_reset_after": 0.1}),
    }[case]
    port = _supervise(tmp_path, "port", body, **kw)
    ref = _supervise(tmp_path, "jax", body, **kw)
    assert port[:4] == ref[:4]
    assert port[4] == ref[4] == ["restart_backoff"] * sum(1 for r in port[3] if r[0] == "restart")
    rc, reason, generations, seq, _ = port
    assert (rc, reason, generations) == {
        "preempt_twice_then_ok": (0, "ok", 3), "always_crashes": (3, "crash", 1),
        "crash_restarted_on_any": (0, "ok", 2), "budget_exhausted": (75, "budget_exhausted", 3),
        "healthy_reset": (0, "ok", 4)}[case]
    if case == "healthy_reset":
        assert [r[1] for r in seq if r[0] == "restart"] == [1, 1, 1]


def test_run_supervised_rejects_an_unknown_policy():
    with pytest.raises(ValueError, match="restart_on"):
        tsup.run_supervised(["true"], restart_on="sometimes")


def test_supervise_cli_rides_through_preemptions(tmp_path):
    """``python -m sparse_coding__tpu_torch.supervise``: two preemptions then
    exit 0; with a budget of 1 against an always-75 child, exit 75."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    base = [sys.executable, "-m", "sparse_coding__tpu_torch.supervise", "--backoff-base", "0.05", "--jitter", "0"]
    res = subprocess.run([*base, "--run-dir", str(tmp_path / "run"), "--",
                          *_child(tmp_path, "ok", "sys.exit(75 if n < 2 else 0)")],
                         env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    recs = [json.loads(line) for line in (tmp_path / "run" / "supervisor_events.jsonl").read_text().splitlines()]
    assert [r["attempt"] for r in recs if r["event"] == "restart"] == [1, 2]
    assert recs[0]["event"] == "run_start" and recs[-1]["event"] == "run_end" and recs[-1]["status"] == "ok"
    res = subprocess.run([*base, "--run-dir", str(tmp_path / "run2"), "--max-restarts", "1", "--",
                          *_child(tmp_path, "loop", "sys.exit(75)")],
                         env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 75, res.stderr
    res = subprocess.run(base, env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 2 and "no driver command" in res.stderr
