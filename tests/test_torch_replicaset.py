"""The port's replica tier on the CPU: two ``--device cpu`` server processes
under `serve.replicaset.ReplicaSet`, behind `serve.router.Router`, under
closed-loop traced load from 4 client threads.

1. One replica is SIGKILLed mid-flight: no client sees a failure (every
   response a bit-correct 200 or a clean retryable rejection), the router
   marks the replica dead, and the supervisor relaunches it (a new process,
   ``replica_ready`` with ``downtime_seconds``).
2. A request the kill forced to retry is traced on both replicas under one
   trace id; the winning attempt's replica is the response's
   ``X-Router-Replica``, and the traced phases and gaps add up to no more than
   the client's latency (the client's window encloses the server-side
   records; 1 ms covers their microsecond rounding). JAX's copy of this check
   sums the phases to the client latency within 5% + 10 ms and fails on host
   jitter (ROADMAP §C, "Flakes"), so the port's holds the structure instead.
3. `rolling_swap` to generation 1 under the same load: nothing dropped and
   nothing torn, both generations served.

Each response is held to the port's bit contract, not to the unpadded
``ld.encode`` JAX's test compares with: the stack of one (`encode_naive`) of
the generation the response declares, at the response's ``bucket``, computed
in this process (ROADMAP §C, "Serving": on the CPU a row's bits can depend
on the padded batch).
"""

import json
import os
import signal
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from sparse_coding__tpu_torch.models.learned_dict import TiedSAE
from sparse_coding__tpu_torch.serve.engine import EncodeEngine
from sparse_coding__tpu_torch.serve.registry import DictRegistry
from sparse_coding__tpu_torch.serve.replicaset import ReplicaSet
from sparse_coding__tpu_torch.serve.router import Router, RouterClient, ShedRejection
from sparse_coding__tpu_torch.serve.server import RetryableRejection
from sparse_coding__tpu_torch.telemetry import RunTelemetry
from sparse_coding__tpu_torch.telemetry.tracing import _load_records, collect_traces, mint_trace_id, trace_summary
from sparse_coding__tpu_torch.train.checkpoint import save_learned_dicts

pytestmark = [pytest.mark.serve, pytest.mark.chaos]

REPO = Path(__file__).resolve().parents[1]
D, N = 16, 64


def _tied(seed: int) -> TiedSAE:
    rng = np.random.default_rng(seed)
    return TiedSAE(torch.from_numpy(rng.standard_normal((N, D), dtype=np.float32)),
                   torch.from_numpy(rng.standard_normal(N, dtype=np.float32) * 0.1))


def _export(path: Path, seeds) -> Path:
    path.mkdir()
    save_learned_dicts(path / "learned_dicts.pkl", [(_tied(s), {}) for s in seeds])
    return path / "learned_dicts.pkl"


def _wait(cond, timeout: float, what: str) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.05)
    pytest.fail(f"timed out after {timeout} s waiting for {what}")


def test_kill_traced_retry_and_rolling_swap_under_load(tmp_path):
    exports = [_export(tmp_path / "gen0", (0, 1)), _export(tmp_path / "gen1", (10, 11))]
    refs = []
    for export in exports:
        reg = DictRegistry(device="cpu")
        reg.load_export(export)
        refs.append(EncodeEngine(reg, max_batch=64))
    ref_lock = threading.Lock()
    payloads = [np.random.default_rng(40 + i).standard_normal((n, D)).astype(np.float32) for i, n in
                enumerate((1, 3, 5, 12))]

    run_dir = tmp_path / "tier"
    router_tel = RunTelemetry(out_dir=run_dir, run_name="router", file_name="router_events.jsonl")
    rs_tel = RunTelemetry(out_dir=run_dir, run_name="replicaset", file_name="replicaset_events.jsonl")
    router = Router(telemetry=router_tel, health_interval=0.25, dead_after=2, max_attempts=4, retry_backoff=0.05,
                    request_deadline=60.0, attempt_timeout=30.0)
    rs = ReplicaSet([str(exports[0])], n_replicas=2, run_dir=run_dir, router=router, telemetry=rs_tel, max_batch=64,
                    max_wait_ms=2.0, backoff_base=0.2, backoff_max=2.0, poll_interval=0.1, ready_timeout=120.0,
                    env={"SC_PREEMPT": "1", "PYTHONPATH": str(REPO)}, device="cpu")
    out = {"ok": 0, "retried_ok": 0, "shed": 0, "rejected": 0, "bad": [], "by_gen": {0: 0, 1: 0}, "results": []}
    lock = threading.Lock()
    stop = threading.Event()

    def client_loop(cid: int):
        client = RouterClient(router.address, timeout=60)
        i = 0
        while not stop.is_set():
            did, X = f"learned_dicts:{(cid + i) % 2}", payloads[(cid + i) % len(payloads)]
            i += 1
            tid = mint_trace_id()
            t0 = time.monotonic()
            try:
                codes, meta = client.encode_with_meta(did, X, trace=tid)
            except ShedRejection:
                with lock:
                    out["shed"] += 1
                time.sleep(0.05)
                continue
            except RetryableRejection:
                with lock:
                    out["rejected"] += 1
                time.sleep(0.05)
                continue
            except Exception as e:  # anything unclean is a failure
                with lock:
                    out["bad"].append(repr(e))
                continue
            latency = time.monotonic() - t0
            gen, bucket = meta["generation"], client.last_meta["bucket"]
            if gen not in (0, 1):
                with lock:
                    out["bad"].append(f"unknown generation {gen!r}")
                continue
            with ref_lock:
                want = refs[gen].encode_naive(did, X, bucket=bucket)
            with lock:
                if np.array_equal(codes, want):
                    out["ok"] += 1
                    out["by_gen"][gen] += 1
                    out["retried_ok"] += meta["attempts"] > 1
                    out["results"].append((tid, latency, meta))
                else:
                    out["bad"].append(f"wrong or torn codes for {did} gen {gen} bucket {bucket}")

    def ok_at_least(n):
        with lock:
            return out["ok"] >= n

    threads = [threading.Thread(target=client_loop, args=(c,)) for c in range(4)]
    try:
        rs.start()
        router.start()
        assert set(router.states().values()) == {"live"}
        for t in threads:
            t.start()
        _wait(lambda: ok_at_least(16), 60, "load to reach 16 responses")

        # -- 1. SIGKILL a replica mid-flight -------------------------------------
        victim = rs.replicas[1]
        victim_pid = victim.proc.pid
        os.kill(victim_pid, signal.SIGKILL)
        _wait(lambda: router.states()["replica1"] in ("dead", "suspect"), 10, "the router to see the kill")
        _wait(lambda: router.states()["replica1"] == "live" and rs.states()["replica1"] == "running", 90,
              f"the killed replica to be readmitted (router {router.states()}, set {rs.states()})")
        assert rs.replicas[1].proc.pid != victim_pid, "no new process spawned"
        with lock:
            n = out["ok"]
        _wait(lambda: ok_at_least(n + 12), 60, "traffic across the healed set")

        # -- 3. rolling swap to generation 1 under load ---------------------------
        assert rs.rolling_swap([str(exports[1])]) == 1
        with lock:
            n = out["ok"]
        _wait(lambda: ok_at_least(n + 12), 60, "traffic after the swap")
        stop.set()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        client = RouterClient(router.address, timeout=60)
        for i in range(4):
            codes, meta = client.encode_with_meta(f"learned_dicts:{i % 2}", payloads[0])
            assert meta["generation"] == 1
            np.testing.assert_array_equal(codes, refs[1].encode_naive(f"learned_dicts:{i % 2}", payloads[0],
                                                                      bucket=client.last_meta["bucket"]))
        stats = dict(router.stats)
    finally:
        stop.set()
        rs.stop()
        router.stop()
        router_tel.close()
        rs_tel.close()

    assert out["bad"] == [], out["bad"][:5]
    assert out["by_gen"][0] > 0 and out["by_gen"][1] > 0
    assert stats["failed"] == 0 and stats["retries"] >= 1 and out["retried_ok"] >= 1

    # -- supervision records --------------------------------------------------------
    events = [json.loads(line) for line in (run_dir / "replicaset_events.jsonl").read_text().splitlines()]
    exits = [e for e in events if e["event"] == "replica_exit"]
    assert [(e["replica"], e["classification"]) for e in exits] == [("replica1", "killed")]
    assert [e["replica"] for e in events if e["event"] == "replica_restart"] == ["replica1"]
    readies = [e for e in events if e["event"] == "replica_ready" and e.get("downtime_seconds") is not None]
    assert [e["replica"] for e in readies] == ["replica1"] and readies[0]["downtime_seconds"] > 0
    swapped = [e["replica"] for e in events if e["event"] == "replica_swapped"]
    assert swapped == ["replica0", "replica1"] and any(e["event"] == "rolling_swap_done" for e in events)
    router_events = [json.loads(line) for line in (run_dir / "router_events.jsonl").read_text().splitlines()]
    # dead by the failed forwards or by the supervisor's mark_down, whichever came first
    assert ("replica1", "dead") in {(e["replica"], e["to"]) for e in router_events
                                    if e["event"] == "router_replica_state"}
    for i in range(2):
        starts = [e for e in (json.loads(line) for line in (run_dir / f"replica{i}" / "events.jsonl").read_text()
                              .splitlines()) if e["event"] == "run_start"]
        assert starts and all(s["config"]["device"] == "cpu" for s in starts)

    # -- 2. the retried request's trace ---------------------------------------------
    traces = collect_traces(_load_records(run_dir))
    retried = [(tid, lat, meta) for tid, lat, meta in out["results"] if meta["attempts"] > 1 and tid in traces]
    assert retried, "no retried request was traced"
    spans_both = 0
    for tid, latency, meta in retried:
        s = trace_summary(tid, traces[tid])
        assert s["n_attempts"] >= 2, s
        assert s["winner"] == meta["replica"], (s, meta)
        assert sum(s["phases"].values()) + s["gap_seconds"] <= latency + 1e-3, (s, latency)
        spans_both += s["replicas"] == ["replica0", "replica1"]
    assert spans_both, "no retried request's trace spans both replicas"


def test_a_replica_that_cannot_take_the_card_is_a_crash_not_a_cpu_fallback(tmp_path):
    """With no device named, a replica serves on the card; one that finds no
    card exits non-zero, is counted as a crash and restarted from its budget,
    and a set whose replicas never come up fails to start."""
    export = _export(tmp_path / "gen0", (0,))
    run_dir = tmp_path / "tier"
    with RunTelemetry(out_dir=run_dir, run_name="replicaset", file_name="replicaset_events.jsonl") as tel:
        rs = ReplicaSet([str(export)], n_replicas=1, run_dir=run_dir, telemetry=tel, max_restarts=1,
                        backoff_base=0.05, jitter=0.0, poll_interval=0.05, ready_timeout=60.0,
                        env={"CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(REPO)})
        with pytest.raises(TimeoutError, match="never became ready"):
            rs.start()
    events = [json.loads(line) for line in (run_dir / "replicaset_events.jsonl").read_text().splitlines()]
    assert [e["classification"] for e in events if e["event"] == "replica_exit"] == ["crash", "crash"]
    assert [e["event"] for e in events if e["event"].startswith("replica_budget")] == ["replica_budget_exhausted"]
    log = (run_dir / "replica0" / "server.log").read_text()
    assert "no CUDA device" in log and "listening" not in log
