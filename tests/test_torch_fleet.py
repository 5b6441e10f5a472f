"""The port's fleet scheduler (`sparse_coding__tpu_torch/fleet/`) against the
JAX package's (`tests/test_fleet.py`, case for case), and the two packages
on one fleet directory.

  - **unit** — queue claim atomicity, lease renewal/expiry, quarantine,
    watermark-aware packing, export-manifest verification;
  - **in-process chaos** (``chaos``) — an 8-member sweep over 3 workers
    with a simulated worker death (fault + abandoned lease), a torn
    checkpoint and a transient read error finishes with ZERO lost members,
    every member's dicts bit-equal to an uninterrupted run's, and the fleet
    report renders the reassignment lineage;
  - **subprocess chaos** (``slow`` + ``chaos``) — the same story with real
    worker processes (``--device cpu``) and a real SC_FAULT SIGKILL;
  - **across packages** — a queue either package filled and reaps is served
    by the other's worker; each package's `verify_export` accepts the
    other's run dirs; the report, the monitor's fleet view, the goodput
    gaps and the tower's fleet gauges give JAX's output on
    `tests/golden/fleet_run` and on fleet dirs either package wrote.

Every worker here trains on the CPU (``device="cpu"``): without it a worker
raises, as the last test shows.
"""

import contextlib
import importlib
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from sparse_coding__tpu_torch.data.chunks import save_chunk
from sparse_coding__tpu_torch.fleet import (
    FleetScheduler,
    FleetWorker,
    LeaseLost,
    WorkQueue,
    build_sweep_items,
    load_fleet,
    member_bytes_from_run,
    pack_members,
    render_fleet_markdown,
    verify_export,
    write_export_manifest,
)
from sparse_coding__tpu_torch.telemetry import RunTelemetry
from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib
from sparse_coding__tpu_torch.train import preemption
from sparse_coding__tpu_torch.utils import faults

REPO = Path(__file__).resolve().parent.parent
GOLDEN_FLEET = Path(__file__).parent / "golden" / "fleet_run"
CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_fault_state(monkeypatch):
    monkeypatch.delenv(faults.FAULT_ENV, raising=False)
    monkeypatch.setenv("SC_SYNC_BACKOFF", "0")
    faults.reset()
    preemption.reset()
    yield
    faults.reset()
    preemption.reset()


def _worker(fleet, wid, **kw):
    return FleetWorker(fleet, wid, device=CPU, **kw)


# -- queue semantics ----------------------------------------------------------

def _submit(q, item_id, members=("m0", "m1")):
    return q.submit(item_id, list(members), {"driver": "noop"})


def test_claim_is_exclusive_and_ordered(tmp_path):
    q = WorkQueue(tmp_path)
    _submit(q, "g0")
    _submit(q, "g1")
    a = q.claim("w0", lease_seconds=30)
    b = q.claim("w1", lease_seconds=30)
    assert a["item"] == "g0" and b["item"] == "g1", "sorted order, one winner each"
    assert q.claim("w2", lease_seconds=30) is None, "queue drained"
    assert a["lineage"][-1]["worker"] == "w0"
    assert {l["item"] for l in q.leases()} == {"g0", "g1"}
    assert not q.finished(), "leased items are outstanding work"
    with pytest.raises(FileExistsError):
        _submit(q, "g0")
    with pytest.raises(ValueError, match="invalid item id"):
        _submit(q, "../g2")


def test_renew_extends_and_reap_reassigns(tmp_path):
    q = WorkQueue(tmp_path)
    _submit(q, "g0")
    q.claim("w0", lease_seconds=10)
    lease = q.renew("g0", "w0", lease_seconds=10)
    assert lease["renewals"] == 1
    assert q.renew("g0", "w0", lease_seconds=10)["renewals"] == 2
    with pytest.raises(LeaseLost):
        q.renew("g0", "w1", lease_seconds=10)
    actions = q.reap_expired(now=time.time() + 60, quarantine_after=3)
    assert [a["kind"] for a in actions] == ["lease_expired"]
    assert actions[0]["worker"] == "w0" and actions[0]["requeued_to"] == "pending"
    item = q.items("pending")[0]
    assert item["attempt"] == 1
    assert item["lineage"][-1]["outcome"] == "lease_expired"
    assert q.worker_record("w0")["strikes"] == 1
    with pytest.raises(LeaseLost):
        q.renew("g0", "w0")


def test_complete_commits_exactly_once(tmp_path):
    q = WorkQueue(tmp_path)
    _submit(q, "g0", members=("a", "b", "c"))
    q.claim("w0", lease_seconds=30)
    done = q.complete("g0", "w0", result={"verified": True, "export_digest": "ab" * 32})
    assert done["lineage"][-1]["outcome"] == "done"
    assert done["lineage"][-1]["export_digest"] == "ab" * 32
    assert q.finished() and not q.leases()
    assert q.state()["members"]["done"] == 3
    with pytest.raises(LeaseLost):
        q.complete("g0", "w0")


def test_fail_requeues_then_exhausts_budget(tmp_path):
    q = WorkQueue(tmp_path)
    _submit(q, "g0")
    q.claim("w0", lease_seconds=30)
    assert q.fail("g0", "w0", "boom", max_attempts=2) == "pending"
    assert q.items("pending")[0]["attempt"] == 1
    q.claim("w1", lease_seconds=30)
    assert q.fail("g0", "w1", "boom again", max_attempts=2) == "failed"
    state = q.state()
    assert state["members"]["lost"] == 2 and q.finished()
    assert [e["outcome"] for e in q.items("failed")[0]["lineage"]] == ["failed", "failed"]


def test_release_returns_item_without_penalty(tmp_path):
    q = WorkQueue(tmp_path)
    _submit(q, "g0")
    q.claim("w0", lease_seconds=30)
    q.release("g0", "w0", outcome="preempted")
    item = q.items("pending")[0]
    assert item["attempt"] == 0 and item["lineage"][-1]["outcome"] == "preempted"


def test_repeat_offender_quarantined(tmp_path):
    q = WorkQueue(tmp_path)
    for i in range(3):
        _submit(q, f"g{i}")
    for i in range(2):
        assert q.claim("w0", lease_seconds=5) is not None
        kinds = [a["kind"] for a in q.reap_expired(now=time.time() + 60, quarantine_after=2)]
        assert "lease_expired" in kinds
        if i == 1:
            assert "quarantine" in kinds
    assert q.worker_quarantined("w0")
    assert q.claim("w0", lease_seconds=5) is None
    assert q.claim("w1", lease_seconds=5) is not None


def test_orphaned_claim_without_lease_is_reaped(tmp_path):
    q = WorkQueue(tmp_path)
    _submit(q, "g0")
    q.claim("w0", lease_seconds=30)
    q._lease_path("g0").unlink()
    assert q.reap_expired(now=time.time(), grace_seconds=3600) == []
    actions = q.reap_expired(now=time.time() + 7200, grace_seconds=3600)
    assert [a["kind"] for a in actions] == ["lease_expired"]
    assert q.items("pending")[0]["attempt"] == 1


def test_state_counts_orphaned_members(tmp_path):
    q = WorkQueue(tmp_path)
    _submit(q, "g0")
    _submit(q, "g1", members=("x",))
    q.claim("w0", lease_seconds=0.0)
    assert q.state(now=time.time() + 1)["members"] == {
        "queued": 1, "running": 0, "orphaned": 2, "done": 0, "lost": 0,
    }


# -- packing ------------------------------------------------------------------

def test_pack_members_budget_math():
    members = list(range(8))
    assert pack_members(members) == [members]
    groups = pack_members(members, bytes_per_member=1.0, hbm_budget_bytes=2.5, reserve_fraction=0.2)
    assert [len(g) for g in groups] == [2, 2, 2, 2]
    assert [len(g) for g in pack_members(members, max_members_per_item=3)] == [3, 3, 2]
    assert pack_members([]) == []


def test_pack_members_from_device_watermarks(tmp_path):
    """Per-member bytes from a previous run's ``hbm.*.peak_bytes_in_use``
    gauges (the port's drivers record the card's peak there), the same
    numbers JAX's packing reads from the same run dir."""
    from sparse_coding__tpu.fleet import member_bytes_from_run as j_member_bytes
    from sparse_coding__tpu.fleet import pack_members as j_pack

    with RunTelemetry(out_dir=str(tmp_path / "prev"), run_name="probe") as t:
        t.run_start()
        t.gauge_set("hbm.d0.peak_bytes_in_use", 8.0e9)
        t.gauge_set("hbm.d0.bytes_limit", 16.0e9)
    assert member_bytes_from_run(tmp_path / "prev", 4) == pytest.approx(2.0e9)
    kw = dict(watermark_run_dir=tmp_path / "prev", watermark_members=4, hbm_budget_bytes=16.0e9,
              reserve_fraction=0.25)
    groups = pack_members(list(range(8)), **kw)
    assert [len(g) for g in groups] == [6, 2]
    assert groups == j_pack(list(range(8)), **kw)
    assert member_bytes_from_run(tmp_path / "prev", 0) is None
    assert j_member_bytes(tmp_path / "prev", 4) == member_bytes_from_run(tmp_path / "prev", 4)


# -- export manifests ---------------------------------------------------------

def test_export_manifest_verify_and_corruption(tmp_path):
    run = tmp_path / "run"
    (run / "epoch_0").mkdir(parents=True)
    (run / "epoch_0" / "learned_dicts.pkl").write_bytes(b"dict-bytes-1")
    assert verify_export(run) == (False, "no export manifest")
    write_export_manifest(run)
    ok, reason = verify_export(run)
    assert ok, reason
    (run / "epoch_0" / "learned_dicts.pkl").write_bytes(b"dict-bytes-2")
    ok, reason = verify_export(run)
    assert not ok and "digest mismatch" in reason
    (run / "epoch_0" / "learned_dicts.pkl").write_bytes(b"truncated")
    ok, reason = verify_export(run)
    assert not ok and "size mismatch" in reason


def test_empty_export_never_verifies(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    write_export_manifest(run)
    ok, reason = verify_export(run)
    assert not ok and "no exports" in reason


# -- real training items ------------------------------------------------------

def _make_dataset(folder, n_chunks=2, rows=128, width=8):
    rng = np.random.default_rng(0)
    for i in range(n_chunks):
        save_chunk(folder, i, rng.normal(size=(rows, width)).astype(np.float16))


def _base_kwargs(dataset):
    return dict(dataset_folder=str(dataset), activation_width=8, dict_ratio=2.0, batch_size=64, n_epochs=1,
                lr=1e-3, fista_iters=2, seed=0, checkpoint_every=1)


def test_worker_trains_verifies_and_commits(tmp_path):
    dataset = tmp_path / "data"
    _make_dataset(dataset)
    fleet = tmp_path / "fleet"
    q = WorkQueue(fleet)
    build_sweep_items(q, [[1e-4, 1e-3]], _base_kwargs(dataset))
    w = _worker(fleet, "w0", lease_seconds=30)
    assert w.claim_and_run() == "done"
    assert w.claim_and_run() == "idle"
    assert q.finished()
    item = q.items("done")[0]
    assert item["result"]["verified"] is True
    run_dir = q.run_dir("g0")
    assert verify_export(run_dir)[0]
    dicts = ckpt_lib.load_learned_dicts(run_dir / "epoch_0" / "learned_dicts.pkl", device=CPU)
    assert [hp["l1_alpha"] for _ld, hp in dicts] == [1e-4, 1e-3]
    manifest = json.loads((run_dir / "export_manifest.json").read_text())
    assert manifest["provenance"]["fingerprint"]["torch"] == torch.__version__


def test_scheduler_requeues_corrupted_done_export(tmp_path):
    dataset = tmp_path / "data"
    _make_dataset(dataset)
    fleet = tmp_path / "fleet"
    q = WorkQueue(fleet)
    build_sweep_items(q, [[1e-3]], _base_kwargs(dataset))
    w = _worker(fleet, "w0", lease_seconds=30)
    assert w.claim_and_run() == "done"
    assert FleetScheduler(fleet, lease_seconds=5).tick() == []
    pkl = q.run_dir("g0") / "epoch_0" / "learned_dicts.pkl"
    data = bytearray(pkl.read_bytes())
    data[0] ^= 0xFF
    pkl.write_bytes(bytes(data))
    actions = FleetScheduler(fleet, lease_seconds=5).tick()
    assert [a["kind"] for a in actions] == ["export_corrupt"]
    assert [i["item"] for i in q.items("pending")] == ["g0"]
    assert w.claim_and_run() == "done"
    assert verify_export(q.run_dir("g0"))[0]


def test_worker_admission_check_refuses_a_rotten_store(tmp_path, monkeypatch):
    """A store corrupt past ``SC_CHUNK_LOSS_BUDGET`` is refused before any
    training (``input_corrupt``, attempt charged); within budget it trains."""
    dataset = tmp_path / "data"
    _make_dataset(dataset)
    fleet = tmp_path / "fleet"
    q = WorkQueue(fleet)
    build_sweep_items(q, [[1e-3]], _base_kwargs(dataset))
    raw = bytearray((dataset / "1.npy").read_bytes())
    raw[-1] ^= 0xFF
    (dataset / "1.npy").write_bytes(bytes(raw))
    w = _worker(fleet, "w0", lease_seconds=30)
    assert w.claim_and_run() == "failed"
    item = q.items("pending")[0]
    assert item["attempt"] == 1 and item["lineage"][-1]["outcome"] == "input_corrupt"
    assert not (q.run_dir("g0") / "epoch_0").exists(), "nothing trained on the rotten store"
    monkeypatch.setenv("SC_CHUNK_LOSS_BUDGET", "0.5")
    assert _worker(fleet, "w1", lease_seconds=30).claim_and_run() == "done"


# -- the acceptance chaos run (in-process) ------------------------------------

@pytest.mark.chaos
def test_chaos_fleet_zero_lost_members(tmp_path, monkeypatch):
    """An 8-member sweep over 3 workers rides out a dead worker (fault +
    abandoned lease: the in-process stand-in for SIGKILL), a torn checkpoint
    and a transient read error with ZERO lost members; every member's
    learned dict verifies against its manifest and equals an uninterrupted
    run's bit for bit, and the fleet report renders which worker lost which
    lease and where the item resumed. The report, the monitor's fleet view,
    the goodput gaps and the tower's gauges of the finished fleet are the
    JAX package's."""
    from sparse_coding__tpu_torch.fleet.queue import is_fleet_dir

    dataset = tmp_path / "data"
    _make_dataset(dataset)
    fleet = tmp_path / "fleet"
    q = WorkQueue(fleet)
    members = [float(a) for a in np.logspace(-4, -2, 8)]
    groups = pack_members(members, bytes_per_member=1.0, hbm_budget_bytes=2.5, reserve_fraction=0.2)
    assert [len(g) for g in groups] == [2, 2, 2, 2]
    base = _base_kwargs(dataset)
    build_sweep_items(q, groups, base)
    assert is_fleet_dir(fleet)

    sched_tel = RunTelemetry(out_dir=str(fleet), run_name="fleet_scheduler", file_name="scheduler_events.jsonl")
    sched_tel.run_start()
    sched = FleetScheduler(fleet, lease_seconds=5, max_attempts=5, quarantine_after=3, telemetry=sched_tel)
    workers = {}
    for wid in ("w0", "w1", "w2"):
        tel = RunTelemetry(out_dir=str(fleet), run_name=f"fleet_worker_{wid}", file_name=f"worker_{wid}_events.jsonl")
        tel.run_start()
        workers[wid] = _worker(fleet, wid, lease_seconds=5, telemetry=tel)

    def with_fault(spec, fn):
        monkeypatch.setenv(faults.FAULT_ENV, spec)
        faults.reset()
        try:
            return fn()
        finally:
            monkeypatch.delenv(faults.FAULT_ENV)
            faults.reset()

    try:
        workers["w0"].fail_mode = "abandon"
        assert with_fault("exc:chunk_loop:chunk=1", workers["w0"].claim_and_run) == "abandoned"
        assert ckpt_lib.latest_checkpoint(q.run_dir("g0")) is not None
        assert with_fault("torn_checkpoint", workers["w1"].claim_and_run) == "failed"
        assert ckpt_lib.latest_checkpoint(q.run_dir("g1")) is None, "a torn save must never look committed"
        assert with_fault("io_error:chunk_read:times=1", workers["w2"].claim_and_run) == "done"
        kinds = [a["kind"] for a in sched.tick(now=time.time() + 30)]
        assert "lease_expired" in kinds and "item_lost" not in kinds
        assert q.worker_record("w0")["strikes"] == 1
        deadline = time.time() + 120
        while not q.finished() and time.time() < deadline:
            sched.tick()
            if {workers["w1"].claim_and_run(), workers["w2"].claim_and_run()} == {"idle"}:
                time.sleep(0.05)
        assert q.finished(), q.state()["item_counts"]
        for w in workers.values():
            w.publish_metrics()
    finally:
        sched_tel.close()
        for w in workers.values():
            w.telemetry.close()

    state = q.state()
    assert state["members"]["lost"] == 0 and state["members"]["done"] == 8
    assert state["item_counts"]["failed"] == 0
    for item in q.items("done"):
        ok, reason = verify_export(q.run_dir(item["item"]))
        assert ok, (item["item"], reason)
    g0 = next(i for i in q.items("done") if i["item"] == "g0")
    assert [e["outcome"] for e in g0["lineage"]] == ["lease_expired", "done"]
    assert g0["lineage"][0]["worker"] == "w0"
    assert g0["lineage"][1]["resumed_from"] == "ckpt_0"
    from sparse_coding__tpu_torch.telemetry import read_events

    retried = [i["item"] for i in q.items("done") if [e for e in read_events(q.run_dir(i["item"]) / "events.jsonl")
                                                       if e["event"] == "snapshot"][-1]["counters"].get("io.retry")]
    assert len(retried) == 1, "exactly one item retried its read"

    from sparse_coding__tpu_torch.train.basic_l1_sweep import basic_l1_sweep

    for i, group in enumerate(groups):
        ref_dir = tmp_path / f"ref_{i}"
        basic_l1_sweep(output_folder=str(ref_dir), l1_values=list(group), device=CPU, **base)
        ref = ckpt_lib.load_learned_dicts(ref_dir / "epoch_0" / "learned_dicts.pkl", device=CPU)
        got = ckpt_lib.load_learned_dicts(q.run_dir(f"g{i}") / "epoch_0" / "learned_dicts.pkl", device=CPU)
        assert [hp["l1_alpha"] for _l, hp in got] == [hp["l1_alpha"] for _l, hp in ref]
        for (ld_r, _), (ld_g, _) in zip(ref, got):
            assert torch.equal(ld_r.get_learned_dict(), ld_g.get_learned_dict()), f"group {i} diverged"

    md = render_fleet_markdown(load_fleet(fleet))
    assert "**8 done**" in md and "**0 lost**" in md
    assert "lease_expired" in md and "ckpt_0" in md
    assert "| w0 |" in md and "| w1 |" in md and "| w2 |" in md
    assert "## Worker metrics" in md
    from sparse_coding__tpu_torch.monitor import main as monitor_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert monitor_main([str(fleet), "--once"]) == 0
    out = buf.getvalue()
    assert "fleet:" in out and "0 lost" in out
    _assert_fleet_views_match_jax(fleet)


# -- lease-loss / shutdown / ledger regressions -------------------------------

_DRIVER = "import:tests._torch_fleet_drivers:{}"


def _submit_driver(q, item_id, fn, members=("m0",), module="_torch_fleet_drivers", **kwargs):
    return q.submit(item_id, list(members), {"driver": f"import:tests.{module}:{fn}", "kwargs": kwargs})


def test_lease_loss_recovers_worker_inprocess(tmp_path):
    fleet = tmp_path / "fleet"
    q = WorkQueue(fleet)
    _submit_driver(q, "g0", "slow_driver", seconds=20.0, poll=0.02)
    w = _worker(fleet, "w0", lease_seconds=1.0, heartbeat_every=0.1)
    result = {}
    t = threading.Thread(target=lambda: result.setdefault("out", w.claim_and_run()))
    t.start()
    deadline = time.time() + 30
    while not q.leases() and time.time() < deadline:
        time.sleep(0.02)
    assert q.leases(), "worker never claimed"
    assert [a["kind"] for a in q.reap_expired(now=time.time() + 60, quarantine_after=5)] == ["lease_expired"]
    t.join(timeout=90)
    assert not t.is_alive() and result["out"] == "lease_lost"
    assert not preemption.preemption_requested()
    assert q.items("pending")[0]["lineage"][-1]["outcome"] == "lease_expired"
    assert q.claim("other", lease_seconds=300)["item"] == "g0"
    _submit_driver(q, "g1", "quick_driver", members=("m1",))
    assert w.claim_and_run() == "done"
    assert q.state()["done_by_worker"] == {"w0": 1}


def test_preempted_worker_releases_item_and_reraises(tmp_path):
    fleet = tmp_path / "fleet"
    q = WorkQueue(fleet)
    _submit_driver(q, "g0", "slow_driver", seconds=20.0, poll=0.02)
    w = _worker(fleet, "w0", lease_seconds=30)
    preemption.request_preemption(signal.SIGTERM)
    with pytest.raises(preemption.Preempted) as exc:
        w.claim_and_run()
    assert exc.value.code == 75
    item = q.items("pending")[0]
    assert item["attempt"] == 0 and item["lineage"][-1]["outcome"] == "preempted"
    assert not q.leases()


def test_worker_shutdown_releases_item_without_penalty(tmp_path):
    fleet = tmp_path / "fleet"
    q = WorkQueue(fleet)
    _submit_driver(q, "g0", "interrupt_driver")
    w = _worker(fleet, "w0", lease_seconds=30)
    with pytest.raises(KeyboardInterrupt):
        w.claim_and_run()
    item = q.items("pending")[0]
    assert item["attempt"] == 0 and item["lineage"][-1]["outcome"] == "released"
    assert not q.leases()


@pytest.mark.parametrize("reason,outcome", [("supervisor_preempted", "preempted"), ("budget_exhausted", "failed")])
def test_supervised_worker_stop_reasons(tmp_path, monkeypatch, reason, outcome):
    """``--mode supervised``: a stop because THIS worker is preempted releases
    the item without penalty and re-raises (exit 75); a child that burned its
    restart budget charges the item and the worker lives on. The child's
    command is the port's module, ``--device`` forwarded when named."""
    import sparse_coding__tpu_torch.supervise as sup

    fleet = tmp_path / "fleet"
    q = WorkQueue(fleet)
    _submit_driver(q, "g0", "quick_driver")
    seen = {}

    def fake_run_supervised(cmd, outcome=None, **kw):
        seen["cmd"] = cmd
        if outcome is not None:
            outcome["reason"] = reason
        return 75

    monkeypatch.setattr(sup, "run_supervised", fake_run_supervised)
    w = _worker(fleet, "w0", mode="supervised", lease_seconds=30)
    if outcome == "preempted":
        with pytest.raises(preemption.Preempted):
            w.claim_and_run()
        assert q.items("pending")[0]["attempt"] == 0
    else:
        assert w.claim_and_run() == "failed"
        assert q.items("pending")[0]["attempt"] == 1
    assert q.items("pending")[0]["lineage"][-1]["outcome"] == outcome
    assert not q.leases()
    assert seen["cmd"][1:] == ["-m", "sparse_coding__tpu_torch.fleet.worker", str(fleet), "--run-item", "g0",
                               "--device", "cpu"]


def test_quarantine_survives_worker_liveness_stamp(tmp_path):
    q = WorkQueue(tmp_path)
    _submit(q, "g0")
    q.strike_worker("w0", "lease_expired:g9", quarantine_after=1)
    assert q.worker_quarantined("w0")
    q.touch_seen("w0")
    rec = q.worker_record("w0")
    assert rec["quarantined"] and rec["strikes"] == 1 and "last_seen_ts" in rec
    assert q.claim("w0", lease_seconds=5) is None
    assert q.claim("w1", lease_seconds=5) is not None
    assert [w["worker"] for w in q.workers()] == ["w0", "w1"]


def test_export_corrupt_exhausts_attempt_budget(tmp_path):
    fleet = tmp_path / "fleet"
    q = WorkQueue(fleet)
    _submit_driver(q, "g0", "quick_driver")
    w = _worker(fleet, "w0", lease_seconds=30)
    assert w.claim_and_run() == "done"
    (q.run_dir("g0") / "epoch_0" / "learned_dicts.pkl").write_bytes(b"rot")
    actions = FleetScheduler(fleet, max_attempts=1).tick()
    assert [a["kind"] for a in actions] == ["export_corrupt", "item_lost"]
    assert actions[0]["requeued_to"] == "failed"
    assert q.state()["members"]["lost"] == 1 and q.finished()
    assert q.items("failed")[0]["lineage"][-1]["outcome"] == "export_corrupt"


def test_scheduler_run_loop_and_cli(tmp_path, capsys):
    """`FleetScheduler.run` exits when the queue finishes (after one
    re-verification pass) with a ``fleet_done`` event; the CLI exits 0 on a
    clean fleet and 1 with lost members; the worker CLI drains a queue."""
    from sparse_coding__tpu_torch.fleet import scheduler as sched_mod
    from sparse_coding__tpu_torch.fleet import worker as worker_mod
    from sparse_coding__tpu_torch.telemetry import read_events

    fleet = tmp_path / "fleet"
    q = WorkQueue(fleet)
    for i in range(2):
        _submit_driver(q, f"g{i}", "quick_driver")
    assert worker_mod.main([str(fleet), "--worker-id", "w0", "--device", "cpu", "--poll", "0.01"]) == 0
    assert "2 item(s) completed" in capsys.readouterr().out
    assert sched_mod.main([str(fleet), "--poll", "0.01", "--max-seconds", "5"]) == 0
    assert "2 done / 0 lost" in capsys.readouterr().out
    done = [e for e in read_events(fleet / "scheduler_events.jsonl") if e["event"] == "fleet_done"]
    assert len(done) == 1 and done[0]["members"]["done"] == 2
    assert (fleet / "metrics" / "w0.prom").is_file()
    lost = tmp_path / "lost"
    q2 = WorkQueue(lost)
    _submit(q2, "g0")
    q2.claim("w0", lease_seconds=30)
    q2.fail("g0", "w0", "dead", max_attempts=1)
    assert sched_mod.main([str(lost), "--poll", "0.01", "--max-seconds", "5"]) == 1


# -- subprocess chaos: real workers, real SIGKILL ----------------------------

def _worker_cmd(fleet, wid, extra=()):
    return [sys.executable, "-m", "sparse_coding__tpu_torch.fleet.worker", str(fleet), "--worker-id", wid,
            "--lease-seconds", "6", "--poll", "0.2", "--idle-exit", "60", "--device", "cpu", *extra]


def _worker_env(**overrides):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["SC_SYNC_BACKOFF"] = "0"
    env.pop("SC_FAULT", None)
    env.update(overrides)
    return env


@pytest.mark.slow
@pytest.mark.chaos
def test_chaos_fleet_subprocess_kill_storm(tmp_path):
    dataset = tmp_path / "data"
    _make_dataset(dataset)
    fleet = tmp_path / "fleet"
    q = WorkQueue(fleet)
    groups = pack_members([float(a) for a in np.logspace(-4, -2, 8)], max_members_per_item=2)
    build_sweep_items(q, groups, _base_kwargs(dataset))
    procs = [
        subprocess.Popen(_worker_cmd(fleet, "w0"), env=_worker_env(SC_FAULT="kill:chunk_loop:chunk=1:times=1")),
        subprocess.Popen(_worker_cmd(fleet, "w1"), env=_worker_env(SC_FAULT="io_error:chunk_read:times=1")),
        subprocess.Popen(_worker_cmd(fleet, "w2"), env=_worker_env()),
    ]
    sched = FleetScheduler(fleet, lease_seconds=6, max_attempts=6, quarantine_after=3)
    try:
        deadline = time.time() + 480
        while not q.finished() and time.time() < deadline:
            sched.tick()
            time.sleep(0.5)
        assert q.finished(), q.state()["item_counts"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
    assert procs[0].returncode == -9, "w0 really was SIGKILLed by the fault"
    state = q.state()
    assert state["members"]["lost"] == 0 and state["members"]["done"] == 8
    md = render_fleet_markdown(load_fleet(fleet))
    assert "**0 lost**" in md
    assert "lease_expired" in md or "interrupted" in md


@pytest.mark.slow
def test_supervised_worker_mode_end_to_end(tmp_path):
    dataset = tmp_path / "data"
    _make_dataset(dataset)
    fleet = tmp_path / "fleet"
    q = WorkQueue(fleet)
    build_sweep_items(q, [[1e-4, 1e-3]], _base_kwargs(dataset))
    res = subprocess.run(_worker_cmd(fleet, "w0", extra=("--mode", "supervised")),
                         env=_worker_env(SC_FAULT="sigterm:chunk=1:times=1"), capture_output=True, text=True,
                         timeout=480)
    assert res.returncode == 0, (res.stdout, res.stderr)
    assert q.finished() and q.state()["members"]["done"] == 2
    run = q.run_dir("g0")
    assert verify_export(run)[0]
    from sparse_coding__tpu_torch.telemetry import read_events

    kinds = [e["event"] for e in read_events(run / "events.jsonl")]
    assert "preempt" in kinds and "resume" in kinds


# -- golden fleet fixture (report/monitor rendering pins) ---------------------

def test_fleet_report_on_golden_fixture(capsys):
    from sparse_coding__tpu_torch.fleet.report import main as report_main

    assert (GOLDEN_FLEET / "queue" / "done" / "g0.json").exists()
    assert report_main([str(GOLDEN_FLEET)]) == 0
    out = capsys.readouterr().out
    assert "# Fleet report" in out
    assert "**4 done**" in out and "**0 lost**" in out
    assert "## Reassignment lineage" in out
    assert "| g0 | 0 | w0 | lease_expired | - |" in out
    assert "| g0 | 1 | w1 | done | ckpt_1 |" in out
    assert "| w2 | 0 | 3 | YES |" in out


def test_monitor_fleet_view_on_golden_fixture(capsys):
    from sparse_coding__tpu_torch.monitor import main as monitor_main

    assert monitor_main([str(GOLDEN_FLEET), "--once"]) == 0
    out = capsys.readouterr().out
    assert "fleet: items 2 done" in out and "4 done" in out and "0 lost" in out
    assert "w2 QUARANTINED (3 strikes)" in out


def test_fleet_report_exit_code_gates_lost_members(tmp_path, capsys):
    q = WorkQueue(tmp_path)
    _submit(q, "g0")
    q.claim("w0", lease_seconds=30)
    q.fail("g0", "w0", "dead", max_attempts=1)
    from sparse_coding__tpu_torch.fleet.report import main as report_main

    assert report_main([str(tmp_path)]) == 1
    assert "LOST" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="no fleet queue"):
        load_fleet(tmp_path / "nothing")


# -- the two packages on one fleet directory -----------------------------------

def _as_jax(text):
    return text.replace("sparse_coding__tpu_torch.", "sparse_coding__tpu.")


def _dump(obj):
    return json.dumps(obj, sort_keys=True, default=str)


def _fleet_now(fleet):
    """A fixed ``now`` five seconds after the fleet's newest timestamp."""
    ts = []
    for p in Path(fleet).rglob("*.json*"):
        for line in p.read_text().splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                ts += [v for k, v in rec.items() if k.endswith("_ts") and isinstance(v, (int, float))]
                ts += [rec["ts"]] if isinstance(rec.get("ts"), (int, float)) else []
    return max(ts) + 5.0


def _assert_fleet_views_match_jax(fleet):
    """The fleet report, the report CLI's exit code, the monitor's fleet
    view, the goodput gaps and ledger, and the tower's fleet gauges of both
    packages on one directory."""
    mods = {n: (importlib.import_module(f"sparse_coding__tpu.{n}"), importlib.import_module(f"sparse_coding__tpu_torch.{n}"))
            for n in ("fleet.report", "fleet.queue", "telemetry.monitor", "telemetry.goodput", "telemetry.tower")}
    (jr, tr), (jq, tq) = mods["fleet.report"], mods["fleet.queue"]
    now = _fleet_now(fleet)
    js = jq.WorkQueue(fleet, create=False).state(now=now)
    ts = tq.WorkQueue(fleet, create=False).state(now=now)
    assert _dump(ts) == _dump(js)
    jf, tf = jr.load_fleet(fleet), tr.load_fleet(fleet)
    jf["state"], tf["state"] = js, ts
    assert _as_jax(tr.render_fleet_markdown(tf)) == jr.render_fleet_markdown(jf)
    outs = []
    for mod in (tr, jr):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main([str(fleet)])
        outs.append((rc, buf.getvalue()))
    assert outs[0][0] == outs[1][0]
    jm, tm = mods["telemetry.monitor"]
    assert tm.fleet_lines(fleet, now) == jm.fleet_lines(fleet, now)
    jg, tg = mods["telemetry.goodput"]
    assert _dump(tg.fleet_reassignment_gaps(fleet)) == _dump(jg.fleet_reassignment_gaps(fleet))
    jl, tl = jg.build_ledger(fleet), tg.build_ledger(fleet)
    assert _dump(tl) == _dump(jl)
    assert tg.render_ledger(tl) == jg.render_ledger(jl)
    jt, tt = mods["telemetry.tower"]
    assert tt._fleet_gauges(fleet, now) == jt._fleet_gauges(fleet, now)


def test_fleet_views_match_jax_on_the_golden_fleet_run():
    from sparse_coding__tpu_torch.telemetry import goodput

    _assert_fleet_views_match_jax(GOLDEN_FLEET)
    gaps = goodput.fleet_reassignment_gaps(GOLDEN_FLEET)
    assert (gaps[0]["item"], gaps[0]["from_worker"], gaps[0]["to_worker"]) == ("g0", "w0", "w1")
    assert len(gaps) == 4 and all(g["seconds"] > 0 for g in gaps)


def _phantom_reap(q_mod, sched_mod, fleet, item_id):
    """A worker that claims ``item_id`` and dies: its lease expires and the
    given package's scheduler reaps it."""
    q = q_mod.WorkQueue(fleet)
    item = q.claim("wdead", lease_seconds=1)
    assert item["item"] == item_id
    kinds = [a["kind"] for a in sched_mod.FleetScheduler(fleet, lease_seconds=1).tick(now=time.time() + 60)]
    assert kinds == ["lease_expired"]


def test_jax_filled_queue_is_served_by_the_port_worker(tmp_path):
    """A queue the JAX package's `WorkQueue` filled (a `basic_l1_sweep`
    item and an item of the JAX tests' own ``import:`` driver) and whose
    dead lease the JAX scheduler reaped is served by the port's worker on the
    CPU; the JAX package then finds both done, verifies the exports and loads
    the trained dicts."""
    from sparse_coding__tpu.fleet import WorkQueue as JQueue
    from sparse_coding__tpu.fleet import build_sweep_items as j_build
    from sparse_coding__tpu.fleet import queue as jq
    from sparse_coding__tpu.fleet import scheduler as jsched
    from sparse_coding__tpu.fleet import verify_export as j_verify
    from sparse_coding__tpu.train import checkpoint as j_ckpt

    dataset = tmp_path / "data"
    _make_dataset(dataset)
    fleet = tmp_path / "fleet"
    jqueue = JQueue(fleet)
    j_build(jqueue, [[1e-4, 1e-3]], _base_kwargs(dataset), name_prefix="a")
    jqueue.submit("b0", ["m0"], {"driver": "import:tests._fleet_drivers:quick_driver", "kwargs": {}})
    _phantom_reap(jq, jsched, fleet, "a0")
    w = _worker(fleet, "wport", lease_seconds=30)
    assert w.run_forever(poll_every=0.01) == 2
    state = jqueue.state()
    assert state["members"] == {"queued": 0, "running": 0, "orphaned": 0, "done": 3, "lost": 0}
    a0 = next(i for i in jqueue.items("done") if i["item"] == "a0")
    assert [(e["worker"], e["outcome"]) for e in a0["lineage"]] == [("wdead", "lease_expired"), ("wport", "done")]
    for item in ("a0", "b0"):
        assert j_verify(jqueue.run_dir(item)) == verify_export(jqueue.run_dir(item)) == (True, "ok")
    got = j_ckpt.load_learned_dicts(jqueue.run_dir("a0") / "epoch_0" / "learned_dicts.pkl", verify=True)
    assert [hp["l1_alpha"] for _ld, hp in got] == [1e-4, 1e-3]
    assert jsched.FleetScheduler(fleet).tick() == [], "the JAX scheduler re-verifies the port's exports"
    _assert_fleet_views_match_jax(fleet)


def test_port_filled_queue_is_served_by_the_jax_worker(tmp_path):
    """The reverse: a queue the port's `WorkQueue` filled (``import:``
    payloads of either package's test drivers) and whose dead lease the
    port's scheduler reaped is served by the JAX package's worker; the port
    then verifies the exports and re-verifies them as its scheduler."""
    from sparse_coding__tpu.fleet import FleetWorker as JWorker
    from sparse_coding__tpu.fleet import verify_export as j_verify
    from sparse_coding__tpu_torch.fleet import queue as tq
    from sparse_coding__tpu_torch.fleet import scheduler as tsched

    fleet = tmp_path / "fleet"
    q = WorkQueue(fleet)
    _submit_driver(q, "a0", "quick_driver", members=("m0", "m1"))
    _submit_driver(q, "b0", "quick_driver", members=("m2",), module="_fleet_drivers")
    _phantom_reap(tq, tsched, fleet, "a0")
    assert JWorker(fleet, "wjax", lease_seconds=30).run_forever(poll_every=0.01) == 2
    assert q.state()["members"]["done"] == 3 and q.state()["members"]["lost"] == 0
    for item in ("a0", "b0"):
        assert verify_export(q.run_dir(item)) == j_verify(q.run_dir(item)) == (True, "ok")
    assert FleetScheduler(fleet).tick() == []
    a0 = next(i for i in q.items("done") if i["item"] == "a0")
    assert [(e["worker"], e["outcome"]) for e in a0["lineage"]] == [("wdead", "lease_expired"), ("wjax", "done")]
    _assert_fleet_views_match_jax(fleet)


def test_queue_files_are_the_jax_packages(tmp_path):
    """The same operations through each package's `WorkQueue` leave the same
    tree and the same JSON (timestamps aside)."""
    from sparse_coding__tpu.fleet import WorkQueue as JQueue

    def drive(cls, root):
        q = cls(root)
        q.submit("g0", ["a", "b"], {"driver": "basic_l1_sweep", "kwargs": {"l1_values": [1e-3]}})
        q.submit("g1", ["c"], {"driver": "noop"})
        q.claim("w0", lease_seconds=30)
        q.note("g0", "w0", resumed_from="ckpt_0")
        q.complete("g0", "w0", result={"verified": True, "export_digest": "cd" * 32})
        q.claim("w1", lease_seconds=30)
        q.fail("g1", "w1", "boom", max_attempts=1)
        q.strike_worker("w1", "lease_expired:g1", quarantine_after=1)
        return {str(p.relative_to(root)): _strip_ts(json.loads(p.read_text()))
                for p in sorted(root.rglob("*.json"))}

    assert drive(WorkQueue, tmp_path / "port") == drive(JQueue, tmp_path / "jax")


def _strip_ts(obj):
    if isinstance(obj, dict):
        return {k: _strip_ts(v) for k, v in obj.items() if not k.endswith("_ts")}
    if isinstance(obj, list):
        return [_strip_ts(v) for v in obj]
    return obj


def test_worker_needs_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    from sparse_coding__tpu_torch.fleet import worker as worker_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetWorker(tmp_path / "fleet", "w0")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        worker_mod.main([str(tmp_path / "fleet"), "--worker-id", "w0"])
    assert not (tmp_path / "fleet" / "worker_w0_events.jsonl").exists(), "refused before any telemetry"
    assert FleetWorker(tmp_path / "fleet", "w0", device="cpu").device == "cpu"
