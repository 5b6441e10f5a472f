"""The port's FISTA driver `basic_l1_sweep` against the JAX package's, on the
CPU, at `tests/test_train_drivers.py::test_basic_l1_sweep`'s sizes (D 24, l1
1e-4 and 1e-3, dictionary ratio 2, 30 FISTA iterations, 2 epochs) over one
JAX-written store of 2 chunks of 256 rows.

The two packages shuffle a chunk's rows from different generators, so each
chunk is one batch (``batch_size`` = 256): a permutation inside one batch
changes only the order of its sums. The port's driver starts from the JAX
ensemble's initial state (its `build_ensemble` patched to load it).
Tolerances, and why (those of `tests/test_torch_fista_slice.py`):
  - exported decoders within 1e-5 (chained FISTA steps);
  - encoders and biases within 1e-2 lr per step (Adam maps a gradient near
    zero, whose sign a sum order may flip, to an update of up to lr);
  - health metrics: losses and norms rtol 1e-4 after the 4 steps, the
    nonfinite flags exactly;
  - the rest (paths, cadences, replays, quarantine): exact.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from sparse_coding__tpu_torch import build_ensemble
from sparse_coding__tpu_torch.data import integrity
from sparse_coding__tpu_torch.interop import state_from_jax_numpy
from sparse_coding__tpu_torch.telemetry import read_events
from sparse_coding__tpu_torch.telemetry.feature_stats import load_run_snapshots
from sparse_coding__tpu_torch.train import basic_l1_sweep as tbls
from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib
from sparse_coding__tpu_torch.train import preemption
from sparse_coding__tpu_torch.utils import faults

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_bls_worker.py"
D, ROWS, LR = 24, 256, 1e-3
KW = dict(activation_width=D, l1_values=[1e-4, 1e-3], dict_ratio=2, batch_size=ROWS, fista_iters=30, n_epochs=2)


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    for k in ("SC_FAULT", "SC_RESUME", "SC_CHUNK_LOSS_BUDGET", "SC_TRACE_WINDOW"):
        monkeypatch.delenv(k, raising=False)
    faults.reset()
    preemption.reset()
    yield
    faults.reset()
    preemption.reset()


def _rows(n, d=D, seed=0):
    """Sparse non-negative mixtures of 48 unit rows plus a little noise."""
    rng = np.random.default_rng(seed)
    truth = rng.standard_normal((48, d))
    truth /= np.linalg.norm(truth, axis=-1, keepdims=True)
    codes = rng.uniform(0.5, 1.5, (n, 48)) * (rng.random((n, 48)) < 0.1)
    return (codes @ truth + 0.01 * rng.standard_normal((n, d))).astype(np.float32)


def _jax_store(folder, n_chunks=2, rows=ROWS, d=D):
    from sparse_coding__tpu.data.chunks import save_chunk as jax_save_chunk

    x = _rows(n_chunks * rows, d)
    for i in range(n_chunks):
        jax_save_chunk(folder, i, x[i * rows:(i + 1) * rows])
    return folder


def _from_jax_init(monkeypatch):
    """Patch the port driver's `build_ensemble` to start from the state the
    JAX driver builds from the same seed."""
    from sparse_coding__tpu import build_ensemble as jax_build
    from sparse_coding__tpu.models import FunctionalFista as JaxFista

    def build(sig, key, hparams, optimizer_kwargs=None, health=False, feature_stats=False, device=None, **common):
        jens = jax_build(JaxFista, jax.random.PRNGKey(key), hparams, optimizer_kwargs=optimizer_kwargs,
                         health=health, feature_stats=feature_stats, **common)
        st = jax.device_get(jens.state)
        a = st.opt_state[0]
        ens = build_ensemble(sig, key, hparams, optimizer_kwargs=optimizer_kwargs, health=health,
                             feature_stats=feature_stats, device=device, **common)
        ens.state = state_from_jax_numpy(st.params, st.buffers, {"count": np.asarray(a.count), "mu": dict(a.mu),
                                                                  "nu": dict(a.nu)}, device=device)
        return ens

    monkeypatch.setattr(tbls, "build_ensemble", build)


def _exports(out):
    return sorted(str(p.relative_to(out)) for p in Path(out).rglob("learned_dicts.pkl"))


def _metrics(out):
    recs = [json.loads(line) for line in open(Path(out) / "basic_l1_sweep_metrics.jsonl")]
    return {(r["step"], r["series"], r["metric"]): r["value"] for r in recs}


def test_driver_matches_the_jax_driver_and_its_export_loads_there(tmp_path, monkeypatch):
    from sparse_coding__tpu.train.basic_l1_sweep import basic_l1_sweep as jax_bls
    from sparse_coding__tpu.train.checkpoint import load_learned_dicts as jax_load

    store = _jax_store(tmp_path / "store")
    jlds = jax_bls(str(store), str(tmp_path / "jax"), **KW)
    _from_jax_init(monkeypatch)
    tlds = tbls.basic_l1_sweep(str(store), str(tmp_path / "torch"), device="cpu", **KW)
    assert _exports(tmp_path / "torch") == _exports(tmp_path / "jax") == [
        "epoch_0/learned_dicts.pkl", "epoch_1/learned_dicts.pkl"]
    assert [hp for _, hp in tlds] == [hp for _, hp in jlds]
    for (tld, _), (jld, _) in zip(tlds, jlds):
        np.testing.assert_allclose(to_np(tld.decoder), np.asarray(jld.decoder), rtol=0, atol=1e-5)
        for f in ("encoder", "encoder_bias"):
            np.testing.assert_allclose(to_np(getattr(tld, f)), np.asarray(getattr(jld, f)), rtol=0,
                                       atol=1e-2 * LR * 4, err_msg=f)
    # the same metric series, the health metrics among them
    tm, jm = _metrics(tmp_path / "torch"), _metrics(tmp_path / "jax")
    assert sorted(tm) == sorted(jm)
    assert {k[2] for k in tm} >= {"loss", "health_grad_norm", "health_dict_norm", "health_nonfinite",
                                  "health_dead_frac"}
    for k, v in jm.items():
        if k[2] == "health_nonfinite":
            assert tm[k] == v == 0.0
        elif k[2] in ("loss", "l_reconstruction", "health_grad_norm", "health_dict_norm"):
            assert tm[k] == pytest.approx(v, rel=1e-4), k
    # one feature snapshot a chunk boundary on both sides, over the same rows
    tsnaps, jsnaps = load_run_snapshots(tmp_path / "torch"), load_run_snapshots(tmp_path / "jax")
    assert [s.gen for s in tsnaps] == [s.gen for s in jsnaps] == [f"train{i:04d}" for i in range(4)]
    for t, j in zip(tsnaps, jsnaps):
        assert t.names == j.names == ["l1_1.00e-04", "l1_1.00e-03"]
        np.testing.assert_array_equal(t.rows, j.rows)
    # the port's events read as the JAX package's: the same kinds of record
    tev = read_events(tmp_path / "torch" / "events.jsonl")
    jev = read_events(tmp_path / "jax" / "events.jsonl")
    for kind in ("span", "provenance", "feature_stats", "chunk_start", "chunk_end"):
        assert sum(e["event"] == kind for e in tev) > 0, kind
    assert ([(e["category"], e.get("name")) for e in tev if e["event"] == "span" and e["category"] != "compile"]
            == [(e["category"], e.get("name")) for e in jev if e["event"] == "span" and e["category"] != "compile"])
    assert tev[-1]["event"] == "run_end" and tev[-1]["status"] == "ok" and tev[-1]["timer"]["steps"] == 4
    # no device-memory gauges from a CPU run, in either package
    for ev in (tev, jev):
        assert not [g for g in [e for e in ev if e["event"] == "snapshot"][-1]["gauges"] if g.startswith("hbm.")]
    # the port's export, as written, in the JAX package with its sidecar verified
    loaded = jax_load(tmp_path / "torch" / "epoch_1" / "learned_dicts.pkl", verify=True)
    assert [type(ld).__name__ for ld, _ in loaded] == ["UntiedSAE"] * 2
    for (ld, hp), (tld, thp) in zip(loaded, tlds):
        assert hp == thp
        np.testing.assert_array_equal(np.asarray(ld.decoder), to_np(tld.decoder))


def test_hbm_cache_save_after_every_and_checkpoint_every(tmp_path):
    """``hbm_cache`` trains bit for bit as a fresh load each time;
    ``save_after_every`` exports each chunk under its position;
    ``checkpoint_every=2`` commits every second chunk boundary."""
    from sparse_coding__tpu.train.basic_l1_sweep import basic_l1_sweep as jax_bls

    store = _jax_store(tmp_path / "store", n_chunks=2, rows=128)
    kw = dict(KW, batch_size=64, fista_iters=10)
    plain = tbls.basic_l1_sweep(str(store), str(tmp_path / "plain"), device="cpu", **kw)
    cached = tbls.basic_l1_sweep(str(store), str(tmp_path / "cached"), hbm_cache=True, device="cpu", **kw)
    for (a, ha), (b, hb) in zip(plain, cached):
        assert ha == hb
        for f in ("encoder", "encoder_bias", "decoder"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    every = tbls.basic_l1_sweep(str(store), str(tmp_path / "every"), save_after_every=True, checkpoint_every=2,
                                checkpoint_keep=10, device="cpu", **kw)
    jax_bls(str(store), str(tmp_path / "jax_every"), save_after_every=True, checkpoint_every=2, checkpoint_keep=10,
            **kw)
    want = [f"epoch_{e}/chunk_{p}/learned_dicts.pkl" for e in (0, 1) for p in (0, 1)]
    assert _exports(tmp_path / "every") == _exports(tmp_path / "jax_every") == want
    ckpts = sorted(p.name for p in (tmp_path / "every").glob("ckpt_*"))
    assert ckpts == sorted(p.name for p in (tmp_path / "jax_every").glob("ckpt_*")) == ["ckpt_1", "ckpt_3"]
    reasons = [e["reason"] for e in read_events(tmp_path / "every" / "events.jsonl") if e["event"] == "checkpoint"]
    assert reasons == ["periodic", "periodic"]
    from sparse_coding__tpu.telemetry.provenance import checkpoint_digest as jax_digest

    digests = [ckpt_lib.checkpoint_digest(tmp_path / "every" / c) for c in ckpts]
    assert digests == [jax_digest(tmp_path / "every" / c) for c in ckpts] and None not in digests
    provenance = [e["digest"] for e in read_events(tmp_path / "every" / "events.jsonl")
                  if e["event"] == "provenance" and e["artifact"] == "checkpoint"]
    assert provenance == digests
    for (a, _), (b, _) in zip(every, plain):  # exports change where they go, not what is trained
        assert torch.equal(a.decoder, b.decoder)


def _worker(store, out, *args, fault=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("SC_")}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    if fault:
        env["SC_FAULT"] = fault
    return subprocess.run([sys.executable, str(WORKER), str(store), str(out), *args], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=180)


def test_kill_and_resume_replays_the_uninterrupted_run_bit_for_bit(tmp_path):
    """SIGTERM after epoch 1's first chunk (exit 75, ``ckpt_2`` committed),
    then ``--resume``: both epochs' exports, the firing EMA and every
    feature snapshot are the uninterrupted run's bits."""
    store = tmp_path / "store"
    from sparse_coding__tpu_torch.data.chunks import save_chunk

    x = _rows(256, d=16)
    for i in range(2):
        save_chunk(store, i, x[i * 128:(i + 1) * 128])
    a = _worker(store, tmp_path / "a")
    assert a.returncode == 0, a.stderr
    killed = _worker(store, tmp_path / "b", fault="sigterm:chunk=0:epoch=1")
    assert killed.returncode == 75, (killed.returncode, killed.stderr[-2000:])
    assert ckpt_lib.latest_checkpoint(tmp_path / "b").name == "ckpt_2"
    assert (tmp_path / "b" / "epoch_0").exists() and not (tmp_path / "b" / "epoch_1").exists()
    resumed = _worker(store, tmp_path / "b", "--resume")
    assert resumed.returncode == 0, resumed.stderr
    assert "Resumed" in resumed.stdout
    for epoch in (0, 1):
        got = ckpt_lib.load_learned_dicts(tmp_path / "b" / f"epoch_{epoch}" / "learned_dicts.pkl", verify=True,
                                          device="cpu")
        ref = ckpt_lib.load_learned_dicts(tmp_path / "a" / f"epoch_{epoch}" / "learned_dicts.pkl", verify=True,
                                          device="cpu")
        for (g, hg), (r, hr) in zip(got, ref):
            assert hg == hr
            for f in ("encoder", "encoder_bias", "decoder"):
                assert torch.equal(getattr(g, f), getattr(r, f)), (epoch, f)
    ema = [ckpt_lib.restore_ensemble_checkpoint(tmp_path / s / "ckpt_3")["ensembles"]["ensemble"]["state"]
           .buffers["health_fire_ema"] for s in ("a", "b")]
    assert torch.equal(ema[0], ema[1]) and float(ema[0].sum()) > 0
    snaps = [load_run_snapshots(tmp_path / s) for s in ("a", "b")]
    assert [s.gen for s in snaps[1]] == [s.gen for s in snaps[0]] == [f"train{i:04d}" for i in range(4)]
    for sa, sb in zip(*snaps):
        for f in ("rows", "fire", "sum", "sumsq", "max", "hist"):
            np.testing.assert_array_equal(getattr(sb, f), getattr(sa, f), err_msg=(sa.gen, f))
    events = read_events(tmp_path / "b" / "events.jsonl")
    assert [e["status"] for e in events if e["event"] == "run_end"] == ["preempted", "ok"]
    resume = next(e for e in events if e["event"] == "resume")
    assert resume["cursor"] == {"chunk": 2, "epoch": 1, "position": 0, "n_trained": 3}


def test_a_corrupt_chunk_is_skipped_within_the_budget(tmp_path, monkeypatch):
    store = _jax_store(tmp_path / "store", n_chunks=4, rows=64)
    with open(store / "2.npy", "ab") as f:  # a torn write: the size no longer matches
        f.write(b"\0")
    monkeypatch.setenv("SC_CHUNK_LOSS_BUDGET", "0.25")
    lds = tbls.basic_l1_sweep(str(store), str(tmp_path / "out"), device="cpu",
                              **dict(KW, batch_size=64, fista_iters=10, n_epochs=1))
    assert len(lds) == 2 and integrity.quarantined_indices(store) == [2]
    events = read_events(tmp_path / "out" / "events.jsonl")
    assert [(e["chunk"], e["rows"]) for e in events if e["event"] == "chunk_skipped"] == [(2, 64)]
    assert sorted(e["chunk"] for e in events if e["event"] == "chunk_start") == [0, 1, 3]
    assert len(load_run_snapshots(tmp_path / "out")) == 3


def test_a_trace_window_captures_one_boundary_window(tmp_path, monkeypatch):
    """JAX's drive of ``SC_TRACE_WINDOW=2:4`` through the driver: one step a
    chunk (4 boundaries over 2 epochs), the window from boundary 2 to 4."""
    from _torch_profiler_stub import stub_profiler

    calls = stub_profiler(monkeypatch)
    monkeypatch.setenv("SC_TRACE_WINDOW", "2:4")
    store = _jax_store(tmp_path / "store")
    tbls.basic_l1_sweep(str(store), str(tmp_path / "out"), device="cpu", **KW)
    traces = [e for e in read_events(tmp_path / "out" / "events.jsonl") if e["event"] == "trace"]
    assert [(t["reason"], t["start_step"], t["stop_step"]) for t in traces] == [("step_window", 2, 4)]
    assert calls["started"] == [str(tmp_path / "out" / "trace_step2")] and calls["stopped"] == 1


def test_nan_member_is_flagged_by_the_guard_and_masked(tmp_path, monkeypatch):
    """The default policy warns and writes a bundle; ``mask`` freezes the
    member through the ensemble (the JAX driver's wiring)."""
    from sparse_coding__tpu_torch.telemetry.anomaly import AnomalyPolicy

    store = _jax_store(tmp_path / "store", n_chunks=1, rows=128)
    real = tbls.build_ensemble

    def build(*a, **k):
        ens = real(*a, **k)
        ens.state.params["encoder"][1] = float("nan")
        return ens

    monkeypatch.setattr(tbls, "build_ensemble", build)
    with pytest.warns(RuntimeWarning, match="masked models"):
        tbls.basic_l1_sweep(str(store), str(tmp_path / "out"), anomaly_policy=AnomalyPolicy(action="mask"),
                            device="cpu", **dict(KW, batch_size=64, fista_iters=10, n_epochs=1))
    events = read_events(tmp_path / "out" / "events.jsonl")
    anomalies = [e for e in events if e["event"] == "anomaly"]
    assert anomalies and anomalies[0]["kind"] == "nonfinite" and anomalies[0]["models"] == [1]
    assert Path(anomalies[0]["bundle"]).exists()
    assert events[-1]["masked_models"] == [1]


def test_entry_point_needs_cuda_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbls.basic_l1_sweep(str(tmp_path), str(tmp_path / "out"), **KW)
