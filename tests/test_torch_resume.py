"""The port's recovery machinery against the JAX package's contract: kill and
resume bit for bit, the checkpoint commit protocol, quarantine within the
chunk-loss budget, the ``SC_FAULT`` grammar and the signal handlers.

Tolerances: none. Resume must replay the uninterrupted run bit for bit
(`torch.equal` on every array, equal hyperparams); the rest are exact
protocol checks.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sparse_coding__tpu_torch import FunctionalTiedSAE, build_ensemble
from sparse_coding__tpu_torch.data import integrity
from sparse_coding__tpu_torch.data.chunks import ChunkStore, save_chunk
from sparse_coding__tpu_torch.telemetry import read_events
from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib
from sparse_coding__tpu_torch.train import preemption
from sparse_coding__tpu_torch.train.loop import DriverCheckpointer
from sparse_coding__tpu_torch.train.sweep import sweep
from sparse_coding__tpu_torch.utils import faults
from sparse_coding__tpu_torch.utils.config import EnsembleArgs

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_sweep_worker.py"
D, N = 16, 32


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """No faults armed, no preemption pending, before and after."""
    for k in ("SC_FAULT", "SC_RESUME", "SC_CHUNK_LOSS_BUDGET", "SC_CKPT_VERIFY", "SC_CHUNK_VERIFY"):
        monkeypatch.delenv(k, raising=False)
    faults.reset()
    preemption.reset()
    yield
    faults.reset()
    preemption.reset()


def _store(folder, n_chunks=3, rows=128, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n_chunks):
        save_chunk(folder, i, rng.standard_normal((rows, D)).astype(np.float32))
    return folder


def _worker(store, out, *args, fault=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("SC_")}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    if fault:
        env["SC_FAULT"] = fault
    return subprocess.run([sys.executable, str(WORKER), str(store), str(out), *args], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=180)


def _init(cfg):
    ens = build_ensemble(FunctionalTiedSAE, cfg.seed, [{"l1_alpha": 1e-3}, {"l1_alpha": 3e-3}],
                         optimizer_kwargs={"learning_rate": 1e-3}, activation_size=D, n_dict_components=N,
                         device="cpu")
    return [(ens, {"batch_size": cfg.batch_size}, "e")], [], ["l1_alpha"], {}


def _cfg(tmp_path, store, **kw):
    return EnsembleArgs(dataset_folder=str(store), output_folder=str(tmp_path / "out"), batch_size=64,
                        activation_width=D, **kw)


def test_kill_and_resume_replays_the_uninterrupted_run_bit_for_bit(tmp_path):
    """A real SIGTERM at position 1 (``SC_FAULT=sigterm:chunk=1``) exits 75
    with a committed ``ckpt_1``; ``--resume`` then finishes the run, and its
    final export equals the uninterrupted run's bit for bit, for an Adam
    ensemble and an SGD ensemble with a schedule alike. The JAX package's
    `read_events` reads the port's log."""
    from sparse_coding__tpu.telemetry import read_events as jax_read_events

    store = _store(tmp_path / "store")
    a = _worker(store, tmp_path / "a")
    assert a.returncode == 0, a.stderr
    killed = _worker(store, tmp_path / "b", fault="sigterm:chunk=1")
    assert killed.returncode == 75, (killed.returncode, killed.stderr[-2000:])
    assert ckpt_lib.latest_checkpoint(tmp_path / "b").name == "ckpt_1"
    assert ckpt_lib.verify_checkpoint(tmp_path / "b" / "ckpt_1") == (True, "ok")
    assert not (tmp_path / "b" / "_5").exists()
    resumed = _worker(store, tmp_path / "b", "--resume")
    assert resumed.returncode == 0, resumed.stderr
    assert "Resumed" in resumed.stdout

    got = ckpt_lib.load_learned_dicts(tmp_path / "b" / "_5" / "learned_dicts.pkl", verify=True, device="cpu")
    ref = ckpt_lib.load_learned_dicts(tmp_path / "a" / "_5" / "learned_dicts.pkl", verify=True, device="cpu")
    assert len(got) == len(ref) == 3
    for (g, hg), (r, hr) in zip(got, ref):
        assert hg == hr
        for f in ("encoder", "encoder_bias"):
            assert torch.equal(getattr(g, f), getattr(r, f)), f

    events = jax_read_events(tmp_path / "b" / "events.jsonl")
    assert events == read_events(tmp_path / "b" / "events.jsonl")
    kinds = [e["event"] for e in events]
    assert {"preempt", "resume", "checkpoint"} <= set(kinds)
    assert next(e for e in events if e["event"] == "preempt")["signum"] == signal.SIGTERM == 15
    assert [e["status"] for e in events if e["event"] == "run_end"] == ["preempted", "ok"]
    assert [e["generation"] for e in events if e["event"] == "run_start"] == [0, 1]
    resume = next(e for e in events if e["event"] == "resume")
    assert resume["cursor"] == {"chunk": 1} and resume["checkpoint"].endswith("ckpt_1")


def test_torn_and_corrupt_checkpoints_are_skipped_and_gc_keeps_the_newest(tmp_path, monkeypatch):
    ensembles = _init(_cfg(tmp_path, tmp_path))[0]
    out = tmp_path / "out"
    for i in range(4):
        ckpt_lib.save_ensemble_checkpoint(out / f"ckpt_{i}", ensembles, chunk_cursor=i)
    assert ckpt_lib.gc_checkpoints(out, keep=3) == [out / "ckpt_0"]
    assert sorted(p.name for p in out.iterdir()) == ["ckpt_1", "ckpt_2", "ckpt_3"]
    # a save killed between its data and its commit leaves only a staging dir
    monkeypatch.setenv("SC_FAULT", "torn_checkpoint")
    with pytest.raises(faults.InjectedFault):
        ckpt_lib.save_ensemble_checkpoint(out / "ckpt_4", ensembles, chunk_cursor=4)
    assert (out / ".staging_ckpt_4").is_dir() and not (out / "ckpt_4").exists()
    assert ckpt_lib.latest_checkpoint(out).name == "ckpt_3"
    # bit rot after the commit: the digest check falls back to ckpt_2
    monkeypatch.setenv("SC_FAULT", "corrupt_checkpoint")
    ckpt_lib.save_ensemble_checkpoint(out / "ckpt_3", ensembles, chunk_cursor=3)
    assert ckpt_lib.verify_checkpoint(out / "ckpt_3")[1] == f"digest mismatch on {ckpt_lib.STATE_FILE}"
    assert ckpt_lib.verify_checkpoint(out / "ckpt_3", depth="size") == (True, "ok")
    with pytest.warns(RuntimeWarning, match="skipping checkpoint ckpt_3"):
        latest = ckpt_lib.latest_checkpoint(out)
    assert latest.name == "ckpt_2"
    assert ckpt_lib.restore_ensemble_checkpoint(latest)["cursor"] == {"chunk": 2}
    # a manifest-less dir is uncommitted: resume skips it and GC sweeps it
    # with the staging dir
    (out / "ckpt_5").mkdir()
    with pytest.warns(RuntimeWarning, match="skipping checkpoint ckpt_5: uncommitted"):
        assert ckpt_lib.latest_checkpoint(out).name == "ckpt_2"
    assert set(ckpt_lib.gc_checkpoints(out, keep=1)) == {
        out / "ckpt_2", out / "ckpt_1", out / ".staging_ckpt_4", out / "ckpt_5"}
    assert sorted(p.name for p in out.iterdir()) == ["ckpt_3"]


def test_restored_state_steps_like_the_live_one(tmp_path):
    """The training state round-trips through ``torch.save`` exactly, every
    class rebuilt (read with ``weights_only=True``), bf16 moments and the
    step included."""
    kw = dict(compute_dtype="bfloat16", activation_size=128, n_dict_components=512, device="cpu")
    ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": 1e-3}, {"l1_alpha": 3e-3}],
                         optimizer_kwargs={"learning_rate": 1e-3, "mu_dtype": "bfloat16"}, **kw)
    x = torch.randn((2, 256, 128), generator=torch.Generator().manual_seed(0))
    ens.step_batch(x[0])
    ckpt_lib.save_ensemble_checkpoint(tmp_path / "ckpt_0", [(ens, {"batch_size": 256}, "e")])
    tree = ckpt_lib.restore_ensemble_checkpoint(tmp_path / "ckpt_0")
    assert tree["args"] == {"e": {"batch_size": 256}}
    clone = type(ens).from_state(tree["ensembles"]["e"], device="cpu")
    assert (clone.fused, clone.fused_adam, clone.state.step) == (ens.fused, ens.fused_adam, 1)
    assert clone.state.opt_state.mu["encoder"].dtype == torch.bfloat16
    la, _ = ens.step_batch(x[1])
    lb, _ = clone.step_batch(x[1])
    assert torch.equal(la["loss"], lb["loss"])
    for k in ens.state.params:
        assert torch.equal(ens.state.params[k], clone.state.params[k]), k


def test_a_corrupt_chunk_is_quarantined_and_skipped_within_the_budget(tmp_path, monkeypatch):
    store = _store(tmp_path / "store", n_chunks=4)
    with open(store / "2.npy", "ab") as f:  # a torn write: the size no longer matches
        f.write(b"\0")
    monkeypatch.setenv("SC_CHUNK_LOSS_BUDGET", "0.25")
    lds = sweep(_init, _cfg(tmp_path, store), device="cpu")
    assert len(lds) == 2
    from sparse_coding__tpu.data import integrity as jax_integrity

    assert integrity.quarantined_indices(store) == [2] and not (store / "2.npy").exists()
    assert integrity.quarantined_rows(store, 2) == 128
    # the same quarantine layout as the JAX package's
    assert jax_integrity.quarantined_indices(store) == [2] and jax_integrity.quarantined_rows(store, 2) == 128
    assert ChunkStore(store).slot_count() == 4 and len(ChunkStore(store)) == 3
    events = read_events(tmp_path / "out" / "events.jsonl")
    skipped = [e for e in events if e["event"] == "chunk_skipped"]
    assert [(e["chunk"], e["rows"]) for e in skipped] == [(2, 128)]
    assert "size mismatch" in skipped[0]["reason"]
    assert any(e["event"] == "anomaly" and e["kind"] == "chunk_corrupt" for e in events)
    trained = [e["file"] for e in events if e["event"] == "chunk_start"]
    assert sorted(trained) == [0, 1, 3]


def test_past_the_loss_budget_the_sweep_exits_75(tmp_path, monkeypatch):
    store = _store(tmp_path / "store", n_chunks=4)
    for i in (1, 3):
        (store / f"{i}.npy").write_bytes(b"garbage")
    monkeypatch.setenv("SC_CHUNK_LOSS_BUDGET", "0.25")
    with pytest.raises(preemption.ResumableAbort) as exc:
        sweep(_init, _cfg(tmp_path, store), device="cpu")
    assert exc.value.code == preemption.RESUMABLE_EXIT_CODE == 75
    assert "loss budget exhausted" in str(exc.value)
    events = read_events(tmp_path / "out" / "events.jsonl")
    assert [e["event"] for e in events].count("loss_budget_exhausted") == 1
    assert events[-1]["event"] == "run_end" and events[-1]["status"].startswith("resumable-abort")


def test_fault_grammar_matches_the_jax_package():
    from sparse_coding__tpu.utils import faults as jax_faults

    for spec in ("kill:chunk=3;torn_checkpoint;io_error:chunks:every=5", "sigterm:chunk=1", "exc:step=2:times=1",
                 "corrupt_chunk,corrupt_checkpoint"):
        got = [(s.action, s.site, s.params, s.max_fires) for s in faults.parse_faults(spec)]
        ref = [(s.action, s.site, s.params, s.max_fires) for s in jax_faults.parse_faults(spec)]
        assert got == ref, spec
    for bad in ("explode:chunk=1", "kill"):
        with pytest.raises(ValueError):
            faults.parse_faults(bad)


def test_the_checkpointer_puts_back_the_signal_handlers_it_replaced(tmp_path):
    def mine(signum, frame):
        pass

    before = signal.signal(signal.SIGTERM, mine)
    try:
        ckpt = DriverCheckpointer(tmp_path)
        assert ckpt.handlers_active and signal.getsignal(signal.SIGTERM) is not mine
        os.kill(os.getpid(), signal.SIGTERM)  # handled: the flag, not an exit
        assert preemption.preemption_requested() and preemption.preemption_signal() == signal.SIGTERM
        with pytest.raises(preemption.Preempted) as exc:
            ckpt.boundary(7, lambda path: ckpt_lib.save_checkpoint_tree(path, {"cursor": {"chunk": 7}}))
        assert exc.value.code == 75 and (tmp_path / "ckpt_7").is_dir()
        ckpt.close()
        assert signal.getsignal(signal.SIGTERM) is mine
    finally:
        signal.signal(signal.SIGTERM, before)


def test_flags_keep_the_jax_package_spellings(monkeypatch):
    from sparse_coding__tpu.utils import flags as jax_flags
    from sparse_coding__tpu_torch.utils import flags

    for name, flag in flags.FLAGS.items():
        ref = jax_flags.FLAGS[name]
        assert (flag.kind, flag.default, flag.choices) == (ref.kind, ref.default, ref.choices), name
        for raw in (None, "", "0", "1", "off", "FALSE", "yes", "0.5"):
            env = {} if raw is None else {name: raw}
            try:
                want = ref.get(env)
            except ValueError:
                with pytest.raises(ValueError):
                    flag.get(env)
                continue
            assert flag.get(env) == want, (name, raw)
