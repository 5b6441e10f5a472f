"""The port's anomaly guard against the JAX package's, on the CPU.

Both guards are fed the same flush windows (the host trees a
`MetricLogger.flush` hands its ``on_flush`` hook) under each policy action,
and must find the same anomalies, mask the same members, write the same
diagnostic bundles and anomaly events (the same JSON but for timestamps and
the run directory), and, under ``abort``, raise only after the bundle is on
disk. The guard is numpy on the host, so everything compares exactly.
"""

import json
import warnings

import numpy as np
import pytest
import torch

from sparse_coding__tpu_torch import FunctionalTiedSAE, build_ensemble
from sparse_coding__tpu_torch.telemetry import anomaly as ta
from sparse_coding__tpu_torch.telemetry.events import RunTelemetry, read_events

NAMES = ["lo", "mid", "hi"]


def _windows():
    """Flush windows over 3 members: steady losses, a NaN in member 1 at
    step 20, a loss spike in member 0 at step 30, a dead-fraction jump in
    member 2 at step 40, a health_nonfinite flag in member 2 at step 50."""
    rng = np.random.default_rng(0)
    out = []
    for w in range(6):
        steps, trees = [], []
        for j in range(10):
            s = 10 * w + j
            loss = 1.0 + 0.01 * rng.standard_normal(3)
            dead = np.array([0.05, 0.05, 0.05 if s < 40 else 0.6])
            nonfinite = np.zeros(3)
            if s == 20:
                loss[1] = np.nan
            if s == 30:
                loss[0] = 40.0
            if s == 50:
                nonfinite[2] = 1.0
            steps.append(s)
            trees.append({"loss": loss.astype(np.float32), "l_l1": (0.1 * loss).astype(np.float32),
                          "health_dead_frac": dead.astype(np.float32),
                          "health_nonfinite": nonfinite.astype(np.float32)})
        out.append((steps, trees))
    return out


class _FakeEnsemble:
    n_models = 3

    def __init__(self):
        self.masks = []

    def set_update_mask(self, mask):
        self.masks.append(np.asarray(mask).tolist())


def _run(pkg, tmp, policy_kw, ensemble):
    if pkg == "jax":
        from sparse_coding__tpu.telemetry import AnomalyAbort, AnomalyGuard, AnomalyPolicy, RunTelemetry as Tel
    else:
        AnomalyAbort, AnomalyGuard, AnomalyPolicy, Tel = ta.AnomalyAbort, ta.AnomalyGuard, ta.AnomalyPolicy, RunTelemetry
    tel = Tel(out_dir=str(tmp), run_name="guard")
    guard = AnomalyGuard(telemetry=tel, out_dir=str(tmp), policy=AnomalyPolicy(**policy_kw), ensemble=ensemble,
                         model_names=NAMES)
    found, aborted_at = [], None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i, (steps, trees) in enumerate(_windows()):
            try:
                found.append(guard.observe(steps, trees))
            except AnomalyAbort:
                aborted_at = i
                assert list((tmp / "diagnostics").glob("anomaly_*.json")), "abort before its bundle"
                break
    tel.close()
    return guard, found, aborted_at


def _same(a, b) -> bool:
    """Equal as JSON (a NaN value equals a NaN value)."""
    return json.dumps(a, sort_keys=True, default=float) == json.dumps(b, sort_keys=True, default=float)


def _bundles(tmp):
    out = {}
    for p in sorted((tmp / "diagnostics").glob("*.json")):
        b = json.loads(p.read_text())
        b.pop("ts")
        out[p.name] = b
    return out


def _anomaly_events(tmp, read):
    out = []
    for e in read(tmp / "events.jsonl"):
        if e["event"] == "anomaly":
            e = {k: v for k, v in e.items() if k not in ("seq", "ts", "mono")}
            e["bundle"] = e["bundle"] and e["bundle"].rsplit("/", 1)[-1]
            out.append(e)
    return out


@pytest.mark.parametrize("action", ["warn", "mask", "abort"])
def test_guard_matches_the_jax_guard(tmp_path, action):
    from sparse_coding__tpu.telemetry import read_events as jax_read

    kw = dict(action=action, spike_min_window=8)
    fakes = {"jax": _FakeEnsemble(), "torch": _FakeEnsemble()}
    runs = {pkg: _run(pkg, tmp_path / pkg, kw, fakes[pkg]) for pkg in ("jax", "torch")}
    (jg, jfound, jabort), (tg, tfound, tabort) = runs["jax"], runs["torch"]
    assert _same(tfound, jfound) and tabort == jabort
    assert _same(tg.anomalies, jg.anomalies) and tg.masked == jg.masked
    assert fakes["torch"].masks == fakes["jax"].masks
    kinds = {f["kind"] for w in tfound for f in w}
    if action == "warn":
        assert kinds == {"nonfinite", "loss_spike", "dead_feature_jump"}
    if action == "mask":
        assert tg.masked == {0, 1, 2} and fakes["torch"].masks[0] == [1.0, 0.0, 1.0]
    if action == "abort":
        assert tabort == 2 and kinds == set()
    assert _same(_bundles(tmp_path / "torch"), _bundles(tmp_path / "jax")) and _bundles(tmp_path / "jax")
    assert _same(_anomaly_events(tmp_path / "torch", read_events), _anomaly_events(tmp_path / "jax", jax_read))
    assert _anomaly_events(tmp_path / "jax", jax_read)


def test_mask_action_freezes_the_members_of_a_port_ensemble(tmp_path):
    """With a real ensemble, ``mask`` goes through `Ensemble.set_update_mask`:
    the NaN member stops moving and the others train on."""
    ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": 1e-3}] * 3, activation_size=8, n_dict_components=16,
                         device="cpu")
    guard = ta.AnomalyGuard(out_dir=str(tmp_path), policy=ta.AnomalyPolicy(action="mask"), ensemble=ens)
    with pytest.warns(RuntimeWarning, match="masked models"):
        guard.observe([0], [{"loss": np.array([1.0, np.nan, 1.0], np.float32)}])
    assert ens.state.buffers["update_mask"].tolist() == [1.0, 0.0, 1.0]
    before = ens.state.params["encoder"].clone()
    ens.step_batch(torch.randn(32, 8, generator=torch.Generator().manual_seed(0)))
    after = ens.state.params["encoder"]
    assert torch.equal(after[1], before[1]) and not torch.equal(after[0], before[0])


def test_a_trace_trigger_fires_on_the_first_anomaly_only(tmp_path, monkeypatch):
    from _torch_profiler_stub import stub_profiler
    from sparse_coding__tpu_torch.telemetry import RunTelemetry, TraceTrigger, read_events

    calls = stub_profiler(monkeypatch)
    tel = RunTelemetry(out_dir=str(tmp_path), run_name="anom")
    tt = TraceTrigger(telemetry=tel, out_dir=str(tmp_path))
    guard = ta.AnomalyGuard(telemetry=tel, out_dir=str(tmp_path), policy=ta.AnomalyPolicy(action="warn"),
                            trace_trigger=tt)
    with pytest.warns(RuntimeWarning):
        guard.observe([3], [{"loss": np.array([np.nan, 1.0], np.float32)}])
    tt.on_step(4)
    with pytest.warns(RuntimeWarning):
        guard.observe([5], [{"loss": np.array([1.0, np.nan], np.float32)}])
    tel.close()
    assert calls["started"] == [str(tmp_path / "trace_anomaly_step3")] and calls["stopped"] == 1
    anomalies = [e for e in read_events(tmp_path / "events.jsonl") if e["event"] == "anomaly"]
    assert anomalies[0]["trace_dir"] == calls["started"][0] and anomalies[1]["trace_dir"] is None
    with pytest.raises(ValueError, match="unknown anomaly action"):
        ta.AnomalyPolicy(action="page")
