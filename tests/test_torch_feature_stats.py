"""The port's feature sketch, snapshots and flush against the JAX package's,
on the CPU.

The same numpy codes go through the JAX `update_feature_stats` (vmapped over
the members, as the JAX step runs it) and the port's stacked one.
Tolerances, and why:
  - ``rows``, ``fire`` and ``max``: exact (counts, and a max of the inputs);
  - ``sum`` and ``sumsq``: rtol 1e-5 (f32 sums in another order);
  - ``hist``: exact, except for elements whose |c| lies within 4 f32 ulps of
    a bucket edge (``2^(2b−10)``), where torch's and XLA's f32 ``log`` may
    round to different sides: no more elements may land in another bucket
    than there are such elements. The data holds values on the edges;
  - snapshots, aggregates and drift: a package's file loads in the other
    unchanged (exact), and both compute the same aggregates and drift to
    1e-12 (float64 numpy on the same arrays).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding__tpu_torch import FunctionalFista, FunctionalTiedSAE, build_ensemble
from sparse_coding__tpu_torch.telemetry import feature_stats as tfs
from sparse_coding__tpu_torch.telemetry import read_events
from sparse_coding__tpu_torch.telemetry.events import RunTelemetry

M, ROWS, F = 3, 40, 24
CFG = tfs.FeatureStatsConfig()


def _codes(seed=0):
    """Signed codes over every bucket, half of them zero, some exactly on
    the bucket edges and at one ulp either side of them."""
    rng = np.random.default_rng(seed)
    mag = np.exp(rng.uniform(np.log(1e-4), np.log(1e3), (M, ROWS, F)))
    c = (mag * np.where(rng.random((M, ROWS, F)) < 0.8, 1.0, -1.0)).astype(np.float32)
    c[rng.random((M, ROWS, F)) < 0.5] = 0.0
    edges = CFG.edges().astype(np.float32)
    picks = rng.integers(0, len(edges), 30)
    for j, e in enumerate(edges[picks]):
        v = [e, np.nextafter(e, np.float32(0)), np.nextafter(e, np.float32(np.inf))][j % 3]
        c[j % M, (7 * j) % ROWS, (5 * j) % F] = v
    return c


def _near_edge(c) -> int:
    a = np.abs(c[c != 0]).astype(np.float32)
    edges = CFG.edges().astype(np.float32)
    return int(sum(((np.abs(a - e) <= 4 * np.spacing(e)) for e in edges)).astype(bool).sum())


def _jax_update(c, mask=None):
    from sparse_coding__tpu.telemetry import feature_stats as jfs

    jcfg = jfs.FeatureStatsConfig()
    stats = jfs.init_feature_stats(M, F, jcfg)
    if mask is None:
        out = jax.vmap(lambda s, cm: jfs.update_feature_stats(s, cm, jcfg))(stats, jnp.asarray(c))
    else:
        out = jax.vmap(lambda s, cm, mm: jfs.update_feature_stats(s, cm, jcfg, mask=mm))(
            stats, jnp.asarray(c), jnp.asarray(mask))
    return {k: np.asarray(v) for k, v in jax.device_get(out).items()}


def _port_update(c, mask=None):
    stats = tfs.init_feature_stats(M, F, CFG)
    out = tfs.update_feature_stats(stats, torch.from_numpy(c), CFG,
                                   mask=None if mask is None else torch.from_numpy(mask))
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("masked", [False, True])
def test_update_feature_stats_matches_jax(masked):
    c = _codes()
    mask = None
    if masked:
        mask = (np.random.default_rng(3).random((M, ROWS)) < 0.7).astype(np.float32)
    ref, got = _jax_update(c, mask), _port_update(c, mask)
    assert sorted(got) == sorted(ref) == sorted(tfs.FEATURE_STATS_KEYS)
    for k in ("featstat_rows", "featstat_fire", "featstat_max"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("featstat_sum", "featstat_sumsq"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    moved = np.abs(got["featstat_hist"] - ref["featstat_hist"]).sum() / 2
    assert moved <= _near_edge(c if mask is None else c * (mask[:, :, None] > 0)), moved
    assert got["featstat_hist"].sum() == got["featstat_fire"].sum()
    if masked:
        np.testing.assert_array_equal(got["featstat_rows"], mask.sum(axis=1))


def test_bucket_index_follows_the_edges():
    a = torch.tensor([0.0, 2.0**-11, 2.0**-10, 2.0**-9, 2.0**-8, 1.0, 3.0, 2.0**4, 1e6])
    assert tfs._bucket_index(a, CFG).tolist() == [0, 0, 0, 0, 1, 5, 5, 7, 7]


def _host(seed, n_models=2, n_feats=8, rows=64, scale=1.0):
    rng = np.random.default_rng(seed)
    codes = rng.standard_normal((n_models, rows, n_feats)).astype(np.float32)
    codes = np.where(rng.random(codes.shape) < 0.5, 0.0, np.abs(codes) * scale).astype(np.float32)
    stats = tfs.update_feature_stats(tfs.init_feature_stats(n_models, n_feats, CFG), torch.from_numpy(codes), CFG)
    return {k: v.numpy().astype(np.float64) for k, v in stats.items()}


def test_snapshots_cross_packages_and_agree(tmp_path):
    """A snapshot written by each package loads in the other as written;
    aggregates and drift computed by both agree."""
    from sparse_coding__tpu.telemetry import feature_stats as jfs

    base_h, cur_h = _host(1), _host(2, scale=16.0)
    (tmp_path / "jax").mkdir()
    jfs.write_snapshot(tmp_path / "jax", "train", base_h, ["a", "b"], jfs.FeatureStatsConfig(), meta={"step": 3})
    tfs.write_snapshot(tmp_path, "serve", cur_h, ["a", "b"], CFG)
    base_path, cur_path = tmp_path / "jax" / "feature_stats.train0000.npz", tmp_path / "feature_stats.serve0000.npz"
    tbase, jbase = tfs.FeatureSnapshot.load(base_path), jfs.FeatureSnapshot.load(base_path)
    tcur, jcur = tfs.FeatureSnapshot.load(cur_path), jfs.FeatureSnapshot.load(cur_path)
    np.testing.assert_array_equal(tcur.hist, cur_h["featstat_hist"])
    for t, j in ((tbase, jbase), (tcur, jcur)):
        assert (t.scope, t.gen, t.names, t.meta) == (j.scope, j.gen, j.names, j.meta)
        for f in ("rows", "fire", "sum", "sumsq", "max", "hist", "edges"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    assert tbase.meta["step"] == 3
    for t, j in ((tbase, jbase), (tcur, jcur)):
        ta, ja = tfs.snapshot_aggregates(t), jfs.snapshot_aggregates(j)
        assert sorted(ta) == sorted(ja)
        for k in ta:
            assert ta[k] == pytest.approx(ja[k], rel=1e-12, abs=1e-12), k
    for method in ("psi", "js"):
        tr, jr = tfs.drift_report(tbase, tcur, method=method), jfs.drift_report(jbase, jcur, method=method)
        assert tr["score"] == pytest.approx(jr["score"], rel=1e-12) and tr["score"] > 0
        np.testing.assert_allclose(tr["per_feature"], jr["per_feature"], rtol=1e-12)
        assert [f for f, _ in tr["top"]] == [f for f, _ in jr["top"]]
        assert tr["lanes"] == jr["lanes"]
    assert tfs.drift_report(tbase, tfs.write_snapshot(tmp_path, "serve", _host(4, n_feats=12), ["a"], CFG)) is None
    assert [s.gen for s in tfs.load_run_snapshots(tmp_path)] == ["serve0000", "serve0001"]


def _ens(sig, feature_stats, health=False, seed=0):
    return build_ensemble(sig, seed, [{"l1_alpha": 1e-4}, {"l1_alpha": 1e-3}], optimizer_kwargs={"learning_rate": 1e-3},
                          compute_dtype="bfloat16", fused=False, feature_stats=feature_stats, health=health,
                          device="cpu", activation_size=16, n_dict_components=32)


def test_flush_writes_a_snapshot_and_an_event_and_resets_in_place(tmp_path):
    ens = _ens(FunctionalTiedSAE, True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 64, 16)).astype(np.float32))
    for b in x:
        ens.step_batch(b)
    ens._device_step()
    leaves_before = [(t.data_ptr(), t.shape, t.dtype, t.stride()) for t in ens._leaves()]
    tel = RunTelemetry(out_dir=str(tmp_path), run_name="feat")
    summary = tfs.flush_ensemble_feature_stats(ens, tel, tmp_path, model_names=["lo", "hi"])
    assert summary["scope"] == "train" and summary["gen"] == "train0000" and summary["names"] == ["lo", "hi"]
    assert summary["rows"] == 2 * 3 * 64
    assert (tmp_path / "feature_stats.train0000.npz").exists()
    assert tel.counters["train.feature.flushes"] == 1 and "train.feature.dead_frac" in tel.gauges
    # reset in place: the same tensors, now zero, so a step graph's frozen
    # addresses still hold
    assert [(t.data_ptr(), t.shape, t.dtype, t.stride()) for t in ens._leaves()] == leaves_before
    assert all(not ens.state.buffers[k].any() for k in tfs.FEATURE_STATS_KEYS)
    assert tfs.flush_ensemble_feature_stats(ens, tel, tmp_path) is None
    ens.step_batch(x[0])
    assert ens.state.buffers["featstat_rows"].tolist() == [64.0, 64.0]
    tel.close()
    events = read_events(tmp_path / "events.jsonl")
    assert [e["path"] for e in events if e["event"] == "feature_stats"] == ["feature_stats.train0000.npz"]
    assert [e["name"] for e in events if e["event"] == "span" and e["category"] == "feature_flush"] == ["train"] * 2
    assert tfs.flush_ensemble_feature_stats(_ens(FunctionalTiedSAE, False), None, tmp_path) is None


@pytest.mark.parametrize("sig", [FunctionalTiedSAE, FunctionalFista], ids=lambda s: s.__name__)
def test_train_step_bit_identical_with_packs_on(sig):
    """The packs only observe: losses, codes and params are the same bits
    with both on and with both off (both on the unfused path)."""
    on, off = _ens(sig, True, health=True), _ens(sig, False)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 64, 16)).astype(np.float32))
    for b in x:
        l_on, a_on = on.step_batch(b)
        l_off, a_off = off.step_batch(b)
        for k in l_off:
            assert torch.equal(l_on[k], l_off[k]), k
        assert torch.equal(a_on["c"], a_off["c"])
    for k in off.state.params:
        assert torch.equal(on.state.params[k], off.state.params[k]), k
    assert on.state.buffers["featstat_rows"].tolist() == [4 * 64, 4 * 64]
    assert {k for k in l_on if k.startswith("health_")} == {
        "health_grad_norm", "health_dict_norm", "health_nonfinite", "health_dead_frac"}


def test_serving_half_and_the_run_summary_of_an_empty_dir(tmp_path):
    # the serving half is held against JAX's in tests/test_torch_serve.py
    stats = tfs.ServeFeatureStats()
    assert stats.cfg == tfs.FeatureStatsConfig() and stats.flush(None, ".") == []
    assert tfs.summarize_run(tmp_path) is None


# -- the run summary and the `features` CLI (tests/test_feature_stats.py:437-484)

from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GOLDEN_FEATURES = REPO / "tests" / "golden" / "feature_run"


def test_features_cli_golden_output_and_exit_codes(tmp_path, capsys, monkeypatch):
    from sparse_coding__tpu_torch.features import main as features_main

    expected = (GOLDEN_FEATURES / "expected_cli.txt").read_text()
    monkeypatch.chdir(REPO)
    assert features_main(["tests/golden/feature_run"]) == 0
    assert capsys.readouterr().out == expected
    # exit 1 past threshold, 3 on a dir with no snapshots
    assert features_main(["tests/golden/feature_run", "--threshold", "0.25"]) == 1
    assert features_main([str(tmp_path)]) == 3


@pytest.mark.parametrize("argv", [[], ["--json"], ["--diff", "train0000", "train0001"], ["--method", "js", "--top", "3"],
                                  ["--baseline", str(GOLDEN_FEATURES / "feature_stats.train0000.npz")]])
def test_features_cli_matches_jax(capsys, argv):
    from sparse_coding__tpu.features import main as jax_main
    from sparse_coding__tpu_torch.features import main as features_main

    rc_j = jax_main([str(GOLDEN_FEATURES)] + argv)
    out_j = capsys.readouterr().out
    rc_t = features_main([str(GOLDEN_FEATURES)] + argv)
    assert (rc_t, capsys.readouterr().out) == (rc_j, out_j)


def test_features_cli_json_and_diff(capsys):
    from sparse_coding__tpu_torch.features import main as features_main

    assert features_main([str(GOLDEN_FEATURES), "--json"]) == 0
    info = __import__("json").loads(capsys.readouterr().out)
    assert info["drift"]["band"] == "major"
    assert info["drift"]["baseline"] == "train0001"
    assert info["drift"]["current"] == "serve0000"
    assert info["drift"]["score"] == pytest.approx(4.074, abs=1e-3)
    assert info["dead"]["features"] == [30, 31]
    # --diff addresses gens explicitly: the train-only control pair is stable
    assert features_main([str(GOLDEN_FEATURES), "--diff", "train0000", "train0001", "--threshold", "0.25"]) == 0
    assert "[STABLE]" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="unknown gen"):
        features_main([str(GOLDEN_FEATURES), "--diff", "train0000", "nope"])


def test_features_cli_over_a_port_run_matches_its_flushes(tmp_path, capsys):
    """The summary over snapshots the port's flush wrote: its aggregates are
    the ``feature_stats`` events' (the card's `features` phase checks the
    same over `basic_l1_sweep`'s run dir)."""
    from sparse_coding__tpu_torch.features import main as features_main

    ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": 1e-3}, {"l1_alpha": 3e-3}], activation_size=8,
                         n_dict_components=16, feature_stats=True, device="cpu")
    tel = RunTelemetry(out_dir=str(tmp_path), run_name="fs")
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        ens.step_batch(torch.randn(32, 8, generator=g))
        tfs.flush_ensemble_feature_stats(ens, tel, tmp_path)
    tel.close()
    assert features_main([str(tmp_path), "--json"]) == 0
    info = __import__("json").loads(capsys.readouterr().out)
    flushes = [e for e in read_events(tmp_path / "events.jsonl") if e["event"] == "feature_stats"]
    assert [s["gen"] for s in info["snapshots"]] == [e["gen"] for e in flushes]
    for snap, ev in zip(info["snapshots"], flushes):
        for k in ("dead_frac", "gini", "hot_frac"):
            assert snap[k] == pytest.approx(ev[k], abs=1e-6), k
