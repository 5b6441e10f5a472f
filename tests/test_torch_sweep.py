"""The port's sweep driver against the JAX package's, on the CPU.

Tolerances, and why:
  - sweep against sweep (f32 autograd): each chunk is exactly one batch, so
    the two shuffles differ only in the order of the batch's rows, which
    moves f32 sums; params within 1e-2 lr per step (the f32 slice's bound:
    Adam maps gradient noise near |g| ~ eps to updates bounded by lr);
  - the export re-evaluated in JAX: FVU rtol 1e-5, L0 within one row;
  - the fused-grads route (bf16): losses rtol 1e-3 and each step's update
    gradient-close (cosine > 0.9999, max rel 1e-2: the bf16 fused slice's
    bounds); Adam's update to max rel 0.1, since Adam maps the bf16 noise
    of a gradient near eps to an update of up to lr;
  - the generators: the transforms of given draws to f32 rounding (atol
    1e-5, the spectrum shift to 1e-4 of its size); the draws to JAX's
    statistics within 5%.
"""

import dataclasses
import inspect
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import assert_grads_close, to_np
from sparse_coding__tpu_torch import FunctionalTiedSAE, build_ensemble
from sparse_coding__tpu_torch.data import synthetic as ts
from sparse_coding__tpu_torch.interop import state_from_jax_numpy
from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
from sparse_coding__tpu_torch.telemetry import read_events
from sparse_coding__tpu_torch.train import sweep as tsweep
from sparse_coding__tpu_torch.utils import config as tconfig
from sparse_coding__tpu_torch.utils import optim as toptim
from sparse_coding__tpu_torch.utils.logging import MetricLogger

D, N, B = 32, 64, 64
L1 = [1e-3, 3e-3]
LR = 1e-3


def _jax_init(cfg):
    from sparse_coding__tpu.ensemble import build_ensemble as jax_build_ensemble
    from sparse_coding__tpu.models import FunctionalTiedSAE as JaxTiedSAE

    ens = jax_build_ensemble(JaxTiedSAE, jax.random.PRNGKey(cfg.seed), [{"l1_alpha": a} for a in L1],
                             optimizer_kwargs={"learning_rate": LR}, activation_size=D, n_dict_components=N)
    return ens


def _ranges():
    return ["dict_size"], ["l1_alpha"], {"l1_alpha": L1, "dict_size": [N]}


@pytest.mark.parametrize("center", [False, True])
def test_sweep_matches_the_jax_sweep_on_a_jax_written_store(tmp_path, center):
    """(a) A store written by the JAX package's `save_chunk` trains in both
    sweeps from the same initial state: the same chunk order, the same save
    points and hyperparams, params to f32 tolerance after 3 chunks × 2
    epochs, with and without ``center_activations`` (the first chunk's mean,
    kept in ``means.npy``). (b) The port's export loads in the JAX package
    as written, its sidecar verified, and re-evaluates there to the port's
    FVU and L0."""
    from sparse_coding__tpu.data.chunks import save_chunk as jax_save_chunk
    from sparse_coding__tpu.metrics import standard as jm
    from sparse_coding__tpu.train.checkpoint import load_learned_dicts as jax_load
    from sparse_coding__tpu.train.sweep import sweep as jax_sweep
    from sparse_coding__tpu.utils.config import EnsembleArgs as JaxEnsembleArgs
    from sparse_coding__tpu_torch.metrics import standard as tm

    rng = np.random.default_rng(0)
    store = tmp_path / "store"
    for i in range(3):
        jax_save_chunk(store, i, rng.standard_normal((B, D)).astype(np.float32))
    common = dict(dataset_folder=str(store), batch_size=B, n_epochs=2, activation_width=D,
                  center_activations=center)
    jens = _jax_init(JaxEnsembleArgs(**common))
    st = jax.device_get(jens.state)
    opt = {"count": np.asarray(st.opt_state[0].count), "mu": dict(st.opt_state[0].mu),
           "nu": dict(st.opt_state[0].nu)}

    def jax_init(cfg):
        return ([(jens, {"batch_size": cfg.batch_size, "dict_size": N}, "l1")], *_ranges())

    def port_init(cfg):
        ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": a} for a in L1], optimizer_kwargs={"learning_rate": LR},
                             activation_size=D, n_dict_components=N, device="cpu")
        ens.state = state_from_jax_numpy(st.params, st.buffers, opt, device="cpu")
        return ([(ens, {"batch_size": cfg.batch_size, "dict_size": N}, "l1")], *_ranges())

    jcfg = JaxEnsembleArgs(output_folder=str(tmp_path / "jax"), **common)
    tcfg = tconfig.EnsembleArgs(output_folder=str(tmp_path / "torch"), **common)
    jlds = jax_sweep(jax_init, jcfg)
    tlds = tsweep.sweep(port_init, tcfg, device="cpu")

    from sparse_coding__tpu.telemetry import read_events as jax_read_events

    def order(events):
        return [(e["chunk"], e["file"]) for e in events if e["event"] == "chunk_start"]

    assert order(read_events(tmp_path / "torch" / "events.jsonl")) == order(
        jax_read_events(tmp_path / "jax" / "events.jsonl")) == list(
        enumerate(np.tile(np.random.default_rng(0).permutation(3), 2).tolist()))
    for side in ("jax", "torch"):
        saved = sorted(p.name for p in (tmp_path / side).iterdir() if p.name.startswith("_"))
        assert saved == ["_5"], (side, saved)
    jyaml = (tmp_path / "jax" / "_5" / "config.yaml").read_text().replace(str(tmp_path / "jax"), "OUT")
    tyaml = (tmp_path / "torch" / "_5" / "config.yaml").read_text().replace(str(tmp_path / "torch"), "OUT")
    assert tyaml == jyaml
    assert [hp for _, hp in tlds] == [hp for _, hp in jlds]
    assert (tmp_path / "torch" / "means.npy").exists() == center
    if center:
        np.testing.assert_allclose(np.load(tmp_path / "torch" / "means.npy"), np.load(tmp_path / "jax" / "means.npy"),
                                   rtol=1e-6, atol=1e-7)
    for (tld, _), (jld, _) in zip(tlds, jlds):
        for f in ("encoder", "encoder_bias"):
            diff = np.abs(to_np(getattr(tld, f)) - np.asarray(getattr(jld, f))).max()
            assert diff <= 1e-2 * LR * 6, (f, diff)
    # both guards read every flush and, on this healthy run, flag nothing
    assert _anomalies(read_events(tmp_path / "torch" / "events.jsonl")) == _anomalies(
        jax_read_events(tmp_path / "jax" / "events.jsonl")) == []

    # (b) the export as written, in the JAX package, verified
    loaded = jax_load(tmp_path / "torch" / "_5" / "learned_dicts.pkl", verify=True)
    assert [type(ld).__module__ + "." + type(ld).__qualname__ for ld, _ in loaded] == [
        "sparse_coding__tpu.models.learned_dict.TiedSAE"] * 2
    assert [hp for _, hp in loaded] == [hp for _, hp in tlds]
    x = np.random.default_rng(1).standard_normal((200, D)).astype(np.float32)
    got = tm.evaluate_dicts([ld for ld, _ in tlds], torch.from_numpy(x))
    ref = jm.evaluate_dicts([ld for ld, _ in loaded], jnp.asarray(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["fvu"], r["fvu"], rtol=1e-5)
        assert abs(g["l0"] - r["l0"]) <= 1.0 / len(x)


def _anomalies(events):
    """The guard's anomaly events: kind, step, members, action and each
    detection's (kind, step, metric, member), sorted (JAX's loss dicts come
    back in key order, the port's in the signature's)."""
    return [(e["kind"], e["step"], e["models"], e["action"],
             sorted((d["kind"], d["step"], d["metric"], d["model"]) for d in e["detections"]))
            for e in events if e["event"] == "anomaly"]


def test_sweeps_flag_the_same_anomalies_on_a_nan_member(tmp_path):
    """Member 1's l1 coefficient is NaN from the start on both sides: both
    sweeps' guards (no loss spikes: one logger carries every ensemble) flag
    it as non-finite at the same steps of every flush window, write a
    bundle each time, and report no member as masked (the default warns)."""
    import dataclasses as dc

    from sparse_coding__tpu.data.chunks import save_chunk as jax_save_chunk
    from sparse_coding__tpu.telemetry import read_events as jax_read_events
    from sparse_coding__tpu.train.sweep import sweep as jax_sweep
    from sparse_coding__tpu.utils.config import EnsembleArgs as JaxEnsembleArgs

    rng = np.random.default_rng(2)
    store = tmp_path / "store"
    for i in range(2):
        jax_save_chunk(store, i, rng.standard_normal((2 * B, D)).astype(np.float32))
    common = dict(dataset_folder=str(store), batch_size=B, n_epochs=1, activation_width=D)
    jens = _jax_init(JaxEnsembleArgs(**common))
    jens.state = dc.replace(jens.state, buffers={**jens.state.buffers,
                                                 "l1_alpha": jnp.asarray([L1[0], np.nan], jnp.float32)})
    st = jax.device_get(jens.state)
    opt = {"count": np.asarray(st.opt_state[0].count), "mu": dict(st.opt_state[0].mu), "nu": dict(st.opt_state[0].nu)}

    def jax_init(cfg):
        return ([(jens, {"batch_size": cfg.batch_size, "dict_size": N}, "l1")], *_ranges())

    def port_init(cfg):
        ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": a} for a in L1], optimizer_kwargs={"learning_rate": LR},
                             activation_size=D, n_dict_components=N, device="cpu")
        ens.state = state_from_jax_numpy(st.params, st.buffers, opt, device="cpu")
        return ([(ens, {"batch_size": cfg.batch_size, "dict_size": N}, "l1")], *_ranges())

    with pytest.warns(RuntimeWarning, match="nonfinite"):
        jax_sweep(jax_init, JaxEnsembleArgs(output_folder=str(tmp_path / "jax"), **common))
    with pytest.warns(RuntimeWarning, match="nonfinite"):
        tsweep.sweep(port_init, tconfig.EnsembleArgs(output_folder=str(tmp_path / "torch"), **common), device="cpu")
    tev, jev = read_events(tmp_path / "torch" / "events.jsonl"), jax_read_events(tmp_path / "jax" / "events.jsonl")
    got = _anomalies(tev)
    assert got == _anomalies(jev) and got
    assert {m for e in got for m in e[2]} == {1} and {e[3] for e in got} == {"warn"}
    assert sorted(p.name for p in (tmp_path / "torch" / "diagnostics").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax" / "diagnostics").iterdir())
    assert tev[-1]["masked_models"] == jev[-1]["masked_models"] == []


def test_synthetic_sweep_streams_and_caches_alike_and_keeps_its_config(tmp_path):
    """`init_synthetic_dataset` materializes a `SparseMixDataset` store and
    its ground truth; the cached-chunk path (``hbm_cache_chunks``) trains bit
    for bit as the streaming one; ``config.yaml`` loads in both packages."""
    from sparse_coding__tpu.utils.config import SyntheticEnsembleArgs as JaxArgs

    def cfg(out, **kw):
        return tconfig.SyntheticEnsembleArgs(
            use_synthetic_dataset=True, activation_width=D, n_ground_truth_components=N, gen_batch_size=256,
            feature_num_nonzero=4, feature_prob_decay=0.99, noise_magnitude_scale=0.01, n_chunks=2,
            chunk_size_gb=512 * D * 2 / 1024**3, batch_size=128, n_epochs=2, dataset_folder=str(tmp_path / "act"),
            output_folder=str(tmp_path / out), **kw)

    def init(c):
        ens = build_ensemble(FunctionalTiedSAE, c.seed, [{"l1_alpha": a} for a in L1],
                             optimizer_kwargs={"learning_rate": LR}, activation_size=D, n_dict_components=N,
                             device="cpu")
        return ([(ens, {"batch_size": c.batch_size, "dict_size": N}, "l1")], *_ranges())

    a = tsweep.sweep(init, cfg("stream"), device="cpu")
    b = tsweep.sweep(init, cfg("cached", hbm_cache_chunks=True), device="cpu")
    assert sorted(p.name for p in (tmp_path / "act").glob("*.npy")) == ["0.npy", "1.npy"]
    assert np.load(tmp_path / "act" / "0.npy").shape == (512, D)
    truth = np.load(tmp_path / "stream" / "ground_truth_dict.npy")
    np.testing.assert_allclose(np.linalg.norm(truth, axis=1), 1.0, rtol=1e-5)
    for (la, ha), (lb, hb) in zip(a, b):
        assert ha == hb and torch.equal(la.encoder, lb.encoder) and torch.equal(la.encoder_bias, lb.encoder_bias)
    back = tconfig.SyntheticEnsembleArgs.load_yaml(tmp_path / "cached" / "_3" / "config.yaml")
    assert back == cfg("cached", hbm_cache_chunks=True)
    jback = JaxArgs.load_yaml(tmp_path / "cached" / "_3" / "config.yaml")
    assert dataclasses.asdict(jback) == back.as_dict()
    # every step's losses, for each member: 4 positions × 4 steps of each chunk
    recs = [json.loads(line) for line in open(tmp_path / "stream" / "sweep_stream_metrics.jsonl")]
    metrics = {r["metric"] for r in recs}
    assert metrics == {"loss", "l_reconstruction", "l_l1"}
    assert {r["step"] for r in recs} == {0, 1, 2, 3} and len(recs) == 4 * 4 * len(metrics) * 2


def test_the_config_classes_keep_the_jax_fields():
    from sparse_coding__tpu.utils import config as jconfig

    for name in ("TrainArgs", "EnsembleArgs", "SyntheticEnsembleArgs"):
        port, ref = getattr(tconfig, name)(), getattr(jconfig, name)()
        assert port.as_dict() == ref.as_dict(), name
    assert tconfig.TrainArgs(dtype="bfloat16").torch_dtype == torch.bfloat16
    for bad in (dict(layer_loc="nowhere"), dict(dtype="int3"), dict(batch_size=0)):
        with pytest.raises(ValueError):
            tconfig.TrainArgs(**bad)
    assert tconfig.TrainArgs.from_cli(["--batch_size", "7", "--center_activations", "true"]).batch_size == 7


def test_what_waits_for_later_slices_raises_naming_the_roadmap(tmp_path):
    from sparse_coding__tpu_torch.data.activations import capture_fn
    from sparse_coding__tpu_torch.lm.model import config_for

    from sparse_coding__tpu_torch.data.activations import make_activation_dataset
    from sparse_coding__tpu_torch.lm.ring_attention import ring_attention
    from sparse_coding__tpu_torch.train.big_batch import train_big_batch

    # an empty store is harvested now (tests/test_torch_harvest.py), on the
    # blockwise attention too, and the image dashboards are drawn
    # (tests/test_torch_plotting.py), and the big-batch trainer takes a mesh
    # (tests/test_torch_elastic_resume.py); the sequence-parallel harvest is
    # ported (tests/test_torch_seqpar.py): its single-device options raise
    # JAX's ValueError with a mesh, and ring attention needs one
    assert callable(capture_fn(config_for("pythia-70m"), ["blocks.2.hook_resid_post"], 3, attn="blockwise"))
    with pytest.raises(ValueError, match="single-device"):
        make_activation_dataset(None, config_for("pythia-70m"), np.zeros((1, 4), np.int32), tmp_path / "h", [2],
                                ["residual"], mesh=object(), compute_dtype="bfloat16", device="cpu")
    with pytest.raises(ValueError, match="mesh="):
        ring_attention("data")
    assert "mesh" in inspect.signature(train_big_batch).parameters
    assert not (tmp_path / "h_l2_residual").exists()


def _random_tied(n, d, seed):
    from sparse_coding__tpu.models.learned_dict import TiedSAE as JaxTied
    from sparse_coding__tpu_torch.models.learned_dict import TiedSAE

    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((n, d)).astype(np.float32)
    bias = (rng.standard_normal(n) * 0.5 - 0.5).astype(np.float32)
    return TiedSAE(torch.from_numpy(enc), torch.from_numpy(bias)), JaxTied(jnp.asarray(enc), jnp.asarray(bias))


def test_log_sweep_metrics_matches_the_jax_package(tmp_path):
    """Feature-activity counts and the small-vs-larger MMCS grid over a
    2 × 2 × 2 grid (l1, dict size, a third hyperparam), one untrained cell."""
    from sparse_coding__tpu.train.sweep import log_sweep_metrics as jax_log_sweep_metrics

    ranges = {"l1_alpha": [1e-3, 3e-3], "dict_size": [32, 64], "tied": [True, False]}
    tl, jl, seed = [], [], 0
    for l1 in ranges["l1_alpha"]:
        for size in ranges["dict_size"]:
            for tied in ranges["tied"]:
                if (l1, size, tied) == (3e-3, 64, False):
                    continue  # an untrained grid cell: NaN on both sides
                t, j = _random_tied(size, D, seed)
                seed += 1
                hp = {"l1_alpha": l1, "dict_size": size, "tied": tied}
                tl.append((t, hp))
                jl.append((j, hp))
    chunk = np.random.default_rng(9).standard_normal((3000, D)).astype(np.float32)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    logger = MetricLogger(out_dir=str(tmp_path / "t"), run_name="m")
    got = tsweep.log_sweep_metrics(tl, torch.from_numpy(chunk), 4, ranges, logger, str(tmp_path / "t"))
    logger.close()
    ref = jax_log_sweep_metrics(jl, jnp.asarray(chunk), 4, ranges, None, str(tmp_path / "j"))
    assert got["n_active"] == ref["n_active"]
    for name in ref["feat_counts"]:
        np.testing.assert_array_equal(got["feat_counts"][name], np.asarray(ref["feat_counts"][name]))
    assert sorted(got["mmcs_grids"]) == sorted(ref["mmcs_grids"]) == ["tied_False", "tied_True"]
    t_npz, j_npz = np.load(tmp_path / "t" / "mmcs_grids_4.npz"), np.load(tmp_path / "j" / "mmcs_grids_4.npz")
    for name in ref["mmcs_grids"]:
        np.testing.assert_allclose(t_npz[name], j_npz[name], rtol=1e-5, equal_nan=True)
    assert np.isnan(t_npz["tied_False"][1, 0])
    recs = [json.loads(line) for line in open(tmp_path / "t" / "m_metrics.jsonl")]
    assert {r["metric"] for r in recs} == {f"{n}_{k}" for n in ref["n_active"] for k in ("n_active", "prop_active")}


def test_metric_logger_copies_each_window_once(tmp_path, monkeypatch):
    """`log` keeps the tensors; `flush` copies the window in one transfer
    and writes the JAX package's record schema."""
    copies = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: copies.append(1) or real_cpu(self, *a, **k))
    logger = MetricLogger(out_dir=str(tmp_path), run_name="r", model_names=["a", "b"])
    for step in range(10):
        logger.log(step, {"loss": torch.tensor([1.0, 2.0]) * step, "l_l1": torch.tensor([0.5, 0.25])})
    assert copies == []
    logger.flush()
    assert len(copies) == 1
    logger.close()
    recs = [json.loads(line) for line in open(tmp_path / "r_metrics.jsonl")]
    assert len(recs) == 10 * 2 * 2 and set(recs[0]) == {"step", "series", "metric", "value", "ts"}
    assert {(r["series"], r["value"]) for r in recs if r["step"] == 3 and r["metric"] == "loss"} == {("a", 3.0),
                                                                                                    ("b", 6.0)}


# -- (f) the generators --------------------------------------------------------------

def test_correlated_generator_transforms_match_the_jax_package():
    from sparse_coding__tpu.data import synthetic as js

    n, bs = 48, 256
    key = jax.random.PRNGKey(3)
    m = np.array(jax.random.uniform(key, (n, n)))
    ref = np.array(js.generate_corr_matrix(key, n))
    got = to_np(ts.corr_matrix_from_uniform(torch.from_numpy(m)))
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())
    np.testing.assert_allclose(to_np(ts.chol_factor(torch.from_numpy(ref))), np.asarray(js.chol_factor(jnp.asarray(ref))),
                               atol=1e-5)
    chol = np.array(js.chol_factor(jnp.asarray(ref)))
    feats = np.array(js.generate_rand_feats(jax.random.PRNGKey(4), D, n))
    decay = np.asarray([0.99**i for i in range(n)], np.float32)
    k = jax.random.PRNGKey(5)
    jc, jd = js.sample_correlated_dataset(k, jnp.asarray(chol), jnp.asarray(feats), 4 / n, jnp.asarray(decay), n, bs)
    k_mvn, k_thresh, k_vals, k_fix, k_strength = jax.random.split(k, 5)
    draws = [np.array(jax.random.normal(k_mvn, (n,))), np.array(jax.random.uniform(k_thresh, (bs, n))),
             np.array(jax.random.uniform(k_vals, (bs, n))), np.array(jax.random.randint(k_fix, (bs,), 0, n)),
             np.array(jax.random.uniform(k_strength, (bs, n)))]
    z, thresh, values, fix, strengths = (torch.from_numpy(a) for a in draws)
    tc, td = ts.correlated_from_draws(torch.from_numpy(chol), z, thresh, values, fix.long(), strengths,
                                      torch.from_numpy(feats), 4 / n, torch.from_numpy(decay))
    np.testing.assert_array_equal(to_np(tc) != 0, np.asarray(jc) != 0)
    np.testing.assert_allclose(to_np(tc), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(to_np(td), np.asarray(jd), atol=1e-5)
    assert ((np.asarray(jc) != 0).sum(axis=1) > 0).all()


def _l0_and_power(codes_and_data):
    codes, data = zip(*codes_and_data)
    codes, data = np.concatenate([np.asarray(to_np(c)) for c in codes]), np.concatenate([to_np(d) for d in data])
    return (codes != 0).sum(axis=1).mean(), (data**2).sum(axis=1).mean()


def test_correlated_draws_follow_the_jax_package_statistics():
    """The port's own draws: mean L0 and activation power within 5% of the
    JAX package's over 16 batches, and every row non-empty; the generators
    built on them yield finite batches of their shape."""
    from sparse_coding__tpu.data import synthetic as js

    n, bs, nnz = 64, 1024, 6
    eye = np.eye(n, dtype=np.float32)
    chol = ts.chol_factor(torch.from_numpy(eye))
    feats = ts.generate_rand_feats(torch.Generator().manual_seed(0), D, n, "cpu")
    decay = ts._decay(0.99, n, "cpu")
    gen = torch.Generator().manual_seed(1)
    port = [ts.sample_correlated_dataset(gen, chol, feats, nnz / n, decay, n, bs) for _ in range(16)]
    keys = jax.random.split(jax.random.PRNGKey(1), 16)
    jf, jdec, jchol = jnp.asarray(to_np(feats)), jnp.asarray(to_np(decay)), js.chol_factor(jnp.asarray(eye))
    ref = [js.sample_correlated_dataset(k, jchol, jf, nnz / n, jdec, n, bs) for k in keys]
    (tl0, tpow), (jl0, jpow) = _l0_and_power(port), _l0_and_power(ref)
    assert abs(tl0 / jl0 - 1) < 0.05 and abs(tpow / jpow - 1) < 0.05, (tl0, jl0, tpow, jpow)
    assert all(((to_np(c) != 0).sum(axis=1) > 0).all() for c, _ in port)

    g = ts.RandomDatasetGenerator(D, n, 128, nnz, 0.99, correlated=True, key=0, device="cpu")
    x = next(g)
    assert x.shape == (128, D) and torch.isfinite(x).all()
    assert torch.allclose(g.corr_matrix, g.corr_matrix.T) and torch.linalg.eigvalsh(g.corr_matrix).min() >= -1e-5
    mix = ts.SparseMixDataset(D, n, 128, nnz, 0.99, 0.1, key=0, sparse_component_covariance=torch.eye(n),
                              device="cpu")
    jmix = js.SparseMixDataset(D, n, 128, nnz, 0.99, 0.1, key=jax.random.PRNGKey(0),
                               sparse_component_dict=jnp.asarray(to_np(mix.sparse_component_dict)),
                               sparse_component_covariance=jnp.eye(n))
    tp = np.mean([float((mix.send(1024) ** 2).sum(dim=1).mean()) for _ in range(16)])
    jp = np.mean([float((jmix.send(1024) ** 2).sum(axis=1).mean()) for _ in range(16)])
    assert abs(tp / jp - 1) < 0.05, (tp, jp)


# -- (g) SGD and schedules on the fused-grads route ------------------------------------

def _jax_step(tx):
    from sparse_coding__tpu.ensemble import make_ensemble_step
    from sparse_coding__tpu.models import FunctionalTiedSAE as JaxTiedSAE

    class Interpreted(JaxTiedSAE):
        """The fused Pallas kernels in interpret mode (the CPU)."""

        @staticmethod
        def fused_grads_stacked(params, buffers, batch):
            return JaxTiedSAE.fused_grads_stacked(params, buffers, batch, interpret=True)

    return jax.jit(make_ensemble_step(Interpreted, tx, compute_dtype=jnp.bfloat16, fused=True))


@pytest.mark.parametrize("optimizer", ["sgd", "sgd_schedule", "adam_schedule"])
def test_sgd_and_schedules_take_the_fused_grads_route_and_match_make_ensemble_step(optimizer):
    from sparse_coding__tpu.ensemble import EnsembleState as JaxState
    from sparse_coding__tpu.ensemble import stack_pytrees
    from sparse_coding__tpu.models import FunctionalTiedSAE as JaxTiedSAE

    d, n, b = 128, 512, 256
    models = [JaxTiedSAE.init(k, d, n, l1_alpha=a) for k, a in zip(jax.random.split(jax.random.PRNGKey(0), 2), L1)]
    params, buffers = stack_pytrees([p for p, _ in models]), stack_pytrees([q for _, q in models])
    name = "adam" if optimizer.startswith("adam") else "sgd"
    if optimizer == "sgd":
        tx, lr = optax.sgd(0.05), 0.05
    else:
        peak = 0.05 if name == "sgd" else LR
        tx = (optax.sgd if name == "sgd" else optax.adam)(optax.linear_schedule(0.0, peak, 2))
        lr = toptim.linear_schedule(0.0, peak, 2)
    kw = dict(optimizer=name, optimizer_kwargs={"learning_rate": lr}, compute_dtype="bfloat16", activation_size=d,
              n_dict_components=n, device="cpu")
    if optimizer == "adam_schedule":
        with pytest.warns(UserWarning, match=r"non-scalar learning_rate \(schedule\)"):
            ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": a} for a in L1], **kw)
    else:
        ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": a} for a in L1], **kw)
    assert ens.fused and ens.fused_adam is None
    opt_state = jax.vmap(tx.init)(params)
    jst = JaxState(params=params, buffers=buffers, opt_state=opt_state, step=jnp.asarray(0, jnp.int32))
    st = jax.device_get(jst)
    if name == "adam":
        adam = {"count": np.asarray(st.opt_state[0].count), "mu": dict(st.opt_state[0].mu),
                "nu": dict(st.opt_state[0].nu)}
        ens.state = state_from_jax_numpy(st.params, st.buffers, adam, device="cpu")
    else:
        carried = state_from_jax_numpy(st.params, st.buffers, device="cpu")
        ens.state = dataclasses.replace(carried, opt_state=ens.tx.init(carried.params))
    step = _jax_step(tx)
    xs = np.random.default_rng(2).standard_normal((3, b, d)).astype(np.float32)
    tk.reset_launches()
    for i in range(3):
        before_t = {k: v.clone() for k, v in ens.state.params.items()}
        before_j = jax.device_get(jst.params)
        jst, (jl, _) = step(jst, jnp.asarray(xs[i]))
        tl, _ = ens.step_batch(torch.from_numpy(xs[i]))
        for k in ("loss", "l_reconstruction", "l_l1"):
            np.testing.assert_allclose(to_np(tl[k]), np.asarray(jl[k]), rtol=1e-3, err_msg=k)
        after_j = jax.device_get(jst.params)
        for k in ("encoder", "encoder_bias"):
            du_t = to_np(ens.state.params[k]) - to_np(before_t[k])
            du_j = np.asarray(after_j[k]) - np.asarray(before_j[k])
            if i == 0 and optimizer != "sgd":
                assert np.abs(du_t).max() == 0 and np.abs(du_j).max() == 0  # the schedule starts at 0
            else:
                assert_grads_close(du_t, du_j, f"{optimizer} step {i} {k}", max_rel=1e-2 if name == "sgd" else 0.1)
            ens.state.params[k].copy_(torch.from_numpy(np.asarray(after_j[k])))  # the same point next step
    assert sum(tk.LAUNCHES.values()) == 0  # CPU tensors: the plain versions ran
