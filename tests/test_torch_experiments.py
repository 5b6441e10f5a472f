"""The port's experiment catalog (`train/experiments.py`) and untied SAE
(`models/sae.py::FunctionalSAE`) against the JAX package's, on the CPU.

Tolerances, and why:
  - builder contracts: names, args, hyperparameter names and ranges, member
    counts, buffer values and param shapes exactly (the grids are the same
    numpy expressions; buffer values are f32 of them on both sides);
  - `FunctionalSAE` in f32: losses and gradients rtol 1e-5 (matmuls summing
    in another order), as the f32 slice's pins; under the bf16 policy the
    losses rtol 1e-3 and gradients cosine > 0.9999 / max rel 1e-2 (bf16
    roundings of c moved by f32 noise), the bf16 slice's bounds;
  - the sweep against the JAX sweep (f32 autograd, each chunk one batch):
    params within 1e-2 lr per step, the export re-evaluated in JAX to FVU
    rtol 1e-5 and L0 within one row (`tests/test_torch_sweep.py`'s bounds);
  - metrics on the same dicts and batch: f32 values rtol 1e-5 (atol 1e-6
    where a value sums to ~0), counts and assignments exactly, except where
    an entry within f32 noise of the relu's zero may flip (L0 within one
    row, as `tests/test_torch_metrics.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_grads_close, to_np
from sparse_coding__tpu.metrics import standard as jm
from sparse_coding__tpu.models import learned_dict as jld
from sparse_coding__tpu.train import experiments as jexp
from sparse_coding__tpu.utils.config import EnsembleArgs as JaxEnsembleArgs
from sparse_coding__tpu_torch import Ensemble, FunctionalSAE
from sparse_coding__tpu_torch.interop import state_from_jax_numpy
from sparse_coding__tpu_torch.metrics import standard as tm
from sparse_coding__tpu_torch.models import learned_dict as tld
from sparse_coding__tpu_torch.train import experiments as texp
from sparse_coding__tpu_torch.utils import precision as px
from sparse_coding__tpu_torch.utils.config import EnsembleArgs

PORTED = ["tied_vs_not_experiment", "topk_experiment", "synthetic_linear_range", "dense_l1_range_experiment",
          "simple_setoff", "residual_denoising_comparison", "zero_l1_baseline", "long_mlp_sweep",
          "pythia_1_4_b_dict"]


def _np(v):
    return None if v is None else to_np(v) if isinstance(v, torch.Tensor) else np.asarray(v)


def _contract(out):
    """A builder's output as plain values: per ensemble (signature name,
    member count, args, name, param shapes, buffer values), then the
    hyperparameter names and ranges."""
    ensembles, ens_hp, buf_hp, ranges = out
    rows = []
    for ens, args, name in ensembles:
        st = ens.state
        rows.append((
            ens.sig.__name__, ens.n_models, dict(args), name,
            {k: tuple(v.shape) for k, v in st.params.items()},
            {k: (None if v is None else (_np(v).dtype.kind, _np(v).shape, _np(v).tolist()))
             for k, v in st.buffers.items()},
            ens.l1_warmup_steps,
        ))
    return rows, list(ens_hp), list(buf_hp), {k: [float(x) for x in v] for k, v in ranges.items()}


@pytest.mark.parametrize("name,recall", [(n, None) for n in PORTED] + [("topk_experiment", 0.95)])
def test_builders_keep_the_jax_contract(name, recall):
    """Each ported builder at ``EnsembleArgs(activation_width=16,
    batch_size=32)``: the same ensembles (signature, members, names, args),
    param shapes, buffers (``l1_alpha``, ``bias_decay``, ``sparsity``, the
    cap, ``recall``) and hyperparameter names and ranges as the JAX
    builder's; ``topk_recall`` only changes the TopK signature."""
    kw = dict(activation_width=16, batch_size=32, topk_recall=recall)
    got = _contract(getattr(texp, name)(EnsembleArgs(**kw), device="cpu"))
    want = _contract(getattr(jexp, name)(JaxEnsembleArgs(**kw)))
    assert got == want


def test_builders_take_the_warmup_and_the_untied_flag():
    """``cfg.l1_warmup_steps`` reaches l1 signatures and warns (and is
    dropped) for TopK; ``tied_ae=False`` builds `FunctionalSAE`."""
    cfg = EnsembleArgs(activation_width=16, batch_size=32, l1_warmup_steps=5, tied_ae=False)
    ens, _, _ = texp.dense_l1_range_experiment(cfg, device="cpu")[0][0]
    assert ens.sig is FunctionalSAE and ens.l1_warmup_steps == 5
    with pytest.warns(UserWarning, match="l1_warmup_steps=5 ignored"):
        out = texp.topk_experiment(cfg, device="cpu")
    assert all(e.l1_warmup_steps == 0 for e, _, _ in out[0])


@pytest.mark.parametrize("dtype,want", [(None, None), ("float32", None), ("bfloat16", torch.bfloat16)])
def test_builders_compute_in_the_configs_dtype(dtype, want):
    """The run config's ``dtype`` (a field both packages' configs share,
    default float32) is every ensemble's compute dtype: float32 is exact
    f32 (None), bfloat16 the route to the fused kernels."""
    kw = {} if dtype is None else {"dtype": dtype}
    cfg = EnsembleArgs(activation_width=16, batch_size=32, **kw)
    for name in ("tied_vs_not_experiment", "topk_experiment"):
        assert [e.compute_dtype for e, _, _ in getattr(texp, name)(cfg, device="cpu")[0]] == [want] * (
            2 if name == "tied_vs_not_experiment" else 4)


@pytest.mark.parametrize("call", ["mesh"])
def test_what_is_not_ported_raises_naming_its_roadmap_item(call, tmp_path):
    """The catalog's last refusal (``mesh=``) is lifted: a builder given a
    mesh returns its ensembles sharded on it (a world of one's here; the
    sharded sweep itself is `tests/test_torch_elastic_resume.py`'s)."""
    from sparse_coding__tpu_torch.parallel import make_mesh

    cfg = EnsembleArgs(activation_width=16, batch_size=32)
    mesh = make_mesh()
    ensembles = texp.zero_l1_baseline(cfg, mesh=mesh, device="cpu")[0]
    assert [ens.mesh for ens, _, _ in ensembles] == [mesh] * len(ensembles)


def test_run_single_layer_trains_an_existing_store_at_a_given_width(tmp_path):
    """With ``activation_width`` and a chunk store in its ``dataset_folder``,
    `run_single_layer` runs its builder through the sweep (no harvest)."""
    from sparse_coding__tpu_torch.data.chunks import save_chunk

    rng = np.random.default_rng(0)
    for i in range(2):
        save_chunk(tmp_path / "store", i, rng.standard_normal((64, 16)).astype(np.float32))
    lds = texp.run_single_layer(experiment=texp.zero_l1_baseline, activation_width=16, device="cpu",
                                dataset_folder=str(tmp_path / "store"), output_folder=str(tmp_path / "out"),
                                batch_size=32, n_epochs=1)
    assert [hp for _, hp in lds] == [{"dict_size": 64, "l1_alpha": 0.0}]
    assert (tmp_path / "out" / "_1" / "learned_dicts.pkl").exists()


# -- FunctionalSAE against the JAX signature ------------------------------------

def _sae_params(M=3, D=16, N=32, seed=0):
    from sparse_coding__tpu.ensemble import stack_pytrees
    from sparse_coding__tpu.models import FunctionalSAE as JaxSAE

    keys = jax.random.split(jax.random.PRNGKey(seed), M)
    models = [JaxSAE.init(k, D, N, l1, bias_decay=bd) for k, l1, bd in zip(keys, (1e-3, 3e-3, 1e-2), (0.0, 0.05, 0.1))]
    params = stack_pytrees([p for p, _ in models])
    # a non-zero bias, so the bias decay's gradient is exercised
    params["encoder_bias"] = 0.01 * jax.random.normal(jax.random.PRNGKey(seed + 1), params["encoder_bias"].shape)
    return JaxSAE, params, stack_pytrees([b for _, b in models])


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_functional_sae_loss_and_grads_match_jax(dtype):
    JaxSAE, jp, jb = _sae_params()
    x = np.random.default_rng(1).standard_normal((64, 16)).astype(np.float32)
    from sparse_coding__tpu.utils import precision as jpx

    def jloss(p):
        with jpx.compute(None if dtype is None else jnp.bfloat16):
            total, (ld, aux) = jax.vmap(JaxSAE.loss, in_axes=(0, 0, None))(p, jb, jnp.asarray(x))
        return total.sum(), ld

    (_, jl), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in jp.items()}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    with px.compute(dtype):
        total, (tl, aux) = FunctionalSAE.loss(tp, tb, torch.from_numpy(x))
    tg = dict(zip(tp, torch.autograd.grad(total.sum(), list(tp.values()))))
    assert set(tl) == set(jl) == {"loss", "l_reconstruction", "l_l1", "l_bias_decay"}
    for k in jl:
        np.testing.assert_allclose(to_np(tl[k]), np.asarray(jl[k]), rtol=1e-5 if dtype is None else 1e-3, err_msg=k)
    for k in jg:
        if dtype is None:
            np.testing.assert_allclose(to_np(tg[k]), np.asarray(jg[k]), rtol=1e-5, atol=1e-8, err_msg=k)
        else:
            assert_grads_close(tg[k], jg[k], k)
    ld = FunctionalSAE.to_learned_dict({k: v[0].detach() for k, v in tp.items()}, {})
    assert isinstance(ld, tld.UntiedSAE) and ld.n_feats == 32


def test_untied_ensemble_checkpoint_resumes():
    """An untied ensemble's `state_dict` rebuilds by its signature's name and
    steps on identically."""
    ens = texp.tied_vs_not_experiment(EnsembleArgs(activation_width=16, batch_size=32), device="cpu")[0][0][0]
    x = torch.randn((2, 32, 16), generator=torch.Generator().manual_seed(0))
    ens.step_batch(x[0])
    clone = Ensemble.from_state(ens.state_dict(), device="cpu")
    assert clone.sig is FunctionalSAE
    la, lb = ens.step_batch(x[1])[0], clone.step_batch(x[1])[0]
    assert all(torch.equal(la[k], lb[k]) for k in la)


def test_run_sweep_synthetic_tied_vs_not_matches_the_jax_run(tmp_path):
    """`run_sweep_synthetic(tied_vs_not_experiment)` at width 16 in both
    packages on one store the JAX run writes, the port's builder wrapped to
    start from the JAX builder's initial state: the same hyperparams
    (``dict_size``, ``tied``, ``l1_alpha``, ``bias_decay``), params to f32
    tolerance, and the port's export loads in JAX, verified, and
    re-evaluates there to the port's FVU and L0."""
    from sparse_coding__tpu.train.checkpoint import load_learned_dicts as jax_load

    common = dict(activation_width=16, n_ground_truth_components=32, feature_num_nonzero=4, gen_batch_size=64,
                  chunk_size_gb=64 * 16 * 2 / 1024**3, n_chunks=2, batch_size=64,
                  dataset_folder=str(tmp_path / "store"))
    start = {}

    def jax_builder(cfg, mesh=None):
        out = jexp.tied_vs_not_experiment(cfg, mesh)
        for ens, _, name in out[0]:
            st = jax.device_get(ens.state)
            adam = st.opt_state[0]
            start[name] = (st.params, st.buffers, {"count": np.asarray(adam.count), "mu": dict(adam.mu),
                                                   "nu": dict(adam.nu)})
        return out

    def port_builder(cfg, **kw):
        out = texp.tied_vs_not_experiment(cfg, **kw)
        for ens, _, name in out[0]:
            ens.state = state_from_jax_numpy(*start[name], device="cpu")
        return out

    jlds = jexp.run_sweep_synthetic(jax_builder, output_folder=str(tmp_path / "jax"), **common)
    tlds = texp.run_sweep_synthetic(port_builder, device="cpu", output_folder=str(tmp_path / "torch"), **common)
    assert [hp for _, hp in tlds] == [hp for _, hp in jlds]
    assert [(hp["tied"], type(ld).__name__) for ld, hp in tlds][::12] == [(False, "UntiedSAE"), (True, "TiedSAE")]
    for (t, _), (j, _) in zip(tlds, jlds):
        for f in ("encoder", "encoder_bias") + (("decoder",) if isinstance(t, tld.UntiedSAE) else ()):
            diff = np.abs(to_np(getattr(t, f)) - np.asarray(getattr(j, f))).max()
            assert diff <= 1e-2 * 1e-3 * 2, (f, diff)
    loaded = jax_load(tmp_path / "torch" / "_1" / "learned_dicts.pkl", verify=True)
    assert [hp for _, hp in loaded] == [hp for _, hp in tlds]
    x = np.random.default_rng(1).standard_normal((200, 16)).astype(np.float32)
    got = tm.evaluate_dicts([ld for ld, _ in tlds], torch.from_numpy(x))
    ref = jm.evaluate_dicts([ld for ld, _ in loaded], jnp.asarray(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["fvu"], r["fvu"], rtol=1e-5)
        assert abs(g["l0"] - r["l0"]) <= 1.0 / len(x)


# -- metrics against the JAX package's -----------------------------------------

D, N, B = 16, 32, 96


def _dict_pair(kind: str, seed: int):
    """(JAX dict, port dict) of one class from the same numpy arrays."""
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((N, D)).astype(np.float32)
    dec = rng.standard_normal((N, D)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(N) - 0.2).astype(np.float32)
    t = torch.from_numpy
    if kind == "tied":
        return jld.TiedSAE(jnp.asarray(enc), jnp.asarray(bias), norm_encoder=True), tld.TiedSAE(
            t(enc), t(bias), norm_encoder=True)
    if kind == "untied":
        return jld.UntiedSAE(jnp.asarray(enc), jnp.asarray(dec), jnp.asarray(bias)), tld.UntiedSAE(
            t(enc), t(dec), t(bias))
    if kind == "reverse":
        return jld.ReverseSAE(jnp.asarray(enc), jnp.asarray(bias), True), tld.ReverseSAE(t(enc), t(bias), True)
    raise ValueError(kind)


def _metric_inputs():
    (ja, ta), (jb, tb), (ju, tu) = _dict_pair("tied", 0), _dict_pair("tied", 1), _dict_pair("untied", 2)
    x = np.random.default_rng(3).standard_normal((B, D)).astype(np.float32)
    truth = np.random.default_rng(4).standard_normal((24, D)).astype(np.float32)
    truth /= np.linalg.norm(truth, axis=-1, keepdims=True)
    return (ja, ta), (jb, tb), (ju, tu), x, truth


def _close(got, want, what, rtol=1e-5, atol=1e-6):
    if isinstance(want, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}[{i}]", rtol, atol)
        return
    np.testing.assert_allclose(np.asarray(_np(got), np.float64), np.asarray(np.asarray(want), np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


METRICS = ["mmcs_from_list", "representedness", "hungarian_matched_mcs", "mean_nonzero_activations",
           "fraction_variance_unexplained_top_activating", "r_squared", "neurons_per_feature",
           "capacity_per_feature", "interference_capacity", "calc_feature_n_active", "calc_feature_mean",
           "calc_feature_variance", "calc_feature_skew", "calc_feature_kurtosis",
           "batched_calc_feature_n_ever_active", "calc_moments_streaming", "logistic_regression_auroc",
           "ridge_regression_auroc"]


@pytest.mark.parametrize("metric", METRICS)
def test_metric_matches_jax(metric):
    (ja, ta), (jb, tb), (ju, tu), x, truth = _metric_inputs()
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jt, tt = jnp.asarray(truth), torch.from_numpy(truth)
    jf, tf_ = getattr(jm, metric), getattr(tm, metric)
    if metric == "mmcs_from_list":
        _close(tf_([ta, tb, tu]), jf([ja, jb, ju]), metric)
    elif metric == "representedness":
        _close(tf_(tt, tu), jf(jt, ju), metric)
    elif metric == "hungarian_matched_mcs":
        (gv, gc), (wv, wc) = tf_(tu, tt), jf(ju, jt)
        assert np.array_equal(gc, wc)
        _close(gv, wv, metric)
    elif metric in ("mean_nonzero_activations", "fraction_variance_unexplained_top_activating", "r_squared"):
        for j, t in ((ja, ta), (ju, tu)):
            _close(tf_(t, tx), jf(j, jx), metric, atol=1.0 / B)
    elif metric in ("neurons_per_feature", "capacity_per_feature", "interference_capacity"):
        _close(tf_(tu), jf(ju), metric)
    elif metric.startswith("calc_feature"):
        code = np.maximum(x @ np.asarray(ja.get_learned_dict()).T - 0.3, 0).astype(np.float32)
        _close(tf_(torch.from_numpy(code)), jf(jnp.asarray(code)), metric, rtol=1e-4)
    elif metric == "batched_calc_feature_n_ever_active":
        for thr in (0, 10, 40):
            assert tf_(tu, tx, batch_size=32, threshold=thr) == jf(ju, jx, batch_size=32, threshold=thr)
    elif metric == "calc_moments_streaming":
        _close(tuple(tf_(tu, tx, batch_size=40)), tuple(jf(ju, jx, batch_size=40)), metric, rtol=1e-5, atol=1e-6)
    else:
        labels = (x[:, 0] > 0).astype(np.int64)
        acts = np.asarray(ju.encode(jx))
        assert tf_(torch.from_numpy(acts), torch.from_numpy(labels)) == pytest.approx(jf(acts, labels), rel=1e-9)


def test_moments_streaming_equal_one_batch_exactly_computed():
    """One batch: the streaming moments are that batch's code moments
    (rtol 1e-5; what the card's smoke holds them to)."""
    (_, _), (_, _), (_, tu), x, _ = _metric_inputs()
    tx = torch.from_numpy(x)
    times, mean, var, skew, kurt, m4 = tm.calc_moments_streaming(tu, tx, batch_size=B)
    c = tu.encode(tx).double()
    torch.testing.assert_close(mean.double(), c.mean(0), rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(var.double(), (c**2).mean(0) - c.mean(0) ** 2, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(m4.double(), (c**4).mean(0), rtol=1e-5, atol=1e-7)
    assert times.tolist() == (c.mean(0) != 0).double().tolist()


def test_evaluate_dicts_stacks_groups_and_matches_jax_and_one_at_a_time():
    """Dicts group by class, statics and shapes as the JAX package groups
    them; the values, read to the host a group at a time, equal each dict
    evaluated alone (rtol 1e-6) and JAX's (FVU rtol 1e-5, L0 within one
    row), baselines without leaves included."""
    pairs = [_dict_pair("tied", 0), _dict_pair("tied", 1), _dict_pair("untied", 2), _dict_pair("reverse", 5),
             (jld.Identity(D), tld.Identity(D, device="cpu")), _dict_pair("untied", 6)]
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    assert tm.group_stackable_dicts(ts) == jm.group_stackable_dicts(js) == [[0, 1], [2, 5], [3], [4]]
    x = np.random.default_rng(3).standard_normal((B, D)).astype(np.float32)
    got = tm.evaluate_dicts(ts, torch.from_numpy(x))
    ref = jm.evaluate_dicts(js, jnp.asarray(x))
    for ld, g, r in zip(ts, got, ref):
        alone = {"fvu": float(tm.fraction_variance_unexplained(ld, torch.from_numpy(x))),
                 "l0": float(tm.sparsity_l0(ld, torch.from_numpy(x)))}
        np.testing.assert_allclose(g["fvu"], alone["fvu"], rtol=1e-6)
        np.testing.assert_allclose(g["l0"], alone["l0"], rtol=1e-6)
        np.testing.assert_allclose(g["fvu"], r["fvu"], rtol=1e-5)
        assert abs(g["l0"] - r["l0"]) <= 1.0 / B
        assert g["r2"] == 1.0 - g["fvu"]
