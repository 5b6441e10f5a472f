"""The health pack and the feature sketch inside the port's `Ensemble` step,
against the JAX package's ensemble with both packs on (CPU, D 24, N 48,
batch 64, 3 members; inputs from numpy with a seed).

Tolerances, and why:
  - port against JAX (f32 autograd from the same state): losses rtol 1e-5
    (the slices' own); ``health_grad_norm`` and ``health_dict_norm`` rtol
    1e-5 (sums of squares of gradients that agree to f32 rounding);
    ``health_nonfinite``, ``health_dead_frac``, the sketch's ``rows``,
    ``fire`` and ``hist`` exact (counts over codes that agree to 1e-6, none
    on a bucket edge or at a ReLU boundary in this data); the firing EMA
    rtol 1e-6; ``sum``, ``sumsq`` and ``max`` rtol 1e-5;
  - port against port where only the dispatch differs (`step_scan`,
    `step_scan_idx`, per-member batches, a state round trip): bit-equal;
    ``unstacked``: the stacked losses and metrics to rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from sparse_coding__tpu_torch import Ensemble, FunctionalFista, FunctionalTiedSAE, TopKEncoderApprox, build_ensemble
from sparse_coding__tpu_torch.interop import state_from_jax_numpy
from sparse_coding__tpu_torch.telemetry.feature_stats import FEATURE_STATS_KEYS, FeatureStatsConfig
from sparse_coding__tpu_torch.telemetry.health import FIRE_EMA_KEY, HealthConfig
from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib
from sparse_coding__tpu_torch.train.loop import make_fista_decoder_update

D, N, B = 24, 48, 64
L1 = [{"l1_alpha": a} for a in (1e-4, 1e-3, 1e-2)]
OPT = {"learning_rate": 1e-3}
HEALTH = ("health_grad_norm", "health_dict_norm", "health_nonfinite", "health_dead_frac")


def _batches(k, seed=1):
    return np.random.default_rng(seed).standard_normal((k, B, D)).astype(np.float32)


def _pair(sig_name):
    """The JAX ensemble with both packs and the port's at its state."""
    import sparse_coding__tpu.models as jm
    from sparse_coding__tpu import build_ensemble as jax_build

    jsig = getattr(jm, sig_name)
    jens = jax_build(jsig, jax.random.PRNGKey(0), L1, optimizer_kwargs=OPT, activation_size=D,
                     n_dict_components=N, health=True, feature_stats=True)
    st = jax.device_get(jens.state)
    a = st.opt_state[0]
    sig = {"FunctionalTiedSAE": FunctionalTiedSAE, "FunctionalFista": FunctionalFista}[sig_name]
    ens = build_ensemble(sig, 0, L1, optimizer_kwargs=OPT, activation_size=D, n_dict_components=N, health=True,
                         feature_stats=True, device="cpu")
    assert sorted(ens.state.buffers) == sorted(st.buffers)
    ens.state = state_from_jax_numpy(st.params, st.buffers, {"count": np.asarray(a.count), "mu": dict(a.mu),
                                                              "nu": dict(a.nu)}, step=int(st.step), device="cpu")
    return jens, ens


@pytest.mark.parametrize("sig", [FunctionalTiedSAE, FunctionalFista], ids=lambda s: s.__name__)
@pytest.mark.parametrize("packs", [dict(health=True), dict(feature_stats=True), dict(health=True, feature_stats=True)],
                         ids=["health", "feature_stats", "both"])
@pytest.mark.parametrize("fused", [None, True])
def test_packs_force_the_unfused_path(sig, packs, fused):
    """Either pack turns the fused kernels off, also over ``fused=True``
    (bf16 compute, where the tied signature would otherwise fuse)."""
    ens = build_ensemble(sig, 0, L1, optimizer_kwargs=OPT, compute_dtype="bfloat16", fused=fused,
                         activation_size=128, n_dict_components=256, device="cpu", **packs)
    assert ens.fused is False and ens.fused_adam is None
    assert ens._route(256, False, False) == "autograd"
    plain = build_ensemble(sig, 0, L1, optimizer_kwargs=OPT, compute_dtype="bfloat16", fused=fused,
                           activation_size=128, n_dict_components=256, device="cpu")
    assert plain.fused == (fused is True or sig is FunctionalTiedSAE)


def test_packs_refuse_a_signature_without_encoder_or_decoder_as_jax_does():
    import sparse_coding__tpu.models as jm
    from sparse_coding__tpu import build_ensemble as jax_build

    with pytest.raises(ValueError, match="'encoder' or 'decoder'") as ref:
        jax_build(jm.TopKEncoderApprox, jax.random.PRNGKey(0), [{"sparsity": 4}], d_activation=D, n_features=N,
                  health=True)
    with pytest.raises(ValueError, match="'encoder' or 'decoder'") as got:
        build_ensemble(TopKEncoderApprox, 0, [{"sparsity": 4}], d_activation=D, n_features=N, health=True,
                       device="cpu")
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("sig_name", ["FunctionalTiedSAE", "FunctionalFista"])
def test_three_steps_with_both_packs_match_jax(sig_name):
    """Losses, the health metrics, the firing EMA and the sketch after each
    of 3 steps (FISTA: each followed by a 20-iteration decoder update)."""
    from sparse_coding__tpu.train import make_fista_decoder_update as jax_update

    jens, ens = _pair(sig_name)
    fista = sig_name == "FunctionalFista"
    for x in _batches(3):
        jl, jaux = jens.step_batch(jnp.asarray(x))
        tl, taux = ens.step_batch(torch.from_numpy(x))
        if fista:
            jens.state = jax_update(num_iter=20)(jens.state, jnp.asarray(x), jaux["c"])
            ens.state = make_fista_decoder_update(num_iter=20)(ens.state, torch.from_numpy(x), taux["c"])
        assert sorted(tl) == sorted(jl) and set(HEALTH) <= set(tl)
        jl = jax.device_get(jl)
        for k in jl:
            if k in ("health_nonfinite", "health_dead_frac"):
                np.testing.assert_array_equal(to_np(tl[k]), np.asarray(jl[k]), err_msg=k)
            else:
                np.testing.assert_allclose(to_np(tl[k]), np.asarray(jl[k]), rtol=1e-5, err_msg=k)
        jb = jax.device_get(jens.state.buffers)
        for k in ("featstat_rows", "featstat_fire", "featstat_hist"):
            np.testing.assert_array_equal(to_np(ens.state.buffers[k]), np.asarray(jb[k]), err_msg=k)
        for k in ("featstat_sum", "featstat_sumsq", "featstat_max"):
            np.testing.assert_allclose(to_np(ens.state.buffers[k]), np.asarray(jb[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(to_np(ens.state.buffers[FIRE_EMA_KEY]), np.asarray(jb[FIRE_EMA_KEY]), rtol=1e-6)
    assert ens.state.buffers["featstat_rows"].tolist() == [3.0 * B] * 3
    assert float(ens.state.buffers[FIRE_EMA_KEY].sum()) > 0


def _ens(**kw):
    return build_ensemble(FunctionalTiedSAE, 3, L1, optimizer_kwargs=OPT, activation_size=D, n_dict_components=N,
                          health=True, feature_stats=True, device="cpu", **kw)


def _state_bits(ens):
    st = ens.state
    return {**{f"p.{k}": v for k, v in st.params.items()}, **{f"b.{k}": v for k, v in st.buffers.items()
                                                           if v is not None}}


@pytest.mark.parametrize("entry", ["step_scan", "step_scan_idx", "per_model"])
def test_scans_with_the_packs_are_the_eager_steps(entry):
    """The CPU's `step_scan` / `step_scan_idx` (the plain versions the card's
    graph replays are held to) against eager steps, packs included."""
    a, b = _ens(), _ens()
    x = _batches(4, seed=2)
    if entry == "per_model":
        xs = np.stack([_batches(4, seed=3 + m) for m in range(3)], axis=1)  # [K, M, B, D]
        got = a.step_scan(torch.from_numpy(xs), per_model=True)
        ref = [b.step_batch(torch.from_numpy(xm), per_model=True)[0] for xm in xs]
    elif entry == "step_scan":
        got = a.step_scan(torch.from_numpy(x))
        ref = [b.step_batch(torch.from_numpy(xi))[0] for xi in x]
    else:
        data = torch.from_numpy(x.reshape(4 * B, D))
        idxs = torch.randperm(4 * B, generator=torch.Generator().manual_seed(0)).reshape(4, B)
        got = a.step_scan_idx(data, idxs)
        ref = [b.step_batch(data[i])[0] for i in idxs]
    for k in ref[0]:
        assert torch.equal(got[k], torch.stack([r[k] for r in ref])), k
    bits_a, bits_b = _state_bits(a), _state_bits(b)
    for k in bits_b:
        assert torch.equal(bits_a[k], bits_b[k]), k
    assert a.state.buffers["featstat_rows"].tolist() == [4.0 * B] * 3


def test_unstacked_with_the_packs_is_the_stacked_step():
    s = _ens()
    u = Ensemble.from_state({**s.state_dict(), "unstacked": True}, device="cpu")
    assert u.unstacked and u.health == s.health
    for x in _batches(2, seed=4):
        ls, _ = s.step_batch(torch.from_numpy(x))
        lu, _ = u.step_batch(torch.from_numpy(x))
        for k in ls:
            np.testing.assert_allclose(to_np(lu[k]), to_np(ls[k]), rtol=1e-6, err_msg=k)
    for k in ("featstat_rows", "featstat_fire"):
        assert torch.equal(u.state.buffers[k], s.state.buffers[k]), k


def test_state_dict_round_trip_keeps_the_configs_and_buffers(tmp_path):
    ens = _ens()
    ens.health = HealthConfig(ema_decay=0.9, dead_threshold=1e-3)
    ens.feature_stats = FeatureStatsConfig(n_buckets=8, hist_lo=2.0 ** -10, hist_ratio=4.0)
    x = _batches(3, seed=5)
    ens.step_batch(torch.from_numpy(x[0]))
    sd = ens.state_dict()
    assert sd["health"] == {"ema_decay": 0.9, "dead_threshold": 1e-3}
    assert sd["feature_stats"] == {"n_buckets": 8, "hist_lo": 2.0 ** -10, "hist_ratio": 4.0}
    ckpt_lib.save_ensemble_checkpoint(tmp_path / "ckpt_0", [(ens, {}, "e")])
    tree = ckpt_lib.restore_ensemble_checkpoint(tmp_path / "ckpt_0")
    backs = [Ensemble.from_state(sd, device="cpu"), Ensemble.from_state(tree["ensembles"]["e"], device="cpu")]
    for back in backs:
        assert back.health == ens.health and back.feature_stats == ens.feature_stats and back.fused is False
        for k in (FIRE_EMA_KEY, *FEATURE_STATS_KEYS):
            assert torch.equal(back.state.buffers[k], ens.state.buffers[k]), k
    le, _ = ens.step_batch(torch.from_numpy(x[1]))
    for back in backs:
        lb, _ = back.step_batch(torch.from_numpy(x[1]))
        for k in le:
            assert torch.equal(lb[k], le[k]), k
        assert torch.equal(back.state.buffers[FIRE_EMA_KEY], ens.state.buffers[FIRE_EMA_KEY])
    plain = build_ensemble(FunctionalTiedSAE, 0, L1, activation_size=D, n_dict_components=N, device="cpu")
    assert plain.state_dict()["health"] is None and Ensemble.from_state(plain.state_dict(), device="cpu").health is None
