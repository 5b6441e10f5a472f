"""The port's toy-model replication (`train/toy_models.py`) against the JAX
package's, on the CPU, at the JAX tests' sizes (d 16 / 8, a few dozen
ground-truth features).

Both packages' RNG streams differ, so parity runs from the same point: the
JAX ensemble's initial state is carried across (`interop.state_from_jax_numpy`
through the driver module's `build_ensemble`), and both packages' drivers
read the same batches, drawn by the JAX package's `RandomDatasetGenerator`
and replayed to each (with the JAX generator's planted dictionary as
``feats``).

Tolerances:
  - `ToySAE` loss terms and gradients: rtol 1e-5 (atol 1e-7);
  - `run_single_go` / `run_toy_grid` from JAX's init and batches: MMCS
    within 1e-5, dead-neuron counts equal;
  - the port's own init: the glorot bound (every entry within it, the
    uniform variance within 10%), orthonormal decoder columns (n_dict > d)
    or rows (n_dict < d) within 1e-5, a zero bias; its noise: mean within
    3 standard errors of 0, standard deviation within 2% of the level.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding__tpu import build_ensemble as jax_build
from sparse_coding__tpu.data.synthetic import RandomDatasetGenerator as JaxGenerator
from sparse_coding__tpu.train import toy_models as jtoy
from sparse_coding__tpu.utils.config import ToyArgs as JaxToyArgs
from sparse_coding__tpu_torch import build_ensemble
from sparse_coding__tpu_torch.ensemble import Ensemble
from sparse_coding__tpu_torch.interop import state_from_jax_numpy
from sparse_coding__tpu_torch.train import toy_models as ttoy
from sparse_coding__tpu_torch.utils.config import ToyArgs

SINGLE = dict(activation_dim=16, n_ground_truth_components=32, batch_size=256, feature_num_nonzero=4,
              feature_prob_decay=0.99, epochs=40, n_components_dictionary=32, l1_alpha=3e-4, lr=3e-3)
GRID = dict(activation_dim=8, n_ground_truth_components=16, batch_size=128, feature_num_nonzero=3,
            feature_prob_decay=0.99, epochs=20, l1_exp_low=-8, l1_exp_high=-6, dict_ratio_exp_low=0,
            dict_ratio_exp_high=2)


class Replay:
    """A generator that yields recorded batches (as ``wrap`` makes them) and
    carries the planted dictionary."""

    def __init__(self, batches, feats, wrap):
        self._it = iter([wrap(np.array(b)) for b in batches])
        self.feats = wrap(np.array(feats))

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)


def _jax_batches(cfg, n, seed=None):
    gen = JaxGenerator(cfg.activation_dim, cfg.n_ground_truth_components, cfg.batch_size, cfg.feature_num_nonzero,
                       cfg.feature_prob_decay, cfg.correlated_components,
                       key=jax.random.PRNGKey(cfg.seed if seed is None else seed))
    return [np.asarray(next(gen)) for _ in range(n)], np.asarray(gen.feats)


def _from_jax_init(monkeypatch):
    """The port driver's `build_ensemble` starting from the state the JAX
    package builds from the same seed."""

    def build(sig, key, hparams, optimizer_kwargs=None, device=None, **common):
        jens = jax_build(jtoy.ToySAE, jax.random.PRNGKey(key), hparams, optimizer_kwargs=optimizer_kwargs, **common)
        st = jax.device_get(jens.state)
        ens = build_ensemble(sig, key, hparams, optimizer_kwargs=optimizer_kwargs, device=device, **common)
        ens.state = state_from_jax_numpy(st.params, st.buffers, device=device)
        return ens

    monkeypatch.setattr(ttoy, "build_ensemble", build)


def _stacked(sig, init, n_dict, d, l1s, gen):
    members = [init(gen, d, n_dict, a) for a in l1s]
    return ({k: torch.stack([p[k] for p, _ in members]) for k in members[0][0]},
            {k: torch.stack([b[k] for _, b in members]) for k in members[0][1]})


def test_toy_sae_loss_and_grads_match_jax():
    gen = torch.Generator().manual_seed(0)
    params, buffers = _stacked(ttoy.ToySAE, ttoy.ToySAE.init, 24, 16, [1e-3, 3e-2], gen)
    batch = torch.from_numpy(np.random.default_rng(1).normal(size=(64, 16)).astype(np.float32))
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    total, (data, aux) = ttoy.ToySAE.loss(leaves, buffers, batch)
    grads = torch.autograd.grad(total.sum(), list(leaves.values()))
    for m in range(2):
        jp = {k: jnp.asarray(v[m].numpy()) for k, v in params.items()}
        jb = {k: jnp.asarray(v[m].numpy()) for k, v in buffers.items()}
        (jtotal, (jdata, jaux)), jgrads = jax.value_and_grad(jtoy.ToySAE.loss, has_aux=True)(jp, jb, jnp.asarray(batch.numpy()))
        for k in ("loss", "l_reconstruction", "l_l1"):
            np.testing.assert_allclose(float(data[k][m].detach()), float(jdata[k]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(aux["c"][m].detach().numpy(), np.asarray(jaux["c"]), rtol=1e-5, atol=1e-6)
        for k, g in zip(leaves, grads):
            np.testing.assert_allclose(g[m].numpy(), np.asarray(jgrads[k]), rtol=1e-5, atol=1e-7)


def test_run_single_go_from_jax_init_and_batches_matches_jax(monkeypatch):
    jcfg, tcfg = JaxToyArgs(**SINGLE), ToyArgs(**SINGLE)
    batches, feats = _jax_batches(jcfg, jcfg.epochs + 10)
    jld, jmmcs, jdead = jtoy.run_single_go(jcfg, Replay(batches, feats, jnp.asarray))
    _from_jax_init(monkeypatch)
    tld, tmmcs, tdead = ttoy.run_single_go(tcfg, Replay(batches, feats, torch.from_numpy), device="cpu")
    assert abs(tmmcs - jmmcs) <= 1e-5 and tdead == jdead
    assert 0.0 < tmmcs <= 1.0
    np.testing.assert_allclose(tld.get_learned_dict().numpy(), np.asarray(jld.get_learned_dict()), atol=1e-4)


def test_run_toy_grid_from_jax_init_and_batches_matches_jax(monkeypatch):
    jcfg, tcfg = JaxToyArgs(**GRID), ToyArgs(**GRID)
    n_ratios = GRID["dict_ratio_exp_high"] - GRID["dict_ratio_exp_low"]
    batches, feats = _jax_batches(jcfg, n_ratios * (jcfg.epochs + 3 * 2))
    monkeypatch.setattr(jtoy, "RandomDatasetGenerator", lambda **kw: Replay(batches, feats, jnp.asarray))
    want = jtoy.run_toy_grid(jcfg)
    monkeypatch.setattr(ttoy, "RandomDatasetGenerator", lambda **kw: Replay(batches, feats, torch.from_numpy))
    _from_jax_init(monkeypatch)
    got = ttoy.run_toy_grid(tcfg, device="cpu")
    assert sorted(got) == sorted(want) == ["l1_range", "mmcs", "n_dead", "ratio_range"]
    np.testing.assert_allclose(got["l1_range"], want["l1_range"], rtol=1e-12)
    np.testing.assert_array_equal(got["ratio_range"], want["ratio_range"])
    assert got["mmcs"].shape == (2, 2) and got["n_dead"].dtype == want["n_dead"].dtype
    np.testing.assert_allclose(got["mmcs"], want["mmcs"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["n_dead"], want["n_dead"])


def test_run_toy_grid_stacks_the_l1_row_in_one_ensemble_per_dict_size(monkeypatch):
    built = []
    real = ttoy.build_ensemble

    def spy(sig, key, hparams, **kw):
        built.append((key, [hp["l1_alpha"] for hp in hparams], kw["n_dict_components"]))
        return real(sig, key, hparams, **kw)

    monkeypatch.setattr(ttoy, "build_ensemble", spy)
    cfg = ToyArgs(**{**GRID, "epochs": 2, "l1_exp_high": -5})
    grid = ttoy.run_toy_grid(cfg, device="cpu")
    l1s = [cfg.l1_exp_base**e for e in range(-8, -5)]
    assert built == [(cfg.seed, l1s, 8), (cfg.seed + 1, l1s, 16)]
    assert grid["mmcs"].shape == (3, 2) and np.isfinite(grid["mmcs"]).all()
    assert ((grid["mmcs"] >= -1) & (grid["mmcs"] <= 1)).all()


def test_get_n_dead_neurons_matches_jax():
    from sparse_coding__tpu.models.learned_dict import UntiedSAE as JUntied
    from sparse_coding__tpu_torch.models.learned_dict import UntiedSAE

    rng = np.random.default_rng(2)
    enc, dec = rng.normal(size=(48, 8)).astype(np.float32), rng.normal(size=(48, 8)).astype(np.float32)
    bias = np.where(np.arange(48) % 3 == 0, -50.0, 0.0).astype(np.float32)  # every third feature dead
    batches = [rng.normal(size=(32, 8)).astype(np.float32) for _ in range(4)]
    want = jtoy.get_n_dead_neurons(JUntied(jnp.asarray(enc), jnp.asarray(dec), jnp.asarray(bias)),
                                   Replay(batches, enc, jnp.asarray), n_batches=4)
    got = ttoy.get_n_dead_neurons(UntiedSAE(torch.from_numpy(enc), torch.from_numpy(dec), torch.from_numpy(bias)),
                                  Replay(batches, enc, torch.from_numpy), n_batches=4)
    assert got == want >= 16


@pytest.mark.parametrize("n_dict,d", [(512, 64), (32, 96)])
def test_toy_sae_init_statistics(n_dict, d):
    gen = torch.Generator().manual_seed(3)
    params, buffers = ttoy.ToySAE.init(gen, d, n_dict, 1e-3)
    limit = (6.0 / (n_dict + d)) ** 0.5
    enc = params["encoder"]
    assert enc.shape == (n_dict, d) and float(enc.abs().max()) <= limit
    assert abs(float(enc.var()) / (limit**2 / 3) - 1) < 0.1
    dec = params["decoder"].double()
    gram = dec.T @ dec if n_dict > d else dec @ dec.T
    torch.testing.assert_close(gram, torch.eye(min(n_dict, d), dtype=torch.float64), rtol=0, atol=1e-5)
    assert torch.equal(params["encoder_bias"], torch.zeros(n_dict)) and float(buffers["l1_alpha"]) == pytest.approx(1e-3)


def test_run_single_go_noise_statistics(monkeypatch):
    """With ``noise_level`` the steps see the batch plus Gaussian noise of
    that scale from the port's generator."""
    seen = []
    monkeypatch.setattr(Ensemble, "step_batch", lambda self, b, per_model=False: seen.append(b.clone()))
    cfg = ToyArgs(**{**SINGLE, "epochs": 8, "noise_level": 0.5})
    zeros = Replay([np.zeros((256, 16), np.float32)] * 18, np.eye(32, 16, dtype=np.float32), torch.from_numpy)
    ttoy.run_single_go(cfg, zeros, device="cpu")
    noise = torch.stack(seen)
    assert len(seen) == 8
    assert abs(float(noise.mean())) < 3 * 0.5 / noise.numel() ** 0.5
    assert abs(float(noise.std()) / 0.5 - 1) < 0.02


def test_run_single_go_own_generator_recovers_features():
    """The whole driver on its own generator and init (the JAX test's
    configuration, its bound)."""
    cfg = ToyArgs(**{**SINGLE, "batch_size": 512, "epochs": 300})
    ld, mmcs, n_dead = ttoy.run_single_go(cfg, device="cpu")
    assert 0.5 < mmcs <= 1.0 and 0 <= n_dead <= 32


def test_toy_args_match_jax_field_for_field():
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxToyArgs)]
    tf = [(f.name, f.default) for f in dataclasses.fields(ToyArgs)]
    assert tf == jf
