"""The port's evaluation metrics against the JAX package's on the same
dictionaries and batch (f32: FVU and MMCS to rtol 1e-5, the matmuls summing
in another order; L0 to one code entry in the batch, where an entry within
f32 noise of the relu's zero may flip)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding__tpu.metrics import standard as jm
from sparse_coding__tpu.models.learned_dict import TiedSAE as JaxTiedSAE
from sparse_coding__tpu_torch.metrics import standard as tm
from sparse_coding__tpu_torch.models.learned_dict import TiedSAE

D, N, B = 32, 64, 200


def _dicts(seed):
    rng = np.random.default_rng(seed)
    enc = rng.standard_normal((N, D)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(N) - 0.2).astype(np.float32)
    return (
        JaxTiedSAE(jnp.asarray(enc), jnp.asarray(bias), norm_encoder=True),
        TiedSAE(torch.from_numpy(enc), torch.from_numpy(bias), norm_encoder=True),
    )


def test_metrics_match_jax():
    (ja, ta), (jb, tb) = _dicts(0), _dicts(1)
    x = np.random.default_rng(2).standard_normal((B, D)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_allclose(float(tm.fraction_variance_unexplained(ta, tx)),
                               float(jm.fraction_variance_unexplained(ja, jx)), rtol=1e-5)
    assert abs(float(tm.sparsity_l0(ta, tx)) - float(jm.sparsity_l0(ja, jx))) <= 1.0 / B
    np.testing.assert_allclose(float(tm.mmcs(ta, tb)), float(jm.mmcs(ja, jb)), rtol=1e-5)
    truth = np.random.default_rng(3).standard_normal((16, D)).astype(np.float32)
    truth /= np.linalg.norm(truth, axis=-1, keepdims=True)
    np.testing.assert_allclose(float(tm.mmcs_to_fixed(ta, torch.from_numpy(truth))),
                               float(jm.mmcs_to_fixed(ja, jnp.asarray(truth))), rtol=1e-5)
    got = tm.evaluate_dicts([ta, tb], tx)
    ref = jm.evaluate_dicts([ja, jb], jx)
    for g, r in zip(got, ref):
        assert set(g) == set(r) == {"fvu", "l0", "r2"}
        np.testing.assert_allclose(g["fvu"], r["fvu"], rtol=1e-5)
        np.testing.assert_allclose(g["r2"], r["r2"], rtol=1e-5)
        assert abs(g["l0"] - r["l0"]) <= 1.0 / B


def test_unported_options_raise():
    """What the port still lacks raises; ``correlated=True`` and ``"sgd"``,
    which raised here until the sweep slice ported them, now build."""
    from sparse_coding__tpu_torch import FunctionalTiedSAE, build_ensemble
    from sparse_coding__tpu_torch.data.synthetic import RandomDatasetGenerator

    kw = dict(activation_size=32, n_dict_components=64, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": 1e-3}], optimizer_kwargs={"mu_dtype": "float16"}, **kw)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": 1e-3}], optimizer="lion", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": 1e-3}], optimizer="sgd",
                       optimizer_kwargs={"learning_rate": 0.05, "momentum": 0.9}, **kw)
    assert torch.isfinite(next(RandomDatasetGenerator(32, 64, 16, 4, 0.99, True, key=0, device="cpu"))).all()
    ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": 1e-3}], optimizer="sgd", **kw)
    loss, _ = ens.step_batch(torch.randn(16, 32, generator=torch.Generator().manual_seed(0)))
    assert torch.isfinite(loss["loss"]).all()


def test_random_generator_is_seeded_and_planted():
    from sparse_coding__tpu_torch.data.synthetic import RandomDatasetGenerator

    a = RandomDatasetGenerator(32, 64, 16, 4, 0.99, False, key=5, device="cpu")
    b = RandomDatasetGenerator(32, 64, 16, 4, 0.99, False, key=5, device="cpu")
    xa, xb = next(a), next(b)
    assert xa.shape == (16, 32) and xa.dtype == torch.float32
    assert torch.equal(xa, xb) and not torch.equal(xa, next(a))
    torch.testing.assert_close(a.feats.norm(dim=-1), torch.ones(64))
