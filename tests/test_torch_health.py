"""The port's health pack against the JAX package's, on the CPU.

The same numpy params, gradients, losses and codes go through the JAX
`health_pack` (vmapped over the members, as the JAX step runs it) and the
port's stacked one. Tolerances, and why:
  - ``health_grad_norm`` and ``health_dict_norm``: rtol 1e-6 (f32 sums of
    squares in another order);
  - ``health_nonfinite`` and ``health_dead_frac``: exact (counts);
  - the firing EMA: rtol 1e-6 (``decay ** (step + 1)`` on the device may
    differ from XLA's ``pow`` by an ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding__tpu_torch.telemetry import health as th

M, D, N, B = 3, 24, 48, 32


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {"encoder": rng.standard_normal((M, N, D)).astype(np.float32),
              "encoder_bias": rng.standard_normal((M, N)).astype(np.float32)}
    grads = {k: (1e-2 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in params.items()}
    loss = rng.uniform(0.5, 2.0, M).astype(np.float32)
    loss[1] = np.nan  # a member whose loss went non-finite
    c = np.maximum(rng.standard_normal((M, B, N)), 0.0).astype(np.float32)
    c[:, :, :5] = 0.0  # features that never fire
    c[2] = 0.0  # a member whose codes are all zero
    return params, grads, loss, c


def _jax_pack(params, grads, loss, c, ema, step, cfg):
    from sparse_coding__tpu.telemetry.health import HealthConfig, health_pack

    jcfg = HealthConfig(ema_decay=cfg.ema_decay, dead_threshold=cfg.dead_threshold)

    def one(p, g, l, cm, e):
        return health_pack(p, g, l, {"c": cm}, e, jnp.asarray(step, jnp.int32), jcfg)

    out = jax.vmap(one)(params, grads, jnp.asarray(loss), jnp.asarray(c), jnp.asarray(ema))
    return jax.device_get(out)


def _port_pack(params, grads, loss, c, ema, step, cfg):
    t = {k: torch.from_numpy(v) for k, v in params.items()}
    g = {k: torch.from_numpy(v) for k, v in grads.items()}
    aux = {} if c is None else {"c": torch.from_numpy(c)}
    metrics, new = th.health_pack(t, g, torch.from_numpy(loss), aux, torch.from_numpy(ema),
                                  torch.tensor(step, dtype=torch.int32), cfg)
    return {k: v.numpy() for k, v in metrics.items()}, new.numpy()


def _close(got, ref):
    np.testing.assert_allclose(got["health_grad_norm"], ref["health_grad_norm"], rtol=1e-6)
    np.testing.assert_allclose(got["health_dict_norm"], ref["health_dict_norm"], rtol=1e-6)
    np.testing.assert_array_equal(got["health_nonfinite"], ref["health_nonfinite"])
    np.testing.assert_array_equal(got["health_dead_frac"], ref["health_dead_frac"])


@pytest.mark.parametrize("dict_key", ["encoder", "decoder"])
def test_health_pack_matches_jax(dict_key):
    """One step of the pack, a NaN loss and an all-zero member among the
    three; with a ``decoder`` present, its rows are the dictionary's."""
    params, grads, loss, c = _inputs()
    if dict_key == "decoder":
        params["decoder"] = 2.0 * params["encoder"]
        grads["decoder"] = grads["encoder"][::-1].copy()
    ema = np.random.default_rng(1).uniform(0, 0.2, (M, N)).astype(np.float32)
    ema[2] = 0.0  # the all-zero member has never fired
    cfg = th.HealthConfig()
    (ref_m, ref_ema) = _jax_pack(params, grads, loss, c, ema, 4, cfg)
    got_m, got_ema = _port_pack(params, grads, loss, c, ema, 4, cfg)
    assert sorted(got_m) == sorted(ref_m)
    _close(got_m, ref_m)
    np.testing.assert_allclose(got_ema, ref_ema, rtol=1e-6)
    assert got_m["health_nonfinite"].tolist() == [0.0, 1.0, 0.0]
    assert got_m["health_dead_frac"][2] == 1.0


def test_health_ema_over_five_steps_matches_jax():
    """The EMA carried over 5 steps with the bias correction from the step
    counter, and a dead threshold that some features cross."""
    cfg = th.HealthConfig(ema_decay=0.9, dead_threshold=0.05)
    ema_j = ema_t = th.init_fire_ema(M, N).numpy()
    for step in range(5):
        params, grads, loss, c = _inputs(seed=10 + step)
        c[0, :, 5:12] = 0.0  # seven more features never fire in member 0
        ref_m, ema_j = _jax_pack(params, grads, loss, c, ema_j, step, cfg)
        got_m, ema_t = _port_pack(params, grads, loss, c, ema_t, step, cfg)
        _close(got_m, ref_m)
        np.testing.assert_allclose(ema_t, ema_j, rtol=1e-6)
    assert np.rint(got_m["health_dead_frac"] * N).tolist() == [12, 5, N]


def test_no_code_gives_nan_dead_frac_and_keeps_the_ema():
    params, grads, loss, _ = _inputs()
    ema = np.full((M, N), 0.5, np.float32)
    got_m, got_ema = _port_pack(params, grads, loss, None, ema, 0, th.HealthConfig())
    assert np.isnan(got_m["health_dead_frac"]).all()
    np.testing.assert_array_equal(got_ema, ema)


def test_n_feats_of_and_init():
    assert th.n_feats_of({"encoder": torch.zeros(7, 3)}) == 7
    assert th.n_feats_of({"decoder": torch.zeros(5, 3)}) == 5
    with pytest.raises(ValueError, match="'encoder' or 'decoder'"):
        th.n_feats_of({"dict": torch.zeros(5, 3)})
    assert th.init_fire_ema(2, 4).shape == (2, 4)
