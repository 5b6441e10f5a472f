"""The port's Adam (`sparse_coding__tpu_torch.utils.optim`) against optax.adam
on the same stacked params and gradients. The port writes out optax's
expressions term for term, so states and updates are held bit-equal (f32 and
bf16 mu); the update values, which pass through a sqrt and two divisions,
to one f32 ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import jax_to_torch, to_np
from sparse_coding__tpu_torch.utils import optim

M, N, D = 2, 64, 32


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {
        "encoder": (1e-2 * rng.standard_normal((M, N, D))).astype(np.float32),
        "encoder_bias": (1e-3 * rng.standard_normal((M, N))).astype(np.float32),
    }


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_adam_matches_optax(mu_dtype):
    params = _grads(0)
    tx = optax.adam(1e-3, mu_dtype=None if mu_dtype is None else jnp.bfloat16)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = jax.vmap(tx.init)(j_params)
    opt = optim.adam(1e-3, mu_dtype=mu_dtype)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_state = opt.init(t_params)
    for step in range(4):
        g = _grads(10 + step)
        j_upd, j_state = jax.vmap(tx.update)({k: jnp.asarray(v) for k, v in g.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, j_upd)
        t_upd, t_state = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, t_state, t_params)
        t_params = optim.apply_updates(t_params, t_upd)
        np.testing.assert_array_equal(to_np(t_state.count), np.asarray(j_state[0].count))
        for k in params:
            assert t_state.mu[k].dtype == jax_to_torch(j_state[0].mu[k]).dtype
            np.testing.assert_array_equal(to_np(t_state.mu[k]), to_np(j_state[0].mu[k]), err_msg=k)
            np.testing.assert_array_equal(to_np(t_state.nu[k]), to_np(j_state[0].nu[k]), err_msg=k)
            np.testing.assert_allclose(to_np(t_upd[k]), to_np(j_upd[k]), rtol=2.4e-7, atol=0, err_msg=k)
            # p + u: one ulp of the update (~1e-6 lr) where the updates differ by one
            np.testing.assert_allclose(to_np(t_params[k]), to_np(j_params[k]), rtol=2.4e-7, atol=1e-9)


def test_bf16_mu_update_formula_matches_optax_exactly():
    """optax rounds b1 to bf16 and forms b1 * mu in bf16 before the f32 add
    (weak typing); torch would multiply by the unrounded scalar. The port's
    `decayed_moment` mirrors optax bit for bit."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal(4096).astype(np.float32)
    mu = jnp.asarray(rng.standard_normal(4096)).astype(jnp.bfloat16)
    optax_mu = (1 - 0.9) * jnp.asarray(g) + 0.9 * mu
    t_mu = jax_to_torch(mu)
    port_mu = optim.f32(1 - 0.9, t_mu) * torch.from_numpy(g) + optim.decayed_moment(0.9, t_mu)
    assert port_mu.dtype == torch.float32
    np.testing.assert_array_equal(to_np(port_mu), np.asarray(optax_mu))
    naive = 0.9 * t_mu.float() + optim.f32(1 - 0.9, t_mu) * torch.from_numpy(g)
    assert not np.array_equal(to_np(naive), np.asarray(optax_mu))


@pytest.mark.parametrize("kw", [{"nu_dtype": "float16"}, {"mu_dtype": "uint8"}, {"nu_dtype": "float64"}])
def test_compressed_moment_storage_is_not_ported(kw):
    """Storage outside the tiers raises ValueError: nu outside the JAX
    package's (f32, bf16, int8), as its `scale_by_adam_compressed` refuses
    it; mu outside optax's float storage and the JAX package's int8."""
    with pytest.raises(ValueError, match="must be None/float32/bfloat16"):
        optim.adam(1e-3, **kw)


def test_adam_fp16_mu_matches_optax():
    """``mu_dtype=float16``: the JAX package returns literal
    ``optax.adam(mu_dtype=float16)``. The moment is formed in f32 (b1 rounded
    to fp16, ``b1 * mu`` an fp16 product), the update reads the unrounded
    value, and the carried moment is cast to fp16: bit-equal moments, params
    within one f32 ulp."""
    params = _grads(0)
    tx = optax.adam(1e-3, mu_dtype=jnp.float16)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = jax.vmap(tx.init)(j_params)
    opt = optim.adam(1e-3, mu_dtype="float16")
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_state = opt.init(t_params)
    for step in range(20):
        g = _grads(10 + step)
        j_upd, j_state = jax.vmap(tx.update)({k: jnp.asarray(v) for k, v in g.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, j_upd)
        t_upd, t_state = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, t_state, t_params)
        t_params = optim.apply_updates(t_params, t_upd)
        np.testing.assert_array_equal(to_np(t_state.count), np.asarray(j_state[0].count))
        for k in params:
            assert t_state.mu[k].dtype == torch.float16 and j_state[0].mu[k].dtype == jnp.float16
            np.testing.assert_array_equal(to_np(t_state.mu[k]), np.asarray(j_state[0].mu[k]), err_msg=k)
            np.testing.assert_array_equal(to_np(t_state.nu[k]), np.asarray(j_state[0].nu[k]), err_msg=k)
            np.testing.assert_allclose(to_np(t_params[k]), np.asarray(j_params[k]), rtol=2.4e-7, atol=1e-9)


def _optax_sgd(schedule, momentum, nesterov, acc):
    lr = optax.linear_schedule(0.0, 0.05, 5) if schedule else 0.05
    return optax.sgd(lr, momentum=momentum, nesterov=nesterov,
                     accumulator_dtype=None if acc is None else jnp.dtype(acc))


def _port_sgd(schedule, momentum, nesterov, acc):
    lr = optim.linear_schedule(0.0, 0.05, 5) if schedule else 0.05
    return optim.sgd(lr, momentum=momentum, nesterov=nesterov, accumulator_dtype=acc)


@pytest.mark.parametrize("schedule", [False, True], ids=["constant", "schedule"])
@pytest.mark.parametrize("acc", [None, "bfloat16"], ids=["acc_params", "acc_bf16"])
@pytest.mark.parametrize("nesterov", [False, True], ids=["heavy_ball", "nesterov"])
def test_sgd_momentum_matches_optax(nesterov, acc, schedule):
    """``optax.sgd(lr, momentum=0.9, nesterov, accumulator_dtype)`` = trace →
    rate. Over 20 steps of the same gradients the trace is bit-equal (its
    dtype too: bf16 when asked, else the params' f32) and the params within
    one f32 ulp."""
    params = _grads(0)
    tx = _optax_sgd(schedule, 0.9, nesterov, acc)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = jax.vmap(tx.init)(j_params)
    opt = _port_sgd(schedule, 0.9, nesterov, acc)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_state = opt.init(t_params)
    for step in range(20):
        g = _grads(10 + step)
        j_upd, j_state = jax.vmap(tx.update)({k: jnp.asarray(v) for k, v in g.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, j_upd)
        t_upd, t_state = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, t_state, t_params)
        t_params = optim.apply_updates(t_params, t_upd)
        np.testing.assert_array_equal(to_np(t_state.count), np.full(M, step + 1))
        for k in params:
            j_trace = j_state[0].trace[k]
            assert t_state.trace[k].dtype == jax_to_torch(j_trace).dtype
            np.testing.assert_array_equal(to_np(t_state.trace[k]), to_np(j_trace), err_msg=k)
            np.testing.assert_allclose(to_np(t_upd[k]), np.asarray(j_upd[k]), rtol=2.4e-7, atol=0, err_msg=k)
            np.testing.assert_allclose(to_np(t_params[k]), np.asarray(j_params[k]), rtol=2.4e-7, atol=1e-9)


def test_sgd_nesterov_without_momentum_is_ignored():
    """optax 0.2.6's ``sgd(momentum=None, nesterov=True)`` is ``identity()``
    then the rate: no trace, plain ``-lr · g``; the port's likewise."""
    params = _grads(0)
    tx = optax.sgd(0.05, nesterov=True)
    j_state = jax.vmap(tx.init)({k: jnp.asarray(v) for k, v in params.items()})
    assert jax.tree.leaves(j_state) == []
    opt = optim.sgd(0.05, nesterov=True)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_state = opt.init(t_params)
    assert t_state.trace is None
    g = _grads(3)
    j_upd, _ = jax.vmap(tx.update)({k: jnp.asarray(v) for k, v in g.items()}, j_state)
    t_upd, t_state = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, t_state)
    assert t_state.trace is None
    for k in params:
        np.testing.assert_array_equal(to_np(t_upd[k]), np.asarray(j_upd[k]), err_msg=k)
