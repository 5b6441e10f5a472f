"""The port's compressed-moment Adam (`utils.optim.adam` with int8 / bf16
moments) against the JAX package's `utils.optim.adam` on the same stacked
params and gradients.

The two draw their stochastic stores from different streams (the port's
counter hash; JAX's threefry), so the carried states are held to the JAX
suite's contract, not to bits: unbiased stores (tests/test_optim.py), the
int8 layout (1-D member leaves stay f32), and two steps that track within
the envelope of tests/test_fused_signatures.py::
test_int8_two_step_state_roundtrip — dequantized moments within 4 int8
steps of each other, params with a median difference under lr and none over
50 lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import to_np
from sparse_coding__tpu.utils import optim as jax_optim
from sparse_coding__tpu_torch.utils import optim

M, N, D = 2, 64, 32
LR = 1e-3


def test_stochastic_round_is_unbiased_and_passes_nonfinite_through():
    x = torch.full((50_000,), 1.00123)
    r = optim.stochastic_round(x, optim.uniform_bits(1, 50_000, 1234)[0])
    assert set(np.unique(to_np(r.float()))) <= {1.0, 1.0078125}
    assert abs(float(r.float().mean()) - 1.00123) < 2e-4
    bad = torch.tensor([np.inf, -np.inf, np.nan])
    rb = optim.stochastic_round(bad, optim.uniform_bits(1, 3, 5)[0]).float()
    assert rb[0] == np.inf and rb[1] == -np.inf and torch.isnan(rb[2])


def test_int8_store_is_unbiased():
    """Per element, E[q · scale] = x: the mean over 256 independent stores
    stays within 4 sigma of x everywhere it matters (the row's step / 16)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32))
    stores = [optim.quantize_rows_stochastic(x, optim.uniform_bits(4, 64, s)).dequant() for s in range(256)]
    mean = torch.stack(stores).mean(0)
    step = x.abs().amax(-1, keepdim=True) / 127
    assert float(((mean - x) / step).abs().max()) < 4 * 0.5 / 16


def _params():
    rng = np.random.default_rng(0)
    return {
        "encoder": (0.1 * rng.standard_normal((M, N, D))).astype(np.float32),
        "encoder_bias": (0.01 * rng.standard_normal((M, N))).astype(np.float32),
    }


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {
        "encoder": (1e-2 * rng.standard_normal((M, N, D))).astype(np.float32),
        "encoder_bias": (1e-3 * rng.standard_normal((M, N))).astype(np.float32),
    }


@pytest.mark.parametrize("kw", [dict(mu_dtype="int8", nu_dtype="bfloat16"), dict(mu_dtype="int8", nu_dtype="int8"),
                                dict(nu_dtype="bfloat16")])
def test_compressed_layout_matches_jax_vmapped_init(kw):
    """A leaf whose member is 2-D is quantized; the stacked bias [M, N] (a
    1-D member leaf) stays f32 for int8, and bf16 nu covers every leaf."""
    j = jax.vmap(jax_optim.adam(LR, **kw).init)({k: jnp.asarray(v) for k, v in _params().items()})[0]
    t = optim.adam(LR, **kw).init({k: torch.from_numpy(v) for k, v in _params().items()})
    for mom_j, mom_t in ((j.mu, t.mu), (j.nu, t.nu)):
        for k in ("encoder", "encoder_bias"):
            assert isinstance(mom_t[k], optim.QuantMoment) == isinstance(mom_j[k], jax_optim.QuantMoment), k
            if isinstance(mom_t[k], optim.QuantMoment):
                assert mom_t[k].q.dtype == torch.int8 and mom_t[k].scale.shape == (M, N)
                np.testing.assert_array_equal(to_np(mom_t[k].scale), np.asarray(mom_j[k].scale))
            else:
                assert str(mom_t[k].dtype).split(".")[-1] == np.asarray(mom_j[k]).dtype.name, k


@pytest.mark.parametrize("nu_dtype", ["bfloat16", "int8"])
def test_int8_mu_two_steps_track_jax(nu_dtype):
    params = _params()
    tx = jax_optim.adam(LR, mu_dtype="int8", nu_dtype=nu_dtype)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = jax.vmap(tx.init)(j_params)
    opt = optim.adam(LR, mu_dtype="int8", nu_dtype=nu_dtype)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_state = opt.init(t_params)
    for step in range(2):
        g = _grads(10 + step)
        j_upd, j_state = jax.vmap(tx.update)({k: jnp.asarray(v) for k, v in g.items()}, j_state, j_params)
        j_params = optax.apply_updates(j_params, j_upd)
        t_upd, t_state = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, t_state, t_params)
        t_params = optim.apply_updates(t_params, t_upd)
    np.testing.assert_array_equal(to_np(t_state.count), [2, 2])
    for k in params:
        diff = np.abs(to_np(t_params[k]) - np.asarray(j_params[k]))
        assert np.median(diff) < LR and diff.max() < 50 * LR, k
    for mom_j, mom_t in ((j_state[0].mu, t_state.mu), (j_state[0].nu, t_state.nu)):
        a = mom_t["encoder"]
        b = mom_j["encoder"]
        dq_a = to_np(optim.dequant(a))
        dq_b = np.asarray(b.dequant() if isinstance(b, jax_optim.QuantMoment) else b, np.float32)
        atol = 1.5 * float(np.abs(to_np(a.scale)).max()) if isinstance(a, optim.QuantMoment) else 0.0
        assert np.abs(dq_a - dq_b).max() < 4 * atol + 1e-3


def test_compressed_adam_is_deterministic_given_its_seed():
    g = {k: torch.from_numpy(v) for k, v in _grads(3).items()}
    p = {k: torch.from_numpy(v) for k, v in _params().items()}
    outs = []
    for seed in (0, 0, 1):
        opt = optim.adam(LR, mu_dtype="int8", nu_dtype="bfloat16", seed=seed)
        outs.append(opt.update(g, opt.init(p), p)[1])
    assert torch.equal(outs[0].mu["encoder"].q, outs[1].mu["encoder"].q)
    assert not torch.equal(outs[0].mu["encoder"].q, outs[2].mu["encoder"].q)
