"""The port's training slice against the JAX package, from the same weights.

The JAX ensemble's state is carried across with `interop.state_from_jax_numpy`
and both sides step on the same numpy batches. Tolerances, and why:
  - f32 (autograd path): losses rtol 1e-5; params within 1e-2 lr per step —
    Adam maps gradient noise near |g| ~ eps to updates bounded by lr;
  - bf16 fused path: losses rtol 1e-3 (bf16 roundings of c, dxh and dc may
    flip at ties); params within 2 lr per step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import to_np
from sparse_coding__tpu import build_ensemble as jax_build_ensemble
from sparse_coding__tpu.ensemble import _mask_updates
from sparse_coding__tpu.models import FunctionalTiedSAE as JaxTiedSAE
from sparse_coding__tpu_torch import FunctionalTiedSAE, build_ensemble
from sparse_coding__tpu_torch.interop import state_from_jax_numpy
from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk

LR = 1e-3
L1 = [{"l1_alpha": 1e-3}, {"l1_alpha": 3e-3}]


def _carry(jax_params, jax_buffers, jax_opt_state=None, step=0):
    """A JAX ensemble state (device_get'd) as the port's EnsembleState."""
    opt = None
    if jax_opt_state is not None:
        a = jax_opt_state[0]
        opt = {"count": np.asarray(a.count), "mu": dict(a.mu), "nu": dict(a.nu)}
    return state_from_jax_numpy(jax_params, jax_buffers, opt, step=step, device="cpu")


def _batches(seed, k, b, d):
    return np.random.default_rng(seed).standard_normal((k, b, d)).astype(np.float32)


def test_f32_slice_matches_jax_ensemble():
    D, N, B = 32, 64, 64
    jens = jax_build_ensemble(
        JaxTiedSAE, jax.random.PRNGKey(0), L1, optimizer_kwargs={"learning_rate": LR},
        activation_size=D, n_dict_components=N,
    )
    assert not jens.fused
    st = jax.device_get(jens.state)
    ens = build_ensemble(FunctionalTiedSAE, 0, L1, optimizer_kwargs={"learning_rate": LR},
                         activation_size=D, n_dict_components=N, device="cpu")
    assert not ens.fused
    ens.state = _carry(st.params, st.buffers, st.opt_state)
    xs = _batches(1, 7, B, D)
    for i in range(3):
        jl, _ = jens.step_batch(jnp.asarray(xs[i]))
        tl, _ = ens.step_batch(torch.from_numpy(xs[i]))
        for k in ("loss", "l_reconstruction", "l_l1"):
            np.testing.assert_allclose(to_np(tl[k]), np.asarray(jl[k]), rtol=1e-5, err_msg=k)
    jl = jens.step_scan(jnp.asarray(xs[3:]))
    tl = ens.step_scan(torch.from_numpy(xs[3:]))
    for k in ("loss", "l_reconstruction", "l_l1"):
        assert tl[k].shape == (4, 2)
        np.testing.assert_allclose(to_np(tl[k]), np.asarray(jl[k]), rtol=1e-5, err_msg=k)
    jp = jax.device_get(jens.state.params)
    for k in ("encoder", "encoder_bias"):
        assert np.abs(to_np(ens.state.params[k]) - np.asarray(jp[k])).max() <= 1e-2 * LR * 7, k
    assert ens.state.step == 7 and int(jens.state.step) == 7
    np.testing.assert_array_equal(to_np(ens.state.opt_state.count), [7, 7])


def _jax_stacked(D, N, seed=0):
    models = [
        JaxTiedSAE.init(k, D, N, l1_alpha=a["l1_alpha"], bias_decay=1e-4)
        for k, a in zip(jax.random.split(jax.random.PRNGKey(seed), len(L1)), L1)
    ]
    from sparse_coding__tpu.ensemble import stack_pytrees

    params = stack_pytrees([p for p, _ in models])
    buffers = stack_pytrees([b for _, b in models])
    return params, buffers


def _port_ensemble(params, buffers, opt_state, D, N, **kw):
    ens = build_ensemble(
        FunctionalTiedSAE, 0, [dict(a, bias_decay=1e-4) for a in L1],
        optimizer_kwargs={"learning_rate": LR, "mu_dtype": "bfloat16"},
        compute_dtype="bfloat16", activation_size=D, n_dict_components=N, device="cpu", **kw,
    )
    ens.state = _carry(jax.device_get(params), jax.device_get(buffers), jax.device_get(opt_state))
    return ens


def test_bf16_fused_slice_matches_chained_jax_fused_adam_step():
    D, N, B = 128, 512, 256
    params, buffers = _jax_stacked(D, N)
    tx = optax.adam(LR, mu_dtype=jnp.bfloat16)
    opt_state = jax.vmap(tx.init)(params)
    ens = _port_ensemble(params, buffers, opt_state, D, N)
    assert ens.fused and ens.fused_adam == {"lr": LR, "b1": 0.9, "b2": 0.999, "eps": 1e-8}
    xs = _batches(2, 3, B, D)
    for i in range(3):
        params, opt_state, jl = JaxTiedSAE.fused_adam_step(
            params, buffers, jnp.asarray(xs[i]), opt_state, LR, 0.9, 0.999, 1e-8, interpret=True
        )
        tl, aux = ens.step_batch(torch.from_numpy(xs[i]))
        assert aux == {}
        for k in ("loss", "l_reconstruction", "l_l1"):
            np.testing.assert_allclose(to_np(tl[k]), np.asarray(jl[k]), rtol=1e-3, err_msg=k)
        for k in ("encoder", "encoder_bias"):
            diff = np.abs(to_np(ens.state.params[k]) - np.asarray(params[k])).max()
            assert diff <= 2 * LR * (i + 1), (k, i, diff)
    assert ens.state.opt_state.mu["encoder"].dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(ens.state.opt_state.count), np.asarray(opt_state[0].count))


def test_masked_slice_takes_fused_grads_and_freezes_the_member():
    D, N, B = 128, 512, 256
    params, buffers = _jax_stacked(D, N, seed=1)
    tx = optax.adam(LR, mu_dtype=jnp.bfloat16)
    opt_state = jax.vmap(tx.init)(params)
    ens = _port_ensemble(params, buffers, opt_state, D, N)
    ens.set_update_mask([1.0, 0.0])
    frozen = ens.state.params["encoder"][1].clone()
    mask = jnp.asarray([1.0, 0.0])
    xs = _batches(3, 2, B, D)
    tk.reset_launches()
    for i in range(2):
        grads, jl = JaxTiedSAE.fused_grads_stacked(params, buffers, jnp.asarray(xs[i]), interpret=True)
        upd, opt_state = jax.vmap(tx.update)(grads, opt_state, params)
        params = optax.apply_updates(params, _mask_updates(upd, mask))
        tl, _ = ens.step_batch(torch.from_numpy(xs[i]))
        for k in ("loss", "l_reconstruction", "l_l1"):
            np.testing.assert_allclose(to_np(tl[k]), np.asarray(jl[k]), rtol=1e-3, err_msg=k)
        for k in ("encoder", "encoder_bias"):
            diff = np.abs(to_np(ens.state.params[k]) - np.asarray(params[k])).max()
            assert diff <= 2 * LR * (i + 1), (k, i, diff)
    assert torch.equal(ens.state.params["encoder"][1], frozen)
    assert sum(tk.LAUNCHES.values()) == 0  # CPU tensors: the plain versions ran


def test_unknown_adam_kwarg_refuses_the_fused_adam_kernel_once():
    kw = dict(optimizer_kwargs={"learning_rate": LR, "eps_root": 1e-8}, compute_dtype="bfloat16",
              activation_size=128, n_dict_components=512, device="cpu")
    with pytest.warns(UserWarning, match="fused-Adam kernel refused"):
        ens = build_ensemble(FunctionalTiedSAE, 0, L1, **kw)
    assert ens.fused and ens.fused_adam is None
    x = torch.from_numpy(_batches(4, 1, 256, 128)[0])
    loss, _ = ens.step_batch(x)
    assert torch.isfinite(loss["loss"]).all()


def test_l1_warmup_scales_the_observed_l1_term():
    kw = dict(optimizer_kwargs={"learning_rate": 0.0}, activation_size=32, n_dict_components=64,
              device="cpu")
    x = torch.from_numpy(_batches(5, 1, 64, 32)[0])
    ctrl = build_ensemble(FunctionalTiedSAE, 0, L1, **kw)
    warm = build_ensemble(FunctionalTiedSAE, 0, L1, l1_warmup_steps=4, **kw)
    for k in range(5):
        lc, _ = ctrl.step_batch(x)
        lw, _ = warm.step_batch(x)
        np.testing.assert_allclose(to_np(lw["l_l1"]), min((k + 1) / 4, 1.0) * to_np(lc["l_l1"]), rtol=1e-6)


def test_state_dict_round_trip_steps_identically():
    kw = dict(optimizer_kwargs={"learning_rate": LR, "mu_dtype": "bfloat16"}, compute_dtype="bfloat16",
              activation_size=128, n_dict_components=512, device="cpu")
    a = build_ensemble(FunctionalTiedSAE, 0, L1, **kw)
    xs = torch.from_numpy(_batches(6, 2, 256, 128))
    a.step_batch(xs[0])
    b = type(a).from_state(a.state_dict(), device="cpu")
    assert (b.fused, b.fused_adam, b.state.step) == (a.fused, a.fused_adam, 1)
    la, _ = a.step_batch(xs[1])
    lb, _ = b.step_batch(xs[1])
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    for k in a.state.params:
        assert torch.equal(a.state.params[k], b.state.params[k]), k
