"""The capacity setting end to end on the CPU: the port's ensemble with
``mu_dtype="int8", nu_dtype="bfloat16"`` and ``SC_RECOMPUTE_CODE=1``
against the JAX package, its checkpoints and its interop.

Both sides' fused steps draw the encoder's stochastic stores from the same
counter hash, so they track closely; the bias leaf's bf16 nu (JAX:
threefry) and Adam's 1/|g| amplification of a flipped int8 code keep the
envelope of tests/test_fused_signatures.py::test_int8_two_step_state_roundtrip:
the bulk of the params within lr a step, none beyond 50 lr; losses rtol 1e-3.
After chained steps the two sides' params (so the rows' absmax) have drifted
apart a little: int8 codes within 4 steps and stored moments equal in >= 75%
of elements (independent streams agree on about half).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_moment_tracks, to_np
from sparse_coding__tpu.ensemble import stack_pytrees
from sparse_coding__tpu.models import FunctionalTiedSAE as JaxTiedSAE
from sparse_coding__tpu.models import TopKEncoderApprox as JaxTopK
from sparse_coding__tpu.utils.optim import QuantMoment as JaxQuantMoment
from sparse_coding__tpu.utils.optim import adam as jax_adam
from sparse_coding__tpu_torch import FunctionalTiedSAE, TopKEncoderApprox, build_ensemble
from sparse_coding__tpu_torch.ensemble import Ensemble
from sparse_coding__tpu_torch.interop import state_from_jax_numpy
from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
from sparse_coding__tpu_torch.utils.optim import QuantMoment

LR = 1e-3
CAPACITY = {"learning_rate": LR, "mu_dtype": "int8", "nu_dtype": "bfloat16"}
L1 = [{"l1_alpha": 1e-3, "bias_decay": 1e-4}, {"l1_alpha": 3e-3, "bias_decay": 1e-4}]
D, N, B = 128, 512, 256


@pytest.fixture
def recompute(monkeypatch):
    monkeypatch.setenv("SC_RECOMPUTE_CODE", "1")


def _carry(params, buffers, opt_state=None, step=0):
    opt = None
    if opt_state is not None:
        a = jax.device_get(opt_state[0])
        opt = {"count": np.asarray(a.count), "mu": dict(a.mu), "nu": dict(a.nu)}
    return state_from_jax_numpy(jax.device_get(params), jax.device_get(buffers), opt, step=step, device="cpu")


def _batches(seed, k, b=B, d=D):
    return np.random.default_rng(seed).standard_normal((k, b, d)).astype(np.float32)


def _jax_tied(seed=0):
    models = [JaxTiedSAE.init(k, D, N, **hp) for k, hp in zip(jax.random.split(jax.random.PRNGKey(seed), 2), L1)]
    params = stack_pytrees([p for p, _ in models])
    params["encoder_bias"] = 0.01 * jax.random.normal(jax.random.PRNGKey(5), (2, N))
    return params, stack_pytrees([b for _, b in models])


def _port_tied(params, buffers, opt_state):
    ens = build_ensemble(FunctionalTiedSAE, 0, L1, optimizer_kwargs=CAPACITY, compute_dtype="bfloat16",
                         activation_size=D, n_dict_components=N, device="cpu")
    ens.state = _carry(params, buffers, opt_state)
    return ens


def _assert_tracks(got, want, before, steps):
    """The port's params against JAX's after ``steps`` steps from ``before``:
    within the envelope, and far closer than the steps moved them (a step
    that left the leaf alone, or drew other bits, is within the envelope)."""
    diff = np.abs(to_np(got) - np.asarray(want))
    moved = np.median(np.abs(np.asarray(want) - np.asarray(before)))
    assert np.median(diff) < LR * steps and diff.max() < 50 * LR, (np.median(diff), diff.max())
    assert moved > 0.5 * LR and np.median(diff) < 0.01 * moved, (np.median(diff), moved)


def test_capacity_ensemble_tracks_chained_jax_fused_steps(recompute):
    params, buffers = _jax_tied()
    opt_state = jax.vmap(jax_adam(**CAPACITY).init)(params)
    ens = _port_tied(params, buffers, opt_state)
    assert ens.fused and ens.fused_adam["recompute_code"] is True
    assert isinstance(ens.state.opt_state.mu["encoder"], QuantMoment)
    xs = _batches(1, 3)
    start = {k: np.asarray(params[k]) for k in ("encoder", "encoder_bias")}
    for i in range(3):
        params, opt_state, jl = JaxTiedSAE.fused_adam_step(
            params, buffers, jnp.asarray(xs[i]), opt_state, LR, 0.9, 0.999, 1e-8,
            interpret=True, recompute_code=True,
        )
        tl, aux = ens.step_batch(torch.from_numpy(xs[i]))
        assert aux == {}
        for k in ("loss", "l_reconstruction", "l_l1"):
            np.testing.assert_allclose(to_np(tl[k]), np.asarray(jl[k]), rtol=1e-3, err_msg=k)
        for k in ("encoder", "encoder_bias"):
            _assert_tracks(ens.state.params[k], params[k], start[k], i + 1)
    st = ens.state.opt_state
    assert st.mu["encoder"].q.dtype == torch.int8 and st.nu["encoder"].dtype == torch.bfloat16
    assert st.mu["encoder_bias"].dtype == torch.float32 and st.nu["encoder_bias"].dtype == torch.bfloat16
    assert_moment_tracks(st.mu["encoder"], opt_state[0].mu["encoder"], "mu", min_equal=0.75, scale_rtol=1e-2, max_code_diff=4)
    assert_moment_tracks(st.nu["encoder"], opt_state[0].nu["encoder"], "nu", min_equal=0.75, scale_rtol=1e-2, max_code_diff=4)
    assert sum(tk.LAUNCHES.values()) == 0  # CPU tensors: the plain versions ran


def test_recompute_is_bit_identical_through_the_ensemble(monkeypatch):
    params, buffers = _jax_tied(seed=2)
    opt_state = jax.vmap(jax_adam(**CAPACITY).init)(params)
    ens = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("SC_RECOMPUTE_CODE", flag)
        ens[flag] = _port_tied(params, buffers, opt_state)
    assert "recompute_code" not in ens["0"].fused_adam
    xs = torch.from_numpy(_batches(2, 2))
    for x in xs:
        la, _ = ens["0"].step_batch(x)
        lb, _ = ens["1"].step_batch(x)
        torch.testing.assert_close(la["loss"], lb["loss"], rtol=1e-6, atol=0)
    a, b = ens["0"].state, ens["1"].state
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert torch.equal(a.opt_state.mu["encoder"].q, b.opt_state.mu["encoder"].q)
    assert torch.equal(a.opt_state.nu["encoder"].view(torch.int16), b.opt_state.nu["encoder"].view(torch.int16))


def test_quantized_state_round_trips_and_steps_identically(recompute):
    kw = dict(optimizer_kwargs=CAPACITY, compute_dtype="bfloat16", activation_size=D, n_dict_components=N,
              device="cpu")
    a = build_ensemble(FunctionalTiedSAE, 0, L1, **kw)
    xs = torch.from_numpy(_batches(3, 2))
    a.step_batch(xs[0])
    sd = a.state_dict()
    assert isinstance(sd["state"].opt_state.mu["encoder"], QuantMoment)
    b = Ensemble.from_state(sd, device="cpu")
    assert (b.fused_adam, b.state.step) == (a.fused_adam, 1)
    qa, qb = a.state.opt_state.mu["encoder"], b.state.opt_state.mu["encoder"]
    assert torch.equal(qa.q, qb.q) and torch.equal(qa.scale, qb.scale)
    la, _ = a.step_batch(xs[1])
    lb, _ = b.step_batch(xs[1])
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    for k in a.state.params:
        assert torch.equal(a.state.params[k], b.state.params[k]), k


def test_jax_quantized_state_carries_across_exactly():
    """A JAX ensemble's int8/bf16 Adam state (after one XLA step on the CPU)
    carries into the port bit for bit, and both fused steps then agree."""
    from sparse_coding__tpu import build_ensemble as jax_build_ensemble

    jens = jax_build_ensemble(JaxTiedSAE, jax.random.PRNGKey(0), L1, optimizer_kwargs=CAPACITY,
                              compute_dtype="bfloat16", activation_size=D, n_dict_components=N)
    xs = _batches(4, 2)
    jens.step_batch(jnp.asarray(xs[0]))
    st = jax.device_get(jens.state)
    carried = _carry(st.params, st.buffers, st.opt_state, step=1)
    jmu, tmu = st.opt_state[0].mu["encoder"], carried.opt_state.mu["encoder"]
    assert isinstance(jmu, JaxQuantMoment) and isinstance(tmu, QuantMoment)
    np.testing.assert_array_equal(to_np(tmu.q), np.asarray(jmu.q))
    np.testing.assert_array_equal(to_np(tmu.scale), np.asarray(jmu.scale))
    jnu = np.asarray(st.opt_state[0].nu["encoder"]).view(np.int16)
    np.testing.assert_array_equal(carried.opt_state.nu["encoder"].view(torch.int16).numpy(), jnu)
    ens = build_ensemble(FunctionalTiedSAE, 0, L1, optimizer_kwargs=CAPACITY, compute_dtype="bfloat16",
                         activation_size=D, n_dict_components=N, device="cpu")
    ens.state = carried
    p, o, jl = JaxTiedSAE.fused_adam_step(st.params, st.buffers, jnp.asarray(xs[1]), st.opt_state,
                                          LR, 0.9, 0.999, 1e-8, interpret=True)
    tl, _ = ens.step_batch(torch.from_numpy(xs[1]))
    np.testing.assert_allclose(to_np(tl["loss"]), np.asarray(jl["loss"]), rtol=1e-3)
    for k in ("encoder", "encoder_bias"):
        _assert_tracks(ens.state.params[k], p[k], st.params[k], 1)
    assert_moment_tracks(ens.state.opt_state.mu["encoder"], o[0].mu["encoder"], "mu")


def test_masked_capacity_step_takes_fused_grads_and_the_compressed_adam(recompute):
    params, buffers = _jax_tied(seed=1)
    opt_state = jax.vmap(jax_adam(**CAPACITY).init)(params)
    ens = _port_tied(params, buffers, opt_state)
    ens.set_update_mask([1.0, 0.0])
    frozen = ens.state.params["encoder"][1].clone()
    x = _batches(5, 1)[0]
    _, jl = JaxTiedSAE.fused_grads_stacked(params, buffers, jnp.asarray(x), interpret=True)
    tl, _ = ens.step_batch(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(tl["loss"]), np.asarray(jl["loss"]), rtol=1e-3)
    assert torch.equal(ens.state.params["encoder"][1], frozen)
    assert not np.array_equal(to_np(ens.state.params["encoder"][0]), np.asarray(params["encoder"][0]))
    assert isinstance(ens.state.opt_state.mu["encoder"], QuantMoment)
    assert ens.state.opt_state.nu["encoder"].dtype == torch.bfloat16


def test_topk_capacity_ensemble_tracks_chained_jax_fused_steps(recompute):
    ks = [7, 31]
    models = [JaxTopK.init(k, D, N, sparsity=s, sparsity_cap=31)
              for k, s in zip(jax.random.split(jax.random.PRNGKey(1), 2), ks)]
    params = stack_pytrees([p for p, _ in models])
    buffers = stack_pytrees([b for _, b in models])
    opt_state = jax.vmap(jax_adam(**CAPACITY).init)(params)
    ens = build_ensemble(TopKEncoderApprox, 0, [{"sparsity": k} for k in ks], optimizer_kwargs=CAPACITY,
                         compute_dtype="bfloat16", d_activation=D, n_features=N, sparsity_cap=31, device="cpu")
    assert ens.fused and ens.fused_adam["recompute_code"] is True  # accepted, ignored
    ens.state = _carry(params, buffers, opt_state)
    xs = _batches(6, 2)
    start = np.asarray(params["dict"])
    for i in range(2):
        params, opt_state, jl = JaxTopK.fused_adam_step(params, buffers, jnp.asarray(xs[i]), opt_state,
                                                        LR, 0.9, 0.999, 1e-8, interpret=True)
        tl, _ = ens.step_batch(torch.from_numpy(xs[i]))
        np.testing.assert_allclose(to_np(tl["loss"]), np.asarray(jl["loss"]), rtol=1e-3)
        _assert_tracks(ens.state.params["dict"], params["dict"], start, i + 1)
    assert_moment_tracks(ens.state.opt_state.mu["dict"], opt_state[0].mu["dict"], "mu", min_equal=0.75, scale_rtol=1e-2, max_code_diff=4)
    assert_moment_tracks(ens.state.opt_state.nu["dict"], opt_state[0].nu["dict"], "nu", min_equal=0.75, scale_rtol=1e-2, max_code_diff=4)
