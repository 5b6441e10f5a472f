"""The port's `Ensemble` options against the JAX package's: per-member
batches, ``unstacked``, `step_scan_idx`, the l1-warmup ramp computed on the
device and its resume, and the train loop's routes. D 128, N 512, batch 256,
2–3 members, inputs from numpy with a seed; each test mirrors one of
`tests/test_ensemble.py`'s. On CPU tensors `step_scan` and `step_scan_idx`
loop over `step_batch` (their CUDA graphs are held to it bit for bit in
`tests/test_torch_kernels_cuda.py`).

Tolerances, and why:
  - port against JAX, f32 autograd: losses rtol 1e-5, params within 1e-2 lr
    per step (the f32 slice's, `tests/test_torch_slice.py`);
  - port against port where only the dispatch differs (`step_scan_idx` vs
    `step_scan` of the gathered rows, the device ramp vs the host ramp, a
    state round trip): bit-equal;
  - ``unstacked`` against stacked (the JAX test's rtol 1e-5): each member's
    loss and gradient computed alone are the stacked ones' up to the
    batched products' rounding, so losses rtol 1e-6 and params within
    1e-6 lr per step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_moments import state_differences
from _torch_parity import to_np
from sparse_coding__tpu import Ensemble as JaxEnsemble
from sparse_coding__tpu.ensemble import make_ensemble_multi_step_idx
from sparse_coding__tpu.models import FunctionalTiedSAE as JaxTiedSAE
from sparse_coding__tpu_torch import Ensemble, FunctionalTiedSAE, build_ensemble
from sparse_coding__tpu_torch.ensemble import l1_warmup_buffers, unstack_pytree
from sparse_coding__tpu_torch.interop import state_from_jax_numpy
from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib
from sparse_coding__tpu_torch.train.loop import ensemble_train_loop

D, N, B = 128, 512, 256
LR = 1e-3
L1 = [1e-3, 3e-3, 1e-2]
OPT = {"learning_rate": LR}


def _jax_ensemble(l1=L1, seed=0, **kw):
    models = [JaxTiedSAE.init(k, D, N, l1_alpha=a) for k, a in zip(jax.random.split(jax.random.PRNGKey(seed), len(l1)), l1)]
    return JaxEnsemble(models, JaxTiedSAE, optimizer_kwargs=dict(OPT), **kw)


def _port_of(jens, **kw):
    """A port ensemble of ``kw``'s options at the JAX ensemble's state."""
    st = jax.device_get(jens.state)
    a = st.opt_state[0]
    state = state_from_jax_numpy(st.params, st.buffers, {"count": np.asarray(a.count), "mu": dict(a.mu), "nu": dict(a.nu)},
                                 step=int(st.step), device="cpu")
    models = list(zip(unstack_pytree(state.params, jens.n_models), unstack_pytree(state.buffers, jens.n_models)))
    ens = Ensemble(models, FunctionalTiedSAE, optimizer_kwargs=dict(OPT), **kw)
    ens.state = state
    return ens


def _batches(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_losses(tl, jl, rtol=1e-5):
    for k in ("loss", "l_reconstruction", "l_l1"):
        np.testing.assert_allclose(to_np(tl[k]), np.asarray(jl[k]), rtol=rtol, err_msg=k)


def _assert_params(ens, jens, steps):
    jp = jax.device_get(jens.state.params)
    for k in ("encoder", "encoder_bias"):
        assert np.abs(to_np(ens.state.params[k]) - np.asarray(jp[k])).max() <= 1e-2 * LR * steps, k


@pytest.mark.parametrize("entry", ["step_batch", "step_scan"])
def test_per_model_batches_match_jax(entry):
    """Each member steps on its own batch ([M, B, D], or [K, M, B, D] for
    `step_scan`), through the autograd path, as JAX's ``per_model``
    (`tests/test_ensemble.py::test_per_model_batches`)."""
    fused = _port_of(_jax_ensemble(), compute_dtype="bfloat16")
    assert fused.fused and fused._route(B, False, True) == "autograd"  # per-member batches refuse the kernels
    jens = _jax_ensemble()
    ens = _port_of(jens)
    xs = _batches(1, (3, len(L1), B, D))
    if entry == "step_batch":
        for k in range(3):
            jl, _ = jens.step_batch(jnp.asarray(xs[k]), per_model=True)
            tl, aux = ens.step_batch(torch.from_numpy(xs[k]), per_model=True)
            assert tl["loss"].shape == (len(L1),) and aux["c"].shape == (len(L1), B, N)
            _assert_losses(tl, jl)
    else:
        jl = jens.step_scan(jnp.asarray(xs), per_model=True)
        tl = ens.step_scan(torch.from_numpy(xs), per_model=True)
        assert tl["loss"].shape == (3, len(L1))
        _assert_losses(tl, jl)
    _assert_params(ens, jens, 3)


@pytest.mark.parametrize("per_model", [False, True])
def test_unstacked_equals_stacked_and_matches_jax(per_model):
    """``unstacked`` differentiates one member at a time and equals the
    stacked ensemble (`tests/test_ensemble.py::test_unstacked_escape_hatch_
    matches_vmap`), and JAX's ``unstacked`` within the f32 tolerances. It
    refuses the fused kernels, as JAX's does."""
    jens_u = _jax_ensemble(seed=7, unstacked=True)
    ens_u = _port_of(jens_u, unstacked=True)
    ens_v = _port_of(jens_u)
    assert ens_u.unstacked and not ens_v.unstacked
    shape = (3, len(L1), B, D) if per_model else (3, B, D)
    xs = _batches(3, shape)
    for k in range(3):
        jl, _ = jens_u.step_batch(jnp.asarray(xs[k]), per_model=per_model)
        lu, au = ens_u.step_batch(torch.from_numpy(xs[k]), per_model=per_model)
        lv, av = ens_v.step_batch(torch.from_numpy(xs[k]), per_model=per_model)
        _assert_losses(lu, jl)
        for name in lv:
            torch.testing.assert_close(lu[name], lv[name], rtol=1e-6, atol=0)
        assert au["c"].shape == av["c"].shape == (len(L1), B, N)
    for name in ("encoder", "encoder_bias"):
        torch.testing.assert_close(ens_u.state.params[name], ens_v.state.params[name], rtol=0, atol=1e-6 * LR * 3)
    _assert_params(ens_u, jens_u, 3)
    fused = Ensemble(list(zip(unstack_pytree(ens_v.state.params, 3), unstack_pytree(ens_v.state.buffers, 3))),
                     FunctionalTiedSAE, optimizer_kwargs=dict(OPT), compute_dtype="bfloat16", unstacked=True)
    assert not fused.fused and fused.fused_adam is None
    rt = Ensemble.from_state(ens_u.state_dict(), device="cpu")
    assert rt.unstacked


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_step_scan_idx_matches_step_scan_and_jax(compute_dtype):
    """Gathering each batch by index (`step_scan_idx`) is bit-identical to
    scanning the gathered rows (`tests/test_ensemble.py::test_step_scan_idx_
    matches_step_scan`), on the f32 autograd path and on the bf16 fused path
    (the kernels' plain versions), and the f32 one matches JAX's
    `step_scan_idx`."""
    dataset = np.random.default_rng(0).standard_normal((2048, D), dtype=np.float32)
    idxs = np.random.default_rng(1).permutation(2048)[: 4 * B].reshape(4, B)
    jens = _jax_ensemble(seed=2)
    ens_a = _port_of(jens, compute_dtype=compute_dtype)
    ens_b = _port_of(jens, compute_dtype=compute_dtype)
    assert ens_a.fused == (compute_dtype is not None)
    data_t = torch.from_numpy(dataset)
    la = ens_a.step_scan_idx(data_t, torch.from_numpy(idxs))
    lb = ens_b.step_scan(data_t[torch.from_numpy(idxs)])
    for k in lb:
        assert torch.equal(la[k], lb[k]), k
    assert state_differences(ens_a.state, ens_b.state) == []
    if compute_dtype is None:
        _assert_losses(la, jens.step_scan_idx(jnp.asarray(dataset), idxs))
        _assert_params(ens_a, jens, 4)


def test_step_scan_idx_is_shared_batch_only():
    """As JAX's (`make_ensemble_multi_step_idx`), `step_scan_idx` refuses
    per-member batches."""
    with pytest.raises(ValueError, match="shared-batch only"):
        make_ensemble_multi_step_idx(JaxTiedSAE, optax.adam(LR), per_model_batch=True)
    ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": a} for a in L1], optimizer_kwargs=dict(OPT),
                         activation_size=D, n_dict_components=N, device="cpu")
    with pytest.raises(ValueError, match="shared-batch only"):
        ens.step_scan_idx(torch.zeros((B, D)), torch.zeros((1, B), dtype=torch.int64), per_model=True)
    assert ens.state.step == 0


@pytest.mark.parametrize("warmup_steps", [1, 3, 7, 16, 1000])
def test_device_ramp_is_the_host_ramp_bit_for_bit(warmup_steps):
    """``min((step + 1) / W, 1)`` from a device step counter gives each step's
    f32 ramp, and the ramped l1, with the bits of the host ramp it replaced
    (``np.float32`` arithmetic)."""
    l1 = torch.tensor(L1, dtype=torch.float32)
    for step in range(40):
        host = min((np.float32(step) + np.float32(1.0)) / np.float32(warmup_steps), np.float32(1.0))
        got = l1_warmup_buffers({"l1_alpha": l1}, torch.tensor(step, dtype=torch.int32), warmup_steps)["l1_alpha"]
        assert torch.equal(got, l1 * float(host)), step


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_warmup_steps_are_the_host_ramp_steps_and_match_jax(compute_dtype):
    """Over 6 steps with a 4-step ramp, an ensemble ramping l1 on the device
    gives the losses and params of one whose l1 buffer is set, before each
    step, to the host ramp's value (the port's former ramp) — bit for bit,
    on the f32 autograd path and the bf16 fused path — and the f32 one
    matches JAX's warmup (`l1_warmup_steps`) within the f32 tolerances."""
    W = 4
    jens = _jax_ensemble(seed=4, l1_warmup_steps=W)
    warm = _port_of(jens, compute_dtype=compute_dtype, l1_warmup_steps=W)
    ctrl = _port_of(jens, compute_dtype=compute_dtype)
    l1 = ctrl.state.buffers["l1_alpha"].clone()
    xs = _batches(5, (6, B, D))
    for k in range(6):
        ramp = min((np.float32(k) + np.float32(1.0)) / np.float32(W), np.float32(1.0))
        ctrl.state.buffers = {**ctrl.state.buffers, "l1_alpha": l1 * float(ramp)}
        lw, _ = warm.step_batch(torch.from_numpy(xs[k]))
        lc, _ = ctrl.step_batch(torch.from_numpy(xs[k]))
        for name in lc:
            assert torch.equal(lw[name], lc[name]), (k, name)
        for name in ("encoder", "encoder_bias"):
            assert torch.equal(warm.state.params[name], ctrl.state.params[name]), (k, name)
        if compute_dtype is None:
            jl, _ = jens.step_batch(jnp.asarray(xs[k]))
            _assert_losses(lw, jl)
    assert torch.equal(warm.state.buffers["l1_alpha"], l1)  # the stored buffer is never ramped
    if compute_dtype is None:
        _assert_params(warm, jens, 6)


@pytest.mark.parametrize("through", ["state_dict", "checkpoint"])
def test_warmup_ramp_phase_survives_a_round_trip(through, tmp_path):
    """A mid-ramp state restored by `from_state` (from `state_dict`, or from
    a committed sweep checkpoint) keeps the warmup length and the step, so
    it continues the ramp (`tests/test_ensemble.py::test_l1_warmup_resume_
    keeps_ramp_phase`): the next step's losses are the live ensemble's bits."""
    ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": 1e-2}], optimizer_kwargs=dict(OPT),
                         activation_size=D, n_dict_components=N, l1_warmup_steps=16, device="cpu")
    xs = torch.from_numpy(_batches(6, (5, B, D)))
    ens.step_scan(xs[:4])
    sd = ens.state_dict()
    if through == "checkpoint":
        ckpt_lib.save_ensemble_checkpoint(tmp_path / "ckpt_0", [(ens, {}, "a")])
        sd = ckpt_lib.restore_ensemble_checkpoint(tmp_path / "ckpt_0")["ensembles"]["a"]
    restored = Ensemble.from_state(sd, device="cpu")
    assert restored.l1_warmup_steps == 16 and restored.state.step == 4
    la, _ = ens.step_batch(xs[4])
    lb, _ = restored.step_batch(xs[4])
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    assert state_differences(ens.state, restored.state) == []


@pytest.mark.parametrize("path", ["grouped", "whole_chunk"])
def test_train_loop_routes(path, monkeypatch):
    """`ensemble_train_loop` takes the JAX loop's routes: the grouped path
    (a progress callback) calls `step_scan_idx` for each group and for each
    remainder step, never `step_scan` or `step_batch`; the whole-chunk path
    calls `step_scan` once."""
    ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": a} for a in L1[:2]], optimizer_kwargs=dict(OPT),
                         compute_dtype="bfloat16", activation_size=D, n_dict_components=N, device="cpu")
    calls = {"step_scan_idx": [], "step_scan": []}
    for name in ("step_scan_idx", "step_scan"):
        orig = getattr(ens, name)

        def wrapped(*a, _orig=orig, _name=name, **kw):
            out = _orig(*a, **kw)
            calls[_name].append(len(out["loss"]))
            return out

        monkeypatch.setattr(ens, name, wrapped)
    dataset = torch.from_numpy(_batches(7, (10 * B + 17, D)))
    seen = []
    ensemble_train_loop(ens, dataset, B, key=0, scan_steps=4, dead_check=False,
                        progress_callback=(lambda i, n: seen.append(i)) if path == "grouped" else None)
    if path == "grouped":
        assert calls["step_scan_idx"] == [4, 4, 1, 1] and calls["step_scan"] == [] and seen == [3, 7, 8, 9]
    else:
        assert calls["step_scan"] == [10] and calls["step_scan_idx"] == []
    assert ens.state.step == 10


@pytest.mark.parametrize("route", ["fused", "autograd", "per_model"])
def test_step_batch_writes_the_new_state_into_the_state_tensors(route):
    """Every step commits its state one way: into the state's own tensors
    (the captured step's way), so a step leaves each tensor where it was and
    a graph captured before it stays valid. The values are those of a step
    from a copy of the state (bit-equal: only where they are written
    differs)."""
    kw = dict(compute_dtype="bfloat16") if route == "fused" else {}
    ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": a} for a in L1[:2]], optimizer_kwargs=dict(OPT),
                         activation_size=D, n_dict_components=N, l1_warmup_steps=4, device="cpu", **kw)
    assert ens.fused == (route == "fused")
    per_model = route == "per_model"
    x = torch.from_numpy(_batches(8, (2, ens.n_models, B, D) if per_model else (2, B, D)))
    ens.step_batch(x[0], per_model=per_model)
    copy = Ensemble.from_state(ens.state_dict(), device="cpu")
    tensors = [t.data_ptr() for t in ens._leaves()]
    la, _ = ens.step_batch(x[1], per_model=per_model)
    lb, _ = copy.step_batch(x[1], per_model=per_model)
    assert [t.data_ptr() for t in ens._leaves()] == tensors
    assert ens.state.step == 2 and int(ens._step_t) == 2
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    assert state_differences(ens.state, copy.state) == []


def test_assigned_state_refills_the_device_step_and_records_stay_unchanged():
    """Assigning a state (as resume and the FISTA decoder update do) refills
    the device step counter from ``state.step`` before the next step, so the
    ramp continues from the assigned step; ensembles rebuilt from one record
    own copies, so stepping one changes neither the record nor the other."""
    ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": 1e-2}], optimizer_kwargs=dict(OPT),
                         activation_size=D, n_dict_components=N, l1_warmup_steps=16, device="cpu")
    xs = torch.from_numpy(_batches(9, (6, B, D)))
    ens.step_scan(xs[:2])
    sd = ens.state_dict()
    ens.step_scan(xs[2:5])
    later = ens.state_dict()["state"]
    a = Ensemble.from_state(sd, device="cpu")
    b = Ensemble.from_state(sd, device="cpu")
    record = {k: v.clone() for k, v in sd["state"].params.items()}
    a.step_scan(xs[2:5])
    assert all(torch.equal(sd["state"].params[k], record[k]) for k in record)
    assert state_differences(a.state, later) == []
    b.step_batch(xs[2])  # its device counter now holds 3
    b.state = a.state_dict()["state"]  # a state assigned from outside, at step 5
    assert b.state.step == 5
    la, _ = ens.step_batch(xs[5])
    lb, _ = b.step_batch(xs[5])
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    assert int(b._step_t) == 6
