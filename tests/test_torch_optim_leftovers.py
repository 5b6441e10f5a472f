"""The optimizer leftovers at the ensemble level: SGD with momentum (and
Nesterov, and a bf16 accumulator) and Adam with fp16 first moments, held to
the JAX package's ensemble from one state, and an SGD-momentum sweep resumed
from its checkpoint.

Tolerances, and why:
  - f32 (autograd path): losses rtol 1e-5; the params' movement over the run
    and the trace gradient-close (`_torch_parity.assert_grads_close`: cosine
    > 0.9999, max error < 1e-2 of the max) — both sides' f32 sums differ in
    order only;
  - bf16 fused grads (K1 + K3's plain versions here, the Pallas entries in
    interpret mode in JAX): losses rtol 1e-3 (bf16 roundings of c, dxh and
    dc may flip at ties); the params' movement, traces and moments
    gradient-close (a bf16-stored trace to 2e-2 of its max: each of the 5
    steps rounds it anew to 2^-8); Adam's params within 2 lr per step (the
    bf16 slice's pin: Adam maps gradient noise near |g| ~ eps to updates
    bounded by lr, so its movement is not gradient-close);
  - resume: none (`torch.equal` on every exported array).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import assert_grads_close, to_np
from sparse_coding__tpu_torch import FunctionalTiedSAE, build_ensemble
from sparse_coding__tpu_torch.interop import state_from_jax_numpy
from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib
from sparse_coding__tpu_torch.train import preemption
from sparse_coding__tpu_torch.utils import faults, optim
from sparse_coding__tpu_torch.utils.tree import tree_leaves

L1 = [1e-3, 3e-3]
SGD_KW = {"learning_rate": 0.05, "momentum": 0.9}


def _jax_opt_numpy(opt_state):
    """The JAX ensemble's optimizer state as `state_from_jax_numpy` takes it."""
    first = jax.device_get(opt_state[0])
    if hasattr(first, "trace"):
        return {"trace": dict(first.trace)}
    return {"count": np.asarray(first.count), "mu": dict(first.mu), "nu": dict(first.nu)}


def _batches(seed, k, b, d):
    return np.random.default_rng(seed).standard_normal((k, b, d)).astype(np.float32)


def test_f32_sgd_momentum_ensemble_matches_jax():
    """Two JAX steps first, so the carried trace is not zero; then 5 steps
    on both sides from that state."""
    from sparse_coding__tpu import build_ensemble as jax_build_ensemble
    from sparse_coding__tpu.models import FunctionalTiedSAE as JaxTiedSAE

    d, n, b = 32, 64, 64
    kw = dict(optimizer="sgd", optimizer_kwargs=SGD_KW, activation_size=d, n_dict_components=n)
    jens = jax_build_ensemble(JaxTiedSAE, jax.random.PRNGKey(0), [{"l1_alpha": a} for a in L1], **kw)
    xs = _batches(1, 7, b, d)
    for i in range(2):
        jens.step_batch(jnp.asarray(xs[i]))
    st = jax.device_get(jens.state)
    ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": a} for a in L1], device="cpu", **kw)
    assert not ens.fused and isinstance(ens.state.opt_state, optim.SgdState)
    ens.state = state_from_jax_numpy(st.params, st.buffers, _jax_opt_numpy(st.opt_state), step=2, device="cpu")
    np.testing.assert_array_equal(to_np(ens.state.opt_state.count), [2, 2])
    start = {k: to_np(v).copy() for k, v in ens.state.params.items()}
    for i in range(2, 7):
        jl, _ = jens.step_batch(jnp.asarray(xs[i]))
        tl, _ = ens.step_batch(torch.from_numpy(xs[i]))
        for k in ("loss", "l_reconstruction", "l_l1"):
            np.testing.assert_allclose(to_np(tl[k]), np.asarray(jl[k]), rtol=1e-5, err_msg=k)
    jst = jax.device_get(jens.state)
    for k in ("encoder", "encoder_bias"):
        assert_grads_close(to_np(ens.state.params[k]) - start[k], np.asarray(jst.params[k]) - start[k], f"moved {k}")
        assert_grads_close(ens.state.opt_state.trace[k], jst.opt_state[0].trace[k], f"trace {k}")
    assert ens.state.step == 7 and int(jst.step) == 7


def _interpreted_step(tx):
    """The JAX package's bf16 fused-grads step (`make_ensemble_step`, K1 + K3
    as Pallas entries in interpret mode on the CPU), then ``tx``: what its
    `Ensemble` runs on a TPU for an optimizer the fused Adam refuses."""
    from sparse_coding__tpu.ensemble import make_ensemble_step
    from sparse_coding__tpu.models import FunctionalTiedSAE as JaxTiedSAE

    class Interpreted(JaxTiedSAE):
        @staticmethod
        def fused_grads_stacked(params, buffers, batch):
            return JaxTiedSAE.fused_grads_stacked(params, buffers, batch, interpret=True)

    return jax.jit(make_ensemble_step(Interpreted, tx, compute_dtype=jnp.bfloat16, fused=True))


ARMS = {
    "sgd_momentum": ("sgd", SGD_KW, lambda: optax.sgd(0.05, momentum=0.9)),
    "sgd_nesterov_bf16_trace": ("sgd", dict(SGD_KW, nesterov=True, accumulator_dtype="bfloat16"),
                                lambda: optax.sgd(0.05, momentum=0.9, nesterov=True, accumulator_dtype=jnp.bfloat16)),
    "adam_fp16_mu": ("adam", {"learning_rate": 1e-3, "mu_dtype": "float16"},
                     lambda: optax.adam(1e-3, mu_dtype=jnp.float16)),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_bf16_fused_grads_ensemble_matches_jax(arm):
    """The arms chip_smoke's ``optim_leftovers`` runs at config 2's width,
    here at D 128, N 512, batch 256: the fused Adam is refused (fp16 mu with
    the one-time warning JAX gives), the step takes fused grads (K1 + K3)
    then the port's optimizer, and 5 steps track JAX's."""
    from sparse_coding__tpu.ensemble import EnsembleState as JaxState
    from sparse_coding__tpu.ensemble import stack_pytrees
    from sparse_coding__tpu.models import FunctionalTiedSAE as JaxTiedSAE

    d, n, b = 128, 512, 256
    name, kwargs, make_tx = ARMS[arm]
    models = [JaxTiedSAE.init(k, d, n, l1_alpha=a) for k, a in zip(jax.random.split(jax.random.PRNGKey(0), 2), L1)]
    params, buffers = stack_pytrees([p for p, _ in models]), stack_pytrees([q for _, q in models])
    tx = make_tx()
    jst = JaxState(params=params, buffers=buffers, opt_state=jax.vmap(tx.init)(params),
                   step=jnp.asarray(0, jnp.int32))
    kw = dict(optimizer=name, optimizer_kwargs=kwargs, compute_dtype="bfloat16", activation_size=d,
              n_dict_components=n, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": a} for a in L1], **kw)
        ens2 = build_ensemble(FunctionalTiedSAE, 1, [{"l1_alpha": a} for a in L1], **kw)
    refusals = [w for w in caught if "fused-Adam kernel refused" in str(w.message)]
    if name == "adam":
        # once per (signature, reason) in a process: a second build is silent
        assert len(refusals) <= 1 and all("unsupported moment storage ['mu_dtype=float16']" in str(w.message)
                                          for w in refusals)
    else:
        assert refusals == []
    assert ens.fused and ens.fused_adam is None and ens2.fused_adam is None
    assert ens._route(b, masked=False, per_model=False) == "fused_grads"
    st = jax.device_get(jst)
    carried = state_from_jax_numpy(st.params, st.buffers, _jax_opt_numpy(st.opt_state), device="cpu")
    ens.state = carried
    step = _interpreted_step(tx)
    xs = _batches(2, 5, b, d)
    tk.reset_launches()
    start = {k: to_np(v).copy() for k, v in ens.state.params.items()}
    for i in range(5):
        jst, (jl, _) = step(jst, jnp.asarray(xs[i]))
        tl, _ = ens.step_batch(torch.from_numpy(xs[i]))
        for k in ("loss", "l_reconstruction", "l_l1"):
            np.testing.assert_allclose(to_np(tl[k]), np.asarray(jl[k]), rtol=1e-3, err_msg=f"{arm} step {i} {k}")
    assert sum(tk.LAUNCHES.values()) == 0  # CPU tensors: the plain versions ran
    jst = jax.device_get(jst)
    opt = ens.state.opt_state
    for k in ("encoder", "encoder_bias"):
        moved_t, moved_j = to_np(ens.state.params[k]) - start[k], np.asarray(jst.params[k]) - start[k]
        if name == "sgd":
            assert_grads_close(moved_t, moved_j, f"{arm} moved {k}")
            tr = jst.opt_state[0].trace[k]
            assert opt.trace[k].dtype == (torch.bfloat16 if "bf16" in arm else torch.float32)
            assert str(tr.dtype) == str(opt.trace[k].dtype).removeprefix("torch.")
            # a bf16 trace rounds each step's sum anew: after 5 chained
            # steps its elements sit a few bf16 ulps (2^-8 each) apart
            assert_grads_close(opt.trace[k], tr, f"{arm} trace {k}", max_rel=2e-2 if "bf16" in arm else 1e-2)
        else:
            assert opt.mu[k].dtype == torch.float16 and jst.opt_state[0].mu[k].dtype == jnp.float16
            assert_grads_close(opt.mu[k].float(), np.asarray(jst.opt_state[0].mu[k], np.float32), f"{arm} mu {k}")
            assert np.abs(moved_t - moved_j).max() <= 2 * 1e-3 * 5, k
    assert ens.state.step == 5


def test_sgd_momentum_sweep_resumed_from_its_checkpoint_gives_the_uninterrupted_bits(tmp_path, monkeypatch):
    """A SIGTERM at position 1 (``SC_FAULT=sigterm:chunk=1``) commits a
    checkpoint holding the SGD trace (`SgdState`, rebuilt from a
    ``weights_only`` load); the resumed sweep exports the uninterrupted
    run's bits, and its trace the same bits."""
    from sparse_coding__tpu_torch.data.chunks import save_chunk
    from sparse_coding__tpu_torch.train.sweep import sweep
    from sparse_coding__tpu_torch.utils.config import EnsembleArgs

    d, n = 16, 32
    for k in ("SC_FAULT", "SC_RESUME"):
        monkeypatch.delenv(k, raising=False)
    rng = np.random.default_rng(0)
    for i in range(3):
        save_chunk(tmp_path / "store", i, rng.standard_normal((128, d)).astype(np.float32))
    held = {}

    def init(cfg):
        ens = build_ensemble(FunctionalTiedSAE, cfg.seed, [{"l1_alpha": a} for a in L1], optimizer="sgd",
                             optimizer_kwargs=dict(SGD_KW, learning_rate=1e-2, nesterov=True),
                             activation_size=d, n_dict_components=n, device="cpu")
        held[cfg.output_folder] = ens
        return [(ens, {"batch_size": cfg.batch_size}, "sgd")], [], ["l1_alpha"], {"l1_alpha": L1}

    def run(out):
        cfg = EnsembleArgs(dataset_folder=str(tmp_path / "store"), output_folder=str(tmp_path / out), batch_size=32,
                           n_epochs=2, activation_width=d)
        return sweep(init, cfg, resume=False, device="cpu")

    faults.reset()
    preemption.reset()
    try:
        run("a")
        monkeypatch.setenv("SC_FAULT", "sigterm:chunk=1")
        faults.reset()
        with pytest.raises(preemption.Preempted):
            run("b")
        tree = ckpt_lib.restore_ensemble_checkpoint(ckpt_lib.latest_checkpoint(tmp_path / "b"))
        saved = tree["ensembles"]["sgd"]["state"].opt_state
        assert isinstance(saved, optim.SgdState) and saved.trace["encoder"].shape == (2, n, d)
        assert float(saved.trace["encoder"].abs().max()) > 0
        monkeypatch.delenv("SC_FAULT")
        monkeypatch.setenv("SC_RESUME", "1")
        faults.reset()
        preemption.reset()
        run("b")
    finally:
        faults.reset()
        preemption.reset()
    a, b = held[str(tmp_path / "a")], held[str(tmp_path / "b")]
    assert a.state.step == b.state.step and a.state.step > 0
    for ta, tb in zip(tree_leaves(a.state.opt_state), tree_leaves(b.state.opt_state)):
        assert torch.equal(ta, tb)
    last = sorted(p for p in (tmp_path / "a").iterdir() if p.name.startswith("_"))[-1].name
    got = ckpt_lib.load_learned_dicts(tmp_path / "b" / last / "learned_dicts.pkl", verify=True, device="cpu")
    ref = ckpt_lib.load_learned_dicts(tmp_path / "a" / last / "learned_dicts.pkl", verify=True, device="cpu")
    assert len(got) == len(ref) == 2
    for (g, hg), (r, hr) in zip(got, ref):
        assert hg == hr
        for f in ("encoder", "encoder_bias"):
            assert torch.equal(getattr(g, f), getattr(r, f)), f
