"""The port's FISTA dictionary path against the JAX package, from the same
weights: the `FunctionalFista` gradient step, the FISTA decoder update, both
chained over a few batches, the train loop, checkpoints and exports (CPU).

The JAX ensemble's state is carried across with `interop.state_from_jax_numpy`
and both sides step on the same numpy batches. Tolerances, and why:
  - the gradient step (float32 autograd): losses rtol 1e-5; gradients and
    the step's code atol 1e-6;
  - the decoder update (a 50-iteration solve + basis step on unit-norm
    rows): decoder atol 1e-6, Hessian diagonal atol 1e-7 (its entries are
    ~1e-4; sums in another order);
  - chained steps: 30 gradient steps + decoder updates, decoders within
    1e-5 (3e-7 measured) and the planted-feature MMCS within 1e-5;
  - exports: FVU rtol 1e-5 and L0 to one entry in the batch.
"""

import importlib
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from sparse_coding__tpu import build_ensemble as jax_build_ensemble
from sparse_coding__tpu.models import FunctionalFista as JaxFista
from sparse_coding__tpu.train import make_fista_decoder_update as jax_make_update
from sparse_coding__tpu_torch import Ensemble, Fista, FunctionalFista, build_ensemble
from sparse_coding__tpu_torch.interop import state_from_jax_numpy
from sparse_coding__tpu_torch.models.learned_dict import UntiedSAE
from sparse_coding__tpu_torch.ops import fista_kernel as fk
from sparse_coding__tpu_torch.train.loop import ensemble_train_loop, make_fista_decoder_update

REPO = Path(__file__).resolve().parents[1]
LR = 1e-3
L1 = [{"l1_alpha": 1e-4}, {"l1_alpha": 1e-3}]
N, D = 32, 16


def _truth(seed=0):
    t = np.random.default_rng(seed).standard_normal((N, D)).astype(np.float32)
    return t / np.linalg.norm(t, axis=-1, keepdims=True)


def _batches(truth, k, b=128, seed=1):
    """``k`` batches [b, D] of sparse non-negative mixtures of ``truth``'s rows."""
    rng = np.random.default_rng(seed)
    codes = rng.uniform(0.5, 1.5, (k, b, N)) * (rng.uniform(size=(k, b, N)) < 0.1)
    return (codes @ truth).astype(np.float32)


def _pair(seed=2, bias_decay=0.0):
    """A JAX FunctionalFista ensemble and the port's, carried from its state."""
    hp = [dict(a, bias_decay=bias_decay) for a in L1]
    jens = jax_build_ensemble(JaxFista, jax.random.PRNGKey(seed), hp, optimizer_kwargs={"learning_rate": LR},
                              compute_dtype="bfloat16", activation_size=D, n_dict_components=N)
    st = jax.device_get(jens.state)
    adam = st.opt_state[0]
    ens = build_ensemble(FunctionalFista, 0, hp, optimizer_kwargs={"learning_rate": LR},
                         compute_dtype="bfloat16", activation_size=D, n_dict_components=N, device="cpu")
    ens.state = state_from_jax_numpy(
        st.params, st.buffers, {"count": np.asarray(adam.count), "mu": dict(adam.mu), "nu": dict(adam.nu)},
        step=int(st.step), device="cpu",
    )
    return jens, ens


def test_carried_state_and_init():
    jens, ens = _pair()
    assert not ens.fused and ens.fused_adam is None  # untied: the autograd step
    assert sorted(ens.state.params) == ["decoder", "encoder", "encoder_bias"]
    assert sorted(ens.state.buffers) == ["bias_decay", "hessian_diag", "l1_alpha"]
    for k, v in jax.device_get(jens.state.buffers).items():
        np.testing.assert_array_equal(to_np(ens.state.buffers[k]), np.asarray(v), err_msg=k)
    own = build_ensemble(FunctionalFista, 7, L1, activation_size=D, n_dict_components=N, device="cpu")
    enc, dec = own.state.params["encoder"], own.state.params["decoder"]
    limit = (6.0 / (N + D)) ** 0.5
    assert enc.shape == dec.shape == (2, N, D) and not torch.equal(enc, dec)
    assert float(enc.abs().max()) <= limit and float(dec.abs().max()) <= limit
    assert not own.state.buffers["hessian_diag"].any()


def test_gradient_step_matches_jax():
    """Loss, step code (f32 under bf16 compute, as JAX's) and params."""
    jens, ens = _pair(bias_decay=1e-3)
    x = _batches(_truth(), 2)
    for i in range(2):
        jl, jaux = jens.step_batch(jnp.asarray(x[i]))
        tl, taux = ens.step_batch(torch.from_numpy(x[i]))
        assert taux["c"].dtype == torch.float32 and np.asarray(jaux["c"]).dtype == np.float32
        np.testing.assert_allclose(to_np(taux["c"]), np.asarray(jaux["c"]), rtol=0, atol=1e-6)
        assert sorted(tl) == sorted(jl)
        for k in jl:
            np.testing.assert_allclose(to_np(tl[k]), np.asarray(jl[k]), rtol=1e-5, err_msg=k)
    jp = jax.device_get(jens.state.params)
    for k in jp:
        np.testing.assert_allclose(to_np(ens.state.params[k]), np.asarray(jp[k]), rtol=0, atol=1e-6, err_msg=k)


def test_loss_and_grads_match_jax():
    jens, ens = _pair(seed=3, bias_decay=1e-3)
    x = _batches(_truth(), 1)[0]
    st = jax.device_get(jens.state)

    def jax_member(m):
        p = {k: v[m] for k, v in st.params.items()}
        b = {k: v[m] for k, v in st.buffers.items()}
        return jax.value_and_grad(lambda p: JaxFista.loss(p, b, jnp.asarray(x))[0])(p)

    leaves = {k: v.clone().requires_grad_(True) for k, v in ens.state.params.items()}
    total, _ = FunctionalFista.loss(leaves, ens.state.buffers, torch.from_numpy(x))
    grads = torch.autograd.grad(total.sum(), list(leaves.values()))
    for m in range(2):
        val, g = jax_member(m)
        np.testing.assert_allclose(float(total[m].detach()), float(val), rtol=1e-6)
        for k, tg in zip(leaves, grads):
            np.testing.assert_allclose(to_np(tg[m]), np.asarray(g[k]), rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("jax_use_pallas", [None, True])
def test_decoder_update_matches_jax_and_freezes_a_masked_nan_member(jax_use_pallas):
    """`make_fista_decoder_update` against each of the JAX package's routes
    (its Pallas route in interpret mode for ``True``), member 0 masked and
    its warm start NaN: its decoder and Hessian diagonal stay as they were,
    bit for bit."""
    jens, ens = _pair(seed=4)
    x = _batches(_truth(), 1)[0]
    c = np.abs(np.random.default_rng(5).standard_normal((2, len(x), N))).astype(np.float32) * 0.1
    c[0, 3, 5] = np.nan
    jens.set_update_mask([0.0, 1.0])
    ens.set_update_mask([0.0, 1.0])
    before = jax.device_get(jens.state)
    got = make_fista_decoder_update(num_iter=50)(ens.state, torch.from_numpy(x), torch.from_numpy(c))
    ref = jax.device_get(jax_make_update(num_iter=50, use_pallas=jax_use_pallas)(jens.state, jnp.asarray(x), jnp.asarray(c)))
    dec, hess = to_np(got.params["decoder"]), to_np(got.buffers["hessian_diag"])
    np.testing.assert_array_equal(dec[0], np.asarray(before.params["decoder"][0]))
    np.testing.assert_array_equal(hess[0], np.asarray(before.buffers["hessian_diag"][0]))
    np.testing.assert_array_equal(np.asarray(ref.params["decoder"][0]), dec[0])
    np.testing.assert_allclose(dec[1], np.asarray(ref.params["decoder"][1]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(hess[1], np.asarray(ref.buffers["hessian_diag"][1]), rtol=0, atol=1e-7)
    assert not np.allclose(dec[1], np.asarray(before.params["decoder"][1]))
    np.testing.assert_allclose(np.linalg.norm(dec[1], axis=-1), 1.0, atol=1e-6)
    # everything but the decoder and the Hessian diagonal passes through
    assert got.opt_state is ens.state.opt_state and got.step == ens.state.step
    assert got.params["encoder"] is ens.state.params["encoder"]


def test_decoder_update_is_cached_by_its_arguments():
    assert make_fista_decoder_update(50) is make_fista_decoder_update(50)
    assert make_fista_decoder_update(50) is not make_fista_decoder_update(50, tol=1e-3)


def test_chained_steps_match_jax_and_learn_the_planted_features():
    """30 gradient steps, each followed by the decoder update on the same
    batch warm-started from the step's code, on both sides: the losses fall,
    and both packages' decoders move toward the planted features alike
    (mirrors tests/test_fista.py::test_functional_fista_trains_in_ensemble)."""
    truth = _truth()
    jens, ens = _pair(seed=2)
    jfn, tfn = jax_make_update(num_iter=50), make_fista_decoder_update(num_iter=50)

    def mmcs(dec):
        dec = dec / np.linalg.norm(dec, axis=-1, keepdims=True)
        return (dec @ truth.T).max(-1).mean(-1)

    start = mmcs(to_np(ens.state.params["decoder"]))
    xs = _batches(truth, 30, seed=9)
    first = None
    for x in xs:
        jl, jaux = jens.step_batch(jnp.asarray(x))
        jens.state = jfn(jens.state, jnp.asarray(x), jaux["c"])
        tl, taux = ens.step_batch(torch.from_numpy(x))
        ens.state = tfn(ens.state, torch.from_numpy(x), taux["c"])
        np.testing.assert_allclose(to_np(tl["loss"]), np.asarray(jl["loss"]), rtol=1e-5)
        first = to_np(tl["loss"]) if first is None else first
    assert (to_np(tl["loss"]) < first).all()
    jd, td = np.asarray(jax.device_get(jens.state.params["decoder"])), to_np(ens.state.params["decoder"])
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-5)
    np.testing.assert_allclose(to_np(ens.state.buffers["hessian_diag"]),
                               np.asarray(jax.device_get(jens.state.buffers["hessian_diag"])), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(mmcs(td), mmcs(jd), rtol=0, atol=1e-5)
    assert (mmcs(td) > start + 5e-3).all(), (start, mmcs(td))


def test_train_loop_runs_the_decoder_update_every_batch():
    """`ensemble_train_loop` detects the update from the signature, forces
    one batch per step, and honours the mask (mirrors
    tests/test_telemetry.py::test_update_mask_freezes_fista_decoder_update)."""
    x = torch.from_numpy(_batches(_truth(), 2, b=64).reshape(128, D))
    ens = build_ensemble(FunctionalFista, 0, L1, optimizer_kwargs={"learning_rate": LR}, activation_size=D,
                         n_dict_components=N, device="cpu")
    ens.set_update_mask([0.0, 1.0])
    dec0, hess0 = ens.state.params["decoder"].clone(), ens.state.buffers["hessian_diag"].clone()
    fk.reset_launches()
    loss = ensemble_train_loop(ens, x, 64, key=1, fista_iters=10, dead_check=False)
    assert ens.state.step == 2 and torch.isfinite(loss["loss"]).all()
    assert torch.equal(ens.state.params["decoder"][0], dec0[0])
    assert torch.equal(ens.state.buffers["hessian_diag"][0], hess0[0])
    assert not torch.allclose(ens.state.params["decoder"][1], dec0[1])
    assert bool((ens.state.buffers["hessian_diag"][1] > 0).any())
    torch.testing.assert_close(torch.linalg.vector_norm(ens.state.params["decoder"][1], dim=-1),
                               torch.ones(N), rtol=0, atol=1e-6)
    assert fk.LAUNCHES == {"fista_solve": 0}  # CPU tensors: the plain version


def test_state_dict_round_trip_keeps_the_hessian():
    ens = build_ensemble(FunctionalFista, 0, L1, activation_size=D, n_dict_components=N, device="cpu")
    x = torch.from_numpy(_batches(_truth(), 2))
    _, aux = ens.step_batch(x[0])
    ens.state = make_fista_decoder_update(num_iter=10)(ens.state, x[0], aux["c"])
    clone = Ensemble.from_state(ens.state_dict(), device="cpu")
    assert clone.sig is FunctionalFista
    assert torch.equal(clone.state.buffers["hessian_diag"], ens.state.buffers["hessian_diag"])
    assert bool(clone.state.buffers["hessian_diag"].any())
    la, aux_a = ens.step_batch(x[1])
    lb, aux_b = clone.step_batch(x[1])
    assert torch.equal(la["loss"], lb["loss"]) and torch.equal(aux_a["c"], aux_b["c"])
    for k in ens.state.params:
        assert torch.equal(ens.state.params[k], clone.state.params[k]), k


@pytest.mark.parametrize("loss", ["loss2", "fista_loss"])
def test_gradients_through_the_solve_are_not_ported(loss):
    """`FunctionalFista.loss2` and `fista_loss` differentiate through the
    unrolled plain solve (10 iterations), as the JAX package's do through
    its plain jnp loop (no kernel, no custom backward): values against JAX's
    rtol 1e-5 and gradients against `jax.grad` atol 1e-6 of a largest entry
    ~0.1 (f32 sums of the same terms in another order, carried through 10
    iterations and the power iteration for η)."""
    jfista = importlib.import_module("sparse_coding__tpu.models.fista").FunctionalFista
    rng = np.random.default_rng(7)
    enc = rng.standard_normal((2, N, D)).astype(np.float32)
    bias = (0.1 * rng.standard_normal((2, N))).astype(np.float32)
    x = _batches(_truth(), 1, b=32)[0]
    c0 = (0.1 * np.abs(rng.standard_normal((2, len(x), N)))).astype(np.float32)
    l1, bd = np.array([1e-3, 1e-2], np.float32), np.array([1e-3, 0.0], np.float32)
    leaves = {"encoder": torch.from_numpy(enc).requires_grad_(True),
              "encoder_bias": torch.from_numpy(bias).requires_grad_(True), "decoder": torch.from_numpy(enc.copy())}
    buffers = {"l1_alpha": torch.from_numpy(l1), "bias_decay": torch.from_numpy(bd)}
    if loss == "loss2":
        total, (data, aux) = FunctionalFista.loss2(leaves, buffers, torch.from_numpy(x), fista_iters=10)
        assert sorted(data) == ["l_fista_reconstruction", "l_l1", "l_reconstruction", "loss"] and "c" in aux
    else:
        total, (data, aux) = FunctionalFista.fista_loss(leaves, buffers, torch.from_numpy(x), torch.from_numpy(c0),
                                                        fista_iters=10)
        assert sorted(data) == ["loss"] and aux["c_fista"].shape == (2, len(x), N)
    grads = torch.autograd.grad(total.sum(), [leaves["encoder"], leaves["encoder_bias"]], allow_unused=True)
    for m in range(2):
        p = {"encoder": jnp.asarray(enc[m]), "encoder_bias": jnp.asarray(bias[m]), "decoder": jnp.asarray(enc[m])}
        b = {"l1_alpha": jnp.asarray(l1[m]), "bias_decay": jnp.asarray(bd[m])}
        if loss == "loss2":
            fn = lambda p: jfista.loss2(p, b, jnp.asarray(x), fista_iters=10)[0]  # noqa: E731
        else:
            fn = lambda p: jfista.fista_loss(p, b, jnp.asarray(x), jnp.asarray(c0[m]), fista_iters=10)[0]  # noqa: E731
        val, g = jax.value_and_grad(fn)(p)
        np.testing.assert_allclose(float(total[m].detach()), float(val), rtol=1e-5)
        np.testing.assert_allclose(to_np(grads[0][m]), np.asarray(g["encoder"]), rtol=0, atol=1e-6)
        if loss == "loss2":
            np.testing.assert_allclose(to_np(grads[1][m]), np.asarray(g["encoder_bias"]), rtol=0, atol=1e-6)
        else:
            assert grads[1] is None and not np.asarray(g["encoder_bias"]).any()
        assert np.abs(np.asarray(g["encoder"])).max() > 1e-3


def test_exports_load_both_ways(tmp_path):
    from sparse_coding__tpu.metrics import standard as jm
    from sparse_coding__tpu.models.fista import Fista as JaxFistaDict
    from sparse_coding__tpu.train.checkpoint import load_learned_dicts as jax_load
    from sparse_coding__tpu.train.checkpoint import save_learned_dicts as jax_save
    from sparse_coding__tpu_torch.metrics import standard as tm
    from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts, save_learned_dicts

    truth = _truth()
    x = _batches(truth, 1, b=200)[0]
    jens, ens = _pair()
    xb = _batches(truth, 1, seed=3)[0]
    _, aux = ens.step_batch(torch.from_numpy(xb))
    ens.state = make_fista_decoder_update(num_iter=20)(ens.state, torch.from_numpy(xb), aux["c"])
    # the port's UntiedSAE and Fista exports, re-evaluated by the JAX package
    lds = ens.to_learned_dicts() + [Fista(torch.from_numpy(truth), torch.full((N,), -0.1))]
    assert [type(ld) for ld in lds] == [UntiedSAE, UntiedSAE, Fista]
    save_learned_dicts(tmp_path / "port.pkl", [(ld, {"i": i}) for i, ld in enumerate(lds)])
    records = pickle.loads((tmp_path / "port.pkl").read_bytes())
    assert [r["class"] for r in records] == ["sparse_coding__tpu.models.learned_dict.UntiedSAE"] * 2 + [
        "sparse_coding__tpu.models.fista.Fista"]
    jlds = [ld for ld, _ in jax_load(tmp_path / "port.pkl", verify=True)]
    assert [type(ld) for ld in jlds][2] is JaxFistaDict
    assert [type(ld).__module__ + "." + type(ld).__name__ for ld in jlds] == [r["class"] for r in records]
    got = tm.evaluate_dicts(lds, torch.from_numpy(x))
    ref = jm.evaluate_dicts(jlds, jnp.asarray(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["fvu"], r["fvu"], rtol=1e-5)
        assert abs(g["l0"] - r["l0"]) <= 1.0 / len(x)
    # the JAX package's exports, loaded by the port; Fista's exact inference alike
    jlds = jens.to_learned_dicts() + [JaxFistaDict(jnp.asarray(truth), jnp.full((N,), -0.1))]
    jax_save(tmp_path / "jax.pkl", [(ld, {"i": i}) for i, ld in enumerate(jlds)])
    loaded = load_learned_dicts(tmp_path / "jax.pkl", verify=True, device="cpu")
    assert [type(ld) for ld, _ in loaded] == [UntiedSAE, UntiedSAE, Fista]
    for jld, (tld, hp) in zip(jlds, loaded):
        tc, jc = to_np(tld.encode(torch.from_numpy(x))), np.asarray(jld.encode(jnp.asarray(x)))
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-6)
    c0 = np.zeros((len(x), N), np.float32)
    ta, tr = loaded[-1][0].fista(torch.from_numpy(x), torch.from_numpy(c0), 1e-3, num_iter=100)
    ja, jr = jlds[-1].fista(jnp.asarray(x), jnp.asarray(c0), jnp.asarray(1e-3), num_iter=100)
    np.testing.assert_allclose(to_np(ta), np.asarray(ja), rtol=0, atol=1e-5)
    np.testing.assert_allclose(to_np(tr), np.asarray(jr), rtol=0, atol=1e-5)
    assert float((tr**2).mean()) < 1e-2 * float((torch.from_numpy(x) ** 2).mean())


def test_fista_export_loads_in_a_process_that_imports_only_the_checkpoint_module(tmp_path):
    from sparse_coding__tpu_torch.train.checkpoint import save_learned_dicts

    save_learned_dicts(tmp_path / "e.pkl", [(Fista(torch.from_numpy(_truth()), torch.zeros(N)), {})])
    code = (
        "from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts\n"
        f"lds = load_learned_dicts({str(tmp_path / 'e.pkl')!r}, verify=True, device='cpu')\n"
        "print([type(ld).__name__ for ld, _ in lds])\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "['Fista']"
