"""The port's TopK k-sweep slice against the JAX package, from the same weights.

The JAX ensemble's state is carried across with `interop.state_from_jax_numpy`
and both sides step on the same numpy batches. Tolerances, and why:
  - f32 (autograd path): losses rtol 1e-5; params within 1e-2 lr per step —
    Adam maps gradient noise near |g| ~ eps to updates bounded by lr;
  - bf16 fused path: losses rtol 1e-3 (bf16 roundings of s, dxh and dc may
    flip); the dictionary within 2 lr per step;
  - selection helpers and exports: exact where the scores are the same f32
    values (ties broken toward the lower index on both sides), FVU rtol 1e-5
    and L0 to one entry in the batch where the matmuls sum in another order.
"""

import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import to_np
from sparse_coding__tpu import build_ensemble as jax_build_ensemble
from sparse_coding__tpu.ensemble import _mask_updates, stack_pytrees
from sparse_coding__tpu.models import topk as jtopk
from sparse_coding__tpu.models.topk import TopKEncoder as JaxTopK
from sparse_coding__tpu.models.topk import TopKEncoderApprox as JaxTopKApprox
from sparse_coding__tpu.models.topk import TopKLearnedDict as JaxTopKLearnedDict
from sparse_coding__tpu_torch import Ensemble, TopKEncoder, TopKEncoderApprox, build_ensemble
from sparse_coding__tpu_torch.interop import state_from_jax_numpy
from sparse_coding__tpu_torch.models import topk as ttopk
from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
from sparse_coding__tpu_torch.ops import topk_kernel as kk

REPO = Path(__file__).resolve().parents[1]
LR = 1e-3
KS = (7, 31)
SIGS = {"TopKEncoder": (JaxTopK, TopKEncoder), "TopKEncoderApprox": (JaxTopKApprox, TopKEncoderApprox)}


def _carry(jax_params, jax_buffers, jax_opt_state=None, step=0):
    opt = None
    if jax_opt_state is not None:
        a = jax_opt_state[0]
        opt = {"count": np.asarray(a.count), "mu": dict(a.mu), "nu": dict(a.nu)}
    return state_from_jax_numpy(jax_params, jax_buffers, opt, step=step, device="cpu")


def _batches(seed, k, b, d):
    return np.random.default_rng(seed).standard_normal((k, b, d)).astype(np.float32)


def _ks(ks):
    return [{"sparsity": k} for k in ks]


@pytest.mark.parametrize("name", sorted(SIGS))
def test_f32_slice_matches_jax_ensemble(name):
    jsig, tsig = SIGS[name]
    D, N, B, ks = 32, 64, 64, (4, 8)
    kw = dict(optimizer_kwargs={"learning_rate": LR}, d_activation=D, n_features=N, sparsity_cap=max(ks))
    jens = jax_build_ensemble(jsig, jax.random.PRNGKey(0), _ks(ks), **kw)
    ens = build_ensemble(tsig, 0, _ks(ks), device="cpu", **kw)
    assert not jens.fused and not ens.fused
    st = jax.device_get(jens.state)
    ens.state = _carry(st.params, st.buffers, st.opt_state)
    xs = _batches(1, 7, B, D)
    for i in range(3):
        jl, _ = jens.step_batch(jnp.asarray(xs[i]))
        tl, aux = ens.step_batch(torch.from_numpy(xs[i]))
        np.testing.assert_allclose(to_np(tl["loss"]), np.asarray(jl["loss"]), rtol=1e-5)
        assert aux["c"].shape == (2, B, N)
    jl = jens.step_scan(jnp.asarray(xs[3:]))
    tl = ens.step_scan(torch.from_numpy(xs[3:]))
    assert tl["loss"].shape == (4, 2)
    np.testing.assert_allclose(to_np(tl["loss"]), np.asarray(jl["loss"]), rtol=1e-5)
    jp = jax.device_get(jens.state.params)
    assert np.abs(to_np(ens.state.params["dict"]) - np.asarray(jp["dict"])).max() <= 1e-2 * LR * 7
    np.testing.assert_array_equal(to_np(ens.state.opt_state.count), [7, 7])


def _jax_stacked(D, N, seed=0):
    models = [
        JaxTopKApprox.init(k, D, N, sparsity=s, sparsity_cap=max(KS))
        for k, s in zip(jax.random.split(jax.random.PRNGKey(seed), len(KS)), KS)
    ]
    return stack_pytrees([p for p, _ in models]), stack_pytrees([b for _, b in models])


def _port_ensemble(params, buffers, opt_state, D, N, mu_dtype=None):
    ens = build_ensemble(
        TopKEncoderApprox, 0, _ks(KS), optimizer_kwargs={"learning_rate": LR, "mu_dtype": mu_dtype},
        compute_dtype="bfloat16", d_activation=D, n_features=N, sparsity_cap=max(KS), device="cpu",
    )
    ens.state = _carry(jax.device_get(params), jax.device_get(buffers), jax.device_get(opt_state))
    return ens


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_bf16_fused_slice_matches_chained_jax_fused_adam_step(mu_dtype):
    D, N, B = 128, 512, 256
    params, buffers = _jax_stacked(D, N)
    tx = optax.adam(LR, mu_dtype=None if mu_dtype is None else jnp.bfloat16)
    opt_state = jax.vmap(tx.init)(params)
    ens = _port_ensemble(params, buffers, opt_state, D, N, mu_dtype)
    assert ens.fused and ens.fused_adam == {"lr": LR, "b1": 0.9, "b2": 0.999, "eps": 1e-8}
    xs = _batches(2, 3, B, D)
    kk.reset_launches()
    for i in range(3):
        params, opt_state, jl = JaxTopKApprox.fused_adam_step(
            params, buffers, jnp.asarray(xs[i]), opt_state, LR, 0.9, 0.999, 1e-8, interpret=True
        )
        tl, aux = ens.step_batch(torch.from_numpy(xs[i]))
        assert aux == {}
        np.testing.assert_allclose(to_np(tl["loss"]), np.asarray(jl["loss"]), rtol=1e-3)
        diff = np.abs(to_np(ens.state.params["dict"]) - np.asarray(params["dict"])).max()
        assert diff <= 2 * LR * (i + 1), (i, diff)
    assert ens.state.opt_state.mu["dict"].dtype == (torch.float32 if mu_dtype is None else torch.bfloat16)
    np.testing.assert_array_equal(to_np(ens.state.opt_state.count), np.asarray(opt_state[0].count))
    assert sum(kk.LAUNCHES.values()) == 0  # CPU tensors: the plain versions ran


def test_masked_topk_takes_fused_grads_and_freezes_the_member():
    D, N, B = 128, 512, 256
    params, buffers = _jax_stacked(D, N, seed=1)
    tx = optax.adam(LR)
    opt_state = jax.vmap(tx.init)(params)
    ens = _port_ensemble(params, buffers, opt_state, D, N)
    ens.set_update_mask([1.0, 0.0])
    frozen = ens.state.params["dict"][1].clone()
    mask = jnp.asarray([1.0, 0.0])
    xs = _batches(3, 2, B, D)
    for i in range(2):
        grads, jl = JaxTopKApprox.fused_grads_stacked(params, buffers, jnp.asarray(xs[i]), interpret=True)
        upd, opt_state = jax.vmap(tx.update)(grads, opt_state, params)
        params = optax.apply_updates(params, _mask_updates(upd, mask))
        tl, _ = ens.step_batch(torch.from_numpy(xs[i]))
        np.testing.assert_allclose(to_np(tl["loss"]), np.asarray(jl["loss"]), rtol=1e-3)
        diff = np.abs(to_np(ens.state.params["dict"]) - np.asarray(params["dict"])).max()
        assert diff <= 2 * LR * (i + 1), (i, diff)
    assert torch.equal(ens.state.params["dict"][1], frozen)


def test_config4_build_takes_the_fused_kernels():
    """BASELINE config 4 (768 -> 12288, k 1..151, batch 2048) with bf16
    compute reports the fused paths; the shapes are checked on meta tensors,
    so nothing of 7 x 12288 x 768 is allocated."""
    ks = [1, 11, 31, 61, 91, 121, 151]
    models = []
    for k in ks:
        params = {"dict": torch.empty((12288, 768), device="meta")}
        buffers = {
            "sparsity": torch.tensor(k, dtype=torch.int32, device="meta"),
            "topk_cap": torch.empty(151, dtype=torch.int8, device="meta"),
            "recall": torch.empty((), device="meta"),
        }
        models.append((params, buffers))
    ens = Ensemble(models, TopKEncoderApprox, optimizer_kwargs={"learning_rate": LR}, compute_dtype="bfloat16")
    assert ens.fused and ens.fused_adam is not None
    assert TopKEncoderApprox.fused_batch_supported(ens.state.params, 2048)
    assert not TopKEncoderApprox.fused_batch_supported(ens.state.params, 2000)
    assert not Ensemble(models, TopKEncoderApprox, compute_dtype=None).fused
    assert ens.device.type == "meta"


def test_state_dict_round_trip_and_zero_moment_carry():
    """The three parameter-name repairs: `Ensemble.device`, `from_state`'s
    signature map and `state_from_jax_numpy`'s zero moments, on a TopK
    ensemble (their params are {"dict"})."""
    kw = dict(optimizer_kwargs={"learning_rate": LR}, compute_dtype="bfloat16", d_activation=128,
              n_features=512, sparsity_cap=max(KS), device="cpu")
    a = build_ensemble(TopKEncoderApprox, 0, _ks(KS), **kw)
    assert a.device.type == "cpu"
    xs = torch.from_numpy(_batches(6, 2, 256, 128))
    a.step_batch(xs[0])
    b = Ensemble.from_state(a.state_dict(), device="cpu")
    assert b.sig is TopKEncoderApprox and (b.fused, b.fused_adam, b.state.step) == (a.fused, a.fused_adam, 1)
    la, _ = a.step_batch(xs[1])
    lb, _ = b.step_batch(xs[1])
    assert torch.equal(la["loss"], lb["loss"])
    assert torch.equal(a.state.params["dict"], b.state.params["dict"])
    exact = build_ensemble(TopKEncoder, 0, _ks(KS), **kw)
    assert Ensemble.from_state(exact.state_dict(), device="cpu").sig is TopKEncoder

    params, buffers = _jax_stacked(32, 64)
    st = state_from_jax_numpy(jax.device_get(params), jax.device_get(buffers), device="cpu")
    assert st.opt_state.count.tolist() == [0, 0]
    assert st.opt_state.mu["dict"].shape == (2, 64, 32) and not st.opt_state.nu["dict"].any()
    assert st.buffers["sparsity"].dtype == torch.int32 and st.buffers["topk_cap"].shape == (2, max(KS))


def test_l1_warmup_refuses_topk():
    with pytest.raises(ValueError, match="no 'l1_alpha'"):
        build_ensemble(TopKEncoderApprox, 0, _ks(KS), l1_warmup_steps=4, d_activation=32,
                       n_features=64, sparsity_cap=max(KS), device="cpu")


def _tie_scores():
    """f32 score rows with ties straddling the k-th place, negatives, zeros."""
    rng = np.random.default_rng(7)
    s = np.round(rng.standard_normal((6, 16)) * 2) / 2  # a few distinct values: many ties
    s[0, :4] = 1.5
    s[1] = 0.0
    return s.astype(np.float32)


@pytest.mark.parametrize("k", [1, 3, 5, 8])
def test_mask_helpers_match_jax_with_ties(k):
    s = _tie_scores()
    js, ts = jnp.asarray(s), torch.from_numpy(s)
    cap = 8
    pairs = [
        (jtopk.topk_mask_code(js, k), ttopk.topk_mask_code(ts, k)),
        (jtopk.topk_mask_code_capped(js, k, cap), ttopk.topk_mask_code_capped(ts, k, cap)),
        (jtopk.topk_mask_code_approx(js, k, cap, 0.95), ttopk.topk_mask_code_approx(ts, k, cap, 0.95)),
        (jtopk.topk_mask_code_static(js, k), ttopk.topk_mask_code_static(ts, k)),
    ]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_array_equal(to_np(b), np.asarray(a), err_msg=str(i))


def test_export_interop_both_ways(tmp_path):
    from sparse_coding__tpu.metrics import standard as jm
    from sparse_coding__tpu.train.checkpoint import load_learned_dicts as jax_load
    from sparse_coding__tpu.train.checkpoint import save_learned_dicts as jax_save
    from sparse_coding__tpu_torch.metrics import standard as tm
    from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts, save_learned_dicts

    D, N, ks = 32, 64, (4, 8)
    x = _batches(8, 1, 200, D)[0]
    # the port's export, re-evaluated by the JAX package
    ens = build_ensemble(TopKEncoderApprox, 0, _ks(ks), d_activation=D, n_features=N, sparsity_cap=8,
                         device="cpu")
    ens.step_batch(torch.from_numpy(x[:64]))
    lds = ens.to_learned_dicts()
    path = tmp_path / "port.pkl"
    save_learned_dicts(path, [(ld, {"sparsity": k}) for ld, k in zip(lds, ks)])
    records = pickle.loads(path.read_bytes())
    assert [r["class"] for r in records] == ["sparse_coding__tpu.models.topk.TopKLearnedDict"] * 2
    jlds = [ld for ld, _ in jax_load(path, verify=True)]
    assert all(type(ld) is JaxTopKLearnedDict for ld in jlds)
    got = tm.evaluate_dicts(lds, torch.from_numpy(x))
    ref = jm.evaluate_dicts(jlds, jnp.asarray(x))
    for g, r, k in zip(got, ref, ks):
        np.testing.assert_allclose(g["fvu"], r["fvu"], rtol=1e-5)
        assert abs(g["l0"] - r["l0"]) <= 1.0 / len(x)
        assert g["l0"] <= k
    # the JAX package's export, loaded by the port
    jens = jax_build_ensemble(JaxTopKApprox, jax.random.PRNGKey(1), _ks(ks), d_activation=D,
                              n_features=N, sparsity_cap=8)
    jens.step_batch(jnp.asarray(x[:64]))
    jlds = jens.to_learned_dicts()
    jax_save(tmp_path / "jax.pkl", [(ld, {"sparsity": k}) for ld, k in zip(jlds, ks)])
    loaded = load_learned_dicts(tmp_path / "jax.pkl", verify=True, device="cpu")
    for jld, (tld, hp) in zip(jlds, loaded):
        assert type(tld) is ttopk.TopKLearnedDict and tld.sparsity == hp["sparsity"]
        np.testing.assert_array_equal(to_np(tld.dict), np.asarray(jld.dict))
        # the same codes: the support exactly (no near-ties at these sizes),
        # the values to f32 summation order
        tc, jc = to_np(tld.encode(torch.from_numpy(x))), np.asarray(jld.encode(jnp.asarray(x)))
        np.testing.assert_array_equal(tc != 0, jc != 0)
        np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-6)


def test_topk_export_loads_in_a_process_that_imports_only_the_checkpoint_module(tmp_path):
    from sparse_coding__tpu_torch.train.checkpoint import save_learned_dicts

    ens = build_ensemble(TopKEncoder, 0, _ks((2, 3)), d_activation=16, n_features=32, sparsity_cap=3,
                         device="cpu")
    save_learned_dicts(tmp_path / "e.pkl", [(ld, {}) for ld in ens.to_learned_dicts()])
    code = (
        "import sys\n"
        "from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts\n"
        f"lds = load_learned_dicts({str(tmp_path / 'e.pkl')!r}, verify=True, device='cpu')\n"
        "print([(type(ld).__name__, ld.sparsity) for ld, _ in lds])\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[('TopKLearnedDict', 2), ('TopKLearnedDict', 3)]"


def test_topk_trains_over_a_chunk_store(tmp_path):
    """`ensemble_train_loop` over a two-chunk fp16 store on the fused path
    (plain versions on the CPU); the dead-ensemble probe calls the stacked
    `encode`."""
    from sparse_coding__tpu_torch.data.chunks import generate_synthetic_chunks
    from sparse_coding__tpu_torch.data.synthetic import RandomDatasetGenerator
    from sparse_coding__tpu_torch.train.loop import ensemble_train_loop, warn_if_ensemble_dead
    from sparse_coding__tpu_torch.utils import precision as px

    gen = RandomDatasetGenerator(128, 256, 512, 8, 0.99, False, key=0, device="cpu")
    store = generate_synthetic_chunks(gen, tmp_path, 2, chunk_size_gb=1024 * 128 * 2 / 1024**3)
    ens = build_ensemble(TopKEncoderApprox, 0, _ks(KS), optimizer_kwargs={"learning_rate": 1e-3},
                         compute_dtype="bfloat16", d_activation=128, n_features=512, sparsity_cap=max(KS),
                         device="cpu")
    assert ens.fused and ens.fused_adam is not None
    probe = next(gen)

    def loss():
        with torch.no_grad(), px.compute(torch.bfloat16):
            return TopKEncoderApprox.loss(ens.state.params, ens.state.buffers, probe)[0]

    before = loss()
    tk.reset_launches()
    for i, chunk in enumerate(store.iter_chunks([0, 1], device="cpu")):
        last = ensemble_train_loop(ens, chunk, 256, key=i, scan_steps=4)
        assert torch.isfinite(last["loss"]).all()
    assert ens.state.step == 8 and sum(tk.LAUNCHES.values()) == 0
    assert float(loss().mean()) < float(before.mean())
    assert not warn_if_ensemble_dead(ens, probe)
    params, buffers = ens.state.params, ens.state.buffers
    c = TopKEncoderApprox.encode(probe, buffers, ttopk._norm_rows(params["dict"]),
                                 TopKEncoderApprox._cap(params, buffers))
    assert c.shape == (2, 512, 512)
    l0 = (c != 0).sum(-1).float().mean(-1)
    assert (l0 <= torch.tensor(KS)).all()
