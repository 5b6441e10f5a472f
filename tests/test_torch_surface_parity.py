"""The port's import surface where it was short of the reference (ROADMAP
C5–C7), each piece against the JAX function on the CPU, from the same
numpy inputs:

  - the chunk store's ``iter_chunks(center=)`` and ``n_chunks``: the same
    chunks, bit for bit (one float32 subtraction each side);
  - ``FunctionalTiedSAE.center`` / ``uncenter`` on every combination of
    centring buffers: within 1e-5 of JAX's (one float32 matmul each side),
    and ``uncenter(center(x))`` within 1e-5 of x (orthogonal rotations);
  - ``TraceTrigger(on_anomaly=, anomaly_windows=)``: the same captures,
    step for step, with both packages' profilers stubbed;
  - ``ensemble_train_loop(fista_update=)``: False leaves the decoder to the
    gradient step alone, None runs the decoder update after it, as JAX's
    loop does (decoders within 1e-6: the two loops permute the batch's rows
    differently, and the sums follow the row order; 7e-9 and 6e-8 seen);
  - ``LearnedDict.to_device``: the same encodings as JAX's moved dict
    (within 1e-6), a copy that leaves the original as it was;
  - ``TopKEncoder.encode`` in JAX's signature ``(batch, buffers,
    normed_dict, cap)``: the same codes (values within 1e-5, the same
    support);
  - the single-model ``fused_grads``: the stacked entry's member, bit for bit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_profiler_stub import stub_profiler
from sparse_coding__tpu import build_ensemble as jax_build_ensemble
from sparse_coding__tpu.data.chunks import ChunkStore as JaxChunkStore
from sparse_coding__tpu.data.chunks import save_chunk
from sparse_coding__tpu.models import FunctionalFista as JaxFista
from sparse_coding__tpu.models import FunctionalTiedSAE as JaxTiedSAE
from sparse_coding__tpu.models import TiedSAE as JaxTiedLD
from sparse_coding__tpu.models import TopKEncoder as JaxTopK
from sparse_coding__tpu.telemetry.profiling import TraceTrigger as JaxTraceTrigger
from sparse_coding__tpu.train import ensemble_train_loop as jax_train_loop
from sparse_coding__tpu_torch import FunctionalFista, FunctionalTiedSAE, TopKEncoder, TopKEncoderApprox, build_ensemble
from sparse_coding__tpu_torch.data.chunks import ChunkStore
from sparse_coding__tpu_torch.interop import state_from_jax_numpy
from sparse_coding__tpu_torch.models.learned_dict import Identity, TiedSAE, _norm_rows
from sparse_coding__tpu_torch.telemetry.profiling import TraceTrigger
from sparse_coding__tpu_torch.train import ensemble_train_loop


def test_iter_chunks_center_and_n_chunks_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(3):
        save_chunk(tmp_path, i, rng.standard_normal((32, 8)).astype(np.float32))
    center = rng.standard_normal(8).astype(np.float32)
    js, ts = JaxChunkStore(tmp_path), ChunkStore(tmp_path)
    assert ts.n_chunks == js.n_chunks == len(ts) == 3
    want = [np.asarray(x) for x in js.iter_chunks([2, 0, 1], center=jnp.asarray(center))]
    got = [x.numpy() for x in ts.iter_chunks([2, 0, 1], device="cpu", center=torch.from_numpy(center))]
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # a float64 host vector is taken as float32, as JAX's device arrays are
    plain = next(iter(ts.iter_chunks([1], device="cpu")))
    got64 = next(iter(ts.iter_chunks([1], device="cpu", center=center.astype(np.float64))))
    assert got64.dtype == torch.float32
    torch.testing.assert_close(got64, plain - torch.from_numpy(center), rtol=0, atol=0)


@pytest.mark.parametrize("parts", ["t", "r", "s", "trs"])
def test_uncenter_inverts_center_as_jax(parts):
    rng = np.random.default_rng(1)
    M, B, D = 2, 5, 8
    trans = rng.standard_normal((M, D)).astype(np.float32) if "t" in parts else None
    rot = np.stack([np.linalg.qr(rng.standard_normal((D, D)))[0] for _ in range(M)]).astype(np.float32) \
        if "r" in parts else None
    scale = rng.uniform(0.5, 2.0, (M, D)).astype(np.float32) if "s" in parts else None
    x = rng.standard_normal((B, D)).astype(np.float32)

    def bufs(m=None, lib=torch.from_numpy):
        pick = (lambda a: a) if m is None else (lambda a: a[m])
        return {k: None if v is None else lib(pick(v))
                for k, v in (("center_trans", trans), ("center_rot", rot), ("center_scale", scale))}

    c = FunctionalTiedSAE.center(bufs(), torch.from_numpy(x))
    u = FunctionalTiedSAE.uncenter(bufs(), c)
    for m in range(M):
        jb = bufs(m, jnp.asarray)
        cj = JaxTiedSAE.center(jb, jnp.asarray(x))
        uj = JaxTiedSAE.uncenter(jb, cj)
        np.testing.assert_allclose(c[m].numpy(), np.asarray(cj), rtol=0, atol=1e-5)
        np.testing.assert_allclose(u[m].numpy(), np.asarray(uj), rtol=0, atol=1e-5)
        np.testing.assert_allclose(u[m].numpy(), x, rtol=0, atol=1e-5)


def _stub_jax_profiler(monkeypatch):
    calls = {"started": [], "stopped": 0, "active": None}

    def start(log_dir, create_perfetto_link=False):
        if calls["active"] is not None:
            return False
        calls["active"] = log_dir
        calls["started"].append(log_dir)
        return True

    def stop():
        d, calls["active"] = calls["active"], None
        calls["stopped"] += d is not None
        return d

    trace_mod = importlib.import_module("sparse_coding__tpu.utils.trace")
    monkeypatch.setattr(trace_mod, "start_trace_safe", start)
    monkeypatch.setattr(trace_mod, "stop_trace_safe", stop)
    return calls


@pytest.mark.parametrize("on_anomaly,windows", [(True, 1), (True, 3), (False, 1), (False, 3)])
def test_trace_trigger_anomaly_keywords_behave_as_jax(tmp_path, monkeypatch, on_anomaly, windows):
    """An anomaly at step 3, then boundaries 4..8, then a second anomaly:
    the same capture (or none), active over the same boundaries, in the
    same directory, and the second anomaly never arms."""
    runs = {}
    for name, cls, calls in (("jax", JaxTraceTrigger, _stub_jax_profiler(monkeypatch)),
                             ("port", TraceTrigger, stub_profiler(monkeypatch))):
        tt = cls(out_dir=str(tmp_path / name), on_anomaly=on_anomaly, anomaly_windows=windows)
        fired = tt.fire(step=3)
        trail = [tt.active]
        for step in range(4, 9):
            tt.on_step(step)
            trail.append(tt.active)
        again = tt.fire(step=9)
        tt.close()
        runs[name] = dict(fired=None if fired is None else fired.rsplit("/", 1)[-1], trail=trail,
                          again=again, started=[d.rsplit("/", 1)[-1] for d in calls["started"]],
                          stopped=calls["stopped"])
    assert runs["port"] == runs["jax"]
    if on_anomaly:
        assert runs["port"]["trail"] == [True] * windows + [False] * (6 - windows)
        assert runs["port"]["started"] == ["trace_anomaly_step3"]
    else:
        assert runs["port"]["fired"] is None and runs["port"]["started"] == []


def _fista_pair():
    """A JAX FunctionalFista ensemble and the port's, carried from its state."""
    hp = [{"l1_alpha": 1e-4}, {"l1_alpha": 1e-3}]
    jens = jax_build_ensemble(JaxFista, jax.random.PRNGKey(2), hp, optimizer_kwargs={"learning_rate": 1e-3},
                              activation_size=16, n_dict_components=32)
    st = jax.device_get(jens.state)
    adam = st.opt_state[0]
    ens = build_ensemble(FunctionalFista, 0, hp, optimizer_kwargs={"learning_rate": 1e-3}, activation_size=16,
                         n_dict_components=32, device="cpu")
    ens.state = state_from_jax_numpy(st.params, st.buffers,
                                     {"count": np.asarray(adam.count), "mu": dict(adam.mu), "nu": dict(adam.nu)},
                                     step=int(st.step), device="cpu")
    return jens, ens


@pytest.mark.parametrize("fista_update", [False, None])
def test_train_loop_fista_update_keyword_as_jax(fista_update):
    rng = np.random.default_rng(3)
    truth = rng.standard_normal((32, 16)).astype(np.float32)
    truth /= np.linalg.norm(truth, axis=-1, keepdims=True)
    x = ((rng.uniform(0.5, 1.5, (128, 32)) * (rng.uniform(size=(128, 32)) < 0.1)) @ truth).astype(np.float32)
    jens, ens = _fista_pair()
    d0 = ens.state.params["decoder"].clone()
    jax_train_loop(jens, jnp.asarray(x), 128, jax.random.PRNGKey(1), fista_update=fista_update, fista_iters=10,
                   dead_check=False)
    ensemble_train_loop(ens, torch.from_numpy(x), 128, key=1, fista_update=fista_update, fista_iters=10,
                        dead_check=False)
    jd = np.asarray(jax.device_get(jens.state.params["decoder"]))
    td = ens.state.params["decoder"].numpy()
    assert ens.state.step == int(jens.state.step) == 1
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-6)
    norms = np.linalg.norm(td, axis=-1)
    if fista_update is False:  # Adam's first step alone: each element moves by about lr, rows not renormalised
        assert np.abs(td - d0.numpy()).max() <= 1.01e-3 and not np.allclose(norms, 1.0, atol=1e-3)
    else:  # the decoder update's basis step leaves unit rows
        np.testing.assert_allclose(norms, 1.0, rtol=0, atol=1e-6)


def test_learned_dict_to_device_encodes_as_jax():
    rng = np.random.default_rng(4)
    enc, bias = rng.standard_normal((32, 16)).astype(np.float32), rng.standard_normal(32).astype(np.float32) * 0.1
    trans = rng.standard_normal(16).astype(np.float32)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    jld = JaxTiedLD(jnp.asarray(enc), jnp.asarray(bias), centering=(jnp.asarray(trans), None, None),
                    norm_encoder=True).to_device(jax.devices("cpu")[0])
    ld = TiedSAE(torch.from_numpy(enc), torch.from_numpy(bias), centering=(torch.from_numpy(trans), None, None),
                 norm_encoder=True)
    moved = ld.to_device("cpu")
    assert moved is not ld and type(moved) is TiedSAE and moved.n_feats == 32
    np.testing.assert_allclose(moved.encode(moved.center(torch.from_numpy(x))).numpy(),
                               np.asarray(jld.encode(jld.center(jnp.asarray(x)))), rtol=0, atol=1e-6)
    assert torch.equal(ld.encoder, torch.from_numpy(enc))
    ident = Identity(16, device="cpu").to_device(torch.device("cpu"))
    assert ident.device == torch.device("cpu") and torch.equal(ident.encode(torch.from_numpy(x)), torch.from_numpy(x))


def test_topk_encode_takes_jax_signature_and_codes():
    rng = np.random.default_rng(5)
    M, B, N, D, cap = 2, 16, 32, 8, 6
    dictionary = rng.standard_normal((M, N, D)).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    ks = np.array([3, 6], np.int32)
    nd = _norm_rows(torch.from_numpy(dictionary))
    buffers = {"sparsity": torch.from_numpy(ks), "topk_cap": torch.zeros((M, cap), dtype=torch.int8)}
    got = TopKEncoder.encode(torch.from_numpy(x), buffers, nd, cap)
    assert got.shape == (M, B, N)
    for m in range(M):
        want = JaxTopK.encode(jnp.asarray(x), {"sparsity": jnp.asarray(ks[m]), "topk_cap": jnp.zeros((cap,), jnp.int8)},
                              jnp.asarray(nd[m].numpy()), cap)
        want = np.asarray(want)
        np.testing.assert_array_equal(got[m].numpy() != 0, want != 0)
        np.testing.assert_allclose(got[m].numpy(), want, rtol=0, atol=1e-5)
        assert ((want != 0).sum(-1) <= ks[m]).all()


@pytest.mark.parametrize("sig", ["tied", "topk"])
def test_fused_grads_is_one_member_of_the_stacked_grads(sig):
    if sig == "tied":
        ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": 1e-3}, {"l1_alpha": 3e-3}], activation_size=128,
                             n_dict_components=256, compute_dtype="bfloat16", device="cpu")
        cls = FunctionalTiedSAE
    else:
        ens = build_ensemble(TopKEncoderApprox, 0, [{"sparsity": 4}, {"sparsity": 8}], d_activation=128,
                             n_features=256, sparsity_cap=8, compute_dtype="bfloat16", device="cpu")
        cls = TopKEncoderApprox
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((64, 128)).astype(np.float32))
    params, buffers = ens.state.params, ens.state.buffers
    grads, losses = cls.fused_grads_stacked(params, buffers, x)
    for m in range(2):
        g1, l1 = cls.fused_grads({k: v[m] for k, v in params.items()},
                                 {k: v[m] if isinstance(v, torch.Tensor) else v for k, v in buffers.items()}, x)
        assert set(g1) == set(grads) and set(l1) == set(losses)
        for k in grads:
            assert torch.equal(g1[k], grads[k][m]), k
        for k in losses:
            assert torch.equal(l1[k], losses[k][m]), k
