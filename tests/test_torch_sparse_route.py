"""Which route of K2/K3 each fused entry asks for, on the CPU.

The TopK step's backward takes the sparse route (`sparse=True`: the kernel
that touches only the code's non-zeros) and the tied steps the dense one.
The caller picks it statically; these tests record the keyword with a
wrapper around the real entry point, so no data decides the route. On CPU
tensors both routes run the same plain versions: the TopK-vs-JAX parity of
tests/test_torch_topk_kernels.py holds unchanged. The card-side checks of
the sparse kernels are in tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

from _torch_moments import same_bits
from sparse_coding__tpu_torch import TopKEncoderApprox, build_ensemble
from sparse_coding__tpu_torch.models.sae import FunctionalTiedSAE
from sparse_coding__tpu_torch.ops import _build
from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
from sparse_coding__tpu_torch.ops import topk_kernel as kk
from sparse_coding__tpu_torch.utils.optim import QuantMoment

M, B, N, D = 2, 256, 512, 128
KS = (7, 31)
HP = (1e-3, 0.9, 0.999, 1e-8)  # Adam: lr, b1, b2, eps


@pytest.fixture
def routes(monkeypatch):
    """Records (entry, sparse keyword) of every K2/K3 wrapper call, and makes
    sure no call reaches the kernel build (CPU tensors: plain versions)."""
    seen = []
    for name in ("tied_sae_bwd_adam", "tied_sae_bwd_grads"):
        real = getattr(tk, name)

        def record(*a, _real=real, _name=name, **kw):
            seen.append((_name, kw.get("sparse", False)))
            return _real(*a, **kw)

        monkeypatch.setattr(tk, name, record)

    def no_build():
        raise AssertionError("kernel build reached with CPU tensors")

    monkeypatch.setattr(_build, "load", no_build)
    tk.reset_launches()
    kk.reset_launches()
    yield seen
    assert sum(tk.LAUNCHES.values()) == 0 and sum(kk.LAUNCHES.values()) == 0


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    d_raw = torch.from_numpy(rng.standard_normal((M, N, D)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    bias = torch.from_numpy((0.01 * rng.standard_normal((M, N))).astype(np.float32))
    return d_raw, x, bias


def _moments(kind):
    z = torch.zeros((M, N, D))
    if kind == "int8":
        return QuantMoment(q=torch.zeros((M, N, D), dtype=torch.int8), scale=torch.ones((M, N))), z.bfloat16()
    return z, z.clone()


def _bc():
    return torch.tensor([[0.1, 0.001]] * M)


@pytest.mark.parametrize("tier", ["float32", "int8"])
def test_topk_adam_step_asks_for_the_sparse_k2(routes, tier):
    d_raw, x, _ = _inputs()
    mu, nu = _moments(tier)
    kk.topk_adam_step_stacked(d_raw, mu, nu, x, torch.tensor(KS), _bc(), 1, *HP)
    assert routes == [("tied_sae_bwd_adam", True)]


def test_topk_grads_asks_for_the_sparse_k3(routes):
    d_raw, x, _ = _inputs(1)
    kk.topk_grads_stacked(d_raw, torch.tensor(KS), x)
    assert routes == [("tied_sae_bwd_grads", True)]


@pytest.mark.parametrize("recompute_code", [False, True])
def test_tied_adam_step_keeps_the_dense_k2(routes, recompute_code):
    d_raw, x, bias = _inputs(2)
    mu, nu = _moments("float32")
    tk.tied_sae_adam_step_stacked(d_raw, bias, mu, nu, x, torch.tensor([1e-3, 3e-3]), _bc(), 1, *HP,
                                  recompute_code=recompute_code)
    assert routes == [("tied_sae_bwd_adam", False)]


def test_tied_grads_keep_the_dense_k3(routes):
    d_raw, x, bias = _inputs(3)
    nrm = torch.sqrt(torch.sum(d_raw * d_raw, dim=-1))
    tk.tied_sae_grads_stacked(d_raw / nrm[..., None], nrm, bias, x, torch.tensor([1e-3, 3e-3]))
    assert routes == [("tied_sae_bwd_grads", False)]


@pytest.mark.parametrize("sig,hparams,dims,entry", [
    (TopKEncoderApprox, [{"sparsity": k} for k in KS], dict(d_activation=D, n_features=N, sparsity_cap=max(KS)), True),
    (FunctionalTiedSAE, [{"l1_alpha": a} for a in (1e-3, 3e-3)], dict(activation_size=D, n_dict_components=N), False),
])
def test_ensemble_steps_take_their_path_route(routes, sig, hparams, dims, entry):
    """A fused step (K2) and a masked step (fused grads, K3) of a built
    ensemble: TopK asks for the sparse route both times, tied for the dense."""
    ens = build_ensemble(sig, 0, hparams, optimizer_kwargs={"learning_rate": 1e-3}, compute_dtype="bfloat16",
                         device="cpu", **dims)
    assert ens.fused and ens.fused_adam is not None
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, B, D)).astype(np.float32))
    ens.step_batch(x[0])
    ens.set_update_mask([1.0, 0.0])
    ens.step_batch(x[1])
    assert routes == [("tied_sae_bwd_adam", entry), ("tied_sae_bwd_grads", entry)]


def _bwd_args(seed=5):
    d_raw, x, _ = _inputs(seed)
    xb = x.bfloat16()
    nrm = torch.sqrt(torch.sum(d_raw * d_raw, dim=-1))
    db = (d_raw / nrm[..., None]).bfloat16()
    s, thresh = kk.topk_scores(xb, db, torch.tensor(KS, dtype=torch.int32))
    c, dxh, _ = kk.topk_decode(s, thresh, db, xb, 2.0 / (B * D))
    return xb, dxh, c, nrm, d_raw, db


def test_sparse_route_on_cpu_tensors_is_the_same_plain_version(routes):
    """Both routes run the same plain functions on the CPU: bit-equal
    results, no launch, no build."""
    xb, dxh, c, nrm, d_raw, db = _bwd_args()
    l1b = torch.zeros(M)
    mu, nu = _moments("float32")
    outs = [tk.tied_sae_bwd_adam(xb, dxh, c, nrm, d_raw.clone(), mu.clone(), nu.clone(), l1b, _bc(), *HP,
                                 sparse=sparse) for sparse in (False, True)]
    assert all(same_bits(a, b) for a, b in zip(*outs))
    g = [tk.tied_sae_bwd_grads(xb, dxh, c, nrm, db, l1b, sparse=sparse) for sparse in (False, True)]
    assert all(torch.equal(a, b) for a, b in zip(*g))


def test_wrappers_refuse_arguments_they_cannot_take():
    """The sparse route walks the stored code: with the code to be rebuilt
    (c=None) it raises before any device dispatch, as K3 does without a
    code; so the refusal shows on the CPU as on the card."""
    xb, dxh, c, nrm, d_raw, db = _bwd_args(6)
    l1b = torch.zeros(M)
    mu, nu = _moments("float32")
    bias = torch.zeros((M, N))
    with pytest.raises(ValueError, match="sparse route needs the stored code"):
        tk.tied_sae_bwd_adam(xb, dxh, None, nrm, d_raw, mu, nu, l1b, _bc(), *HP, bias=bias, sparse=True)
    with pytest.raises(ValueError, match="needs the stored code"):
        tk.tied_sae_bwd_grads(xb, dxh, None, nrm, db, l1b, sparse=True)
    # the dense route still rebuilds the code from the bias
    out = tk.tied_sae_bwd_adam(xb, dxh, None, nrm, d_raw.clone(), mu, nu, l1b, _bc(), *HP, bias=bias)
    assert out[0].shape == (M, N, D)
