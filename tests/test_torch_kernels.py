"""The port's tied-SAE kernel entries (plain versions on the CPU) against the
JAX package's Pallas entries in interpret mode, on the same numpy inputs.

Shapes are those of tests/test_fused_kernel.py: M, B, N, D = 2, 256, 512, 128
(B = 1024 for the batch-tiled accumulating kernel). Tolerances, and why:
  - losses rtol 1e-3: the sums run in another order;
  - c / dxh: within 1 bf16 ulp (or f32 noise across zero), < 0.1% differing:
    summation order moves a few bf16 roundings;
  - gradients and moments: cosine > 0.9999, max error 1e-2 of the max: a
    flipped bf16 rounding of dc moves a few gradient entries;
  - Adam-updated encoder: |diff| <= 2 lr, Adam's bound on one step's update.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_grads_close, bf16_close, to_np
from sparse_coding__tpu.ops import tied_sae_kernel as jk
from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk

M, B, N, D = 2, 256, 512, 128
LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8


def _inputs(seed: int, batch: int = B):
    rng = np.random.default_rng(seed)
    lim = np.sqrt(6.0 / (N + D))
    d_raw = rng.uniform(-lim, lim, (M, N, D)).astype(np.float32)
    bias = (0.01 * rng.standard_normal((M, N))).astype(np.float32)
    x = rng.standard_normal((batch, D)).astype(np.float32)
    l1 = np.asarray([1e-3, 3e-3], np.float32)
    return d_raw, bias, x, l1


def _t(a):
    return torch.from_numpy(np.array(a))


def test_grads_stacked_matches_jax_interpret():
    d_raw, bias, x, l1 = _inputs(0)
    nrm = np.sqrt(np.sum(d_raw * d_raw, axis=-1)).astype(np.float32)
    d_hat = (d_raw / nrm[..., None]).astype(np.float32)
    ref = jk.tied_sae_grads_stacked(
        jnp.asarray(d_hat), jnp.asarray(nrm), jnp.asarray(bias), jnp.asarray(x),
        jnp.asarray(l1), interpret=True,
    )
    got = tk.tied_sae_grads_stacked(_t(d_hat), _t(nrm), _t(bias), _t(x), _t(l1))
    assert_grads_close(got[0], ref[0], "g_enc")
    assert_grads_close(got[1], ref[1], "g_bias")
    for name, a, b in zip(["l_rec", "l_l1_raw"], got[2:], ref[2:]):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-3, err_msg=name)


@pytest.mark.parametrize(
    "mu_dtype,batch,force_accum",
    [
        ("float32", B, False),
        ("bfloat16", B, False),
        ("float32", 1024, True),  # the batch-tiled accumulating kernel (#4)
        ("bfloat16", 1024, True),
    ],
)
def test_adam_step_stacked_matches_jax_interpret(mu_dtype, batch, force_accum):
    d_raw, bias, x, l1 = _inputs(1, batch)
    rng = np.random.default_rng(2)
    mu = (1e-3 * rng.standard_normal((M, N, D))).astype(np.float32)
    nu = (1e-6 * rng.uniform(size=(M, N, D))).astype(np.float32)
    bc = np.tile(np.asarray([[0.1, 0.001]], np.float32), (M, 1))
    jdt = jnp.bfloat16 if mu_dtype == "bfloat16" else jnp.float32
    ref = jk.tied_sae_adam_step_stacked(
        jnp.asarray(d_raw), jnp.asarray(bias), jnp.asarray(mu, jdt), jnp.asarray(nu),
        jnp.asarray(x), jnp.asarray(l1), jnp.asarray(bc), jnp.asarray([7], jnp.int32),
        LR, B1, B2, EPS, interpret=True, force_accum=force_accum,
    )
    tdt = getattr(torch, mu_dtype)
    got = tk.tied_sae_adam_step_stacked(
        _t(d_raw), _t(bias), _t(mu).to(tdt), _t(nu), _t(x), _t(l1), _t(bc), 7, LR, B1, B2, EPS
    )
    assert got[1].dtype == tdt
    assert np.abs(to_np(got[0]) - to_np(ref[0])).max() <= 2 * LR
    assert_grads_close(got[1], ref[1], "mu")
    assert_grads_close(got[2], ref[2], "nu")
    assert_grads_close(got[3], ref[3], "g_bias")
    for name, a, b in zip(["l_rec", "l_l1_raw"], got[4:], ref[4:]):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-3, err_msg=name)


def test_fwd_code_and_cotangent_follow_the_rounding_points():
    """The JAX entries return neither c nor dxh, so the port's are held
    against the Pallas rounding points 1-3 written out in jnp; the decode half
    is checked on the port's own code (the two halves meet at the bf16 c)."""
    d_raw, bias, x, _ = _inputs(3)
    f32, bf16 = jnp.float32, jnp.bfloat16
    dj = jnp.asarray(d_raw)
    nrm = jnp.sqrt(jnp.sum(dj * dj, axis=-1))
    db = (dj / nrm[..., None]).astype(bf16)
    xb = jnp.asarray(x).astype(bf16)
    cpre = jnp.einsum("bd,mnd->mbn", xb, db, preferred_element_type=f32) + jnp.asarray(bias)[:, None, :]
    c_ref = jnp.maximum(cpre, 0.0)
    scale = 2.0 / (B * D)

    # the same bf16 rows on both sides (the two packages' row norms may
    # differ by an ulp, which would move a few roundings of D̂ itself)
    t_db = _t(to_np(db)).to(torch.bfloat16)
    c, dxh, lrec, ll1 = tk.tied_sae_fwd(_t(x).to(torch.bfloat16), t_db, _t(bias), scale)
    assert c.dtype == dxh.dtype == torch.bfloat16
    frac, ok = bf16_close(c, c_ref.astype(bf16))
    assert ok and frac < 1e-3, (frac, ok)
    np.testing.assert_allclose(to_np(ll1), np.asarray(jnp.sum(c_ref, axis=(1, 2))), rtol=1e-3)

    cb = jnp.asarray(to_np(c)).astype(bf16)
    err = jnp.einsum("mbn,mnd->mbd", cb, db, preferred_element_type=f32) - xb.astype(f32)[None]
    frac, ok = bf16_close(dxh, (scale * err).astype(bf16))
    assert ok and frac < 1e-3, (frac, ok)
    np.testing.assert_allclose(to_np(lrec), np.asarray(jnp.sum(err * err, axis=(1, 2))), rtol=1e-3)


def test_shape_predicate_and_refusals():
    assert tk.shapes_supported(4096, 512, 2048)
    assert tk.shapes_supported(512, 128, 256)
    assert tk.shapes_supported(12288, 768, 2048)  # D 768: the bwd tile is 32 x 768
    assert not tk.shapes_supported(4096, 640)  # width outside the bwd tiling
    assert not tk.shapes_supported(4096 + 64, 512)  # N not a multiple of 128
    assert not tk.shapes_supported(4096, 512, 100)  # B not a multiple of 64
    d_raw, bias, x, l1 = _inputs(4, 96)
    with pytest.raises(ValueError, match="not covered"):
        tk.tied_sae_grads_stacked(_t(d_raw), _t(d_raw[..., 0]), _t(bias), _t(x), _t(l1))


def test_cpu_tensors_never_reach_the_kernel_build(monkeypatch):
    """A wrapper given CPU tensors runs its plain version and counts no
    launch; only CUDA tensors go to the kernel (and its build)."""
    from sparse_coding__tpu_torch.ops import _build

    def no_build():
        raise AssertionError("kernel build reached with CPU tensors")

    monkeypatch.setattr(_build, "load", no_build)
    tk.reset_launches()
    d_raw, bias, x, l1 = _inputs(5)
    nrm = _t(np.sqrt(np.sum(d_raw * d_raw, axis=-1)))
    tk.tied_sae_grads_stacked(_t(d_raw) / nrm[..., None], nrm, _t(bias), _t(x), _t(l1))
    assert tk.LAUNCHES == {"tied_sae_fwd": 0, "tied_sae_fwd_nocode": 0, "tied_sae_bwd_adam": 0,
                           "tied_sae_bwd_grads": 0, "tied_sae_bwd_adam_sparse": 0,
                           "tied_sae_bwd_grads_sparse": 0}


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from sparse_coding__tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()
