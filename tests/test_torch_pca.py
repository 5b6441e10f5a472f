"""`models/pca.py` against the JAX package's streaming PCA, on the CPU.

Eigenvectors have no fixed sign (``jnp.linalg.eigh`` and
``torch.linalg.eigh`` may negate any column), so the dict views are held up
to each row's sign, and the rest through quantities that do not depend on
it. Tolerances, and why: the streaming covariance and mean rtol 1e-5 (atol
1e-6 of the largest: f32 sums in another order) and against float64 numpy
1e-4; eigenvalues rtol 1e-4; eigenvector rows up to sign 1e-4 (a distinct
spectrum: the data has scales 1..16); the whitened covariance within 1e-3
of the identity; encodes rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from sparse_coding__tpu.models import pca as jpca
from sparse_coding__tpu_torch.models import pca as tpca

D, ROWS = 8, 1000


def _acts(seed=0):
    rng = np.random.default_rng(seed)
    scales = np.linspace(1.0, 16.0, D).astype(np.float32)
    mix = np.linalg.qr(rng.standard_normal((D, D)))[0].astype(np.float32)
    return ((rng.standard_normal((ROWS, D)).astype(np.float32) * scales) @ mix + 3.0).astype(np.float32)


def _signs_aligned(got, want):
    s = np.sign(np.sum(got * want, axis=-1, keepdims=True))
    return got * s


@pytest.mark.parametrize("batch_size", [128, 512, 1000])
def test_streaming_covariance_and_mean_match_jax_and_float64(batch_size):
    x = _acts()
    jp = jpca.calc_pca(jnp.asarray(x), batch_size=batch_size)
    tp = tpca.calc_pca(torch.from_numpy(x), batch_size=batch_size, device="cpu")
    for got, want in ((tp.cov, jp.cov), (tp.mean, jp.mean)):
        w = np.asarray(want)
        np.testing.assert_allclose(to_np(got), w, rtol=1e-5, atol=1e-6 * np.abs(w).max())
    ref = x.astype(np.float64)
    np.testing.assert_allclose(to_np(tp.mean), ref.mean(0), rtol=1e-4)
    np.testing.assert_allclose(to_np(tp.cov), np.cov(ref.T, bias=True), rtol=1e-4, atol=1e-4)
    assert float(tp.n_samples) == ROWS
    np.testing.assert_allclose(to_np(tpca.calc_mean(torch.from_numpy(x), batch_size, device="cpu")),
                               np.asarray(jpca.calc_mean(jnp.asarray(x), batch_size)), rtol=1e-5, atol=1e-6)


def test_eigen_views_match_jax_up_to_each_rows_sign():
    x = _acts(1)
    jp = jpca.calc_pca(jnp.asarray(x))
    tp = tpca.calc_pca(torch.from_numpy(x), device="cpu")
    (jvals, _), (tvals, _) = jp.get_pca(), tp.get_pca()
    np.testing.assert_allclose(to_np(tvals), np.asarray(jvals), rtol=1e-4)
    jd, td = np.asarray(jp.get_dict()), to_np(tp.get_dict())
    np.testing.assert_allclose(_signs_aligned(td, jd), jd, atol=1e-4)
    rot = to_np(tp.to_rotation_dict(3).get_learned_dict())
    np.testing.assert_allclose(_signs_aligned(rot, jd[:3]), jd[:3], atol=1e-4)
    topk = tp.to_topk_dict(2)
    assert topk.n_feats == 2 * D and topk.sparsity == 2
    np.testing.assert_allclose(to_np(topk.get_learned_dict())[D:], -td)


def test_centering_transform_whitens_and_feeds_the_tied_sae_as_in_jax():
    """``((x - t) @ R) * s`` has unit covariance (any signs); the triple as
    `FunctionalTiedSAE`'s centring buffers gives JAX's loss on the same
    dictionary once the rotation's columns carry JAX's signs (the centring
    multiplies by Rᵀ, as the JAX package's does)."""
    from sparse_coding__tpu.models import FunctionalTiedSAE as JaxTied
    from sparse_coding__tpu_torch.models.sae import FunctionalTiedSAE

    x = _acts(2)
    jp = jpca.calc_pca(jnp.asarray(x))
    tp = tpca.calc_pca(torch.from_numpy(x), device="cpu")
    t, r, s = tp.get_centering_transform()
    w = ((torch.from_numpy(x) - t) @ r) * s
    cov = to_np(w.T @ w / ROWS)
    np.testing.assert_allclose(cov, np.eye(D), atol=1e-3)
    jt, jr, js = (np.asarray(v) for v in jp.get_centering_transform())
    flip = np.sign(np.sum(to_np(r) * jr, axis=0, keepdims=True))
    r_aligned = to_np(r) * flip
    np.testing.assert_allclose(r_aligned, jr, atol=1e-4)
    np.testing.assert_allclose(to_np(s), js, rtol=1e-4)
    enc = np.random.default_rng(3).standard_normal((12, D)).astype(np.float32)
    jparams = {"encoder": jnp.asarray(enc), "encoder_bias": jnp.zeros(12)}
    jbufs = {"center_trans": jnp.asarray(jt), "center_rot": jnp.asarray(jr), "center_scale": jnp.asarray(js),
             "l1_alpha": jnp.asarray(1e-3), "bias_decay": jnp.asarray(0.0)}
    jl = float(JaxTied.loss(jparams, jbufs, jnp.asarray(x[:64]))[0])
    _, bufs = FunctionalTiedSAE.init(torch.Generator().manual_seed(0), D, 12, 1e-3, translation=t,
                                     rotation=torch.from_numpy(r_aligned), scaling=s, device="cpu")
    tparams = {"encoder": torch.from_numpy(enc)[None], "encoder_bias": torch.zeros(1, 12)}
    tbufs = {k: None if v is None else v[None] for k, v in bufs.items()}
    tl = float(FunctionalTiedSAE.loss(tparams, tbufs, torch.from_numpy(x[:64]))[0][0])
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_pca_encoder_keeps_the_top_scores_by_magnitude_as_jax():
    """`PCAEncoder` on JAX's dict: the signed scores of the top-k |score|
    components, the same support as JAX's (ties toward the lower index)."""
    x = _acts(4)
    jd = np.asarray(jpca.calc_pca(jnp.asarray(x)).get_dict())
    jenc = jpca.PCAEncoder(jnp.asarray(jd), 3)
    tenc = tpca.PCAEncoder(torch.from_numpy(jd.copy()), 3)
    q = _acts(5)[:50] - 3.0
    want = np.asarray(jenc.encode(jnp.asarray(q)))
    got = to_np(tenc.encode(torch.from_numpy(q)))
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert ((got != 0).sum(-1) == 3).all()


def test_pca_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tpca.calc_pca(torch.zeros(4, D)), lambda: tpca.calc_mean(torch.zeros(4, D)),
                 lambda: tpca.BatchedPCA(D), lambda: tpca.BatchedMean(D)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
