"""Streaming PCA and mean baselines.

Counterpart of `sparse_coding__tpu/models/pca.py`: a streaming covariance
and mean (Chan et al.'s update a batch), one eigendecomposition a fit, and
the views built from it (`PCAEncoder`, a top-k dict, a rotation, the
whitening triple that `FunctionalTiedSAE`'s centring buffers take). The
state lives on ``device`` (None = cuda). Eigenvectors have no fixed sign:
``torch.linalg.eigh`` and ``jnp.linalg.eigh`` may return any column negated,
so a dict made from them equals the JAX package's up to each row's sign.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sparse_coding__tpu_torch.models.learned_dict import LearnedDict, Rotation, register_learned_dict
from sparse_coding__tpu_torch.models.topk import TopKLearnedDict, topk_mask_code_static
from sparse_coding__tpu_torch.utils.device import resolve_device


def _pca_update(cov, mean, n_samples, activations):
    """One batch's streaming covariance and mean update: ``(cov, mean,
    n_samples)`` after it."""
    batch_size = activations.shape[0]
    total = n_samples + batch_size
    corrected = activations - mean[None, :]
    new_mean = mean + corrected.mean(dim=0) * batch_size / total
    cov_update = torch.matmul(corrected.T, activations - new_mean[None, :]) / batch_size
    new_cov = cov * (n_samples / total) + cov_update * batch_size / total
    return new_cov, new_mean, total


class BatchedMean:
    """A streaming mean (with the running count, as the JAX package keeps
    it)."""

    def __init__(self, n_dims: int, device=None):
        self.n_dims = n_dims
        self.mean = torch.zeros(n_dims, device=resolve_device(device))
        self.n_samples = 0.0

    def train_batch(self, activations: torch.Tensor):
        batch_size = activations.shape[0]
        total = self.n_samples + batch_size
        self.mean = self.mean * (self.n_samples / total) + activations.sum(dim=0) / total
        self.n_samples = total

    def get_mean(self) -> torch.Tensor:
        return self.mean


class BatchedPCA:
    """Streaming PCA: the covariance [D, D], the mean [D] and the count, in
    f32 on ``device``."""

    def __init__(self, n_dims: int, device=None):
        device = resolve_device(device)
        self.n_dims = n_dims
        self.cov = torch.zeros((n_dims, n_dims), device=device)
        self.mean = torch.zeros(n_dims, device=device)
        self.n_samples = torch.zeros((), device=device)

    def get_mean(self) -> torch.Tensor:
        return self.mean

    def train_batch(self, activations: torch.Tensor):
        self.cov, self.mean, self.n_samples = _pca_update(self.cov, self.mean, self.n_samples, activations)

    def get_pca(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(eigenvalues ascending, eigenvectors as columns)`` of the
        symmetrized covariance."""
        return torch.linalg.eigh((self.cov + self.cov.T) / 2)

    def get_centering_transform(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The whitening triple ``(translation, rotation, scaling)``: the
        mean, the eigenvectors (columns) and ``1 / sqrt(max(eigenvalue,
        1e-6))``, so ``((x - t) @ R) * s`` has unit covariance.
        `FunctionalTiedSAE.init` takes them as ``translation``,
        ``rotation``, ``scaling`` (its centring multiplies by ``Rᵀ``, as the
        JAX package's does)."""
        eigvals, eigvecs = self.get_pca()
        return self.get_mean(), eigvecs, 1.0 / torch.sqrt(torch.clamp(eigvals, min=1e-6))

    def get_dict(self) -> torch.Tensor:
        """The eigenvectors as rows, by decreasing eigenvalue (a stable
        order among equal ones, as ``jnp.argsort``)."""
        eigvals, eigvecs = self.get_pca()
        return eigvecs[:, torch.argsort(-eigvals, stable=True)].T

    def to_learned_dict(self, sparsity: int) -> "PCAEncoder":
        return PCAEncoder(self.get_dict(), sparsity)

    def to_topk_dict(self, sparsity: int) -> TopKLearnedDict:
        """The ± components as a non-negative top-k dict."""
        eigvecs = self.get_dict()
        return TopKLearnedDict(torch.cat([eigvecs, -eigvecs], dim=0), sparsity)

    def to_rotation_dict(self, n_components: int) -> Rotation:
        return Rotation(self.get_dict()[:n_components])


def _rows(activations, device) -> torch.Tensor:
    return torch.as_tensor(activations).to(resolve_device(device))


def calc_pca(activations, batch_size: int = 512, device=None) -> BatchedPCA:
    """Fit streaming PCA over activations [n, D] on ``device`` (None = cuda;
    the rows are moved there)."""
    activations = _rows(activations, device)
    pca = BatchedPCA(activations.shape[1], device=activations.device)
    for i in range(0, activations.shape[0], batch_size):
        pca.train_batch(activations[i : i + batch_size])
    return pca


def calc_mean(activations, batch_size: int = 512, device=None) -> torch.Tensor:
    """The streaming mean of activations [n, D] on ``device`` (None = cuda)."""
    activations = _rows(activations, device)
    mean = BatchedMean(activations.shape[1], device=activations.device)
    for i in range(0, activations.shape[0], batch_size):
        mean.train_batch(activations[i : i + batch_size])
    return mean.get_mean()


class PCAEncoder(LearnedDict):
    """The top-``sparsity`` components by |score|, keeping the signed scores
    (ties toward the lower index, as ``lax.top_k``)."""

    def __init__(self, pca_dict: torch.Tensor, sparsity: int):
        self.pca_dict = pca_dict / torch.linalg.norm(pca_dict, dim=-1, keepdim=True)
        self.sparsity = int(sparsity)
        self.n_feats, self.activation_size = self.pca_dict.shape

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        scores = x @ self.pca_dict.T
        mask = topk_mask_code_static(torch.abs(scores), self.sparsity) > 0
        return torch.where(mask, scores, torch.zeros((), dtype=scores.dtype, device=scores.device))

    def get_learned_dict(self) -> torch.Tensor:
        return self.pca_dict


register_learned_dict(PCAEncoder, ("pca_dict",), ("sparsity",))
