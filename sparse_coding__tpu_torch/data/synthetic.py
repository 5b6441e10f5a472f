"""Synthetic sparse-feature data with a known ground-truth dictionary.

Counterpart of `sparse_coding__tpu/data/synthetic.py`: Bernoulli-gated
uniform codes over planted unit-norm features, decaying per-feature
probabilities (`RandomDatasetGenerator`), their correlated variant (the
MVN-CDF trick: `sample_correlated_dataset`), and `SparseMixDataset`
(correlated sparse components + correlated gaussian noise), which the sweep
materializes into its chunk store.

Sampling runs on ``device`` from a `torch.Generator`; the two packages'
random streams differ, so each sampler is split into its draws and a
deterministic transform of them (``*_from_draws``), which the tests hold to
the JAX package on the same draws; the draws themselves are held to its
distribution statistics.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from sparse_coding__tpu_torch.utils.device import resolve_device


def generate_rand_feats(gen: torch.Generator, feat_dim: int, num_feats: int, device) -> torch.Tensor:
    """Random unit-norm feature directions [num_feats, feat_dim]."""
    feats = torch.randn((num_feats, feat_dim), generator=gen, device=device)
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


def corr_matrix_from_uniform(m: torch.Tensor) -> torch.Tensor:
    """`generate_corr_matrix`'s transform of its uniform draw: symmetrize,
    then shift the spectrum positive."""
    m = (m + m.T) / 2.0
    min_eig = torch.linalg.eigvalsh(m).min()
    shift = torch.where(min_eig < 0, -1.001 * min_eig, torch.zeros_like(min_eig))
    return m + shift * torch.eye(m.shape[0], dtype=m.dtype, device=m.device)


def generate_corr_matrix(gen: torch.Generator, num_feats: int, device) -> torch.Tensor:
    """Random symmetric positive semi-definite "correlation" matrix."""
    return corr_matrix_from_uniform(torch.rand((num_feats, num_feats), generator=gen, device=device))


def chol_factor(cov: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of a covariance, jittered by 1e-6 I for safety.
    Computed once per generator, not per batch."""
    n = cov.shape[0]
    return torch.linalg.cholesky(cov + 1e-6 * torch.eye(n, dtype=cov.dtype, device=cov.device))


def _normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def correlated_from_draws(corr_chol, z, thresh, values, fix_idx, strengths, feats, frac_nonzero: float,
                          decay) -> Tuple[torch.Tensor, torch.Tensor]:
    """`sample_correlated_dataset`'s transform of its draws (z ~ N(0, I) [n];
    thresh, values, strengths ~ U[0, 1) [B, n]; fix_idx uniform in [0, n)
    [B]): the correlated draw through the normal CDF, decayed and rescaled
    to the target density, gates the values; a row left empty gets the one
    component ``fix_idx`` at 1. Returns (codes, data)."""
    n = z.shape[0]
    probs = _normal_cdf(corr_chol @ z) * decay
    probs = probs * (frac_nonzero / probs.mean())
    codes = torch.where(thresh <= probs[None, :], values, torch.zeros_like(values))
    empty = (codes != 0).sum(dim=1) == 0
    fix = torch.nn.functional.one_hot(fix_idx, n).to(codes.dtype)
    codes = torch.where(empty[:, None], fix, codes)
    return codes, (codes * strengths) @ feats


def sample_correlated_dataset(gen: torch.Generator, corr_chol, feats, frac_nonzero: float, decay,
                              n_components: int, batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Correlated sparse codes → activations (see `correlated_from_draws`)."""
    dev = feats.device
    z = torch.randn((n_components,), generator=gen, device=dev)
    thresh = torch.rand((batch_size, n_components), generator=gen, device=dev)
    values = torch.rand((batch_size, n_components), generator=gen, device=dev)
    fix_idx = torch.randint(0, n_components, (batch_size,), generator=gen, device=dev)
    strengths = torch.rand((batch_size, n_components), generator=gen, device=dev)
    return correlated_from_draws(corr_chol, z, thresh, values, fix_idx, strengths, feats, frac_nonzero, decay)


def sample_noise(gen: torch.Generator, noise_chol, noise_magnitude_scale: float, batch_size: int) -> torch.Tensor:
    """Correlated gaussian noise ``(z @ Lᵀ) · scale`` from the noise
    covariance's Cholesky factor L."""
    z = torch.randn((batch_size, noise_chol.shape[0]), generator=gen, device=noise_chol.device)
    return (z @ noise_chol.T) * noise_magnitude_scale


def _decay(feature_prob_decay: float, n: int, device) -> torch.Tensor:
    return torch.tensor([feature_prob_decay**i for i in range(n)], dtype=torch.float32, device=device)


class RandomDatasetGenerator:
    """Decaying-Bernoulli sparse feature generator. ``next(g)`` yields a
    ``[batch_size, activation_dim]`` float32 batch on ``device``; the planted
    dictionary is ``g.feats``. ``key`` seeds a `torch.Generator` on ``device``
    (``device=None`` means cuda). ``correlated=True`` draws each batch's
    component probabilities through a random correlation matrix
    (`sample_correlated_dataset`)."""

    def __init__(self, activation_dim: int, n_ground_truth_components: int, batch_size: int,
                 feature_num_nonzero: int, feature_prob_decay: float, correlated: bool, key, device=None):
        self.device = resolve_device(device)
        self.activation_dim = activation_dim
        self.n_ground_truth_components = n_ground_truth_components
        self.batch_size = batch_size
        self.frac_nonzero = feature_num_nonzero / n_ground_truth_components
        self.correlated = correlated
        self._gen = torch.Generator(device=self.device).manual_seed(int(key))
        self.decay = _decay(feature_prob_decay, n_ground_truth_components, self.device)
        self.feats = generate_rand_feats(self._gen, activation_dim, n_ground_truth_components, self.device)
        if correlated:
            self.corr_matrix = generate_corr_matrix(self._gen, n_ground_truth_components, self.device)
            self.corr_chol = chol_factor(self.corr_matrix)
            self.component_probs = None
        else:
            self.corr_matrix = self.corr_chol = None
            self.component_probs = self.decay * self.frac_nonzero

    def __iter__(self):
        return self

    def __next__(self) -> torch.Tensor:
        return self.send(None)

    def send(self, _ignored=None) -> torch.Tensor:
        n, bs, g, dev = self.n_ground_truth_components, self.batch_size, self._gen, self.device
        if self.correlated:
            return sample_correlated_dataset(g, self.corr_chol, self.feats, self.frac_nonzero, self.decay, n, bs)[1]
        thresh = torch.rand((bs, n), generator=g, device=dev)
        values = torch.rand((bs, n), generator=g, device=dev)
        codes = torch.where(thresh <= self.component_probs[None, :], values, torch.zeros_like(values))
        strengths = torch.rand((bs, n), generator=g, device=dev)
        return (codes * strengths) @ self.feats


class SparseMixDataset:
    """Correlated sparse components + correlated gaussian noise. ``send(bs)``
    yields ``sparse + noise`` batches [bs, activation_dim] on ``device``;
    the ground truth is ``sparse_component_dict``. ``key`` seeds a
    `torch.Generator` on ``device`` (None = cuda)."""

    def __init__(self, activation_dim: int, n_sparse_components: int, batch_size: int, feature_num_nonzero: int,
                 feature_prob_decay: float, noise_magnitude_scale: float, key,
                 sparse_component_dict: Optional[torch.Tensor] = None,
                 sparse_component_covariance: Optional[torch.Tensor] = None,
                 noise_covariance: Optional[torch.Tensor] = None, device=None):
        self.device = resolve_device(device)
        self.activation_dim = activation_dim
        self.n_sparse_components = n_sparse_components
        self.batch_size = batch_size
        self.frac_nonzero = feature_num_nonzero / n_sparse_components
        self.noise_magnitude_scale = noise_magnitude_scale
        self._gen = torch.Generator(device=self.device).manual_seed(int(key))
        dev = self.device
        self.sparse_component_dict = (
            sparse_component_dict.to(dev) if sparse_component_dict is not None
            else generate_rand_feats(self._gen, activation_dim, n_sparse_components, dev)
        )
        self.sparse_component_covariance = (
            sparse_component_covariance.to(dev) if sparse_component_covariance is not None
            else generate_corr_matrix(self._gen, n_sparse_components, dev)
        )
        self.noise_covariance = (
            noise_covariance.to(dev) if noise_covariance is not None else torch.eye(activation_dim, device=dev)
        )
        self.corr_chol = chol_factor(self.sparse_component_covariance)
        self.noise_chol = chol_factor(self.noise_covariance)
        self.sparse_component_probs = _decay(feature_prob_decay, n_sparse_components, dev)

    def __iter__(self):
        return self

    def __next__(self) -> torch.Tensor:
        return self.send(None)

    def send(self, batch_size: Optional[int] = None) -> torch.Tensor:
        bs = batch_size or self.batch_size
        _, sparse = sample_correlated_dataset(self._gen, self.corr_chol, self.sparse_component_dict,
                                              self.frac_nonzero, self.sparse_component_probs,
                                              self.n_sparse_components, bs)
        return sparse + sample_noise(self._gen, self.noise_chol, self.noise_magnitude_scale, bs)
