"""Synthetic sparse-feature data with a known ground-truth dictionary.

Counterpart of `sparse_coding__tpu/data/synthetic.py::RandomDatasetGenerator`:
Bernoulli-gated uniform codes over planted unit-norm features, decaying
per-feature probabilities. Sampling runs on ``device`` from a
`torch.Generator`; the two packages' random streams differ, so tests hand
the same numpy data to both rather than expecting equal draws.
"""

from __future__ import annotations

import torch

from sparse_coding__tpu_torch.utils.device import resolve_device


def generate_rand_feats(gen: torch.Generator, feat_dim: int, num_feats: int, device) -> torch.Tensor:
    """Random unit-norm feature directions [num_feats, feat_dim]."""
    feats = torch.randn((num_feats, feat_dim), generator=gen, device=device)
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


class RandomDatasetGenerator:
    """Decaying-Bernoulli sparse feature generator. ``next(g)`` yields a
    ``[batch_size, activation_dim]`` float32 batch on ``device``; the planted
    dictionary is ``g.feats``. ``key`` seeds a `torch.Generator` on ``device``
    (``device=None`` means cuda). The correlated variant is not ported yet
    (ROADMAP A1)."""

    def __init__(
        self,
        activation_dim: int,
        n_ground_truth_components: int,
        batch_size: int,
        feature_num_nonzero: int,
        feature_prob_decay: float,
        correlated: bool,
        key,
        device=None,
    ):
        if correlated:
            raise NotImplementedError("correlated=True is not ported yet — ROADMAP A1")
        self.device = resolve_device(device)
        self.activation_dim = activation_dim
        self.n_ground_truth_components = n_ground_truth_components
        self.batch_size = batch_size
        self.frac_nonzero = feature_num_nonzero / n_ground_truth_components
        self._gen = torch.Generator(device=self.device).manual_seed(int(key))
        decay = torch.tensor(
            [feature_prob_decay**i for i in range(n_ground_truth_components)],
            dtype=torch.float32, device=self.device,
        )
        self.feats = generate_rand_feats(self._gen, activation_dim, n_ground_truth_components, self.device)
        self.component_probs = decay * self.frac_nonzero

    def __iter__(self):
        return self

    def __next__(self) -> torch.Tensor:
        return self.send(None)

    def send(self, _ignored=None) -> torch.Tensor:
        n, bs, g, dev = self.n_ground_truth_components, self.batch_size, self._gen, self.device
        thresh = torch.rand((bs, n), generator=g, device=dev)
        values = torch.rand((bs, n), generator=g, device=dev)
        codes = torch.where(thresh <= self.component_probs[None, :], values, torch.zeros_like(values))
        strengths = torch.rand((bs, n), generator=g, device=dev)
        return (codes * strengths) @ self.feats
