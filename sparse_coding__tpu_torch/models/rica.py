"""Reconstruction ICA (RICA): a tied linear autoencoder with a sparsity
penalty.

Counterpart of `sparse_coding__tpu/models/rica.py`: ``x̂ = (x·Wᵀ)·W``, loss
MSE + ``sparsity_coef`` × penalty, the penalty smooth-L1 (Huber, mean) or
the mean |c|, chosen per member by the ``sparsity_is_l1`` flag buffer, so
members of both kinds share one stack. The signature takes the STACKED
params/buffers of an ensemble and computes in f32 (the JAX signature applies
no precision policy).
"""

from __future__ import annotations

import torch

from sparse_coding__tpu_torch.models.learned_dict import LearnedDict, _norm_rows, register_learned_dict
from sparse_coding__tpu_torch.models.sae import glorot_uniform


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Huber (torch's ``smooth_l1_loss`` against 0), the mean over the last
    two axes: one value per member."""
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * x**2 / beta, ax - 0.5 * beta).mean(dim=(-2, -1))


class RICA:
    """Params ``weights`` [N, D] (glorot uniform); buffers ``sparsity_coef``
    and ``sparsity_is_l1`` (1 for the l1 penalty, 0 for smooth-L1)."""

    @staticmethod
    def init(generator: torch.Generator, activation_size: int, n_dict_components: int, sparsity_coef: float = 0.0,
             sparsity_loss: str = "smooth_l1", dtype=torch.float32, device=None):
        device = device if device is not None else generator.device
        params = {"weights": glorot_uniform((n_dict_components, activation_size), generator, dtype, device)}
        buffers = {
            "sparsity_coef": torch.tensor(sparsity_coef, dtype=dtype, device=device),
            "sparsity_is_l1": torch.tensor(1.0 if sparsity_loss == "l1" else 0.0, dtype=dtype, device=device),
        }
        return params, buffers

    @staticmethod
    def forward(params, x):
        """``(x̂, c)``: ``c = x·Wᵀ``, ``x̂ = c·W``."""
        c = torch.matmul(x, params["weights"].transpose(-2, -1))
        return torch.matmul(c, params["weights"]), c

    @staticmethod
    def loss(params, buffers, batch):
        """(total [M], (loss_data, {"c": c [M, B, N]})); ``l_l1`` is the
        penalty before its coefficient."""
        x_hat, c = RICA.forward(params, batch)
        l_reconstruction = torch.mean((batch - x_hat) ** 2, dim=(-2, -1))
        # both penalties, flag-selected per member
        l_sparsity = torch.where(buffers["sparsity_is_l1"] > 0.5, torch.abs(c).mean(dim=(-2, -1)), smooth_l1(c))
        total = l_reconstruction + buffers["sparsity_coef"] * l_sparsity
        return total, ({"loss": total, "l_reconstruction": l_reconstruction, "l_l1": l_sparsity}, {"c": c})

    @staticmethod
    def to_learned_dict(params, buffers):
        return RICADict(params["weights"])


class RICADict(LearnedDict):
    """Inference view: the code ``x·Wᵀ`` and a decode by the raw weights (the
    trained forward pass); the dictionary (for the cosine metrics) is the
    normalized weights."""

    def __init__(self, weights: torch.Tensor):
        self.weights = weights
        self.n_feats, self.activation_size = weights.shape

    def get_learned_dict(self):
        return _norm_rows(self.weights)

    def encode(self, x):
        return x @ self.weights.T

    def decode(self, c):
        return c @ self.weights


register_learned_dict(RICADict, ("weights",))
