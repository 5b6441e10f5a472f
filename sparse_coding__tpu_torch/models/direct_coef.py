"""Basis pursuit by direct coefficient optimization.

Counterpart of `sparse_coding__tpu/models/direct_coef.py`: no learned
encoder; each batch's codes are found by ``N_ITERS_OPT`` steps of momentum
SGD on the lasso objective, projected to c ≥ 0, and the decoder learns from
the reconstruction at those codes (the search carries no gradient).

The search's gradient is written out, not taken by autograd, and follows the
JAX package's convention at the kink of ``|c|``: ``jax.grad(jnp.abs)(0.)``
is 1 (torch's ``abs`` gives 0 there). The search starts at c = 0, so its
first step, and every later one at a zero code, adds ``l1 / B`` to the
gradient of every entry, and the velocity carries it on: with torch's
convention the codes come out other ones. The signature takes the STACKED
params/buffers of an ensemble; `DirectCoefSearch` runs the same search for
one member. f32 throughout (the JAX signature applies no precision policy).
"""

from __future__ import annotations

from typing import Optional

import torch

from sparse_coding__tpu_torch.models.learned_dict import LearnedDict, _norm_rows, register_learned_dict
from sparse_coding__tpu_torch.utils.tree import tree_map

N_ITERS_OPT = 100
MOMENTUM = 0.9


def _per_member(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape + (1, 1))


def jax_abs_grad(c: torch.Tensor) -> torch.Tensor:
    """The derivative of ``jnp.abs`` at ``c``: 1 where ``c >= 0``, else -1."""
    one = torch.ones((), dtype=c.dtype, device=c.device)
    return torch.where(c >= 0, one, -one)


class DirectCoefOptimizer:
    """Params ``decoder`` [N, D] (standard normal); buffers ``l1_alpha`` and
    ``lr`` (the search's step size)."""

    @staticmethod
    def init(generator: torch.Generator, d_activation: int, n_features: int, l1_alpha: float, lr: float = 1e-3,
             dtype=torch.float32, device=None):
        device = device if device is not None else generator.device
        params = {"decoder": torch.randn((n_features, d_activation), generator=generator, dtype=dtype, device=device)}
        buffers = {
            "l1_alpha": torch.tensor(l1_alpha, dtype=dtype, device=device),
            "lr": torch.tensor(lr, dtype=dtype, device=device),
        }
        return params, buffers

    @staticmethod
    def objective(c, normed_dict, batch, l1_alpha):
        """The lasso objective on the codes: ``(total, (losses, {"c": c}))``,
        per member."""
        x_hat = torch.matmul(c, normed_dict)
        l_reconstruction = torch.mean((x_hat - batch) ** 2, dim=(-2, -1))
        l_sparsity = l1_alpha * torch.abs(c).sum(dim=-1).mean(dim=-1)
        total = l_reconstruction + l_sparsity
        return total, ({"loss": total, "l_reconstruction": l_reconstruction, "l_l1": l_sparsity}, {"c": c})

    @staticmethod
    def objective_grad(c, normed_dict, batch, l1_alpha):
        """d objective / d c: ``2 (c·D̂ − x)·D̂ᵀ / (B·D)`` plus ``l1 / B``
        times `jax_abs_grad` (JAX's ``abs`` derivative at 0)."""
        B, D = batch.shape[-2:]
        diff = torch.matmul(c, normed_dict) - batch
        g_rec = torch.matmul(diff * (2.0 / (B * D)), normed_dict.transpose(-2, -1))
        return g_rec + _per_member(l1_alpha / B) * jax_abs_grad(c)

    @staticmethod
    def basis_pursuit(params, buffers, batch, normed_dict: Optional[torch.Tensor] = None,
                      n_iters: int = N_ITERS_OPT) -> torch.Tensor:
        """``n_iters`` steps of momentum SGD on the codes from c = 0, each
        projected to c ≥ 0; no gradient. One member's params give [B, N],
        stacked ones [M, B, N]."""
        with torch.no_grad():
            if normed_dict is None:
                normed_dict = _norm_rows(params["decoder"])
            normed_dict = normed_dict.detach()
            c = torch.zeros(normed_dict.shape[:-2] + (batch.shape[-2], normed_dict.shape[-2]),
                            dtype=batch.dtype, device=batch.device)
            velocity = torch.zeros_like(c)
            lr = _per_member(buffers["lr"])
            for _ in range(n_iters):
                g = DirectCoefOptimizer.objective_grad(c, normed_dict, batch, buffers["l1_alpha"])
                velocity = MOMENTUM * velocity - lr * g
                c = torch.relu(c + velocity)
        return c

    @staticmethod
    def loss(params, buffers, batch):
        """(reconstruction [M], ({"loss"}, {"c": c})) at the search's codes:
        the decoder's gradient comes through the final decode only."""
        normed_dict = _norm_rows(params["decoder"])
        c = DirectCoefOptimizer.basis_pursuit(params, buffers, batch, normed_dict)
        x_hat = torch.matmul(c, normed_dict)
        l_reconstruction = torch.mean((x_hat - batch) ** 2, dim=(-2, -1))
        return l_reconstruction, ({"loss": l_reconstruction}, {"c": c})

    @staticmethod
    def to_learned_dict(params, buffers):
        """One member as a `DirectCoefSearch` (its buffers copied: the
        ensemble's are views of the training state)."""
        return DirectCoefSearch(params, tree_map(lambda v: v.detach().clone(), buffers))


class DirectCoefSearch(LearnedDict):
    """Inference view: ``encode`` runs the whole basis-pursuit search."""

    def __init__(self, params, buffers):
        self.params = params
        self.buffers = buffers
        self.n_feats, self.activation_size = params["decoder"].shape

    def encode(self, x):
        return DirectCoefOptimizer.basis_pursuit(self.params, self.buffers, x)

    def get_learned_dict(self):
        return _norm_rows(self.params["decoder"])


register_learned_dict(DirectCoefSearch, ("params", "buffers"))
