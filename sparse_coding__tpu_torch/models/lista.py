"""Learned-ISTA (LISTA) and residual-MLP denoising autoencoders.

Counterpart of `sparse_coding__tpu/models/lista.py`. The K unrolled encoder
layers are one nested ``encoder_layers`` dict whose leaves carry a layer
axis: ``[K, ...]`` for one member, ``[M, K, ...]`` in a stacked ensemble
(the JAX package's ``lax.scan`` over a stacked layer pytree; here a loop
over that axis, which a captured step graph unrolls). The signatures take
the STACKED params/buffers of an ensemble and compute in f32 (the JAX
signatures apply no precision policy); the inference views run the same
encode on one member's params.

Initial weights are drawn from a `torch.Generator`: the orthogonal matrices
by a QR of a gaussian draw (columns orthonormal for the tall shape, rows for
the wide one), not JAX's stream.
"""

from __future__ import annotations

import torch

from sparse_coding__tpu_torch.models.learned_dict import LearnedDict, _norm_rows, jclip, register_learned_dict
from sparse_coding__tpu_torch.models.sae import _l1
from sparse_coding__tpu_torch.utils.tree import tree_map


def orthogonal(shape, generator: torch.Generator, dtype=torch.float32, device=None) -> torch.Tensor:
    """A random ``[rows, cols]`` matrix with orthonormal columns (rows ≥
    cols) or rows (rows < cols): the Q of a gaussian draw's QR, its columns'
    signs fixed by R's diagonal (`jax.nn.initializers.orthogonal`'s
    property; other numbers)."""
    rows, cols = shape
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=generator, dtype=torch.float32, device=device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return (q if rows >= cols else q.T).to(dtype)


def _normal(shape, generator, dtype, device, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=dtype, device=device) * scale


def _stack_layers(layers):
    """Per-layer dicts stacked on a leading layer axis ``[K, ...]``."""
    return tree_map(lambda *leaves: torch.stack(leaves), *layers)


def _layer(layers, learned_dict: torch.Tensor, k: int):
    """Layer ``k`` of the stacked layers: their layer axis is the one after
    the member axis, if the dictionary has one."""
    axis = learned_dict.ndim - 2
    return {name: v.select(axis, k) for name, v in layers.items()}


def _n_layers(layers, learned_dict: torch.Tensor) -> int:
    return next(iter(layers.values())).shape[learned_dict.ndim - 2]


def _per_member(v: torch.Tensor) -> torch.Tensor:
    """A per-member (or 0-d) scalar shaped to broadcast against [.., B, N]."""
    return v.reshape(v.shape + (1, 1))


def shrinkage(r: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Soft threshold ``sign(r) · relu(|r| − θ)``, θ [N] (or [M, N]) over
    r [B, N] (or [M, B, N])."""
    return torch.sign(r) * torch.relu(torch.abs(r) - theta[..., None, :])


class LISTALayer:
    """One unrolled ISTA-with-momentum layer: ``W`` [N, D] (orthogonal),
    ``theta`` [N] (normal × 0.02), ``rho`` (0.1)."""

    @staticmethod
    def init(generator: torch.Generator, d_activation: int, n_features: int, dtype=torch.float32, device=None):
        device = device if device is not None else generator.device
        return {
            "W": orthogonal((n_features, d_activation), generator, dtype, device),
            "theta": _normal((n_features,), generator, dtype, device, 0.02),
            "rho": torch.tensor(0.1, dtype=dtype, device=device),
        }

    @staticmethod
    def forward(params, y, b, x, A):
        """One step of solving ``c A ≈ b``: ``(y momentum iterate, x)`` →
        the new pair. The momentum ``clip(rho, 0, 1)`` has `jnp.clip`'s
        gradient."""
        m = _per_member(jclip(params["rho"], 0.0, 1.0))
        r = y + torch.matmul(b - torch.matmul(y, A), params["W"].transpose(-2, -1))
        x_new = shrinkage(r, params["theta"])
        return x_new + m * (x_new - x), x_new


class FunctionalLISTADenoisingSAE:
    """K LISTA layers as the encoder, a normalized linear decoder: params
    ``decoder`` [N, D] (orthogonal) and ``encoder_layers`` (a dict of [K, ...]
    leaves); buffer ``l1_alpha``."""

    @staticmethod
    def init(generator: torch.Generator, d_activation: int, n_features: int, n_hidden_layers: int,
             l1_alpha: float, dtype=torch.float32, device=None):
        """One member's (params, buffers), unstacked: the decoder, then the
        layers, drawn in that order."""
        device = device if device is not None else generator.device
        decoder = orthogonal((n_features, d_activation), generator, dtype, device)
        layers = [LISTALayer.init(generator, d_activation, n_features, dtype, device) for _ in range(n_hidden_layers)]
        params = {"decoder": decoder, "encoder_layers": _stack_layers(layers)}
        return params, {"l1_alpha": torch.tensor(l1_alpha, dtype=dtype, device=device)}

    @staticmethod
    def encode(params, b, learned_dict):
        """Codes of ``b`` after the K layers, from ``y0 = b·D̂ᵀ``: [B, N] for
        one member's params and dictionary [N, D], [M, B, N] stacked."""
        y = torch.matmul(b, learned_dict.transpose(-2, -1))
        x = y
        layers = params["encoder_layers"]
        for k in range(_n_layers(layers, learned_dict)):
            y, x = LISTALayer.forward(_layer(layers, learned_dict, k), y, b, x, learned_dict)
        return y

    @staticmethod
    def loss(params, buffers, batch):
        """(total [M], (loss_data, {"c": c [M, B, N]})): reconstruction + l1."""
        learned_dict = _norm_rows(params["decoder"])
        c = FunctionalLISTADenoisingSAE.encode(params, batch, learned_dict)
        return _denoising_losses(c, learned_dict, batch, buffers)

    @staticmethod
    def to_learned_dict(params, buffers):
        return LISTADenoisingSAE(params)


def _denoising_losses(c, learned_dict, batch, buffers):
    x_hat = torch.matmul(c, learned_dict)
    l_reconstruction = torch.mean((x_hat - batch) ** 2, dim=(-2, -1))
    l_sparsity = buffers["l1_alpha"] * _l1(c)
    total = l_reconstruction + l_sparsity
    return total, ({"loss": total, "l_reconstruction": l_reconstruction, "l_l1": l_sparsity}, {"c": c})


class LISTADenoisingSAE(LearnedDict):
    """Inference view: one member's params, the normalized decoder as the
    dictionary, the K-layer encode."""

    def __init__(self, params):
        self.params = params
        self.n_feats, self.activation_size = params["decoder"].shape

    def get_learned_dict(self):
        return _norm_rows(self.params["decoder"])

    def encode(self, x):
        return FunctionalLISTADenoisingSAE.encode(self.params, x, self.get_learned_dict())


class ResidualDenoisingLayer:
    """relu(x + θ), mixed by ``W`` [N, N] (orthogonal), plus the residual."""

    @staticmethod
    def init(generator: torch.Generator, n_features: int, dtype=torch.float32, device=None):
        device = device if device is not None else generator.device
        return {
            "W": orthogonal((n_features, n_features), generator, dtype, device),
            "theta": _normal((n_features,), generator, dtype, device, 0.02),
        }

    @staticmethod
    def forward(params, x):
        h = torch.relu(x + params["theta"][..., None, :])
        return torch.matmul(h, params["W"].transpose(-2, -1)) + x


class FunctionalResidualDenoisingSAE:
    """The residual-MLP encoder variant: params ``decoder`` [N, D]
    (orthogonal), ``encoder_layers`` (``W`` [K, N, N], ``theta`` [K, N]) and
    ``encoder_bias`` [N] (normal × 0.02); buffer ``l1_alpha``."""

    @staticmethod
    def init(generator: torch.Generator, d_activation: int, n_features: int, n_hidden_layers: int,
             l1_alpha: float, dtype=torch.float32, device=None):
        """One member's (params, buffers), unstacked: the decoder, the bias,
        then the layers, drawn in that order."""
        device = device if device is not None else generator.device
        decoder = orthogonal((n_features, d_activation), generator, dtype, device)
        bias = _normal((n_features,), generator, dtype, device, 0.02)
        layers = [ResidualDenoisingLayer.init(generator, n_features, dtype, device) for _ in range(n_hidden_layers)]
        params = {"decoder": decoder, "encoder_layers": _stack_layers(layers), "encoder_bias": bias}
        return params, {"l1_alpha": torch.tensor(l1_alpha, dtype=dtype, device=device)}

    @staticmethod
    def encode(params, b, learned_dict):
        """``relu(x_K + bias)``, ``x_0 = b·D̂ᵀ`` through the K residual layers."""
        x = torch.matmul(b, learned_dict.transpose(-2, -1))
        layers = params["encoder_layers"]
        for k in range(_n_layers(layers, learned_dict)):
            x = ResidualDenoisingLayer.forward(_layer(layers, learned_dict, k), x)
        return torch.relu(x + params["encoder_bias"][..., None, :])

    @staticmethod
    def loss(params, buffers, batch):
        """(total [M], (loss_data, {"c": c [M, B, N]})): reconstruction + l1."""
        learned_dict = _norm_rows(params["decoder"])
        c = FunctionalResidualDenoisingSAE.encode(params, batch, learned_dict)
        return _denoising_losses(c, learned_dict, batch, buffers)

    @staticmethod
    def to_learned_dict(params, buffers):
        return ResidualDenoisingSAE(params)


class ResidualDenoisingSAE(LearnedDict):
    """Inference view of the residual variant (the dictionary is the
    normalized ``decoder``, as in the JAX package)."""

    def __init__(self, params):
        self.params = params
        self.n_feats, self.activation_size = params["decoder"].shape

    def get_learned_dict(self):
        return _norm_rows(self.params["decoder"])

    def encode(self, x):
        return FunctionalResidualDenoisingSAE.encode(self.params, x, self.get_learned_dict())


register_learned_dict(LISTADenoisingSAE, ("params",))
register_learned_dict(ResidualDenoisingSAE, ("params",))
