"""Non-negative ("positive") SAE variants.

Counterpart of `sparse_coding__tpu/models/positive.py`: the encoder weights
are read through a relu (the projected view of a non-negativity constraint,
so the signature stays functional), inputs are shifted by +0.18 and the bias
starts at -1. The signature takes the STACKED params/buffers of an ensemble
(leading member axis ``M``) and computes in f32: the JAX signature applies
no precision policy.
"""

from __future__ import annotations

import torch

from sparse_coding__tpu_torch.models.learned_dict import LearnedDict, TiedSAE, _norm_rows, register_learned_dict
from sparse_coding__tpu_torch.models.sae import _safe_l2, glorot_uniform

INPUT_SHIFT = 0.18


class FunctionalPositiveTiedSAE:
    """Tied SAE on ``relu(encoder)``: params ``encoder`` [N, D] (the absolute
    value of a glorot-uniform draw), ``encoder_bias`` [N] (-1); buffers
    ``l1_alpha``, ``bias_decay``."""

    @staticmethod
    def init(generator: torch.Generator, activation_size: int, n_dict_components: int, l1_alpha: float,
             bias_decay: float = 0.0, dtype=torch.float32, device=None):
        """One member's (params, buffers), unstacked."""
        device = device if device is not None else generator.device
        params = {
            "encoder": torch.abs(glorot_uniform((n_dict_components, activation_size), generator, dtype, device)),
            "encoder_bias": torch.full((n_dict_components,), -1.0, dtype=dtype, device=device),
        }
        buffers = {
            "l1_alpha": torch.tensor(l1_alpha, dtype=dtype, device=device),
            "bias_decay": torch.tensor(bias_decay, dtype=dtype, device=device),
        }
        return params, buffers

    @staticmethod
    def loss(params, buffers, batch):
        """(total [M], (loss_data with ``l_bias_decay``, {"c": c [M, B, N]})):
        the code of the shifted batch, the reconstruction shifted back."""
        learned_dict = _norm_rows(torch.relu(params["encoder"]))
        c = torch.matmul(batch + INPUT_SHIFT, learned_dict.transpose(-2, -1))
        c = torch.relu(c + params["encoder_bias"][:, None, :])
        x_hat = torch.matmul(c, learned_dict)
        l_reconstruction = torch.mean(((x_hat - INPUT_SHIFT) - batch) ** 2, dim=(-2, -1))
        l_l1 = buffers["l1_alpha"] * torch.abs(c).sum(dim=-1).mean(dim=-1)
        l_bias_decay = buffers["bias_decay"] * _safe_l2(params["encoder_bias"])
        total = l_reconstruction + l_l1 + l_bias_decay
        loss_data = {"loss": total, "l_reconstruction": l_reconstruction, "l_l1": l_l1, "l_bias_decay": l_bias_decay}
        return total, (loss_data, {"c": c})

    @staticmethod
    def to_learned_dict(params, buffers):
        """One member as a `TiedSAE` of ``relu(encoder)``."""
        return TiedSAE(torch.relu(params["encoder"]), params["encoder_bias"], norm_encoder=True)


class TiedPositiveSAE(LearnedDict):
    """Inference view that takes ``|encoder|`` at construction."""

    def __init__(self, encoder: torch.Tensor, encoder_bias: torch.Tensor, norm_encoder: bool = False):
        self.encoder = torch.abs(encoder)
        self.encoder_bias = encoder_bias
        self.norm_encoder = norm_encoder
        self.n_feats, self.activation_size = encoder.shape

    def get_learned_dict(self):
        return _norm_rows(self.encoder)

    def encode(self, batch):
        encoder = _norm_rows(self.encoder) if self.norm_encoder else self.encoder
        return torch.relu(batch @ encoder.T + self.encoder_bias)


class UntiedPositiveSAE(LearnedDict):
    """Untied inference view (``|encoder|`` at construction; the encode
    honours ``norm_encoder``, as the JAX package's does)."""

    def __init__(self, encoder: torch.Tensor, encoder_bias: torch.Tensor, decoder: torch.Tensor,
                 norm_encoder: bool = False):
        self.encoder = torch.abs(encoder)
        self.decoder = decoder
        self.encoder_bias = encoder_bias
        self.norm_encoder = norm_encoder
        self.n_feats, self.activation_size = encoder.shape

    def get_learned_dict(self):
        return _norm_rows(self.encoder)

    def encode(self, batch):
        encoder = _norm_rows(self.encoder) if self.norm_encoder else self.encoder
        return torch.relu(batch @ encoder.T + self.encoder_bias)


register_learned_dict(TiedPositiveSAE, ("encoder", "encoder_bias"), ("norm_encoder",))
register_learned_dict(UntiedPositiveSAE, ("encoder", "encoder_bias", "decoder"), ("norm_encoder",))
