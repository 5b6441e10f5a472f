"""Semi-linear SAE: a two-layer MLP encoder, a normalized linear decoder.

Counterpart of `sparse_coding__tpu/models/semilinear.py`. The encoder's
layers are a LIST of ``{"weight", "bias"}`` dicts (the JAX package's param
tree), stacked member by member like every other leaf. The signature takes
the STACKED params/buffers of an ensemble and computes in f32 (the JAX
signature applies no precision policy).
"""

from __future__ import annotations

import torch

from sparse_coding__tpu_torch.models.learned_dict import LearnedDict, _norm_rows, register_learned_dict
from sparse_coding__tpu_torch.models.sae import _l1, glorot_uniform


class FFLayer:
    """Affine + relu: ``weight`` [out, in] (glorot uniform), ``bias`` [out]
    (zeros)."""

    @staticmethod
    def init(generator: torch.Generator, input_size: int, output_size: int, dtype=torch.float32, device=None):
        device = device if device is not None else generator.device
        return {
            "weight": glorot_uniform((output_size, input_size), generator, dtype, device),
            "bias": torch.zeros(output_size, dtype=dtype, device=device),
        }

    @staticmethod
    def forward(params, x):
        return torch.relu(torch.matmul(x, params["weight"].transpose(-2, -1)) + params["bias"][..., None, :])


class SemiLinearSAE:
    """Params ``encoder_layers`` (two `FFLayer`s: D → hidden → N; hidden
    defaults to N) and ``decoder`` [N, D]; buffer ``l1_alpha``."""

    @staticmethod
    def init(generator: torch.Generator, activation_size: int, n_dict_components: int, l1_alpha: float,
             hidden_size=None, dtype=torch.float32, device=None):
        """One member's (params, buffers), unstacked: the two layers, then the
        decoder, drawn in that order."""
        device = device if device is not None else generator.device
        hidden_size = n_dict_components if hidden_size is None else hidden_size
        layers = [FFLayer.init(generator, activation_size, hidden_size, dtype, device),
                  FFLayer.init(generator, hidden_size, n_dict_components, dtype, device)]
        params = {
            "encoder_layers": layers,
            "decoder": glorot_uniform((n_dict_components, activation_size), generator, dtype, device),
        }
        return params, {"l1_alpha": torch.tensor(l1_alpha, dtype=dtype, device=device)}

    @staticmethod
    def encode(params, batch):
        """The layers in turn: [B, N] for one member, [M, B, N] stacked."""
        c = batch
        for layer in params["encoder_layers"]:
            c = FFLayer.forward(layer, c)
        return c

    @staticmethod
    def loss(params, buffers, batch):
        """(total [M], (loss_data, {"c": c [M, B, N]})): reconstruction + l1."""
        c = SemiLinearSAE.encode(params, batch)
        x_hat = torch.matmul(c, _norm_rows(params["decoder"]))
        l_reconstruction = torch.mean((x_hat - batch) ** 2, dim=(-2, -1))
        l_l1 = buffers["l1_alpha"] * _l1(c)
        total = l_reconstruction + l_l1
        return total, ({"loss": total, "l_reconstruction": l_reconstruction, "l_l1": l_l1}, {"c": c})

    @staticmethod
    def to_learned_dict(params, buffers):
        return SemiLinearSAE_export(params)


class SemiLinearSAE_export(LearnedDict):
    """Inference view: one member's params, the normalized decoder as the
    dictionary."""

    def __init__(self, params):
        self.params = params
        self.n_feats, self.activation_size = params["decoder"].shape

    def get_learned_dict(self):
        return _norm_rows(self.params["decoder"])

    def encode(self, x):
        return SemiLinearSAE.encode(self.params, x)


register_learned_dict(SemiLinearSAE_export, ("params",))
