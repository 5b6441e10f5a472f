"""Inference-time dictionary interface: `LearnedDict`, `TiedSAE`, `UntiedSAE`.

Counterpart of `sparse_coding__tpu/models/learned_dict.py`. A `LearnedDict` is
the evaluation view of a trained model: a (possibly normalized) dictionary
``[n_feats, activation_size]`` plus an `encode` map to codes
``[batch, n_feats]``. Array and static field names are the JAX package's, so
export records (`train.checkpoint`) are interchangeable between the two.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def _norm_rows(m: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Row-normalize a dictionary matrix (sqrt of the sum of squares, as
    `jnp.linalg.norm`, clipped below at ``eps``)."""
    norms = torch.sqrt(torch.sum(m * m, dim=-1, keepdim=True))
    return m / torch.clamp(norms, min=eps)


class LearnedDict:
    """Base class: trained dictionary with `encode`/`decode`/`predict`.
    `decode` is ``nd,bn->bd`` against the normalized dictionary;
    `center`/`uncenter` are overloadable affine hooks."""

    n_feats: int
    activation_size: int

    def get_learned_dict(self) -> torch.Tensor:
        raise NotImplementedError

    def encode(self, batch: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def decode(self, code: torch.Tensor) -> torch.Tensor:
        return code @ self.get_learned_dict()

    def center(self, batch: torch.Tensor) -> torch.Tensor:
        return batch

    def uncenter(self, batch: torch.Tensor) -> torch.Tensor:
        return batch

    def predict(self, batch: torch.Tensor) -> torch.Tensor:
        return self.uncenter(self.decode(self.encode(self.center(batch))))

    def n_dict_components(self) -> int:
        return self.get_learned_dict().shape[0]


# {cls: (array_fields, static_fields)}: serialization reconstructs instances
# by FIELD NAME. LEARNED_DICT_CLASSES maps the bare class name to the class,
# so records written by either package load here by name (no importlib).
LEARNED_DICT_REGISTRY: Dict[type, Tuple[Tuple[str, ...], Tuple[str, ...]]] = {}
LEARNED_DICT_CLASSES: Dict[str, type] = {}


def register_learned_dict(cls, array_fields: Tuple[str, ...], static_fields: Tuple[str, ...] = ()):
    """Register a LearnedDict subclass's array and static fields
    (``n_feats``/``activation_size`` are always static)."""
    static_fields = static_fields + ("n_feats", "activation_size")
    LEARNED_DICT_REGISTRY[cls] = (array_fields, static_fields)
    LEARNED_DICT_CLASSES[cls.__qualname__] = cls
    return cls


class UntiedSAE(LearnedDict):
    """encoder/decoder SAE export."""

    def __init__(self, encoder: torch.Tensor, decoder: torch.Tensor, encoder_bias: torch.Tensor):
        self.encoder = encoder
        self.decoder = decoder
        self.encoder_bias = encoder_bias
        self.n_feats, self.activation_size = encoder.shape

    def get_learned_dict(self):
        return _norm_rows(self.decoder)

    def encode(self, batch):
        return torch.relu(batch @ self.encoder.T + self.encoder_bias)


class TiedSAE(LearnedDict):
    """Tied SAE with optional affine whitening centering:
    center(x) = (R @ (x - t)) * s."""

    def __init__(
        self,
        encoder: torch.Tensor,
        encoder_bias: torch.Tensor,
        centering: Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]] = (None, None, None),
        norm_encoder: bool = False,
    ):
        self.encoder = encoder
        self.encoder_bias = encoder_bias
        self.norm_encoder = norm_encoder
        self.n_feats, self.activation_size = encoder.shape
        t, r, s = centering
        d, kw = self.activation_size, dict(dtype=encoder.dtype, device=encoder.device)
        self.center_trans = t if t is not None else torch.zeros(d, **kw)
        self.center_rot = r if r is not None else torch.eye(d, **kw)
        self.center_scale = s if s is not None else torch.ones(d, **kw)

    def center(self, batch):
        return ((batch - self.center_trans[None, :]) @ self.center_rot.T) * self.center_scale[None, :]

    def uncenter(self, batch):
        return (batch / self.center_scale[None, :]) @ self.center_rot + self.center_trans[None, :]

    def get_learned_dict(self):
        return _norm_rows(self.encoder)

    def encode(self, batch):
        encoder = _norm_rows(self.encoder) if self.norm_encoder else self.encoder
        return torch.relu(batch @ encoder.T + self.encoder_bias)


register_learned_dict(UntiedSAE, ("encoder", "decoder", "encoder_bias"))
register_learned_dict(
    TiedSAE,
    ("encoder", "encoder_bias", "center_trans", "center_rot", "center_scale"),
    ("norm_encoder",),
)
