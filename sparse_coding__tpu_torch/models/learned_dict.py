"""Inference-time dictionary interface and the baseline dictionaries.

Counterpart of `sparse_coding__tpu/models/learned_dict.py`. A `LearnedDict` is
the evaluation view of a trained model: a (possibly normalized) dictionary
``[n_feats, activation_size]`` plus an `encode` map to codes
``[batch, n_feats]``. Array and static field names are the JAX package's, so
export records (`train.checkpoint`) are interchangeable between the two.

The baselines (`Identity`, `IdentityReLU`, `RandomDict`, `ReverseSAE`,
`ThresholdingSAE_export`, `AddedNoise`, `Rotation`) take a ``device`` where
they make their own arrays (None = cuda). The JAX package's RNG keys become
`torch.Generator` draws: `RandomDict`'s encoder and `AddedNoise`'s noise are
the port's own streams, not JAX's.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from sparse_coding__tpu_torch.utils import precision as px
from sparse_coding__tpu_torch.utils.device import resolve_device
from sparse_coding__tpu_torch.utils.tree import tree_paths, tree_unflatten


def jclip(x: torch.Tensor, lo: Optional[float] = None, hi: Optional[float] = None) -> torch.Tensor:
    """``jnp.clip``: ``min(max(x, lo), hi)``, whose gradient at either edge
    is 0.5 (the two arguments of a tie share it), where `torch.clamp`'s is
    1."""
    if lo is not None:
        x = torch.maximum(x, torch.full((), lo, dtype=x.dtype, device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.full((), hi, dtype=x.dtype, device=x.device))
    return x


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


def dict_leaves(ld) -> List[Tuple[str, Tuple, Any]]:
    """A registered dict's array leaves in the JAX package's pytree order,
    ``(field, path, value)``: the fields in registry order, each field's tree
    (a dict of params, LISTA's nested layers, the semi-linear SAE's list of
    layers) by sorted key and list order, ``path`` the keys and indices
    inside the field (``()`` for a plain array); an unregistered dict has
    none."""
    out: List[Tuple[str, Tuple, Any]] = []
    for f in LEARNED_DICT_REGISTRY.get(type(ld), ((), ()))[0]:
        out += [(f, path, v) for path, v in tree_paths(getattr(ld, f))]
    return out


def with_leaves(ld, values: List[Any]):
    """A shallow copy of ``ld`` whose array leaves (`dict_leaves` order) are
    ``values``."""
    new = type(ld).__new__(type(ld))
    new.__dict__.update(ld.__dict__)
    values = iter(values)
    for f in LEARNED_DICT_REGISTRY[type(ld)][0]:
        v = getattr(ld, f)
        setattr(new, f, tree_unflatten(v, [next(values) for _ in tree_paths(v)]))
    return new


def stack_key(ld) -> Optional[Tuple]:
    """The JAX package's pytree-structure key: class, static fields and
    every array leaf's shape and dtype (None for an unregistered dict).
    Dicts with equal keys give values of one shape and stack."""
    if type(ld) not in LEARNED_DICT_REGISTRY:
        return None
    statics = tuple(repr(getattr(ld, f, None)) for f in LEARNED_DICT_REGISTRY[type(ld)][1])
    return (type(ld).__qualname__, statics, tuple((tuple(t.shape), str(t.dtype)) for _, _, t in dict_leaves(ld)))


class Identity(LearnedDict):
    """Pass-through baseline: the code is the activation."""

    def __init__(self, activation_size: int, device=None):
        self.n_feats = activation_size
        self.activation_size = activation_size
        self.device = resolve_device(device)

    def get_learned_dict(self):
        return torch.eye(self.n_feats, device=self.device)

    def encode(self, batch):
        return batch


class IdentityReLU(LearnedDict):
    """relu(x + bias) baseline (bias zero unless given)."""

    def __init__(self, activation_size: int, bias: Optional[torch.Tensor] = None, device=None):
        self.n_feats = activation_size
        self.activation_size = activation_size
        self.bias = bias if bias is not None else torch.zeros(activation_size, device=resolve_device(device))
        assert self.bias.shape == (activation_size,)

    def get_learned_dict(self):
        return torch.eye(self.n_feats, device=self.bias.device)

    def encode(self, batch):
        return torch.relu(batch + self.bias)


class RandomDict(LearnedDict):
    """Random gaussian encoder baseline: relu(x·Eᵀ + 0). ``key`` is a
    `torch.Generator` (whose device the encoder takes) or an int seed (None:
    0) for a generator on ``device``."""

    def __init__(self, activation_size: int, n_feats: Optional[int] = None, key=None, device=None):
        n_feats = n_feats or activation_size
        self.n_feats = n_feats
        self.activation_size = activation_size
        gen = key if isinstance(key, torch.Generator) else (
            torch.Generator(device=resolve_device(device)).manual_seed(int(key or 0)))
        self.encoder = torch.randn((n_feats, activation_size), generator=gen, device=gen.device)
        self.encoder_bias = torch.zeros(n_feats, device=gen.device)

    def get_learned_dict(self):
        return self.encoder

    def encode(self, batch):
        return torch.relu(batch @ self.encoder.T + self.encoder_bias)


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


class ReverseSAE(LearnedDict):
    """Tied SAE that subtracts the bias again from the active features before
    decoding. The decode is ``nd,bn->bd`` on the tied dictionary, the JAX
    package's convention (its reference decodes with the transpose,
    ``dn,bn->bd``, which the encode's geometry does not imply)."""

    def __init__(self, encoder: torch.Tensor, encoder_bias: torch.Tensor, norm_encoder: bool = False):
        self.encoder = encoder
        self.encoder_bias = encoder_bias
        self.norm_encoder = norm_encoder
        self.n_feats, self.activation_size = encoder.shape

    def get_learned_dict(self):
        return _norm_rows(self.encoder)

    def _encoder(self):
        return _norm_rows(self.encoder) if self.norm_encoder else self.encoder

    def encode(self, batch):
        return torch.relu(batch @ self._encoder().T + self.encoder_bias)

    def decode(self, c):
        c = torch.where(c > 0.0, c - self.encoder_bias[None, :], c)
        return c @ self._encoder()


def thresholding_encode(params: Dict[str, torch.Tensor], batch: torch.Tensor,
                        learned_dict: torch.Tensor) -> torch.Tensor:
    """The smooth relu6 soft-threshold encode of the thresholding SAE (the JAX
    package's `FunctionalThresholdingSAE.encode`): scores of the centred
    batch, scaled by the learnable gain and squared scale, then ``relu6(60 (c
    - 0.9)) / 6 + relu(c - 1)``, times the squared scale. One member's params
    and dictionary [N, D] give codes [B, N]; stacked ones [M, N, D] give [M,
    B, N] (the batch [B, D] or [M, B, D]). The scores' matmul runs in the
    precision policy's compute dtype, the rest in f32; both clips have
    `jnp.clip`'s gradient (`jclip`)."""
    batch = batch - params["centering"][..., None, :]
    c = px.acc_f32(torch.matmul(px.cast_in(batch), px.cast_in(learned_dict).transpose(-2, -1)))
    a_sq = (params["activation_scale"] ** 2)[..., None, :]
    c = (c + params["activation_gain"][..., None, :]) / jclip(a_sq, 1e-8)
    c = jclip(60.0 * (c - 0.9), 0.0, 6.0) / 6.0 + torch.relu(c - 1.0)
    return c * a_sq


class ThresholdingSAE_export(LearnedDict):
    """Inference view of the thresholding SAE (`models.sae.
    FunctionalThresholdingSAE`): its raw param dict (``encoder``,
    ``activation_scale``, ``activation_gain``, ``centering``) and the
    smooth-threshold encode."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.params = params
        self.n_feats, self.activation_size = params["encoder"].shape

    def get_learned_dict(self):
        return _norm_rows(self.params["encoder"])

    def encode(self, batch):
        return thresholding_encode(self.params, batch, self.get_learned_dict())


class AddedNoise(LearnedDict):
    """Identity + gaussian noise baseline. ``noise_mag`` is a 0-d f32 array
    leaf; ``_key`` a ``uint32[2]`` leaf (the JAX package's raw PRNG key, an
    int seed ``s`` → ``[0, s]``), so its exports load in both packages. The
    port draws the noise from a `torch.Generator` seeded by the key (not
    JAX's stream) and, where no generator is passed, moves the key on after
    each draw, as the JAX package splits it."""

    def __init__(self, noise_mag: float, activation_size: int, key=None, device=None):
        self.noise_mag = torch.tensor(float(noise_mag), dtype=torch.float32, device=resolve_device(device))
        self.activation_size = activation_size
        self.n_feats = activation_size
        k = np.asarray([0, int(key or 0)] if key is None or np.ndim(key) == 0 else key, dtype=np.uint32)
        self._key = torch.from_numpy(k)

    def get_learned_dict(self):
        return torch.eye(self.activation_size, device=self.noise_mag.device)

    def encode(self, batch, generator: Optional[torch.Generator] = None):
        if generator is None:
            hi, lo = (int(v) for v in np.asarray(self._key.cpu().numpy(), dtype=np.uint64))
            generator = torch.Generator(device=batch.device).manual_seed((hi << 32) | lo)
            noise = torch.randn(batch.shape, generator=generator, device=batch.device, dtype=batch.dtype)
            nxt = torch.randint(0, 2**32, (2,), generator=generator, device=batch.device, dtype=torch.int64)
            self._key = torch.from_numpy(nxt.cpu().numpy().astype(np.uint32))
        else:
            noise = torch.randn(batch.shape, generator=generator, device=batch.device, dtype=batch.dtype)
        return batch + noise * self.noise_mag


class Rotation(LearnedDict):
    """Fixed rotation dictionary: the code is ``x · Mᵀ``."""

    def __init__(self, matrix: torch.Tensor):
        self.matrix = matrix
        self.n_feats, self.activation_size = matrix.shape

    def get_learned_dict(self):
        return self.matrix

    def encode(self, batch):
        return batch @ self.matrix.T


register_learned_dict(Identity, ())
register_learned_dict(IdentityReLU, ("bias",))
register_learned_dict(AddedNoise, ("noise_mag", "_key"))
register_learned_dict(RandomDict, ("encoder", "encoder_bias"))
register_learned_dict(UntiedSAE, ("encoder", "decoder", "encoder_bias"))
register_learned_dict(
    TiedSAE,
    ("encoder", "encoder_bias", "center_trans", "center_rot", "center_scale"),
    ("norm_encoder",),
)
register_learned_dict(ReverseSAE, ("encoder", "encoder_bias"), ("norm_encoder",))
register_learned_dict(Rotation, ("matrix",))
register_learned_dict(ThresholdingSAE_export, ("params",))
