"""Adam over dicts of stacked tensors, in optax's update order, with the JAX
package's compressed moment storage.

Counterpart of `sparse_coding__tpu/utils/optim.py::adam`. For float moment
storage that IS `optax.adam`; the expressions and their rounding follow optax
exactly, so the port and the JAX package step alike:

    mu = (1 - b1) * g + b1 * mu        # with mu stored bf16, b1 is rounded to
                                       # bf16 and b1 * mu is a bf16 product
                                       # (optax's weak typing), the sum is f32
    nu = (1 - b2) * g**2 + b2 * nu     # f32 (nu upcast first when compressed)
    u  = -lr * (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t) + eps_root) + eps)
    p  = p + u

``1 - b1`` and ``1 - b2`` are python-float values rounded once to f32. Every
leaf carries a leading member axis; ``count`` is ``[n_models]`` int32 (the
JAX ensemble vmaps ``tx.init``), identical across members.

Compressed storage (``scale_by_adam_compressed`` in the JAX package):
  - ``nu_dtype="bfloat16"``: the EMA runs in f32 and the update uses the
    unrounded value; only the carried state is stored bf16, by an unbiased
    stochastic rounding (`stochastic_round`), every leaf.
  - ``"int8"`` (mu or nu): a leaf whose MEMBER is at least 2-D becomes a
    `QuantMoment` (int8 codes + one f32 absmax scale per row, stored by
    `quantize_rows_stochastic`); 1-D member leaves (biases) stay f32. The
    JAX package decides this under ``vmap``, on per-member leaves, so the
    stacked bias ``[M, N]`` stays f32 here too.

Random bits: the JAX package draws the unfused stores from ``jax.random``'s
threefry, which torch cannot reproduce. Here every stochastic store takes its
bits from the JAX package's counter hash (`mix32`, the interpret-mode
`_uniform_bits` of its kernels), seeded from ``(seed, step count, leaf)``:
deterministic, on the device, and unbiased, which is the contract
(`tests/test_torch_capacity_optim.py`). The fused kernels' stores use the
same hash with the kernel's own tile seeds (`ops.tied_sae_kernel.tile_bits`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Union

import torch

from sparse_coding__tpu_torch.utils.precision import as_dtype

_MOMENT_DTYPES = (None, torch.float32, torch.bfloat16, torch.int8)
_U32 = 0xFFFFFFFF
# salts of the unfused stores' streams (the JAX package folds 0x5117 into
# the int8-mu key; any fixed value decorrelates the streams)
_SALT_MU, _SALT_NU = 0x5117, 0x0A11CE


@dataclasses.dataclass
class QuantMoment:
    """An int8-quantized Adam moment: ``value ≈ q * scale[..., None]``, with
    ``q`` int8 of the param's shape and ``scale`` f32 of that shape minus the
    last axis (one symmetric absmax scale per row)."""

    q: torch.Tensor
    scale: torch.Tensor

    def dequant(self) -> torch.Tensor:
        return self.q.float() * self.scale[..., None]


Moment = Union[torch.Tensor, QuantMoment]


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: ``count`` [n_models] int32 and the
    moment dicts, keyed like the params (values tensors or `QuantMoment`s)."""

    count: torch.Tensor
    mu: Dict[str, Moment]
    nu: Dict[str, Moment]


def f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A python float rounded once to an f32 scalar on ``like``'s device
    (filled there: no host-to-device copy, so no wait for queued work)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _per_member(v: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (leaf.ndim - v.ndim))


def bias_corrections(count_inc: torch.Tensor, b1: float, b2: float):
    """``(1 - b1**t, 1 - b2**t)`` in f32 per member, ``t = count + 1``."""
    tf = count_inc.to(torch.float32)
    return 1.0 - torch.pow(f32(b1, tf), tf), 1.0 - torch.pow(f32(b2, tf), tf)


def decayed_moment(b: float, prev: torch.Tensor) -> torch.Tensor:
    """``b * prev`` as optax computes it: in the storage dtype, with the
    python float rounded to that dtype first (the bf16-mu trap: torch would
    otherwise multiply by the unrounded scalar)."""
    return f32(b, prev).to(prev.dtype) * prev


# -- the counter hash and the stochastic stores ----------------------------------
# u32 arithmetic on int64 tensors (or python ints): every value stays in
# [0, 2^32) and no product leaves int64's range.

def mul32(a, c: int):
    """``a * c mod 2^32`` for u32 values ``a`` and a u32 constant ``c``."""
    return ((a & 0xFFFF) * c + ((((a >> 16) * c) & 0xFFFF) << 16)) & _U32


def mix32(h):
    """The murmur3 finalizer of the JAX package's kernels (`_mix32`)."""
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def as_u32(seed, device=None) -> torch.Tensor:
    """A seed (python int or integer tensor) as an int64 u32 tensor."""
    return torch.as_tensor(seed, device=device).to(torch.int64) & _U32


def uniform_bits(rows: int, cols: int, seed) -> torch.Tensor:
    """The JAX package's interpret-mode `_uniform_bits((rows, cols), seed)`:
    ``mix32((r * cols + c) ^ seed)``, as int64 u32 values [rows, cols] on
    the seed's device (the CPU for an int)."""
    seed = as_u32(seed)
    idx = torch.arange(rows * cols, dtype=torch.int64, device=seed.device).reshape(rows, cols)
    return mix32(idx ^ seed)


def quantize_rows_stochastic(x: torch.Tensor, bits: torch.Tensor) -> QuantMoment:
    """Symmetric per-row absmax int8 quantization with an unbiased store
    ``floor(x / scale + u)``, u = (bits >> 8) · 2^-24 ∈ [0, 1) — the JAX
    package's `_quantize_rows_int8_sr` given the same bits. Scale = absmax /
    127 (all-zero rows get 1). Non-finite rows as in JAX: a NaN anywhere makes
    the row's absmax NaN, so its scale is 1 and NaN elements store 0; an inf
    absmax gives scale inf (finite elements store 0); ±inf elements of a
    row whose scale is finite saturate to ±127."""
    xf = x.float()
    absmax = torch.amax(xf.abs(), dim=-1)  # NaN propagates, as jnp.max
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    v = xf / scale[..., None]
    v = torch.where(torch.isnan(v), torch.zeros_like(v), v).clamp(-127.0, 127.0)
    u = (bits >> 8).to(torch.float32) * 2.0 ** -24
    q = torch.floor(v + u).clamp(-127.0, 127.0).to(torch.int8)
    return QuantMoment(q=q, scale=scale)


def stochastic_round(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Unbiasedly round f32 ``x`` to bf16: add the low 16 of ``bits`` to the
    f32 pattern and keep the upper half, so E[round(x)] = x. Non-finite
    values pass through a plain cast (inf stays inf, NaN becomes the quiet
    NaN 0x7FC0 with its sign, as XLA casts it) — the JAX package's
    `stochastic_round` / `_stochastic_round_bf16` given the same bits."""
    xf = x.float().contiguous()
    xb = xf.view(torch.int32).to(torch.int64) & _U32
    up = (xb + (bits & 0xFFFF)) >> 16
    cast = torch.where(torch.isnan(xf), (xb >> 16) & 0x8000 | 0x7FC0, xb >> 16)
    out = torch.where(torch.isfinite(xf), up, cast)
    return torch.where(out >= 0x8000, out - 0x10000, out).to(torch.int16).view(torch.bfloat16)


def _leaf_bits(like: torch.Tensor, seed: int, count: torch.Tensor, leaf: int, salt: int) -> torch.Tensor:
    """The unfused stores' bits for one leaf at one step: the counter hash
    over the leaf as [rows, last dim], seeded by (seed, count, leaf, salt)."""
    s = mix32(mix32((seed ^ salt) & _U32) ^ mul32(as_u32(count, like.device), 0x9E3779B9)
              ^ mul32(leaf, 0x7FEB352D))
    d = like.shape[-1] if like.ndim else 1
    return uniform_bits(like.numel() // d, d, s).reshape(like.shape)


def _quantized(dtype, leaf: torch.Tensor) -> bool:
    """int8 storage applies to leaves whose member (leaf minus the stacked
    member axis) is at least 2-D."""
    return dtype == torch.int8 and leaf.ndim - 1 >= 2


def dequant(m: Moment) -> torch.Tensor:
    """A moment's f32 value (int8 dequantized, bf16 upcast)."""
    return m.dequant() if isinstance(m, QuantMoment) else m.float()


class Adam:
    """``optax.adam`` over stacked tensors with the JAX package's storage
    knobs: `init(params)` and `update(grads, state, params)` -> (updates,
    new_state)."""

    def __init__(self, learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                 mu_dtype=None, nu_dtype=None, seed: int = 0):
        mu_dtype, nu_dtype = as_dtype(mu_dtype), as_dtype(nu_dtype)
        if mu_dtype not in _MOMENT_DTYPES or nu_dtype not in _MOMENT_DTYPES:
            raise NotImplementedError(
                f"adam(mu_dtype={mu_dtype}, nu_dtype={nu_dtype}): moment storage "
                "other than float32, bfloat16 or int8 is not ported"
            )
        if callable(learning_rate):
            raise NotImplementedError(
                "learning-rate schedules are not ported yet — ROADMAP A1"
            )
        self.learning_rate = float(learning_rate)
        self.b1, self.b2, self.eps, self.eps_root = float(b1), float(b2), float(eps), float(eps_root)
        self.mu_dtype, self.nu_dtype = mu_dtype, nu_dtype
        self.seed = int(seed)

    def _init_moment(self, p: torch.Tensor, dtype) -> Moment:
        if _quantized(dtype, p):
            return QuantMoment(q=torch.zeros_like(p, dtype=torch.int8),
                               scale=torch.ones(p.shape[:-1], dtype=torch.float32, device=p.device))
        if dtype == torch.int8:  # 1-D member leaves stay f32
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros_like(p, dtype=dtype or p.dtype)

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        n = next(iter(params.values())).shape[0]
        dev = next(iter(params.values())).device
        return AdamState(
            count=torch.zeros(n, dtype=torch.int32, device=dev),
            mu={k: self._init_moment(p, self.mu_dtype) for k, p in params.items()},
            nu={k: self._init_moment(p, self.nu_dtype) for k, p in params.items()},
        )

    def _store(self, value: torch.Tensor, prev: Moment, dtype, bits) -> Moment:
        """A moment's carried state in its storage tier: int8 rows and (for
        nu) bf16 by the stochastic stores, float tiers by a plain cast.
        ``bits()`` makes the store's random bits."""
        if isinstance(prev, QuantMoment):
            return quantize_rows_stochastic(value, bits())
        if dtype == torch.int8:  # a 1-D member leaf
            return value.float()
        return value.to(dtype) if dtype is not None else value

    def update(self, grads, state: AdamState, params=None):
        del params
        count_inc = state.count + 1
        bc1, bc2 = bias_corrections(count_inc, self.b1, self.b2)
        updates, mu_out, nu_out = {}, {}, {}
        # leaves in sorted key order: the JAX package's tree order
        for i, k in enumerate(sorted(grads)):
            g, mu_prev, nu_prev = grads[k], state.mu[k], state.nu[k]
            if isinstance(mu_prev, QuantMoment):
                mu = f32(1 - self.b1, g) * g + f32(self.b1, g) * mu_prev.dequant()
            else:
                mu = f32(1 - self.b1, g) * g + decayed_moment(self.b1, mu_prev)
            nu = f32(1 - self.b2, g) * (g * g) + f32(self.b2, g) * dequant(nu_prev)
            mu_hat = mu / _per_member(bc1, mu)
            nu_hat = nu / _per_member(bc2, nu)
            u = mu_hat / (torch.sqrt(nu_hat + self.eps_root) + self.eps)
            updates[k] = f32(-self.learning_rate, u) * u
            t = count_inc[0]
            mu_out[k] = self._store(mu, mu_prev, self.mu_dtype,
                                    lambda: _leaf_bits(mu, self.seed, t, i, _SALT_MU))
            nu_bits = lambda: _leaf_bits(nu, self.seed, t, i, _SALT_NU)
            if self.nu_dtype == torch.bfloat16:
                nu_out[k] = stochastic_round(nu, nu_bits())
            else:
                nu_out[k] = self._store(nu, nu_prev, self.nu_dtype, nu_bits)
        return updates, AdamState(count=count_inc, mu=mu_out, nu=nu_out)


def adam(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
         mu_dtype=None, nu_dtype=None, seed: int = 0) -> Adam:
    """`optax.adam` with the JAX package's storage knobs (``mu_dtype`` and
    ``nu_dtype`` in {None, float32, bfloat16, int8}; ``seed`` seeds the
    stochastic stores)."""
    return Adam(learning_rate, b1, b2, eps, eps_root, mu_dtype, nu_dtype, seed)


def apply_updates(params: Dict[str, torch.Tensor], updates: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``optax.apply_updates``: ``p + u`` in the param dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
