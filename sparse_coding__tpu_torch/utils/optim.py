"""Adam over dicts of stacked tensors, in optax's update order.

Counterpart of `sparse_coding__tpu/utils/optim.py::adam`, which for float
moment storage IS `optax.adam`. The expressions and their rounding follow
optax exactly, so the port and the JAX package step alike:

    mu = (1 - b1) * g + b1 * mu        # with mu stored bf16, b1 is rounded to
                                       # bf16 and b1 * mu is a bf16 product
                                       # (optax's weak typing), the sum is f32
    nu = (1 - b2) * g**2 + b2 * nu     # f32
    u  = -lr * (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t) + eps_root) + eps)
    p  = p + u

``1 - b1`` and ``1 - b2`` are python-float values rounded once to f32. Every
leaf carries a leading member axis; ``count`` is ``[n_models]`` int32 (the
JAX ensemble vmaps ``tx.init``), identical across members.

Compressed storage (``nu_dtype`` bf16 via stochastic rounding, int8
moments) is not ported yet: those settings raise ``NotImplementedError``
(ROADMAP B2, still to be ported).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from sparse_coding__tpu_torch.utils.precision import as_dtype

_MOMENT_DTYPES = (None, torch.float32, torch.bfloat16)


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: ``count`` [n_models] int32 and the
    moment dicts, keyed like the params."""

    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


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


class Adam:
    """``optax.adam`` over stacked tensors: `init(params)` and
    `update(grads, state, params)` -> (updates, new_state)."""

    def __init__(self, learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                 mu_dtype=None, nu_dtype=None, seed: int = 0):
        mu_dtype = as_dtype(mu_dtype)
        if mu_dtype not in _MOMENT_DTYPES or nu_dtype is not None:
            raise NotImplementedError(
                f"adam(mu_dtype={mu_dtype}, nu_dtype={nu_dtype}): compressed "
                "moment storage (bf16 nu by stochastic rounding, int8 moments) "
                "is not ported yet — ROADMAP B2"
            )
        if callable(learning_rate):
            raise NotImplementedError(
                "learning-rate schedules are not ported yet — ROADMAP A1"
            )
        self.learning_rate = float(learning_rate)
        self.b1, self.b2, self.eps, self.eps_root = float(b1), float(b2), float(eps), float(eps_root)
        self.mu_dtype = mu_dtype
        # `seed` drives only the stochastic stores, which are not ported

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        n = next(iter(params.values())).shape[0]
        dev = next(iter(params.values())).device
        return AdamState(
            count=torch.zeros(n, dtype=torch.int32, device=dev),
            mu={k: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )

    def update(self, grads, state: AdamState, params=None):
        del params
        count_inc = state.count + 1
        bc1, bc2 = bias_corrections(count_inc, self.b1, self.b2)
        updates, mu_out, nu_out = {}, {}, {}
        for k, g in grads.items():
            mu = f32(1 - self.b1, g) * g + decayed_moment(self.b1, state.mu[k])
            nu = f32(1 - self.b2, g) * (g * g) + decayed_moment(self.b2, state.nu[k])
            mu_hat = mu / _per_member(bc1, mu)
            nu_hat = nu / _per_member(bc2, nu)
            u = mu_hat / (torch.sqrt(nu_hat + self.eps_root) + self.eps)
            updates[k] = f32(-self.learning_rate, u) * u
            mu_out[k] = mu.to(self.mu_dtype) if self.mu_dtype is not None else mu
            nu_out[k] = nu
        return updates, AdamState(count=count_inc, mu=mu_out, nu=nu_out)


def adam(learning_rate=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
         mu_dtype=None, nu_dtype=None, seed: int = 0) -> Adam:
    """`optax.adam` with the JAX package's storage knobs (only float mu
    storage is ported)."""
    return Adam(learning_rate, b1, b2, eps, eps_root, mu_dtype, nu_dtype, seed)


def apply_updates(params: Dict[str, torch.Tensor], updates: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``optax.apply_updates``: ``p + u`` in the param dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
