"""Carry an ensemble's state across from the JAX package.

`state_from_jax_numpy` takes the JAX `Ensemble`'s state as numpy arrays
(``jax.device_get`` is the caller's: this module imports no JAX) and returns
the port's `EnsembleState`, so both packages compute from the same point.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from sparse_coding__tpu_torch.ensemble import EnsembleState
from sparse_coding__tpu_torch.utils.device import resolve_device
from sparse_coding__tpu_torch.utils.optim import AdamState, QuantMoment


def _tensor(a, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16 has no torch counterpart in numpy
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _moment(v, device):
    """A moment leaf: an array, or the JAX package's `QuantMoment` node (its
    ``q`` and ``scale``) as the port's, codes and scales carried exactly."""
    if hasattr(v, "q") and hasattr(v, "scale"):
        return QuantMoment(q=_tensor(v.q, device), scale=_tensor(v.scale, device))
    return _tensor(v, device)


def state_from_jax_numpy(
    params: Dict[str, Any],
    buffers: Dict[str, Any],
    opt_state: Optional[Dict[str, Any]] = None,
    step: int = 0,
    device=None,
) -> EnsembleState:
    """params (``{"encoder", "encoder_bias"}`` of a tied SAE, ``{"dict"}`` of
    a TopK signature, ``{"encoder", "encoder_bias", "decoder"}`` of the
    untied `FunctionalSAE` and of `FunctionalFista`: any dict of params
    goes), buffers (None for absent centering; FISTA's
    ``hessian_diag``, the health pack's ``health_fire_ema`` and the feature
    sketch's ``featstat_*`` like any other), and optax's
    ``(ScaleByAdamState(count, mu, nu), EmptyState())`` flattened to
    ``{"count", "mu", "nu"}`` — each moment keeps its storage: f32, bf16, or
    an int8 ``QuantMoment`` node (q and scale). With
    ``opt_state=None`` the moments start at zero. Every array carries the
    leading member axis."""
    device = resolve_device(device)
    p = {k: _tensor(v, device) for k, v in params.items()}
    b = {k: _tensor(v, device) for k, v in buffers.items()}
    if opt_state is None:
        n = next(iter(p.values())).shape[0]
        adam = AdamState(
            count=torch.zeros(n, dtype=torch.int32, device=device),
            mu={k: torch.zeros_like(v) for k, v in p.items()},
            nu={k: torch.zeros_like(v) for k, v in p.items()},
        )
    else:
        adam = AdamState(
            count=_tensor(opt_state["count"], device).to(torch.int32),
            mu={k: _moment(v, device) for k, v in opt_state["mu"].items()},
            nu={k: _moment(v, device) for k, v in opt_state["nu"].items()},
        )
    return EnsembleState(params=p, buffers=b, opt_state=adam, step=int(step))
