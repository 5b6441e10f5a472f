"""Carry state across from the JAX package.

`state_from_jax_numpy` takes the JAX `Ensemble`'s state as numpy arrays
(``jax.device_get`` is the caller's: this module imports no JAX) and returns
the port's `EnsembleState`; `big_batch_state_from_jax_numpy` does the same
for the big-batch trainer's `BigBatchState`, and `lm_params_from_jax` for a
subject LM's param tree. Both packages then compute from the same point.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from sparse_coding__tpu_torch.ensemble import EnsembleState
from sparse_coding__tpu_torch.utils.device import resolve_device
from sparse_coding__tpu_torch.utils.optim import AdamState, QuantMoment
from sparse_coding__tpu_torch.utils.tree import tree_leaves, tree_map


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
    untied `FunctionalSAE` and of `FunctionalFista`, LISTA's nested
    ``encoder_layers`` dict, the semi-linear SAE's list of layers: any tree
    of dicts and lists goes), buffers (None for absent centering; FISTA's
    ``hessian_diag``, the health pack's ``health_fire_ema`` and the feature
    sketch's ``featstat_*`` like any other), and optax's
    ``(ScaleByAdamState(count, mu, nu), EmptyState())`` flattened to
    ``{"count", "mu", "nu"}``, the moments trees of the params' structure —
    each moment keeps its storage: f32, bf16, or an int8 ``QuantMoment``
    node (q and scale). With
    ``opt_state=None`` the moments start at zero. Every array carries the
    leading member axis."""
    device = resolve_device(device)
    p = tree_map(lambda v: _tensor(v, device), params)
    b = tree_map(lambda v: _tensor(v, device), buffers)
    if opt_state is None:
        n = tree_leaves(p)[0].shape[0]
        adam = AdamState(
            count=torch.zeros(n, dtype=torch.int32, device=device),
            mu=tree_map(torch.zeros_like, p),
            nu=tree_map(torch.zeros_like, p),
        )
    else:
        # the moments walked along the params' structure: a JAX QuantMoment
        # node at a leaf's place is taken whole
        adam = AdamState(
            count=_tensor(opt_state["count"], device).to(torch.int32),
            mu=tree_map(lambda _p, v: _moment(v, device), p, opt_state["mu"]),
            nu=tree_map(lambda _p, v: _moment(v, device), p, opt_state["nu"]),
        )
    return EnsembleState(params=p, buffers=b, opt_state=adam, step=int(step))


def big_batch_state_from_jax_numpy(
    params: Dict[str, Any],
    buffers: Dict[str, Any],
    opt_state: Dict[str, Any],
    c_totals,
    step,
    device=None,
):
    """The JAX `train.big_batch.BigBatchState` as the port's: one member's
    params and buffers (no member axis), optax's Adam state flattened to
    ``{"count", "mu", "nu"}`` (``count`` 0-d int32), ``c_totals`` [n_feats]
    and the 0-d int32 step, every array copied exactly to ``device``."""
    from sparse_coding__tpu_torch.train.big_batch import BigBatchState

    device = resolve_device(device)
    return BigBatchState(
        params=tree_map(lambda v: _tensor(v, device), params),
        buffers=tree_map(lambda v: _tensor(v, device), buffers),
        opt_state=AdamState(
            count=_tensor(opt_state["count"], device).to(torch.int32).reshape(()),
            mu=tree_map(lambda v: _moment(v, device), opt_state["mu"]),
            nu=tree_map(lambda v: _moment(v, device), opt_state["nu"]),
        ),
        c_totals=_tensor(c_totals, device).to(torch.float32),
        step=_tensor(step, device).to(torch.int32).reshape(()),
    )


def lm_params_from_jax(params_np, device=None):
    """The JAX subject LM's param tree (`lm.model.init_params` /
    `lm.convert.params_from_hf` layout: dicts and a list of blocks), its
    leaves as numpy arrays, as the port's tree of tensors on ``device``
    (None = cuda). The layouts are the same, so this is a plain copy; bf16
    leaves keep their bits."""
    device = resolve_device(device)
    return tree_map(lambda a: _tensor(a, device), params_np)
