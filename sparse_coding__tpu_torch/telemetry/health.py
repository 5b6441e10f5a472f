"""Per-member training-health pack, computed inside the ensemble step.

Counterpart of `sparse_coding__tpu/telemetry/health.py`, on the stacked
``[M, ...]`` tensors of an ensemble instead of one vmapped member. The step
(`ensemble.Ensemble`, autograd route) calls `health_pack` after the
gradients and before the optimizer, so the metrics are device tensors that
ride the `utils.logging.MetricLogger` buffer (no host sync per step), and the
pack is captured with the rest of the step into its CUDA graph.

Per member (``[M]`` step outputs, prefixed ``health_``):
  - ``health_grad_norm``   global L2 norm of the member's gradients
  - ``health_dict_norm``   mean L2 row norm of the dictionary param
                           ("decoder" when present, else "encoder")
  - ``health_nonfinite``   1.0 when the member's total loss is NaN/Inf
  - ``health_dead_frac``   share of features whose bias-corrected firing
                           EMA is at or below ``dead_threshold``

The firing EMA lives in the ensemble buffers under `FIRE_EMA_KEY` ([M, N]),
so it checkpoints with the state. A signature whose aux has no code ``"c"``
gets ``health_dead_frac = NaN`` and an untouched EMA. The EMA's bias
correction ``1 − decay^(step+1)`` reads the ensemble's step counter on the
device, so a replayed graph sees each step's own count.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

__all__ = ["HealthConfig", "FIRE_EMA_KEY", "health_pack", "init_fire_ema", "n_feats_of"]

FIRE_EMA_KEY = "health_fire_ema"


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """``ema_decay``: per-step decay of the firing-frequency EMA (0.99 ≈ a
    ~100-step window). ``dead_threshold``: a feature is dead when its
    bias-corrected firing frequency is at or below it. Hashable: part of a
    step graph's key."""

    ema_decay: float = 0.99
    dead_threshold: float = 1e-6


def n_feats_of(params) -> int:
    """Dictionary-feature count of one (unstacked) member's params."""
    for key in ("encoder", "decoder"):
        if key in params:
            return int(params[key].shape[0])
    raise ValueError(
        f"health pack needs an 'encoder' or 'decoder' param to size the firing EMA; got keys {sorted(params)}"
    )


def init_fire_ema(n_models: int, n_feats: int, device=None) -> torch.Tensor:
    return torch.zeros((n_models, n_feats), dtype=torch.float32, device=device)


def _global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Each member's L2 norm over all its gradient leaves, the leaves taken
    in sorted key order (the JAX pytree's order) → [M]."""
    leaves = [grads[k] for k in sorted(grads) if grads[k] is not None]
    return torch.sqrt(sum(g.float().square().reshape(g.shape[0], -1).sum(dim=1) for g in leaves))


def _mean(flags: torch.Tensor, dim: int) -> torch.Tensor:
    """The share of true entries along ``dim`` as XLA computes a mean: the
    f32 count times the f32 reciprocal of the length (which can differ from
    a division by an ulp; the counts themselves are exact)."""
    return flags.sum(dim=dim, dtype=torch.float32) * (1.0 / flags.shape[dim])


def health_pack(params, grads, loss, aux, fire_ema, step: torch.Tensor,
                cfg: HealthConfig) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The health metrics of every member: ``params``/``grads`` stacked dicts,
    ``loss`` the total [M], ``aux`` the signature's aux (code ``"c"`` [M, B, N]
    when it has one), ``fire_ema`` [M, N], ``step`` the step count before
    this step (an integer tensor on the device). Returns ``(metrics {name:
    [M] f32}, new_fire_ema)``."""
    with torch.no_grad():
        dict_param = params["decoder"] if "decoder" in params else params["encoder"]
        metrics = {
            "health_grad_norm": _global_norm(grads),
            "health_dict_norm": torch.linalg.vector_norm(dict_param.float(), dim=-1).mean(dim=-1),
            "health_nonfinite": torch.where(torch.isfinite(loss), 0.0, 1.0).to(torch.float32),
        }
        c = aux.get("c") if isinstance(aux, dict) else None
        if c is None:
            metrics["health_dead_frac"] = torch.full_like(loss, float("nan"), dtype=torch.float32)
            return metrics, fire_ema
        fire = _mean((c != 0), dim=1)  # [M, N]
        new_ema = cfg.ema_decay * fire_ema + (1.0 - cfg.ema_decay) * fire
        # Adam-style bias correction: an EMA started at zero under-reports
        # firing for its first ~1/(1 - decay) steps
        bias = 1.0 - torch.pow(cfg.ema_decay, step.to(torch.float32) + 1.0)
        ema_hat = new_ema / torch.clamp_min(bias, 1e-12)
        metrics["health_dead_frac"] = _mean(ema_hat <= cfg.dead_threshold, dim=-1)
        return metrics, new_ema
