"""Evaluation metrics for learned dictionaries: FVU, L0, MMCS.

Counterpart of the slice's part of `sparse_coding__tpu/metrics/standard.py`.
Dictionary arguments accept a `LearnedDict` or a raw ``[n_feats, d]`` matrix.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from sparse_coding__tpu_torch.models.learned_dict import LearnedDict


def _as_dict(d) -> torch.Tensor:
    return d.get_learned_dict() if isinstance(d, LearnedDict) else d


def mcs_duplicates(ground, model) -> torch.Tensor:
    """Max cosine sim of each `model` atom against all `ground` atoms
    (rows assumed unit-norm)."""
    return (_as_dict(model) @ _as_dict(ground).T).max(dim=-1).values


def mmcs(model, model2) -> torch.Tensor:
    """Mean max cosine similarity."""
    return mcs_duplicates(model2, model).mean()


def mcs_to_fixed(model, truth: torch.Tensor) -> torch.Tensor:
    return (_as_dict(model) @ truth.T).max(dim=-1).values


def mmcs_to_fixed(model, truth: torch.Tensor) -> torch.Tensor:
    """MMCS against a fixed ground-truth dictionary."""
    return mcs_to_fixed(model, truth).mean()


def sparsity_l0(model: LearnedDict, batch: torch.Tensor) -> torch.Tensor:
    """Mean number of active features per example."""
    c = model.encode(model.center(batch))
    return (c != 0).sum(dim=-1).to(torch.float32).mean()


def fraction_variance_unexplained(model: LearnedDict, batch: torch.Tensor) -> torch.Tensor:
    """FVU = E[(x - x_hat)^2] / E[(x - mean(x))^2]."""
    x_hat = model.predict(batch)
    residuals = torch.mean((batch - x_hat) ** 2)
    total = torch.mean((batch - batch.mean(dim=0)) ** 2)
    return residuals / total


DEFAULT_EVAL_METRICS: Dict[str, Any] = {
    "fvu": fraction_variance_unexplained,
    "l0": sparsity_l0,
}


def evaluate_dicts(
    learned_dicts: List[Any],
    batch: torch.Tensor,
    metric_fns: Dict[str, Any] = None,
) -> List[Dict[str, float]]:
    """Per-dict metrics, one ``{metric: value}`` dict per input in input
    order (``r2 = 1 - fvu`` added with the default metrics). Values come back
    to the host once per dict and metric."""
    defaults = metric_fns is None
    metric_fns = DEFAULT_EVAL_METRICS if defaults else metric_fns
    out: List[Dict[str, float]] = []
    with torch.no_grad():
        for ld in learned_dicts:
            row = {}
            for name, fn in metric_fns.items():
                val = fn(ld, batch)
                row[name] = float(val) if val.ndim == 0 else val.cpu().numpy()
            if defaults:
                row["r2"] = 1.0 - row["fvu"]
            out.append(row)
    return out
