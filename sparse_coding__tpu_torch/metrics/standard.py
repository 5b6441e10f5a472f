"""Evaluation metrics for learned dictionaries.

Counterpart of `sparse_coding__tpu/metrics/standard.py`: the MMCS family,
reconstruction quality (FVU, L0, R²), feature-activity and capacity
statistics, streaming per-feature moments, the sklearn probe AUROCs, and
`evaluate_dicts`, which evaluates a whole sweep's dicts with one host read
per group of like dicts and metric.
Dictionary arguments accept a `LearnedDict` or a raw ``[n_feats, d]``
matrix where noted. Array results are tensors on the inputs' device;
`hungarian_matched_mcs` (scipy) and the AUROC probes (sklearn, imported
when called) run on the host.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from sparse_coding__tpu_torch.models.learned_dict import LearnedDict, stack_key


def _as_dict(d) -> torch.Tensor:
    return d.get_learned_dict() if isinstance(d, LearnedDict) else d


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- the MMCS family ------------------------------------------------------------

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


def mmcs_from_list(ld_list: List[Any]) -> torch.Tensor:
    """Symmetric [n, n] matrix of pairwise MMCS (ones on the diagonal), built
    on the host (a CPU tensor)."""
    n = len(ld_list)
    out = np.eye(n, dtype=np.float32)
    for i in range(n):
        for j in range(i):
            out[i, j] = out[j, i] = float(mmcs(ld_list[i], ld_list[j]))
    return torch.from_numpy(out)


def representedness(features: torch.Tensor, model) -> torch.Tensor:
    """For each ground-truth feature, its best cosine match in the model."""
    return (features @ _as_dict(model).T).max(dim=-1).values


def hungarian_matched_mcs(model, truth: torch.Tensor) -> Tuple[torch.Tensor, np.ndarray]:
    """Optimal 1:1 assignment of model atoms to ground-truth atoms (scipy's
    Hungarian solver on the host). Returns (the matched cosine sims, one per
    assigned truth atom, on the truth's device; the model atom assigned to
    each)."""
    from scipy.optimize import linear_sum_assignment

    cos = _host(truth @ _as_dict(model).T)
    rows, cols = linear_sum_assignment(-cos)
    return torch.from_numpy(cos[rows, cols]).to(truth.device), cols


# -- reconstruction quality -----------------------------------------------------

def mean_nonzero_activations(model: LearnedDict, batch: torch.Tensor) -> torch.Tensor:
    """Per-feature activation frequency [n_feats]."""
    c = model.encode(model.center(batch))
    return (c != 0).to(torch.float32).mean(dim=0)


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


def fraction_variance_unexplained_top_activating(
    model: LearnedDict, batch: torch.Tensor, n_top: int = 2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FVU of the reconstruction from the ``n_top`` features of highest mean
    activation alone, and from all the others (ties in the mean broken
    toward the lower index: a stable sort, as `jnp.argsort`)."""
    c = model.encode(model.center(batch))
    order = torch.argsort(-c.mean(dim=0), stable=True)
    is_top = torch.zeros(c.shape[-1], dtype=torch.bool, device=c.device)
    is_top[order[:n_top]] = True
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    c_top = torch.where(is_top[None, :], c, zero)
    c_rest = torch.where(is_top[None, :], zero, c)
    x_hat_top = model.center(model.decode(c_top))
    x_hat_rest = model.center(model.decode(c_rest))
    variance = torch.mean((batch - batch.mean(dim=0)) ** 2)
    return torch.mean((batch - x_hat_top) ** 2) / variance, torch.mean((batch - x_hat_rest) ** 2) / variance


def r_squared(model: LearnedDict, batch: torch.Tensor) -> torch.Tensor:
    return 1.0 - fraction_variance_unexplained(model, batch)


def neurons_per_feature(model) -> torch.Tensor:
    """Mean Simpson-diversity count of neurons per learned feature."""
    c = _as_dict(model)
    c = c / torch.abs(c).sum(dim=-1, keepdim=True)
    return (1.0 / (c**2).sum(dim=-1)).mean()


def capacity_per_feature(model) -> torch.Tensor:
    """Each feature's capacity (Scherlis et al. 2022): its squared self
    product over the sum of its squared products with every feature."""
    d = _as_dict(model)
    sq = (d @ d.T) ** 2
    return torch.diagonal(sq) / sq.sum(dim=-1)


def interference_capacity(model) -> torch.Tensor:
    """Sum of the features' capacities."""
    return capacity_per_feature(model).sum()


# -- per-feature activation statistics -----------------------------------------

def calc_feature_n_active(batch: torch.Tensor) -> torch.Tensor:
    return (batch != 0).sum(dim=0)


def batched_calc_feature_n_ever_active(model: LearnedDict, activations: torch.Tensor, batch_size: int = 1000,
                                       threshold: int = 10) -> int:
    """Number of features active more than ``threshold`` times over the data
    (encoded ``batch_size`` rows at a time; one host read)."""
    count = torch.zeros(model.n_feats, device=activations.device)
    for i in range(0, activations.shape[0], batch_size):
        count = count + calc_feature_n_active(model.encode(activations[i : i + batch_size]))
    return int((count > threshold).sum())


def calc_feature_mean(batch):
    return batch.mean(dim=0)


def calc_feature_variance(batch):
    return batch.var(dim=0, correction=1)


def calc_feature_skew(batch):
    """Asymmetric skew centred at 0."""
    var = batch.var(dim=0, correction=1)
    return (batch**3).mean(dim=0) / torch.clamp(var**1.5, min=1e-8)


def calc_feature_kurtosis(batch):
    """Asymmetric kurtosis centred at 0."""
    var = batch.var(dim=0, correction=1)
    return (batch**4).mean(dim=0) / torch.clamp(var**2, min=1e-8)


def calc_moments_streaming(model: LearnedDict, activations: torch.Tensor, batch_size: int = 1000):
    """Streaming per-feature moments over the activations' whole batches of
    ``batch_size`` rows (a trailing partial batch is dropped), the JAX
    package's weighted update term for term (its weights in f32, from an f32
    row count on the device); no host read. Returns (times_active, mean,
    var, skew, kurtosis, m4), each [n_feats]."""
    dev = activations.device
    zeros = torch.zeros(model.n_feats, device=dev)
    times_active, mean, m2, m3, m4 = zeros, zeros, zeros, zeros, zeros
    count = torch.zeros((), device=dev)
    for i in range(activations.shape[0] // batch_size):
        c = model.encode(activations[i * batch_size : (i + 1) * batch_size])
        b_mean = c.mean(dim=0)
        times_active = times_active + (b_mean != 0)
        w_old = count / (count + batch_size)
        w_new = batch_size / (count + batch_size)
        mean = w_old * mean + w_new * b_mean
        m2 = w_old * m2 + w_new * (c**2).mean(dim=0)
        m3 = w_old * m3 + w_new * (c**3).mean(dim=0)
        m4 = w_old * m4 + w_new * (c**4).mean(dim=0)
        count = count + batch_size
    var = m2 - mean**2
    skew = m3 / torch.clamp(var**1.5, min=1e-8)
    kurtosis = m4 / torch.clamp(var**2, min=1e-8)
    return times_active, mean, var, skew, kurtosis, m4


# -- probe AUROCs (host, sklearn) ------------------------------------------------

def logistic_regression_auroc(activations, labels, **kwargs) -> float:
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import roc_auc_score

    x, y = _host(activations), _host(labels)
    clf = LogisticRegression(**kwargs)
    clf.fit(x, y)
    return float(roc_auc_score(y, clf.predict_proba(x)[:, 1]))


def ridge_regression_auroc(activations, labels, **kwargs) -> float:
    from sklearn.linear_model import RidgeClassifier
    from sklearn.metrics import roc_auc_score

    x, y = _host(activations), _host(labels)
    clf = RidgeClassifier(**kwargs)
    clf.fit(x, y)
    return float(roc_auc_score(y, clf.predict(x)))


# -- evaluating many dicts at once -----------------------------------------------

def group_stackable_dicts(learned_dicts: List[Any]) -> List[List[int]]:
    """Indices grouped by `models.learned_dict.stack_key` (class, static
    fields, leaf shapes and dtypes), the JAX package's pytree-structure key:
    the dicts of a group give metric values of one shape. An unregistered
    dict is a group of its own."""
    groups: Dict[Any, List[int]] = {}
    for i, ld in enumerate(learned_dicts):
        groups.setdefault(stack_key(ld) or ("unregistered", i), []).append(i)
    return list(groups.values())


# r2 is derived on the host as 1 - fvu
DEFAULT_EVAL_METRICS: Dict[str, Any] = {
    "fvu": fraction_variance_unexplained,
    "l0": sparsity_l0,
}


def _row_value(v: np.ndarray):
    return float(v) if v.ndim == 0 else v


def evaluate_dicts(
    learned_dicts: List[Any],
    batch: torch.Tensor,
    metric_fns: Dict[str, Any] = None,
) -> List[Dict[str, float]]:
    """Per-dict metrics, one ``{metric: value}`` dict per input in input
    order (``r2 = 1 - fvu`` added with the default metrics). Each metric
    ``fn(learned_dict, batch) -> scalar or vector`` runs on each dict alone,
    on the batch's device; the values of a group of dicts that stack
    (`group_stackable_dicts`) are stacked there and brought to the host once
    per group and metric."""
    defaults = metric_fns is None
    metric_fns = DEFAULT_EVAL_METRICS if defaults else metric_fns
    out: List[Dict[str, float]] = [dict() for _ in learned_dicts]
    with torch.no_grad():
        for idxs in group_stackable_dicts(learned_dicts):
            for name, fn in metric_fns.items():
                vals = _host(torch.stack([torch.as_tensor(fn(learned_dicts[i], batch)) for i in idxs]))
                for j, i in enumerate(idxs):
                    out[i][name] = _row_value(vals[j])
    if defaults:
        for row in out:
            row["r2"] = 1.0 - row["fvu"]
    return out
