"""FVU ↔ perplexity scatter with PCA / added-noise baselines.

Counterpart of `sparse_coding__tpu/experiments/pca_perplexity.py` (the
reference's `experiments/pca_perplexity.py:33-169`): for every learned dict,
plus AddedNoise, dynamic-PCA and static-PCA baselines, the FVU on an
activation sample and the LM loss with the hook point replaced by the
dict's reconstruction, then a scatter of loss against FVU.

`pca_perplexity_scores` is the device half (the streaming PCA, the FVUs and
every edited forward, on ``device``); `run_pca_perplexity` calls it, then
writes the CSV, the JSON and the figure (matplotlib, imported only there).
AddedNoise draws the port's own noise stream, not JAX's.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparse_coding__tpu_torch.experiments._figures import pyplot
from sparse_coding__tpu_torch.lm import model as lm_model
from sparse_coding__tpu_torch.metrics.intervention import Location, mean_reconstruction_loss
from sparse_coding__tpu_torch.metrics.standard import fraction_variance_unexplained
from sparse_coding__tpu_torch.models.learned_dict import AddedNoise
from sparse_coding__tpu_torch.models.pca import BatchedPCA, calc_pca
from sparse_coding__tpu_torch.utils.device import resolve_device


def train_pca(activations, batch_size: int = 5000, device=None) -> BatchedPCA:
    """Streaming PCA over the activation chunk (reference `train_pca`)."""
    return calc_pca(activations, batch_size=batch_size, device=device)


def baseline_sets(activations, pca_step: int = 8, noise_mags: Optional[Sequence[float]] = None,
                  device=None) -> Dict[str, List[Tuple[Any, Dict[str, Any]]]]:
    """The baselines scored beside the dicts: AddedNoise at each magnitude
    (default 32 from 0 to 0.5), and PCA with ``k`` = 1, 1 + pca_step, ...
    < d/2 components, dynamic (top-k of the PCA code) and static (the
    rotation onto the first ``n`` components)."""
    d_act = activations.shape[1]
    pca = train_pca(activations, device=device)
    mags = np.linspace(0.0, 0.5, 32) if noise_mags is None else np.asarray(noise_mags)
    return {
        "Added Noise": [(AddedNoise(float(m), d_act, device=device), {"dict_size": d_act, "mag": float(m)})
                        for m in mags],
        "PCA (dynamic)": [(pca.to_learned_dict(k), {"dict_size": d_act, "k": k})
                          for k in range(1, d_act // 2, pca_step)],
        "PCA (static)": [(pca.to_rotation_dict(n), {"dict_size": d_act, "n": n})
                         for n in range(1, d_act // 2, pca_step)],
    }


def pca_perplexity_scores(
    params,
    lm_cfg: lm_model.LMConfig,
    location: Location,
    tokens,
    activations,
    dict_sets: Dict[str, List[Tuple[Any, Dict[str, Any]]]],
    n_sample: int = 10000,
    noise_mags: Optional[Sequence[float]] = None,
    pca_step: int = 8,
    token_batch: int = 16,
    seed: int = 0,
    device=None,
) -> Dict[str, List[Tuple[float, float]]]:
    """``{label: [(fvu, lm_loss), ...]}`` for every dict set and the
    baselines (`baseline_sets`), on ``device`` (None = cuda): the FVU on a
    sample of ``n_sample`` rows (drawn without replacement by numpy's
    ``default_rng(seed)``, as in JAX), the mean edited-forward loss over the
    whole ``token_batch``-row batches of ``tokens``."""
    device = resolve_device(device)
    if tokens.shape[0] == 0:
        raise ValueError(f"no token rows to evaluate (tokens.shape={tuple(tokens.shape)})")
    acts = torch.as_tensor(np.asarray(activations) if not isinstance(activations, torch.Tensor) else activations)
    acts = acts.to(device=device, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    idx = rng.choice(acts.shape[0], min(n_sample, acts.shape[0]), replace=False)
    sample = acts[torch.from_numpy(idx).to(device)]
    sets = {**dict_sets, **baseline_sets(acts, pca_step=pca_step, noise_mags=noise_mags, device=device)}

    token_batch = min(token_batch, tokens.shape[0])
    n = (tokens.shape[0] // token_batch) * token_batch
    toks = np.asarray(tokens[:n].cpu() if isinstance(tokens, torch.Tensor) else tokens[:n])
    batches = toks.reshape(-1, token_batch, toks.shape[1])

    scores: Dict[str, List[Tuple[float, float]]] = {}
    for label, ld_set in sets.items():
        scores[label] = []
        for ld, _hp in ld_set:
            fvu = float(fraction_variance_unexplained(ld, sample))
            loss = mean_reconstruction_loss(params, lm_cfg, ld, location, batches, device=device)
            scores[label].append((fvu, loss))
    return scores


def run_pca_perplexity(
    params,
    lm_cfg: lm_model.LMConfig,
    location: Location,
    tokens,
    activations,
    dict_sets: Dict[str, List[Tuple[Any, Dict[str, Any]]]],
    out_dir,
    n_sample: int = 10000,
    noise_mags: Optional[Sequence[float]] = None,
    pca_step: int = 8,
    token_batch: int = 16,
    seed: int = 0,
    device=None,
) -> Dict[str, List[Tuple[float, float]]]:
    """Score every dict set and the baselines (`pca_perplexity_scores`);
    write ``pca_perplexity.{csv,json,png}`` into ``out_dir``. Returns the
    scores. Needs matplotlib (checked before any scoring)."""
    pyplot()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    scores = pca_perplexity_scores(params, lm_cfg, location, tokens, activations, dict_sets, n_sample=n_sample,
                                   noise_mags=noise_mags, pca_step=pca_step, token_batch=token_batch, seed=seed,
                                   device=device)
    with open(out_dir / "pca_perplexity.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["label", "fvu", "lm_loss"])
        for label, pts in scores.items():
            for fvu, loss in pts:
                w.writerow([label, fvu, loss])
    with open(out_dir / "pca_perplexity.json", "w") as f:
        json.dump({k: v for k, v in scores.items()}, f)
    _plot(scores, out_dir / "pca_perplexity.png")
    return scores


def _plot(scores, path):
    import itertools

    plt = pyplot()
    colors = ["red", "blue", "green", "orange", "purple", "black"]
    markers = ["o", "x", "s", "v", "D", "P"]
    fig, ax = plt.subplots()
    for (marker, color), (label, pts) in zip(itertools.product(markers, colors), scores.items()):
        if not pts:
            continue
        x, y = zip(*pts)
        ax.scatter(x, y, label=label, color=color, marker=marker)
    ax.legend(fontsize=7)
    ax.set_xlabel("Fraction Variance Unexplained")
    ax.set_ylabel("Loss")
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    """CLI: ``python -m sparse_coding__tpu_torch.experiments.pca_perplexity
    --dicts A.pkl --labels A --chunk acts.npy --tokens toks.npy --lm-params
    lm.pkl --layer 2 [--device cpu]``."""
    import argparse

    from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts
    from sparse_coding__tpu_torch.utils import pickles

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dicts", nargs="+", required=True, help="learned_dicts.pkl paths")
    ap.add_argument("--labels", nargs="+", required=True)
    ap.add_argument("--chunk", required=True, help=".npy activation chunk")
    ap.add_argument("--tokens", required=True, help=".npy token matrix [N, L]")
    ap.add_argument("--lm-params", required=True, help="LM params pickle (a (params, LMConfig) pair)")
    ap.add_argument("--layer", type=int, required=True)
    ap.add_argument("--layer-loc", default="residual")
    ap.add_argument("--out", default="outputs/pca_perplexity")
    ap.add_argument("--device", default=None, help="default cuda; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    if len(args.labels) != len(args.dicts):
        ap.error(f"--labels ({len(args.labels)}) and --dicts ({len(args.dicts)}) must have the same length")
    device = resolve_device(args.device)
    with open(args.lm_params, "rb") as f:
        params, lm_cfg = pickles.load(f, device=device)
    dict_sets: Dict[str, List] = {}
    for label, path in zip(args.labels, args.dicts):
        dict_sets.setdefault(label, []).extend(load_learned_dicts(path, device=device))
    run_pca_perplexity(params, lm_cfg, (args.layer, args.layer_loc), np.load(args.tokens), np.load(args.chunk),
                       dict_sets, args.out, device=device)


if __name__ == "__main__":
    main()
