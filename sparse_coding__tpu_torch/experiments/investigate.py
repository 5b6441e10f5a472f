"""Do converged features differ systematically from un-converged ones?

Counterpart of `sparse_coding__tpu/experiments/investigate.py` (the
reference's `experiments/investigate.py:1-109`): a smaller dictionary's
features compared against a larger one by max cosine similarity (MCS), and
each feature's "convergence" (its MCS) correlated with how distributed it
is: the entropy of its normalized absolute weights and its effective number
of neurons (ENN). Also the random-direction diversity check.
`investigate_scores` is the device half; `run_investigate` adds the JSON
and the figures (matplotlib, imported only there). `random_feature_diversity`
draws its directions from the port's own stream, not JAX's.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from sparse_coding__tpu_torch.experiments._figures import pyplot
from sparse_coding__tpu_torch.metrics.standard import mcs_to_fixed
from sparse_coding__tpu_torch.utils.device import resolve_device


def feature_entropy(learned_dict: torch.Tensor) -> torch.Tensor:
    """Entropy of each row's normalized |weights| (reference `entropy`)."""
    d = torch.abs(learned_dict / torch.linalg.vector_norm(learned_dict, dim=1, keepdim=True))
    return -torch.sum(d * torch.log(d + 1e-8), dim=1)


def effective_number_of_neurons(learned_dict: torch.Tensor) -> torch.Tensor:
    """``1 / sum(p_i^2)`` with ``p`` the per-row |weight| proportions
    (reference `effective_number_of_neurons`)."""
    a = torch.abs(learned_dict)
    p = a / torch.sum(a, dim=1, keepdim=True)
    return 1.0 / torch.sum(p**2, dim=1)


def investigate_scores(smaller_dict: Any, larger_dict: Any) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(mcs, entropy, enn)`` of the smaller dict's rows, each [n_small] on
    the host: the MCS of each against the larger dict, computed where the
    dicts live."""
    with torch.inference_mode():
        mcs = mcs_to_fixed(smaller_dict, larger_dict.get_learned_dict())
        rows = smaller_dict.get_learned_dict()
        ent, enn = feature_entropy(rows), effective_number_of_neurons(rows)
        return tuple(t.float().cpu().numpy() for t in (mcs, ent, enn))


def investigate_summary(mcs: np.ndarray, ent: np.ndarray, enn: np.ndarray, threshold: float = 0.9) -> Dict[str, float]:
    """The correlations and threshold statistics `run_investigate` reports."""
    above, below = enn[mcs > threshold], enn[mcs < threshold]
    return {
        "entropy_mmcs_correlation": float(np.corrcoef(ent, mcs)[0, 1]),
        "enn_mmcs_correlation": float(np.corrcoef(enn, mcs)[0, 1]),
        "mean_enn_above_threshold": float(above.mean()) if len(above) else float("nan"),
        "mean_enn_below_threshold": float(below.mean()) if len(below) else float("nan"),
        "n_above_threshold": int((mcs > threshold).sum()),
        "threshold": threshold,
    }


def run_investigate(smaller_dict: Any, larger_dict: Any, out_dir, threshold: float = 0.9) -> Dict[str, float]:
    """MCS(smaller → larger) against the entropy and ENN of the smaller
    dict's rows. Writes ``entropy_vs_mmcs.png``, ``enn_vs_mmcs.png`` and
    ``investigate.json``; returns the summary. Needs matplotlib (checked
    before any scoring)."""
    plt = pyplot()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    mcs, ent, enn = investigate_scores(smaller_dict, larger_dict)
    summary = investigate_summary(mcs, ent, enn, threshold)
    for x, name, label in [(ent, "entropy_vs_mmcs", "entropy"), (enn, "enn_vs_mmcs", "Effective number of neurons")]:
        fig, ax = plt.subplots()
        ax.scatter(x, mcs, s=8)
        ax.set_xlabel(label)
        ax.set_ylabel("MCS to larger dict")
        fig.savefig(out_dir / f"{name}.png", dpi=150, bbox_inches="tight")
        plt.close(fig)
    with open(out_dir / "investigate.json", "w") as f:
        json.dump(summary, f, indent=2)
    print("correlation between entropy and mmcs:", summary["entropy_mmcs_correlation"])
    print("mean enn above threshold:", summary["mean_enn_above_threshold"])
    print("mean enn below threshold:", summary["mean_enn_below_threshold"])
    return summary


def random_feature_diversity(out_dir, n: int = 10000, d: int = 128, seed: int = 0, device=None) -> float:
    """The ENN histogram of random unit directions, the null distribution
    (reference `test_diversity_of_random_features`); writes
    ``enn_randn.png``. Returns the mean ENN."""
    plt = pyplot()
    device = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    dirs = torch.randn((n, d), generator=torch.Generator(device=device).manual_seed(seed), device=device)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=1, keepdim=True)
    enn = effective_number_of_neurons(dirs).cpu().numpy()
    fig, ax = plt.subplots()
    ax.hist(enn, bins=50)
    ax.set_xlabel("Effective number of neurons")
    ax.set_ylabel("count")
    fig.savefig(out_dir / "enn_randn.png", dpi=150, bbox_inches="tight")
    plt.close(fig)
    print("mean:", enn.mean())
    return float(enn.mean())


def main(argv=None):
    """CLI: ``python -m sparse_coding__tpu_torch.experiments.investigate
    --smaller a.pkl:0 --larger b.pkl:0 [--device cpu]``."""
    import argparse

    from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smaller", required=True, help="pkl:index of the smaller dict")
    ap.add_argument("--larger", required=True, help="pkl:index of the larger dict")
    ap.add_argument("--threshold", type=float, default=0.9)
    ap.add_argument("--out", default="outputs/investigate")
    ap.add_argument("--device", default=None, help="default cuda; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    def load(spec):
        path, idx = spec.rsplit(":", 1)
        return load_learned_dicts(path, device=device)[int(idx)][0]

    random_feature_diversity(args.out, device=device)
    run_investigate(load(args.smaller), load(args.larger), args.out, args.threshold)


if __name__ == "__main__":
    main()
