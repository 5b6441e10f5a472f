"""Correlate feature activation moments with autointerp scores.

Counterpart of `sparse_coding__tpu/experiments/interp_moment_corrs.py` (the
reference's `experiments/interp_moment_corrs.py:1-123`): for each (dict,
activation chunk, autointerp results folder) entry, the streaming
per-feature moments (n_active, mean, var, skew, kurtosis, "l4_norm") and
their Pearson correlation with the per-feature interpretability scores, per
entry and pooled, plus log-transformed variants. "l4_norm" is the
reference's label for the raw 4th moment E[c^4], kept with its quantity.
`entry_moments` is the device half (the moments where the chunk lives); the
scores are read from the results folders on the host (pandas). No figure.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from sparse_coding__tpu_torch.metrics.standard import calc_moments_streaming

MOMENTS = ["n_active", "mean", "var", "skew", "kurtosis", "l4_norm"]


def _corr(a: np.ndarray, b: np.ndarray) -> float:
    if len(a) < 2 or np.std(a) == 0 or np.std(b) == 0:
        return float("nan")
    return float(np.corrcoef(a, b)[0, 1])


def entry_moments(ld, chunk, batch_size: int = 1000) -> Dict[str, np.ndarray]:
    """The streaming per-feature moments of ``ld``'s code over ``chunk``
    (`metrics.standard.calc_moments_streaming`, on the chunk's device), on
    the host by name."""
    return {m: v.float().cpu().numpy() for m, v in zip(MOMENTS, calc_moments_streaming(ld, chunk, batch_size))}


def run_moment_corrs(
    entries: Sequence[Tuple[Any, Any, str]],
    out_dir,
    score_mode: str = "random",
    batch_size: int = 1000,
) -> Dict[str, Any]:
    """``entries``: ``[(learned_dict, chunk [N, d], interp_results_folder),
    ...]``. Returns ``{"pooled": {moment: r}, "pooled_log": {...},
    "per_entry": [...]}``; writes ``moment_corrs.csv`` (one row a feature)
    and ``moment_corrs.json``."""
    from sparse_coding__tpu_torch.interp.pipeline import read_transform_scores

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    pooled: Dict[str, List[float]] = {m: [] for m in MOMENTS}
    pooled_scores: List[float] = []
    per_entry = []
    rows = []
    for entry_i, (ld, chunk, results_loc) in enumerate(entries):
        ndxs, scores = read_transform_scores(results_loc, score_mode=score_mode)
        if not ndxs:
            per_entry.append({})
            continue
        moments = entry_moments(ld, chunk, batch_size=batch_size)
        sel = {m: v[np.asarray(ndxs)] for m, v in moments.items()}
        per_entry.append({m: _corr(sel[m], np.asarray(scores)) for m in MOMENTS})
        for m in MOMENTS:
            pooled[m].extend(sel[m].tolist())
        pooled_scores.extend(scores)
        for j, f in enumerate(ndxs):
            rows.append([entry_i, f, scores[j]] + [float(sel[m][j]) for m in MOMENTS])

    s = np.asarray(pooled_scores)
    pooled_corr = {m: _corr(np.asarray(pooled[m]), s) for m in MOMENTS}
    pooled_log = {}
    for m in ["skew", "kurtosis", "l4_norm"]:
        v = np.asarray(pooled[m])
        if len(v):
            shifted = v - v.min() + 1e-8 if m != "l4_norm" else np.maximum(v, 1e-12)
            pooled_log[f"log_{m}"] = _corr(np.log(shifted), s)

    result = {"pooled": pooled_corr, "pooled_log": pooled_log, "per_entry": per_entry}
    with open(out_dir / "moment_corrs.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["entry", "feature", "score"] + MOMENTS)
        w.writerows(rows)
    with open(out_dir / "moment_corrs.json", "w") as f:
        json.dump(result, f, indent=2)
    for m, r in pooled_corr.items():
        print(f"{m} correlation: {r}")
    for m, r in pooled_log.items():
        print(f"{m} correlation: {r}")
    return result


def main(argv=None):
    """CLI: ``python -m sparse_coding__tpu_torch.experiments.interp_moment_corrs
    --entries dicts.pkl:0:chunk.npy:results/ [--device cpu]``."""
    import argparse

    import torch

    from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts
    from sparse_coding__tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--entries", nargs="+", required=True,
                    help="dict_pkl:dict_index:chunk_npy:interp_results_folder per entry")
    ap.add_argument("--score-mode", default="random", choices=["all", "top", "random"])
    ap.add_argument("--out", default="outputs/interp_moment_corrs")
    ap.add_argument("--device", default=None, help="default cuda; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    entries = []
    for spec in args.entries:
        pkl, idx, chunk, results = spec.split(":", 3)
        ld, _hp = load_learned_dicts(pkl, device=device)[int(idx)]
        entries.append((ld, torch.from_numpy(np.load(chunk)).to(device=device, dtype=torch.float32), results))
    run_moment_corrs(entries, args.out, score_mode=args.score_mode)


if __name__ == "__main__":
    main()
