"""Are layer-0 residual SAE features just token (un)embeddings?

Counterpart of `sparse_coding__tpu/experiments/check_l0_tokens.py` (the
reference's `experiments/check_l0_tokens.py`): per layer and dict ratio,
the mean max cosine similarity of the learned dictionary against the LM's
row-normalized embedding and unembedding matrices; a two-panel line plot.
`embedding_cosine_scores` is the device half (the similarities, where the
params and dicts live); `run_embedding_cosine_check` adds the CSV and the
figure (matplotlib, imported only there).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Any, Dict, List, Tuple

import torch

from sparse_coding__tpu_torch.experiments._figures import pyplot
from sparse_coding__tpu_torch.metrics.standard import mcs_to_fixed


def _unit_rows(m: torch.Tensor) -> torch.Tensor:
    return m / torch.linalg.vector_norm(m, dim=1, keepdim=True)


def embedding_cosine_scores(lm_params, dict_sets: Dict[int, List[Tuple[str, Any]]],
                            tie_word_embeddings: bool = False) -> Dict[int, List[Tuple[str, float, float]]]:
    """``{layer: [(ratio_label, embed_mcs, unembed_mcs), ...]}`` for
    ``dict_sets`` ``{layer: [(ratio_label, LearnedDict), ...]}``, on the
    device of the params' ``embed`` (and ``unembed`` unless tied)."""
    embed = lm_params["embed"].float()
    unembed = embed if tie_word_embeddings else lm_params["unembed"].float()
    embed, unembed = _unit_rows(embed), _unit_rows(unembed)
    data: Dict[int, List[Tuple[str, float, float]]] = {}
    with torch.inference_mode():
        for layer, entries in dict_sets.items():
            data[layer] = [(ratio, float(mcs_to_fixed(ld, embed).mean()), float(mcs_to_fixed(ld, unembed).mean()))
                           for ratio, ld in entries]
    return data


def run_embedding_cosine_check(
    lm_params,
    dict_sets: Dict[int, List[Tuple[str, Any]]],
    out_dir,
    tie_word_embeddings: bool = False,
) -> Dict[int, List[Tuple[str, float, float]]]:
    """`embedding_cosine_scores`, then ``embed_unembed.csv`` and
    ``embed_unembed.png`` in ``out_dir``. Needs matplotlib (checked before
    any scoring)."""
    plt = pyplot()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    data = embedding_cosine_scores(lm_params, dict_sets, tie_word_embeddings=tie_word_embeddings)

    with open(out_dir / "embed_unembed.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["layer", "ratio", "embed_mcs", "unembed_mcs"])
        for layer, rows in data.items():
            for ratio, e, u in rows:
                w.writerow([layer, ratio, e, u])

    # one shared categorical x-axis over the union of ratio labels, so layers
    # with different ratio lists land on (and are labelled at) the right places
    all_ratios = sorted({r for rows in data.values() for r, _, _ in rows},
                        key=lambda r: (0, float(r)) if r.replace(".", "", 1).isdigit() else (1, r))
    pos = {r: i for i, r in enumerate(all_ratios)}
    fig, ax = plt.subplots(1, 2, figsize=(10, 5))
    for layer, rows in data.items():
        x = [pos[r] for r, _, _ in rows]
        ax[0].plot(x, [e for _, e, _ in rows], label=layer)
        ax[1].plot(x, [u for _, _, u in rows], label=layer)
    for a in ax:
        a.set_xticks(range(len(all_ratios)))
        a.set_xticklabels(all_ratios)
    ax[0].set_title("Embedding")
    ax[1].set_title("Unembedding")
    for a in ax:
        a.legend()
        a.set_xlabel("Dict ratio")
        a.set_ylabel("Mean cosine similarity")
    fig.savefig(out_dir / "embed_unembed.png", dpi=150, bbox_inches="tight")
    plt.close(fig)
    return data


def main(argv=None):
    """CLI: ``python -m sparse_coding__tpu_torch.experiments.check_l0_tokens
    --lm-params lm.pkl --dicts 0:1:a.pkl 0:2:b.pkl [--device cpu]``."""
    import argparse

    from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts
    from sparse_coding__tpu_torch.utils import pickles
    from sparse_coding__tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--lm-params", required=True)
    ap.add_argument("--dicts", nargs="+", required=True,
                    help="entries layer:ratio:path_to_learned_dicts.pkl (first dict of each file)")
    ap.add_argument("--out", default="outputs/check_l0_tokens")
    ap.add_argument("--device", default=None, help="default cuda; 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    with open(args.lm_params, "rb") as f:
        params, lm_cfg = pickles.load(f, device=device)
    dict_sets: Dict[int, List] = {}
    for spec in args.dicts:
        layer_s, ratio, path = spec.split(":", 2)
        ld, _hp = load_learned_dicts(path, device=device)[0]
        dict_sets.setdefault(int(layer_s), []).append((ratio, ld))
    run_embedding_cosine_check(params, dict_sets, args.out,
                               tie_word_embeddings=getattr(lm_cfg, "tie_word_embeddings", False))


if __name__ == "__main__":
    main()
