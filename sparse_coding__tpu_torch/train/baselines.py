"""Baseline-suite runner: PCA / ICA / random / identity-ReLU per layer.

Counterpart of `sparse_coding__tpu/train/baselines.py`. Layers run one
after another: the PCA is a streaming pass on ``device`` (None = cuda), the
ICA a host-side sklearn fit. Sparsity for the top-k exports is matched to a
chosen trained SAE's L0 when one is supplied.

Outputs: one folder per (layer, layer_loc) holding `pca.pkl`,
`pca_topk.pkl`, `ica.pkl`, `ica_topk.pkl`, `random.pkl`,
`identity_relu.pkl`, the JAX package's folder layout and file names. Each
file is a pickle of one dictionary with numpy leaves, written under the
JAX package's class paths (`utils.pickles`), so either package's
`load_baseline` reads either package's files.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from sparse_coding__tpu_torch.data.chunks import ChunkStore
from sparse_coding__tpu_torch.metrics.standard import mean_nonzero_activations
from sparse_coding__tpu_torch.models import BatchedPCA, ICAEncoder, IdentityReLU, RandomDict
from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts
from sparse_coding__tpu_torch.utils import pickles
from sparse_coding__tpu_torch.utils.device import resolve_device


def _save(obj, path: Path):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickles.dump(obj, f)


def run_layer_baselines(
    layer: int,
    layer_locs: Sequence[str],
    chunks_folder: str,
    output_folder: str,
    sparsity: int = 64,
    sparsity_match_dicts_path: Optional[str] = None,
    sparsity_match_index: int = 7,
    remake: bool = False,
    pca_batch_size: int = 500,
    ica_max_samples: int = 200_000,
    device=None,
) -> Dict[str, List[str]]:
    """Fit and save the baseline dictionaries for one layer.

    `sparsity_match_dicts_path` points at a sweep's `learned_dicts.pkl`; the
    dict at `sparsity_match_index` sets the top-k sparsity.
    """
    device = resolve_device(device)
    written: Dict[str, List[str]] = {}
    for layer_loc in layer_locs:
        folder_name = f"l{layer}_{layer_loc}"
        out = Path(output_folder) / folder_name
        out.mkdir(parents=True, exist_ok=True)
        store = ChunkStore(Path(chunks_folder) / folder_name)
        chunk = store.load(0, dtype=torch.float32, device=device)
        activation_dim = chunk.shape[1]
        layer_sparsity = sparsity

        if sparsity_match_dicts_path is not None:
            dicts = load_learned_dicts(sparsity_match_dicts_path, device=device)
            ld = dicts[min(sparsity_match_index, len(dicts) - 1)][0]
            with torch.no_grad():
                layer_sparsity = int(float(mean_nonzero_activations(ld, chunk).sum()))
            print(f"matched sparsity for layer {layer}: {layer_sparsity}")
        layer_sparsity = max(1, min(layer_sparsity, activation_dim))

        files = []
        if remake or not (out / "pca.pkl").exists():
            pca = BatchedPCA(activation_dim, device=device)
            for i in range(0, chunk.shape[0], pca_batch_size):
                pca.train_batch(chunk[i : i + pca_batch_size])
            _save(pca.to_learned_dict(sparsity=activation_dim), out / "pca.pkl")
            _save(pca.to_topk_dict(layer_sparsity), out / "pca_topk.pkl")
            files += ["pca.pkl", "pca_topk.pkl"]

        if remake or not (out / "ica.pkl").exists():
            ica = ICAEncoder(activation_size=activation_dim, max_iter=500, device=device)
            ica.train(chunk[:ica_max_samples])
            _save(ica, out / "ica.pkl")
            _save(ica.to_topk_dict(layer_sparsity), out / "ica_topk.pkl")
            files += ["ica.pkl", "ica_topk.pkl"]

        if remake or not (out / "random.pkl").exists():
            _save(RandomDict(activation_size=activation_dim, device=device), out / "random.pkl")
            files.append("random.pkl")

        if remake or not (out / "identity_relu.pkl").exists():
            _save(IdentityReLU(activation_size=activation_dim, device=device), out / "identity_relu.pkl")
            files.append("identity_relu.pkl")

        written[folder_name] = files
    return written


def run_all_baselines(
    layers: Sequence[int],
    layer_locs: Sequence[str],
    chunks_folder: str,
    output_folder: str,
    **kwargs,
):
    """All layers, one after another."""
    return {
        layer: run_layer_baselines(layer, layer_locs, chunks_folder, output_folder, **kwargs)
        for layer in layers
    }


def load_baseline(output_folder: str, layer: int, layer_loc: str, name: str, device=None):
    """One baseline file of either package, its arrays as tensors on
    ``device`` (None = cuda). A JAX-written ``ica.pkl`` holds its encoder in
    a 0-d object array; the encoder itself is returned."""
    with open(Path(output_folder) / f"l{layer}_{layer_loc}" / f"{name}.pkl", "rb") as f:
        return pickles.load(f, device=device)
