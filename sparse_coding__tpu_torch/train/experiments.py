"""Experiment catalog: ensemble builders and the run entry points.

Counterpart of `sparse_coding__tpu/train/experiments.py`, with its grids,
ensemble names and hyperparameter contracts. Every builder
``builder(cfg, mesh=None, device=None)`` returns the sweep contract
``(ensembles=[(Ensemble, args, name), ...], ensemble_hyperparams,
buffer_hyperparams, hyperparam_ranges)``; each hyperparameter grid is one
stacked ensemble per dict size. What the port adds:
  - ``device`` (None = cuda) where the members are drawn and trained;
  - the run config's ``dtype`` is the ensembles' compute dtype
    (``"float32"``, the default: exact f32, the JAX builders' precision, which
    does not read the field). With ``"bfloat16"`` a tied or TopK ensemble
    whose shape the Hopper kernels take steps through them (K1 + K2; K_s +
    K_d + the sparse K2), the others by autograd, as the JAX package routes
    bf16 compute;
  - members are drawn from a `torch.Generator` (`_key`), not from JAX's
    PRNG: the same salts and order, other numbers.
The run drivers (`run_sweep_synthetic`, `run_single_layer`, ...) take
``device`` and hand it to the builder and to `train.sweep.sweep`; their
``overrides`` set any config field, ``dtype`` included. The ablations'
signatures (LISTA, thresholding, masked, positive) apply the precision
policy where the JAX signatures do (the masked and thresholding SAEs) and
compute in f32 otherwise. ``mesh`` (a `parallel.Mesh`) shards every
ensemble a builder returns (`Ensemble.shard`): a grid lives in one stacked
ensemble per dict size, and the mesh spreads it over the ranks, so the
builders need not know about devices.
"""

from __future__ import annotations

import functools
import warnings
from itertools import product

import numpy as np
import torch

from sparse_coding__tpu_torch.data.activations import MAX_SENTENCE_LEN
from sparse_coding__tpu_torch.ensemble import Ensemble
from sparse_coding__tpu_torch.lm.model import get_activation_size
from sparse_coding__tpu_torch.models.lista import FunctionalLISTADenoisingSAE
from sparse_coding__tpu_torch.models.positive import FunctionalPositiveTiedSAE
from sparse_coding__tpu_torch.models.sae import (
    FunctionalMaskedTiedSAE,
    FunctionalSAE,
    FunctionalThresholdingSAE,
    FunctionalTiedSAE,
)
from sparse_coding__tpu_torch.models.topk import TopKEncoder, TopKEncoderApprox
from sparse_coding__tpu_torch.train.sweep import sweep
from sparse_coding__tpu_torch.utils.config import EnsembleArgs, SyntheticEnsembleArgs
from sparse_coding__tpu_torch.utils.device import resolve_device


def _ensemble(sig, models, cfg, dict_size, name, extra_args=None, mesh=None):
    """``(Ensemble, args, name)``: Adam at ``cfg.lr``, compute in
    ``cfg.dtype`` (float32: exact), ``cfg.l1_warmup_steps`` for signatures
    with an ``l1_alpha`` buffer (for the others a requested warm-up warns
    and is dropped: one sweep may mix model families); sharded over ``mesh``
    when one is given."""
    warmup = getattr(cfg, "l1_warmup_steps", 0)
    if warmup > 0 and "l1_alpha" not in models[0][1]:
        warnings.warn(f"l1_warmup_steps={warmup} ignored for {sig.__name__} (no l1_alpha buffer)")
        warmup = 0
    dtype = getattr(cfg, "dtype", "float32")
    ens = Ensemble(models, sig, "adam", {"learning_rate": cfg.lr},
                   compute_dtype=None if dtype == "float32" else dtype, l1_warmup_steps=warmup)
    if mesh is not None:
        ens.shard(mesh)
    args = {"batch_size": cfg.batch_size, "dict_size": dict_size, **(extra_args or {})}
    return ens, args, name


def _key(cfg, salt: int = 0, device=None) -> torch.Generator:
    """The builder's generator on ``device``, seeded with ``cfg.seed + salt``
    (the JAX package's salts); it draws the members in order. The draws are
    the port's own, not JAX's PRNG stream."""
    return torch.Generator(device=resolve_device(device)).manual_seed(int(cfg.seed) + int(salt))


# -- builders ---------------------------------------------------------------------

def tied_vs_not_experiment(cfg: EnsembleArgs, mesh=None, device=None):
    """Untied vs tied SAEs over (l1 × bias_decay) at ratio 8: l1
    ``logspace(-3.5, -2, 4)`` × bias decay {0, 0.05, 0.1}, one ensemble of
    12 members each."""
    l1_values = list(np.logspace(-3.5, -2, 4))
    bias_decays = [0.0, 0.05, 0.1]
    dict_size = cfg.activation_width * 8
    grids = list(product(l1_values, bias_decays))
    ensembles = []
    for tied, sig in ((False, FunctionalSAE), (True, FunctionalTiedSAE)):
        gen = _key(cfg, int(tied), device)
        models = [sig.init(gen, cfg.activation_width, dict_size, l1, bias_decay=bd) for l1, bd in grids]
        ensembles.append(_ensemble(sig, models, cfg, dict_size, f"dict_ratio_8{'_tied' if tied else ''}",
                                   {"tied": tied}, mesh))
    return (
        ensembles,
        ["dict_size", "tied"],
        ["l1_alpha", "bias_decay"],
        {"dict_size": [dict_size], "tied": [False, True], "l1_alpha": l1_values, "bias_decay": bias_decays},
    )


def topk_experiment(cfg: EnsembleArgs, mesh=None, device=None):
    """k-sparse sweep: sparsity 1..151 step 10 × dict ratios {0.5, 1, 2, 4},
    one stack per ratio, each member's k capped at the dict size and the
    stack's cap ``min(151, N)``. ``cfg.topk_recall`` switches to
    `TopKEncoderApprox` (threshold selection; the recall is stored and
    ignored); None trains exact top-k (`TopKEncoder`)."""
    recall = getattr(cfg, "topk_recall", None)
    sig = TopKEncoder if recall is None else TopKEncoderApprox
    recall_kw = {} if recall is None else {"recall": float(recall)}
    sparsity_levels = list(np.arange(1, 161, 10))
    dict_ratios = [0.5, 1, 2, 4]
    ensembles, dict_sizes = [], []
    for r in dict_ratios:
        dict_size = int(cfg.activation_width * r)
        dict_sizes.append(dict_size)
        gen = _key(cfg, int(r * 2), device)
        cap = min(max(sparsity_levels), dict_size)
        models = [sig.init(gen, cfg.activation_width, dict_size, min(int(s), dict_size), sparsity_cap=cap,
                           **recall_kw) for s in sparsity_levels]
        ensembles.append(_ensemble(sig, models, cfg, dict_size, f"topk_r{r}", mesh=mesh))
    return ensembles, ["dict_size"], ["sparsity"], {"dict_size": dict_sizes, "sparsity": sparsity_levels}


def synthetic_linear_range(cfg: EnsembleArgs, mesh=None, device=None):
    """A 32-point l1 ``logspace(-4, -2, 32)`` × dict ratios {0.5, 1, 2, 4} on
    tied SAEs, the whole l1 grid in one stack per ratio."""
    l1_vals = list(np.logspace(-4, -2, 32))
    dict_ratios = [0.5, 1, 2, 4]
    ensembles, dict_sizes = [], []
    for r in dict_ratios:
        dict_size = int(cfg.activation_width * r)
        dict_sizes.append(dict_size)
        gen = _key(cfg, int(r * 2), device)
        models = [FunctionalTiedSAE.init(gen, cfg.activation_width, dict_size, l1) for l1 in l1_vals]
        ensembles.append(_ensemble(FunctionalTiedSAE, models, cfg, dict_size, f"linear_r{r}", mesh=mesh))
    return ensembles, ["dict_size"], ["l1_alpha"], {"dict_size": dict_sizes, "l1_alpha": l1_vals}


def _l1_grid(sig, cfg, l1_values, dict_size, name, mesh, device, *layers):
    """One stack of ``sig`` over ``l1_values`` at ``dict_size`` (``layers``:
    the signature's extra init arguments before the l1; no bias decay)."""
    gen = _key(cfg, 0, device)
    models = [sig.init(gen, cfg.activation_width, dict_size, *layers, l1) for l1 in l1_values]
    ensembles = [_ensemble(sig, models, cfg, dict_size, name, mesh=mesh)]
    return ensembles, ["dict_size"], ["l1_alpha"], {"dict_size": [dict_size], "l1_alpha": l1_values}


def _l1_range(cfg, l1_values, name, mesh, device):
    """One stack over ``l1_values`` at ``cfg.learned_dict_ratio``, tied per
    ``cfg.tied_ae``, no bias decay."""
    sig = FunctionalTiedSAE if cfg.tied_ae else FunctionalSAE
    return _l1_grid(sig, cfg, l1_values, int(cfg.activation_width * cfg.learned_dict_ratio), name, mesh, device)


def dense_l1_range_experiment(cfg: EnsembleArgs, mesh=None, device=None):
    """16-point l1 ``logspace(-4, -2, 16)`` at ``cfg.learned_dict_ratio``,
    tied per ``cfg.tied_ae``: the paper's main sweep shape."""
    return _l1_range(cfg, list(np.logspace(-4, -2, 16)), "l1_range", mesh, device)


def simple_setoff(cfg: EnsembleArgs, mesh=None, device=None):
    """9-point l1 grid including l1 = 0 (``[0] + logspace(-4, -2, 8)``) at
    ``cfg.learned_dict_ratio``, tied per ``cfg.tied_ae``: the builder
    `run_across_layers` sweeps."""
    return _l1_range(cfg, [0.0] + list(np.logspace(-4, -2, 8)), "simple", mesh, device)


def residual_denoising_experiment(cfg: EnsembleArgs, mesh=None, device=None):
    """LISTA denoising SAEs (`FunctionalLISTADenoisingSAE`, 3 layers): a
    16-point l1 ``logspace(-5, -3, 16)`` at ``cfg.learned_dict_ratio``."""
    dict_size = int(cfg.activation_width * cfg.learned_dict_ratio)
    return _l1_grid(FunctionalLISTADenoisingSAE, cfg, list(np.logspace(-5, -3, 16)), dict_size,
                    "residual_denoising", mesh, device, 3)


def residual_denoising_comparison(cfg: EnsembleArgs, mesh=None, device=None):
    """The tied-SAE control for the LISTA run: `dense_l1_range_experiment`."""
    return dense_l1_range_experiment(cfg, mesh, device)


def thresholding_experiment(cfg: EnsembleArgs, mesh=None, device=None):
    """Smooth-thresholding SAEs (`FunctionalThresholdingSAE`) at ratio 4, a
    16-point l1 ``logspace(-4, -2, 16)``."""
    return _l1_grid(FunctionalThresholdingSAE, cfg, list(np.logspace(-4, -2, 16)), int(cfg.activation_width * 4),
                    "thresholding", mesh, device)


def zero_l1_baseline(cfg: EnsembleArgs, mesh=None, device=None):
    """A single l1 = 0 model at ratio 4, tied per ``cfg.tied_ae``."""
    dict_size = int(cfg.activation_width * 4)
    sig = FunctionalTiedSAE if cfg.tied_ae else FunctionalSAE
    models = [sig.init(_key(cfg, 0, device), cfg.activation_width, dict_size, 0.0, bias_decay=0.0)]
    ensembles = [_ensemble(sig, models, cfg, dict_size, "l1_range_zero_b", mesh=mesh)]
    return ensembles, ["dict_size"], ["l1_alpha"], {"dict_size": [dict_size], "l1_alpha": [0.0]}


def dict_ratio_experiment(cfg: EnsembleArgs, mesh=None, device=None):
    """Eight dict sizes (``int(512 x)`` for x in ``linspace(1, 5, 8)``: 512
    to 2560) × 12 repeats in ONE masked stack (`FunctionalMaskedTiedSAE`,
    each member padded to 2560 rows) at l1 1e-3: 96 members. ``dict_size``
    is a buffer hyperparam (an int32 buffer a member), so the ensemble
    hyperparams are empty."""
    dict_sizes = [int(512 * x) for x in np.linspace(1, 5, 8)]
    max_size = max(dict_sizes)
    l1_value = 1e-3
    n_repeats = 12
    gen = _key(cfg, 0, device)
    models = [FunctionalMaskedTiedSAE.init(gen, cfg.activation_width, s, max_size, l1_value)
              for _ in range(n_repeats) for s in dict_sizes]
    ensembles = [_ensemble(FunctionalMaskedTiedSAE, models, cfg, max_size, "dict_ratio", mesh=mesh)]
    return ensembles, [], ["l1_alpha", "dict_size"], {"dict_size": dict_sizes, "l1_alpha": [l1_value]}


def long_mlp_sweep(cfg: EnsembleArgs, mesh=None, device=None):
    """The MLP-location long run: `dense_l1_range_experiment`."""
    return dense_l1_range_experiment(cfg, mesh, device)


def run_positive_experiment(cfg: EnsembleArgs, mesh=None, device=None):
    """Non-negative tied SAEs (`FunctionalPositiveTiedSAE`): a 16-point l1
    ``logspace(-4, -2, 16)`` at ``cfg.learned_dict_ratio``."""
    dict_size = int(cfg.activation_width * cfg.learned_dict_ratio)
    return _l1_grid(FunctionalPositiveTiedSAE, cfg, list(np.logspace(-4, -2, 16)), dict_size, "positive", mesh,
                    device)


def pythia_1_4_b_dict(cfg: EnsembleArgs, mesh=None, device=None):
    """The largest workload: Pythia-1.4B layer 6 residual, 6× dictionary,
    4-point l1 ``logspace(-4, -3, 4)``, tied SAEs."""
    l1_values = list(np.logspace(-4, -3, 4))
    dict_size = int(cfg.activation_width * 6)
    gen = _key(cfg, 0, device)
    models = [FunctionalTiedSAE.init(gen, cfg.activation_width, dict_size, l1) for l1 in l1_values]
    ensembles = [_ensemble(FunctionalTiedSAE, models, cfg, dict_size, "pythia_1_4_b", mesh=mesh)]
    return ensembles, ["dict_size"], ["l1_alpha"], {"dict_size": [dict_size], "l1_alpha": l1_values}


# -- run drivers --------------------------------------------------------------------

def _sweep(experiment, cfg, device):
    """`sweep` over the builder on the run's device."""
    return sweep(functools.partial(experiment, device=device), cfg, device=device)


def run_sweep_synthetic(experiment=synthetic_linear_range, device=None, **overrides):
    """A sweep over synthetic data: width 512, 2048 ground-truth components,
    100 active, decay 0.996, 10 chunks, batch 1024 (``overrides`` set any
    `SyntheticEnsembleArgs` field)."""
    cfg = SyntheticEnsembleArgs(
        use_synthetic_dataset=True,
        feature_num_nonzero=100,
        gen_batch_size=4096,
        activation_width=512,
        noise_magnitude_scale=0.0,
        n_ground_truth_components=2048,
        feature_prob_decay=0.996,
        n_chunks=10,
        batch_size=1024,
        output_folder="output_synthetic",
        dataset_folder="activation_data_synthetic",
    )
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return _sweep(experiment, cfg, device)


def run_single_layer(layer: int = 2, layer_loc: str = "residual", tied: bool = True, ratio: float = 4.0,
                     experiment=None, device=None, **overrides):
    """A one-layer Pythia-70M sweep (default builder
    `dense_l1_range_experiment`) over the chunk store in the run's
    ``dataset_folder``, harvested there first when it is empty
    (`train.sweep.init_model_dataset`). The width is the subject model's at
    ``layer_loc`` (`lm.model.get_activation_size`, ``"pattern"`` rows sized
    at `MAX_SENTENCE_LEN` tokens); ``activation_width`` overrides it."""
    model_name = overrides.pop("model_name", "EleutherAI/pythia-70m-deduped")
    width = overrides.pop("activation_width", None)
    if width is None:
        width = get_activation_size(model_name, layer_loc, seq_len=MAX_SENTENCE_LEN)
    cfg = EnsembleArgs(
        model_name=model_name,
        activation_width=width,
        dataset_name="NeelNanda/pile-10k",
        layer=layer,
        layer_loc=layer_loc,
        tied_ae=tied,
        learned_dict_ratio=ratio,
        batch_size=2048,
        n_chunks=20,
        n_epochs=8,
        output_folder=f"output_{'tied' if tied else 'untied'}_{layer_loc}_l{layer}_r{int(ratio)}",
        dataset_folder=f"pilechunks_l{layer}_{layer_loc}",
    )
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return _sweep(experiment or dense_l1_range_experiment, cfg, device)


def run_single_layer_gpt2(layer: int = 9, **overrides):
    """`run_single_layer` on GPT-2 small (width 768, openwebtext)."""
    return run_single_layer(layer=layer, model_name="gpt2", activation_width=768, dataset_name="openwebtext",
                            **overrides)


def run_across_layers(layers=range(6), layer_locs=("residual",), experiment=None, ratios=(4,), **kwargs):
    """`run_single_layer` over layers × locations × ratios (default builder
    `simple_setoff`, batch 1024, 20 chunks). Results keyed ``(layer,
    layer_loc, ratio)``, or ``(layer, layer_loc)`` for a caller passing one
    ``ratio=``."""
    experiment = experiment or simple_setoff
    kwargs.setdefault("batch_size", 1024)
    kwargs.setdefault("n_chunks", 20)
    legacy_keys = "ratio" in kwargs
    if legacy_keys:
        ratios = (kwargs.pop("ratio"),)
    results = {}
    for layer_loc in layer_locs:
        for layer in layers:
            for ratio in ratios:
                key = (layer, layer_loc) if legacy_keys else (layer, layer_loc, ratio)
                results[key] = run_single_layer(layer=layer, layer_loc=layer_loc, ratio=ratio,
                                                experiment=experiment, **kwargs)
    return results


def _run_across_layers_location(layer_loc, tied, layers, ratios, kwargs):
    """The per-location layer loops' shared shape: batch 2048, lr 3e-4, 10
    chunks, save_every 2, `dense_l1_range_experiment` over dict ratios."""
    kwargs.setdefault("batch_size", 2048)
    kwargs.setdefault("lr", 3e-4)
    kwargs.setdefault("n_chunks", 10)
    kwargs.setdefault("save_every", 2)
    return run_across_layers(layers=layers, layer_locs=(layer_loc,), ratios=ratios,
                             experiment=dense_l1_range_experiment, tied=tied, **kwargs)


def run_across_layers_attn(layers=range(6), ratios=(1, 2, 4, 8), **kwargs):
    """Attention outputs, tied."""
    return _run_across_layers_location("attn", True, layers, ratios, kwargs)


def run_across_layers_mlp_out(layers=range(6), ratios=(1, 2, 4, 8), **kwargs):
    """MLP outputs, tied."""
    return _run_across_layers_location("mlpout", True, layers, ratios, kwargs)


def run_across_layers_mlp_untied(layers=range(6), ratios=(1, 2, 4, 8), **kwargs):
    """MLP hidden activations, untied."""
    return _run_across_layers_location("mlp", False, layers, ratios, kwargs)


def run_pythia_1_4_b_sweep(device=None, **overrides):
    """`pythia_1_4_b_dict` over Pythia-1.4B layer 6 residual activations
    (width 2048, batch 2048, 30 chunks)."""
    cfg = EnsembleArgs(
        model_name="EleutherAI/pythia-1.4b-deduped",
        dataset_name="EleutherAI/pile",
        layer=6,
        layer_loc="residual",
        activation_width=2048,
        batch_size=2048,
        n_chunks=30,
        output_folder="output_pythia_1_4_b",
        dataset_folder="pilechunks_1.4b_l6_residual",
    )
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return _sweep(pythia_1_4_b_dict, cfg, device)


if __name__ == "__main__":
    run_pythia_1_4_b_sweep()
