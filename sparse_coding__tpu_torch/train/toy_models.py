"""Superposition toy-model replication.

Counterpart of `sparse_coding__tpu/train/toy_models.py`: train small SAEs on
synthetic sparse data over an (l1_alpha × dict_ratio) grid and report
MMCS-to-ground-truth and dead-neuron grids. Each dict size of the grid is
one ensemble with the l1 row stacked in it, stepped on ``device`` (None =
cuda). The init and the noise are drawn from the port's `torch.Generator`
streams (the glorot bound and the orthogonal decoder's orthonormal columns
held, not JAX's bits).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from sparse_coding__tpu_torch.data.synthetic import RandomDatasetGenerator
from sparse_coding__tpu_torch.ensemble import build_ensemble
from sparse_coding__tpu_torch.metrics.standard import mmcs_to_fixed
from sparse_coding__tpu_torch.models.learned_dict import UntiedSAE, _norm_rows
from sparse_coding__tpu_torch.models.sae import glorot_uniform
from sparse_coding__tpu_torch.utils.config import ToyArgs
from sparse_coding__tpu_torch.utils.device import resolve_device


def _orthogonal(shape, generator: torch.Generator, dtype=torch.float32, device=None) -> torch.Tensor:
    """`jax.nn.initializers.orthogonal` for a 2-D shape: the Q of a normal
    draw's QR with the signs of R's diagonal, so a tall matrix has
    orthonormal columns (a wide one orthonormal rows)."""
    n_rows, n_cols = shape
    a = torch.randn((max(shape), min(shape)), generator=generator, dtype=dtype, device=device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q if n_rows >= n_cols else q.T


class ToySAE:
    """The toy AutoEncoder as a training signature: biased ReLU encoder,
    unit-norm bias-free decoder (orthogonal init), loss = MSE +
    l1·‖c‖₁/n_dict. The loss takes the stacked params (leading member axis
    M) and returns ``[M]`` losses, in exact f32."""

    @staticmethod
    def init(generator: torch.Generator, activation_size, n_dict_components, l1_alpha, dtype=torch.float32,
             device=None):
        """One member's (params, buffers): glorot-uniform encoder then the
        orthogonal decoder (drawn in that order from ``generator``), a zero
        bias."""
        device = device if device is not None else generator.device
        shape = (n_dict_components, activation_size)
        params = {
            "encoder": glorot_uniform(shape, generator, dtype, device),
            "encoder_bias": torch.zeros(n_dict_components, dtype=dtype, device=device),
            "decoder": _orthogonal(shape, generator, dtype, device),
        }
        buffers = {"l1_alpha": torch.tensor(l1_alpha, dtype=dtype, device=device)}
        return params, buffers

    @staticmethod
    def loss(params, buffers, batch):
        """(total [M], (loss_data {name: [M]}, {"c": c [M, B, N]}))."""
        c = torch.relu(torch.matmul(batch, params["encoder"].transpose(-2, -1)) + params["encoder_bias"][:, None, :])
        x_hat = torch.matmul(c, _norm_rows(params["decoder"]))
        l_reconstruction = torch.mean((batch - x_hat) ** 2, dim=(-2, -1))
        l_l1 = buffers["l1_alpha"] * torch.abs(c).sum(dim=-1).mean(dim=-1) / c.shape[-1]
        total = l_reconstruction + l_l1
        return total, ({"loss": total, "l_reconstruction": l_reconstruction, "l_l1": l_l1}, {"c": c})

    @staticmethod
    def to_learned_dict(params, buffers):
        return UntiedSAE(params["encoder"], params["decoder"], params["encoder_bias"])


def get_n_dead_neurons(learned_dict, data_generator, n_batches: int = 10) -> int:
    """Features whose mean activation over fresh batches is 0 (one host
    read)."""
    with torch.no_grad():
        outputs = [learned_dict.encode(next(data_generator)) for _ in range(n_batches)]
        mean_acts = torch.cat(outputs).mean(dim=0)
        return int((mean_acts == 0).sum())


def _generator(cfg: ToyArgs, device) -> RandomDatasetGenerator:
    return RandomDatasetGenerator(
        activation_dim=cfg.activation_dim,
        n_ground_truth_components=cfg.n_ground_truth_components,
        batch_size=cfg.batch_size,
        feature_num_nonzero=cfg.feature_num_nonzero,
        feature_prob_decay=cfg.feature_prob_decay,
        correlated=cfg.correlated_components,
        key=cfg.seed,
        device=device,
    )


def run_single_go(cfg: ToyArgs, data_generator: Optional[RandomDatasetGenerator] = None, device=None):
    """Train one toy SAE; returns (learned_dict, mmcs, n_dead)."""
    device = resolve_device(device)
    if data_generator is None:
        data_generator = _generator(cfg, device)
    ens = build_ensemble(
        ToySAE,
        cfg.seed + 1,
        [{"l1_alpha": cfg.l1_alpha}],
        optimizer_kwargs={"learning_rate": cfg.lr},
        activation_size=cfg.activation_dim,
        n_dict_components=cfg.n_components_dictionary,
        device=device,
    )
    noise = torch.Generator(device=device).manual_seed(cfg.seed + 2)
    for _ in range(cfg.epochs):
        batch = next(data_generator)
        if cfg.noise_level > 0:
            batch = batch + cfg.noise_level * torch.randn(batch.shape, generator=noise, device=device,
                                                          dtype=batch.dtype)
        ens.step_batch(batch)
    ld = ens.to_learned_dicts()[0]
    mmcs = float(mmcs_to_fixed(ld, data_generator.feats))
    n_dead = get_n_dead_neurons(ld, data_generator)
    return ld, mmcs, n_dead


def run_toy_grid(cfg: ToyArgs, device=None) -> Dict[str, np.ndarray]:
    """The replication grid: l1 ∈ base^[low..high) × dict_ratio ∈
    base^[low..high) → MMCS and dead-neuron matrices. Each dict size is ONE
    ensemble with all l1 values stacked."""
    device = resolve_device(device)
    l1_range = [cfg.l1_exp_base**exp for exp in range(cfg.l1_exp_low, cfg.l1_exp_high)]
    ratio_range = [
        cfg.dict_ratio_exp_base**exp
        for exp in range(cfg.dict_ratio_exp_low, cfg.dict_ratio_exp_high)
    ]
    generator = _generator(cfg, device)
    mmcs_grid = np.zeros((len(l1_range), len(ratio_range)))
    dead_grid = np.zeros((len(l1_range), len(ratio_range)), dtype=int)
    for j, ratio in enumerate(ratio_range):
        dict_size = int(cfg.activation_dim * ratio)
        ens = build_ensemble(
            ToySAE,
            cfg.seed + j,
            [{"l1_alpha": float(a)} for a in l1_range],
            optimizer_kwargs={"learning_rate": cfg.lr},
            activation_size=cfg.activation_dim,
            n_dict_components=dict_size,
            device=device,
        )
        for _ in range(cfg.epochs):
            ens.step_batch(next(generator))
        for i, ld in enumerate(ens.to_learned_dicts()):
            mmcs_grid[i, j] = float(mmcs_to_fixed(ld, generator.feats))
            dead_grid[i, j] = get_n_dead_neurons(ld, generator, n_batches=3)
    return {
        "l1_range": np.asarray(l1_range),
        "ratio_range": np.asarray(ratio_range),
        "mmcs": mmcs_grid,
        "n_dead": dead_grid,
    }
