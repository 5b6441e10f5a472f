"""Per-chunk ensemble training loop.

Counterpart of `sparse_coding__tpu/train/loop.py::ensemble_train_loop` on
its non-FISTA path: a permutation drawn from a `torch.Generator` on the
dataset's device, then either the whole-chunk path (ONE bulk gather of the
permuted rows, then every step) or groups of ``scan_steps`` batches gathered
as they go. The FISTA decoder update is not ported yet (ROADMAP A3).
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional

import torch

from sparse_coding__tpu_torch.ensemble import Ensemble


def warn_if_ensemble_dead(ensemble: Ensemble, batch: torch.Tensor, context: str = "") -> bool:
    """Warn when every member's codes are identically zero on a probe batch
    (the Adam-lr x l1 collapse of large dictionaries). One host sync."""
    st = ensemble.state
    with torch.no_grad():
        c = ensemble.sig.encode(st.params, st.buffers, batch)
        dead = not bool((c != 0).any())
    if dead:
        warnings.warn(
            f"DEAD ENSEMBLE{' (' + context + ')' if context else ''}: every member "
            f"of the {ensemble.n_models}-member {ensemble.sig.__name__} ensemble "
            "produced all-zero codes on a probe batch; lower the lr or warm up l1.",
            RuntimeWarning,
            stacklevel=2,
        )
    return dead


def ensemble_train_loop(
    ensemble: Ensemble,
    dataset: torch.Tensor,
    batch_size: int,
    key: int,
    progress_callback: Optional[Callable[[int, int], None]] = None,
    scan_steps: int = 8,
    dead_check: bool = True,
    bulk_shuffle_max_bytes: int = 2 << 30,
) -> Dict[str, torch.Tensor]:
    """Train the ensemble for one pass over ``dataset`` [N, d] (on the
    ensemble's device). ``key`` seeds the permutation's `torch.Generator` on
    that device. Returns the last step's loss dict (on the device).

    Datasets whose shuffled copy fits ``bulk_shuffle_max_bytes`` take the
    whole-chunk path unless a ``progress_callback`` is given or
    ``scan_steps <= 1``; otherwise batches are gathered ``scan_steps`` at a
    time. Either way every batch is one `Ensemble.step_batch`."""
    n = dataset.shape[0]
    n_batches = n // batch_size
    gen = torch.Generator(device=dataset.device).manual_seed(int(key))
    perm = torch.randperm(n, generator=gen, device=dataset.device)
    loss_dict: Dict[str, torch.Tensor] = {}
    if n_batches == 0:
        return loss_dict
    whole_chunk = (
        scan_steps > 1
        and progress_callback is None
        and dataset.element_size() * dataset.numel() <= bulk_shuffle_max_bytes
    )
    if whole_chunk:
        shuffled = dataset[perm[: n_batches * batch_size]].reshape(n_batches, batch_size, -1)
        losses = ensemble.step_scan(shuffled)
        del shuffled
        loss_dict = {k: v[-1] for k, v in losses.items()}
    else:
        i = 0
        while i < n_batches:
            k = scan_steps if n_batches - i >= scan_steps else 1
            idxs = perm[i * batch_size : (i + k) * batch_size].reshape(k, batch_size)
            losses = ensemble.step_scan(dataset[idxs])
            loss_dict = {name: v[-1] for name, v in losses.items()}
            i += k
            if progress_callback is not None:
                progress_callback(i - 1, n_batches)
    if dead_check:
        warn_if_ensemble_dead(ensemble, dataset[perm[:64]], context="after chunk pass")
    return loss_dict
