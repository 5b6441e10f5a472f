"""Per-chunk ensemble training loop and the FISTA decoder update.

Counterpart of `sparse_coding__tpu/train/loop.py::ensemble_train_loop` and
`make_fista_decoder_update`: a permutation drawn from a `torch.Generator` on
the dataset's device, then either the whole-chunk path (ONE bulk gather of
the permuted rows, then every step) or groups of ``scan_steps`` batches
gathered as they go. A signature with ``has_fista_decoder_update`` takes
one batch at a time instead: the gradient step, then the FISTA decoder
update warm-started from that step's code (K_f on the card).
"""

from __future__ import annotations

import warnings
from functools import lru_cache
from typing import Callable, Dict, Optional

import torch

from sparse_coding__tpu_torch.ensemble import Ensemble, EnsembleState
from sparse_coding__tpu_torch.models.fista import dictionary_update
from sparse_coding__tpu_torch.models.learned_dict import _norm_rows
from sparse_coding__tpu_torch.ops.fista_kernel import fista_solve


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


@lru_cache(maxsize=None)
def make_fista_decoder_update(num_iter: int = 500, tol: float = 0.0) -> Callable:
    """``update(state, batch, c) -> state``: every member's decoder replaced
    by one FISTA solve + quadratic basis update, warm-started from ``c``
    [M, B, N] (the gradient step's code), in the JAX package's order — the
    rows normalised, the solve (`ops.fista_kernel.fista_solve`: K_f on the
    card, its plain loop on the CPU), the Hessian EMA, the basis update.
    ``tol > 0`` lets each member stop early. A member that the state's
    ``update_mask`` freezes keeps its decoder and Hessian diagonal
    (`torch.where`, so its NaNs stay out). Cached by its arguments."""

    def solve(batch, learned_dict, l1_alpha, c):
        return fista_solve(batch, learned_dict, l1_alpha, c, num_iter, tol=tol)

    @torch.no_grad()
    def update(state: EnsembleState, batch: torch.Tensor, c: torch.Tensor) -> EnsembleState:
        decoder, hessian = state.params["decoder"], state.buffers["hessian_diag"]
        new_dict, new_hessian, _ = dictionary_update(
            _norm_rows(decoder), hessian, batch, c, state.buffers["l1_alpha"], num_iter, solver=solve
        )
        mask = state.buffers.get("update_mask")
        if mask is not None:
            keep = mask > 0
            new_dict = torch.where(keep.view(-1, 1, 1), new_dict, decoder)
            new_hessian = torch.where(keep.view(-1, 1), new_hessian, hessian)
        return EnsembleState(
            params={**state.params, "decoder": new_dict},
            buffers={**state.buffers, "hessian_diag": new_hessian},
            opt_state=state.opt_state,
            step=state.step,
        )

    return update


def ensemble_train_loop(
    ensemble: Ensemble,
    dataset: torch.Tensor,
    batch_size: int,
    key: int,
    progress_callback: Optional[Callable[[int, int], None]] = None,
    scan_steps: int = 8,
    dead_check: bool = True,
    bulk_shuffle_max_bytes: int = 2 << 30,
    fista_iters: int = 500,
    fista_tol: float = 0.0,
) -> Dict[str, torch.Tensor]:
    """Train the ensemble for one pass over ``dataset`` [N, d] (on the
    ensemble's device). ``key`` seeds the permutation's `torch.Generator` on
    that device. Returns the last step's loss dict (on the device).

    Datasets whose shuffled copy fits ``bulk_shuffle_max_bytes`` take the
    whole-chunk path unless a ``progress_callback`` is given or
    ``scan_steps <= 1``; otherwise batches are gathered ``scan_steps`` at a
    time. Either way every batch is one `Ensemble.step_batch`.

    A signature with ``has_fista_decoder_update`` takes ``scan_steps`` 1,
    and each `step_batch` is followed by `make_fista_decoder_update`
    (``fista_iters``, ``fista_tol``) on the same batch and the step's code."""
    fista_fn = None
    if getattr(ensemble.sig, "has_fista_decoder_update", False):
        fista_fn = make_fista_decoder_update(fista_iters, tol=fista_tol)
        scan_steps = 1
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
            if fista_fn is not None:
                batch = dataset[idxs[0]]
                loss_dict, aux = ensemble.step_batch(batch)
                ensemble.state = fista_fn(ensemble.state, batch, aux["c"])
            else:
                losses = ensemble.step_scan(dataset[idxs])
                loss_dict = {name: v[-1] for name, v in losses.items()}
            i += k
            if progress_callback is not None:
                progress_callback(i - 1, n_batches)
    if dead_check:
        warn_if_ensemble_dead(ensemble, dataset[perm[:64]], context="after chunk pass")
    return loss_dict
