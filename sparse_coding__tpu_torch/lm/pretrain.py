"""Subject-LM pretraining: next-token loss on a synthetic corpus.

Counterpart of `sparse_coding__tpu/lm/pretrain.py`, with its recipe: AdamW
(weight decay 0.01) under a warm-up + cosine-decay schedule from 0 (warm-up
``min(warmup, max(1, n // 10))``, decay over ``max(n, 2)`` steps), f32
master params and moments, the loss computed on a ``compute_dtype`` cast of
the params (the cast's backward returns f32 gradients), and batches drawn
with replacement by ``np.random.default_rng(seed).integers(0, N, (k,
batch))``, ``scan_steps`` at a time. No weights can be downloaded, so parity
subjects are pretrained on `data.synthetic_text.TrigramLanguage`. The token
corpus moves to the device once; each step indexes it there.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sparse_coding__tpu_torch.lm import model as lm_model
from sparse_coding__tpu_torch.utils import optim
from sparse_coding__tpu_torch.utils.device import resolve_device
from sparse_coding__tpu_torch.utils.precision import as_dtype


def _unflatten(template, leaves: Dict[str, torch.Tensor], prefix: str = ""):
    """``template``'s tree with its leaves replaced by ``leaves[path]``."""
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{prefix}.{k}" if prefix else str(k)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, f"{prefix}.{i}" if prefix else str(i))
                              for i, v in enumerate(template))
    return leaves[prefix]


def make_pretrain_scan_step(cfg: lm_model.LMConfig, tx, compute_dtype=None):
    """``(params, opt_state, tokens[K, B, S]) -> (params, opt_state,
    losses[K])``: K optimizer steps of ``tx`` (an `optim.AdamW`); the losses
    stay on the device."""
    compute_dtype = as_dtype(compute_dtype)

    def loss_fn(p, toks):
        return lm_model.lm_loss(lm_model.cast_params(p, compute_dtype), toks, cfg)

    def scan_step(params, opt_state, tokens):
        losses = []
        for toks in tokens:
            leaves = {k: v.detach().requires_grad_(True) for k, v in lm_model.tree_leaves(params).items()}
            loss = loss_fn(_unflatten(params, leaves), toks)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            with torch.no_grad():
                flat = {k: v.detach() for k, v in leaves.items()}
                updates, opt_state = tx.update(grads, opt_state, flat)
                params = _unflatten(params, optim.apply_updates(flat, updates))
            losses.append(loss.detach())
        return params, opt_state, torch.stack(losses)

    return scan_step


def pretrain_lm(
    params,
    cfg: lm_model.LMConfig,
    tokens: np.ndarray,
    n_steps: int,
    batch_size: int = 32,
    learning_rate: float = 3e-4,
    scan_steps: int = 8,
    compute_dtype="bfloat16",
    warmup: int = 100,
    seed: int = 0,
    log_every: int = 0,
    device=None,
) -> Tuple[dict, Dict[str, float]]:
    """Train ``params`` for ``n_steps`` of AdamW on ``[N, S]`` int token rows.

    Returns (trained params, {"loss_first", "loss_last"}). The params stay
    on their device; ``device`` (None = cuda) must be it."""
    device = resolve_device(device)
    sched = optim.warmup_cosine_decay_schedule(0.0, learning_rate, min(warmup, max(1, n_steps // 10)),
                                               max(n_steps, 2))
    tx = optim.adamw(sched, weight_decay=0.01)
    params = lm_model.tree_map(lambda x: x.to(device), params)
    opt_state = tx.init(lm_model.tree_leaves(params))
    step = make_pretrain_scan_step(cfg, tx, compute_dtype)
    corpus = torch.from_numpy(np.ascontiguousarray(tokens)).to(device)

    rng = np.random.default_rng(seed)
    loss_first: Optional[float] = None
    loss_last = float("nan")
    done = 0
    while done < n_steps:
        k = min(scan_steps, n_steps - done)
        idx = torch.from_numpy(rng.integers(0, tokens.shape[0], (k, batch_size))).to(device)
        params, opt_state, losses = step(params, opt_state, corpus[idx])
        done += k
        losses = losses.cpu().numpy()  # one host read per scan, as JAX's device_get
        if loss_first is None:
            loss_first = float(losses[0])
        loss_last = float(losses[-1])
        if log_every and (done % log_every < k):
            print(f"  pretrain step {done}/{n_steps}: loss {loss_last:.3f}")
    return params, {"loss_first": float(loss_first), "loss_last": loss_last}
