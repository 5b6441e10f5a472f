"""FISTA sparse inference + Olshausen-style dictionary learning.

Counterpart of `sparse_coding__tpu/models/fista.py`. Every function takes
the STACKED state of an ensemble — a leading member axis ``M`` where the JAX
package vmaps over members — with the batch ``[B, D]`` shared by all members:
dictionaries ``[M, N, D]``, codes ``[M, B, N]``, per-member scalars ``[M]``.

The solve (`fista`) stays full float32, as the JAX package's does. Its two
products per iteration run in `torch.matmul` here: this is the plain version
of the hand-written solve kernel K_f (`ops.fista_kernel`), which the train
loop's decoder update takes on the card. η comes from a 50-step power
iteration on the implicit ``D Dᵀ``; the momentum scalars (t_k − 1)/t_{k+1}
do not depend on the data and come from one float32 table (`momentum_table`)
that the plain loop and the kernel share.

`FunctionalFista` is the untied-SAE training signature whose decoder the
train loop overwrites with one FISTA basis step per batch
(`train.loop.make_fista_decoder_update`); `Fista` is the inference view that
loads the JAX package's `Fista` exports.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from sparse_coding__tpu_torch.models.learned_dict import TiedSAE, UntiedSAE, _norm_rows, register_learned_dict
from sparse_coding__tpu_torch.models.sae import _safe_l2, glorot_uniform

# EMA horizon for the Hessian diagonal (the JAX package's constant)
ACT_HISTORY_LEN = 300.0


def power_iteration_max_eig(learned_dict: torch.Tensor, n_iter: int = 30, eps: float = 1e-12) -> torch.Tensor:
    """λmax of ``D Dᵀ`` for each dictionary of ``learned_dict`` [..., n, d]
    by power iteration on the implicit operator (two matvecs a step), from
    the start vector ones/√n. Returns [...]."""
    n = learned_dict.shape[-2]
    dt = learned_dict.transpose(-1, -2)
    v = torch.ones(learned_dict.shape[:-1], dtype=learned_dict.dtype, device=learned_dict.device)
    v = v / float(np.sqrt(np.float32(n)))

    def op(v):
        w = torch.matmul(dt, v.unsqueeze(-1))
        return torch.matmul(learned_dict, w).squeeze(-1)

    for _ in range(n_iter):
        w = op(v)
        v = w / torch.clamp_min(torch.linalg.vector_norm(w, dim=-1, keepdim=True), eps)
    w = op(v)
    return (v * w).sum(-1) / torch.clamp_min((v * v).sum(-1), eps)


def default_eta(learned_dict: torch.Tensor) -> torch.Tensor:
    """The step size η = 1 / (1.05 λmax) of a 50-step power iteration (it
    approaches λmax from below; FISTA needs η ≤ 1/λmax). [..., n, d] → [...]."""
    return 1.0 / (1.05 * power_iteration_max_eig(learned_dict, n_iter=50))


@lru_cache(maxsize=8)
def momentum_table(num_iter: int) -> np.ndarray:
    """The momentum factor (t_k − 1)/t_{k+1} of each of ``num_iter``
    iterations, t_0 = 1, t_{k+1} = (1 + √(1 + 4 t_k²)) / 2 — float32 with the
    JAX loop's operations in its order (numpy's float32 sqrt is correctly
    rounded). Read-only, cached by ``num_iter``."""
    one, two, four = np.float32(1.0), np.float32(2.0), np.float32(4.0)
    out = np.empty(num_iter, np.float32)
    tk = one
    for i in range(num_iter):
        tk_n = (one + np.sqrt(one + four * (tk * tk))) / two
        out[i] = (tk - one) / tk_n
        tk = tk_n
    out.setflags(write=False)
    return out


def run_fista_iterations(update: Callable, c0: torch.Tensor, num_iter: int, tol: float, eta: torch.Tensor):
    """THE FISTA iteration scaffold. ``update(ahat, ahat_y, i) -> (ahat_new,
    ahat_y)`` does iteration ``i`` for every member (``c0`` [M, B, N]).

    ``tol = 0`` runs ``num_iter`` iterations with no reduction. ``tol > 0``
    stops each member after the first iteration whose largest code change
    ``max |â' − â|`` over the member's whole batch is not above ``tol·η``
    (a NaN change stops it too), bounded by ``num_iter``; a stopped member
    keeps its codes while the others go on — the JAX package's vmap of a
    `while_loop`. Returns ``(ahat, iterations [M] int32)``."""
    M = c0.shape[0]
    ahat, ahat_y = c0, c0
    iters = torch.zeros(M, dtype=torch.int32, device=c0.device)
    if tol > 0.0:
        thresh = tol * eta
        active = torch.ones(M, dtype=torch.bool, device=c0.device)
        for i in range(num_iter):
            a_new, y_new = update(ahat, ahat_y, i)
            delta = torch.amax(torch.abs(a_new - ahat), dim=(1, 2))
            keep = active.view(M, 1, 1)
            ahat = torch.where(keep, a_new, ahat)
            ahat_y = torch.where(keep, y_new, ahat_y)
            iters += active.to(torch.int32)
            active = active & (delta > thresh)
            if not bool(active.any()):
                break
        return ahat, iters
    for i in range(num_iter):
        ahat, ahat_y = update(ahat, ahat_y, i)
    return ahat, iters + num_iter


def fista_codes(batch, learned_dict, eta, l1_coef, c0, num_iter: int = 500, tol: float = 0.0):
    """The FISTA loop alone, in torch ops: codes ``[M, B, N]`` and the
    iteration count of each member. ``eta`` and ``l1_coef`` are [M]; every
    iteration does, member by member,

        res = x − ŷ·D;  ŷ ← ŷ + η·(res·Dᵀ);  â' = max(ŷ − η·l1, 0);
        ŷ ← â' + (â' − â)·(t_k − 1)/t_{k+1}

    with each product and sum rounded on its own (the kernel K_f does the
    same scalar steps without fused multiply-adds)."""
    mom = momentum_table(num_iter)
    eta3 = eta.reshape(-1, 1, 1)
    thr3 = (eta * l1_coef).reshape(-1, 1, 1)
    dt = learned_dict.transpose(1, 2)

    def update(ahat, ahat_y, i):
        res = batch - torch.matmul(ahat_y, learned_dict)
        ahat_y = ahat_y + eta3 * torch.matmul(res, dt)
        # clamp_min keeps a NaN, as jnp.maximum does
        ahat_new = torch.clamp_min(ahat_y - thr3, 0.0)
        return ahat_new, ahat_new + (ahat_new - ahat) * float(mom[i])

    return run_fista_iterations(update, c0, num_iter, tol, eta)


def fista(
    batch: torch.Tensor,
    learned_dict: torch.Tensor,
    l1_coef: torch.Tensor,
    coefficients: torch.Tensor,
    num_iter: int = 500,
    eta: Optional[torch.Tensor] = None,
    tol: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-negative FISTA: argmin_c ½‖x − cD‖² + λ‖c‖₁, c ≥ 0, for each member.

    batch [B, D], learned_dict [M, N, D], l1_coef [M], coefficients
    [M, B, N] (the warm start). Returns ``(ahat [M, B, N], residual
    [M, B, D])``. ``eta`` [M] defaults to `default_eta` and is rounded to
    the batch's dtype; ``tol`` as in `run_fista_iterations`."""
    if eta is None:
        eta = default_eta(learned_dict)
    eta = torch.as_tensor(eta, device=batch.device).to(batch.dtype).reshape(-1)
    ahat, _ = fista_codes(batch, learned_dict, eta, l1_coef.reshape(-1), coefficients, num_iter, tol)
    return ahat, batch - torch.matmul(ahat, learned_dict)


def quadratic_basis_update(
    learned_dict: torch.Tensor,
    res: torch.Tensor,
    ahat: torch.Tensor,
    lowest_activation: float,
    hessian_diag: torch.Tensor,
    step_size: float = 0.001,
    noneg: bool = False,
    row_sum=None,
    n_rows: Optional[int] = None,
) -> torch.Tensor:
    """Olshausen quadratic dictionary update with per-atom Hessian scaling,
    rows (atoms) renormalized — as the JAX package's. learned_dict
    [M, N, D], res [M, B, D], ahat [M, B, N], hessian_diag [M, N]. With the
    batch's rows spread over ranks, ``row_sum`` sums the residual-code
    product over them and ``n_rows`` is the global batch size."""
    prod = torch.matmul(res.transpose(1, 2), ahat)
    if row_sum is not None:
        prod = row_sum(prod)
    d_basis = step_size * prod / (ahat.shape[1] if n_rows is None else n_rows)  # [M, D, N]
    d_basis = d_basis / (hessian_diag + lowest_activation)[:, None, :]
    new_dict = learned_dict + d_basis.transpose(1, 2)
    if noneg:
        new_dict = torch.clamp_min(new_dict, 0.0)
    return _norm_rows(new_dict)


def dictionary_update(
    learned_dict: torch.Tensor,
    hessian_diag: torch.Tensor,
    batch_centered: torch.Tensor,
    coeffs: torch.Tensor,
    l1_alpha: torch.Tensor,
    num_iter: int = 500,
    solver=None,
    row_sum=None,
    n_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One FISTA solve + basis update for every member; returns ``(new_dict,
    new_hessian, res)``. ``solver(batch, dicts, l1, warm) -> (codes, res)``
    replaces the plain `fista` (the train loop passes the selector of
    `ops.fista_kernel`, which runs K_f on the card). With the batch's rows
    spread over ranks (a data axis), each rank solves its own rows and
    ``row_sum`` sums the two batch reductions (the Hessian's mean of squared
    codes, the basis update's product) over the ranks; ``n_rows`` is the
    global batch size."""
    if solver is not None:
        coeffs_fista, res = solver(batch_centered, learned_dict, l1_alpha, coeffs)
    else:
        coeffs_fista, res = fista(batch_centered, learned_dict, l1_alpha, coeffs, num_iter)
    if row_sum is None:
        sq_mean = (coeffs_fista * coeffs_fista).mean(dim=1)
    else:
        sq_mean = row_sum((coeffs_fista * coeffs_fista).sum(dim=1)) / n_rows
    new_hessian = hessian_diag * ((ACT_HISTORY_LEN - 1.0) / ACT_HISTORY_LEN) + sq_mean / ACT_HISTORY_LEN
    new_dict = quadratic_basis_update(learned_dict, res, coeffs_fista, 0.001, new_hessian, row_sum=row_sum,
                                      n_rows=n_rows)
    return new_dict, new_hessian, res


class FunctionalFista:
    """Untied-SAE training signature with a FISTA-refined decoder.

    The gradient step trains encoder, bias and decoder as an untied SAE, in
    float32 whatever the ensemble's compute dtype (the JAX signature applies
    no precision policy either); the train loop then overwrites the decoder
    with one FISTA basis step (`has_fista_decoder_update`). Functions take
    stacked params/buffers and return ``[M]`` losses."""

    has_fista_decoder_update = True

    @staticmethod
    def init(
        generator: torch.Generator,
        activation_size: int,
        n_dict_components: int,
        l1_alpha: float,
        bias_decay: float = 0.0,
        dtype=torch.float32,
        device=None,
    ):
        """One member's (params, buffers), unstacked: glorot encoder and
        decoder drawn in that order from ``generator``."""
        device = device if device is not None else generator.device
        shape = (n_dict_components, activation_size)
        params = {
            "encoder": glorot_uniform(shape, generator, dtype, device),
            "encoder_bias": torch.zeros(n_dict_components, dtype=dtype, device=device),
            "decoder": glorot_uniform(shape, generator, dtype, device),
        }
        buffers = {
            "l1_alpha": torch.tensor(l1_alpha, dtype=dtype, device=device),
            "bias_decay": torch.tensor(bias_decay, dtype=dtype, device=device),
            "hessian_diag": torch.zeros(n_dict_components, dtype=dtype, device=device),
        }
        return params, buffers

    @staticmethod
    def encode(params, buffers, batch):
        c = torch.matmul(batch, params["encoder"].transpose(1, 2)) + params["encoder_bias"][:, None, :]
        return torch.relu(c)

    @staticmethod
    def loss(params, buffers, batch):
        """(total [M], (loss_data {name: [M]}, {"c": c [M, B, N] f32}))."""
        c = FunctionalFista.encode(params, buffers, batch)
        learned_dict = _norm_rows(params["decoder"])
        x_hat = torch.matmul(c, learned_dict)
        diff = x_hat - batch
        l_reconstruction = torch.mean(diff * diff, dim=(-2, -1))
        l_l1 = buffers["l1_alpha"] * torch.abs(c).sum(dim=-1).mean(dim=-1)
        l_bias_decay = buffers["bias_decay"] * _safe_l2(params["encoder_bias"])
        total = l_reconstruction + l_l1 + l_bias_decay
        loss_data = {
            "loss": total,
            "l_reconstruction": l_reconstruction,
            "l_l1": l_l1,
            "l_bias_decay": l_bias_decay,
        }
        return total, (loss_data, {"c": c})

    @staticmethod
    def loss2(params, buffers, batch, fista_iters: int = 50):
        """The tied-encoder hybrid: SAE reconstruction + the residual of a
        ``fista_iters``-iteration FISTA solve from the encoder's code, with
        the encoder's normalised rows as the dictionary. Gradients flow
        through the unrolled solve: the plain loop (`fista`) under autograd
        on any device, as the JAX package differentiates its plain loop.
        No driver calls it. ``(overall [M], (loss_data, {"c": c}))``."""
        learned_dict = _norm_rows(params["encoder"])
        c = torch.relu(torch.matmul(batch, learned_dict.transpose(1, 2)) + params["encoder_bias"][:, None, :])
        diff = torch.matmul(c, learned_dict) - batch
        l_reconstruction = torch.mean(diff * diff, dim=(-2, -1))
        l_l1 = buffers["l1_alpha"] * torch.abs(c).sum(dim=-1).mean(dim=-1)
        l_bias_decay = buffers["bias_decay"] * _safe_l2(params["encoder_bias"])
        _, res = fista(batch, learned_dict, buffers["l1_alpha"], c, fista_iters)
        fista_l_reconstruction = torch.mean(res * res, dim=(-2, -1))
        overall = l_reconstruction + fista_l_reconstruction + l_l1 + l_bias_decay
        loss_data = {
            "loss": overall,
            "l_reconstruction": l_reconstruction,
            "l_fista_reconstruction": fista_l_reconstruction,
            "l_l1": l_l1,
        }
        return overall, (loss_data, {"c": c})

    @staticmethod
    def fista_loss(params, buffers, batch, c, fista_iters: int = 50):
        """The pure FISTA-residual loss of a solve warm-started from ``c``
        [M, B, N] on the encoder's normalised rows, differentiable through
        the unrolled plain loop as `loss2`. ``(loss [M], ({"loss"},
        {"c_fista"}))``."""
        learned_dict = _norm_rows(params["encoder"])
        c_fista, res = fista(batch, learned_dict, buffers["l1_alpha"], c, fista_iters)
        l_reconstruction = torch.mean(res * res, dim=(-2, -1))
        return l_reconstruction, ({"loss": l_reconstruction}, {"c_fista": c_fista})

    @staticmethod
    def to_learned_dict(params, buffers):
        """One member (unstacked) as an `UntiedSAE`."""
        return UntiedSAE(params["encoder"], params["decoder"], params["encoder_bias"])


class Fista(TiedSAE):
    """Inference view: a `TiedSAE` with a `fista` method for exact sparse
    inference (batch [B, D], coefficients [B, N]; l1 a scalar)."""

    def fista(self, batch, coefficients, l1_coef, num_iter: int = 500, eta=None):
        d = self.get_learned_dict()[None]
        l1 = torch.as_tensor(l1_coef, dtype=d.dtype, device=d.device).reshape(1)
        eta = None if eta is None else torch.as_tensor(eta, device=d.device).reshape(1)
        ahat, res = fista(batch, d, l1, coefficients[None], num_iter, eta)
        return ahat[0], res[0]


register_learned_dict(
    Fista,
    ("encoder", "encoder_bias", "center_trans", "center_rot", "center_scale"),
    ("norm_encoder",),
)
