"""The sparse autoencoder training signatures: tied and untied.

Counterpart of `sparse_coding__tpu/models/sae.py::FunctionalTiedSAE` and
`::FunctionalSAE`. The
functions take the STACKED params/buffers of an ensemble: every tensor has a
leading member axis ``M`` (the JAX package's vmap written out), and losses
come back as ``[M]`` vectors. Loss conventions, as in the JAX package:
  - reconstruction = mean squared error over all elements,
  - l1 = batch mean of per-example L1 norms of the code,
  - bias_decay = L2 norm of the encoder bias (zero gradient at 0),
  - dictionary rows are normalized inside the loss.

Under the bf16 policy (`utils.precision`) matmul operands and the code run in
bf16 and reductions in f32; with the policy off the math is exact f32. The
fused path (`fused_grads_stacked`, `fused_adam_step`) runs the hand-written
kernels of `ops.tied_sae_kernel` (their plain versions for CPU tensors).
The untied signature has no fused path (neither has the JAX package's): it
always takes the autograd step, which `Ensemble.step_scan` captures into a
CUDA graph like every other route.
"""

from __future__ import annotations

from typing import Optional

import torch

from sparse_coding__tpu_torch.models.learned_dict import TiedSAE, UntiedSAE, _norm_rows
from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
from sparse_coding__tpu_torch.utils import precision as px
from sparse_coding__tpu_torch.utils.optim import (
    as_u32,
    bias_corrections,
    decayed_moment,
    f32,
    mix32,
    stochastic_round,
    uniform_bits,
)

_CENTERING = ("center_rot", "center_trans", "center_scale")
_BIAS_SALT = 0x5AE  # the bias leaf's bf16-nu store stream (the JAX package's key)


def glorot_uniform(shape, generator: torch.Generator, dtype=torch.float32, device=None):
    """`jax.nn.initializers.glorot_uniform` for a 2-D ``[fan_in, fan_out]`` shape."""
    limit = (6.0 / (shape[0] + shape[1])) ** 0.5
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return (2.0 * u - 1.0) * limit


def _safe_l2(b: torch.Tensor) -> torch.Tensor:
    """Per-member L2 norm with a zero (not NaN) gradient at b == 0."""
    return torch.sqrt(torch.clamp_min(torch.sum(b * b, dim=-1), 1e-24))


def _bias_decay(params, buffers):
    """(l_bias_decay [M], its gradient w.r.t. the bias [M, N])."""
    b = params["encoder_bias"]
    bias_l2 = _safe_l2(b)
    return buffers["bias_decay"] * bias_l2, (buffers["bias_decay"] / bias_l2)[:, None] * b


def _l1(c: torch.Tensor) -> torch.Tensor:
    """Per-member batch mean of the code's L1 norms [M], summed in f32."""
    return px.acc_f32(torch.abs(c)).sum(dim=-1).mean(dim=-1)


def _mse_f32(x_hat: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-member mean squared error over all elements [M], in f32."""
    diff = px.acc_f32(x_hat) - px.acc_f32(target)
    return torch.mean(diff * diff, dim=(-2, -1))


class FunctionalSAE:
    """Untied SAE: ``c = relu(x·Eᵀ + b)``, reconstruction ``c·D̂`` from the
    row-normalized decoder. Params ``encoder`` [N, D], ``encoder_bias`` [N],
    ``decoder`` [N, D]; buffers ``l1_alpha``, ``bias_decay``."""

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
        """One member's (params, buffers), unstacked: glorot-uniform encoder
        then decoder (drawn in that order from ``generator``), a zero bias."""
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
        }
        return params, buffers

    @staticmethod
    def encode(params, buffers, batch):
        """Stacked codes [M, B, N] of a batch [B, D] (or [M, B, D]), in the
        compute dtype."""
        c = torch.matmul(px.cast_in(batch), px.cast_in(params["encoder"]).transpose(-2, -1))
        return torch.relu(c + px.cast_in(params["encoder_bias"])[:, None, :])

    @staticmethod
    def loss(params, buffers, batch):
        """(total [M], (loss_data {name: [M]}, {"c": c [M, B, N]}))."""
        c = FunctionalSAE.encode(params, buffers, batch)
        learned_dict = _norm_rows(params["decoder"])
        # decode accumulated and kept in f32 (bf16-valued operands under the policy)
        x_hat = torch.matmul(px.cast_in(c).float(), px.cast_in(learned_dict).float())
        l_reconstruction = _mse_f32(x_hat, batch)
        l_l1 = buffers["l1_alpha"] * _l1(c)
        l_bias_decay = buffers["bias_decay"] * _safe_l2(params["encoder_bias"])
        total = l_reconstruction + l_l1 + l_bias_decay
        loss_data = {"loss": total, "l_reconstruction": l_reconstruction, "l_l1": l_l1,
                     "l_bias_decay": l_bias_decay}
        return total, (loss_data, {"c": c})

    @staticmethod
    def to_learned_dict(params, buffers):
        """One member (unstacked params) as an `UntiedSAE`."""
        return UntiedSAE(params["encoder"], params["decoder"], params["encoder_bias"])


class FunctionalTiedSAE:
    """Tied SAE (encoder = normalized dictionary) with optional affine
    whitening centering in the buffers (absent components are None)."""

    @staticmethod
    def init(
        generator: torch.Generator,
        activation_size: int,
        n_dict_components: int,
        l1_alpha: float,
        bias_decay: float = 0.0,
        translation: Optional[torch.Tensor] = None,
        rotation: Optional[torch.Tensor] = None,
        scaling: Optional[torch.Tensor] = None,
        dtype=torch.float32,
        device=None,
    ):
        """One member's (params, buffers), unstacked."""
        device = device if device is not None else generator.device
        params = {
            "encoder": glorot_uniform((n_dict_components, activation_size), generator, dtype, device),
            "encoder_bias": torch.zeros(n_dict_components, dtype=dtype, device=device),
        }
        buffers = {
            "center_rot": rotation,
            "center_trans": translation,
            "center_scale": scaling,
            "l1_alpha": torch.tensor(l1_alpha, dtype=dtype, device=device),
            "bias_decay": torch.tensor(bias_decay, dtype=dtype, device=device),
        }
        return params, buffers

    @staticmethod
    def center(buffers, batch):
        """batch [B, D] → [M, B, D] when any centering is present, else batch."""
        if buffers["center_trans"] is not None:
            batch = batch - buffers["center_trans"][:, None, :]
        if buffers["center_rot"] is not None:
            batch = torch.matmul(batch, buffers["center_rot"].transpose(1, 2))
        if buffers["center_scale"] is not None:
            batch = batch * buffers["center_scale"][:, None, :]
        return batch

    @staticmethod
    def encode(params, buffers, batch):
        learned_dict = _norm_rows(params["encoder"])
        x = FunctionalTiedSAE.center(buffers, batch)
        c = torch.matmul(px.cast_in(x), px.cast_in(learned_dict).transpose(1, 2))
        return torch.relu(c + px.cast_in(params["encoder_bias"])[:, None, :])

    @staticmethod
    def loss(params, buffers, batch):
        """(total [M], (loss_data {name: [M]}, {"c": c [M, B, N]}))."""
        learned_dict = _norm_rows(params["encoder"])
        x = FunctionalTiedSAE.center(buffers, batch)
        ld = px.cast_in(learned_dict)
        c = torch.matmul(px.cast_in(x), ld.transpose(1, 2))
        c = torch.relu(c + px.cast_in(params["encoder_bias"])[:, None, :])
        # decode accumulated and kept in f32 (bf16-valued operands under the policy)
        x_hat = torch.matmul(c.float(), ld.float())
        diff = x_hat - px.acc_f32(x)
        l_reconstruction = torch.mean(diff * diff, dim=(-2, -1))
        l_l1 = buffers["l1_alpha"] * px.acc_f32(torch.abs(c)).sum(dim=-1).mean(dim=-1)
        l_bias_decay = buffers["bias_decay"] * _safe_l2(params["encoder_bias"])
        total = l_reconstruction + l_l1 + l_bias_decay
        loss_data = {"loss": total, "l_reconstruction": l_reconstruction, "l_l1": l_l1}
        return total, (loss_data, {"c": c})

    @staticmethod
    def to_learned_dict(params, buffers):
        """One member (unstacked params/buffers) as a `TiedSAE`."""
        return TiedSAE(
            params["encoder"],
            params["encoder_bias"],
            centering=(buffers["center_trans"], buffers["center_rot"], buffers["center_scale"]),
            norm_encoder=True,
        )

    # -- fused step (ops/tied_sae_kernel.py) ----------------------------------

    @staticmethod
    def fused_supported(params, buffers) -> bool:
        """True when the Hopper kernels cover this config: no whitening
        centering and a shape the kernels' tiling takes
        (`ops.tied_sae_kernel.shapes_supported`). Unstacked or stacked
        params; the batch is checked per step (`fused_batch_supported`)."""
        n_dict, d_act = params["encoder"].shape[-2:]
        return all(buffers.get(k) is None for k in _CENTERING) and tk.shapes_supported(n_dict, d_act)

    @staticmethod
    def fused_batch_supported(stacked_params, batch_size: int, adam_fused: bool = True) -> bool:
        """Whether the kernels take this batch size. Both kernel pairs walk
        the whole batch inside each block, so ``adam_fused`` does not change
        the answer; it is kept for the JAX signature."""
        n_dict, d_act = stacked_params["encoder"].shape[-2:]
        return tk.shapes_supported(n_dict, d_act, batch_size)

    @staticmethod
    def fused_grads_stacked(params, buffers, batch):
        """Stacked-ensemble gradients + loss dict through K1 + K3. Returns
        ``(grads, loss_dict)`` with leading member axes."""
        d = params["encoder"]
        nrm = torch.sqrt(torch.sum(d * d, dim=-1))
        d_hat = d / nrm[..., None]
        g_enc, g_bias, l_rec, l_l1_raw = tk.tied_sae_grads_stacked(
            d_hat, nrm, params["encoder_bias"], batch, buffers["l1_alpha"]
        )
        l_bias_decay, g_decay = _bias_decay(params, buffers)
        l_l1 = buffers["l1_alpha"] * l_l1_raw
        grads = {"encoder": g_enc, "encoder_bias": g_bias + g_decay}
        loss_data = {"loss": l_rec + l_l1 + l_bias_decay, "l_reconstruction": l_rec, "l_l1": l_l1}
        return grads, loss_data

    @staticmethod
    def fused_adam_step(params, buffers, batch, opt_state, lr, b1, b2, eps, recompute_code=False):
        """Whole training step (grads + Adam) through K1 + K2 (K1n + K2 with
        ``recompute_code``, the ``SC_RECOMPUTE_CODE=1`` step): the encoder's
        gradient, moments and update stay inside K2 (on CUDA the encoder and
        its moments are updated in place; the moments may be f32, bf16 or
        int8 `QuantMoment`s); the small bias-leaf Adam runs here in the optax
        expressions, its nu EMA in f32 and, for bf16 nu, stored by the
        stochastic rounding. ``opt_state`` is a `utils.optim.AdamState`; the
        step count seeds every stochastic store. Returns ``(new_params,
        new_opt_state, loss_dict)``."""
        t = opt_state.count + 1
        bc1, bc2 = bias_corrections(t, b1, b2)
        bc = torch.stack([bc1, bc2], dim=-1)
        seed = t[0]
        d_new, mu_d, nu_d, g_bias, l_rec, l_l1_raw = tk.tied_sae_adam_step_stacked(
            params["encoder"], params["encoder_bias"], opt_state.mu["encoder"],
            opt_state.nu["encoder"], batch, buffers["l1_alpha"], bc, seed,
            float(lr), float(b1), float(b2), float(eps), recompute_code=recompute_code,
        )
        b = params["encoder_bias"]
        l_bias_decay, g_decay = _bias_decay(params, buffers)
        g_bias = g_bias + g_decay
        mu_b_prev = opt_state.mu["encoder_bias"]
        nu_b_prev = opt_state.nu["encoder_bias"]
        mu_b = f32(1 - b1, g_bias) * g_bias + decayed_moment(b1, mu_b_prev)
        nu_b = f32(b2, g_bias) * nu_b_prev.float() + f32(1 - b2, g_bias) * g_bias * g_bias
        bias_new = b - f32(lr, b) * (mu_b / bc1[:, None]) / (torch.sqrt(nu_b / bc2[:, None]) + f32(eps, b))
        if nu_b_prev.dtype == torch.bfloat16:
            # the bias leaf's f32 EMA with an unbiased bf16 store, as the
            # kernel stores the encoder's (its own counter-hash stream)
            M, N = nu_b.shape
            nu_b = stochastic_round(nu_b, uniform_bits(M, N, mix32(as_u32(seed, b.device) ^ _BIAS_SALT)))
        new_params = {"encoder": d_new, "encoder_bias": bias_new}
        new_state = type(opt_state)(
            count=t,
            mu={"encoder": mu_d, "encoder_bias": mu_b.to(mu_b_prev.dtype)},
            nu={"encoder": nu_d, "encoder_bias": nu_b},
        )
        l_l1 = buffers["l1_alpha"] * l_l1_raw
        loss_data = {"loss": l_rec + l_l1 + l_bias_decay, "l_reconstruction": l_rec, "l_l1": l_l1}
        return new_params, new_state, loss_data
