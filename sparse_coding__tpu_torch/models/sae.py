"""The sparse autoencoder training signatures.

Counterpart of `sparse_coding__tpu/models/sae.py`: `FunctionalSAE`,
`FunctionalTiedSAE`, `FunctionalTiedCenteredSAE` (a learnable centre),
`FunctionalThresholdingSAE` (the smooth soft threshold), the masked
`FunctionalMaskedTiedSAE` / `FunctionalMaskedSAE` (several dict sizes in one
stack: the code times a keep mask, ``dict_size`` an int32 buffer) and
`FunctionalReverseSAE`, and the data-parallel `FunctionalTiedSAEDP` that
`FunctionalTiedSAE.bind_mesh` picks on a mesh with a data axis (one
gradient contraction, so one all-reduce operand). The functions take
the STACKED params/buffers of an ensemble: every tensor has a leading member
axis ``M`` (the JAX package's vmap written out), and losses come back as
``[M]`` vectors. Loss conventions, as in the JAX package:
  - reconstruction = mean squared error over all elements,
  - l1 = batch mean of per-example L1 norms of the code,
  - bias_decay = L2 norm of the encoder bias (zero gradient at 0),
  - dictionary rows are normalized inside the loss.

Under the bf16 policy (`utils.precision`) matmul operands and the code run in
bf16 and reductions in f32; with the policy off the math is exact f32. The
fused path (`fused_grads_stacked`, `fused_adam_step`) runs the hand-written
kernels of `ops.tied_sae_kernel` (their plain versions for CPU tensors).
Only the tied signature has a fused path (as in the JAX package): the others
always take the autograd step, which `Ensemble.step_scan` captures into a
CUDA graph like every other route.
"""

from __future__ import annotations

from typing import Optional

import torch

from sparse_coding__tpu_torch.models.learned_dict import (
    ReverseSAE,
    ThresholdingSAE_export,
    TiedSAE,
    UntiedSAE,
    _norm_rows,
    thresholding_encode,
)
from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
from sparse_coding__tpu_torch.utils import precision as px
from sparse_coding__tpu_torch.utils.optim import (
    QuantMoment,
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


def _encode_mm(dictionary: torch.Tensor, batch: torch.Tensor) -> torch.Tensor:
    """Stacked scores ``x·Dᵀ`` [M, B, N] in the compute dtype."""
    return torch.matmul(px.cast_in(batch), px.cast_in(dictionary).transpose(-2, -1))


def _decode_mm(dictionary: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``c·D`` [M, B, D] accumulated and kept in f32 (bf16-valued operands
    under the policy)."""
    return torch.matmul(px.cast_in(c).float(), px.cast_in(dictionary).float())


def _bias(params) -> torch.Tensor:
    """The stacked encoder bias [M, 1, N], in the compute dtype."""
    return px.cast_in(params["encoder_bias"])[:, None, :]


def _one_member(stacked_fn, params, buffers, batch):
    """``stacked_fn`` (a signature's ``fused_grads_stacked``) on one member's
    unstacked params and buffers: each tensor given a member axis of one, the
    results' taken off again (JAX's single-model ``fused_grads``)."""
    def up(tree):
        return {k: v[None] if isinstance(v, torch.Tensor) else v for k, v in tree.items()}

    grads, loss_data = stacked_fn(up(params), up(buffers), batch)
    return {k: v[0] for k, v in grads.items()}, {k: v[0] for k, v in loss_data.items()}


def _mask_buffers(n_dict_components: int, n_components_stack: int, l1_alpha: float, bias_decay: float,
                  dtype, device):
    """The masked signatures' buffers: ``dict_size`` (int32) and the keep mask
    ``coef_keep`` (1 on the first ``dict_size`` rows of the stack)."""
    keep = torch.arange(n_components_stack, device=device) < n_dict_components
    return {
        "l1_alpha": torch.tensor(l1_alpha, dtype=dtype, device=device),
        "bias_decay": torch.tensor(bias_decay, dtype=dtype, device=device),
        "dict_size": torch.tensor(n_dict_components, dtype=torch.int32, device=device),
        "coef_keep": keep.to(dtype),
    }


def _l1_losses(x_hat, target, c, buffers):
    """``(total, loss_data)`` of reconstruction + l1."""
    l_reconstruction = _mse_f32(x_hat, target)
    l_l1 = buffers["l1_alpha"] * _l1(c)
    total = l_reconstruction + l_l1
    return total, {"loss": total, "l_reconstruction": l_reconstruction, "l_l1": l_l1}


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
    def uncenter(buffers, batch):
        """The inverse of `center`: batch [M, B, D] (or [B, D] with no
        centering) back to the activations' frame."""
        if buffers["center_scale"] is not None:
            batch = batch / buffers["center_scale"][:, None, :]
        if buffers["center_rot"] is not None:
            batch = torch.matmul(batch, buffers["center_rot"])
        if buffers["center_trans"] is not None:
            batch = batch + buffers["center_trans"][:, None, :]
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

    @staticmethod
    def bind_mesh(mesh):
        """The signature a step on ``mesh`` runs (`Ensemble.shard`): on a
        mesh with a data axis larger than 1 the DP loss, whose tied-weight
        backward is one contraction (`FunctionalTiedSAEDP`); otherwise this
        one (the fused backward's two operand copies pay only where a
        gradient all-reduce is saved)."""
        from sparse_coding__tpu_torch.parallel.mesh import DATA_AXIS

        if mesh.shape.get(DATA_AXIS, 1) > 1:
            return FunctionalTiedSAEDP
        return FunctionalTiedSAE

    @staticmethod
    def dict_parallel_loss(params, buffers, batch, dict_sum):
        """`loss` on this rank's slice of the dictionary rows (a mesh with a
        dict axis): the code of the local rows, the partial decode summed
        over the dict group by ``dict_sum`` (all-reduce forward, identity
        backward), and the l1 and bias-decay terms from their summed
        partials, so the losses are the whole dictionary's on every rank of
        the group. ``buffers`` are whole (centering included). The aux code
        is the local rows'. (The fused kernels compute the loss from the
        whole decode inside K1, so a dictionary slice takes this autograd
        route.)"""
        learned_dict = _norm_rows(params["encoder"])
        x = FunctionalTiedSAE.center(buffers, batch)
        ld = px.cast_in(learned_dict)
        c = torch.relu(torch.matmul(px.cast_in(x), ld.transpose(1, 2)) + px.cast_in(params["encoder_bias"])[:, None, :])
        x_hat = dict_sum(torch.matmul(c.float(), ld.float()))
        diff = x_hat - px.acc_f32(x)
        l_reconstruction = torch.mean(diff * diff, dim=(-2, -1))
        l_l1 = buffers["l1_alpha"] * dict_sum(px.acc_f32(torch.abs(c)).sum(dim=-1).mean(dim=-1))
        b = params["encoder_bias"]
        l_bias_decay = buffers["bias_decay"] * torch.sqrt(torch.clamp_min(dict_sum(torch.sum(b * b, dim=-1)), 1e-24))
        total = l_reconstruction + l_l1 + l_bias_decay
        loss_data = {"loss": total, "l_reconstruction": l_reconstruction, "l_l1": l_l1}
        return total, (loss_data, {"c": c})

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
    def fused_grads(params, buffers, batch):
        """One member's (unstacked) gradients + loss dict through
        `fused_grads_stacked`."""
        return _one_member(FunctionalTiedSAE.fused_grads_stacked, params, buffers, batch)

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
    def fused_step_work(params, opt_state, batch_size: int, route: str, recompute_code: bool = False,
                        nnz: Optional[int] = None):
        """``{"flops", "bytes_accessed", "kernels"}`` of one fused step at
        this shape, from `ops.tied_sae_kernel.kernel_work` with the code's
        ``nnz`` non-zero entries (`code_nnz`; None: a dense code, the most
        the step can need): K1 + K2 (K1n + K2 rebuilding the code with
        ``recompute_code``) on the ``"fused_adam"`` route, K1 + K3 on
        ``"fused_grads"`` (the bias and optimizer arithmetic outside the
        kernels is not counted)."""
        M, N, D = params["encoder"].shape
        B = int(batch_size)

        def size(mom):
            return (1, True) if isinstance(mom, QuantMoment) else (mom.element_size(), False)

        if route == "fused_adam":
            (mu_b, scaled), (nu_b, _) = size(opt_state.mu["encoder"]), size(opt_state.nu["encoder"])
            names = (("tied_sae_fwd_nocode", "tied_sae_bwd_adam_rc") if recompute_code
                     else ("tied_sae_fwd", "tied_sae_bwd_adam"))
            kw = {"mu_bytes": mu_b, "nu_bytes": nu_b, "mu_scaled": scaled}
            work = [tk.kernel_work(names[0], M, B, N, D, nnz), tk.kernel_work(names[1], M, B, N, D, nnz, **kw)]
        elif route == "fused_grads":
            names = ("tied_sae_fwd", "tied_sae_bwd_grads")
            work = [tk.kernel_work(n, M, B, N, D, nnz) for n in names]
        else:
            raise ValueError(f"fused_step_work: no kernel route {route!r}")
        return {"flops": float(sum(f for f, _ in work)), "bytes_accessed": float(sum(b for _, b in work)),
                "kernels": list(names)}

    @staticmethod
    def code_nnz(params, batch) -> torch.Tensor:
        """The non-zero entries of the code the fused step's K1 writes for
        ``batch`` [B, D] at ``params`` (a 0-d device tensor; `fused_step_work`'s
        ``nnz`` once read)."""
        return tk.code_nnz(params["encoder"], params["encoder_bias"], batch)

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


class _TiedPairDP(torch.autograd.Function):
    """Tied encode + decode ``(c, x_hat)`` with a data-parallel backward.

    Autograd of the plain loss gives the tied dictionary two gradient-sized
    partials (the encode's and the decode's transposes); this backward
    computes their sum as ONE contraction over a doubled batch axis,

        dD = [dpre; c]^T [x; dxh]   (stacked on the batch axis: one product)

    so the gradient that the data group all-reduces is a single operand
    (the JAX package's `_tied_pair_dp`). The forward is the plain loss's
    (under the compute dtype active at the call, which the backward reuses:
    it may run on another thread, outside the policy's context)."""

    @staticmethod
    def forward(ctx, d_hat, bias, x, compute_dtype):
        with px.compute(compute_dtype):
            ld = px.cast_in(d_hat)
            c = torch.relu(torch.matmul(px.cast_in(x), ld.transpose(-2, -1)) + px.cast_in(bias)[:, None, :])
        x_hat = torch.matmul(c.float(), ld.float())
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(d_hat, x, c)
        return c, x_hat

    @staticmethod
    def backward(ctx, dc_out, dxh):
        d_hat, x, c = ctx.saved_tensors
        with px.compute(ctx.compute_dtype):
            ld = px.cast_in(d_hat).float()
            dc_decode = torch.matmul(dxh.float(), ld.transpose(-2, -1))
            dpre = torch.where(c.float() > 0, px.acc_f32(dc_out) + dc_decode, torch.zeros((), device=c.device))
            xs = x.expand(c.shape[:-1] + x.shape[-1:])
            lhs = torch.cat([px.cast_in(dpre), px.cast_in(c)], dim=-2).float()  # [M, 2B, N]
            rhs = torch.cat([px.cast_in(xs), px.cast_in(dxh)], dim=-2).float()  # [M, 2B, D]
            g_dhat = torch.matmul(lhs.transpose(-2, -1), rhs).to(d_hat.dtype)
            g_bias = dpre.sum(dim=-2).to(d_hat.dtype)
            g_x = None
            if ctx.needs_input_grad[2]:
                g_x = torch.matmul(px.cast_in(dpre).float(), ld)
                if x.dim() < g_x.dim():
                    g_x = g_x.sum(dim=0)
                g_x = g_x.to(x.dtype)
        return g_dhat, g_bias, g_x, None


class FunctionalTiedSAEDP(FunctionalTiedSAE):
    """`FunctionalTiedSAE` with the one-contraction tied backward
    (`_TiedPairDP`): an execution-only specialization that
    `FunctionalTiedSAE.bind_mesh` selects on meshes with a data axis;
    checkpoints and exports record the plain signature. `bind_mesh` is
    inherited (binding again is idempotent)."""

    @staticmethod
    def loss(params, buffers, batch):
        """(total [M], (loss_data {name: [M]}, {"c": c [M, B, N]})): the plain
        loss's values, the DP backward's gradients."""
        learned_dict = _norm_rows(params["encoder"])
        x = FunctionalTiedSAE.center(buffers, batch)
        c, x_hat = _TiedPairDP.apply(learned_dict, params["encoder_bias"], x, px.current())
        diff = x_hat - px.acc_f32(x)
        l_reconstruction = torch.mean(diff * diff, dim=(-2, -1))
        l_l1 = buffers["l1_alpha"] * px.acc_f32(torch.abs(c)).sum(dim=-1).mean(dim=-1)
        l_bias_decay = buffers["bias_decay"] * _safe_l2(params["encoder_bias"])
        total = l_reconstruction + l_l1 + l_bias_decay
        loss_data = {"loss": total, "l_reconstruction": l_reconstruction, "l_l1": l_l1}
        return total, (loss_data, {"c": c})


class FunctionalTiedCenteredSAE:
    """Tied SAE with a learnable centre translation: params ``center`` [D],
    ``encoder`` [N, D], ``encoder_bias`` [N]; buffer ``l1_alpha``."""

    @staticmethod
    def init(generator: torch.Generator, activation_size: int, n_dict_components: int, l1_alpha: float,
             center: Optional[torch.Tensor] = None, dtype=torch.float32, device=None):
        """One member's (params, buffers), unstacked: the centre (zero unless
        given), a glorot-uniform encoder, a zero bias."""
        device = device if device is not None else generator.device
        params = {
            "center": center if center is not None else torch.zeros(activation_size, dtype=dtype, device=device),
            "encoder": glorot_uniform((n_dict_components, activation_size), generator, dtype, device),
            "encoder_bias": torch.zeros(n_dict_components, dtype=dtype, device=device),
        }
        return params, {"l1_alpha": torch.tensor(l1_alpha, dtype=dtype, device=device)}

    @staticmethod
    def loss(params, buffers, batch):
        """(total [M], (loss_data, {"c": c [M, B, N]})): reconstruction of the
        centred batch + l1."""
        learned_dict = _norm_rows(params["encoder"])
        batch_centered = batch - params["center"][:, None, :]
        c = torch.relu(_encode_mm(learned_dict, batch_centered) + _bias(params))
        total, loss_data = _l1_losses(_decode_mm(learned_dict, c), batch_centered, c, buffers)
        return total, (loss_data, {"c": c})

    @staticmethod
    def to_learned_dict(params, buffers):
        """One member as a `TiedSAE` centred by its learned translation."""
        return TiedSAE(params["encoder"], params["encoder_bias"], centering=(params["center"], None, None),
                       norm_encoder=True)


class FunctionalThresholdingSAE:
    """Smooth relu6-based soft-thresholding encoder with a learnable
    per-feature scale and gain: params ``encoder`` [N, D],
    ``activation_scale`` [N] (ones), ``activation_gain`` [N] (zeros),
    ``centering`` [D] (zeros, as the JAX package adds it); buffer
    ``l1_alpha``. The encode is `models.learned_dict.thresholding_encode`."""

    encode = staticmethod(thresholding_encode)

    @staticmethod
    def init(generator: torch.Generator, activation_size: int, n_dict_components: int, l1_alpha: float,
             dtype=torch.float32, device=None):
        """One member's (params, buffers), unstacked."""
        device = device if device is not None else generator.device
        params = {
            "encoder": glorot_uniform((n_dict_components, activation_size), generator, dtype, device),
            "activation_scale": torch.ones(n_dict_components, dtype=dtype, device=device),
            "activation_gain": torch.zeros(n_dict_components, dtype=dtype, device=device),
            "centering": torch.zeros(activation_size, dtype=dtype, device=device),
        }
        return params, {"l1_alpha": torch.tensor(l1_alpha, dtype=dtype, device=device)}

    @staticmethod
    def loss(params, buffers, batch):
        """(total [M], (loss_data, {"c": c [M, B, N] f32}))."""
        learned_dict = _norm_rows(params["encoder"])
        c = thresholding_encode(params, batch, learned_dict)
        total, loss_data = _l1_losses(_decode_mm(learned_dict, c), batch, c, buffers)
        return total, (loss_data, {"c": c})

    @staticmethod
    def to_learned_dict(params, buffers):
        """One member as a `ThresholdingSAE_export` of its raw params."""
        return ThresholdingSAE_export(params)


class FunctionalMaskedTiedSAE:
    """Tied SAE padded to ``n_components_stack`` rows with a coefficient keep
    mask, so members of different dict sizes share one stack: params
    ``encoder`` [S, D], ``encoder_bias`` [S]; buffers ``l1_alpha``,
    ``bias_decay`` (kept, unused by the loss, as in the JAX package),
    ``dict_size`` (int32) and ``coef_keep`` [S]. The code is ``relu(...) *
    coef_keep`` (a multiply, so one captured step serves every size)."""

    @staticmethod
    def init(generator: torch.Generator, activation_size: int, n_dict_components: int, n_components_stack: int,
             l1_alpha: float, bias_decay: float = 0.0, dtype=torch.float32, device=None):
        """One member's (params, buffers), unstacked: a glorot-uniform encoder
        of the stack's rows, a zero bias."""
        device = device if device is not None else generator.device
        params = {
            "encoder": glorot_uniform((n_components_stack, activation_size), generator, dtype, device),
            "encoder_bias": torch.zeros(n_components_stack, dtype=dtype, device=device),
        }
        return params, _mask_buffers(n_dict_components, n_components_stack, l1_alpha, bias_decay, dtype, device)

    @staticmethod
    def loss(params, buffers, batch):
        """(total [M], (loss_data, {"c": c [M, B, S]}))."""
        learned_dict = _norm_rows(params["encoder"])
        c = torch.relu(_encode_mm(learned_dict, batch) + _bias(params)) * px.cast_in(buffers["coef_keep"])[:, None, :]
        total, loss_data = _l1_losses(_decode_mm(learned_dict, c), batch, c, buffers)
        return total, (loss_data, {"c": c})

    @staticmethod
    def to_learned_dict(params, buffers):
        """One member's first ``dict_size`` rows as a `TiedSAE`."""
        n = int(buffers["dict_size"])
        return TiedSAE(params["encoder"][:n], params["encoder_bias"][:n], norm_encoder=True)


class FunctionalMaskedSAE:
    """The untied masked SAE (`FunctionalMaskedTiedSAE`'s buffers): params
    ``encoder`` [S, D], ``encoder_bias`` [S], ``decoder`` [S, D]."""

    @staticmethod
    def init(generator: torch.Generator, activation_size: int, n_dict_components: int, n_components_stack: int,
             l1_alpha: float, bias_decay: float = 0.0, dtype=torch.float32, device=None):
        """One member's (params, buffers), unstacked: glorot-uniform encoder
        then decoder (drawn in that order), a zero bias."""
        device = device if device is not None else generator.device
        shape = (n_components_stack, activation_size)
        params = {
            "encoder": glorot_uniform(shape, generator, dtype, device),
            "encoder_bias": torch.zeros(n_components_stack, dtype=dtype, device=device),
            "decoder": glorot_uniform(shape, generator, dtype, device),
        }
        return params, _mask_buffers(n_dict_components, n_components_stack, l1_alpha, bias_decay, dtype, device)

    @staticmethod
    def loss(params, buffers, batch):
        """(total [M], (loss_data, {"c": c [M, B, S]}))."""
        learned_dict = _norm_rows(params["decoder"])
        c = torch.relu(_encode_mm(params["encoder"], batch) + _bias(params))
        c = c * px.cast_in(buffers["coef_keep"])[:, None, :]
        total, loss_data = _l1_losses(_decode_mm(learned_dict, c), batch, c, buffers)
        return total, (loss_data, {"c": c})

    @staticmethod
    def to_learned_dict(params, buffers):
        """One member's first ``dict_size`` rows as an `UntiedSAE`."""
        n = int(buffers["dict_size"])
        return UntiedSAE(params["encoder"][:n], params["decoder"][:n], params["encoder_bias"][:n])


class FunctionalReverseSAE:
    """Tied SAE that subtracts the bias again from the active features before
    decoding (``where(c > 0, c - b, c)``): params ``encoder`` [N, D],
    ``encoder_bias`` [N]; buffers ``l1_alpha``, ``bias_decay``."""

    @staticmethod
    def init(generator: torch.Generator, activation_size: int, n_dict_components: int, l1_alpha: float,
             bias_decay: float = 0.0, dtype=torch.float32, device=None):
        """One member's (params, buffers), unstacked."""
        device = device if device is not None else generator.device
        params = {
            "encoder": glorot_uniform((n_dict_components, activation_size), generator, dtype, device),
            "encoder_bias": torch.zeros(n_dict_components, dtype=dtype, device=device),
        }
        buffers = {
            "l1_alpha": torch.tensor(l1_alpha, dtype=dtype, device=device),
            "bias_decay": torch.tensor(bias_decay, dtype=dtype, device=device),
        }
        return params, buffers

    @staticmethod
    def loss(params, buffers, batch):
        """(total [M], (loss_data with ``l_bias_decay``, {"c": c [M, B, N]}))."""
        learned_dict = _norm_rows(params["encoder"])
        c = torch.relu(_encode_mm(learned_dict, batch) + _bias(params))
        c = torch.where(c > 0.0, c - _bias(params), c)
        total, loss_data = _l1_losses(_decode_mm(learned_dict, c), batch, c, buffers)
        l_bias_decay = buffers["bias_decay"] * _safe_l2(params["encoder_bias"])
        total = total + l_bias_decay
        return total, ({**loss_data, "loss": total, "l_bias_decay": l_bias_decay}, {"c": c})

    @staticmethod
    def to_learned_dict(params, buffers):
        """One member as a `ReverseSAE`."""
        return ReverseSAE(params["encoder"], params["encoder_bias"], norm_encoder=True)
