"""The k-sparse (top-k) training signatures and their export view.

Counterpart of `sparse_coding__tpu/models/topk.py`. As in `models.sae`, the
signature functions take the STACKED params/buffers of an ensemble (leading
member axis ``M``); each member's ``sparsity`` is a tensor, so a k-sweep
steps as one stack. Loss = MSE of the reconstruction from the normalized
dictionary, no l1 or bias term.

Selection, and how it matches the JAX package:
  - `TopKEncoder` keeps each row's first k entries in descending order,
    ties broken toward the lower index (`lax.top_k`'s order): a STABLE
    descending sort here, since `torch.topk` does not promise an order
    among equal values. relu after the mask.
  - `TopKEncoderApprox` keeps every entry ≥ the row's exact k-th largest
    score (ties all kept), relu after. On a TPU the JAX package finds that
    threshold with `lax.approx_max_k` at the member's ``recall``; on every
    other backend that is the exact top-k, and the fused kernels use the
    exact threshold too. The port stores ``recall`` (state and export
    compatibility) and ignores it.
  - `TopKLearnedDict.encode` is the static-k rank mask with the same stable
    order, relu after.

With bf16 compute and a shape the Hopper kernels take, `TopKEncoderApprox`
steps through `ops.topk_kernel` (fused grads / fused Adam; their plain
versions for CPU tensors).
"""

from __future__ import annotations

import torch

from sparse_coding__tpu_torch.models.learned_dict import LearnedDict, _norm_rows, register_learned_dict
from sparse_coding__tpu_torch.models.sae import _one_member
from sparse_coding__tpu_torch.ops import topk_kernel as kk
from sparse_coding__tpu_torch.utils import precision as px
from sparse_coding__tpu_torch.utils.optim import bias_corrections


def _top_sorted(scores: torch.Tensor, cap: int):
    """The descending top-``cap`` strip (values, indices) of each row, ties
    toward the lower index."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :cap], idx[..., :cap]


def _scatter_rank_masked(scores, top_vals, top_idx, k, cap: int, relu: bool = False):
    """Keep the first ``k`` of the ``cap`` strip (``k`` an int or a tensor
    broadcasting against ``scores[..., :1]``), optionally relu'd, scattered
    back into a zero [.., N] code. Gradients reach the kept scores only."""
    k = torch.as_tensor(k, device=scores.device)
    rank = torch.arange(cap, device=scores.device)
    vals = torch.where(rank < k, top_vals, torch.zeros((), dtype=scores.dtype, device=scores.device))
    if relu:
        vals = torch.relu(vals)
    return torch.zeros_like(scores).scatter(-1, top_idx, vals)


def topk_mask_code(scores: torch.Tensor, k) -> torch.Tensor:
    """Zero all but the top-``k`` entries of each row (stable ranks: ties
    toward the lower index). The semantic reference: two full-row sorts."""
    order = torch.argsort(scores, dim=-1, descending=True, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    k = torch.as_tensor(k, device=scores.device)
    return torch.where(ranks < k, scores, torch.zeros((), dtype=scores.dtype, device=scores.device))


def topk_mask_code_capped(scores: torch.Tensor, k, cap: int) -> torch.Tensor:
    """`topk_mask_code` through a top-``cap`` strip (``cap >= k``)."""
    top_vals, top_idx = _top_sorted(scores, int(cap))
    return _scatter_rank_masked(scores, top_vals, top_idx, k, int(cap))


def topk_mask_code_approx(scores: torch.Tensor, k, cap: int, recall_target: float = 1.0) -> torch.Tensor:
    """Keep every entry ≥ the row's exact k-th largest score (ties all kept;
    ``k`` an int or a tensor broadcasting against ``scores[..., :1]``, ``cap
    >= k``; the threshold carries no gradient). ``recall_target`` is the JAX
    package's TPU PartialReduce knob; off a TPU its selection is exact, as it
    is here, so it is accepted and ignored."""
    del recall_target
    top = torch.topk(scores.detach(), int(cap), dim=-1).values  # values sorted: no tie order involved
    k = torch.as_tensor(k, dtype=torch.int64, device=scores.device)
    thresh = torch.gather(top, -1, (k - 1).expand(*scores.shape[:-1], 1))
    return torch.where(scores >= thresh, scores, torch.zeros((), dtype=scores.dtype, device=scores.device))


def topk_mask_code_static(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Static-k rank mask: the top ``k`` values scattered back (ties toward
    the lower index)."""
    top_vals, top_idx = _top_sorted(scores, int(k))
    return torch.zeros_like(scores).scatter(-1, top_idx, top_vals)


def _member_k(buffers, scores: torch.Tensor) -> torch.Tensor:
    """Per-member sparsity [M] shaped to broadcast against [M, B, cap]."""
    return buffers["sparsity"].to(torch.int64).reshape(-1, *([1] * (scores.ndim - 1)))


class TopKEncoder:
    """k-sparse autoencoder signature: scores = x·D̂ᵀ, keep the top k, relu,
    MSE loss. ``sparsity`` is a per-member int32 buffer; the cap of a
    mixed-k sweep rides along as the SHAPE of the int8 ``topk_cap`` buffer
    (the JAX package needs it static; here it bounds the sorted strip), so
    every member of one ensemble passes the same ``sparsity_cap``."""

    @staticmethod
    def init(generator: torch.Generator, d_activation: int, n_features: int, sparsity: int,
             dtype=torch.float32, sparsity_cap=None, device=None):
        """One member's (params, buffers), unstacked."""
        cap = int(sparsity if sparsity_cap is None else sparsity_cap)
        if not 0 < int(sparsity) <= cap <= n_features:
            raise ValueError(f"need 0 < sparsity ({sparsity}) <= cap ({cap}) <= n_features ({n_features})")
        device = device if device is not None else generator.device
        params = {"dict": torch.randn((n_features, d_activation), generator=generator, dtype=dtype, device=device)}
        buffers = {
            "sparsity": torch.tensor(int(sparsity), dtype=torch.int32, device=device),
            # value unused; its length is the cap
            "topk_cap": torch.zeros(cap, dtype=torch.int8, device=device),
        }
        return params, buffers

    @staticmethod
    def _cap(params, buffers) -> int:
        cap = buffers.get("topk_cap")
        return params["dict"].shape[-2] if cap is None else cap.shape[-1]

    @classmethod
    def _select(cls, scores, buffers, cap: int):
        top_vals, top_idx = _top_sorted(scores, cap)
        return _scatter_rank_masked(scores, top_vals, top_idx, _member_k(buffers, scores), cap, relu=True)

    @classmethod
    def encode(cls, batch, buffers, normed_dict, cap: int):
        """Stacked codes [M, B, N] of a shared batch [B, D] against the
        normalized dictionary ``normed_dict`` [M, N, D], at most ``cap``
        kept a row (the selection's static size), under the precision
        policy (JAX's signature)."""
        scores = torch.matmul(px.cast_in(batch), px.cast_in(normed_dict).transpose(-2, -1))
        return cls._select(scores, buffers, cap)

    @classmethod
    def _code(cls, params, buffers, batch):
        """(normalized dictionary [M, N, D] in the compute dtype, code [M, B, N])."""
        nd = px.cast_in(_norm_rows(params["dict"]))
        return nd, cls.encode(batch, buffers, nd, cls._cap(params, buffers))

    @classmethod
    def loss(cls, params, buffers, batch):
        """(loss [M], ({"loss": loss}, {"c": code [M, B, N]}))."""
        nd, code = cls._code(params, buffers, batch)
        # decode accumulated and kept in f32 (bf16-valued operands under the policy)
        diff = torch.matmul(code.float(), nd.float()) - px.acc_f32(batch)
        loss = torch.mean(diff * diff, dim=(-2, -1))
        return loss, ({"loss": loss}, {"c": code})

    @staticmethod
    def to_learned_dict(params, buffers):
        """One member (unstacked params/buffers) as a `TopKLearnedDict`."""
        return TopKLearnedDict(_norm_rows(params["dict"]), int(buffers["sparsity"]))


class TopKEncoderApprox(TopKEncoder):
    """`TopKEncoder` with threshold selection in training: every score ≥ the
    row's exact k-th largest is kept (ties all kept, so L0 may exceed k by the
    tie count), relu after. ``recall`` (the JAX package's TPU knob, default
    `RECALL`) is stored and ignored. Exports are `TopKLearnedDict`s, exact."""

    RECALL = 0.95

    @staticmethod
    def init(generator: torch.Generator, d_activation: int, n_features: int, sparsity: int,
             dtype=torch.float32, sparsity_cap=None, recall=None, device=None):
        params, buffers = TopKEncoder.init(generator, d_activation, n_features, sparsity,
                                           dtype=dtype, sparsity_cap=sparsity_cap, device=device)
        r = float(TopKEncoderApprox.RECALL if recall is None else recall)
        if not 0.0 < r <= 1.0:
            raise ValueError(f"recall must be in (0, 1], got {r}")
        buffers["recall"] = torch.tensor(r, dtype=torch.float32, device=buffers["sparsity"].device)
        return params, buffers

    @classmethod
    def _select(cls, scores, buffers, cap: int):
        return torch.relu(topk_mask_code_approx(scores, _member_k(buffers, scores), cap))

    # -- fused step (ops/topk_kernel.py) ----------------------------------

    @staticmethod
    def fused_supported(params, buffers) -> bool:
        """True when the Hopper kernels' tiling takes the dictionary shape
        (`ops.topk_kernel.shapes_supported`). Unstacked or stacked params;
        the batch is checked per step (`fused_batch_supported`)."""
        n_features, d_activation = params["dict"].shape[-2:]
        return kk.shapes_supported(n_features, d_activation)

    @staticmethod
    def fused_batch_supported(stacked_params, batch_size: int, adam_fused: bool = True) -> bool:
        """Whether the kernels take this batch size. K2 and K3 both walk the
        whole batch inside each block, so ``adam_fused`` does not change the
        answer; it is kept for the JAX signature."""
        n_features, d_activation = stacked_params["dict"].shape[-2:]
        return kk.shapes_supported(n_features, d_activation, batch_size)

    @staticmethod
    def fused_grads(params, buffers, batch):
        """One member's (unstacked) gradients + loss dict through
        `fused_grads_stacked`."""
        return _one_member(TopKEncoderApprox.fused_grads_stacked, params, buffers, batch)

    @staticmethod
    def fused_grads_stacked(params, buffers, batch):
        """Stacked-ensemble gradients + loss dict through K_s + K_d + K3."""
        g, l_rec = kk.topk_grads_stacked(params["dict"], buffers["sparsity"], batch)
        return {"dict": g}, {"loss": l_rec}

    @staticmethod
    def fused_adam_step(params, buffers, batch, opt_state, lr, b1, b2, eps, recompute_code=False):
        """Whole training step (grads + Adam) through K_s + K_d + K2; on CUDA
        the dictionary and its moments (f32, bf16 or int8 `QuantMoment`s) are
        updated in place, the step count seeding the stochastic stores.
        ``recompute_code`` is accepted and ignored, as in the JAX package: the
        scores round-trip device memory for the threshold anyway.
        ``opt_state`` is a `utils.optim.AdamState`. Returns ``(new_params,
        new_opt_state, loss_dict)``."""
        del recompute_code
        t = opt_state.count + 1
        bc1, bc2 = bias_corrections(t, b1, b2)
        d_new, mu_new, nu_new, l_rec = kk.topk_adam_step_stacked(
            params["dict"], opt_state.mu["dict"], opt_state.nu["dict"], batch,
            buffers["sparsity"], torch.stack([bc1, bc2], dim=-1), t[0],
            float(lr), float(b1), float(b2), float(eps),
        )
        new_state = type(opt_state)(count=t, mu={"dict": mu_new}, nu={"dict": nu_new})
        return {"dict": d_new}, new_state, {"loss": l_rec}


class TopKLearnedDict(LearnedDict):
    """Inference view: the normalized dictionary and a static sparsity."""

    def __init__(self, dictionary: torch.Tensor, sparsity: int):
        self.dict = dictionary
        self.sparsity = int(sparsity)
        self.n_feats, self.activation_size = dictionary.shape

    def get_learned_dict(self):
        return self.dict

    def encode(self, x):
        return torch.relu(topk_mask_code_static(x @ self.dict.T, self.sparsity))


register_learned_dict(TopKLearnedDict, ("dict",), ("sparsity",))
