"""Fused TopK training-step kernels for the H100, with their plain versions.

Counterpart of `sparse_coding__tpu/ops/topk_kernel.py` (Pallas, TPU). The
stacked step of a TopK k-sweep runs as hand-written CUDA kernels, the member
axis a grid dimension and each member's ``k`` read on the device:

  K_s `topk_scores` (csrc/topk_fwd.cu) replaces `_topk_scores_kernel`:
      s = bf16(x·D̂ᵀ), written once by a TMA + `wgmma` GEMM (a persistent
      block an SM, 128 × 256 output tiles), then each row's exact k-th
      largest bf16 score (the two bytes of the ordered 16-bit key found by
      bisection on fp16 counts held in registers; no atomics). Two launches
      behind one C entry; `sc_topk_select` runs the select alone.
  K_d `topk_decode` (csrc/topk_fwd.cu) replaces `_topk_decode_kernel`:
      c = s where (s ≥ t ∧ s > 0), x̂ = c·D̂ in f32, dxh = bf16(2/(B·D)·(x̂ − x)),
      Σerr² — a sparse decode: a warp a row lists the row's kept columns and
      gathers only those rows of D̂, adding them in ascending column order.
  backward: K3 (`topk_grads_stacked`) or K2 (`topk_adam_step_stacked`) of
      `tied_sae_kernel` at ``l1 = 0``, on their sparse route
      (csrc/tied_sae_bwd_sparse.cu: only the code's ~k of N non-zeros a row
      are touched), their bias gradient dropped — a top-k mask and a relu
      both reach the backward as ``c > 0``, as the JAX package reuses its
      tied bwd kernels.

Selection semantics, as the Pallas kernels': the threshold is the EXACT k-th
largest bf16 score (ties with it are all kept) and non-positive survivors
are dropped — `models.topk.topk_mask_code_approx` with recall 1.

Each wrapper dispatches on the device of its tensors: CPU tensors run the
plain PyTorch version beside it; CUDA tensors launch the kernel, or raise.
Each launch adds one to its entry in `LAUNCHES`, counted on the card at every
execution, a CUDA graph's replays of it included (`_wrap.LaunchCounts`).

Rounding points (from the Pallas code): x_b = bf16(x); nrm = sqrt(Σ d²) in f32
with no eps; D̂_b = bf16(d / nrm); s = bf16(f32-accumulated x_b·D̂_bᵀ); the
select runs on s's bits; c keeps s's bf16 value; l_rec = Σerr² / (B·D).
"""

from __future__ import annotations

from typing import Tuple

import torch

from sparse_coding__tpu_torch.ops import _build
from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
from sparse_coding__tpu_torch.ops._wrap import (
    FWD_COLS,
    FWD_ROWS,
    LaunchCounts,
    MAX_SMEM,
    check_cuda,
    check_dtype,
    require,
    stream,
)
from sparse_coding__tpu_torch.utils.optim import f32

bf16 = torch.bfloat16
fp32 = torch.float32

# launches of each kernel since the counts were last reset, counted on the
# card (`_wrap.LaunchCounts`; plain-version calls on CPU tensors do not count)
LAUNCHES = LaunchCounts(("topk_scores", "topk_decode"))

# the first design's bound on N (one row of N 16-bit keys beside a 2 KB
# histogram in a block's shared memory), kept so that the TopK path takes
# exactly the shapes it took: the select now holds its keys in registers and
# counts a longer row in pieces
SELECT_STATIC_SMEM = 2048
# the JAX TopK step's backward dictionary tile (`TOPK_BWD_DICT_TILE`), whose
# (member, tile, row) indices seed the stochastic moment stores
SEED_TILE = 128


def reset_launches() -> None:
    LAUNCHES.reset()


def fwd_shapes_supported(n_dict: int, d_act: int, batch: int = None) -> bool:
    """The forward's multiples (`FWD_ROWS`, `FWD_COLS`): B % 64, N % 128,
    D % 128 (K_s's GEMM loads and stores its 128 × 256 tiles masked at the
    edges), and N within the first design's shared-memory row
    (`SELECT_STATIC_SMEM`). K_d takes every shape K_s takes: a warp a row,
    x̂ in register passes of 1024 columns."""
    if n_dict % FWD_COLS or d_act % FWD_COLS or 2 * n_dict + SELECT_STATIC_SMEM > MAX_SMEM:
        return False
    return batch is None or batch % FWD_ROWS == 0


def shapes_supported(n_dict: int, d_act: int, batch: int = None) -> bool:
    """THE shape predicate of the TopK path on Hopper (its kernels' own tiling,
    not the TPU's VMEM budgets): K_s/K_d's (`fwd_shapes_supported`) and the
    backward's (`tied_sae_kernel.shapes_supported`)."""
    return fwd_shapes_supported(n_dict, d_act, batch) and tk.shapes_supported(n_dict, d_act, batch)


# -- the ordered 16-bit keys ---------------------------------------------------

def _ordered(sb: torch.Tensor) -> torch.Tensor:
    """bf16 → int32 key in [0, 0xFFFF] whose integer order is the float order:
    ``b | 0x8000``-style for non-negatives, ``0xFFFF - b`` for negatives
    (the Pallas `_ordered_i32`)."""
    b = sb.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    return torch.where(b >= 0x8000, 0xFFFF - b, b + 0x8000)


def _unordered(key: torch.Tensor) -> torch.Tensor:
    """Inverse of `_ordered`: int32 key → the bf16 value."""
    b = torch.where(key >= 0x8000, key - 0x8000, 0xFFFF - key)
    return torch.where(b >= 0x8000, b - 0x10000, b).to(torch.int16).view(bf16)


# -- K_s ------------------------------------------------------------------------

def _select_plain(s: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Each row's exact k[m]-th largest bf16 score, as f32, by a sort of the
    ordered keys (ties kept: the same key as the kernel's radix select;
    k clamped to [1, N] as the kernel clamps it)."""
    M, B, N = s.shape
    keys = torch.sort(_ordered(s), dim=-1, descending=True).values
    kk = k.to(torch.int64).clamp(1, N) - 1
    kth = torch.gather(keys, -1, kk.view(M, 1, 1).expand(M, B, 1))[..., 0]
    return _unordered(kth).float()


def _topk_scores_plain(xb, db, k):
    s = torch.matmul(xb.float(), db.float().transpose(1, 2)).to(bf16)
    return s, _select_plain(s, k)


def topk_scores(xb, db, k):
    """K_s. xb [B, D] bf16, db [M, N, D] bf16 (normalized rows), k [M] int32
    → (s [M, B, N] bf16, thresh [M, B] f32)."""
    if not xb.is_cuda:
        return _topk_scores_plain(xb, db, k)
    name = "topk_scores"
    dev = check_cuda(name, xb=xb, db=db, k=k)
    M, N, D = db.shape
    B = xb.shape[0]
    check_dtype(name, xb, "xb", bf16)
    check_dtype(name, db, "db", bf16)
    check_dtype(name, k, "k", torch.int32)
    require(xb.shape == (B, D) and k.shape == (M,), f"{name}: shape mismatch")
    require(fwd_shapes_supported(N, D, B), f"{name}: shape (B={B}, N={N}, D={D}) not supported")
    s = torch.empty((M, B, N), dtype=bf16, device=dev)
    thresh = torch.empty((M, B), dtype=fp32, device=dev)
    rc = _build.load()["topk_fwd"].sc_topk_scores(
        xb.data_ptr(), db.data_ptr(), k.data_ptr(), s.data_ptr(), thresh.data_ptr(),
        M, B, N, D, stream(dev),
    )
    _build.check(rc, name)
    LAUNCHES.count(name, dev)
    return s, thresh


# -- K_d ------------------------------------------------------------------------

def _topk_decode_plain(s, thresh, db, xb, scale):
    sf = s.float()
    keep = (sf >= thresh[..., None]) & (sf > 0)
    c = torch.where(keep, s, torch.zeros((), dtype=bf16, device=s.device))
    err = torch.matmul(c.float(), db.float()) - xb.float()
    return c, (f32(scale, err) * err).to(bf16), (err * err).sum(dim=(1, 2))


def topk_decode(s, thresh, db, xb, scale: float):
    """K_d. s [M, B, N] bf16, thresh [M, B] f32, db [M, N, D] bf16, xb [B, D]
    bf16 → (c [M, B, N] bf16, dxh [M, B, D] bf16, Σerr² [M] f32)."""
    if not xb.is_cuda:
        return _topk_decode_plain(s, thresh, db, xb, scale)
    name = "topk_decode"
    dev = check_cuda(name, s=s, thresh=thresh, db=db, xb=xb)
    M, N, D = db.shape
    B = xb.shape[0]
    for key, t, dt in (("s", s, bf16), ("thresh", thresh, fp32), ("db", db, bf16), ("xb", xb, bf16)):
        check_dtype(name, t, key, dt)
    require(s.shape == (M, B, N) and thresh.shape == (M, B) and xb.shape == (B, D),
             f"{name}: shape mismatch")
    require(fwd_shapes_supported(N, D, B), f"{name}: shape (B={B}, N={N}, D={D}) not supported")
    c = torch.empty((M, B, N), dtype=bf16, device=dev)
    dxh = torch.empty((M, B, D), dtype=bf16, device=dev)
    lrec_part = torch.empty((M, B), dtype=fp32, device=dev)
    rc = _build.load()["topk_fwd"].sc_topk_decode(
        xb.data_ptr(), db.data_ptr(), s.data_ptr(), thresh.data_ptr(), c.data_ptr(),
        dxh.data_ptr(), lrec_part.data_ptr(), M, B, N, D, float(scale), stream(dev),
    )
    _build.check(rc, name)
    LAUNCHES.count(name, dev)
    # per-row partials summed here: no float atomics, same bits every run
    return c, dxh, lrec_part.sum(dim=1)


# -- the JAX package's entry points -----------------------------------------------

def _topk_fwd(d_raw, k, batch):
    """K_s + K_d: (xb, nrm, db, c, dxh, l_rec [M])."""
    M, N, D = d_raw.shape
    B = batch.shape[0]
    require(
        shapes_supported(N, D, B),
        f"shape (B={B}, N={N}, D={D}) not covered by the TopK kernels "
        "(gate callers with shapes_supported)",
    )
    nrm = torch.sqrt(torch.sum(d_raw * d_raw, dim=-1))
    db = tk.normalized_rows_bf16(d_raw, nrm)
    xb = batch.to(bf16)
    s, thresh = topk_scores(xb, db, k.to(torch.int32).reshape(M).contiguous())
    c, dxh, lrec = topk_decode(s, thresh, db, xb, 2.0 / (B * D))
    return xb, nrm, db, c, dxh, lrec / (B * D)


def topk_grads_stacked(d_raw, k, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked-ensemble TopK gradient w.r.t. the RAW dictionary (K_s + K_d +
    K3). d_raw [M, N, D] f32, k [M] per-member sparsity, batch [B, D] shared.
    Returns (g_dict [M, N, D] f32, l_rec [M] f32 = the MSE loss)."""
    xb, nrm, db, c, dxh, l_rec = _topk_fwd(d_raw, k, batch)
    zeros = torch.zeros(d_raw.shape[0], dtype=fp32, device=d_raw.device)
    g, _ = tk.tied_sae_bwd_grads(xb, dxh, c, nrm, db, zeros, sparse=True)
    return g, l_rec


def topk_adam_step_stacked(d_raw, mu_d, nu_d, batch, k, bc, seed, lr, b1, b2, eps):
    """Fused fwd + bwd + Adam for the stacked TopK ensemble (K_s + K_d + K2).
    The contract of `tied_sae_kernel.tied_sae_adam_step_stacked` without the
    bias and l1 terms: mu_d and nu_d f32, bf16 or int8 `QuantMoment`, bc
    [M, 2] the bias corrections of this step, ``seed`` the step count seeding
    the stochastic stores over `SEED_TILE`-row dictionary tiles. Returns
    (d_new, mu_new, nu_new, l_rec); on CUDA d_raw/mu_d/nu_d are updated in
    place."""
    xb, nrm, _, c, dxh, l_rec = _topk_fwd(d_raw, k, batch)
    zeros = torch.zeros(d_raw.shape[0], dtype=fp32, device=d_raw.device)
    d_new, mu_new, nu_new, _ = tk.tied_sae_bwd_adam(
        xb, dxh, c, nrm, d_raw, mu_d, nu_d, zeros, bc.to(fp32).contiguous(), lr, b1, b2, eps,
        seed=seed, seed_tile=SEED_TILE, sparse=True,
    )
    return d_new, mu_new, nu_new, l_rec
