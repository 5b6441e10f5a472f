"""Fused tied-SAE training-step kernels for the H100, with their plain versions.

Counterpart of `sparse_coding__tpu/ops/tied_sae_kernel.py` (Pallas, TPU). The
step of the WHOLE stacked ensemble runs as hand-written CUDA kernels
(`csrc/*.cu`, built by `_build`), the member axis a grid dimension:

  K1 `tied_sae_fwd`       (csrc/tied_sae_fwd.cu) replaces `_fwd_kernel`:
      c = relu(x·D̂ᵀ + b) (bf16), dxh = bf16(2/(B·D)·(x̂ − x)), Σerr², Σc.
  K2 `tied_sae_bwd_adam`  (csrc/tied_sae_bwd.cu) replaces `_bwd_adam_kernel`
      + `_adam_epilogue` and covers `_bwd_adam_accum_kernel`: code cotangent
      → encoder gradient → normalisation VJP → Adam, the gradient kept on chip.
  K3 `tied_sae_bwd_grads` (csrc/tied_sae_bwd.cu) replaces `_bwd_kernel`: the
      same gradient written out in f32, for masked ensembles and optimizers
      the kernel cannot fuse.

K2 and K3 at ``l1 = 0`` are also the TopK step's backward (`topk_kernel`).

Each wrapper dispatches on the device of its tensors: CPU tensors run the
plain PyTorch version beside it (same rounding points — how the CPU tests
reach this path); CUDA tensors launch the kernel, or raise. Each launch adds
one to its entry in `LAUNCHES`. The plain versions are also what
`chip_smoke.py` holds each kernel against on the card.

Rounding points (from the Pallas code): x_b = bf16(x); nrm = sqrt(Σ d²) in f32
with no eps; D̂_b = bf16(d / nrm). c = relu(x_b·D̂_bᵀ + b) in f32, Σc from the
f32 c, stored bf16. x̂ = Σ c_b·D̂_b in f32; dxh = bf16(scale·(x̂ − f32(x_b))).
dc = dxh_b·D̂_bᵀ in f32, masked on the stored c_b > 0, plus l1/B; g_bias = Σ_b dc
before rounding; g_dhat = c_bᵀ·dxh_b + bf16(dc)ᵀ·x_b; g = (g_dhat − D̂ ⟨g_dhat, D̂⟩)/nrm.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from sparse_coding__tpu_torch.ops import _build
from sparse_coding__tpu_torch.ops._wrap import FWD_COLS, FWD_ROWS, check_cuda, check_dtype, require, stream
from sparse_coding__tpu_torch.utils.optim import decayed_moment, f32

bf16 = torch.bfloat16
fp32 = torch.float32

# launches of each kernel since the counts were last reset (plain-version
# calls on CPU tensors do not count)
LAUNCHES: Dict[str, int] = {"tied_sae_fwd": 0, "tied_sae_bwd_adam": 0, "tied_sae_bwd_grads": 0}

# the shapes the kernels are written for: D, and the elements Nt·D of K2/K3's
# [Nt, D] gradient tile (16 warps × 2 row bands × 4 column blocks of 16×16
# fragments; 3 column blocks at D 768, where 32768 / D is no multiple of 32)
BWD_TILE_ELEMS = {128: 32768, 256: 32768, 512: 32768, 768: 24576, 1024: 32768}
WIDTHS = tuple(BWD_TILE_ELEMS)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bwd_dict_tile(d_act: int) -> int:
    """Dictionary rows per block of K2/K3 at width ``d_act`` (32 at D 768)."""
    return BWD_TILE_ELEMS[d_act] // d_act


def shapes_supported(n_dict: int, d_act: int, batch: int = None) -> bool:
    """THE shape predicate of the Hopper kernels (their own tiling, not the
    TPU's VMEM budgets): D one of `WIDTHS`, N divisible by K1's 128-column
    tile and the bwd dictionary tile, and (when given) B by K1's 64-row tile."""
    if d_act not in WIDTHS:
        return False
    if n_dict % FWD_COLS or n_dict % bwd_dict_tile(d_act):
        return False
    return batch is None or batch % FWD_ROWS == 0


# -- K1 -----------------------------------------------------------------------

def _encode_plain(xb, db, bias):
    """K1's first half: (c [M, B, N] bf16, Σc [M] from the f32 c)."""
    c = torch.clamp_min(torch.matmul(xb.float(), db.float().transpose(1, 2)) + bias[:, None, :], 0.0)
    return c.to(bf16), c.sum(dim=(1, 2))


def _decode_plain(xb, db, cb, scale):
    """K1's second half, from the bf16 code: (dxh [M, B, D] bf16, Σerr² [M])."""
    xf = xb.float()
    err = torch.matmul(cb.float(), db.float()) - xf
    return (f32(scale, err) * err).to(bf16), (err * err).sum(dim=(1, 2))


def _fwd_plain(xb, db, bias, scale):
    cb, ll1 = _encode_plain(xb, db, bias)
    dxh, lrec = _decode_plain(xb, db, cb, scale)
    return cb, dxh, lrec, ll1


def tied_sae_fwd(xb, db, bias, scale: float):
    """K1. xb [B, D] bf16, db [M, N, D] bf16 (normalized rows), bias [M, N]
    f32 → (c [M, B, N] bf16, dxh [M, B, D] bf16, Σerr² [M] f32, Σc [M] f32)."""
    if not xb.is_cuda:
        return _fwd_plain(xb, db, bias, scale)
    name = "tied_sae_fwd"
    dev = check_cuda(name, xb=xb, db=db, bias=bias)
    M, N, D = db.shape
    B = xb.shape[0]
    check_dtype(name, xb, "xb", bf16)
    check_dtype(name, db, "db", bf16)
    check_dtype(name, bias, "bias", fp32)
    require(xb.shape == (B, D) and bias.shape == (M, N), f"{name}: shape mismatch")
    require(shapes_supported(N, D, B), f"{name}: shape (B={B}, N={N}, D={D}) not supported")
    c = torch.empty((M, B, N), dtype=bf16, device=dev)
    dxh = torch.empty((M, B, D), dtype=bf16, device=dev)
    l1_part = torch.empty((M, B // FWD_ROWS, N // FWD_COLS), dtype=fp32, device=dev)
    lrec_part = torch.empty((M, B // FWD_ROWS, D // FWD_COLS), dtype=fp32, device=dev)
    lib = _build.load()["tied_sae_fwd"]
    rc = lib.sc_tied_sae_fwd(
        xb.data_ptr(), db.data_ptr(), bias.data_ptr(), c.data_ptr(), dxh.data_ptr(),
        l1_part.data_ptr(), lrec_part.data_ptr(), M, B, N, D, float(scale), stream(dev),
    )
    _build.check(rc, name)
    LAUNCHES[name] += 1
    # per-block partials summed here: no float atomics, same bits every run
    return c, dxh, lrec_part.sum(dim=(1, 2)), l1_part.sum(dim=(1, 2))


# -- K2 / K3 --------------------------------------------------------------------

def _grads_plain(xb, dxh, c, nrm, db, l1_over_b):
    """Shared body of the bwd plain versions: (g [M, N, D], g_bias [M, N])."""
    xf, dxf, cf, djf = xb.float(), dxh.float(), c.float(), db.float()
    dc = torch.matmul(dxf, djf.transpose(1, 2))
    dc = torch.where(cf > 0, dc + l1_over_b[:, None, None], torch.zeros_like(dc))
    g_bias = dc.sum(dim=1)
    dcf = dc.to(bf16).float()
    g_dhat = torch.matmul(cf.transpose(1, 2), dxf) + torch.matmul(dcf.transpose(1, 2), xf)
    radial = torch.sum(g_dhat * djf, dim=-1, keepdim=True)
    return (g_dhat - djf * radial) / nrm[..., None], g_bias


def _adam_plain(g, d_raw, mu, nu, bc, lr, b1, b2, eps):
    """The `_adam_epilogue` expressions, term for term."""
    omb1, omb2 = f32(1 - b1, g), f32(1 - b2, g)
    mu_new = decayed_moment(b1, mu).float() + omb1 * g
    nu_new = f32(b2, g) * nu + omb2 * g * g
    mhat = mu_new / bc[:, 0, None, None]
    vhat = nu_new / bc[:, 1, None, None]
    d_new = d_raw - f32(lr, g) * mhat / (torch.sqrt(vhat) + f32(eps, g))
    return d_new, mu_new.to(mu.dtype), nu_new


def tied_sae_bwd_adam(xb, dxh, c, nrm, d_raw, mu, nu, l1_over_b, bc, lr, b1, b2, eps):
    """K2. xb [B, D] bf16, dxh [M, B, D] bf16, c [M, B, N] bf16, nrm [M, N]
    f32, d_raw [M, N, D] f32 raw encoder with its Adam moments mu (f32 or
    bf16) and nu (f32), l1_over_b [M] f32, bc [M, 2] f32 bias corrections of
    this step → (d_new, mu_new, nu_new, g_bias [M, N]).

    On CUDA the kernel writes d_new, mu_new and nu_new INTO d_raw, mu and nu
    (the TPU kernel aliases them the same way) and returns those tensors."""
    if not xb.is_cuda:
        dj = (d_raw / nrm[..., None]).to(bf16)
        g, g_bias = _grads_plain(xb, dxh, c, nrm, dj, l1_over_b)
        return (*_adam_plain(g, d_raw, mu, nu, bc, lr, b1, b2, eps), g_bias)
    name = "tied_sae_bwd_adam"
    dev = check_cuda(name, xb=xb, dxh=dxh, c=c, nrm=nrm, d_raw=d_raw, mu=mu, nu=nu,
                      l1_over_b=l1_over_b, bc=bc)
    M, N, D = d_raw.shape
    B = xb.shape[0]
    for key, t, dt in (("xb", xb, bf16), ("dxh", dxh, bf16), ("c", c, bf16), ("nrm", nrm, fp32),
                       ("d_raw", d_raw, fp32), ("nu", nu, fp32), ("l1_over_b", l1_over_b, fp32),
                       ("bc", bc, fp32)):
        check_dtype(name, t, key, dt)
    require(mu.dtype in (fp32, bf16), f"{name}: mu must be float32 or bfloat16, got {mu.dtype}")
    require(
        xb.shape == (B, D) and dxh.shape == (M, B, D) and c.shape == (M, B, N)
        and nrm.shape == (M, N) and mu.shape == nu.shape == (M, N, D)
        and l1_over_b.shape == (M,) and bc.shape == (M, 2),
        f"{name}: shape mismatch",
    )
    require(shapes_supported(N, D, B), f"{name}: shape (B={B}, N={N}, D={D}) not supported")
    g_bias = torch.empty((M, N), dtype=fp32, device=dev)
    lib = _build.load()["tied_sae_bwd"]
    rc = lib.sc_tied_sae_bwd_adam(
        xb.data_ptr(), dxh.data_ptr(), c.data_ptr(), nrm.data_ptr(), d_raw.data_ptr(),
        mu.data_ptr(), int(mu.dtype == bf16), nu.data_ptr(), g_bias.data_ptr(),
        l1_over_b.data_ptr(), bc.data_ptr(), float(lr), float(b1), float(b2), float(eps),
        float(1 - b1), float(1 - b2), M, B, N, D, stream(dev),
    )
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return d_raw, mu, nu, g_bias


def tied_sae_bwd_grads(xb, dxh, c, nrm, db, l1_over_b):
    """K3. As K2 with the normalized rows db [M, N, D] bf16 given and no
    Adam → (g_enc [M, N, D] f32 w.r.t. the RAW encoder, g_bias [M, N] f32)."""
    if not xb.is_cuda:
        return _grads_plain(xb, dxh, c, nrm, db, l1_over_b)
    name = "tied_sae_bwd_grads"
    dev = check_cuda(name, xb=xb, dxh=dxh, c=c, nrm=nrm, db=db, l1_over_b=l1_over_b)
    M, N, D = db.shape
    B = xb.shape[0]
    for key, t, dt in (("xb", xb, bf16), ("dxh", dxh, bf16), ("c", c, bf16), ("nrm", nrm, fp32),
                       ("db", db, bf16), ("l1_over_b", l1_over_b, fp32)):
        check_dtype(name, t, key, dt)
    require(
        xb.shape == (B, D) and dxh.shape == (M, B, D) and c.shape == (M, B, N)
        and nrm.shape == (M, N) and l1_over_b.shape == (M,),
        f"{name}: shape mismatch",
    )
    require(shapes_supported(N, D, B), f"{name}: shape (B={B}, N={N}, D={D}) not supported")
    g_enc = torch.empty((M, N, D), dtype=fp32, device=dev)
    g_bias = torch.empty((M, N), dtype=fp32, device=dev)
    lib = _build.load()["tied_sae_bwd"]
    rc = lib.sc_tied_sae_bwd_grads(
        xb.data_ptr(), dxh.data_ptr(), c.data_ptr(), nrm.data_ptr(), db.data_ptr(),
        g_enc.data_ptr(), g_bias.data_ptr(), l1_over_b.data_ptr(), M, B, N, D, stream(dev),
    )
    _build.check(rc, name)
    LAUNCHES[name] += 1
    return g_enc, g_bias


# -- the JAX package's entry points -----------------------------------------------

def _prepare(d_raw, bias, batch):
    M, N, D = d_raw.shape
    B = batch.shape[0]
    require(
        shapes_supported(N, D, B),
        f"shape (B={B}, N={N}, D={D}) not covered by the tied-SAE kernels "
        "(gate callers with shapes_supported)",
    )
    nrm = torch.sqrt(torch.sum(d_raw * d_raw, dim=-1))
    return nrm, batch.to(bf16), bias.to(fp32).contiguous(), 2.0 / (B * D)


def tied_sae_adam_step_stacked(d_raw, bias, mu_d, nu_d, batch, l1_alpha, bc, seed, lr, b1, b2, eps):
    """Fused fwd + bwd + encoder-Adam for the stacked tied-SAE ensemble (K1 +
    K2). d_raw [M, N, D] f32 raw encoder, bias [M, N], mu_d (f32 or bf16) and
    nu_d (f32) its Adam moments, batch [B, D] shared by the members, l1_alpha
    [M], bc [M, 2] the bias corrections (1-b1^t, 1-b2^t) of this step. ``seed``
    feeds only the stochastic moment stores, which are not ported (ROADMAP
    B2); it is accepted for the JAX signature's sake. Returns (d_new, mu_new,
    nu_new, g_bias, l_rec, l_l1_raw); on CUDA d_raw/mu_d/nu_d are updated in
    place. The bias' own Adam update is the caller's."""
    del seed
    B = batch.shape[0]
    nrm, xb, b, scale = _prepare(d_raw, bias, batch)
    db = (d_raw / nrm[..., None]).to(bf16)
    c, dxh, lrec, ll1 = tied_sae_fwd(xb, db, b, scale)
    l1_over_b = l1_alpha.to(fp32).reshape(-1) / B
    d_new, mu_new, nu_new, g_bias = tied_sae_bwd_adam(
        xb, dxh, c, nrm, d_raw, mu_d, nu_d, l1_over_b, bc.to(fp32).contiguous(), lr, b1, b2, eps
    )
    D = d_raw.shape[2]
    return d_new, mu_new, nu_new, g_bias, lrec / (B * D), ll1 / B


def tied_sae_grads_stacked(d_hat, nrm, bias, batch, l1_alpha) -> Tuple[torch.Tensor, ...]:
    """Stacked-ensemble tied-SAE gradient w.r.t. the RAW encoder and bias (K1 +
    K3). d_hat [M, N, D] f32 row-normalized dictionaries, nrm [M, N] their
    raw row norms, bias [M, N], batch [B, D], l1_alpha [M]. Returns (g_enc
    [M, N, D], g_bias [M, N], l_rec [M], l_l1_raw [M])."""
    B = batch.shape[0]
    _, xb, b, scale = _prepare(d_hat, bias, batch)
    db = d_hat.to(bf16)
    c, dxh, lrec, ll1 = tied_sae_fwd(xb, db, b, scale)
    l1_over_b = l1_alpha.to(fp32).reshape(-1) / B
    g_enc, g_bias = tied_sae_bwd_grads(xb, dxh, c, nrm.to(fp32).contiguous(), db, l1_over_b)
    D = d_hat.shape[2]
    return g_enc, g_bias, lrec / (B * D), ll1 / B
