"""Fused tied-SAE training-step kernels for the H100, with their plain versions.

Counterpart of `sparse_coding__tpu/ops/tied_sae_kernel.py` (Pallas, TPU). The
step of the WHOLE stacked ensemble runs as hand-written CUDA kernels
(`csrc/*.cu`, built by `_build`), the member axis a grid dimension:

  K1 `tied_sae_fwd`       (csrc/tied_sae_fwd.cu) replaces `_fwd_kernel`:
      c = relu(x·D̂ᵀ + b) (bf16), dxh = bf16(2/(B·D)·(x̂ − x)), Σerr², Σc;
      at D ≤ 512 the pipelined encode → decode below, storing each code
      tile as it leaves the encode.
  K1n `tied_sae_fwd_nocode` (csrc/tied_sae_fwd.cu) replaces
      `_fwd_kernel_nocode`: K1 with each code tile kept on chip (never
      stored), for the code-recompute step (``SC_RECOMPUTE_CODE=1``); at
      D ≤ 512 a pipelined encode → decode whose code passes from the
      encode's accumulators to the decode's operand in registers.
  K2 `tied_sae_bwd_adam`  (csrc/tied_sae_bwd.cu, _rc.cu) replaces `_bwd_adam_kernel`
      + `_adam_epilogue` and covers `_bwd_adam_accum_kernel`: code cotangent
      → encoder gradient → normalisation VJP → Adam, the gradient kept on chip.
      Its moments may be f32, bf16 (nu by a stochastic store) or int8
      `QuantMoment`s, and with ``c=None`` it rebuilds each code tile from x
      and D̂ⱼ (`_code_tile(recompute=True)`), bit-identical to K1's stored c.
  K3 `tied_sae_bwd_grads` (csrc/tied_sae_bwd.cu) replaces `_bwd_kernel`: the
      same gradient written out in f32, for masked ensembles and optimizers
      the kernel cannot fuse.

K2 and K3 at ``l1 = 0`` are also the TopK step's backward (`topk_kernel`),
which asks for their sparse route with ``sparse=True``
(csrc/tied_sae_bwd_sparse.cu, `LAUNCHES` names ``*_sparse``): the same
function, computed over the stored code's non-zeros only (gathered dxh and x
rows on the CUDA cores) before the same epilogue. The caller picks the route
statically; nothing inspects the code to decide. CPU tensors run the same
plain versions on either route.

Each wrapper dispatches on the device of its tensors: CPU tensors run the
plain PyTorch version beside it (same rounding points — how the CPU tests
reach this path); CUDA tensors launch the kernel, or raise. Each launch adds
one to its entry in `LAUNCHES`, counted on the card at every execution, a
CUDA graph's replays of it included (`_wrap.LaunchCounts`). The plain
versions are also what `chip_smoke.py` holds each kernel against on the
card.

Rounding points (from the Pallas code): x_b = bf16(x); nrm = sqrt(Σ d²) in f32
with no eps; D̂_b = bf16(d / nrm). c = relu(x_b·D̂_bᵀ + b) in f32, Σc from the
f32 c, stored bf16. x̂ = Σ c_b·D̂_b in f32; dxh = bf16(scale·(x̂ − f32(x_b))).
dc = dxh_b·D̂_bᵀ in f32, masked on the stored c_b > 0, plus l1/B; g_bias = Σ_b dc
before rounding; g_dhat = c_bᵀ·dxh_b + bf16(dc)ᵀ·x_b; g = (g_dhat − D̂ ⟨g_dhat, D̂⟩)/nrm.

Stochastic moment stores (`tile_bits`): the JAX package's interpret-mode
counter hash, so the plain versions match its Pallas entries bit for bit on
the CPU and the kernel matches the plain version on the card. The bits of
element (m, n, col) are ``mix32((r·D + col) ^ tile_seed)``, r = n mod Ns,
with ``tile_seed = mix32(seed ^ m·0x9E3779B9 ^ (n div Ns)·0x7FEB352D ^
salt)``; Ns is the JAX call's dictionary tile (`TIED_SEED_TILE`, or the
TopK step's 128), not the CUDA kernel's own.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sparse_coding__tpu_torch.ops import _build
from sparse_coding__tpu_torch.ops._wrap import (
    FWD_COLS,
    FWD_ROWS,
    LaunchCounts,
    check_cuda,
    check_dtype,
    require,
    stream,
)
from sparse_coding__tpu_torch.utils.optim import (
    QuantMoment,
    as_u32,
    decayed_moment,
    dequant,
    f32,
    mix32,
    mul32,
    quantize_rows_stochastic,
    stochastic_round,
)

bf16 = torch.bfloat16
fp32 = torch.float32

# launches of each kernel since the counts were last reset, counted on the
# card (`_wrap.LaunchCounts`; plain-version calls on CPU tensors do not count)
LAUNCHES = LaunchCounts((
    "tied_sae_fwd", "tied_sae_fwd_nocode", "tied_sae_bwd_adam", "tied_sae_bwd_grads",
    "tied_sae_bwd_adam_sparse", "tied_sae_bwd_grads_sparse",
))

# the stochastic stores' salts (`_adam_epilogue`: XORed into the tile's base
# seed before its mix) and the JAX tied step's dictionary tile, whose
# (member, tile, row) indices seed them
SALT_MU_INT8, SALT_NU_INT8, SALT_NU_BF16 = 0x5117A55A, 0x00A11CE5, 0
TIED_SEED_TILE = 256

# the widths the kernels are written for. The dense K2/K3 blocks take 128
# dictionary rows at D 128 and 256 and at D 512 on the stored code (a cluster
# of two blocks), 64 rows at D 512 rebuilding the code and 32 at D 768 and
# 1024 (csrc/tied_sae_bwd.cuh, which holds its tiles and shared-memory plans
# and asserts that each divides K1's 128-column tile)
WIDTHS = (128, 256, 512, 768, 1024)
# the widths at which K1 and K1n run the pipelined encode → decode (64-row
# blocks, TMA stages, `wgmma`); 768 and 1024 keep the WMMA kernels
PIPELINED_MAX_D = 512


def reset_launches() -> None:
    LAUNCHES.reset()


def shapes_supported(n_dict: int, d_act: int, batch: int = None) -> bool:
    """THE shape predicate of the Hopper kernels (their own tiling, not the
    TPU's VMEM budgets): D one of `WIDTHS`, N divisible by K1's 128-column
    tile (so by every bwd block's rows), and (when given) B by K1's 64-row
    tile (so by the bwd batch stages too)."""
    if d_act not in WIDTHS or n_dict % FWD_COLS:
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
    f32 → (c [M, B, N] bf16, dxh [M, B, D] bf16, Σerr² [M] f32, Σc [M] f32).
    c and dxh carry the same bits at every width; the loss sums group their
    partials per 64-row block at D ≤ 512 (as K1n's) and per output tile
    above, so they may differ between the two in the last bits."""
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
    # the loss partials: per 64-row block on the pipelined kernel (D ≤ 512),
    # else per 64 x 128 output tile of the WMMA encode and decode
    l1_cols, lrec_cols = (1, 1) if D <= PIPELINED_MAX_D else (N // FWD_COLS, D // FWD_COLS)
    l1_part = torch.empty((M, B // FWD_ROWS, l1_cols), dtype=fp32, device=dev)
    lrec_part = torch.empty((M, B // FWD_ROWS, lrec_cols), dtype=fp32, device=dev)
    lib = _build.load()["tied_sae_fwd"]
    rc = lib.sc_tied_sae_fwd(
        xb.data_ptr(), db.data_ptr(), bias.data_ptr(), c.data_ptr(), dxh.data_ptr(),
        l1_part.data_ptr(), lrec_part.data_ptr(), M, B, N, D, float(scale), stream(dev),
    )
    _build.check(rc, name)
    LAUNCHES.count(name, dev)
    # per-block partials summed here: no float atomics, same bits every run
    return c, dxh, lrec_part.sum(dim=(1, 2)), l1_part.sum(dim=(1, 2))


def nocode_tile(d_act: int) -> Tuple[int, int]:
    """K1n's (batch rows, dictionary rows) per block: a block keeps its rows'
    whole x̂ [rows, D] in f32 registers while it walks the dictionary (at
    D ≤ 512 in 64-row TMA stages, csrc/tied_sae_fwd.cu `pp_fwd_kernel`)."""
    return (64, 64) if d_act <= PIPELINED_MAX_D else (32, 32)


def nocode_shapes_supported(n_dict: int, d_act: int, batch: int) -> bool:
    """K1n's shape predicate: the tied kernels' (`shapes_supported`) and its
    own block tiles (`nocode_tile`)."""
    rows, nt = nocode_tile(d_act)
    return shapes_supported(n_dict, d_act, batch) and batch % rows == 0 and n_dict % nt == 0


def _fwd_nocode_plain(xb, db, bias, scale):
    cb, ll1 = _encode_plain(xb, db, bias)
    dxh, lrec = _decode_plain(xb, db, cb, scale)
    return dxh, lrec, ll1


def tied_sae_fwd_nocode(xb, db, bias, scale: float):
    """K1n: K1 without the code store. xb [B, D] bf16, db [M, N, D] bf16,
    bias [M, N] f32 → (dxh [M, B, D] bf16, Σerr² [M] f32, Σc [M] f32). dxh is
    bit-equal to K1's; the loss sums group their partials per block and may
    differ from K1's in the last bits."""
    if not xb.is_cuda:
        return _fwd_nocode_plain(xb, db, bias, scale)
    name = "tied_sae_fwd_nocode"
    dev = check_cuda(name, xb=xb, db=db, bias=bias)
    M, N, D = db.shape
    B = xb.shape[0]
    check_dtype(name, xb, "xb", bf16)
    check_dtype(name, db, "db", bf16)
    check_dtype(name, bias, "bias", fp32)
    require(xb.shape == (B, D) and bias.shape == (M, N), f"{name}: shape mismatch")
    require(nocode_shapes_supported(N, D, B), f"{name}: shape (B={B}, N={N}, D={D}) not supported")
    dxh = torch.empty((M, B, D), dtype=bf16, device=dev)
    parts = torch.empty((2, M, B // nocode_tile(D)[0]), dtype=fp32, device=dev)
    lib = _build.load()["tied_sae_fwd"]
    rc = lib.sc_tied_sae_fwd_nocode(
        xb.data_ptr(), db.data_ptr(), bias.data_ptr(), dxh.data_ptr(), parts[0].data_ptr(),
        parts[1].data_ptr(), M, B, N, D, float(scale), stream(dev),
    )
    _build.check(rc, name)
    LAUNCHES.count(name, dev)
    # per-block partials summed here: no float atomics, same bits every run
    return dxh, parts[0].sum(dim=1), parts[1].sum(dim=1)


# -- K2 / K3 --------------------------------------------------------------------

def _grads_plain(xb, dxh, c, nrm, db, l1_over_b, bias=None):
    """Shared body of the bwd plain versions: (g [M, N, D], g_bias [M, N]).
    ``c=None`` rebuilds the code from x, db and ``bias`` (`_code_tile`)."""
    if c is None:
        c = _encode_plain(xb, db, bias)[0]
    xf, dxf, cf, djf = xb.float(), dxh.float(), c.float(), db.float()
    dc = torch.matmul(dxf, djf.transpose(1, 2))
    dc = torch.where(cf > 0, dc + l1_over_b[:, None, None], torch.zeros_like(dc))
    g_bias = dc.sum(dim=1)
    dcf = dc.to(bf16).float()
    g_dhat = torch.matmul(cf.transpose(1, 2), dxf) + torch.matmul(dcf.transpose(1, 2), xf)
    radial = torch.sum(g_dhat * djf, dim=-1, keepdim=True)
    return (g_dhat - djf * radial) / nrm[..., None], g_bias


def tile_bits(shape, seed, salt: int, seed_tile: int, device=None) -> torch.Tensor:
    """The stochastic stores' bits for an [M, N, D] moment (int64 u32 values):
    per (member m, JAX dictionary tile j = n div ``seed_tile``) the tile seed
    ``mix32(seed ^ m·0x9E3779B9 ^ j·0x7FEB352D ^ salt)``, then
    ``mix32((r·D + col) ^ tile_seed)`` at row r = n mod ``seed_tile`` — the
    JAX package's `_uniform_bits(..., hw_prng=False)` over each of its
    kernel's tiles. ``seed`` is the step count (int or integer tensor)."""
    M, N, D = shape
    seed = as_u32(seed, device).reshape(())
    dev = seed.device
    m = torch.arange(M, dtype=torch.int64, device=dev)[:, None]
    n = torch.arange(N, dtype=torch.int64, device=dev)[None, :]
    base = seed ^ mul32(m, 0x9E3779B9) ^ mul32(n // seed_tile, 0x7FEB352D)
    local = (n % seed_tile)[..., None] * D + torch.arange(D, dtype=torch.int64, device=dev)
    return mix32(local ^ mix32(base ^ salt)[..., None])


def _adam_plain(g, d_raw, mu, nu, bc, lr, b1, b2, eps, seed=0, seed_tile=TIED_SEED_TILE):
    """The `_adam_epilogue` expressions, term for term, in every moment tier:
    int8 moments dequantized, the EMA in f32 (a bf16 mu's decay product in
    bf16), the update from the unrounded moments, then the stores (int8 and
    bf16-nu stochastic, on `tile_bits`; bf16 mu round to nearest)."""
    omb1, omb2 = f32(1 - b1, g), f32(1 - b2, g)
    if isinstance(mu, QuantMoment):
        mu_new = f32(b1, g) * mu.dequant() + omb1 * g
    else:
        mu_new = decayed_moment(b1, mu).float() + omb1 * g
    nu_new = f32(b2, g) * dequant(nu) + omb2 * g * g
    mhat = mu_new / bc[:, 0, None, None]
    vhat = nu_new / bc[:, 1, None, None]
    d_new = d_raw - f32(lr, g) * mhat / (torch.sqrt(vhat) + f32(eps, g))

    def bits(salt):
        return tile_bits(g.shape, seed, salt, seed_tile, g.device)

    if isinstance(mu, QuantMoment):
        mu_out = quantize_rows_stochastic(mu_new, bits(SALT_MU_INT8))
    else:
        mu_out = mu_new.to(mu.dtype)
    if isinstance(nu, QuantMoment):
        nu_out = quantize_rows_stochastic(nu_new, bits(SALT_NU_INT8))
    elif nu.dtype == bf16:
        nu_out = stochastic_round(nu_new, bits(SALT_NU_BF16))
    else:
        nu_out = nu_new
    return d_new, mu_out, nu_out


def _tier(mom) -> int:
    """The C interface's moment tier: 0 f32, 1 bf16, 2 int8."""
    if isinstance(mom, QuantMoment):
        return 2
    return 1 if mom.dtype == bf16 else 0


def tied_sae_bwd_adam(xb, dxh, c, nrm, d_raw, mu, nu, l1_over_b, bc, lr, b1, b2, eps,
                      seed=0, seed_tile: int = TIED_SEED_TILE, bias=None, sparse: bool = False):
    """K2. xb [B, D] bf16, dxh [M, B, D] bf16, c [M, B, N] bf16 (or None: the
    code is rebuilt from x, D̂ and ``bias`` [M, N] f32), nrm [M, N] f32, d_raw
    [M, N, D] f32 raw encoder with its Adam moments mu and nu (each f32,
    bf16, or an int8 `QuantMoment` with q [M, N, D] and scale [M, N]),
    l1_over_b [M] f32, bc [M, 2] f32 bias corrections of this step, ``seed``
    the step count (int or int32 tensor) seeding the stochastic stores over
    JAX dictionary tiles of ``seed_tile`` rows → (d_new, mu_new, nu_new,
    g_bias [M, N]). ``sparse=True`` takes the sparse route (a stored code
    only), which touches just the code's non-zeros: the TopK path's.

    On CUDA the kernel writes d_new and the moments INTO d_raw, mu and nu
    (q and scale of a `QuantMoment` included; the TPU kernel aliases them the
    same way) and returns those objects."""
    require(not (sparse and c is None), "tied_sae_bwd_adam: the sparse route needs the stored code c")
    if not xb.is_cuda:
        dj = (d_raw / nrm[..., None]).to(bf16)
        g, g_bias = _grads_plain(xb, dxh, c, nrm, dj, l1_over_b, bias)
        return (*_adam_plain(g, d_raw, mu, nu, bc, lr, b1, b2, eps, seed, seed_tile), g_bias)
    name = "tied_sae_bwd_adam_sparse" if sparse else "tied_sae_bwd_adam"
    recompute = c is None
    require(not recompute or bias is not None, f"{name}: c=None needs the bias to rebuild the code")
    code = bias if recompute else c
    moments = {}
    for key, mom in (("mu", mu), ("nu", nu)):
        if isinstance(mom, QuantMoment):
            moments[f"{key}_q"], moments[f"{key}_scale"] = mom.q, mom.scale
        else:
            moments[key] = mom
    dev = check_cuda(name, xb=xb, dxh=dxh, code=code, nrm=nrm, d_raw=d_raw, l1_over_b=l1_over_b,
                      bc=bc, **moments)
    M, N, D = d_raw.shape
    B = xb.shape[0]
    for key, t, dt in (("xb", xb, bf16), ("dxh", dxh, bf16), ("code", code, bf16 if c is not None else fp32),
                       ("nrm", nrm, fp32), ("d_raw", d_raw, fp32), ("l1_over_b", l1_over_b, fp32),
                       ("bc", bc, fp32)):
        check_dtype(name, t, key, dt)
    for key, t in moments.items():
        want = torch.int8 if key.endswith("_q") else fp32 if key.endswith("_scale") else t.dtype
        require(t.dtype == want and t.dtype in (fp32, bf16, torch.int8), f"{name}: {key} has dtype {t.dtype}")
        require(t.shape == ((M, N) if key.endswith("_scale") else (M, N, D)), f"{name}: {key} shape mismatch")
    require(
        xb.shape == (B, D) and dxh.shape == (M, B, D)
        and code.shape == ((M, N) if recompute else (M, B, N))
        and nrm.shape == (M, N) and l1_over_b.shape == (M,) and bc.shape == (M, 2),
        f"{name}: shape mismatch",
    )
    require(shapes_supported(N, D, B), f"{name}: shape (B={B}, N={N}, D={D}) not supported")
    # a host int would be copied once and frozen into a captured graph
    require(isinstance(seed, torch.Tensor) or not torch.cuda.is_current_stream_capturing(),
            f"{name}: under CUDA graph capture the seed must be a tensor on the device")
    g_bias = torch.empty((M, N), dtype=fp32, device=dev)
    seed_t = torch.as_tensor(seed, dtype=torch.int32, device=dev).reshape(1)

    def ptrs(mom):
        if isinstance(mom, QuantMoment):
            return mom.q.data_ptr(), mom.scale.data_ptr()
        return mom.data_ptr(), None

    (mu_p, mus_p), (nu_p, nus_p) = ptrs(mu), ptrs(nu)
    if sparse:
        entry = _build.load()["tied_sae_bwd_sparse"].sc_tied_sae_bwd_adam_sparse
    else:
        entry = _build.load()["tied_sae_bwd_rc" if recompute else "tied_sae_bwd"].sc_tied_sae_bwd_adam_tiers
    rc = entry(
        xb.data_ptr(), dxh.data_ptr(), code.data_ptr(), nrm.data_ptr(), d_raw.data_ptr(),
        mu_p, mus_p, _tier(mu), nu_p, nus_p, _tier(nu), g_bias.data_ptr(), l1_over_b.data_ptr(),
        bc.data_ptr(), seed_t.data_ptr(), int(seed_tile), float(lr), float(b1), float(b2),
        float(eps), float(1 - b1), float(1 - b2), M, B, N, D, stream(dev),
    )
    _build.check(rc, name)
    LAUNCHES.count(name, dev)
    return d_raw, mu, nu, g_bias


def tied_sae_bwd_grads(xb, dxh, c, nrm, db, l1_over_b, sparse: bool = False):
    """K3. As K2 with the normalized rows db [M, N, D] bf16 given and no
    Adam → (g_enc [M, N, D] f32 w.r.t. the RAW encoder, g_bias [M, N] f32).
    ``sparse=True``: the sparse route, as K2's."""
    require(c is not None, "tied_sae_bwd_grads: needs the stored code c")
    if not xb.is_cuda:
        return _grads_plain(xb, dxh, c, nrm, db, l1_over_b)
    name = "tied_sae_bwd_grads_sparse" if sparse else "tied_sae_bwd_grads"
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
    if sparse:
        entry = _build.load()["tied_sae_bwd_sparse"].sc_tied_sae_bwd_grads_sparse
    else:
        entry = _build.load()["tied_sae_bwd"].sc_tied_sae_bwd_grads
    rc = entry(
        xb.data_ptr(), dxh.data_ptr(), c.data_ptr(), nrm.data_ptr(), db.data_ptr(),
        g_enc.data_ptr(), g_bias.data_ptr(), l1_over_b.data_ptr(), M, B, N, D, stream(dev),
    )
    _build.check(rc, name)
    LAUNCHES.count(name, dev)
    return g_enc, g_bias


# -- the JAX package's entry points -----------------------------------------------

def normalized_rows_bf16(d_raw, nrm):
    """bf16(d_raw / nrm) in one division that stores straight into the bf16
    result: on the card no f32 quotient [M, N, D] exists (the bits are those
    of the f32 quotient rounded to nearest)."""
    db = torch.empty(d_raw.shape, dtype=bf16, device=d_raw.device)
    return torch.div(d_raw, nrm[..., None], out=db)


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


def tied_sae_adam_step_stacked(d_raw, bias, mu_d, nu_d, batch, l1_alpha, bc, seed, lr, b1, b2, eps,
                               recompute_code: bool = False):
    """Fused fwd + bwd + encoder-Adam for the stacked tied-SAE ensemble (K1 +
    K2, or K1n + K2 rebuilding the code with ``recompute_code``). d_raw
    [M, N, D] f32 raw encoder, bias [M, N], mu_d and nu_d its Adam moments
    (f32, bf16 or int8 `QuantMoment`), batch [B, D] shared by the members,
    l1_alpha [M], bc [M, 2] the bias corrections (1-b1^t, 1-b2^t) of this
    step, ``seed`` the step count t seeding the stochastic stores. With
    ``recompute_code`` the [M, B, N] code tensor never exists; the result is
    bit-identical (up to the loss sums' last bits). Returns (d_new, mu_new,
    nu_new, g_bias, l_rec, l_l1_raw); on CUDA d_raw/mu_d/nu_d are updated in
    place. The bias' own Adam update is the caller's."""
    B = batch.shape[0]
    nrm, xb, b, scale = _prepare(d_raw, bias, batch)
    db = normalized_rows_bf16(d_raw, nrm)
    if recompute_code:
        c = None
        dxh, lrec, ll1 = tied_sae_fwd_nocode(xb, db, b, scale)
    else:
        c, dxh, lrec, ll1 = tied_sae_fwd(xb, db, b, scale)
    l1_over_b = l1_alpha.to(fp32).reshape(-1) / B
    d_new, mu_new, nu_new, g_bias = tied_sae_bwd_adam(
        xb, dxh, c, nrm, d_raw, mu_d, nu_d, l1_over_b, bc.to(fp32).contiguous(), lr, b1, b2, eps,
        seed=seed, seed_tile=TIED_SEED_TILE, bias=b,
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
