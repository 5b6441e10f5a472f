"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card, at a small shape and at the main path's full shape. Needs an NVIDIA
GPU with nvcc; skips (inside each test) without one. On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

Tolerances as in chip_smoke.py: c within 1 bf16 ulp (or f32 noise across
zero) with < 0.1% differing, dxh the same with < 1% (4096-term sums in
another order), gradients cosine > 0.9999 and max error 1e-2 of the max.
The Adam kernel is held at its first step from zero moments, where
mu_new = (1 - b1)·g holds its gradient to that bound member by member, and
at step 10 from moments at the gradient's scale; its updated encoder lies
within 2 ulp of the update recomputed from its own new moments (plus 2^-8
of the update with bf16 mu) and within 2 lr of the plain one. TopK: scores
as c; the select's threshold and the decode's code bit-equal to the plain
versions' on the kernel's own scores (the same bf16 bits in, an exact
selection).
K2/K3's sparse route (the TopK path's: only the code's non-zeros touched)
is held to the dense route's tolerances against the same plain versions,
on TopK codes, a k = 1 member, an all-zero code, a hot feature (non-zero
on every batch row) and a fully dense code, and gives the same bits on two
launches of the same inputs.
K_f (the FISTA solve) against its plain loop on the same η: codes within
atol 1e-4 (the JAX suite's pin for `_fista_kernel` in interpret mode; each
product sums in another order, which the iterations carry), support flips
under 1e-3, ‖res‖² within 1e-5 relative, and with tol > 0 the same
iteration count for each member; at widths that are not multiples of 4 too.
"""

import pytest
import torch

from _torch_moments import adam_moments, clone_moment, same_bits, store_error_steps, stored_agreement
from _torch_parity import assert_grads_close, bf16_close
from sparse_coding__tpu_torch.models import fista as tf
from sparse_coding__tpu_torch.ops import fista_kernel as fk
from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
from sparse_coding__tpu_torch.ops import topk_kernel as kk

pytestmark = pytest.mark.cuda

# M, B, N, D: every width the kernels take (D 768 single-buffers x, D 1024
# runs 16-row batch stages), then the two main paths' full shapes (tied SAE,
# TopK config 4)
SHAPES = [(2, 256, 512, 128), (2, 128, 256, 256), (2, 256, 512, 768), (2, 256, 256, 1024),
          (8, 2048, 4096, 512), (7, 2048, 12288, 768)]
# M, B, N, D and k per member: the CPU tests' shape, then BASELINE config 4
TOPK_SHAPES = [((2, 256, 512, 128), (7, 31)), ((7, 2048, 12288, 768), (1, 11, 31, 61, 91, 121, 151))]
LR = 1e-3
HP = (LR, 0.9, 0.999, 1e-8)  # Adam: lr, b1, b2, eps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests run the hand-written kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dev, seed=0):
    M, B, N, D = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    d_raw = torch.randn((M, N, D), generator=g, device=dev) * 0.05
    bias = torch.randn((M, N), generator=g, device=dev) * 0.01
    xb = torch.randn((B, D), generator=g, device=dev).to(torch.bfloat16)
    nrm = torch.sqrt(torch.sum(d_raw * d_raw, dim=-1))
    db = (d_raw / nrm[..., None]).to(torch.bfloat16)
    l1b = torch.linspace(1e-4, 1e-2, M, device=dev) / B
    return d_raw, bias, xb, nrm, db, l1b


@pytest.mark.parametrize("shape", SHAPES)
def test_fwd_kernel_matches_plain(cuda, shape):
    M, B, N, D = shape
    d_raw, bias, xb, nrm, db, _ = _inputs(shape, cuda)
    tk.reset_launches()
    c, dxh, lrec, ll1 = tk.tied_sae_fwd(xb, db, bias, 2.0 / (B * D))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["tied_sae_fwd"] == 1
    c_p, ll1_p = tk._encode_plain(xb, db, bias)
    dxh_p, lrec_p = tk._decode_plain(xb, db, c, 2.0 / (B * D))
    frac, ok = bf16_close(c, c_p)
    assert ok and frac < 1e-3, (frac, ok)
    frac, ok = bf16_close(dxh, dxh_p)
    assert ok and frac < 1e-2, (frac, ok)
    torch.testing.assert_close(lrec, lrec_p, rtol=1e-3, atol=0)
    torch.testing.assert_close(ll1, ll1_p, rtol=1e-3, atol=0)


def _ulp(t):
    a = t.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def _hold_adam_step(step, d_raw, g_p, mu_dtype, seed):
    """K2, as ``step(d, mu, nu, bc)`` (which updates d, mu and nu in place),
    against the plain Adam on the plain gradient ``g_p``, at two steps:
    step 1 from zero moments, where mu_new = (1 - b1)·g exactly, so the
    moments hold the kernel's gradient member by member; and step 10 from
    moments drawn at each member's gradient scale. d_new is held within
    2 ulp of the update recomputed from the kernel's own new moments (plus
    2^-8 of it with bf16 mu, stored after the step) and within 2 lr of the
    plain d_new. Returns the last step's outputs."""
    M, dev = d_raw.shape[0], d_raw.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    g_rms = g_p.pow(2).mean(dim=(1, 2), keepdim=True).sqrt()
    zeros = torch.zeros_like(d_raw)
    mu10 = (torch.randn(d_raw.shape, generator=gen, device=dev) * g_rms).to(mu_dtype)
    nu10 = torch.rand(d_raw.shape, generator=gen, device=dev) * g_rms * g_rms
    for t, mu, nu in ((1, zeros.to(mu_dtype), zeros), (10, mu10, nu10)):
        bc = torch.tensor([[1 - HP[1] ** t, 1 - HP[2] ** t]] * M, device=dev)
        d_k, mu_k, nu_k = d_raw.clone(), mu.clone(), nu.clone()
        out = step(d_k, mu_k, nu_k, bc)
        torch.cuda.synchronize()
        assert out[0] is d_k and out[1] is mu_k and out[2] is nu_k  # updated in place
        d_p, mu_p, nu_p = tk._adam_plain(g_p, d_raw, mu, nu, bc, *HP)
        for m in range(M):
            assert_grads_close(mu_k[m].float(), mu_p[m].float(), f"step {t} mu[{m}]")
            assert_grads_close(nu_k[m], nu_p[m], f"step {t} nu[{m}]")
        upd = LR * (mu_k.float() / bc[:, 0, None, None]) / (torch.sqrt(nu_k / bc[:, 1, None, None]) + HP[3])
        d_own = d_raw - upd
        slack = 2 * _ulp(d_own) + 2 * _ulp(upd)
        if mu_dtype == torch.bfloat16:
            slack = slack + upd.abs() * 2.0 ** -8
        assert bool(((d_k - d_own).abs() <= slack).all()), f"step {t}: d_new off its own moments' update"
        assert (d_k - d_p).abs().max() <= 2 * LR
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
def test_bwd_adam_kernel_matches_plain(cuda, shape, mu_dtype):
    M, B, N, D = shape
    d_raw, bias, xb, nrm, db, l1b = _inputs(shape, cuda, seed=1)
    c, dxh, _, _ = tk._fwd_plain(xb, db, bias, 2.0 / (B * D))
    dj = (d_raw / nrm[..., None]).to(torch.bfloat16)
    gr, gb_p = tk._grads_plain(xb, dxh, c, nrm, dj, l1b)
    out = _hold_adam_step(
        lambda d, mu, nu, bc: tk.tied_sae_bwd_adam(xb, dxh, c, nrm, d, mu, nu, l1b, bc, *HP),
        d_raw, gr, mu_dtype, seed=2,
    )
    assert_grads_close(out[3], gb_p, "g_bias")


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_grads_kernel_matches_plain(cuda, shape):
    M, B, N, D = shape
    d_raw, bias, xb, nrm, db, l1b = _inputs(shape, cuda, seed=3)
    c, dxh, _, _ = tk._fwd_plain(xb, db, bias, 2.0 / (B * D))
    g_k, gb_k = tk.tied_sae_bwd_grads(xb, dxh, c, nrm, db, l1b)
    g_p, gb_p = tk._grads_plain(xb, dxh, c, nrm, db, l1b)
    assert_grads_close(g_k, g_p, "g_enc")
    assert_grads_close(gb_k, gb_p, "g_bias")


def test_kernels_refuse_what_they_do_not_take(cuda):
    d_raw, bias, xb, nrm, db, l1b = _inputs(SHAPES[0], cuda)
    with pytest.raises(ValueError, match="must be torch.bfloat16"):
        tk.tied_sae_fwd(xb.float(), db, bias, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        tk.tied_sae_fwd(xb, db.transpose(1, 2), bias, 1.0)
    with pytest.raises(ValueError, match="is on cpu"):
        tk.tied_sae_fwd(xb, db, bias.cpu(), 1.0)


def _topk_inputs(shape, ks, dev, seed=0):
    M, B, N, D = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    d_raw = torch.randn((M, N, D), generator=g, device=dev)
    xb = torch.randn((B, D), generator=g, device=dev).to(torch.bfloat16)
    nrm = torch.sqrt(torch.sum(d_raw * d_raw, dim=-1))
    db = (d_raw / nrm[..., None]).to(torch.bfloat16)
    return d_raw, xb, nrm, db, torch.tensor(ks, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("shape,ks", TOPK_SHAPES)
def test_topk_scores_and_decode_kernels_match_plain(cuda, shape, ks):
    M, B, N, D = shape
    d_raw, xb, nrm, db, k = _topk_inputs(shape, ks, cuda)
    kk.reset_launches()
    s, thresh = kk.topk_scores(xb, db, k)
    c, dxh, lrec = kk.topk_decode(s, thresh, db, xb, 2.0 / (B * D))
    torch.cuda.synchronize()
    assert kk.LAUNCHES == {"topk_scores": 1, "topk_decode": 1}
    s_p, _ = kk._topk_scores_plain(xb, db, k)
    frac, ok = bf16_close(s, s_p)
    assert ok and frac < 1e-3, (frac, ok)
    # on the kernel's own scores: the same threshold and code, bit for bit
    assert torch.equal(thresh.view(torch.int32), kk._select_plain(s, k).view(torch.int32))
    c_p, dxh_p, lrec_p = kk._topk_decode_plain(s, thresh, db, xb, 2.0 / (B * D))
    assert torch.equal(c.view(torch.int16), c_p.view(torch.int16))
    frac, ok = bf16_close(dxh, dxh_p)
    assert ok and frac < 1e-2, (frac, ok)
    torch.testing.assert_close(lrec, lrec_p, rtol=1e-3, atol=0)
    kept = (c != 0).sum(-1)
    assert bool((kept >= torch.minimum(k[:, None], (s.float() > 0).sum(-1))).all())


@pytest.mark.parametrize("shape,ks", TOPK_SHAPES)
def test_topk_entries_match_their_plain_composition(cuda, shape, ks):
    """K_s + K_d + K3 (grads) and K_s + K_d + K2 (Adam) against the plain
    versions chained on the kernels' own forward."""
    M, B, N, D = shape
    d_raw, xb, nrm, db, k = _topk_inputs(shape, ks, cuda, seed=1)
    x = xb.float()
    g, l_rec = kk.topk_grads_stacked(d_raw, k, x)
    s, thresh = kk.topk_scores(xb, db, k)
    c, dxh, lrec = kk.topk_decode(s, thresh, db, xb, 2.0 / (B * D))
    zeros = torch.zeros(M, device=cuda)
    g_p, _ = tk._grads_plain(xb, dxh, c, nrm, db, zeros)
    assert_grads_close(g, g_p, "g_dict")
    torch.testing.assert_close(l_rec, lrec / (B * D), rtol=1e-6, atol=0)
    _hold_adam_step(lambda d, mu, nu, bc: kk.topk_adam_step_stacked(d, mu, nu, x, k, bc, 1, *HP),
                    d_raw, g_p, torch.float32, seed=2)


def test_topk_kernels_refuse_what_they_do_not_take(cuda):
    d_raw, xb, nrm, db, k = _topk_inputs(TOPK_SHAPES[0][0], TOPK_SHAPES[0][1], cuda)
    with pytest.raises(ValueError, match="not supported"):
        kk.topk_scores(xb, db[:, :448].contiguous(), k)  # N not a multiple of 128
    with pytest.raises(ValueError, match="must be torch.int32"):
        kk.topk_scores(xb, db, k.long())
    with pytest.raises(ValueError, match="not covered"):
        kk.topk_grads_stacked(d_raw, k, xb[:200].float())


# -- K2/K3's sparse route (the TopK path's backward) ---------------------------

# M, B, N, D, code: TopK codes (k per member, k = 1 among them; the second at
# BASELINE config 4), an all-zero code, a hot feature (non-zero on every row,
# lists split over warps), a fully dense code (every entry non-zero: correct,
# only slow), then every width at 5% density; B 320 and 576 end in a ragged
# chunk of the kernel's 1024-row batch walk, B 2048 takes two chunks
SPARSE_CASES = [
    ((2, 256, 512, 128), (1, 31)),
    ((7, 2048, 12288, 768), (1, 11, 31, 61, 91, 121, 151)),
    ((2, 256, 512, 768), "zero"),
    ((2, 2048, 256, 768), "hot"),
    ((2, 576, 256, 128), "dense"),
] + [((2, 320, 256, D), "5%") for D in (128, 256, 512, 768, 1024)]
SPARSE_TIERS = [("float32", "float32"), ("bfloat16", "float32"), ("int8", "bfloat16")]


def _sparse_inputs(shape, code, dev, seed=20):
    """(xb, dxh, c, nrm, d_raw, db): a TopK code from K_s + K_d when ``code``
    holds each member's k, else a bf16 code of the named pattern, beside a
    random dxh at the scale of K_d's."""
    M, B, N, D = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    d_raw = torch.randn((M, N, D), generator=g, device=dev)
    xb = torch.randn((B, D), generator=g, device=dev).to(torch.bfloat16)
    nrm = torch.sqrt(torch.sum(d_raw * d_raw, dim=-1))
    db = (d_raw / nrm[..., None]).to(torch.bfloat16)
    if isinstance(code, tuple):
        s, th = kk.topk_scores(xb, db, torch.tensor(code, dtype=torch.int32, device=dev))
        c, dxh, _ = kk.topk_decode(s, th, db, xb, 2.0 / (B * D))
        return xb, dxh, c, nrm, d_raw, db
    vals = torch.rand((M, B, N), generator=g, device=dev) + 0.05
    if code == "zero":
        keep = torch.zeros((M, B, N), dtype=torch.bool, device=dev)
    elif code == "dense":
        keep = torch.ones((M, B, N), dtype=torch.bool, device=dev)
    else:
        keep = torch.rand((M, B, N), generator=g, device=dev) < (0.05 if code == "5%" else 0.01)
        if code == "hot":
            keep[:, :, 37] = True  # one feature on every row of every member
    c = torch.where(keep, vals, torch.zeros_like(vals)).to(torch.bfloat16)
    dxh = (torch.randn((M, B, D), generator=g, device=dev) * 2.0 / (B * D)).to(torch.bfloat16)
    return xb, dxh, c, nrm, d_raw, db


@pytest.mark.parametrize("shape,code", SPARSE_CASES)
def test_sparse_bwd_grads_matches_plain(cuda, shape, code):
    xb, dxh, c, nrm, d_raw, db = _sparse_inputs(shape, code, cuda)
    l1b = torch.zeros(shape[0], device=cuda)
    tk.reset_launches()
    g_k, gb_k = tk.tied_sae_bwd_grads(xb, dxh, c, nrm, db, l1b, sparse=True)
    g_p, gb_p = tk._grads_plain(xb, dxh, c, nrm, db, l1b)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["tied_sae_bwd_grads_sparse"] == 1 and tk.LAUNCHES["tied_sae_bwd_grads"] == 0
    if code == "zero":
        assert not g_k.any() and not gb_k.any()
        return
    assert_grads_close(g_k, g_p, "g_enc")
    assert_grads_close(gb_k, gb_p, "g_bias")


@pytest.mark.parametrize("shape,code", SPARSE_CASES)
@pytest.mark.parametrize("tiers", SPARSE_TIERS)
def test_sparse_bwd_adam_matches_plain(cuda, shape, code, tiers):
    """K2's sparse route: for f32 and bf16 mu, `_hold_adam_step` against the
    plain gradient (the dense route's tolerances); in every tier, its
    epilogue against `_adam_plain` on the sparse K3's gradient (the same
    mainloop, so the same g), as the dense route's compressed epilogue."""
    M, B, N, D = shape
    xb, dxh, c, nrm, d_raw, db = _sparse_inputs(shape, code, cuda, seed=21)
    l1b = torch.zeros(M, device=cuda)
    seed_tile = kk.SEED_TILE
    if code != "zero" and tiers[0] != "int8":
        g_p, _ = tk._grads_plain(xb, dxh, c, nrm, db, l1b)
        _hold_adam_step(
            lambda d, mu, nu, bc: tk.tied_sae_bwd_adam(xb, dxh, c, nrm, d, mu, nu, l1b, bc, *HP, sparse=True),
            d_raw, g_p, getattr(torch, tiers[0]), seed=22,
        )
    g, gb = tk.tied_sae_bwd_grads(xb, dxh, c, nrm, db, l1b, sparse=True)
    mu, nu = _moments(d_raw, *tiers, seed=23)
    bc = torch.tensor([[0.1, 0.001]] * M, device=cuda)
    tk.reset_launches()
    d_k, mu_k, nu_k, gb_k = tk.tied_sae_bwd_adam(xb, dxh, c, nrm, d_raw.clone(), clone_moment(mu),
                                                 clone_moment(nu), l1b, bc, *HP, seed=5, seed_tile=seed_tile,
                                                 sparse=True)
    d_p, mu_p, nu_p = tk._adam_plain(g, d_raw, mu, nu, bc, *HP, seed=5, seed_tile=seed_tile)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["tied_sae_bwd_adam_sparse"] == 1 and tk.LAUNCHES["tied_sae_bwd_adam"] == 0
    assert torch.equal(gb_k, gb)
    assert (d_k - d_p).abs().max() <= 1e-6
    for name, got, want in (("mu", mu_k, mu_p), ("nu", nu_k, nu_p)):
        eq, worst, rel = stored_agreement(got, want)
        stochastic = hasattr(want, "q") or (name == "nu" and want.dtype == torch.bfloat16)
        if stochastic:
            assert eq >= 0.999 and worst <= 1 and rel <= 1e-6, (name, eq, worst, rel)


@pytest.mark.parametrize("shape,code", [SPARSE_CASES[1], SPARSE_CASES[3]])
def test_sparse_route_gives_the_same_bits_twice(cuda, shape, code):
    """No float atomics: two launches on the same inputs, bit for bit (K3's
    gradient, and K2's d_new, int8 mu and bf16 nu)."""
    M = shape[0]
    xb, dxh, c, nrm, d_raw, db = _sparse_inputs(shape, code, cuda, seed=24)
    l1b = torch.full((M,), 1e-4, device=cuda)
    g1 = tk.tied_sae_bwd_grads(xb, dxh, c, nrm, db, l1b, sparse=True)
    g2 = tk.tied_sae_bwd_grads(xb, dxh, c, nrm, db, l1b, sparse=True)
    mu, nu = _moments(d_raw, "int8", "bfloat16", seed=25)
    bc = torch.tensor([[0.1, 0.001]] * M, device=cuda)
    outs = [tk.tied_sae_bwd_adam(xb, dxh, c, nrm, d_raw.clone(), clone_moment(mu), clone_moment(nu), l1b, bc,
                                 *HP, seed=3, sparse=True) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert all(same_bits(a, b) for a, b in zip(*outs))


def test_sparse_route_refuses_what_it_cannot_take(cuda):
    xb, dxh, c, nrm, d_raw, db = _sparse_inputs((2, 256, 512, 128), (1, 31), cuda)
    l1b = torch.zeros(2, device=cuda)
    mu, nu = torch.zeros_like(d_raw), torch.zeros_like(d_raw)
    bc = torch.tensor([[0.1, 0.001]] * 2, device=cuda)
    with pytest.raises(ValueError, match="sparse route needs the stored code"):
        tk.tied_sae_bwd_adam(xb, dxh, None, nrm, d_raw, mu, nu, l1b, bc, *HP, bias=torch.zeros_like(nrm), sparse=True)
    with pytest.raises(ValueError, match="not supported"):  # a width outside the kernels' tiling
        tk.tied_sae_bwd_grads(xb[:, :64].contiguous(), dxh[..., :64].contiguous(), c, nrm,
                              db[..., :64].contiguous(), l1b, sparse=True)
    with pytest.raises(ValueError, match="must be torch.bfloat16"):
        tk.tied_sae_bwd_grads(xb, dxh, c.float(), nrm, db, l1b, sparse=True)


# -- the capacity setting: K1n, K2's code rebuild and compressed moments ------

# (mu, nu) storage tiers K2 takes beyond the first slices' (mu f32/bf16, nu f32)
TIERS = [("float32", "bfloat16"), ("bfloat16", "bfloat16"), ("int8", "bfloat16"), ("int8", "int8"),
         ("float32", "int8"), ("int8", "float32")]


def _moments(d_raw, mu_t, nu_t, seed):
    return adam_moments(d_raw, mu_t, nu_t, torch.Generator(device=d_raw.device).manual_seed(seed))


@pytest.mark.parametrize("shape", SHAPES)
def test_fwd_nocode_kernel_is_k1_bit_for_bit(cuda, shape):
    M, B, N, D = shape
    d_raw, bias, xb, nrm, db, _ = _inputs(shape, cuda, seed=4)
    tk.reset_launches()
    c, dxh, lrec, ll1 = tk.tied_sae_fwd(xb, db, bias, 2.0 / (B * D))
    dxh_n, lrec_n, ll1_n = tk.tied_sae_fwd_nocode(xb, db, bias, 2.0 / (B * D))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["tied_sae_fwd_nocode"] == 1
    assert torch.equal(dxh_n.view(torch.int16), dxh.view(torch.int16))
    # the loss partials group per block differently: last bits only
    torch.testing.assert_close(lrec_n, lrec, rtol=1e-5, atol=0)
    torch.testing.assert_close(ll1_n, ll1, rtol=1e-5, atol=0)


@pytest.mark.parametrize("shape", SHAPES[:4] + SHAPES[4:5])
@pytest.mark.parametrize("tiers", [("bfloat16", "float32")] + TIERS)
def test_bwd_adam_rebuild_is_bit_identical_to_the_stored_code(cuda, shape, tiers):
    """K2 rebuilding the code from x, D̂ and the bias == K2 on K1's stored
    code: d_new, the moments (codes and scales) and g_bias, bit for bit."""
    M, B, N, D = shape
    d_raw, bias, xb, nrm, db, l1b = _inputs(shape, cuda, seed=5)
    c, dxh, _, _ = tk.tied_sae_fwd(xb, db, bias, 2.0 / (B * D))
    mu, nu = _moments(d_raw, *tiers, seed=6)
    bc = torch.tensor([[0.1, 0.001]] * M, device=cuda)
    outs = []
    for code, b in ((c, None), (None, bias)):
        outs.append(tk.tied_sae_bwd_adam(xb, dxh, code, nrm, d_raw.clone(), clone_moment(mu), clone_moment(nu),
                                         l1b, bc, *HP, seed=7, bias=b))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert same_bits(a, b)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tiers", TIERS)
def test_bwd_adam_compressed_epilogue_matches_plain(cuda, shape, tiers):
    """K2's epilogue against `_adam_plain` on the same gradient (K3's, which
    runs K2's gradient code on the same bf16 rows): the stochastic stores
    draw the same counter-hash bits, so int8 codes and bf16 nu agree in
    >= 99.9% of elements, never more than one code or ulp apart, scales
    within 1e-6."""
    M, B, N, D = shape
    d_raw, bias, xb, nrm, db, l1b = _inputs(shape, cuda, seed=8)
    c, dxh, _, _ = tk.tied_sae_fwd(xb, db, bias, 2.0 / (B * D))
    g, gb = tk.tied_sae_bwd_grads(xb, dxh, c, nrm, db, l1b)
    mu, nu = _moments(d_raw, *tiers, seed=9)
    bc = torch.tensor([[0.1, 0.001]] * M, device=cuda)
    seed_tile = 128 if D == 768 else tk.TIED_SEED_TILE
    d_k, mu_k, nu_k, gb_k = tk.tied_sae_bwd_adam(xb, dxh, c, nrm, d_raw.clone(), clone_moment(mu), clone_moment(nu),
                                                 l1b, bc, *HP, seed=11, seed_tile=seed_tile)
    d_p, mu_p, nu_p = tk._adam_plain(g, d_raw, mu, nu, bc, *HP, seed=11, seed_tile=seed_tile)
    torch.cuda.synchronize()
    assert torch.equal(gb_k, gb)
    assert (d_k - d_p).abs().max() <= 1e-6
    for name, got, want in (("mu", mu_k, mu_p), ("nu", nu_k, nu_p)):
        eq, worst, rel = stored_agreement(got, want)
        stochastic = hasattr(want, "q") or (name == "nu" and want.dtype == torch.bfloat16)
        if stochastic:
            assert eq >= 0.999 and worst <= 1 and rel <= 1e-6, (name, eq, worst, rel)


@pytest.mark.parametrize("tiers", [("int8", "bfloat16"), ("int8", "int8")])
def test_bwd_adam_stochastic_stores_are_unbiased(cuda, tiers):
    """Over 64 step seeds, the stored moments' mean error against the f32
    moment (in units of each element's storage step) stays within 4 sigma
    of 0."""
    shape = SHAPES[0]
    M, B, N, D = shape
    d_raw, bias, xb, nrm, db, l1b = _inputs(shape, cuda, seed=12)
    c, dxh, _, _ = tk.tied_sae_fwd(xb, db, bias, 2.0 / (B * D))
    g, _ = tk.tied_sae_bwd_grads(xb, dxh, c, nrm, db, l1b)
    mu, nu = _moments(d_raw, *tiers, seed=13)
    bc = torch.tensor([[0.1, 0.001]] * M, device=cuda)
    from sparse_coding__tpu_torch.utils.optim import dequant

    omb1, omb2 = torch.tensor(1 - HP[1]), torch.tensor(1 - HP[2])
    mu_f = torch.tensor(HP[1]) * dequant(mu) + omb1.cuda() * g
    nu_f = torch.tensor(HP[2]) * dequant(nu) + omb2.cuda() * g * g
    errs = {"mu": [], "nu": []}
    for seed in range(1, 65):
        _, mu_k, nu_k, _ = tk.tied_sae_bwd_adam(xb, dxh, c, nrm, d_raw.clone(), clone_moment(mu), clone_moment(nu),
                                                l1b, bc, *HP, seed=seed)
        for name, got, f in (("mu", mu_k, mu_f), ("nu", nu_k, nu_f)):
            errs[name].append(store_error_steps(got, f))
    for name, e in errs.items():
        e = torch.stack(e)
        mean, sd = float(e.mean()), float(e.std())
        assert abs(mean) <= 4 * sd / e.numel() ** 0.5, (name, mean, sd)


# -- the dense route's wgmma mainloop (D 128, 256, 512) --------------------------

# M, B, N, D: each width the wgmma mainloop takes at its smallest dictionary
# (one block, or one cluster of two at D 512) and a batch that wraps its
# ring of stages unevenly, then B = 4096 at config 2's widths (the regime
# of the TPU's batch-tiled `_bwd_adam_accum_kernel`)
WG_CASES = [(2, 64, 128, 128), (3, 192, 256, 256), (2, 320, 128, 512), (8, 4096, 4096, 512)]
# K2 variants held to the same bits on two launches: (code rebuilt, mu, nu)
K2_VARIANTS = [(False, "float32", "float32"), (False, "bfloat16", "float32"), (False, "int8", "bfloat16"),
               (True, "bfloat16", "float32"), (True, "int8", "bfloat16"), (True, "float32", "int8")]


@pytest.mark.parametrize("shape", WG_CASES)
def test_dense_wgmma_route_matches_plain(cuda, shape):
    """K3 and K2 (bf16 mu) against the plain versions with the dense route's
    tolerances, and K2 rebuilding the code bit-identical to K2 on K1's."""
    M, B, N, D = shape
    d_raw, bias, xb, nrm, db, l1b = _inputs(shape, cuda, seed=30)
    c, dxh, _, _ = tk.tied_sae_fwd(xb, db, bias, 2.0 / (B * D))
    tk.reset_launches()
    g_k, gb_k = tk.tied_sae_bwd_grads(xb, dxh, c, nrm, db, l1b)
    g_p, gb_p = tk._grads_plain(xb, dxh, c, nrm, db, l1b)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["tied_sae_bwd_grads"] == 1 and tk.LAUNCHES["tied_sae_bwd_grads_sparse"] == 0
    assert_grads_close(g_k, g_p, "g_enc")
    assert_grads_close(gb_k, gb_p, "g_bias")
    dj = (d_raw / nrm[..., None]).to(torch.bfloat16)
    gr, _ = tk._grads_plain(xb, dxh, c, nrm, dj, l1b)
    _hold_adam_step(lambda d, mu, nu, bc: tk.tied_sae_bwd_adam(xb, dxh, c, nrm, d, mu, nu, l1b, bc, *HP),
                    d_raw, gr, torch.bfloat16, seed=31)
    mu, nu = _moments(d_raw, "int8", "bfloat16", seed=32)
    bc = torch.tensor([[0.1, 0.001]] * M, device=cuda)
    outs = [tk.tied_sae_bwd_adam(xb, dxh, code, nrm, d_raw.clone(), clone_moment(mu), clone_moment(nu), l1b, bc,
                                 *HP, seed=33, bias=b) for code, b in ((c, None), (None, bias))]
    torch.cuda.synchronize()
    assert all(same_bits(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("shape", [WG_CASES[2], SHAPES[4]])
@pytest.mark.parametrize("variant", ["grads"] + K2_VARIANTS)
def test_dense_route_gives_the_same_bits_twice(cuda, shape, variant):
    """No float atomics, a fixed order for every sum (the dc depth halves
    included): two launches on the same inputs give the same bits, for K3's
    gradient and for K2's d_new, moments and g_bias, on the stored and the
    rebuilt code."""
    M, B, N, D = shape
    d_raw, bias, xb, nrm, db, l1b = _inputs(shape, cuda, seed=34)
    c, dxh, _, _ = tk.tied_sae_fwd(xb, db, bias, 2.0 / (B * D))
    if variant == "grads":
        outs = [tk.tied_sae_bwd_grads(xb, dxh, c, nrm, db, l1b) for _ in range(2)]
    else:
        rebuild, mu_t, nu_t = variant
        mu, nu = _moments(d_raw, mu_t, nu_t, seed=35)
        bc = torch.tensor([[0.1, 0.001]] * M, device=cuda)
        outs = [tk.tied_sae_bwd_adam(xb, dxh, None if rebuild else c, nrm, d_raw.clone(), clone_moment(mu),
                                     clone_moment(nu), l1b, bc, *HP, seed=36, bias=bias if rebuild else None)
                for _ in range(2)]
    torch.cuda.synchronize()
    assert all(same_bits(a, b) for a, b in zip(*outs))


# K_f: M, B, N, D, iterations — the shape where JAX picks `_fista_kernel`,
# then a ragged batch with edge tiles in N and D and depths not a multiple
# of the kernel's 8-deep stages, then rows that are not whole float4s
FISTA_SHAPES = [(2, 256, 512, 128, 100), (3, 200, 196, 36, 40), (2, 200, 2050, 130, 50)]


def _fista_problem(shape, dev, seed=0):
    """Unit-norm dictionaries, a batch of sparse non-negative mixtures of
    member 0's rows plus noise, a non-negative warm start, l1 per member."""
    M, B, N, D = shape
    g = torch.Generator().manual_seed(seed)  # drawn on the host: the same problem on every device
    d = torch.randn((M, N, D), generator=g)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    mask = torch.rand((B, N), generator=g) < 0.02
    codes = (0.5 + torch.rand((B, N), generator=g)) * mask
    x = codes @ d[0] + 0.01 * torch.randn((B, D), generator=g)
    c0 = torch.relu(torch.randn((M, B, N), generator=g)) * 0.05
    l1 = torch.logspace(-2.7, -2, M)
    return x.to(dev), d.to(dev), c0.to(dev), l1.to(dev)


def _hold_fista(a_k, a_p, x, d):
    diff = float((a_k - a_p).abs().max())
    flips = float(((a_k > 0) != (a_p > 0)).float().mean())
    rk, rp = [float(((x - torch.matmul(a, d)) ** 2).sum()) for a in (a_k, a_p)]
    assert diff <= 1e-4 and flips < 1e-3 and abs(rk - rp) <= 1e-5 * rp, (diff, flips, rk, rp)


@pytest.mark.parametrize("shape", FISTA_SHAPES)
@pytest.mark.parametrize("warm", [False, True])
def test_fista_kernel_matches_plain(cuda, shape, warm):
    M, B, N, D, iters = shape
    x, d, c0, l1 = _fista_problem(shape[:4], cuda)
    eta = tf.default_eta(d)
    fk.reset_launches()
    a_k, it_k = fk.fista_cuda(x, d, eta, l1, c0 if warm else None, iters)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fista_solve"] == 1 and it_k.tolist() == [iters] * M
    a_p, _ = tf.fista_codes(x, d, eta, l1, c0 if warm else torch.zeros_like(c0), iters)
    assert a_k.dtype == torch.float32 and a_k.shape == (M, B, N)
    _hold_fista(a_k, a_p, x, d)


def test_fista_kernel_exits_early_member_by_member(cuda):
    """One dictionary for every member, l1 apart: each stops at its own
    count, the kernel's and the plain loop's counts agree, and a stopped
    member's codes are those of a fixed-count solve of that length."""
    M, B, N, D = 3, 256, 512, 128
    x, d, _, l1 = _fista_problem((M, B, N, D), cuda, seed=1)
    d = d[:1].expand(M, N, D).contiguous()  # the batch is planted in member 0's rows
    eta = tf.default_eta(d)
    a_k, it_k = fk.fista_cuda(x, d, eta, l1, None, 500, tol=1e-3)
    a_p, it_p = tf.fista_codes(x, d, eta, l1, torch.zeros((M, B, N), device=cuda), 500, tol=1e-3)
    torch.cuda.synchronize()
    assert it_k.tolist() == it_p.tolist() and max(it_k.tolist()) < 500, (it_k, it_p)
    _hold_fista(a_k, a_p, x, d)
    for m, k in enumerate(it_k.tolist()):
        one = [t[m : m + 1].clone() for t in (d, eta, l1)]  # each 16-byte aligned, as the wrapper requires
        fixed, _ = fk.fista_cuda(x, *one, None, k)
        assert torch.equal(fixed[0], a_k[m]), m


def test_fista_selector_takes_the_kernel_and_refuses_what_it_cannot(cuda):
    x, d, c0, l1 = _fista_problem((2, 256, 512, 128), cuda)
    fk.reset_launches()
    a, res = fk.fista_solve(x, d, l1, c0, num_iter=20)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fista_solve"] == 1 and a.is_cuda and res.shape == (2, 256, 128)
    # a width that is no multiple of 4 goes to K_f too (its float4 edge masked)
    odd_x, odd_d = x[:, :126].contiguous(), d[:, :, :126].contiguous()
    a, res = fk.fista_solve(odd_x, odd_d, l1, None, num_iter=5)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fista_solve"] == 2 and res.shape == (2, 256, 126)
    empty_x, empty_d = x[:, :0].contiguous(), d[:, :, :0].contiguous()
    with pytest.raises(ValueError, match="not supported"):  # no plain solve on the card
        fk.fista_solve(empty_x, empty_d, l1, None, num_iter=5)
    with pytest.raises(ValueError, match="not supported"):
        fk.fista_cuda(empty_x, empty_d, torch.ones(2, device=cuda), l1, None, 5)
    with pytest.raises(ValueError, match="float32"):
        fk.fista_cuda(x.double(), d, tf.default_eta(d), l1, None, 5)
    assert fk.LAUNCHES["fista_solve"] == 2


@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_fista_kernel_takes_widths_that_are_not_multiples_of_4(cuda, tol):
    """N 2050, D 130 (rows of no whole float4s), a ragged batch of 200: K_f
    against its plain loop, the same iteration count for each member."""
    M, B, N, D, iters = 2, 200, 2050, 130, 50
    x, d, c0, l1 = _fista_problem((M, B, N, D), cuda, seed=2)
    eta = tf.default_eta(d)
    fk.reset_launches()
    a_k, it_k = fk.fista_cuda(x, d, eta, l1, c0, iters, tol=tol)
    a_p, it_p = tf.fista_codes(x, d, eta, l1, c0, iters, tol=tol)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fista_solve"] == 1
    assert it_k.tolist() == it_p.tolist(), (it_k, it_p)
    _hold_fista(a_k, a_p, x, d)
