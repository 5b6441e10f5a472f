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
selection), the select alone on crafted rows too, K_s at tiles past B and N
and the same bits on two launches; the sparse decode on rows of every kind (k = N, all ties, no
positive score, one kept entry) and at widths past one register pass, and
the same bits on two launches. K1n: dxh bit-equal to K1's at every width
and batch it takes, the same bits on two launches, and its `wgmma` chains'
bits equal to `mma.sync` chains' on the same operands. K1 on the same
pipeline (D <= 512): dxh bit-equal to K1n's, its stored code the one K2's
rebuild produces, the same bits on two launches, B 64 to 4096.
K2/K3's sparse route (the TopK path's: only the code's non-zeros touched)
is held to the dense route's tolerances against the same plain versions,
on TopK codes, a k = 1 member, an all-zero code, a hot feature (non-zero
on every batch row) and a fully dense code, and gives the same bits on two
launches of the same inputs.
K_f (the FISTA solve) against its plain loop on the same η: codes within
atol 1e-4 (the JAX suite's pin for `_fista_kernel` in interpret mode; each
product sums in another order, which the iterations carry), support flips
under 1e-3, ‖res‖² within 1e-5 relative, and with tol > 0 the same
iteration count for each member; at widths that are not multiples of 4 too;
at the FISTA path's shapes, one launch a solve, the same bits twice.
K1 and K2 at the harvest sweep's shape (`run_single_layer`'s
`dense_l1_range_experiment` on Pythia-70M's residual, ratio 8: M 16, B 2048,
N 4096, D 512, f32 moments) to the same tolerances. The activation harvest
on the card at Pythia-70M's widths (3 of its 6 layers): `harvest_to_device`
yields the bits `make_activation_dataset` writes, and both stay within
1e-3 of the largest magnitude of the same harvest on the CPU.
The sweep driver on the card: an Adam ensemble's steps run K1 + K2, an
ensemble with a learning-rate schedule K1 + K3, and nothing else runs.
Launches are the wrappers' `LAUNCHES`, counted on the card at every
execution, a graph's replays included (`ops/_wrap.py::LaunchCounts`); a
profiler trace of the same run must never count more, and a trace that
counts fewer is reported as a warning naming ROADMAP C3
(`_torch_trace.trace_shortfall`).
The step as a replayed CUDA graph (`Ensemble.step_scan`, `step_scan_idx`):
K replays give the bits of K eager `step_batch` calls (losses, params,
moments with int8 codes and scales, count, step) on every route and moment
tier, and launch each kernel as often; one graph replayed 100 times counts
exactly 100 launches of each of its kernels, and a traced eager step counts
in the trace what its wrappers count; a batch of another shape,
`set_update_mask`, a new warm-up length and a state assigned from outside
each lead to a new capture, never to a stale replay, and an eager step to
none; two calls' losses do not alias.
"""

import pytest
import torch

from _torch_moments import adam_moments, clone_moment, same_bits, store_error_steps, stored_agreement
from _torch_parity import assert_grads_close, bf16_close
from _torch_select_rows import CASES as SELECT_CASES
from _torch_select_rows import case as select_case
from _torch_trace import SYMBOLS, trace_shortfall, traced
from sparse_coding__tpu_torch.models import fista as tf
from sparse_coding__tpu_torch.ops import fista_kernel as fk
from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
from sparse_coding__tpu_torch.ops import topk_kernel as kk

pytestmark = pytest.mark.cuda

# M, B, N, D: every width the kernels take (the dense K2/K3 at D 768 run the
# WMMA mainloop, single-buffering x; at D 1024, on the stored code and
# rebuilding it, the wgmma mainloop in a cluster of four blocks; K1 and K1n
# at D 1024 the pipelined kernel in clusters of two), then the two main
# paths' full shapes (tied SAE, TopK config 4)
SHAPES = [(2, 256, 512, 128), (2, 128, 256, 256), (2, 256, 512, 768), (2, 256, 256, 1024),
          (8, 2048, 4096, 512), (7, 2048, 12288, 768)]
# M, B, N, D at D 1024 (the dense K2/K3 in a cluster of four blocks, K1 and
# K1n in clusters of two): one cluster (N 128) at the smallest batch, a
# batch that wraps the ring of three stages unevenly (B 320: 10 tiles), then
# BASELINE config 5 (Pythia-410M's residual, 32x): K1 and K2 at its batch of
# 2048, K3 at the data axis' local batch of 1024
QUAD_SMALL = [(2, 64, 128, 1024), (3, 320, 256, 1024)]
QUAD_K2_FULL, QUAD_K3_FULL = (4, 2048, 32768, 1024), (4, 1024, 32768, 1024)
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


@pytest.mark.parametrize("shape", SHAPES + QUAD_SMALL + [QUAD_K2_FULL])
@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
def test_bwd_adam_kernel_matches_plain(cuda, shape, mu_dtype):
    M, B, N, D = shape
    d_raw, bias, xb, nrm, db, l1b = _inputs(shape, cuda, seed=1)
    c, dxh, _, _ = tk._fwd_plain(xb, db, bias, 2.0 / (B * D))
    dj = (d_raw / nrm[..., None]).to(torch.bfloat16)
    gr, gb_p = tk._grads_plain(xb, dxh, c, nrm, dj, l1b)
    tk.reset_launches()
    out = _hold_adam_step(
        lambda d, mu, nu, bc: tk.tied_sae_bwd_adam(xb, dxh, c, nrm, d, mu, nu, l1b, bc, *HP),
        d_raw, gr, mu_dtype, seed=2,
    )
    assert tk.LAUNCHES["tied_sae_bwd_adam"] == 2  # steps 1 and 10
    assert_grads_close(out[3], gb_p, "g_bias")


@pytest.mark.parametrize("shape", SHAPES + QUAD_SMALL + [QUAD_K3_FULL])
def test_bwd_grads_kernel_matches_plain(cuda, shape):
    M, B, N, D = shape
    d_raw, bias, xb, nrm, db, l1b = _inputs(shape, cuda, seed=3)
    c, dxh, _, _ = tk._fwd_plain(xb, db, bias, 2.0 / (B * D))
    tk.reset_launches()
    g_k, gb_k = tk.tied_sae_bwd_grads(xb, dxh, c, nrm, db, l1b)
    g_p, gb_p = tk._grads_plain(xb, dxh, c, nrm, db, l1b)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["tied_sae_bwd_grads"] == 1
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


def _select_alone(s, k):
    """K_s's select on given scores, through its C entry `sc_topk_select`
    (not on the TopK path: the path's select runs inside `sc_topk_scores`)."""
    from sparse_coding__tpu_torch.ops import _build
    from sparse_coding__tpu_torch.ops._wrap import stream

    M, B, N = s.shape
    thresh = torch.empty((M, B), dtype=torch.float32, device=s.device)
    rc = _build.load()["topk_fwd"].sc_topk_select(s.data_ptr(), k.data_ptr(), thresh.data_ptr(), M, B, N,
                                                  stream(s.device))
    _build.check(rc, "topk_select")
    return thresh


@pytest.mark.parametrize("name", SELECT_CASES)
def test_topk_select_is_bit_equal_to_the_plain_select_on_crafted_rows(cuda, name):
    """The select alone on the crafted rows of tests/_torch_select_rows.py
    (ties across a high-byte boundary, the k clamps, all negative, zeros of
    both signs, one repeated value, the most crowded high byte, NaN, config
    4's N, a row counted in two pieces): the plain select's threshold bits."""
    s, k = select_case(name)
    s, k = s.to(cuda), k.to(cuda)
    got = _select_alone(s, k)
    want = kk._select_plain(s, k)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), name


# K_s's tiles past the edges: B % 128 == 64 and N % 256 == 128 (a half tile
# each way, stored masked), and the smallest shape taken
TOPK_RAGGED = [((3, 192, 640, 256), (1, 17, 640)), ((2, 64, 128, 128), (1, 128))]


@pytest.mark.parametrize("shape,ks", TOPK_SHAPES + TOPK_RAGGED)
def test_topk_scores_hold_at_every_shape_and_give_the_same_bits_twice(cuda, shape, ks):
    """K_s's scores within 1 bf16 ulp of the plain GEMM's on < 0.1% of
    elements, its thresholds bit-equal to the plain select on its own
    scores, and two launches the same bits, at the TopK shapes and at tiles
    past B and N."""
    M, B, N, D = shape
    d_raw, xb, nrm, db, k = _topk_inputs(shape, ks, cuda, seed=42)
    s, thresh = kk.topk_scores(xb, db, k)
    s2, thresh2 = kk.topk_scores(xb, db, k)
    s_p, _ = kk._topk_scores_plain(xb, db, k)
    torch.cuda.synchronize()
    frac, ok = bf16_close(s, s_p)
    assert ok and frac < 1e-3, (frac, ok)
    assert torch.equal(thresh.view(torch.int32), kk._select_plain(s, k).view(torch.int32))
    assert same_bits(s, s2) and same_bits(thresh, thresh2)


# K_d's rows of every kind: D, then k per member (k = N among them, a k = 1
# member); on top of K_s's thresholds, row 0 of member 0 is all ties at its
# threshold, row 1 has no positive score, row 2 keeps one entry. D 128 holds
# half a 256-column unit a lane; 1152 and 1280 take two register passes
# (the second ragged at 1152)
DECODE_EDGE_WIDTHS = [128, 768, 1152, 1280]


def _edge_scores(D, dev):
    M, B, N = 3, 64, 2048
    d_raw, xb, nrm, db, k = _topk_inputs((M, B, N, D), (1, N, 31), dev, seed=40)
    s, thresh = kk.topk_scores(xb, db, k)
    s, thresh = s.clone(), thresh.clone()
    s[0, 0] = 0.25
    thresh[0, 0] = 0.25
    s[0, 1] = -s[0, 1].abs()
    s[2, 2] = -s[2, 2].abs()
    s[2, 2, 700] = 0.5
    thresh[2, 2] = 0.5
    return s, thresh, db, xb


@pytest.mark.parametrize("D", DECODE_EDGE_WIDTHS)
def test_topk_decode_takes_rows_of_every_kind(cuda, D):
    """K_d against the plain decode on the same scores and thresholds: c bit
    for bit, dxh within 1 ulp on < 1% of elements, l_rec within 1e-3; k = N
    walks a list far longer than the kernel's list buffer in pieces."""
    s, thresh, db, xb = _edge_scores(D, cuda)
    M, B, N = s.shape
    c, dxh, lrec = kk.topk_decode(s, thresh, db, xb, 2.0 / (B * D))
    c_p, dxh_p, lrec_p = kk._topk_decode_plain(s, thresh, db, xb, 2.0 / (B * D))
    torch.cuda.synchronize()
    assert torch.equal(c.view(torch.int16), c_p.view(torch.int16))
    kept = (c != 0).sum(-1)
    assert int(kept[0, 0]) == N and int(kept[0, 1]) == 0 and int(kept[2, 2]) == 1
    # k = N: every positive score kept, ~1024 a row (two pieces of the list)
    assert torch.equal(kept[1], (s[1].float() > 0).sum(-1))
    frac, ok = bf16_close(dxh, dxh_p)
    assert ok and frac < 1e-2, (frac, ok)
    torch.testing.assert_close(lrec, lrec_p, rtol=1e-3, atol=0)


@pytest.mark.parametrize("case", TOPK_SHAPES + ["edge"])
def test_topk_decode_gives_the_same_bits_twice(cuda, case):
    """K_d's sums run in a fixed order (ascending kept column, then a fixed
    shuffle tree a row): two launches on the same inputs give the same c,
    dxh and l_rec bits."""
    if case == "edge":
        s, thresh, db, xb = _edge_scores(1280, cuda)
    else:
        shape, ks = case
        d_raw, xb, nrm, db, k = _topk_inputs(shape, ks, cuda, seed=41)
        s, thresh = kk.topk_scores(xb, db, k)
    scale = 2.0 / (xb.shape[0] * xb.shape[1])
    outs = [kk.topk_decode(s, thresh, db, xb, scale) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(same_bits(a, b) for a, b in zip(*outs))


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


# K1n's shapes: every width, the smallest batch and dictionary it takes,
# then B = 4096 at config 2's widths, then config 5
NOCODE_SHAPES = SHAPES + [(2, 64, 128, 256), (3, 64, 128, 512), (8, 4096, 4096, 512), QUAD_K2_FULL]


@pytest.mark.parametrize("shape", NOCODE_SHAPES)
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


def test_wgmma_chain_gives_the_mma_sync_chain_bits(cuda):
    """K1n multiplies by `wgmma`, K1 (through `wmma`) and K2's rebuild by
    `mma.sync` m16n8k16 chains. On the same bf16 operands a chain of `wgmma`
    k16 steps from k = 0 gives the same f32 bits as the `mma.sync` chain, at
    every depth K1n's encode takes (its widths) and in both forms K1n uses: A
    and B from shared memory, K-major (the encode), and A from registers, B
    N-major (the decode). The kernels are `scripts/fwd_probe.py`'s."""
    import importlib.util
    from pathlib import Path

    from sparse_coding__tpu_torch.ops import _build

    path = Path(__file__).resolve().parents[1] / "scripts" / "fwd_probe.py"
    spec = importlib.util.spec_from_file_location("fwd_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    lib = probe.build(_build.NVCC_FLAGS, _build._nvcc(), variants=False)["wg_bits"]
    rows = probe.wgmma_bits(torch, lib, depths=(128, 256, 512))
    assert len(rows) == 6 and all(r["rc"] == 0 for r in rows)
    assert all(r["share_of_bits_differing"] == 0.0 for r in rows), rows


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[2], SHAPES[4], QUAD_K2_FULL])
def test_fwd_nocode_gives_the_same_bits_twice(cuda, shape):
    """K1n's per-block loss sums add their warps in a fixed order: two
    launches on the same inputs give the same dxh, l_rec and l_l1 bits."""
    M, B, N, D = shape
    d_raw, bias, xb, nrm, db, _ = _inputs(shape, cuda, seed=8)
    outs = [tk.tied_sae_fwd_nocode(xb, db, bias, 2.0 / (B * D)) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(same_bits(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("shape", SHAPES[:5] + QUAD_SMALL + [QUAD_K2_FULL])
@pytest.mark.parametrize("tiers", [("bfloat16", "float32")] + TIERS)
def test_bwd_adam_rebuild_is_bit_identical_to_the_stored_code(cuda, shape, tiers):
    """K2 rebuilding the code from x, D̂ and the bias == K2 on K1's stored
    code: d_new, the moments (codes and scales) and g_bias, bit for bit, at
    every width (at D 1024 the code of K1's order over the depth's quarters,
    rebuilt in the cluster of four), at one cluster, a ragged batch and
    config 5 there."""
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


# (mu, nu) storage tiers, all nine
ALL_TIERS = [(mu, nu) for mu in ("float32", "bfloat16", "int8") for nu in ("float32", "bfloat16", "int8")]
# shape, (mu, nu) tiers and whether K2 rebuilds the code: every width on the
# stored code in the compressed tiers; D 1024's cluster of four in every
# tier, at one cluster and at config 5; K2 rebuilding the code at D 1024 in
# the tiers the bit-identity test takes
EPILOGUE_CASES = ([(s, t, False) for s in SHAPES for t in TIERS]
                  + [(s, t, False) for s in (QUAD_SMALL[0], QUAD_K2_FULL) for t in ALL_TIERS]
                  + [(SHAPES[3], t, True) for t in [("bfloat16", "float32")] + TIERS])


@pytest.mark.parametrize("shape,tiers,rebuild", EPILOGUE_CASES)
def test_bwd_adam_compressed_epilogue_matches_plain(cuda, shape, tiers, rebuild):
    """K2's epilogue against `_adam_plain` on the same gradient: the
    stochastic stores draw the same counter-hash bits, so int8 codes and bf16
    nu agree in >= 99.9% of elements, never more than one code or ulp apart,
    scales within 1e-6. On the stored code the gradient is K3's, which runs
    K2's gradient code on the same bf16 rows. Rebuilding the code (D 1024)
    it is the one K2 itself leaves in f32 mu from zero moments at b1 = 0
    (mu_new = 1 * g exactly), held against the plain gradient of K1's code,
    with that launch's g_bias."""
    M, B, N, D = shape
    d_raw, bias, xb, nrm, db, l1b = _inputs(shape, cuda, seed=8)
    c, dxh, _, _ = tk.tied_sae_fwd(xb, db, bias, 2.0 / (B * D))
    if rebuild:
        zeros = torch.zeros_like(d_raw)
        bc1 = torch.tensor([[1.0, 1 - HP[2]]] * M, device=cuda)
        _, g, _, gb = tk.tied_sae_bwd_adam(xb, dxh, None, nrm, d_raw.clone(), zeros.clone(), zeros.clone(), l1b,
                                           bc1, LR, 0.0, *HP[2:], bias=bias)
        g_p, gb_p = tk._grads_plain(xb, dxh, c, nrm, db, l1b)
        assert_grads_close(g, g_p, "g_enc")
        assert_grads_close(gb, gb_p, "g_bias")
    else:
        g, gb = tk.tied_sae_bwd_grads(xb, dxh, c, nrm, db, l1b)
    mu, nu = _moments(d_raw, *tiers, seed=9)
    bc = torch.tensor([[0.1, 0.001]] * M, device=cuda)
    seed_tile = 128 if D == 768 else tk.TIED_SEED_TILE
    d_k, mu_k, nu_k, gb_k = tk.tied_sae_bwd_adam(xb, dxh, None if rebuild else c, nrm, d_raw.clone(),
                                                 clone_moment(mu), clone_moment(nu), l1b, bc, *HP, seed=11,
                                                 seed_tile=seed_tile, bias=bias if rebuild else None)
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


@pytest.mark.parametrize("shape", [WG_CASES[2], SHAPES[4], QUAD_SMALL[0], QUAD_K2_FULL])
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


# -- the dense route at D 1024 on the stored code: a cluster of four ------------


def test_dense_d1024_plans_and_launches_a_cluster_of_four(cuda):
    """The built libraries' plans at D 1024: the dense K2/K3 on the stored
    code and K2 rebuilding it in clusters of four blocks, at least two
    stages, within the shared memory a block may use, in every int8 tier;
    K1/K1n's pipelined kernel in clusters of two. A traced K1, K1n, K3, K2
    on the stored code and K2 rebuilding it at D 1024 run `pp_fwd_kernel<
    1024, …>` and `wg_bwd_kernel<…, 1024>`, and no WMMA `encode_kernel`,
    `decode_kernel`, `nocode_kernel` or `bwd_kernel`."""
    import ctypes

    from torch.profiler import ProfilerActivity, profile

    from sparse_coding__tpu_torch.ops import _build
    from sparse_coding__tpu_torch.ops._wrap import MAX_SMEM

    libs = _build.load()
    for i8 in (0, 1, 2):
        for lib in ("tied_sae_bwd", "tied_sae_bwd_rc"):
            got = (ctypes.c_int * 3)()
            assert libs[lib].sc_tied_sae_bwd_plan(1024, i8, ctypes.addressof(got)) == 0
            stages, smem, cluster = list(got)
            assert cluster == 4 and stages >= 2 and smem <= MAX_SMEM, (lib, i8, list(got))
    got = (ctypes.c_int * 3)()
    assert libs["tied_sae_fwd"].sc_tied_sae_fwd_plan(1024, ctypes.addressof(got)) == 0
    stages, smem, cluster = list(got)
    assert cluster == 2 and stages >= 2 and smem <= MAX_SMEM, list(got)
    shape = QUAD_SMALL[0]
    M, B, N, D = shape
    d_raw, bias, xb, nrm, db, l1b = _inputs(shape, cuda, seed=40)
    c, dxh, _, _ = tk.tied_sae_fwd(xb, db, bias, 2.0 / (B * D))
    mu, nu = _moments(d_raw, "bfloat16", "float32", seed=41)
    bc = torch.tensor([[0.1, 0.001]] * M, device=cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tk.tied_sae_fwd(xb, db, bias, 2.0 / (B * D))
        tk.tied_sae_fwd_nocode(xb, db, bias, 2.0 / (B * D))
        tk.tied_sae_bwd_grads(xb, dxh, c, nrm, db, l1b)
        tk.tied_sae_bwd_adam(xb, dxh, c, nrm, d_raw.clone(), clone_moment(mu), clone_moment(nu), l1b, bc, *HP)
        tk.tied_sae_bwd_adam(xb, dxh, None, nrm, d_raw.clone(), mu, nu, l1b, bc, *HP, bias=bias)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type.name == "CUDA"]
    for kernel in ("pp_fwd_kernel<1024, true>", "pp_fwd_kernel<1024, false>",
                   "wg_bwd_kernel<false, 0, 0, false, 1024>", "wg_bwd_kernel<true, 1, 0, false, 1024>",
                   "wg_bwd_kernel<true, 1, 0, true, 1024>"):
        assert any(kernel in n for n in names), (kernel, names)
    for kernel in ("::encode_kernel(", "::decode_kernel(", "::nocode_kernel<", "::bwd_kernel<"):
        assert not any(kernel in n for n in names), (kernel, names)


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


# K1 on the pipelined encode -> decode: every pipelined width at the
# smallest batch and dictionary, then config 2 at B 64, 2048 and 4096, then
# D 1024's pair split at one cluster, a ragged batch and config 5
K1_PP_SHAPES = [(2, 64, 128, 128), (2, 64, 128, 256), (2, 64, 128, 512), (2, 2048, 512, 256),
                (8, 64, 4096, 512), (8, 2048, 4096, 512), (8, 4096, 4096, 512),
                (2, 64, 128, 1024), (3, 320, 256, 1024), QUAD_K2_FULL]


@pytest.mark.parametrize("shape", K1_PP_SHAPES)
def test_fwd_pipelined_k1_keeps_the_code_and_dxh_bits(cuda, shape):
    """K1 on K1n's pipeline with its code stored: dxh bit-equal to K1n's, c
    the code K2's rebuild produces (K2 on the stored c and K2 rebuilding it
    give the same bits), both within the plain versions' tolerances, and
    the same c, dxh and loss bits on two launches."""
    M, B, N, D = shape
    d_raw, bias, xb, nrm, db, l1b = _inputs(shape, cuda, seed=21)
    scale = 2.0 / (B * D)
    tk.reset_launches()
    outs = [tk.tied_sae_fwd(xb, db, bias, scale) for _ in range(2)]
    dxh_n, _, _ = tk.tied_sae_fwd_nocode(xb, db, bias, scale)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["tied_sae_fwd"] == 2
    assert all(same_bits(a, b) for a, b in zip(*outs))
    c, dxh, lrec, ll1 = outs[0]
    assert torch.equal(dxh.view(torch.int16), dxh_n.view(torch.int16))
    c_p, ll1_p = tk._encode_plain(xb, db, bias)
    dxh_p, lrec_p = tk._decode_plain(xb, db, c, scale)
    frac, ok = bf16_close(c, c_p)
    assert ok and frac < 1e-3, (frac, ok)
    frac, ok = bf16_close(dxh, dxh_p)
    assert ok and frac < 1e-2, (frac, ok)
    torch.testing.assert_close(lrec, lrec_p, rtol=1e-3, atol=0)
    torch.testing.assert_close(ll1, ll1_p, rtol=1e-3, atol=0)
    mu, nu = _moments(d_raw, "bfloat16", "float32", seed=22)
    bc = torch.tensor([[0.1, 0.001]] * M, device=cuda)
    steps = [tk.tied_sae_bwd_adam(xb, dxh, code, nrm, d_raw.clone(), clone_moment(mu), clone_moment(nu), l1b, bc,
                                  *HP, seed=23, bias=b) for code, b in ((c, None), (None, bias))]
    torch.cuda.synchronize()
    for a, b in zip(*steps):
        assert same_bits(a, b)


# K_f at the FISTA path's shapes: where JAX picks `_fista_kernel`, BASELINE
# config 3 (where it picks `_fista_kernel_hbm_dict`), and rows that are not
# whole float4s with a ragged batch
FISTA_PATH_SHAPES = [(2, 256, 512, 128, 100), (4, 2048, 2048, 512, 500), (2, 200, 2050, 130, 50)]


@pytest.mark.parametrize("shape", FISTA_PATH_SHAPES)
@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_fista_one_launch_solve_matches_plain_at_the_path_shapes(cuda, shape, tol):
    """K_f's one cooperative launch against its plain loop at each shape, at
    tol 0 and 1e-3: the same iteration count for each member, codes within
    `_hold_fista`'s tolerances, and the same bits on two launches."""
    M, B, N, D, iters = shape
    x, d, c0, l1 = _fista_problem((M, B, N, D), cuda, seed=24)
    eta = tf.default_eta(d)
    fk.reset_launches()
    (a_k, it_k), (a_2, it_2) = [fk.fista_cuda(x, d, eta, l1, c0, iters, tol=tol) for _ in range(2)]
    a_p, it_p = tf.fista_codes(x, d, eta, l1, c0, iters, tol=tol)
    torch.cuda.synchronize()
    assert fk.LAUNCHES["fista_solve"] == 2
    assert it_k.tolist() == it_p.tolist() == it_2.tolist(), (it_k, it_p, it_2)
    assert torch.equal(a_k, a_2)
    _hold_fista(a_k, a_p, x, d)


# run_single_layer's dense_l1_range_experiment over the harvested Pythia-70M
# residual at ratio 8 (chip_smoke's harvest_sweep)
HARVEST_SWEEP = (16, 2048, 4096, 512)


def test_k1_and_k2_at_the_harvest_sweeps_shape_match_plain(cuda):
    test_fwd_kernel_matches_plain(cuda, HARVEST_SWEEP)
    test_bwd_adam_kernel_matches_plain(cuda, HARVEST_SWEEP, torch.float32)


def test_harvest_to_device_is_the_disk_store_bit_for_bit_on_the_card(cuda, tmp_path):
    import numpy as np

    from sparse_coding__tpu_torch.data import activations as tact
    from sparse_coding__tpu_torch.lm import config_for, init_params, model as lm_model

    cfg = config_for("pythia-70m")
    params = init_params(0, cfg, device=cuda)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (256, 256)).astype(np.int32)
    kw = dict(layers=[2], layer_locs=["residual", "mlpout"], batch_size=64, chunk_size_gb=2.0 ** -5, n_chunks=2)
    folders = tact.make_activation_dataset(params, cfg, tokens, tmp_path / "disk", device=cuda, **kw)
    chunks = list(tact.harvest_to_device(params, cfg, tokens, device=cuda, **kw))
    assert len(chunks) == 2 and chunks[0][(2, "residual")].shape == (32768, 512)
    for key, folder in folders.items():
        for i, chunk in enumerate(chunks):
            disk = torch.from_numpy(np.load(folder / f"{i}.npy"))
            assert torch.equal(chunk[key].cpu().view(torch.int16), disk.view(torch.int16)), (key, i)
    host = lm_model.tree_map(lambda t: t.cpu(), params)
    (ref,) = tact.harvest_to_device(host, cfg, tokens[:128], device="cpu", **{**kw, "n_chunks": 1})
    for key in ref:
        a, b = ref[key].float(), chunks[0][key].cpu().float()
        assert float((a - b).abs().max() / a.abs().max()) < 1e-3, key


def test_sweep_on_the_card_routes_fused_adam_to_k2_and_a_schedule_to_k3(cuda, tmp_path, monkeypatch):
    """The sweep driver on the card (D 128, N 512, batch 256, 2 chunks of
    512 rows): an Adam ensemble launches K1 + K2 on every step, an ensemble
    with a learning-rate schedule K1 + K3, and nothing else launches."""
    import numpy as np

    from sparse_coding__tpu_torch import FunctionalTiedSAE, build_ensemble
    from sparse_coding__tpu_torch.data.chunks import save_chunk
    from sparse_coding__tpu_torch.train.sweep import sweep
    from sparse_coding__tpu_torch.utils.config import EnsembleArgs
    from sparse_coding__tpu_torch.utils.optim import linear_schedule

    monkeypatch.delenv("SC_RECOMPUTE_CODE", raising=False)
    rng = np.random.default_rng(0)
    for i in range(2):
        save_chunk(tmp_path / "store", i, rng.standard_normal((512, 128)).astype(np.float32))
    kw = dict(compute_dtype="bfloat16", activation_size=128, n_dict_components=512, device=cuda)

    def init(cfg):
        a = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": 1e-3}, {"l1_alpha": 3e-3}],
                           optimizer_kwargs={"learning_rate": LR, "mu_dtype": "bfloat16"}, **kw)
        with pytest.warns(UserWarning, match="schedule"):
            b = build_ensemble(FunctionalTiedSAE, 1, [{"l1_alpha": 1e-3}],
                               optimizer_kwargs={"learning_rate": linear_schedule(0.0, LR, 2)}, **kw)
        assert a.fused_adam is not None and b.fused and b.fused_adam is None
        args = {"batch_size": cfg.batch_size}
        return [(a, args, "adam"), (b, args, "schedule")], [], ["l1_alpha"], {}

    cfg = EnsembleArgs(dataset_folder=str(tmp_path / "store"), output_folder=str(tmp_path / "out"), batch_size=256,
                       activation_width=128)
    _reset_launches()
    lds, trace = traced(torch, lambda: sweep(init, cfg, device=cuda))
    launches = _launches()
    steps = 2 * 512 // 256  # per ensemble
    want = {k: 0 for k in launches}
    want.update(tied_sae_fwd=2 * steps, tied_sae_bwd_adam=steps, tied_sae_bwd_grads=steps)
    assert launches == want
    _report_trace(trace, launches)
    assert len(lds) == 3 and all(torch.isfinite(ld.encoder).all() for ld, _ in lds)


# -- the step as a replayed CUDA graph (Ensemble.step_scan / step_scan_idx) ------
# Each case builds an ensemble at D 128, N 512, batch 256 on one route of the
# step: (build kwargs, environment, per-member batches, update mask)
_GRAPH_KW = dict(activation_size=128, n_dict_components=512)
_TOPK_KW = dict(d_activation=128, n_features=512, sparsity_cap=31)
GRAPH_CASES = {
    "tied_f32_moments": (dict(optimizer_kwargs={"learning_rate": LR}, compute_dtype="bfloat16"), {}, False, False),
    "tied_bf16_mu": (dict(optimizer_kwargs={"learning_rate": LR, "mu_dtype": "bfloat16"},
                          compute_dtype="bfloat16"), {}, False, False),
    "tied_int8_mu_bf16_nu": (dict(optimizer_kwargs={"learning_rate": LR, "mu_dtype": "int8", "nu_dtype": "bfloat16"},
                                  compute_dtype="bfloat16"), {}, False, False),
    "tied_recompute_code": (dict(optimizer_kwargs={"learning_rate": LR, "mu_dtype": "int8", "nu_dtype": "bfloat16"},
                                 compute_dtype="bfloat16"), {"SC_RECOMPUTE_CODE": "1"}, False, False),
    "tied_l1_warmup": (dict(optimizer_kwargs={"learning_rate": LR, "mu_dtype": "bfloat16"}, compute_dtype="bfloat16",
                            l1_warmup_steps=3), {}, False, False),
    "topk": (dict(optimizer_kwargs={"learning_rate": LR}, compute_dtype="bfloat16"), {}, False, False),
    "topk_capacity": (dict(optimizer_kwargs={"learning_rate": LR, "mu_dtype": "int8", "nu_dtype": "bfloat16"},
                           compute_dtype="bfloat16"), {"SC_RECOMPUTE_CODE": "1"}, False, False),
    "fused_grads_schedule": (dict(optimizer_kwargs={"learning_rate": "schedule", "mu_dtype": "bfloat16"},
                                  compute_dtype="bfloat16"), {}, False, False),
    "masked": (dict(optimizer_kwargs={"learning_rate": LR, "mu_dtype": "bfloat16"}, compute_dtype="bfloat16"), {},
               False, True),
    "autograd_f32": (dict(optimizer_kwargs={"learning_rate": LR}), {}, False, False),
    "autograd_per_model": (dict(optimizer_kwargs={"learning_rate": LR}, compute_dtype="bfloat16"), {}, True, False),
}


def _graph_ensemble(case, dev, monkeypatch):
    """(ensemble, its clone from `state_dict`, per_model) for a `GRAPH_CASES`
    entry, with the route checked."""
    import warnings

    from sparse_coding__tpu_torch import Ensemble, FunctionalTiedSAE, TopKEncoderApprox, build_ensemble
    from sparse_coding__tpu_torch.utils.optim import linear_schedule

    build, env, per_model, masked = GRAPH_CASES[case]
    monkeypatch.delenv("SC_RECOMPUTE_CODE", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    build = dict(build, optimizer_kwargs=dict(build["optimizer_kwargs"]))
    if build["optimizer_kwargs"]["learning_rate"] == "schedule":
        build["optimizer_kwargs"]["learning_rate"] = linear_schedule(0.0, LR, 3)
    if case.startswith("topk"):
        sig, hp, kw = TopKEncoderApprox, [{"sparsity": 7}, {"sparsity": 31}], _TOPK_KW
    else:
        sig, hp, kw = FunctionalTiedSAE, [{"l1_alpha": 1e-3}, {"l1_alpha": 3e-3}], _GRAPH_KW
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the schedule's fused-Adam refusal
        a = build_ensemble(sig, 0, hp, device=dev, **build, **kw)
    if masked:
        a.set_update_mask([1.0, 0.0])
    b = Ensemble.from_state(a.state_dict(), sig=sig, device=dev)
    route = a._route(256, masked, per_model)
    want = ("autograd" if case.startswith("autograd") else "fused_grads" if case in ("fused_grads_schedule", "masked")
            else "fused_adam")
    assert route == want, (case, route)
    assert (a.fused_adam or {}).get("recompute_code", False) == bool(env) or case.startswith("topk")
    return a, b, per_model


def _launches():
    return {**tk.LAUNCHES, **kk.LAUNCHES}


def _reset_launches():
    tk.reset_launches()
    kk.reset_launches()


def _report_trace(trace, counted):
    """The trace never counts more than the wrappers; where it counts fewer,
    it has dropped records: a warning naming ROADMAP C3, the wrappers' counts
    standing."""
    short = trace_shortfall(trace, counted)
    if short:
        import warnings

        warnings.warn(f"ROADMAP C3: the profiler trace missed launches (trace, wrappers): {short}")


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graph_replays_are_bit_equal_to_eager_steps(cuda, monkeypatch, case):
    """K replays of the captured step give the losses, params, moments (q and
    scale of int8 ones), count and step of K eager `step_batch` calls from
    the same state, bit for bit, and launch each hand-written kernel as
    often as the eager steps do (the wrappers' counts, which count a
    replay's executions on the card); a profiler trace of either never
    counts more."""
    from _torch_moments import state_differences

    a, b, per_model = _graph_ensemble(case, cuda, monkeypatch)
    K = 4
    g = torch.Generator(device=cuda).manual_seed(3)
    shape = (K + 1, a.n_models, 256, 128) if per_model else (K + 1, 256, 128)
    xs = torch.randn(shape, generator=g, device=cuda)
    first = a.step_scan(xs[:1], per_model=per_model)  # eager first step, then the capture
    lb0, _ = b.step_batch(xs[0], per_model=per_model)
    assert a.captures == 1 and all(torch.equal(first[k][0], lb0[k]) for k in lb0)
    _reset_launches()
    la, graph_trace = traced(torch, lambda: a.step_scan(xs[1:], per_model=per_model))
    graph_ran = _launches()
    _reset_launches()
    lb, eager_trace = traced(torch, lambda: [b.step_batch(x, per_model=per_model)[0] for x in xs[1:]])
    eager_ran = _launches()
    assert a.captures == 1  # every step of the second call a replay
    assert graph_ran == eager_ran
    if not case.startswith("autograd"):
        assert sum(graph_ran.values()) >= 2 * K
    _report_trace(graph_trace, graph_ran)
    _report_trace(eager_trace, eager_ran)
    for k in lb[0]:
        assert torch.equal(la[k], torch.stack([l[k] for l in lb])), k
    assert state_differences(a.state, b.state) == []


@pytest.mark.parametrize("case", ["tied_f32_moments", "fused_grads_schedule", "topk"])
def test_a_graph_replayed_100_times_counts_100_launches_a_kernel(cuda, monkeypatch, case):
    """One captured step replayed 100 times by bare `CUDAGraph.replay()`
    calls (no wrapper runs): the wrappers' counts hold exactly 100 launches
    of each kernel the step launches eagerly, and of no other; a trace of
    the replays never counts more. The one eager step before them is traced
    too, and there the trace must equal the wrappers' counts: that holds
    `SYMBOLS`, the trace's names of the kernels, to the kernels run."""
    a, _, _ = _graph_ensemble(case, cuda, monkeypatch)
    xs = torch.randn((2, 256, 128), generator=torch.Generator(device=cuda).manual_seed(7), device=cuda)
    _reset_launches()
    _, eager_trace = traced(torch, lambda: a.step_batch(xs[0]))
    eager = _launches()
    per_step = {k: v for k, v in eager.items() if v}
    assert per_step and set(per_step.values()) == {1}, per_step
    assert eager_trace == {k: eager.get(k, 0) for k in SYMBOLS}
    a.step_scan(xs[1:])  # the eager first step of a capture, then the capture
    (g,) = a._graphs.values()
    _reset_launches()
    _, trace = traced(torch, lambda: [g.graph.replay() for _ in range(100)])
    counted = _launches()
    assert counted == {k: 100 if k in per_step else 0 for k in counted}
    _report_trace(trace, counted)


def test_graph_is_recaptured_when_what_it_froze_changes(cuda, monkeypatch):
    """A batch of another shape, `set_update_mask`, a host setting the step
    read (the warm-up length) and a state assigned from outside (as resume
    does) each lead to a new capture, an eager step does not, and the steps
    stay the eager steps' bits: a stale graph, which would step the old
    tensors or the old setting, is never replayed."""
    from _torch_moments import state_differences
    from sparse_coding__tpu_torch import Ensemble

    a, b, _ = _graph_ensemble("tied_bf16_mu", cuda, monkeypatch)
    g = torch.Generator(device=cuda).manual_seed(4)
    xs = torch.randn((15, 256, 128), generator=g, device=cuda)

    def both(batches, captures):
        la = a.step_scan(batches)
        lb = [b.step_batch(x)[0] for x in batches]
        assert a.captures == captures
        assert torch.equal(la["loss"], torch.stack([l["loss"] for l in lb]))
        assert state_differences(a.state, b.state) == []

    both(xs[0:3], 1)
    both(xs[3:5], 1)
    both(xs[5:7, :128], 2)  # another batch shape: a graph of its own
    both(xs[7:8], 2)  # the first graph's state is still the ensemble's
    # an eager step writes into the state's tensors: the graph stays valid
    assert torch.equal(a.step_batch(xs[8])[0]["loss"], b.step_batch(xs[8])[0]["loss"])
    both(xs[9:10], 2)
    a.set_update_mask([1.0, 0.0])
    b.set_update_mask([1.0, 0.0])
    both(xs[10:12], 3)
    a.l1_warmup_steps = b.l1_warmup_steps = 20
    both(xs[12:13], 4)
    # a state from outside: another ensemble's, stepped elsewhere
    c = Ensemble.from_state(b.state_dict(), sig=b.sig, device=cuda)
    c.step_batch(xs[13])
    a.state = Ensemble.from_state(c.state_dict(), sig=c.sig, device=cuda).state
    b.state = Ensemble.from_state(c.state_dict(), sig=c.sig, device=cuda).state
    both(xs[13:15], 5)


def test_graph_losses_do_not_alias_and_step_scan_idx_gathers_into_the_graph(cuda, monkeypatch):
    """Each call's [K, M] losses are its own (a later call leaves them as
    they were), and `step_scan_idx` gathers each batch into the graph's
    input with the eager gather's bits, K graph replays serving the whole
    groups and the remainder alike."""
    from _torch_moments import state_differences

    a, b, _ = _graph_ensemble("tied_bf16_mu", cuda, monkeypatch)
    g = torch.Generator(device=cuda).manual_seed(5)
    dataset = torch.randn((2048, 128), generator=g, device=cuda)
    idxs = torch.randperm(2048, generator=g, device=cuda)[: 7 * 256].reshape(7, 256)
    l1 = a.step_scan_idx(dataset, idxs[:4])
    kept = {k: v.clone() for k, v in l1.items()}
    l2 = a.step_scan_idx(dataset, idxs[4:6])
    l3 = a.step_scan_idx(dataset, idxs[6:7])
    assert a.captures == 1
    for k in kept:
        assert torch.equal(l1[k], kept[k]) and l1[k].data_ptr() != l2[k].data_ptr() != l3[k].data_ptr()
    lb = [b.step_batch(dataset[i])[0] for i in idxs]
    for k in kept:
        assert torch.equal(torch.cat([l1[k], l2[k], l3[k]]), torch.stack([l[k] for l in lb])), k
    assert state_differences(a.state, b.state) == []
    with pytest.raises(ValueError, match="shared-batch only"):
        a.step_scan_idx(dataset, idxs[:1], per_model=True)


def test_graph_replays_with_the_packs_are_eager_steps_across_a_flush(cuda, tmp_path):
    """With the health pack and the feature sketch on (bf16, so the tied
    signature would fuse but the packs keep it on autograd), K replays give
    K eager steps' bits: losses and every ``health_*`` metric, params, the
    firing EMA and the sketch. A flush reads the sketch and zeroes it in
    place: the graph stays valid (no recapture) and the next replays still
    match the eager steps. No fused kernel runs in them."""
    from _torch_moments import state_differences
    from sparse_coding__tpu_torch import Ensemble, FunctionalTiedSAE, build_ensemble
    from sparse_coding__tpu_torch.telemetry.feature_stats import FEATURE_STATS_KEYS, flush_ensemble_feature_stats

    a = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": 1e-3}, {"l1_alpha": 3e-3}], compute_dtype="bfloat16",
                       optimizer_kwargs={"learning_rate": LR}, health=True, feature_stats=True, device=cuda,
                       **_GRAPH_KW)
    b = Ensemble.from_state(a.state_dict(), sig=FunctionalTiedSAE, device=cuda)
    assert a.fused is False and b.fused is False and b.health == a.health
    xs = torch.randn((9, 256, 128), generator=torch.Generator(device=cuda).manual_seed(6), device=cuda)
    _reset_launches()
    la, ran = traced(torch, lambda: a.step_scan(xs[:4]))
    lb = [b.step_batch(x)[0] for x in xs[:4]]
    assert sum(ran.values()) == 0 and sum(_launches().values()) == 0
    assert {k for k in lb[0] if k.startswith("health_")} == {
        "health_grad_norm", "health_dict_norm", "health_nonfinite", "health_dead_frac"}
    for k in lb[0]:
        assert torch.equal(la[k], torch.stack([l[k] for l in lb])), k
    assert state_differences(a.state, b.state) == []
    ptrs = [a.state.buffers[k].data_ptr() for k in FEATURE_STATS_KEYS]
    sa = flush_ensemble_feature_stats(a, None, tmp_path)
    sb = flush_ensemble_feature_stats(b, None, tmp_path)
    assert sa["rows"] == sb["rows"] == 2 * 4 * 256
    assert [a.state.buffers[k].data_ptr() for k in FEATURE_STATS_KEYS] == ptrs
    la = a.step_scan(xs[4:])
    lb = [b.step_batch(x)[0] for x in xs[4:]]
    assert a.captures == 1
    for k in lb[0]:
        assert torch.equal(la[k], torch.stack([l[k] for l in lb])), k
    assert state_differences(a.state, b.state) == []
    assert a.state.buffers["featstat_rows"].tolist() == [5 * 256.0] * 2


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_world_of_one_on_the_card_is_dense(cuda, impl):
    """chip_smoke's ``seqpar_world1`` at seq 1024: ring and Ulysses attention
    on a world of one (p = 1, no collective) against dense attention (atol
    2e-5), and layer 2's residual of a random Pythia-70M through
    `make_sequence_parallel_fn` against the dense forward's (atol 2e-3)."""
    from sparse_coding__tpu_torch.lm import config_for, init_params, make_tensor_name, run_with_cache
    from sparse_coding__tpu_torch.lm.model import dense_attention
    from sparse_coding__tpu_torch.lm.ring_attention import ATTN_IMPLS, make_sequence_parallel_fn
    from sparse_coding__tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, 1, 1)
    g = torch.Generator(device=cuda).manual_seed(43)
    q, k, v = (torch.randn((1, 1024, 8, 64), generator=g, device=cuda) for _ in range(3))
    assert float((ATTN_IMPLS[impl]("data", mesh=mesh)(q, k, v) - dense_attention(q, k, v)).abs().max()) <= 2e-5
    cfg = config_for("pythia-70m")
    params = init_params(0, cfg, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=g, device=cuda)
    name = make_tensor_name(2, "residual")
    with torch.no_grad():
        want = run_with_cache(params, tokens, cfg, [name], stop_at_layer=3)[1][name]
        got = make_sequence_parallel_fn(cfg, mesh, cache_names=[name], stop_at_layer=3, attn=impl)(params, tokens)[1][name]
    assert got.shape == want.shape and float((got - want).abs().max()) <= 2e-3
    assert mesh.stats["calls"] == 0


def test_transfer_audit_passes_a_graph_route_chunk_and_catches_a_planted_pull(cuda, tmp_path):
    """`telemetry.audit.transfer_audit` over `ensemble_train_loop` on one
    chunk of the graph route (config 2's members at a small width, the
    graph captured on a warm-up chunk): sync-debug mode is ``"error"`` in
    the block and every sync the loop makes is a sanctioned one (the
    flush, the dead probe); an ``.item()`` planted in the loop raises
    `TransferViolation`; the mode in force before comes back after."""
    from sparse_coding__tpu_torch import FunctionalTiedSAE, build_ensemble
    from sparse_coding__tpu_torch.telemetry import TransferViolation, allowed_transfer, transfer_audit
    from sparse_coding__tpu_torch.train.loop import ensemble_train_loop
    from sparse_coding__tpu_torch.utils.logging import MetricLogger

    ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": a} for a in (1e-4, 1e-3)], activation_size=128,
                         n_dict_components=512, compute_dtype="bfloat16",
                         optimizer_kwargs={"learning_rate": 1e-3, "mu_dtype": "bfloat16"})
    assert ens.fused_adam is not None
    g = torch.Generator(device=cuda).manual_seed(0)
    chunk = torch.randn((32768, 128), generator=g, device=cuda)  # the permutation of 32k rows stays on the card
    logger = MetricLogger(out_dir=str(tmp_path), run_name="audit")
    ensemble_train_loop(ens, chunk, batch_size=256, key=1, logger=logger)  # captures the step's graph
    assert ens.captures == 1
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with transfer_audit():
            assert torch.cuda.get_sync_debug_mode() == 2
            ensemble_train_loop(ens, chunk, batch_size=256, key=2, logger=logger)
            with allowed_transfer():
                assert torch.cuda.get_sync_debug_mode() == 0
        assert torch.cuda.get_sync_debug_mode() == 1 and ens.captures == 1
        leak = lambda i, n: ens.state.params["encoder"].sum().item()  # noqa: E731
        with pytest.raises(TransferViolation):
            with transfer_audit():
                ensemble_train_loop(ens, chunk, batch_size=256, key=3, progress_callback=leak, dead_check=False)
        with pytest.raises(TransferViolation, match="synchronizing"):
            with transfer_audit():
                torch.nonzero(chunk[:8] > 0)  # an implicit sync the interposer cannot see
    finally:
        torch.cuda.set_sync_debug_mode(0)
    logger.close()
