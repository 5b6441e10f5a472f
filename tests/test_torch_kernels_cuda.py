"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card, at a small shape and at the main path's full shape. Needs an NVIDIA
GPU with nvcc; skips (inside each test) without one. On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

Tolerances as in chip_smoke.py: c within 1 bf16 ulp (or f32 noise across
zero) with < 0.1% differing, dxh the same with < 1% (4096-term sums in
another order), gradients cosine > 0.9999 and max error 1e-2 of the max,
the Adam-updated encoder within 2 lr.
"""

import pytest
import torch

from _torch_parity import assert_grads_close, bf16_close
from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk

pytestmark = pytest.mark.cuda

# M, B, N, D: every width the kernels take (D 1024 runs 16-row batch stages),
# then the main path's full shape
SHAPES = [(2, 256, 512, 128), (2, 128, 256, 256), (2, 256, 256, 1024), (8, 2048, 4096, 512)]
LR = 1e-3


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


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
def test_bwd_adam_kernel_matches_plain(cuda, shape, mu_dtype):
    M, B, N, D = shape
    d_raw, bias, xb, nrm, db, l1b = _inputs(shape, cuda, seed=1)
    c, dxh, _, _ = tk._fwd_plain(xb, db, bias, 2.0 / (B * D))
    g = torch.Generator(device=cuda).manual_seed(2)
    mu = (torch.randn((M, N, D), generator=g, device=cuda) * 1e-3).to(mu_dtype)
    nu = torch.rand((M, N, D), generator=g, device=cuda) * 1e-6
    bc = torch.tensor([[0.1, 0.001]] * M, device=cuda)
    hp = (LR, 0.9, 0.999, 1e-8)
    d_k, mu_k, nu_k = d_raw.clone(), mu.clone(), nu.clone()
    out = tk.tied_sae_bwd_adam(xb, dxh, c, nrm, d_k, mu_k, nu_k, l1b, bc, *hp)
    torch.cuda.synchronize()
    assert out[0] is d_k and out[1] is mu_k and out[2] is nu_k  # updated in place
    dj = (d_raw / nrm[..., None]).to(torch.bfloat16)
    gr, gb_p = tk._grads_plain(xb, dxh, c, nrm, dj, l1b)
    d_p, mu_p, nu_p = tk._adam_plain(gr, d_raw, mu, nu, bc, *hp)
    assert (out[0] - d_p).abs().max() <= 2 * LR
    assert_grads_close(out[1].float(), mu_p.float(), "mu")
    assert_grads_close(out[2], nu_p, "nu")
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
