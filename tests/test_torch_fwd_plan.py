"""The shapes the forward kernels K_s (TMA + `wgmma` scores, register
select), K_d (sparse decode), K1n and K1 (the pipelined encode → decode, K1
with its code stored) take, as the Python side states them, on the CPU.

Each must take every (N, D, B) it took in its first design: K_s and K_d the
forward output tiles of `csrc/wmma_tile.cuh` (B % 64, N % 128, D % 128)
with one row of N 16-bit keys for K_s's select in a block's shared memory;
K1n the tied kernels' widths with 64-row blocks and dictionary tiles at
D ≤ 512 and 32-row ones at 768 and 1024; K1 the tied kernels' widths with
the WMMA tiles (64 x 128), 768 and 1024 included, whichever kernel runs
them now. CPU tensors run the plain versions and never reach the kernel
build.
"""

import numpy as np
import pytest
import torch

from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
from sparse_coding__tpu_torch.ops import topk_kernel as kk
from sparse_coding__tpu_torch.ops._wrap import MAX_SMEM

BATCHES = (64, 128, 320, 2048, 4096)


def _old_kd_supported(n: int, d: int, b: int) -> bool:
    return n % 128 == 0 and d % 128 == 0 and 2 * n + 2048 <= MAX_SMEM and b % 64 == 0


def _old_k1_supported(n: int, d: int, b: int) -> bool:
    return d in (128, 256, 512, 768, 1024) and n % 128 == 0 and b % 64 == 0


def _old_k1n_supported(n: int, d: int, b: int) -> bool:
    rows = 64 if d <= 512 else 32
    return d in (128, 256, 512, 768, 1024) and n % 128 == 0 and n % rows == 0 and b % 64 == 0 and b % rows == 0


@pytest.mark.parametrize("d", [128, 256, 384, 512, 768, 1024, 1152, 1280, 2048])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 32, 96, 448])
def test_topk_decode_takes_every_shape_it_took_before(d, k):
    """N at k multiples of 128 up to the select's shared-memory row, every
    multiple-of-128 width (past one 1024-column register pass too), B at
    several multiples of 64: all still taken."""
    n = 128 * k
    for b in BATCHES:
        assert _old_kd_supported(n, d, b)
        assert kk.fwd_shapes_supported(n, d, b), (n, d, b)


def _covered_once(extent: int, tile: int, piece: int) -> bool:
    """Along one axis of s, K_s's GEMM stores tiles of ``tile`` starting at
    every multiple of it below ``extent``, each in pieces of ``piece`` kept
    only where the piece starts inside the extent (scores_kernel's masks):
    every index is stored exactly once."""
    hits = np.zeros(extent + tile, np.int64)
    for t0 in range(0, extent, tile):
        for p0 in range(t0, t0 + tile, piece):
            if p0 < extent:
                hits[p0:p0 + piece] += 1
    return bool((hits[:extent] == 1).all() and not hits[extent:].any())


@pytest.mark.parametrize("d", [128, 256, 384, 512, 768, 1024, 1152, 1280, 2048])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 32, 96, 448])
def test_topk_scores_take_every_shape_they_took_before(d, k):
    """K_s's first design took the WMMA tiles' multiples (B % 64, N % 128,
    D % 128) with one row of N 16-bit keys in a block's shared memory. Its
    TMA + `wgmma` GEMM (128 × 256 tiles, 64-deep stages, the edges masked)
    and its select (keys in registers, a longer row in pieces) take every
    one of them, and the GEMM's masked tiles store each score once: rows in
    tiles of 128 (one row a thread), columns in tiles of 256 stored 32 at a
    time."""
    n = 128 * k
    assert d % 64 == 0  # whole 64-deep stages
    assert _covered_once(n, 256, 32)
    for b in BATCHES:
        assert _old_kd_supported(n, d, b)  # K_s's first design's predicate (K_d shared it)
        assert kk.fwd_shapes_supported(n, d, b), (n, d, b)
        assert _covered_once(b, 128, 1)


@pytest.mark.parametrize("d", sorted(tk.WIDTHS))
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 32, 96])
def test_fwd_nocode_takes_every_shape_it_took_before(d, k):
    n = 128 * k
    for b in BATCHES:
        assert _old_k1n_supported(n, d, b)
        assert tk.nocode_shapes_supported(n, d, b), (n, d, b)


@pytest.mark.parametrize("d", sorted(tk.WIDTHS))
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 32, 96])
def test_fwd_takes_every_shape_it_took_before(d, k):
    """K1 at D ≤ 512 runs on the pipelined kernel (64-row blocks, 64-row
    dictionary stages), at 768 and 1024 on its WMMA kernels: every shape
    its first design took is still taken, and its route follows D alone."""
    n = 128 * k
    for b in BATCHES:
        assert _old_k1_supported(n, d, b)
        assert tk.shapes_supported(n, d, b), (n, d, b)
        assert b % tk.nocode_tile(d)[0] == 0 and n % tk.nocode_tile(d)[1] == 0
    assert (d <= tk.PIPELINED_MAX_D) == (d in (128, 256, 512))


@pytest.mark.parametrize("d", sorted(tk.WIDTHS))
def test_fwd_refuses_what_its_first_design_refused(d):
    assert tk.shapes_supported(4096, d, 2048)
    assert not tk.shapes_supported(4096 + 64, d, 2048)
    assert not tk.shapes_supported(4096, d, 2048 + 32)
    assert not tk.shapes_supported(4096, d + 64, 2048)


def test_cpu_tensors_of_k1_never_reach_the_kernel_build(monkeypatch):
    """K1's wrapper given CPU tensors runs its plain version (both halves:
    the code, then the decode on it) and counts no launch."""
    from sparse_coding__tpu_torch.ops import _build

    def no_build():
        raise AssertionError("kernel build reached with CPU tensors")

    monkeypatch.setattr(_build, "load", no_build)
    tk.reset_launches()
    rng = np.random.default_rng(1)
    M, B, N, D = 2, 64, 256, 128
    d = torch.tensor(rng.standard_normal((M, N, D)), dtype=torch.float32)
    db = (d / d.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    xb = torch.tensor(rng.standard_normal((B, D)), dtype=torch.float32).to(torch.bfloat16)
    bias = torch.tensor(rng.standard_normal((M, N)) * 0.01, dtype=torch.float32)
    c, dxh, lrec, ll1 = tk.tied_sae_fwd(xb, db, bias, 2.0 / (B * D))
    c_p, ll1_p = tk._encode_plain(xb, db, bias)
    dxh_p, lrec_p = tk._decode_plain(xb, db, c_p, 2.0 / (B * D))
    assert torch.equal(c, c_p) and torch.equal(dxh, dxh_p)
    assert torch.equal(lrec, lrec_p) and torch.equal(ll1, ll1_p)
    assert tk.LAUNCHES["tied_sae_fwd"] == 0


@pytest.mark.parametrize("d", sorted(tk.WIDTHS))
def test_fwd_nocode_refuses_ragged_shapes(d):
    assert tk.nocode_shapes_supported(4096, d, 2048)
    assert not tk.nocode_shapes_supported(4096 + 64, d, 2048)
    assert not tk.nocode_shapes_supported(4096, d, 2048 + 32)
    assert not tk.nocode_shapes_supported(4096, d + 64, 2048)


def test_topk_decode_refuses_ragged_shapes():
    assert not kk.fwd_shapes_supported(12288 + 64, 768, 2048)
    assert not kk.fwd_shapes_supported(12288, 768 + 64, 2048)
    assert not kk.fwd_shapes_supported(12288, 768, 2048 + 32)
    assert not kk.fwd_shapes_supported(128 * 1024, 768, 2048)  # the select's row no longer fits


def test_cpu_tensors_of_k_d_and_k1n_never_reach_the_kernel_build(monkeypatch):
    """K_d's and K1n's wrappers given CPU tensors run their plain versions
    and count no launch."""
    from sparse_coding__tpu_torch.ops import _build

    def no_build():
        raise AssertionError("kernel build reached with CPU tensors")

    monkeypatch.setattr(_build, "load", no_build)
    tk.reset_launches()
    kk.reset_launches()
    rng = np.random.default_rng(0)
    M, B, N, D = 2, 64, 256, 128
    d = torch.tensor(rng.standard_normal((M, N, D)), dtype=torch.float32)
    db = (d / d.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    xb = torch.tensor(rng.standard_normal((B, D)), dtype=torch.float32).to(torch.bfloat16)
    bias = torch.tensor(rng.standard_normal((M, N)) * 0.01, dtype=torch.float32)
    dxh, lrec, ll1 = tk.tied_sae_fwd_nocode(xb, db, bias, 2.0 / (B * D))
    assert dxh.shape == (M, B, D) and lrec.shape == (M,) and ll1.shape == (M,)
    s, thresh = kk.topk_scores(xb, db, torch.tensor([3, 17], dtype=torch.int32))
    c, dxh, lrec = kk.topk_decode(s, thresh, db, xb, 2.0 / (B * D))
    assert c.shape == (M, B, N) and int((c != 0).sum(-1).min()) >= 3
    assert tk.LAUNCHES["tied_sae_fwd_nocode"] == 0
    assert kk.LAUNCHES == {"topk_scores": 0, "topk_decode": 0}
