"""The port's TopK kernel entries (plain versions on the CPU) against the JAX
package's Pallas entries in interpret mode, on the same numpy inputs.

Shapes are those of tests/test_topk_fused.py: M, B, N, D = 2, 256, 512, 128,
k = (7, 31). Tolerances, and why:
  - l_rec rtol 1e-3: the sums run in another order;
  - gradients and moments: cosine > 0.9999, max error 1e-2 of the max: a
    flipped bf16 rounding of a score, dc or dxh moves a few entries;
  - Adam-updated dictionary: |diff| <= 2 lr, Adam's bound on one step;
  - the select: EXACT — the threshold is the k-th largest of the given bf16
    scores, and the code keeps every score tied with it;
  - c and dxh against the Pallas forward: c within 1 bf16 ulp (or f32 noise
    across zero) with < 0.1% differing, dxh the same with < 1%.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_grads_close, bf16_close, jax_to_torch, to_np
from sparse_coding__tpu.ops import topk_kernel as jk
from sparse_coding__tpu_torch.ops import topk_kernel as kk

M, B, N, D = 2, 256, 512, 128
KS = (7, 31)
LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    d_raw = rng.standard_normal((M, N, D)).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    return d_raw, x


def _t(a):
    return torch.from_numpy(np.array(a))


def test_grads_stacked_matches_jax_interpret():
    d_raw, x = _inputs(0)
    g_ref, l_ref = jk.topk_grads_stacked(
        jnp.asarray(d_raw), jnp.asarray(KS, jnp.int32), jnp.asarray(x), interpret=True
    )
    g, l_rec = kk.topk_grads_stacked(_t(d_raw), torch.tensor(KS), _t(x))
    assert g.shape == (M, N, D) and g.dtype == torch.float32
    assert_grads_close(g, g_ref, "g_dict")
    np.testing.assert_allclose(to_np(l_rec), np.asarray(l_ref), rtol=1e-3)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_adam_step_stacked_matches_jax_interpret(mu_dtype):
    d_raw, x = _inputs(1)
    rng = np.random.default_rng(2)
    mu = (1e-3 * rng.standard_normal((M, N, D))).astype(np.float32)
    nu = (1e-6 * rng.uniform(size=(M, N, D))).astype(np.float32)
    bc = np.tile(np.asarray([[0.1, 0.001]], np.float32), (M, 1))
    jdt = jnp.bfloat16 if mu_dtype == "bfloat16" else jnp.float32
    ref = jk.topk_adam_step_stacked(
        jnp.asarray(d_raw), jnp.asarray(mu, jdt), jnp.asarray(nu), jnp.asarray(x),
        jnp.asarray(KS, jnp.int32), jnp.asarray(bc), jnp.asarray([7], jnp.int32),
        LR, B1, B2, EPS, interpret=True,
    )
    tdt = getattr(torch, mu_dtype)
    got = kk.topk_adam_step_stacked(
        _t(d_raw), _t(mu).to(tdt), _t(nu), _t(x), torch.tensor(KS, dtype=torch.int32), _t(bc), 7,
        LR, B1, B2, EPS,
    )
    assert got[1].dtype == tdt
    assert np.abs(to_np(got[0]) - to_np(ref[0])).max() <= 2 * LR
    assert_grads_close(got[1], ref[1], "mu")
    assert_grads_close(got[2], ref[2], "nu")
    np.testing.assert_allclose(to_np(got[3]), np.asarray(ref[3]), rtol=1e-3)


def test_fwd_code_and_cotangent_match_the_pallas_forward():
    """K_s + K_d's plain versions against the Pallas `_topk_fwd` on the same
    bf16 rows: c and dxh within the rounding of the scores' sums."""
    d_raw, x = _inputs(3)
    dj = jnp.asarray(d_raw)
    db = (dj / jnp.sqrt(jnp.sum(dj * dj, axis=-1))[..., None]).astype(jnp.bfloat16)
    _, c_ref, dxh_ref, lrec_ref = jk._topk_fwd(db, jnp.asarray(KS, jnp.int32), jnp.asarray(x), 256, 256, True)
    xb = _t(x).to(torch.bfloat16)
    s, thresh = kk.topk_scores(xb, jax_to_torch(db), torch.tensor(KS, dtype=torch.int32))
    c, dxh, lrec = kk.topk_decode(s, thresh, jax_to_torch(db), xb, 2.0 / (B * D))
    assert c.dtype == dxh.dtype == torch.bfloat16 and thresh.shape == (M, B)
    frac, ok = bf16_close(c, c_ref)
    assert ok and frac < 1e-3, (frac, ok)
    frac, ok = bf16_close(dxh, dxh_ref)
    assert ok and frac < 1e-2, (frac, ok)
    np.testing.assert_allclose(to_np(lrec), np.asarray(lrec_ref)[:, 0], rtol=1e-3)
    # every row keeps at least min(k, #positive scores) entries
    for m, k in enumerate(KS):
        kept = (to_np(c[m]) != 0).sum(-1)
        pos = (to_np(s[m]) > 0).sum(-1)
        assert (kept >= np.minimum(k, pos)).all()


def _hand_rows():
    """bf16 rows with ties at, above and below the k-th value, negatives and
    both zeros; returns (s [1, R, N] bf16, k per case)."""
    rows = [
        [3.0, 1.0, 2.0, 2.0, 2.0, 0.5, -1.0, 0.0],   # ties at the 2nd..4th value
        [1.0, 1.0, 1.0, 1.0, 0.5, 0.5, 0.25, -2.0],  # ties above the k-th
        [-0.0, 0.0, -0.0, 0.0, -1.0, -3.0, -0.5, -0.0],  # zeros of both signs
        [-1.0, -2.0, -2.0, -3.0, -4.0, -0.5, -0.5, -8.0],  # all negative
        [0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5],    # all equal
    ]
    return torch.tensor(rows, dtype=torch.float32).to(torch.bfloat16)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8])
def test_select_is_the_exact_kth_largest_and_keeps_ties(k):
    s = _hand_rows()[None]
    thresh = kk._select_plain(s, torch.tensor([k]))
    vals = to_np(s[0])
    expect = np.sort(vals, axis=-1)[:, vals.shape[1] - k]
    np.testing.assert_array_equal(to_np(thresh[0]), expect)  # -0.0 == 0.0 here
    # the code keeps every score tied with the threshold (and > 0)
    c, _, _ = kk._topk_decode_plain(s, thresh, torch.zeros((1, 8, 4), dtype=torch.bfloat16),
                                    torch.zeros((5, 4), dtype=torch.bfloat16), 1.0)
    keep = (vals >= expect[:, None]) & (vals > 0)
    np.testing.assert_array_equal(to_np(c[0]), np.where(keep, vals, 0.0))
    assert ((to_np(c[0]) != 0).sum(-1) >= np.minimum(k, (vals > 0).sum(-1))).all()


def test_ordered_keys_are_the_pallas_keys_and_invert():
    bits = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(torch.int16)
    sb = bits.view(torch.bfloat16)
    keys = kk._ordered(sb)
    ref = np.asarray(jk._ordered_i32(jnp.asarray(np.asarray(bits.numpy()).view(jnp.bfloat16))))
    np.testing.assert_array_equal(keys.numpy(), ref)
    assert torch.equal(kk._unordered(keys).view(torch.int16), bits)
    # integer order is float order on every non-NaN value
    f = sb.float()
    fin = ~torch.isnan(f)
    order = torch.argsort(keys[fin])
    assert bool((f[fin][order][1:] >= f[fin][order][:-1]).all())


def test_shape_predicate_and_refusals():
    assert kk.shapes_supported(12288, 768, 2048)  # BASELINE config 4
    assert kk.shapes_supported(512, 128, 256)
    assert not kk.shapes_supported(12288, 640)  # width outside the bwd tiling
    assert not kk.shapes_supported(12288 + 64, 768)  # N not a multiple of 128
    assert not kk.shapes_supported(12288, 768, 1000)  # B not a multiple of 64
    assert not kk.shapes_supported(131072, 128)  # one row of keys exceeds shared memory
    d_raw, x = _inputs(4)
    with pytest.raises(ValueError, match="not covered"):
        kk.topk_grads_stacked(_t(d_raw), torch.tensor(KS), _t(x[:200]))


def test_cpu_tensors_never_reach_the_kernel_build(monkeypatch):
    from sparse_coding__tpu_torch.ops import _build
    from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk

    def no_build():
        raise AssertionError("kernel build reached with CPU tensors")

    monkeypatch.setattr(_build, "load", no_build)
    kk.reset_launches()
    tk.reset_launches()
    d_raw, x = _inputs(5)
    kk.topk_grads_stacked(_t(d_raw), torch.tensor(KS), _t(x))
    assert kk.LAUNCHES == {"topk_scores": 0, "topk_decode": 0}
    assert sum(tk.LAUNCHES.values()) == 0
