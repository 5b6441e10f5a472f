"""3×TF32 tensor-core splitting, emulated on the CPU, held against the plain
FISTA loop: what a tensor-core K_f would give before any card time is spent.

Each float32 operand v splits into hi = tf32_rna(v) and lo = tf32_rna(v −
hi) (TF32 keeps 10 mantissa bits; rna rounds to nearest, ties away from
zero, done here on the bits), and a product is lo·hi + hi·lo, then hi·hi,
each term in float32 — the scheme of CUTLASS's "fast f32" multiply-add. The
emulated solve runs `models.fista.run_fista_iterations` with the plain
loop's epilogue; it is a test helper, never part of the package.

Held to `chip_smoke.py`'s K_f tolerances: codes within 1e-4 at row 8's shape
(M 2, B 256, N 512, D 128, 100 iterations) and 1e-3 at a depth cut of
BASELINE config 3 (full widths N 2048, D 512, four members, 20 iterations,
256 rows), support flips under 1e-3, ‖res‖² within 1e-4, and the same
iteration count for each member at tol = 1e-3. At config 3's full 500
iterations the support flips exceed 1e-3, as they do for any other order
of the float32 sums (`scripts/fista_probe.py --order-study`): that is why
K_f keeps the plain loop's FMA chains instead.
"""

import numpy as np
import pytest
import torch

from sparse_coding__tpu_torch.models import fista as tf


def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (10 mantissa bits), ties away from
    zero, by rounding the bit pattern: add half of the dropped 13 bits'
    unit to the magnitude, then clear them. Inf and NaN pass through."""
    bits = v.view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(v), rounded, bits).view(torch.float32)


def split(v: torch.Tensor):
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, al = split(a)
    bh, bl = split(b)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(ah, bh)


def emulated_codes(batch, learned_dict, eta, l1_coef, c0, num_iter, tol=0.0):
    """`models.fista.fista_codes` with both products in 3×TF32."""
    mom = tf.momentum_table(num_iter)
    eta3 = eta.reshape(-1, 1, 1)
    thr3 = (eta * l1_coef).reshape(-1, 1, 1)
    dt = learned_dict.transpose(1, 2)

    def update(ahat, ahat_y, i):
        res = batch - mm_3xtf32(ahat_y, learned_dict)
        ahat_y = ahat_y + eta3 * mm_3xtf32(res, dt)
        ahat_new = torch.clamp_min(ahat_y - thr3, 0.0)
        return ahat_new, ahat_new + (ahat_new - ahat) * float(mom[i])

    return tf.run_fista_iterations(update, c0, num_iter, tol, eta)


def _problem(M, B, N, D, seed, l1, shared_dict=False):
    """`chip_smoke.fista_problem`'s problem, drawn with numpy: unit-norm
    dictionaries, sparse non-negative mixtures of member 0's rows plus
    noise, a non-negative warm start."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((1 if shared_dict else M, N, D)).astype(np.float32)
    d = np.broadcast_to(d / np.linalg.norm(d, axis=-1, keepdims=True), (M, N, D)).copy()
    codes = (0.5 + rng.random((B, N), dtype=np.float32)) * (rng.random((B, N)) < 0.01)
    x = codes.astype(np.float32) @ d[0] + 0.01 * rng.standard_normal((B, D)).astype(np.float32)
    c0 = np.maximum(rng.standard_normal((M, B, N)).astype(np.float32), 0) * 0.05
    return (torch.from_numpy(x.astype(np.float32)), torch.from_numpy(d), torch.from_numpy(c0),
            torch.tensor(l1, dtype=torch.float32))


def _agreement(a_e, a_p, x, d):
    diff = float((a_e - a_p).abs().max())
    flips = float(((a_e > 0) != (a_p > 0)).float().mean())
    re, rp = [float(((x - torch.matmul(a, d)) ** 2).sum()) for a in (a_e, a_p)]
    return diff, flips, abs(re - rp) / rp


def test_tf32_rna_rounds_to_ten_mantissa_bits():
    v = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 3.0e38, float("inf"), float("nan")])
    r = tf32_rna(v)
    want = [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]
    assert r[:6].tolist() == want  # exact, ties away from zero (both signs), below half rounds down
    assert bool(torch.isfinite(r[6])) and r[7] == float("inf") and bool(torch.isnan(r[8]))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(10_000).astype(np.float32))
    hi, lo = split(x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all()) and bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -21


@pytest.mark.parametrize("warm", [False, True])
def test_3xtf32_solve_is_within_k_f_tolerances_at_row_8(warm):
    x, d, c0, l1 = _problem(2, 256, 512, 128, seed=11, l1=[1e-4, 3e-4])
    eta = tf.default_eta(d)
    c = c0 if warm else torch.zeros_like(c0)
    a_e, it_e = emulated_codes(x, d, eta, l1, c, 100)
    a_p, _ = tf.fista_codes(x, d, eta, l1, c, 100)
    diff, flips, res_rel = _agreement(a_e, a_p, x, d)
    assert it_e.tolist() == [100, 100]
    assert diff <= 1e-4 and flips < 1e-3 and res_rel <= 1e-4, (diff, flips, res_rel)


def test_3xtf32_solve_is_within_k_f_tolerances_at_a_depth_cut_of_config_3():
    x, d, c0, l1 = _problem(4, 256, 2048, 512, seed=12, l1=[1e-4, 3e-4, 1e-3, 3e-3])
    eta = tf.default_eta(d)
    a_e, _ = emulated_codes(x, d, eta, l1, c0, 20)
    a_p, _ = tf.fista_codes(x, d, eta, l1, c0, 20)
    diff, flips, res_rel = _agreement(a_e, a_p, x, d)
    assert diff <= 1e-3 and flips < 1e-3 and res_rel <= 1e-4, (diff, flips, res_rel)


def test_3xtf32_solve_stops_each_member_at_the_plain_loops_iteration():
    """One dictionary for three members, l1 apart (30x config 3's grid, as
    chip_smoke's early-exit solve): each stops at its own iteration under
    tol = 1e-3, the same in both."""
    x, d, _, l1 = _problem(3, 128, 512, 128, seed=13, l1=[3e-3, 9e-3, 3e-2], shared_dict=True)
    eta = tf.default_eta(d)
    z = torch.zeros((3, 128, 512))
    a_e, it_e = emulated_codes(x, d, eta, l1, z, 500, tol=1e-3)
    a_p, it_p = tf.fista_codes(x, d, eta, l1, z, 500, tol=1e-3)
    assert it_e.tolist() == it_p.tolist() and max(it_p.tolist()) < 500, (it_e, it_p)
    diff, flips, res_rel = _agreement(a_e, a_p, x, d)
    assert diff <= 1e-4 and flips < 1e-3 and res_rel <= 1e-4, (diff, flips, res_rel)
