"""The TopK step's compressed moments: the port's `topk_adam_step_stacked`
(plain versions on the CPU; K2 at l1 = 0 on the card) against the JAX
package's in interpret mode, in the bf16, int8 and capacity (int8 mu, bf16
nu) tiers, on the same numpy inputs.

Shapes are those of tests/test_topk_fused.py: M, B, N, D = 2, 256, 512, 128,
k = (7, 31). The stochastic stores seed over the JAX TopK step's 128-row
dictionary tiles. Tolerances as in tests/test_torch_capacity_kernels.py:
d_new within 2 lr (plus 1% of the update, for int8 nu's collapsed
denominators); int8 codes and bf16 nu equal in >= 99% of elements, codes
never more than one step apart; l_rec rtol 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_moment_tracks, moment_pair, to_np
from sparse_coding__tpu.ops import topk_kernel as jk
from sparse_coding__tpu_torch.ops import topk_kernel as kk

M, B, N, D = 2, 256, 512, 128
KS = (7, 31)
LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8
TIERS = {"bf16": ("bfloat16", "bfloat16"), "int8": ("int8", "int8"), "capacity": ("int8", "bfloat16")}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_topk_step_matches_jax_interpret_in_compressed_tiers(tier):
    rng = np.random.default_rng(21)
    d_raw = rng.standard_normal((M, N, D)).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    mu = (1e-3 * rng.standard_normal((M, N, D))).astype(np.float32)
    nu = (1e-6 * rng.uniform(size=(M, N, D))).astype(np.float32)
    bc = np.tile(np.asarray([[0.1, 0.001]], np.float32), (M, 1))
    mu_t, nu_t = TIERS[tier]
    (jmu, tmu), (jnu, tnu) = moment_pair(mu, mu_t), moment_pair(nu, nu_t)
    ref = jk.topk_adam_step_stacked(
        jnp.asarray(d_raw), jmu, jnu, jnp.asarray(x), jnp.asarray(KS, jnp.int32), jnp.asarray(bc),
        jnp.asarray([7], jnp.int32), LR, B1, B2, EPS, interpret=True,
    )
    got = kk.topk_adam_step_stacked(
        torch.from_numpy(d_raw), tmu, tnu, torch.from_numpy(x), torch.tensor(KS, dtype=torch.int32),
        torch.from_numpy(bc), 7, LR, B1, B2, EPS,
    )
    # Adam's bound on one step, plus 1% of the update: where an int8 nu
    # stores 0 (the denominator collapse of THROUGHPUT §r6b), the update is
    # ~lr·m̂/|g| and carries the two sides' gradient difference amplified
    upd = np.abs(to_np(ref[0]) - d_raw)
    assert (np.abs(to_np(got[0]) - to_np(ref[0])) - 1e-2 * upd).max() <= 2 * LR
    assert_moment_tracks(got[1], ref[1], f"{tier} mu", bf16_stochastic=False)
    assert_moment_tracks(got[2], ref[2], f"{tier} nu")
    np.testing.assert_allclose(to_np(got[3]), np.asarray(ref[3]), rtol=1e-3)
