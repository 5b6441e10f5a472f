"""The capacity setting's kernel pieces (plain versions on the CPU) against
the JAX package: the stochastic stores bit for bit, and the fused tied-SAE
step in every moment tier, with and without the code rebuild, against
`tied_sae_adam_step_stacked(..., interpret=True)`.

Shapes are those of tests/test_fused_signatures.py: M, B, N, D = 2, 256,
512, 128. Tolerances, and why:
  - the stores (`mix32`, `_uniform_bits`, `_quantize_rows_int8_sr`,
    `_stochastic_round_bf16` in interpret mode): EXACT, non-finite rows
    included — the port runs the same counter hash on the same f32 input;
  - the fused step: d_new within 2 lr (Adam's bound on one step); int8 codes
    and bf16 nu bit patterns equal in >= 99% of elements (the stream is the
    same; the f32 gradient sums differ in order, which moves a few values
    across a rounding boundary — independent streams agree on about half),
    int8 codes never more than one step apart; losses rtol 1e-3;
  - the rebuild: bit-identical to the stored-code step inside the port.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_moments import moment_parts
from _torch_parity import assert_grads_close, assert_moment_tracks, moment_pair, to_np
from sparse_coding__tpu.ops import tied_sae_kernel as jk
from sparse_coding__tpu_torch.ops import tied_sae_kernel as tk
from sparse_coding__tpu_torch.utils import optim

M, B, N, D = 2, 256, 512, 128
LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8
# (mu, nu) storage tiers: the JAX suite's three, and the capacity setting
TIERS = {
    "f32": ("float32", "float32"),
    "bf16": ("bfloat16", "bfloat16"),
    "int8": ("int8", "int8"),
    "capacity": ("int8", "bfloat16"),
}


def _special_rows(seed: int, cols: int = 128) -> np.ndarray:
    """Rows at many scales, then rows holding NaN, ±inf, all zeros and a
    huge finite outlier."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((12, cols)) * 10.0 ** rng.uniform(-8, 3, (12, 1))).astype(np.float32)
    x[0, 3] = np.nan
    x[1, 5] = np.inf
    x[2, 7] = -np.inf
    x[3, :] = 0.0
    x[4, 0], x[4, 1] = np.nan, np.inf
    x[5, 0] = 3.4e38
    x[6, :] = np.nan
    return x


def test_mix32_is_bit_exact():
    h = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64)
    ref = np.asarray(jk._mix32(jnp.asarray(h.astype(np.uint32))))
    got = optim.mix32(torch.from_numpy(h.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7, 0xDEADBEEF])
def test_uniform_bits_are_bit_exact(seed):
    ref = np.asarray(jk._uniform_bits((64, 96), jnp.uint32(seed), hw_prng=False))
    got = optim.uniform_bits(64, 96, seed)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("seed", [3, 0x5117A55A])
def test_int8_store_is_bit_exact_with_nonfinite_rows(seed):
    x = _special_rows(seed)
    q_ref, s_ref = jk._quantize_rows_int8_sr(jnp.asarray(x), jnp.uint32(seed), hw_prng=False)
    got = optim.quantize_rows_stochastic(torch.from_numpy(x), optim.uniform_bits(*x.shape, seed))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(s_ref)[:, 0])
    # the documented non-finite cases: a NaN row has scale 1 and stores 0 at
    # its NaN; an inf absmax gives scale inf; all zeros give scale 1
    assert got.scale[0] == 1.0 and got.q[0, 3] == 0 and torch.isinf(got.scale[1])
    assert got.scale[3] == 1.0 and not got.q[3].any()


@pytest.mark.parametrize("seed", [5, 0xA11CE5])
def test_bf16_store_is_bit_exact_with_nonfinite_rows(seed):
    x = _special_rows(seed)
    ref = np.asarray(jk._stochastic_round_bf16(jnp.asarray(x), jnp.uint32(seed), hw_prng=False))
    got = optim.stochastic_round(torch.from_numpy(x), optim.uniform_bits(*x.shape, seed))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), ref.view(np.int16))


@pytest.mark.parametrize("salt", [tk.SALT_MU_INT8, tk.SALT_NU_INT8, tk.SALT_NU_BF16])
def test_tile_bits_are_the_pallas_tiles_streams(salt):
    """`tile_bits` over [M, N, D] is `_adam_epilogue`'s per-tile stream:
    tile j of member m draws `_uniform_bits((Ns, D), mix32(base ^ salt))`."""
    seed, ns = 9, tk.TIED_SEED_TILE
    got = tk.tile_bits((M, N, D), seed, salt, ns)
    u32 = jnp.uint32
    for m in range(M):
        for j in range(N // ns):
            base = u32(seed) ^ (u32(m) * u32(0x9E3779B9)) ^ (u32(j) * u32(0x7FEB352D))
            ref = jk._uniform_bits((ns, D), jk._mix32(base ^ u32(salt)), hw_prng=False)
            np.testing.assert_array_equal(got[m, j * ns:(j + 1) * ns].numpy(),
                                          np.asarray(ref).astype(np.int64))


def _inputs():
    rng = np.random.default_rng(11)
    lim = np.sqrt(6.0 / (N + D))
    d_raw = rng.uniform(-lim, lim, (M, N, D)).astype(np.float32)
    bias = (0.01 * rng.standard_normal((M, N))).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    l1 = np.asarray([1e-3, 3e-3], np.float32)
    mu = (1e-3 * rng.standard_normal((M, N, D))).astype(np.float32)
    nu = (1e-6 * rng.uniform(size=(M, N, D))).astype(np.float32)
    bc = np.tile(np.asarray([[0.1, 0.001]], np.float32), (M, 1))
    return d_raw, bias, x, l1, mu, nu, bc


@functools.lru_cache(maxsize=None)
def _jax_step(tier: str):
    d_raw, bias, x, l1, mu, nu, bc = _inputs()
    mu_t, nu_t = TIERS[tier]
    return jk.tied_sae_adam_step_stacked(
        jnp.asarray(d_raw), jnp.asarray(bias), moment_pair(mu, mu_t)[0], moment_pair(nu, nu_t)[0],
        jnp.asarray(x), jnp.asarray(l1), jnp.asarray(bc), jnp.asarray([7], jnp.int32),
        LR, B1, B2, EPS, interpret=True,
    )


def _port_step(tier: str, recompute: bool):
    d_raw, bias, x, l1, mu, nu, bc = _inputs()
    mu_t, nu_t = TIERS[tier]
    t = torch.from_numpy
    return tk.tied_sae_adam_step_stacked(
        t(d_raw), t(bias), moment_pair(mu, mu_t)[1], moment_pair(nu, nu_t)[1], t(x), t(l1), t(bc), 7,
        LR, B1, B2, EPS, recompute_code=recompute,
    )


@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_fused_step_matches_jax_interpret_in_every_tier(tier, recompute):
    ref = _jax_step(tier)
    got = _port_step(tier, recompute)
    assert np.abs(to_np(got[0]) - to_np(ref[0])).max() <= 2 * LR
    assert_moment_tracks(got[1], ref[1], f"{tier} mu", bf16_stochastic=False)
    assert_moment_tracks(got[2], ref[2], f"{tier} nu")
    assert_grads_close(got[3], ref[3], "g_bias")
    for name, a, b in zip(["l_rec", "l_l1_raw"], got[4:], ref[4:]):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-3, err_msg=name)
    if recompute:
        stored = _port_step(tier, False)
        for a, b in zip(got[:4], stored[:4]):
            for ta, tb in zip(moment_parts(a), moment_parts(b)):
                assert torch.equal(ta.view(torch.uint8) if ta.dtype == torch.bfloat16 else ta,
                                   tb.view(torch.uint8) if tb.dtype == torch.bfloat16 else tb)


def test_fwd_nocode_is_k1_without_the_code():
    d_raw, bias, x, _, _, _, _ = _inputs()
    t = torch.from_numpy
    nrm = torch.sqrt(torch.sum(t(d_raw) ** 2, dim=-1))
    db = (t(d_raw) / nrm[..., None]).to(torch.bfloat16)
    xb = t(x).to(torch.bfloat16)
    _, dxh, lrec, ll1 = tk.tied_sae_fwd(xb, db, t(bias), 2.0 / (B * D))
    got = tk.tied_sae_fwd_nocode(xb, db, t(bias), 2.0 / (B * D))
    assert torch.equal(got[0].view(torch.int16), dxh.view(torch.int16))
    assert torch.equal(got[1], lrec) and torch.equal(got[2], ll1)
    assert tk.nocode_tile(512) == (64, 64) and tk.nocode_tile(768) == (32, 32)
