"""The port's blockwise attention (`lm/ring_attention.py`) and the harvest
on it (`data/activations.py`, ``attn="blockwise"``) against the JAX
package's, on the CPU, with numpy-seeded inputs.

Tolerances (JAX's own pins, `tests/test_lm.py:264-300`):
  - the attention output against JAX's `blockwise_attention` and against
    dense attention: atol 2e-5, over JAX's shapes, ragged lengths (internal
    padding) and non-causal mode;
  - the blockwise capture against JAX's blockwise capture and against the
    port's dense capture: atol 2e-3 (fp16 store precision);
  - a harvested store (`make_activation_dataset(attn="blockwise")`)
    against JAX's: atol 2e-3.
The attention pattern cannot be captured under blockwise attention, as in
JAX (it raises).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding__tpu.data import activations as jact
from sparse_coding__tpu.lm import model as jm
from sparse_coding__tpu.lm.ring_attention import blockwise_attention as jax_blockwise
from sparse_coding__tpu_torch.data import activations as tact
from sparse_coding__tpu_torch.interop import lm_params_from_jax
from sparse_coding__tpu_torch.lm import model as tm
from sparse_coding__tpu_torch.lm.ring_attention import blockwise_attention

KW = dict(arch="neox", n_layers=3, d_model=16, n_heads=2, d_mlp=32, vocab_size=64, n_ctx=64, rotary_pct=0.25)
ATTN_SHAPES = [(24, 8, 8), (30, 8, 16), (16, 16, 16), (17, 8, 8), (40, 16, 8), (9, 4, 16)]


@pytest.fixture(scope="module")
def subject():
    jc, tc = jm.LMConfig(**KW), tm.LMConfig(**KW)
    jp = jm.init_params(jax.random.PRNGKey(0), jc)
    tokens = np.random.default_rng(1).integers(0, 64, (8, 40)).astype(np.int32)
    return jc, tc, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"), tokens


def _qkv(S, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, S, 3, 8)).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,qb,kb", ATTN_SHAPES)
def test_blockwise_attention_matches_jax_and_dense(S, qb, kb, causal):
    q, k, v = _qkv(S, S)
    want = np.asarray(jax_blockwise(q_block=qb, kv_block=kb)(*map(jnp.asarray, (q, k, v)), causal=causal))
    got = blockwise_attention(q_block=qb, kv_block=kb)(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (2, S, 3, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    dense = tm.dense_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-5, rtol=0)


def test_blockwise_attention_keeps_a_bf16_input_dtype():
    """The accumulators are f32 and the output comes back in the input's
    dtype, as JAX's ``astype(q.dtype)``."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(20, 3))
    got = blockwise_attention(q_block=8, kv_block=8)(q, k, v)
    want = tm.dense_attention(q.float(), k.float(), v.float())
    assert got.dtype == torch.bfloat16
    assert float((got.float() - want).abs().max()) < 2e-2


def test_skipped_future_blocks_leave_the_accumulators_alone():
    """Under causal masking a KV block after the q block is skipped; JAX
    computes it with every score masked. The masked step changes nothing:
    a 1-row KV block (every block but the first wholly in the future of the
    first q block) gives the unskipped recurrence's values."""
    q, k, v = _qkv(12, 5)
    want = np.asarray(jax_blockwise(q_block=4, kv_block=1)(*map(jnp.asarray, (q, k, v))))
    got = blockwise_attention(q_block=4, kv_block=1)(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("loc", ["residual", "attn", "mlpout"])
def test_blockwise_capture_matches_jax_and_dense(subject, loc):
    jc, tc, jp, tp, tokens = subject
    name = tm.make_tensor_name(1, loc)
    toks = tokens[:4, :24]
    want = np.asarray(jact._jitted_capture(jc, (name,), 2, None, "blockwise")(jp, jnp.asarray(toks))[name],
                      np.float32)
    got = tact.capture_fn(tc, [name], 2, attn="blockwise")(tp, torch.from_numpy(toks))[name]
    dense = tact.capture_fn(tc, [name], 2)(tp, torch.from_numpy(toks))[name]
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-3, rtol=0)
    np.testing.assert_allclose(got.float().numpy(), dense.float().numpy(), atol=2e-3, rtol=0)


def test_capture_is_cached_per_attention(subject):
    _, tc, _, _, _ = subject
    names = ["blocks.0.hook_resid_post"]
    assert tact.capture_fn(tc, names, 1, attn="blockwise") is tact.capture_fn(tc, names, 1, attn="blockwise")
    assert tact.capture_fn(tc, names, 1, attn="blockwise") is not tact.capture_fn(tc, names, 1)


def test_blockwise_harvest_matches_jax(subject, tmp_path):
    """`make_activation_dataset(attn="blockwise")` over 40-token rows (past
    the default 512-token blocks: one ragged block a row here) into 2
    chunks of 2 batches, JAX's blockwise harvest of the same tokens beside
    it; and the port's dense harvest within the same pin."""
    jc, tc, jp, tp, tokens = subject
    kw = dict(layers=[2], layer_locs=["residual"], batch_size=2, chunk_size_gb=2 * 2 * 40 * 16 * 2 / 1024**3,
              n_chunks=2, single_folder=True)
    jact.make_activation_dataset(jp, jc, tokens, tmp_path / "jax", attn="blockwise", **kw)
    tact.make_activation_dataset(tp, tc, tokens, tmp_path / "port", attn="blockwise", device="cpu", **kw)
    tact.make_activation_dataset(tp, tc, tokens, tmp_path / "dense", device="cpu", **kw)
    for i in range(2):
        want = np.load(tmp_path / "jax" / f"{i}.npy").astype(np.float32)
        got = np.load(tmp_path / "port" / f"{i}.npy").astype(np.float32)
        assert got.shape == want.shape == (2 * 2 * 40, 16)
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
        np.testing.assert_allclose(got, np.load(tmp_path / "dense" / f"{i}.npy").astype(np.float32), atol=2e-3,
                                   rtol=0)


def test_hook_pattern_is_refused_under_blockwise_attention(subject):
    _, tc, _, tp, tokens = subject
    name = tm.make_tensor_name(0, "pattern")
    with pytest.raises(ValueError, match="hook_pattern needs dense attention"):
        tm.run_with_cache(tp, torch.from_numpy(tokens[:2]), tc, [name], attn_impl=blockwise_attention(8, 8))
    with pytest.raises(ValueError, match="hook_pattern needs dense attention"):
        tact.capture_fn(tc, [name], 1, attn="blockwise")(tp, torch.from_numpy(tokens[:2]))
    # dense still captures it
    assert tact.capture_fn(tc, [name], 1)(tp, torch.from_numpy(tokens[:2]))[name].shape == (2, 2, 40, 40)
