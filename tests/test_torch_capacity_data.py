"""The chunk store's int8 and int4 tiers across the two packages: a chunk
written by either package's `save_chunk` loads in the other to the same
float16 values, bit for bit (the same numpy quantization on both sides; the
dequantization q · scale is one float16 product, correctly rounded in torch
and in XLA), with the same files and manifest fields."""

import json

import numpy as np
import pytest
import torch

from sparse_coding__tpu.data.chunks import ChunkStore as JaxChunkStore
from sparse_coding__tpu.data.chunks import quantize_rows_int4 as jax_quantize_rows_int4
from sparse_coding__tpu.data.chunks import quantize_rows_int8 as jax_quantize_rows_int8
from sparse_coding__tpu.data.chunks import save_chunk as jax_save_chunk
from sparse_coding__tpu_torch.data.chunks import (
    ChunkStore,
    generate_synthetic_chunks,
    quantize_rows_int4,
    quantize_rows_int8,
    save_chunk,
)
from sparse_coding__tpu_torch.data.synthetic import RandomDatasetGenerator

TIERS = [np.int8, "int4"]


def _rows(seed=0):
    a = np.random.default_rng(seed).standard_normal((96, 32)).astype(np.float32)
    a[3] = 0.0  # an all-zero row: scale 1
    a[5] *= 1e-3
    return a


@pytest.mark.parametrize("tier", TIERS, ids=["int8", "int4"])
def test_quantizers_match_jax(tier):
    a = _rows()
    mine = quantize_rows_int4(a) if tier == "int4" else quantize_rows_int8(a)
    ref = jax_quantize_rows_int4(a) if tier == "int4" else jax_quantize_rows_int8(a)
    for m, r in zip(mine, ref):
        assert m.dtype == r.dtype
        np.testing.assert_array_equal(m, r)


@pytest.mark.parametrize("tier", TIERS, ids=["int8", "int4"])
def test_jax_chunks_load_in_the_port_bit_for_bit(tmp_path, tier):
    a = _rows(1)
    jax_save_chunk(tmp_path, 0, a, dtype=tier)
    want = np.asarray(JaxChunkStore(tmp_path).load(0, dtype=None, verify="digest"))
    got = ChunkStore(tmp_path).load(0, dtype=None, device="cpu", verify="digest")
    assert got.dtype == torch.float16
    np.testing.assert_array_equal(got.numpy().view(np.int16), want.view(np.int16))
    np.testing.assert_array_equal(ChunkStore(tmp_path).load(0, device="cpu").numpy(), want.astype(np.float32))


@pytest.mark.parametrize("tier", TIERS, ids=["int8", "int4"])
def test_port_chunks_load_in_jax_bit_for_bit(tmp_path, tier):
    a = _rows(2)
    save_chunk(tmp_path / "t", 4, torch.from_numpy(a), dtype=tier)
    jax_save_chunk(tmp_path / "j", 4, a, dtype=tier)
    got = np.asarray(JaxChunkStore(tmp_path / "t").load(4, dtype=None, verify="digest"))
    want = np.asarray(JaxChunkStore(tmp_path / "j").load(4, dtype=None, verify="digest"))
    np.testing.assert_array_equal(got.view(np.int16), want.view(np.int16))
    for name in ("4.npy", "4.scale.npy"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    mt = json.loads((tmp_path / "t" / "sc_chunk.4.json").read_text())
    mj = json.loads((tmp_path / "j" / "sc_chunk.4.json").read_text())
    for key in ("format", "chunk", "rows", "shape", "store_dtype", "files"):
        assert mt[key] == mj[key], key


def test_fp16_over_a_quantized_chunk_drops_the_stale_scale(tmp_path):
    a = _rows(3)
    save_chunk(tmp_path, 0, a, dtype=np.int8)
    save_chunk(tmp_path, 0, a)
    assert not (tmp_path / "0.scale.npy").exists()
    got = ChunkStore(tmp_path).load(0, dtype=None, device="cpu", verify="digest")
    np.testing.assert_array_equal(got.numpy(), a.astype(np.float16))


def test_int8_store_feeds_the_train_loop(tmp_path):
    gen = RandomDatasetGenerator(activation_dim=32, n_ground_truth_components=64, batch_size=64,
                                 feature_num_nonzero=4, feature_prob_decay=0.99, correlated=False,
                                 key=0, device="cpu")
    store = generate_synthetic_chunks(gen, tmp_path, 2, chunk_size_gb=256 * 32 / 1024**3, dtype=np.int8)
    assert store.indices() == [0, 1]
    assert np.load(tmp_path / "0.npy").dtype == np.int8
    x = store.load(1, device="cpu")
    assert x.shape == (256, 32) and x.dtype == torch.float32 and torch.isfinite(x).all()
