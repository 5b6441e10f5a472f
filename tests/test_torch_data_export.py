"""Data and export interop between the JAX package and the port: the chunk
store and learned-dict exports read across in both directions, and the
port's train loop trains over a chunk store."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from sparse_coding__tpu.data.chunks import ChunkStore as JaxChunkStore
from sparse_coding__tpu.data.chunks import save_chunk as jax_save_chunk
from sparse_coding__tpu.train.checkpoint import save_learned_dicts as jax_save_learned_dicts
from sparse_coding__tpu_torch import FunctionalTiedSAE, build_ensemble
from sparse_coding__tpu_torch.data.chunks import ChunkStore, CorruptChunk, generate_synthetic_chunks, save_chunk
from sparse_coding__tpu_torch.data.synthetic import RandomDatasetGenerator
from sparse_coding__tpu_torch.models.learned_dict import LEARNED_DICT_REGISTRY, UntiedSAE
from sparse_coding__tpu_torch.train.checkpoint import load_learned_dicts, save_learned_dicts
from sparse_coding__tpu_torch.train.loop import ensemble_train_loop
from sparse_coding__tpu_torch.utils import precision as px


def test_chunk_store_reads_across_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((96, 32)).astype(np.float32)
    jax_save_chunk(tmp_path / "j", 0, a)
    store = ChunkStore(tmp_path / "j")
    assert store.indices() == [0]
    got = store.load(0, dtype=None, device="cpu", verify="digest")
    assert got.dtype == torch.float16
    np.testing.assert_array_equal(got.numpy(), a.astype(np.float16))
    save_chunk(tmp_path / "t", 3, torch.from_numpy(a))
    back = JaxChunkStore(tmp_path / "t").load(3, dtype=None, verify="digest")
    np.testing.assert_array_equal(np.asarray(back), a.astype(np.float16))


def test_chunk_store_refuses_torn_and_quantized_chunks(tmp_path):
    a = np.ones((8, 16), np.float32)
    save_chunk(tmp_path, 0, a)
    with open(tmp_path / "0.npy", "ab") as f:
        f.write(b"\0")
    with pytest.raises(CorruptChunk, match="size mismatch"):
        ChunkStore(tmp_path).load(0, device="cpu")
    with pytest.raises(ValueError, match="tiers"):
        save_chunk(tmp_path, 1, a, dtype=np.float32)
    # quantized bytes whose scale file is gone never load as raw codes
    jax_save_chunk(tmp_path / "q", 0, a, dtype=np.int8)
    (tmp_path / "q" / "0.scale.npy").unlink()
    for verify in ("size", "off"):
        with pytest.raises(CorruptChunk, match="scale"):
            ChunkStore(tmp_path / "q").load(0, device="cpu", verify=verify)


def test_jax_export_loads_and_encodes_alike(tmp_path):
    from sparse_coding__tpu import build_ensemble as jax_build_ensemble
    from sparse_coding__tpu.models import FunctionalTiedSAE as JaxTiedSAE

    jens = jax_build_ensemble(
        JaxTiedSAE, jax.random.PRNGKey(0), [{"l1_alpha": 1e-3}, {"l1_alpha": 3e-3}],
        optimizer_kwargs={"learning_rate": 1e-3}, activation_size=32, n_dict_components=64,
    )
    jens.step_batch(jax.random.normal(jax.random.PRNGKey(1), (64, 32)))
    lds = jens.to_learned_dicts()
    path = tmp_path / "learned_dicts.pkl"
    jax_save_learned_dicts(path, [(ld, {"l1_alpha": a}) for ld, a in zip(lds, (1e-3, 3e-3))])
    loaded = load_learned_dicts(path, verify=True, device="cpu")
    x = np.random.default_rng(2).standard_normal((50, 32)).astype(np.float32)
    for jld, (tld, hp) in zip(lds, loaded):
        assert type(tld).__name__ == "TiedSAE" and tld.norm_encoder
        # f32 matmuls summed in another order: 1e-6 relative, 1e-6 absolute
        # near the relu's zero
        np.testing.assert_allclose(
            to_np(tld.encode(torch.from_numpy(x))), np.asarray(jld.encode(jnp.asarray(x))),
            rtol=1e-6, atol=1e-6,
        )
    assert [hp["l1_alpha"] for _, hp in loaded] == [1e-3, 3e-3]


def test_port_export_round_trips_with_verified_sidecar(tmp_path):
    ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": 1e-3}, {"l1_alpha": 3e-3}],
                         activation_size=32, n_dict_components=64, device="cpu")
    lds = ens.to_learned_dicts()
    p = lds[0]
    lds.append(UntiedSAE(p.encoder, p.encoder.flip(0), p.encoder_bias))
    path = tmp_path / "out" / "learned_dicts.pkl"
    save_learned_dicts(path, [(ld, {"i": i}) for i, ld in enumerate(lds)])
    loaded = load_learned_dicts(path, verify=True, device="cpu")
    assert [type(ld).__name__ for ld, _ in loaded] == ["TiedSAE", "TiedSAE", "UntiedSAE"]
    for ld, (ld2, hp) in zip(lds, loaded):
        for f in LEARNED_DICT_REGISTRY[type(ld)][0]:
            assert torch.equal(getattr(ld, f), getattr(ld2, f)), f
        assert (ld2.n_feats, ld2.activation_size) == (64, 32)
        x = torch.randn(8, 32)
        assert torch.equal(ld.encode(x), ld2.encode(x))
    data = bytearray(path.read_bytes())
    data[-3] ^= 0xFF
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="manifest verification"):
        load_learned_dicts(path, device="cpu")


def test_train_loop_over_a_two_chunk_store(tmp_path):
    gen = RandomDatasetGenerator(128, 256, 512, 8, 0.99, False, key=0, device="cpu")
    store = generate_synthetic_chunks(gen, tmp_path, 2, chunk_size_gb=2048 * 128 * 2 / 1024**3)
    assert store.indices() == [0, 1]
    ens = build_ensemble(
        FunctionalTiedSAE, 0, [{"l1_alpha": 1e-3}, {"l1_alpha": 3e-3}],
        optimizer_kwargs={"learning_rate": 1e-3, "mu_dtype": "bfloat16"},
        compute_dtype="bfloat16", activation_size=128, n_dict_components=512, device="cpu",
    )
    assert ens.fused and ens.fused_adam is not None
    probe = next(gen)

    def loss():
        with torch.no_grad(), px.compute(torch.bfloat16):
            return FunctionalTiedSAE.loss(ens.state.params, ens.state.buffers, probe)[0]

    before = loss()
    progress = []
    for i, chunk in enumerate(store.iter_chunks([0, 1], device="cpu")):
        assert chunk.shape == (2048, 128)
        # chunk 0: the whole-chunk path; chunk 1: groups of 4 steps
        cb = (lambda k, n: progress.append((k, n))) if i else None
        last = ensemble_train_loop(ens, chunk, 256, key=i, scan_steps=4, progress_callback=cb)
        assert torch.isfinite(last["loss"]).all()
    assert progress == [(3, 8), (7, 8)]
    assert ens.state.step == 16
    np.testing.assert_array_equal(to_np(ens.state.opt_state.count), [16, 16])
    assert float(loss().mean()) < float(before.mean())
