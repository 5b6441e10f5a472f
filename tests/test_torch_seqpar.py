"""The port's sequence-parallel path (`parallel.mesh.Mesh.ring_shift` /
`all_to_all`, `lm/ring_attention.py`'s ring and Ulysses attention and
sharded forward, `data/activations.py`'s ``mesh=`` harvest) against the JAX
package's at the same p, on the CPU.

The port runs in gloo worlds of 2 and 4 processes (one spawn each of
`tests/_torch_mp_worker.py`'s ``seqpar`` scenario); JAX runs here on p of
its 8 virtual CPU devices, on the same numpy inputs. Pins:
  - the collectives against JAX's ``ppermute`` / tiled ``all_to_all``:
    exactly;
  - attention, logits and cache against JAX's sequence-parallel result at
    the same p: rtol/atol 2e-5 (f32); against the port's dense forward at
    JAX's pin (`tests/test_lm.py:156-262`): atol 2e-4; the bare attention
    against dense at the blockwise pin, atol 2e-5;
  - the sharded harvest against JAX's sharded harvest and against the
    port's unsharded store at JAX's pin (`tests/test_activations.py:
    140-161`): atol 2e-3 (fp16 store).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mp_worker import spawn
from sparse_coding__tpu.data import activations as jact
from sparse_coding__tpu.lm import model as jm
from sparse_coding__tpu_torch.data import activations as tact
from sparse_coding__tpu_torch.data.chunks import ChunkStore
from sparse_coding__tpu_torch.interop import lm_params_from_jax
from sparse_coding__tpu_torch.lm import model as tm
from sparse_coding__tpu_torch.parallel import make_mesh

# the packages' `lm` export functions of the module's name: import the modules themselves
jra = importlib.import_module("sparse_coding__tpu.lm.ring_attention")
tra = importlib.import_module("sparse_coding__tpu_torch.lm.ring_attention")

MODELS = {
    "neox": (dict(arch="neox", n_layers=2, d_model=32, n_heads=4, d_mlp=64, vocab_size=64, n_ctx=128,
                  rotary_pct=0.25), 0, "blocks.1.hook_resid_post"),
    "gpt2": (dict(arch="gpt2", n_layers=1, d_model=32, n_heads=4, d_mlp=64, vocab_size=32, n_ctx=64,
                  tie_word_embeddings=True), 2, "blocks.0.hook_resid_post"),
}
HARVEST = dict(batch_size=4, n_chunks=2, layers=[1])
HARVEST_SEQ = 16
CHUNK_GB = HARVEST["batch_size"] * HARVEST_SEQ * 32 * 2 / 1024**3  # one batch a chunk
QKV_SHAPE = (2, 16, 4, 8)


def _shard_map():
    try:
        return jax.shard_map, {"check_vma": False}
    except AttributeError:
        from jax.experimental.shard_map import shard_map

        return shard_map, {"check_rep": False}


def _jax_mesh(p, devices):
    from sparse_coding__tpu.parallel import make_mesh as jax_make_mesh

    return jax_make_mesh(1, p, 1, devices=devices[:p])


def _jax_params(tag):
    cfg_kw, seed, _ = MODELS[tag]
    cfg = jm.LMConfig(**cfg_kw)
    return cfg, jm.init_params(jax.random.PRNGKey(seed), cfg)


def _tokens(vocab=32, shape=(2, 32), seed=3):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _qkv():
    rng = np.random.default_rng(7)
    return np.stack([rng.standard_normal(QKV_SHAPE).astype(np.float32) for _ in range(3)])


@pytest.fixture(scope="module", params=[2, 4], ids=["p2", "p4"])
def world(request, tmp_path_factory):
    """Each rank's ``seqpar`` results in a gloo world of p processes, and
    the inputs they were given."""
    p = request.param
    tmp = tmp_path_factory.mktemp(f"seqpar{p}")
    models = {}
    for tag, (cfg_kw, _, name) in MODELS.items():
        _, jp = _jax_params(tag)
        path = tmp / f"{tag}.pt"
        torch.save(lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"), path)
        models[tag] = (cfg_kw, str(path), name)
    np.save(tmp / "qkv.npy", _qkv())
    np.save(tmp / "tokens.npy", _tokens())
    np.save(tmp / "htok.npy", _tokens(64, (8, HARVEST_SEQ), seed=11))
    harvest = dict(cfg=MODELS["neox"][0], params=models["neox"][1], tokens=str(tmp / "htok.npy"),
                   root=str(tmp / "harvest"), layers=HARVEST["layers"], batch_size=HARVEST["batch_size"],
                   n_chunks=HARVEST["n_chunks"], chunk_size_gb=CHUNK_GB)
    sc = dict(kind="seqpar", name="sp", mesh=[1, p, 1], qkv=str(tmp / "qkv.npy"), tokens=str(tmp / "tokens.npy"),
              models=models, harvest=harvest)
    codes, res, errs = spawn(p, [sc], tmp, timeout=240)
    assert codes == [0] * p, errs
    return p, [r["sp"] for r in res], tmp


def _gather(results, pick, dim=1):
    return np.concatenate([pick(r) for r in results], axis=dim)


def test_collectives_match_jax_ppermute_and_all_to_all(world, devices):
    p, res, _ = world
    smap, kw = _shard_map()
    mesh = _jax_mesh(p, devices)
    P = jax.sharding.PartitionSpec
    base = np.stack([np.arange(24, dtype=np.float32).reshape(2, 3, 4) + 100 * r for r in range(p)])
    perm = [(i, (i + 1) % p) for i in range(p)]
    shifted = jax.jit(smap(lambda x: jax.lax.ppermute(x, "data", perm), mesh=mesh, in_specs=P("data"),
                           out_specs=P("data"), **kw))(base)
    a2a = np.stack([np.arange(64, dtype=np.float32).reshape(2, 4, 8) + 1000 * r for r in range(p)])
    swapped = jax.jit(smap(lambda x: jax.lax.all_to_all(x, "data", split_axis=3, concat_axis=2, tiled=True),
                           mesh=mesh, in_specs=P("data"), out_specs=P("data"), **kw))(a2a)
    for r, got in enumerate(res):
        assert got["coords"] == r
        np.testing.assert_array_equal(got["ring_shift"], np.asarray(shifted)[r])
        np.testing.assert_array_equal(got["all_to_all"], np.asarray(swapped)[r])


def test_mesh_stats_count_each_collective_kind(world):
    p, res, _ = world
    for got in res:
        st = got["stats"]
        assert st["ring_shift.calls"] == 1 and st["all_to_all.calls"] == 1 and st["calls"] == 2
        assert st["ring_shift.bytes"] == 24 * 4 and st["all_to_all.bytes"] == 64 * 4
        assert st["bytes"] == st["ring_shift.bytes"] + st["all_to_all.bytes"]


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_attention_matches_jax_at_the_same_p_and_dense(world, devices, impl):
    p, res, _ = world
    smap, kw = _shard_map()
    P = jax.sharding.PartitionSpec
    q, k, v = _qkv()
    spec = P(None, "data")
    want = jax.jit(smap(jra.ATTN_IMPLS[impl]("data"), mesh=_jax_mesh(p, devices), in_specs=(spec, spec, spec),
                        out_specs=spec, **kw))(q, k, v)
    got = _gather(res, lambda r: r["attn"][impl])
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    dense = tm.dense_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, dense, atol=2e-5, rtol=0)
    if impl == "ring":  # every block attended: no step skipped
        noncausal = tm.dense_attention(*map(torch.from_numpy, (q, k, v)), causal=False).numpy()
        np.testing.assert_allclose(_gather(res, lambda r: r["attn_noncausal_ring"]), noncausal, atol=2e-5, rtol=0)


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
@pytest.mark.parametrize("tag", ["neox", "gpt2"])
def test_sequence_parallel_forward_matches_jax_and_dense(world, devices, tag, attn):
    """Logits, the cache and a shard-local replacement hook; GPT-2 reads its
    learned positions at the global positions."""
    p, res, _ = world
    cfg, jp = _jax_params(tag)
    name = MODELS[tag][2]
    tokens = _tokens()
    mesh = _jax_mesh(p, devices)
    j_logits, j_cache = jra.sequence_parallel_forward(jp, jnp.asarray(tokens), cfg, mesh, cache_names=[name],
                                                      attn=attn)
    j_hooked, _ = jra.sequence_parallel_forward(jp, jnp.asarray(tokens), cfg, mesh, hooks={name: lambda t: t * 0.5},
                                                attn=attn)
    got = {key: _gather(res, lambda r: r["forward"][tag, attn][key]) for key in ("logits", "cache", "hooked")}
    for key, want in (("logits", j_logits), ("cache", j_cache[name]), ("hooked", j_hooked)):
        np.testing.assert_allclose(got[key], np.asarray(want), rtol=2e-5, atol=2e-5)
    tc = tm.LMConfig(**MODELS[tag][0])
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    t_tokens = torch.from_numpy(tokens)
    d_logits, d_cache = tm.forward(tp, t_tokens, tc, cache_names=[name])
    d_hooked, _ = tm.forward(tp, t_tokens, tc, hooks={name: lambda t: t * 0.5})
    np.testing.assert_allclose(got["logits"], d_logits.numpy(), atol=2e-4)
    np.testing.assert_allclose(got["cache"], d_cache[name].numpy(), atol=2e-4)
    np.testing.assert_allclose(got["hooked"], d_hooked.numpy(), atol=2e-4)


def test_ulysses_refuses_indivisible_heads(world):
    _, res, _ = world
    for got in res:
        assert got["indivisible"] is not None and "divisible" in got["indivisible"]


def _store(folder):
    st = ChunkStore(folder)
    return [np.asarray(st.load(i, device="cpu")) for i in range(len(st))]


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_sharded_harvest_matches_jax_and_the_unsharded_store(world, devices, attn):
    """Rank 0 alone writes the store and its spans; its chunks are JAX's
    sharded harvest and the port's single-card one, row for row."""
    p, res, tmp = world
    cfg, jp = _jax_params("neox")
    htok = np.load(tmp / "htok.npy")
    kw = dict(layers=HARVEST["layers"], layer_locs=["residual"], batch_size=HARVEST["batch_size"],
              chunk_size_gb=CHUNK_GB, n_chunks=HARVEST["n_chunks"])
    key = str((1, "residual"))
    folders = {r["harvest"][attn][key] for r in res}
    assert len(folders) == 1
    folder = folders.pop()
    got = _store(folder)
    assert len(got) == HARVEST["n_chunks"] and got[0].shape == (HARVEST["batch_size"] * HARVEST_SEQ, 32)
    want = jact.make_activation_dataset(jp, cfg, htok, tmp / f"jax_{attn}", mesh=_jax_mesh(p, devices),
                                        seq_attn=attn, **kw)
    plain = tact.make_activation_dataset(lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"),
                                         tm.LMConfig(**MODELS["neox"][0]), htok, tmp / f"plain_{attn}",
                                         device="cpu", **kw)
    for a, j, s in zip(got, _store(want[(1, "residual")]), _store(plain[(1, "residual")])):
        np.testing.assert_allclose(a.astype(np.float32), j.astype(np.float32), atol=2e-3)
        np.testing.assert_allclose(a.astype(np.float32), s.astype(np.float32), atol=2e-3)
    # the writer: rank 0's chunks of both harvests and the fused save, nothing of the others
    assert len(res[0]["writes"]) == 3 * HARVEST["n_chunks"]
    assert all(not r["writes"] for r in res[1:])
    assert res[0]["spans"].count("harvest_forward") == 2 * HARVEST["n_chunks"]
    assert all(not r["spans"] for r in res[1:])
    assert tact.read_harvest_cursor(folder)["chunk"] == HARVEST["n_chunks"]


def test_harvest_to_device_yields_the_same_chunks_on_every_rank(world):
    p, res, tmp = world
    tc = tm.LMConfig(**MODELS["neox"][0])
    _, jp = _jax_params("neox")
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    plain = list(tact.harvest_to_device(tp, tc, np.load(tmp / "htok.npy"), HARVEST["layers"], ["residual"],
                                        batch_size=HARVEST["batch_size"], chunk_size_gb=CHUNK_GB,
                                        n_chunks=HARVEST["n_chunks"], device="cpu"))
    key = str((1, "residual"))
    assert len(res[0]["to_device"]) == HARVEST["n_chunks"]
    for r in res[1:]:
        for a, b in zip(r["to_device"], res[0]["to_device"]):
            np.testing.assert_array_equal(a[key], b[key])
    for a, b in zip(res[0]["to_device"], plain):
        np.testing.assert_allclose(a[key].astype(np.float32), b[(1, "residual")].float().numpy(), atol=2e-3)
    saved = _store(tact.harvest_folder_name(tmp / "harvest" / "fused", 1, "residual"))
    for a, b in zip(saved, res[0]["to_device"]):
        np.testing.assert_array_equal(a, b[key])


# -- a world of one, in this process ---------------------------------------------

@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_a_world_of_one_is_dense_attention(impl):
    """The degenerate ring and Ulysses (p = 1, no collective): dense
    attention on the whole sequence."""
    mesh = make_mesh(1, 1, 1)
    q, k, v = map(torch.from_numpy, _qkv())
    got = tra.ATTN_IMPLS[impl]("data", mesh=mesh)(q, k, v)
    np.testing.assert_allclose(got.numpy(), tm.dense_attention(q, k, v).numpy(), atol=2e-5, rtol=0)
    assert mesh.stats["calls"] == 0


def test_the_sequence_parallel_attentions_need_a_mesh():
    for fn in (tra.ring_attention, tra.ulysses_attention):
        with pytest.raises(ValueError, match="mesh="):
            fn("data")
    cfg = tm.LMConfig(**MODELS["neox"][0])
    with pytest.raises(ValueError, match="unknown attn"):
        tra.make_sequence_parallel_fn(cfg, make_mesh(1, 1, 1), attn="blockwise")
    fn = tra.make_sequence_parallel_fn(cfg, make_mesh(1, 1, 1), cache_names=[MODELS["neox"][2]])
    tp = tm.init_params(0, cfg, device="cpu")
    logits, cache = fn(tp, torch.from_numpy(_tokens(64)))
    d_logits, d_cache = tm.forward(tp, torch.from_numpy(_tokens(64)), cfg, cache_names=[MODELS["neox"][2]])
    np.testing.assert_allclose(logits.numpy(), d_logits.numpy(), atol=2e-4)
    np.testing.assert_allclose(cache[MODELS["neox"][2]].numpy(), d_cache[MODELS["neox"][2]].numpy(), atol=2e-4)
