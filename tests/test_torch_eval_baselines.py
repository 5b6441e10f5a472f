"""The port's host-side baselines and analysis against the JAX package's, on
the CPU: ICA/NMF (`models/{ica,nmf}.py`), the baselines runner
(`train/baselines.py`) over a JAX-written chunk store, the clustering
diagnostics (`metrics/clustering.py`), the IOI prompts (`data/ioi.py`) and
the baseline pickles read both ways (`utils/pickles.py`).

Tolerances:
  - ICA/NMF with the same ``random_state`` (sklearn on the same float64
    rows): codes and dictionaries within 1e-6;
  - `run_layer_baselines`: the same files; PCA dictionaries within 1e-4
    (each row up to its sign, as both eigensolvers may flip one: the f32
    streaming covariances sum in another order, `test_torch_pca`'s bound),
    the top-k sparsity equal, the ICA fit (the global numpy seed set alike
    before each run) within 1e-6, the identity-ReLU bias equal; the random
    dict's shape (the packages draw from different streams);
  - clustering on the same rows: the same cluster ids;
  - `generate_ioi_dataset` with a stub encoder: arrays equal.
"""

import pickle
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding__tpu.data import save_chunk as jax_save_chunk
from sparse_coding__tpu.data.ioi import generate_ioi_dataset as jax_ioi
from sparse_coding__tpu.metrics import clustering as jclust
from sparse_coding__tpu.models import ICAEncoder as JICA
from sparse_coding__tpu.models import NMFEncoder as JNMF
from sparse_coding__tpu.models.learned_dict import Rotation as JRotation
from sparse_coding__tpu.models.learned_dict import TiedSAE as JTied
from sparse_coding__tpu.train import baselines as jbase
from sparse_coding__tpu.train.checkpoint import save_learned_dicts as jax_save_dicts
from sparse_coding__tpu_torch import data as tdata
from sparse_coding__tpu_torch import models as tmodels
from sparse_coding__tpu_torch import train as ttrain
from sparse_coding__tpu_torch.data.ioi import generate_ioi_dataset
from sparse_coding__tpu_torch.metrics import clustering as tclust
from sparse_coding__tpu_torch.models.learned_dict import Rotation
from sparse_coding__tpu_torch.models.pca import PCAEncoder
from sparse_coding__tpu_torch.models.topk import TopKLearnedDict
from sparse_coding__tpu_torch.train import baselines as tbase
from sparse_coding__tpu_torch.utils import pickles


@pytest.fixture(scope="module")
def rows():
    """Anisotropic, non-Gaussian rows with a mean (ICA needs non-Gaussian
    sources)."""
    rng = np.random.default_rng(0)
    mix = rng.normal(size=(12, 12)) * np.linspace(0.2, 2.0, 12)[None, :]
    return (rng.laplace(size=(2048, 12)) @ mix + 3.0).astype(np.float32)


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- ICA and NMF --------------------------------------------------------------------

@pytest.mark.parametrize("n_components", [0, 6])
def test_ica_matches_jax(rows, n_components):
    j = JICA(12, n_components=n_components, random_state=0, max_iter=400)
    t = tmodels.ICAEncoder(12, n_components=n_components, random_state=0, max_iter=400, device="cpu")
    np.testing.assert_array_equal(t.train(torch.from_numpy(rows)), j.train(jnp.asarray(rows)))
    x = rows[:100]
    codes = t.encode(torch.from_numpy(x))
    assert codes.dtype == torch.float32 and codes.shape == (100, n_components or 12)
    np.testing.assert_allclose(_host(codes), np.asarray(j.encode(jnp.asarray(x))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_host(t.get_learned_dict()), np.asarray(j.get_learned_dict()), rtol=0, atol=1e-6)
    tk, jk = t.to_topk_dict(3), j.to_topk_dict(3)
    assert isinstance(tk, TopKLearnedDict) and tk.sparsity == jk.sparsity == 3
    np.testing.assert_array_equal(_host(tk.dict), np.asarray(jk.dict))


@pytest.mark.parametrize("n_components", [0, 5])
def test_nmf_matches_jax(rows, n_components):
    j = JNMF(12, n_components=n_components, random_state=0, max_iter=300)
    t = tmodels.NMFEncoder(12, n_components=n_components, random_state=0, max_iter=300, device="cpu")
    j.train(jnp.asarray(rows))
    t.train(torch.from_numpy(rows))
    assert t.shift == j.shift
    x = rows[:100]
    np.testing.assert_allclose(_host(t.encode(torch.from_numpy(x))), np.asarray(j.encode(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    d = t.get_learned_dict()
    np.testing.assert_allclose(_host(d), np.asarray(j.get_learned_dict()), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_host(torch.linalg.vector_norm(d, dim=-1)), 1.0, atol=1e-6)
    np.testing.assert_allclose(_host(t.to_topk_dict(4).dict), np.asarray(j.to_topk_dict(4).dict), rtol=0, atol=1e-6)


# -- the baselines runner -------------------------------------------------------------

def _store(tmp_path, rows):
    jax_save_chunk(tmp_path / "chunks" / "l0_residual", 0, rows)
    return str(tmp_path / "chunks")


def _rows_up_to_sign(a, b, atol):
    sign = np.sign(np.sum(a * b, axis=-1, keepdims=True))
    np.testing.assert_allclose(a * sign, b, rtol=0, atol=atol)


@pytest.mark.parametrize("match", [False, True])
def test_run_layer_baselines_matches_jax_over_a_jax_store(tmp_path, rows, match):
    chunks = _store(tmp_path, rows)
    kw = dict(sparsity=5, ica_max_samples=1000)
    if match:  # the sparsity matched to a JAX-written sweep export's dict
        rng = np.random.default_rng(5)
        lds = [(JTied(jnp.asarray(rng.normal(size=(24, 12)).astype(np.float32)),
                      jnp.asarray((0.3 * rng.normal(size=24)).astype(np.float32)), norm_encoder=True), {"i": i})
               for i in range(3)]
        jax_save_dicts(tmp_path / "sweep" / "learned_dicts.pkl", lds)
        kw.update(sparsity_match_dicts_path=str(tmp_path / "sweep" / "learned_dicts.pkl"), sparsity_match_index=1)
    np.random.seed(0)
    jw = jbase.run_layer_baselines(0, ["residual"], chunks, str(tmp_path / "jax"), **kw)
    np.random.seed(0)
    tw = tbase.run_layer_baselines(0, ["residual"], chunks, str(tmp_path / "port"), device="cpu", **kw)
    assert tw == jw
    assert sorted(p.name for p in (tmp_path / "port" / "l0_residual").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax" / "l0_residual").iterdir())

    def both(name):
        return (tbase.load_baseline(str(tmp_path / "port"), 0, "residual", name, device="cpu"),
                jbase.load_baseline(str(tmp_path / "jax"), 0, "residual", name))

    t, j = both("pca")
    assert isinstance(t, PCAEncoder) and t.sparsity == j.sparsity == 12
    _rows_up_to_sign(_host(t.pca_dict), np.asarray(j.pca_dict), 1e-4)
    t, j = both("pca_topk")
    assert t.sparsity == j.sparsity and t.dict.shape == (24, 12)
    if match:
        lds_t = ttrain.load_learned_dicts(tmp_path / "sweep" / "learned_dicts.pkl", device="cpu")
        want = int(float(tmodels.TiedSAE.encode(lds_t[1][0], torch.from_numpy(rows)).ne(0).float().mean(0).sum()))
        assert t.sparsity == max(1, min(want, 12))
    _rows_up_to_sign(_host(t.dict[:12]), np.asarray(j.dict[:12]), 1e-4)
    t, j = both("ica")
    j = j.item()  # the JAX runner's tree map stores its encoder in a 0-d object array
    assert isinstance(t, tmodels.ICAEncoder) and t.device == torch.device("cpu")
    np.testing.assert_allclose(_host(t.encode(torch.from_numpy(rows[:64]))), np.asarray(j.encode(jnp.asarray(rows[:64]))),
                               rtol=0, atol=1e-6)
    t, j = both("ica_topk")
    np.testing.assert_allclose(_host(t.dict), np.asarray(j.dict), rtol=0, atol=1e-6)
    t, j = both("identity_relu")
    np.testing.assert_array_equal(_host(t.bias), np.asarray(j.bias))
    t, j = both("random")
    assert t.encoder.shape == j.encoder.shape == (12, 12)


def test_run_layer_baselines_skips_what_exists(tmp_path, rows):
    chunks = _store(tmp_path, rows)
    first = tbase.run_layer_baselines(0, ["residual"], chunks, str(tmp_path / "out"), sparsity=5,
                                      ica_max_samples=500, device="cpu")
    assert set(first["l0_residual"]) == {"pca.pkl", "pca_topk.pkl", "ica.pkl", "ica_topk.pkl", "random.pkl",
                                         "identity_relu.pkl"}
    again = tbase.run_all_baselines([0], ["residual"], chunks, str(tmp_path / "out"), sparsity=5, device="cpu")
    assert again == {0: {"l0_residual": []}}
    c = tbase.load_baseline(str(tmp_path / "out"), 0, "residual", "pca_topk", device="cpu").encode(
        torch.from_numpy(rows[:64]))
    assert bool(((c != 0).sum(dim=-1) <= 5).all())


def test_port_baseline_files_load_in_the_jax_package(tmp_path, rows):
    """The port writes the JAX package's class paths and numpy leaves: a plain
    `pickle.load` in the JAX package rebuilds its own dictionaries, which
    encode as the port's do."""
    chunks = _store(tmp_path, rows)
    tbase.run_layer_baselines(0, ["residual"], chunks, str(tmp_path / "out"), sparsity=4, ica_max_samples=500,
                              device="cpu")
    x = rows[:32]
    for name in ("pca", "pca_topk", "ica", "ica_topk", "random", "identity_relu"):
        raw = (tmp_path / "out" / "l0_residual" / f"{name}.pkl").read_bytes()
        assert b"sparse_coding__tpu_torch" not in raw and b"torch" not in raw
        j = jbase.load_baseline(str(tmp_path / "out"), 0, "residual", name)
        assert type(j).__module__.startswith("sparse_coding__tpu.")
        t = tbase.load_baseline(str(tmp_path / "out"), 0, "residual", name, device="cpu")
        np.testing.assert_allclose(np.asarray(j.encode(jnp.asarray(x))), _host(t.encode(torch.from_numpy(x))),
                                   rtol=1e-5, atol=1e-5)


def test_pickles_round_trip_nested_trees_and_jax_arrays():
    """A JAX pickle of (params with JAX array leaves, a dataclass) loads with
    numpy → tensors and no JAX import path; the port's pickle of the same
    loads back equal."""
    from sparse_coding__tpu.lm import model as jlm

    cfg = jlm.LMConfig(arch="neox", n_layers=1, d_model=8, n_heads=2, d_mlp=16, vocab_size=32)
    params = {"embed": jnp.arange(12.0).reshape(3, 4), "blocks": [{"w": jnp.ones(2, jnp.int32)}]}
    got, got_cfg = pickles.loads(pickle.dumps((params, cfg)), device="cpu")
    assert type(got_cfg).__module__ == "sparse_coding__tpu_torch.lm.model" and got_cfg.d_model == 8
    assert torch.equal(got["embed"], torch.arange(12.0).reshape(3, 4)) and got["blocks"][0]["w"].dtype == torch.int32
    back = pickle.loads(pickles.dumps((got, got_cfg)))
    assert type(back[1]) is jlm.LMConfig and back[1] == cfg
    np.testing.assert_array_equal(back[0]["embed"], np.arange(12.0).reshape(3, 4))


# -- clustering -----------------------------------------------------------------------

def test_clustering_gives_the_jax_cluster_ids():
    rng = np.random.default_rng(7)
    centers = rng.normal(size=(3, 16)) * 5
    vecs = np.concatenate([centers[i] + 0.05 * rng.normal(size=(20, 16)) for i in range(3)]).astype(np.float32)
    want = jclust.hierarchical_cluster_vectors(vecs, n_clusters=3)
    got = tclust.hierarchical_cluster_vectors(torch.from_numpy(vecs), n_clusters=3)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == 3
    jtop = jclust.cluster_vectors(JRotation(jnp.asarray(vecs)), n_clusters=3, top_clusters=3)
    ttop = tclust.cluster_vectors(Rotation(torch.from_numpy(vecs)), n_clusters=3, top_clusters=3)
    assert [list(c) for c in ttop] == [list(c) for c in jtop]
    assert sorted(len(c) for c in ttop) == [20, 20, 20]


def test_cluster_vectors_writes_its_clusters(tmp_path):
    vecs = np.random.default_rng(8).normal(size=(30, 8)).astype(np.float32)
    top = tclust.cluster_vectors(Rotation(torch.from_numpy(vecs)), n_clusters=4, top_clusters=2,
                                 save_loc=str(tmp_path / "c.txt"))
    lines = (tmp_path / "c.txt").read_text().splitlines()
    assert len(lines) == 2 and lines[0] == str(list(top[0]))


# -- IOI ------------------------------------------------------------------------------

def _stub_encode(text):
    """A word-level stub tokenizer: one id a word or punctuation mark; the
    rarer names count two tokens, so the single-token filter drops them."""
    words = re.findall(r"\w+|[^\w\s]", text)
    return [sum(map(ord, w)) % 997 for w in words for _ in range(2 if len(w) > 7 else 1)]


@pytest.mark.parametrize("seed", [0, 42])
def test_generate_ioi_dataset_matches_jax(seed):
    want = jax_ioi(_stub_encode, 6, 4, seed=seed)
    got = generate_ioi_dataset(_stub_encode, 6, 4, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == (10, w.shape[1])
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], got[1])


def test_ioi_refuses_multi_token_words():
    with pytest.raises(AssertionError, match="multi-token words"):
        generate_ioi_dataset(lambda t: [1, 2] if "station" in t else [1], 1, 1)


def test_packages_export_the_jax_names():
    import sparse_coding__tpu.data as jdata
    import sparse_coding__tpu.models as jmodels
    import sparse_coding__tpu.train as jtrain

    assert hasattr(tmodels, "ICAEncoder") and hasattr(tmodels, "NMFEncoder")
    assert tdata.generate_ioi_dataset is generate_ioi_dataset
    for name in ("load_baseline", "run_all_baselines", "run_layer_baselines", "ToySAE", "run_single_go",
                 "run_toy_grid"):
        assert hasattr(jtrain, name) and hasattr(ttrain, name)
    missing_models = [n for n in dir(jmodels) if not n.startswith("_") and not hasattr(tmodels, n)]
    assert missing_models in ([], ["fista"])  # the solve's name stays the submodule's
    assert [n for n in ("generate_ioi_dataset", "RandomDatasetGenerator", "ChunkStore") if not hasattr(jdata, n)] == []
