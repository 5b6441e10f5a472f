"""The port's paper experiments (`experiments/`) against the JAX package's,
on the CPU, on a tiny subject (JAX's params carried across) and JAX-drawn
dictionaries (their arrays carried across), as `tests/test_experiments.py`
and `tests/test_case_studies.py` drive the JAX ones.

Tolerances: every score, CSV value and JSON value within rtol 1e-5 of JAX's
(f32 sums in another order), with these exceptions, each for a reason:
  - AddedNoise at a magnitude above 0 draws the port's own noise stream, not
    JAX's: its FVU within 10% and its loss within 5% of JAX's (the noise's
    sample variance over 4,096 elements is ~2% from its mean);
  - `random_feature_diversity` draws the port's own directions: the ENN
    function held to JAX's on the same directions (rtol 1e-5), the mean in
    the null's range;
  - a correlation with a feature's n_active count compares counts that a
    code at the relu's edge may flip: atol 1e-3; skew and kurtosis (and
    their correlations) within rtol 1e-3: their variance is m2 − mean² in
    f32, which cancels, so another order of the sums moves it further;
  - Hungarian assignments exactly, matched similarities atol 1e-5.
Each entry point writes its figure (matplotlib here) and refuses to run
without CUDA unless asked for the CPU.
"""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding__tpu import experiments as jex
from sparse_coding__tpu.lm import LMConfig as JaxLMConfig
from sparse_coding__tpu.lm import init_params as jax_init_params
from sparse_coding__tpu.models.learned_dict import Rotation as JaxRotation
from sparse_coding__tpu.models.learned_dict import TiedSAE as JaxTied
from sparse_coding__tpu_torch import experiments as tex
from sparse_coding__tpu_torch.interop import lm_params_from_jax
from sparse_coding__tpu_torch.lm import LMConfig
from sparse_coding__tpu_torch.models.learned_dict import Rotation, TiedSAE

LM_KW = dict(arch="neox", n_layers=2, d_model=16, n_heads=2, d_mlp=32, vocab_size=64, n_ctx=32)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_lm():
    jc, tc = JaxLMConfig(**LM_KW), LMConfig(**LM_KW)
    jp = jax_init_params(jax.random.PRNGKey(0), jc)
    tokens = np.random.default_rng(1).integers(0, 64, (8, 12)).astype(np.int32)
    return jc, tc, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"), tokens


def _t(a):
    return torch.from_numpy(np.array(a))


def _tied_pair(n, d, seed, rows=None):
    """A JAX TiedSAE of numpy-seeded rows and the port's of the same arrays."""
    rows = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32) if rows is None else rows
    j = JaxTied(jnp.asarray(rows), jnp.zeros((n,)), norm_encoder=True)
    t = TiedSAE(_t(rows), torch.zeros(n), norm_encoder=True)
    return j, t


def _rotation_pair(rows):
    return JaxRotation(jnp.asarray(rows)), Rotation(_t(rows))


def _unit_rows(seed, n, d):
    m = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def _close_rows(got, want, rtol=1e-5, numeric_from=1):
    assert len(got) == len(want) and got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g[:numeric_from] == w[:numeric_from]
        np.testing.assert_allclose([float(x) for x in g[numeric_from:]], [float(x) for x in w[numeric_from:]],
                                   rtol=rtol)


def test_pca_perplexity_matches_jax(tiny_lm, tmp_path):
    jc, tc, jp, tp, tokens = tiny_lm
    acts = np.random.default_rng(2).standard_normal((512, 16)).astype(np.float32)
    jd, td = _tied_pair(24, 16, 3)
    kw = dict(n_sample=256, noise_mags=[0.0, 0.3], pca_step=4, token_batch=4)
    want = jex.run_pca_perplexity(jp, jc, (1, "residual"), jnp.asarray(tokens), jnp.asarray(acts),
                                  {"Linear": [(jd, {"dict_size": 24})]}, tmp_path / "jax", **kw)
    got = tex.run_pca_perplexity(tp, tc, (1, "residual"), tokens, acts, {"Linear": [(td, {"dict_size": 24})]},
                                 tmp_path / "port", device="cpu", **kw)
    assert list(got) == list(want) == ["Linear", "Added Noise", "PCA (dynamic)", "PCA (static)"]
    for label in want:
        assert len(got[label]) == len(want[label]), label
        for i, (g, w) in enumerate(zip(got[label], want[label])):
            if label == "Added Noise" and i > 0:  # the port's own noise stream
                np.testing.assert_allclose(g[0], w[0], rtol=0.1, err_msg=label)
                np.testing.assert_allclose(g[1], w[1], rtol=0.05, err_msg=label)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=f"{label} {i}")
    assert got["Added Noise"][0][0] < 1e-5
    rows, jrows = _csv(tmp_path / "port" / "pca_perplexity.csv"), _csv(tmp_path / "jax" / "pca_perplexity.csv")
    keep = [i for i, r in enumerate(jrows) if i == 0 or r[0] != "Added Noise" or float(r[1]) < 1e-5]
    _close_rows([rows[i] for i in keep], [jrows[i] for i in keep])
    assert json.loads((tmp_path / "port" / "pca_perplexity.json").read_text()).keys() == want.keys()
    assert (tmp_path / "port" / "pca_perplexity.png").stat().st_size > 0


def test_embedding_cosine_check_matches_jax(tiny_lm, tmp_path):
    jc, tc, jp, tp, _ = tiny_lm
    je, te = _tied_pair(10, 16, 0, rows=np.asarray(jp["embed"][:10]))
    jr, tr = _tied_pair(10, 16, 4)
    want = jex.run_embedding_cosine_check(jp, {0: [("1", je)], 1: [("1", jr), ("2", je)]}, tmp_path / "jax")
    got = tex.run_embedding_cosine_check(tp, {0: [("1", te)], 1: [("1", tr), ("2", te)]}, tmp_path / "port")
    assert got.keys() == want.keys()
    for layer in want:
        assert [r for r, _, _ in got[layer]] == [r for r, _, _ in want[layer]]
        np.testing.assert_allclose([v for row in got[layer] for v in row[1:]],
                                   [v for row in want[layer] for v in row[1:]], rtol=1e-5)
    assert got[0][0][1] > 0.999 and got[1][0][1] < 0.9
    _close_rows(_csv(tmp_path / "port" / "embed_unembed.csv"), _csv(tmp_path / "jax" / "embed_unembed.csv"),
                numeric_from=2)
    assert (tmp_path / "port" / "embed_unembed.png").stat().st_size > 0
    # tied embeddings read the embedding for both panels
    tied = tex.embedding_cosine_scores(tp, {0: [("1", te)]}, tie_word_embeddings=True)
    assert tied[0][0][1] == tied[0][0][2]


def _results_folder(root, scores):
    for f, (s, top, rnd) in scores.items():
        folder = root / f"feature_{f:04d}"
        folder.mkdir(parents=True)
        (folder / "explanation.txt").write_text(
            f"something\nScore: {s:.2f}\nTop only score: {top:.2f}\nRandom only score: {rnd:.2f}\n")
    return root


@pytest.mark.parametrize("score_mode", ["random", "all", "top"])
def test_moment_corrs_match_jax(tmp_path, score_mode):
    jd, td = _tied_pair(12, 16, 5)
    chunk = np.random.default_rng(6).standard_normal((512, 16)).astype(np.float32)
    rng = np.random.default_rng(7)
    results = _results_folder(tmp_path / "results", {f: tuple(rng.random(3)) for f in range(8)})
    want = jex.run_moment_corrs([(jd, jnp.asarray(chunk), results)], tmp_path / "jax", score_mode=score_mode,
                                batch_size=128)
    got = tex.run_moment_corrs([(td, torch.from_numpy(chunk), results)], tmp_path / "port", score_mode=score_mode,
                               batch_size=128)
    for part in ("pooled", "pooled_log"):
        assert got[part].keys() == want[part].keys()
        for k in want[part]:
            atol = 1e-3 if k == "n_active" else 0.0
            rtol = 1e-3 if k.endswith(("skew", "kurtosis")) else 1e-5
            np.testing.assert_allclose(got[part][k], want[part][k], rtol=rtol, atol=atol, equal_nan=True,
                                       err_msg=f"{part} {k}")
    assert len(got["per_entry"]) == 1 and got["per_entry"][0].keys() == want["per_entry"][0].keys()
    rows, jrows = _csv(tmp_path / "port" / "moment_corrs.csv"), _csv(tmp_path / "jax" / "moment_corrs.csv")
    assert rows[0] == jrows[0] == ["entry", "feature", "score", "n_active", "mean", "var", "skew", "kurtosis",
                                   "l4_norm"]
    assert [r[:3] for r in rows] == [r[:3] for r in jrows]
    for col, rtol in ((3, 0), (4, 1e-5), (5, 1e-5), (6, 1e-3), (7, 1e-3), (8, 1e-5)):
        np.testing.assert_allclose([float(r[col]) for r in rows[1:]], [float(r[col]) for r in jrows[1:]], rtol=rtol,
                                   atol=1e-12, err_msg=rows[0][col])
    # an entry without scores is an empty per-entry record, as in JAX
    (tmp_path / "empty").mkdir()
    assert tex.run_moment_corrs([(td, torch.from_numpy(chunk), tmp_path / "empty")], tmp_path / "e")["per_entry"] == [{}]


def test_investigate_matches_jax(tmp_path):
    d = 32
    larger_rows = np.random.default_rng(7).standard_normal((64, d)).astype(np.float32)
    jl, tl = _tied_pair(64, d, 0, rows=larger_rows)
    small_rows = np.concatenate([np.asarray(jl.get_learned_dict())[:8],
                                 np.random.default_rng(8).standard_normal((8, d)).astype(np.float32)])
    js, ts = _tied_pair(16, d, 0, rows=small_rows)
    want = jex.run_investigate(js, jl, tmp_path / "jax", threshold=0.9)
    got = tex.run_investigate(ts, tl, tmp_path / "port", threshold=0.9)
    assert got.keys() == want.keys() and got["n_above_threshold"] == want["n_above_threshold"] >= 8
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, equal_nan=True, err_msg=k)
    assert json.loads((tmp_path / "port" / "investigate.json").read_text()).keys() == want.keys()
    assert all((tmp_path / "port" / f"{n}.png").exists() for n in ("entropy_vs_mmcs", "enn_vs_mmcs"))
    # the null distribution: the port's own draws, JAX's ENN on the same directions
    from sparse_coding__tpu.experiments.investigate import effective_number_of_neurons as jenn
    from sparse_coding__tpu.experiments.investigate import feature_entropy as jent
    from sparse_coding__tpu_torch.experiments.investigate import effective_number_of_neurons, feature_entropy

    dirs = _unit_rows(9, 200, d)
    np.testing.assert_allclose(effective_number_of_neurons(_t(dirs)).numpy(), np.asarray(jenn(jnp.asarray(dirs))),
                               rtol=1e-5)
    np.testing.assert_allclose(feature_entropy(_t(dirs)).numpy(), np.asarray(jent(jnp.asarray(dirs))), rtol=1e-5)
    mean_enn = tex.random_feature_diversity(tmp_path / "port", n=500, d=d, device="cpu")
    assert 2 < mean_enn < d and (tmp_path / "port" / "enn_randn.png").exists()


def test_dict_compare_and_across_time_match_jax():
    feats = _unit_rows(0, 16, 8)
    pairs = [(_rotation_pair(feats), _rotation_pair(feats)),
             (_rotation_pair(feats), _rotation_pair(_unit_rows(1, 32, 8))),
             (_rotation_pair(feats), _rotation_pair(np.concatenate([feats, _unit_rows(2, 16, 8)]))),
             (_rotation_pair(np.stack([feats[3], feats[1]])), _rotation_pair(feats[:5]))]
    for (ja, ta), (jb, tb) in pairs:
        want, got = jex.dict_compare(ja, jb), tex.dict_compare(ta, tb)
        assert np.array_equal(got["assignment"], want["assignment"]) and got["n_shared"] == want["n_shared"]
        np.testing.assert_allclose(got["matched_sims"], want["matched_sims"], atol=1e-5)
        for k in ("frac_shared", "mmcs_a_to_b", "mmcs_b_to_a"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    rng = np.random.default_rng(3)
    points = {}
    for k, s in ((1, 1.0), (4, 0.3), (16, 0.0)):
        m = feats + s * rng.standard_normal(feats.shape).astype(np.float32)
        points[k] = m / np.linalg.norm(m, axis=1, keepdims=True)
    want = jex.dict_across_time({k: JaxRotation(jnp.asarray(v)) for k, v in points.items()})
    got = tex.dict_across_time({k: Rotation(_t(v)) for k, v in points.items()})
    assert [r["save_point"] for r in got] == [r["save_point"] for r in want] == [1, 4, 16]
    for g, w in zip(got, want):
        np.testing.assert_allclose([g["mean_matched_mcs"], g["frac_shared"]],
                                   [w["mean_matched_mcs"], w["frac_shared"]], rtol=1e-5)
    assert tex.dict_across_time({}) == []


def test_inter_layer_mcs_matches_jax():
    mats = {0: _unit_rows(0, 10, 6), 1: _unit_rows(1, 10, 6), 2: _unit_rows(0, 10, 6), 3: _unit_rows(5, 14, 6)}
    want, wl = jex.inter_layer_mcs({k: JaxRotation(jnp.asarray(v)) for k, v in mats.items()})
    got, gl = tex.inter_layer_mcs({k: Rotation(_t(v)) for k, v in mats.items()})
    assert gl == wl == [0, 1, 2, 3] and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_inter_dict_connections_match_jax():
    d = 8
    feats_a = _unit_rows(0, 6, d)
    feats_b = np.concatenate([feats_a[:1], _unit_rows(1, 5, d)])
    rng = np.random.default_rng(2)
    x = (rng.random((256, 1)) * feats_a[0][None, :] + 0.01 * rng.standard_normal((256, d))).astype(np.float32)
    (ja, ta), (jb, tb) = _rotation_pair(feats_a), _rotation_pair(feats_b)
    want = jex.inter_dict_connections(ja, jb, jnp.asarray(x), jnp.asarray(x), top_k=3)
    got = tex.inter_dict_connections(ta, tb, _t(x), _t(x), top_k=3)
    np.testing.assert_allclose(got["correlation"], want["correlation"], rtol=1e-5, atol=1e-6)
    assert [(u, v) for u, v, _ in got["top_connections"]] == [(u, v) for u, v, _ in want["top_connections"]]
    assert got["top_connections"][0][:2] == (0, 0) and got["top_connections"][0][2] > 0.95
    with pytest.raises(ValueError, match="row-aligned"):
        tex.inter_dict_connections(ta, tb, _t(x), _t(x[:10]))


@pytest.mark.parametrize("layer_loc,n_in", [("residual", 16), ("mlp", 32)])
def test_feature_case_study_matches_jax(layer_loc, n_in):
    cfg_kw = dict(LM_KW, n_ctx=16, rotary_pct=0.25)
    jc, tc = JaxLMConfig(**cfg_kw), LMConfig(**cfg_kw)
    jp = jax_init_params(jax.random.PRNGKey(0), jc)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jd, td = _tied_pair(12, n_in, 1)
    fragments = np.random.default_rng(2).integers(0, 64, (24, 8)).astype(np.int32)
    decode = lambda row: [f"tok{int(t)}" for t in row]  # noqa: E731
    kw = dict(n_top_fragments=4, batch_size=16)
    want = jex.feature_case_study(jp, jc, jd, 1, layer_loc, fragments, decode, 3, **kw)
    got = tex.feature_case_study(tp, tc, td, 1, layer_loc, fragments, decode, 3, **kw)
    assert [t for t, _ in got["fragments"]] == [t for t, _ in want["fragments"]]
    np.testing.assert_allclose([a for _, acts in got["fragments"] for a in acts],
                               [a for _, acts in want["fragments"] for a in acts], rtol=1e-5, atol=1e-6)
    if layer_loc == "residual":
        assert [t for t, _ in got["top_logit_tokens"]] == [t for t, _ in want["top_logit_tokens"]]
        np.testing.assert_allclose([v for _, v in got["top_logit_tokens"]], [v for _, v in want["top_logit_tokens"]],
                                   rtol=1e-5)
    else:
        assert got["top_logit_tokens"] is None is want["top_logit_tokens"]
    assert tex.render_case_study(got, decode_token=lambda t: f"tok{t}") == jex.render_case_study(
        want, decode_token=lambda t: f"tok{t}")
    with pytest.raises(ValueError, match="out of range"):
        tex.feature_case_study(tp, tc, td, 1, layer_loc, fragments, decode, 50)


def test_the_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    """The CLIs resolve ``--device`` (None = cuda): without a card they
    raise rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    from sparse_coding__tpu_torch.experiments import check_l0_tokens, investigate, pca_perplexity

    for main, argv in ((pca_perplexity.main, ["--dicts", "a", "--labels", "a", "--chunk", "c", "--tokens", "t",
                                              "--lm-params", "p", "--layer", "1"]),
                       (check_l0_tokens.main, ["--lm-params", "p", "--dicts", "0:1:a"]),
                       (investigate.main, ["--smaller", "a:0", "--larger", "b:0"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv + ["--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex.pca_perplexity_scores(None, None, (1, "residual"), np.zeros((4, 4), np.int32), np.zeros((8, 4)), {})
