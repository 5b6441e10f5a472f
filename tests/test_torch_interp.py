"""The port's autointerp (`interp/`) against the JAX package's, on the CPU: a
NeoX subject of 2 layers, d 16, vocab 64 (JAX params carried across by
`interop.lm_params_from_jax`), 48 numpy-seeded fragments of 8 tokens,
numpy-seeded TiedSAE dicts of 12 features.

Tolerances:
  - activation frames: the same columns in the same order, token strings
    equal, values within atol 1e-6;
  - the device half (`_fragment_codes`): each dict's codes the bits of its
    own capture forward + encode;
  - `select_records`, `TokenLexiconClient`, `interpret` and
    `read_results`: fed the same (JAX's) frame, the same records, scores,
    explanation files and result frames;
  - result folders and dictionary files: readable by both packages.
Two packages' codes one ulp apart can reorder near-ties in the per-feature
sort, so record selection is held on one frame.
"""

import json
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from sparse_coding__tpu import interp as jinterp
from sparse_coding__tpu.lm import model as jlm
from sparse_coding__tpu.models.learned_dict import TiedSAE as JTied
from sparse_coding__tpu.train.checkpoint import save_learned_dicts as jax_save_dicts
from sparse_coding__tpu.utils.config import InterpArgs as JInterpArgs
from sparse_coding__tpu.utils.config import InterpGraphArgs as JInterpGraphArgs
from sparse_coding__tpu_torch import interp as tinterp
from sparse_coding__tpu_torch.interop import lm_params_from_jax
from sparse_coding__tpu_torch.interp import pipeline as tpipe
from sparse_coding__tpu_torch.lm import model as tlm
from sparse_coding__tpu_torch.models.learned_dict import TiedSAE
from sparse_coding__tpu_torch.train.checkpoint import save_learned_dicts
from sparse_coding__tpu_torch.utils.config import InterpArgs, InterpGraphArgs

REPO = Path(__file__).resolve().parents[1]
KW = dict(arch="neox", n_layers=2, d_model=16, n_heads=2, d_mlp=32, vocab_size=64, n_ctx=16, rotary_pct=0.25)


def decode(row):
    return [f"tok{int(t)}" for t in row]


@pytest.fixture(scope="module")
def setup():
    jc, tc = jlm.LMConfig(**KW), tlm.LMConfig(**KW)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(3)
    encs = [rng.normal(size=(12, 16)).astype(np.float32) for _ in range(3)]
    jd = [JTied(jnp.asarray(e), jnp.zeros(12), norm_encoder=True) for e in encs]
    td = [TiedSAE(torch.from_numpy(e), torch.zeros(12), norm_encoder=True) for e in encs]
    fragments = rng.integers(0, 64, (48, 8)).astype(np.int32)
    return jc, tc, jp, tp, jd, td, fragments


def _frames(setup, max_features=0, batch_size=16):
    jc, tc, jp, tp, jd, td, fragments = setup
    want = jinterp.make_feature_activation_datasets(jp, jc, jd[:2], 1, "residual", fragments, decode,
                                                    max_features=max_features, batch_size=batch_size)
    got = tinterp.make_feature_activation_datasets(tp, tc, td[:2], 1, "residual", fragments, decode,
                                                   max_features=max_features, batch_size=batch_size, device="cpu")
    return got, want


@pytest.mark.parametrize("max_features,batch_size", [(0, 16), (5, 20)])
def test_frames_match_jax(setup, max_features, batch_size):
    """Whole batches and a padded last one; all features or the first 5."""
    got, want = _frames(setup, max_features, batch_size)
    for g, w in zip(got, want):
        assert list(g.columns) == list(w.columns) and len(g) == len(w) == 48
        assert g["fragment_token_strs"].tolist() == w["fragment_token_strs"].tolist()
        num = [c for c in w.columns if c != "fragment_token_strs"]
        np.testing.assert_allclose(g[num].to_numpy(), w[num].to_numpy(), rtol=0, atol=1e-6)


def test_device_half_is_each_dicts_capture_and_encode(setup):
    _, tc, _, tp, _, td, fragments = setup
    codes = tpipe._fragment_codes(tp, tc, td, 1, "residual", fragments, max_features=7, batch_size=16, device="cpu")
    name = tlm.make_tensor_name(1, "residual")
    for d, c in zip(td, codes):
        parts = []
        for s in range(0, 48, 16):
            _, cache = tlm.forward(tp, torch.from_numpy(fragments[s:s + 16]), tc, cache_names=[name], stop_at_layer=2)
            parts.append(d.encode(cache[name].reshape(-1, 16)).reshape(16, 8, -1)[:, :, :7])
        assert c.shape == (48, 8, 7) and np.array_equal(c, torch.cat(parts).numpy())


def test_single_dict_frame_is_the_multi_dict_frame(setup):
    _, tc, _, tp, _, td, fragments = setup
    multi = tinterp.make_feature_activation_datasets(tp, tc, td[:2], 1, "residual", fragments, decode,
                                                     batch_size=16, device="cpu")
    single = tinterp.make_feature_activation_dataset(tp, tc, td[1], 1, "residual", fragments, decode,
                                                     batch_size=16, device="cpu")
    pd.testing.assert_frame_equal(multi[1], single)


@pytest.mark.parametrize("feat", [0, 3, 11])
def test_select_records_on_jax_frame(setup, feat):
    _, want = _frames(setup)
    df = want[0]
    j, t = jinterp.select_records(df, feat, 8), tinterp.select_records(df, feat, 8)
    if j is None:
        assert t is None
        return
    assert t.feature_index == j.feature_index
    for tr, jr in zip(t.most_positive_activation_records + t.random_sample,
                      j.most_positive_activation_records + j.random_sample):
        assert tr.tokens == jr.tokens and list(map(float, tr.activations)) == list(map(float, jr.activations))


def test_lexicon_client_scores_match_jax():
    rng = np.random.default_rng(4)
    records = [jinterp.ActivationRecord([f"t{k}" for k in rng.integers(0, 9, 8)],
                                        list(np.maximum(rng.normal(size=8), 0.0))) for _ in range(20)]
    trecs = [tinterp.ActivationRecord(r.tokens, r.activations) for r in records]
    je = jinterp.TokenLexiconClient().explain(records, 3.0)
    te = tinterp.TokenLexiconClient().explain(trecs, 3.0)
    assert te == je
    for r in records[:5]:
        assert tinterp.TokenLexiconClient().simulate(te, r.tokens) == jinterp.TokenLexiconClient().simulate(je, r.tokens)
    sims = [tinterp.SequenceSimulation(r.tokens, r.activations, tinterp.TokenLexiconClient().simulate(te, r.tokens))
            for r in trecs]
    jsims = [jinterp.SequenceSimulation(r.tokens, r.activations, jinterp.TokenLexiconClient().simulate(je, r.tokens))
             for r in records]
    assert tinterp.aggregate_scored_sequence_simulations(sims) == jinterp.aggregate_scored_sequence_simulations(jsims)
    assert tinterp.expected_activation_from_digit_logprobs({" 3": -0.1, "7": -2.0}) == \
        jinterp.expected_activation_from_digit_logprobs({" 3": -0.1, "7": -2.0})


def test_interpret_result_folders_match_and_load_both_ways(tmp_path, setup):
    _, want = _frames(setup)
    df = want[0]
    jinterp.interpret(df, tmp_path / "jax", 4, client=jinterp.TokenLexiconClient(), fragment_len=8)
    tinterp.interpret(df, tmp_path / "port", 4, client=tinterp.TokenLexiconClient(), fragment_len=8)
    jf = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*"))
    tf = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*"))
    assert tf == jf and any(p.name == "scored_simulation.pkl" for p in tf)
    for rel in tf:
        if rel.name == "explanation.txt":
            assert (tmp_path / "port" / rel).read_text() == (tmp_path / "jax" / rel).read_text()
    pd.testing.assert_frame_equal(tinterp.read_results(tmp_path / "port"), jinterp.read_results(tmp_path / "jax"))
    for mode in ("all", "top", "random"):
        assert tinterp.read_transform_scores(tmp_path / "port", mode) == jinterp.read_transform_scores(tmp_path / "jax", mode)
    from sparse_coding__tpu_torch.utils import pickles

    for rel in [r for r in tf if r.suffix == ".pkl"]:
        port_bytes, jax_bytes = (tmp_path / "port" / rel).read_bytes(), (tmp_path / "jax" / rel).read_bytes()
        assert b"torch" not in port_bytes
        from_port = pickle.loads(port_bytes)  # the JAX package reads the port's
        assert type(from_port).__module__ == "sparse_coding__tpu.interp.records"
        from_jax = pickles.loads(jax_bytes, device="cpu")  # and the port the JAX package's
        assert type(from_jax).__module__ == "sparse_coding__tpu_torch.interp.records"
        if rel.name == "scored_simulation.pkl":
            assert from_jax.get_preferred_score() == from_port.get_preferred_score()


def test_get_df_caches_to_parquet(tmp_path, setup):
    _, tc, _, tp, _, td, fragments = setup
    kw = dict(layer=1, layer_loc="residual", fragments=fragments, decode_tokens=decode, n_feats=4, save_loc=tmp_path,
              batch_size=16, device="cpu")
    df1 = tinterp.get_df(td[0], tp, tc, **kw)
    assert (tmp_path / "activation_df.parquet").exists()
    pd.testing.assert_frame_equal(df1, tinterp.get_df(td[0], tp, tc, **kw))


def _icfg(save_loc, **kw):
    return InterpArgs(layer=1, layer_loc="residual", n_feats_explain=2, df_n_feats=12, save_loc=str(save_loc), **kw)


def _ctx(setup):
    _, tc, _, tp, _, _, fragments = setup
    return tinterp.InterpContext(tp, tc, fragments, decode, client=tinterp.TokenLexiconClient(), device="cpu")


def test_run_many_and_run_folder(tmp_path, setup):
    _, _, _, _, jd, td, _ = setup
    out = tinterp.run_many([("sparse_coding", td[0]), ("random", td[1])], _icfg(tmp_path / "many"), _ctx(setup))
    assert [p.name for p in out] == ["sparse_coding", "random"]
    assert all((p / "activation_df.parquet").exists() and any(p.glob("feature_*")) for p in out)
    scores = tinterp.read_scores(tmp_path / "many")
    assert list(scores)[0] == "sparse_coding"
    # a folder holding both packages' files: an export of each, a JAX plain pickle
    folder = tmp_path / "dicts"
    folder.mkdir()
    jax_save_dicts(folder / "a.pkl", [(jd[0], {"l1_alpha": 1e-3}), (jd[1], {"l1_alpha": 2e-3})])
    save_learned_dicts(folder / "b.pkl", [(td[2], {})])
    with open(folder / "c.pkl", "wb") as f:
        pickle.dump(jd[2], f)
    cfg = _icfg(tmp_path / "folder", load_interpret_autoencoder=str(folder))
    out = tinterp.run_folder(cfg, _ctx(setup))
    assert [p.name for p in out] == ["a", "a_l1_alpha_0.002", "b", "c"]
    assert all(any(p.glob("feature_*")) for p in out)


def test_batch_helpers_match_jax():
    for hp in ({"tied": True, "dict_size": 512, "l1_alpha": 8.5e-4, "bias_decay": 0.0}, {"l1_alpha": 1e-3}, {}):
        assert tinterp.make_tag_name(hp) == jinterp.make_tag_name(hp)
    for name in ("tied_residual_l2_r4", "untied_mlp_l5_r0_extra_x"):
        assert tinterp.parse_folder_name(name) == jinterp.parse_folder_name(name)


def test_interpret_across_baselines_skips_nmf(tmp_path, setup):
    _, _, _, _, jd, td, _ = setup
    bdir = tmp_path / "baselines" / "l1_residual"
    bdir.mkdir(parents=True)
    with open(bdir / "pca.pkl", "wb") as f:
        pickle.dump(jd[0], f)  # a JAX plain pickle, the baselines-runner format
    with open(bdir / "nmf.pkl", "wb") as f:
        pickle.dump(jd[1], f)
    out = tinterp.interpret_across_baselines(_icfg(tmp_path / "unused"), _ctx(setup), tmp_path / "baselines",
                                             save_dir=tmp_path / "res")
    assert [p.name for p in out] == ["pca"]


def test_read_results_violins_wait_for_plotting(tmp_path, setup):
    _, _, _, _, _, td, _ = setup
    assert tinterp.read_results.__module__ == "sparse_coding__tpu_torch.interp.pipeline"
    from sparse_coding__tpu_torch.interp import batch as tbatch

    (tmp_path / "empty").mkdir()
    assert tbatch.read_results("empty", "top", results_base=tmp_path) is None
    tinterp.run_many([("sparse_coding", td[0])], _icfg(tmp_path / "l1_residual"), _ctx(setup))
    # the violins are drawn now (`plotting`; their data against JAX's in
    # tests/test_torch_plotting.py)
    out = tbatch.read_results("l1_residual", "top", results_base=tmp_path)
    assert out == tmp_path / "l1_residual" / "top_means_and_violin.png" and out.stat().st_size > 0


def test_interp_args_match_jax_field_for_field():
    import dataclasses

    for t, j in ((InterpArgs, JInterpArgs), (InterpGraphArgs, JInterpGraphArgs)):
        assert [(f.name, f.default) for f in dataclasses.fields(t)] == [(f.name, f.default) for f in dataclasses.fields(j)]
    with pytest.raises(ValueError, match="sort_mode"):
        InterpArgs(sort_mode="median")
    with pytest.raises(ValueError, match="bad score_mode"):
        InterpGraphArgs(score_mode="best")


def test_cli_runs_on_the_cpu_from_jax_written_inputs(tmp_path, setup):
    """``python -m sparse_coding__tpu_torch.interp --device cpu`` on a JAX
    pickle of (params, LMConfig), a fragments .npy, a vocab json and a JAX
    export; the process imports no JAX."""
    jc, _, jp, _, jd, _, fragments = setup
    with open(tmp_path / "lm.pkl", "wb") as f:
        pickle.dump((jp, jc), f)
    np.save(tmp_path / "fragments.npy", fragments)
    (tmp_path / "vocab.json").write_text(json.dumps([f"tok{i}" for i in range(64)]))
    jax_save_dicts(tmp_path / "sparse_coding.pkl", [(jd[0], {"l1_alpha": 1e-3})])
    code = (
        "import sys\n"
        "from sparse_coding__tpu_torch.interp.__main__ import main\n"
        f"main({['--load_interpret_autoencoder', str(tmp_path / 'sparse_coding.pkl'), '--lm_params', str(tmp_path / 'lm.pkl'), '--fragments', str(tmp_path / 'fragments.npy'), '--token_strs', str(tmp_path / 'vocab.json'), '--layer', '1', '--layer_loc', 'residual', '--n_feats_explain', '2', '--df_n_feats', '12', '--results_base', str(tmp_path / 'res'), '--device', 'cpu']!r})\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m.startswith('sparse_coding__tpu.'))\n"
        "sys.exit(3 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300,
                          env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    result = tmp_path / "res" / "l1_residual" / "sparse_coding"
    assert (result / "activation_df.parquet").exists() and any(result.glob("feature_*/explanation.txt"))
    with pytest.raises(SystemExit, match="unknown mode"):
        from sparse_coding__tpu_torch.interp.__main__ import main

        main(["bogus", "--device", "cpu"])
