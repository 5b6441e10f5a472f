"""The port's LM-side evaluation (`metrics/intervention.py`) against the JAX
package's, on the CPU: a NeoX subject of 2 layers, d 16, vocab 64 (and one
GPT-2 case), its JAX params carried across by `interop.lm_params_from_jax`,
8 × 12 numpy-seeded tokens, numpy-seeded dictionaries.

Tolerances:
  - edited tensors, losses and codes: rtol 1e-5 / atol 1e-6;
  - ablation graphs: the same keys in the same order, every weight within
    1e-5 of the largest edge;
  - `calculate_perplexity(vmapped=True)` against ``vmapped=False``, and the
    ablation sweep against a per-feature loop of the public hooks: bit for
    bit;
  - error messages: JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding__tpu import metrics as jmetrics
from sparse_coding__tpu.lm import model as jlm
from sparse_coding__tpu.metrics import intervention as jint
from sparse_coding__tpu.models import learned_dict as jld
from sparse_coding__tpu_torch import metrics as tmetrics
from sparse_coding__tpu_torch.interop import lm_params_from_jax
from sparse_coding__tpu_torch.lm import model as tlm
from sparse_coding__tpu_torch.metrics import intervention as tint
from sparse_coding__tpu_torch.models import learned_dict as tld

RTOL, ATOL = 1e-5, 1e-6
NEOX = dict(arch="neox", n_layers=2, d_model=16, n_heads=2, d_mlp=32, vocab_size=64, n_ctx=32, rotary_pct=0.25)
GPT2 = dict(arch="gpt2", n_layers=2, d_model=16, n_heads=2, d_mlp=32, vocab_size=64, n_ctx=32,
            tie_word_embeddings=True, parallel_residual=False)


def _subject(kw, seed=0):
    jc, tc = jlm.LMConfig(**kw), tlm.LMConfig(**kw)
    jp = jlm.init_params(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def neox():
    return _subject(NEOX)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(1).integers(0, 64, (8, 12)).astype(np.int32)


def _tied(seed, n, d=16, bias=0.0):
    """The same TiedSAE in both packages (numpy-seeded, normalized encoder)."""
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(n, d)).astype(np.float32)
    b = (bias * rng.normal(size=n)).astype(np.float32)
    return (jld.TiedSAE(jnp.asarray(enc), jnp.asarray(b), norm_encoder=True),
            tld.TiedSAE(torch.from_numpy(enc), torch.from_numpy(b), norm_encoder=True))


def _untied(seed, n, d=16):
    rng = np.random.default_rng(seed)
    e, dec = (rng.normal(size=(n, d)).astype(np.float32) for _ in range(2))
    b = (0.1 * rng.normal(size=n)).astype(np.float32)
    return (jld.UntiedSAE(jnp.asarray(e), jnp.asarray(dec), jnp.asarray(b)),
            tld.UntiedSAE(torch.from_numpy(e), torch.from_numpy(dec), torch.from_numpy(b)))


def _identity(d=16):
    return jld.Identity(d), tld.Identity(d, device="cpu")


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t, np.asarray(j),
                               rtol=rtol, atol=atol)


def _graphs_agree(tg, jg):
    assert list(tg) == list(jg)
    scale = max(abs(v) for v in jg.values())
    assert max(abs(tg[k] - jg[k]) for k in jg) <= 1e-5 * scale
    assert scale > 0


# -- hooks and caches ---------------------------------------------------------------

HOOKS = {
    "reconstruction": (lambda m, f: jint.replace_with_reconstruction_hook(m),
                       lambda m, f: tint.replace_with_reconstruction_hook(m)),
    "positional": (jint.ablate_feature_intervention, tint.ablate_feature_intervention),
    "non_positional": (jint.ablate_feature_intervention_non_positional,
                       tint.ablate_feature_intervention_non_positional),
}


@pytest.mark.parametrize("name", sorted(HOOKS))
def test_hooks_edit_the_tensor_as_jax(name):
    jhook, thook = HOOKS[name]
    jd, td = _tied(3, 24, bias=0.1)
    x = np.random.default_rng(4).normal(size=(3, 5, 16)).astype(np.float32)
    feature = (2, 7) if name == "positional" else 7
    want = jhook(jd, feature)(jnp.asarray(x))
    _close(thook(td, feature)(torch.from_numpy(x)), want)
    if name != "reconstruction":  # a device tensor index gives the int index's bits
        tensor_feature = torch.tensor(feature)
        assert torch.equal(thook(td, tensor_feature)(torch.from_numpy(x)), thook(td, feature)(torch.from_numpy(x)))


@pytest.mark.parametrize("feature", [(-1, 7), (2, -3), (-5, -1)])
@pytest.mark.parametrize("name", ["positional", "non_positional"])
def test_hooks_count_negative_indices_from_the_end_as_jax(name, feature):
    jhook, thook = HOOKS[name]
    jd, td = _tied(3, 24, bias=0.1)
    x = np.random.default_rng(4).normal(size=(3, 5, 16)).astype(np.float32)
    if name == "non_positional":
        feature = feature[1]
    want = jhook(jd, feature)(jnp.asarray(x))
    _close(thook(td, feature)(torch.from_numpy(x)), want)
    assert torch.equal(thook(td, torch.tensor(feature))(torch.from_numpy(x)), thook(td, feature)(torch.from_numpy(x)))


def test_positional_hook_leaves_other_positions_alone():
    _, td = _tied(5, 24, bias=0.1)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(3, 5, 16)).astype(np.float32))
    idx = int(td.encode(x[:, 2]).sum(dim=0).argmax())  # a feature that fires at position 2
    y = tint.ablate_feature_intervention(td, (2, idx))(x)
    keep = [0, 1, 3, 4]
    assert torch.equal(y[:, keep], x[:, keep]) and not torch.equal(y[:, 2], x[:, 2])


@pytest.mark.parametrize("hooked", [False, True])
def test_cache_all_activations_matches_jax(neox, tokens, hooked):
    jc, tc, jp, tp = neox
    jd, td = _tied(7, 24)
    jm_, tm_ = {(0, "residual"): jd, (1, "mlp"): jld.Identity(32)}, {(0, "residual"): td, (1, "mlp"): tld.Identity(32, device="cpu")}
    jh = th = None
    if hooked:
        name = jint.get_model_tensor_name((0, "residual"))
        jh = {name: jint.ablate_feature_intervention_non_positional(jd, 3)}
        th = {name: tint.ablate_feature_intervention_non_positional(td, 3)}
    want = jint.cache_all_activations(jp, jc, jm_, jnp.asarray(tokens), hooks=jh)
    got = tint.cache_all_activations(tp, tc, tm_, tokens, hooks=th, device="cpu")
    assert list(got) == list(want)
    for loc in want:
        assert got[loc].shape == want[loc].shape
        _close(got[loc], want[loc])


def test_cache_all_activations_equals_run_with_cache_and_encode(neox, tokens):
    """Stopping the forward after the last block it needs keeps the full
    forward's bits."""
    _, tc, _, tp = neox
    _, td = _tied(8, 24)
    got = tint.cache_all_activations(tp, tc, {(0, "residual"): td}, tokens, device="cpu")[(0, "residual")]
    name = tlm.make_tensor_name(0, "residual")
    _, cache = tlm.run_with_cache(tp, torch.from_numpy(tokens), tc, [name])
    want = td.encode(cache[name].reshape(-1, 16)).reshape(8, 12, -1)
    assert torch.equal(got, want)


# -- perplexity ---------------------------------------------------------------------

DICTS = {"identity": _identity, "tied": lambda: _tied(9, 24, bias=0.1), "untied": lambda: _untied(10, 32)}


@pytest.mark.parametrize("arch", ["neox", "gpt2"])
@pytest.mark.parametrize("kind", sorted(DICTS))
def test_perplexity_under_reconstruction_matches_jax(neox, tokens, arch, kind):
    jc, tc, jp, tp = neox if arch == "neox" else _subject(GPT2, seed=2)
    jd, td = DICTS[kind]()
    for loc in [(0, "residual"), (1, "residual")]:
        want = jint.perplexity_under_reconstruction(jp, jc, jd, loc, jnp.asarray(tokens))
        got = tint.perplexity_under_reconstruction(tp, tc, td, loc, tokens, device="cpu")
        assert got.ndim == 0
        _close(got, want)
    if kind == "identity":  # the identity dict's "reconstruction" is the base loss
        base = float(tlm.lm_loss(tp, torch.from_numpy(tokens), tc))
        assert abs(float(got) - base) < 1e-5


@pytest.mark.parametrize("batch_size", [4, 5, 16])
def test_calculate_perplexity_matches_jax(neox, tokens, batch_size):
    """Batch sizes that split the rows evenly, leave a partial batch (12 //
    5: 10 rows scored) and exceed them (one batch of all 8 rows)."""
    jc, tc, jp, tp = neox
    pairs = [_identity(), _tied(11, 24), _tied(12, 24), _untied(13, 32), _tied(14, 12)]
    hps = [{"id": i} for i in range(len(pairs))]
    rows = np.concatenate([tokens, tokens[:4]])
    jb, jr = jint.calculate_perplexity(jp, jc, [(j, hp) for (j, _), hp in zip(pairs, hps)], (1, "residual"),
                                       jnp.asarray(rows), batch_size=batch_size)
    tb, tr = tint.calculate_perplexity(tp, tc, [(t, hp) for (_, t), hp in zip(pairs, hps)], (1, "residual"),
                                       rows, batch_size=batch_size, device="cpu")
    np.testing.assert_allclose(tb, jb, rtol=RTOL, atol=ATOL)
    assert [hp for hp, _ in tr] == hps
    np.testing.assert_allclose([v for _, v in tr], [v for _, v in jr], rtol=RTOL, atol=ATOL)
    assert abs(tr[0][1] - tb) < 1e-5


def test_calculate_perplexity_vmapped_equals_per_dict_bits(neox, tokens):
    _, tc, _, tp = neox
    dicts = [(_tied(20, 24)[1], {"i": 0}), (_tied(21, 24)[1], {"i": 1}), (_identity()[1], {"i": 2}),
             (_untied(22, 32)[1], {"i": 3})]
    bv, rv = tint.calculate_perplexity(tp, tc, dicts, (0, "residual"), tokens, batch_size=4, vmapped=True,
                                       device="cpu")
    bs, rs = tint.calculate_perplexity(tp, tc, dicts, (0, "residual"), tokens, batch_size=4, vmapped=False,
                                       device="cpu")
    assert bv == bs and rv == rs


def test_calculate_perplexity_refuses_empty_tokens(neox):
    jc, tc, jp, tp = neox
    empty = np.zeros((0, 12), np.int32)
    with pytest.raises(ValueError) as jerr:
        jint.calculate_perplexity(jp, jc, [], (0, "residual"), jnp.asarray(empty))
    with pytest.raises(ValueError) as terr:
        tint.calculate_perplexity(tp, tc, [], (0, "residual"), empty, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_mean_reconstruction_loss_matches_jax(neox, tokens):
    jc, tc, jp, tp = neox
    jd, td = _tied(15, 24, bias=0.05)
    batches = tokens.reshape(2, 4, 12)
    want = jint.mean_reconstruction_loss(jp, jc, jd, (1, "mlpout"), batches)
    got = tint.mean_reconstruction_loss(tp, tc, td, (1, "mlpout"), batches, device="cpu")
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -- ablation graphs ----------------------------------------------------------------

def _two_site_models(seed, n=8):
    jd, td = _tied(seed, n)
    jd2, td2 = _tied(seed + 100, n)
    return {(0, "residual"): jd, (1, "residual"): jd2}, {(0, "residual"): td, (1, "residual"): td2}


@pytest.mark.parametrize("arch", ["neox", "gpt2"])
def test_non_positional_graph_matches_jax(neox, tokens, arch):
    jc, tc, jp, tp = neox if arch == "neox" else _subject(GPT2, seed=2)
    jm_, tm_ = _two_site_models(30)
    kw = dict(features_to_ablate={(0, "residual"): [0, 3, 5]}, target_features={(1, "residual"): [1, 2, 6]})
    jg = jint.build_ablation_graph_non_positional(jp, jc, jm_, jnp.asarray(tokens), **kw)
    tg = tint.build_ablation_graph_non_positional(tp, tc, tm_, tokens, device="cpu", **kw)
    assert len(tg) == 3 * (2 + 3)
    _graphs_agree(tg, jg)


def test_positional_graph_matches_jax(neox, tokens):
    jc, tc, jp, tp = neox
    jm_, tm_ = _two_site_models(31)
    # at each ablated position the feature that fires most on the batch, so
    # edges stand above the f32 noise floor of both packages' sums
    codes = tint.cache_all_activations(tp, tc, tm_, tokens, device="cpu")[(0, "residual")].sum(dim=0)
    ablate = [(p, int(codes[p].argmax())) for p in (0, 2, 7)]
    kw = dict(features_to_ablate={(0, "residual"): ablate},
              target_features={(1, "residual"): [(7, 1), (9, 2), (11, 4)]})
    _graphs_agree(tint.build_ablation_graph(tp, tc, tm_, tokens, device="cpu", **kw),
                  jint.build_ablation_graph(jp, jc, jm_, jnp.asarray(tokens), **kw))


@pytest.mark.parametrize("positional", [False, True])
def test_default_ablation_sets_match_jax(neox, tokens, positional):
    """Every feature (and every position) of every dict ablated: the JAX
    package's default sets, key order and self-edge exclusion."""
    jc, tc, jp, tp = neox
    jd, td = _tied(32, 4)
    toks = tokens[:, :3] if positional else tokens
    fn_j = jint.build_ablation_graph if positional else jint.build_ablation_graph_non_positional
    fn_t = tint.build_ablation_graph if positional else tint.build_ablation_graph_non_positional
    jg = fn_j(jp, jc, {(1, "residual"): jd}, jnp.asarray(toks))
    tg = fn_t(tp, tc, {(1, "residual"): td}, toks, device="cpu")
    n = 4 * 3 if positional else 4
    assert len(tg) == n * (n - 1)
    _graphs_agree(tg, jg)


def test_ablation_graph_refuses_features_without_a_dict(neox, tokens):
    jc, tc, jp, tp = neox
    jd, td = _tied(33, 8)
    kw = dict(features_to_ablate={(0, "residual"): [0]}, target_features={(1, "mlp"): [2]})
    with pytest.raises(ValueError) as jerr:
        jint.build_ablation_graph_non_positional(jp, jc, {(0, "residual"): jd}, jnp.asarray(tokens), **kw)
    with pytest.raises(ValueError) as terr:
        tint.build_ablation_graph_non_positional(tp, tc, {(0, "residual"): td}, tokens, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("positional", [False, True])
def test_ablation_sweep_equals_a_loop_of_the_public_hooks(neox, tokens, positional):
    """The sweep's rows are the bits of a per-feature loop over
    `cache_all_activations(hooks=)`, reduced with the same reads."""
    _, tc, _, tp = neox
    _, tm_ = _two_site_models(34)
    site = (0, "residual")
    if positional:
        ablate, target = [(0, 1), (4, 6)], [(4, 2), (9, 7)]
        build, make_hook, read = tint.build_ablation_graph, tint.ablate_feature_intervention, tint._read_feature_positional
    else:
        ablate, target = [1, 6], [0, 7]
        build, make_hook = tint.build_ablation_graph_non_positional, tint.ablate_feature_intervention_non_positional
        read = tint._read_feature_non_positional
    graph = build(tp, tc, tm_, tokens, features_to_ablate={site: ablate}, target_features={(1, "residual"): target},
                  device="cpu")
    base = tint.cache_all_activations(tp, tc, tm_, tokens, device="cpu")
    name = tint.get_model_tensor_name(site)
    t_all = {site: torch.tensor(ablate), (1, "residual"): torch.tensor(target)}
    for feature in ablate:
        acts = tint.cache_all_activations(tp, tc, tm_, tokens, hooks={name: make_hook(tm_[site], feature)}, device="cpu")
        for loc, t in t_all.items():
            row = torch.abs(read(base[loc][None], t) - read(acts[loc][None], t))[0].mean(dim=0)
            for j, f in enumerate(t.tolist()):
                f = tuple(f) if positional else f
                if loc == site and f == feature:
                    continue
                assert graph[((site, feature), (loc, f))] == float(row[j])


def test_metrics_package_exports_the_jax_names():
    names = [n for n in dir(jmetrics) if not n.startswith("_") and n not in ("clustering", "intervention", "standard")]
    assert [n for n in names if not hasattr(tmetrics, n)] == []
