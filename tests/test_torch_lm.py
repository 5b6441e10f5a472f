"""The port's subject LM (`lm/model.py`, `lm/convert.py`) against the JAX
package's, on the CPU, for both architectures (GPT-NeoX and GPT-2).

The JAX params are carried across with `interop.lm_params_from_jax`, so both
sides run the same weights on the same numpy-seeded tokens. Tolerances:
  - f32 logits and every hook point (`HOOK_TEMPLATES`, the pattern and the
    embedding included), `stop_at_layer` and a `run_with_hooks` replacement:
    atol 1e-5, rtol 1e-5 (the same ops summing in another order);
  - `lm_loss`: rtol 1e-5;
  - `params_from_hf` on a tiny local HF model: equal to JAX's exactly (the
    same reshapes of the same f32 weights), logits within JAX's own HF pin,
    atol 2e-4 (HF's GPT-NeoX runs the exact GELU, both packages the tanh
    one: ROADMAP §C);
  - bf16 compute: hook points within 2e-2 of the largest magnitude (bf16
    roundings of products summed in another order);
  - shapes, registry and activation sizes: exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_coding__tpu.data import activations as jact
from sparse_coding__tpu.lm import convert as jconvert
from sparse_coding__tpu.lm import model as jm
from sparse_coding__tpu_torch.data import activations as tact
from sparse_coding__tpu_torch.interop import lm_params_from_jax
from sparse_coding__tpu_torch.lm import convert as tconvert
from sparse_coding__tpu_torch.lm import model as tm

ARCHS = ["neox", "gpt2"]
LOCS = list(jm.HOOK_TEMPLATES)


def _configs(arch, **kw):
    base = dict(arch=arch, n_layers=2, d_model=32, n_heads=4, d_mlp=64, vocab_size=128, n_ctx=32,
                tie_word_embeddings=arch == "gpt2", **kw)
    return jm.LMConfig(**base), tm.LMConfig(**base)


def _subject(arch, seed=0, **kw):
    """JAX params with non-trivial norms and biases, and the port's copy."""
    jc, tc = _configs(arch, **kw)
    jp = jm.init_params(jax.random.PRNGKey(seed), jc)
    leaves, treedef = jax.tree.flatten(jp)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x) + 0.02 * rng.standard_normal(x.shape).astype(np.float32) for x in leaves]
    jp = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in leaves])
    return jc, tc, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(vocab=128, shape=(3, 16), seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(b.detach()), np.asarray(a), atol=1e-5, rtol=1e-5, err_msg=what)


ALL_NAMES = ("hook_embed",) + tuple(jm.make_tensor_name(layer, loc) for layer in range(2) for loc in LOCS)
# one compiled JAX forward instead of an eager dispatch (and compile) per op
_jforward = jax.jit(jm.forward, static_argnames=("cfg", "cache_names", "stop_at_layer"))
_jloss = jax.jit(jm.lm_loss, static_argnames=("cfg",))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_every_hook_point_match_jax(arch):
    jc, tc, jp, tp = _subject(arch)
    toks = _tokens()
    jl, jcache = _jforward(jp, jnp.asarray(toks), jc, cache_names=ALL_NAMES)
    tl, tcache = tm.forward(tp, torch.from_numpy(toks), tc, cache_names=ALL_NAMES)
    _close(jl, tl, "logits")
    # serial GPT-2 emits hook_resid_mid; parallel NeoX does not
    assert sorted(tcache) == sorted(jcache) and len(jcache) >= len(ALL_NAMES) - 2
    for name in jcache:
        assert tuple(tcache[name].shape) == tuple(jcache[name].shape), name
        _close(jcache[name], tcache[name], name)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("stop", [1, 2])
def test_stop_at_layer_returns_the_residual_as_jax(arch, stop):
    jc, tc, jp, tp = _subject(arch)
    toks = _tokens()
    name = jm.make_tensor_name(stop - 1, "residual")
    jr, jcache = _jforward(jp, jnp.asarray(toks), jc, cache_names=(name,), stop_at_layer=stop)
    tr, tcache = tm.run_with_cache(tp, torch.from_numpy(toks), tc, [name], stop_at_layer=stop)
    _close(jr, tr, "residual")
    assert torch.equal(tr, tcache[name])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("loc", ["residual", "mlp", "attn", "pattern", "attn_q"])
def test_run_with_hooks_replacement_matches_jax(arch, loc):
    """A hook that scales its tensor by 0.5 (the pattern's rows too) moves
    the logits as in JAX, and where JAX's do not move (``attn.hook_z`` is a
    capture of z after the output projection has read it) neither do the
    port's."""
    jc, tc, jp, tp = _subject(arch)
    toks = _tokens()
    name = jm.make_tensor_name(0, loc)
    jl = jm.run_with_hooks(jp, jnp.asarray(toks), jc, {name: lambda t: t * 0.5})
    tl = tm.run_with_hooks(tp, torch.from_numpy(toks), tc, {name: lambda t: t * 0.5})
    _close(jl, tl, f"logits with {name} halved")
    moved = not np.array_equal(np.asarray(jl), np.asarray(jm.run_with_hooks(jp, jnp.asarray(toks), jc, {})))
    assert moved == (loc != "attn")
    assert moved == (not torch.equal(tl, tm.run_with_hooks(tp, torch.from_numpy(toks), tc, {})))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_jax(arch):
    jc, tc, jp, tp = _subject(arch)
    toks = _tokens(shape=(4, 16), seed=5)
    np.testing.assert_allclose(float(tm.lm_loss(tp, torch.from_numpy(toks), tc)),
                               float(_jloss(jp, jnp.asarray(toks), jc)), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_stays_near_jax_bf16(arch):
    """Params cast to bf16 on both sides: every hook point within 2e-2 of
    the JAX value's largest magnitude."""
    jc, tc, jp, tp = _subject(arch)
    toks = _tokens()
    jpb = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    tpb = tm.cast_params(tp, torch.bfloat16)
    _, jcache = _jforward(jpb, jnp.asarray(toks), jc, cache_names=ALL_NAMES)
    _, tcache = tm.forward(tpb, torch.from_numpy(toks), tc, cache_names=ALL_NAMES)
    for name in jcache:
        a = np.asarray(jcache[name].astype(jnp.float32))
        b = tcache[name].float().numpy()
        assert tcache[name].dtype == torch.bfloat16, name
        assert np.abs(a - b).max() <= 2e-2 * np.abs(a).max(), name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_jax_layout(arch):
    jc, tc = _configs(arch)
    jshapes = jax.tree.map(lambda x: tuple(x.shape), jm.init_params(jax.random.PRNGKey(0), jc))
    tp = tm.init_params(0, tc, device="cpu")
    assert tm.tree_map(lambda x: tuple(x.shape), tp) == jshapes
    again = tm.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tm.tree_leaves(tp).values(), tm.tree_leaves(again).values()))


def test_lm_params_from_jax_keeps_bf16_bits():
    jc, _ = _configs("neox")
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jm.init_params(jax.random.PRNGKey(3), jc))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for (path, a), b in zip(tm.tree_leaves(tp).items(), jax.tree.leaves(jp)):
        assert a.dtype == torch.bfloat16
        assert np.array_equal(a.view(torch.int16).numpy(), np.asarray(b).view(np.int16)), path


@pytest.mark.parametrize("name", ["pythia-70m", "EleutherAI/pythia-70m-deduped", "pythia-1.4b", "gpt2",
                                  "gpt2-xl"])
def test_config_registry_matches_jax(name):
    assert dataclasses_asdict(tm.config_for(name)) == dataclasses_asdict(jm.config_for(name))
    with pytest.raises(ValueError):
        tm.config_for("llama-7b")


def dataclasses_asdict(cfg):
    import dataclasses

    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("loc", LOCS + ["blocks.{layer}.attn.hook_k", "blocks.1.mlp.hook_pre", "hook_embed"])
def test_activation_sizes_and_names_match_jax(loc):
    """`get_activation_size` (registered locations; it raises where JAX
    raises), `make_tensor_name` and the meta-device probe of any hook point
    against `jax.eval_shape`'s."""
    for model in ("pythia-70m", "gpt2"):
        try:
            want = jm.get_activation_size(model, loc, seq_len=256)
        except ValueError:
            with pytest.raises(ValueError):
                tm.get_activation_size(model, loc, seq_len=256)
        else:
            assert tm.get_activation_size(model, loc, seq_len=256) == want
    assert tm.make_tensor_name(1, loc) == jm.make_tensor_name(1, loc)
    for arch in ARCHS:
        jc, tc = _configs(arch)
        name = jm.make_tensor_name(1, loc)
        if arch == "neox" and name.endswith("hook_resid_mid"):
            continue  # parallel residual: no resid_mid point
        assert tact._probe_activation_size(tc, name, 2, 16) == jact._probe_activation_size(jc, name, 2, 16)


def test_dense_only_attention_is_ported():
    """Every attention is ported (dense, the blockwise recurrence,
    `tests/test_torch_blockwise.py`, and the sequence-parallel ones,
    `tests/test_torch_seqpar.py`): any ``attn_impl`` is called in the
    forward; the four sequence-parallel functions exist, and ring / Ulysses
    need a mesh."""
    import importlib

    tra = importlib.import_module("sparse_coding__tpu_torch.lm.ring_attention")
    _, tc, _, tp = _subject("neox")
    calls = []
    tm.forward(tp, torch.from_numpy(_tokens()), tc, attn_impl=lambda q, k, v: calls.append(q.shape) or q)
    assert len(calls) == tc.n_layers
    for fn in (tra.ring_attention, tra.ulysses_attention, tra.make_sequence_parallel_fn,
               tra.sequence_parallel_forward):
        assert callable(fn)
    for fn in (tra.ring_attention, tra.ulysses_attention):
        with pytest.raises(ValueError, match="mesh="):
            fn("data")


# -- HF conversion ---------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_hf():
    from transformers import GPT2Config, GPT2LMHeadModel, GPTNeoXConfig, GPTNeoXForCausalLM

    torch.manual_seed(0)
    neox = GPTNeoXForCausalLM(GPTNeoXConfig(
        vocab_size=128, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, rotary_pct=0.25, use_parallel_residual=True, tie_word_embeddings=False,
    )).eval()
    gpt2 = GPT2LMHeadModel(GPT2Config(vocab_size=128, n_embd=32, n_layer=2, n_head=4, n_positions=64)).eval()
    return {"neox": neox, "gpt2": gpt2}


HF_TOKENS = np.array([[1, 5, 9, 2, 77, 33, 4, 8], [3, 3, 17, 90, 6, 2, 1, 0]], dtype=np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_hf_equals_jax_and_matches_hf_logits(arch, tiny_hf):
    hf = tiny_hf[arch]
    tc = tconvert.config_from_hf(hf.config)
    assert dataclasses_asdict(tc) == dataclasses_asdict(jconvert.config_from_hf(hf.config))
    tp = tconvert.params_from_hf(hf, device="cpu")
    jp = jconvert.params_from_hf(hf)
    want = tm.tree_leaves(lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    got = tm.tree_leaves(tp)
    assert sorted(got) == sorted(want)
    for path, a in got.items():
        assert a.dtype == want[path].dtype and torch.equal(a, want[path]), path
    with torch.no_grad():
        hf_logits = hf(torch.from_numpy(HF_TOKENS).long()).logits.numpy()
    tl, _ = tm.forward(tp, torch.from_numpy(HF_TOKENS), tc)
    np.testing.assert_allclose(tl.numpy(), hf_logits, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_load_model_from_a_saved_checkpoint_folder(arch, tiny_hf, tmp_path):
    hf = tiny_hf[arch]
    hf.save_pretrained(tmp_path / arch)
    cfg, params = tconvert.load_model(str(tmp_path / arch), device="cpu")
    assert cfg.arch == arch
    with torch.no_grad():
        hf_logits = hf(torch.from_numpy(HF_TOKENS).long()).logits.numpy()
    tl, _ = tm.forward(params, torch.from_numpy(HF_TOKENS), cfg)
    np.testing.assert_allclose(tl.numpy(), hf_logits, atol=2e-4)
    assert tconvert._canonical_hf_name("pythia-70m") == jconvert._canonical_hf_name("pythia-70m")
