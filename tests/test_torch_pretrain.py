"""The port's subject-LM pretraining (`lm/pretrain.py`, AdamW and the warm-up
+ cosine schedule in `utils/optim.py`) and its trigram corpus
(`data/synthetic_text.py`) against the JAX package's, on the CPU.

Tolerances:
  - `TrigramLanguage`: the tables and samples bit for bit (a numpy copy);
  - the schedule: `optax.warmup_cosine_decay_schedule` at every step within
    peak·2⁻²³ (torch's and XLA's f32 cosines round a few arguments one ulp
    apart, and ½(1 + cos) keeps that absolute error); the warm-up steps
    bit for bit;
  - AdamW against `optax.adamw` at a constant rate: bit for bit (the same
    f32 expressions), 3 steps;
  - 5 f32 `pretrain_lm` steps against JAX's on the same params and batches:
    losses rtol 1e-5, params atol 1e-6 (gradients summed in another order;
    the schedule's ulp), except the key biases (``b_qkv[1]``): their
    gradient is zero but for rounding (a key bias shifts a whole row of
    scores, which the softmax cancels), and Adam scales that noise up to
    the learning rate, so they are held within the summed rates;
  - bf16 compute: 5 steps' losses within 1e-2 of JAX's (bf16 roundings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparse_coding__tpu.data.synthetic_text import TrigramLanguage as JaxLanguage
from sparse_coding__tpu.lm import model as jm
from sparse_coding__tpu.lm.pretrain import pretrain_lm as jax_pretrain_lm
from sparse_coding__tpu_torch.data.synthetic_text import TrigramLanguage
from sparse_coding__tpu_torch.interop import lm_params_from_jax
from sparse_coding__tpu_torch.lm import model as tm
from sparse_coding__tpu_torch.lm.pretrain import pretrain_lm
from sparse_coding__tpu_torch.utils import optim

KW = dict(arch="neox", n_layers=2, d_model=32, n_heads=4, d_mlp=64, vocab_size=64, n_ctx=32, rotary_pct=0.25)


@pytest.fixture(autouse=True)
def one_thread():
    """Small eager steps by the hundred: one intra-op thread keeps them fast
    when the suite runs in parallel workers (many threads each thrash)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lang():
    return TrigramLanguage(vocab_size=64, n_ctx_slots=256, k_succ=4, seed=0)


@pytest.mark.parametrize("kw", [dict(vocab_size=64, n_ctx_slots=256, k_succ=4, seed=0),
                                dict(vocab_size=50304, seed=7)])
def test_trigram_language_is_the_jax_packages_bit_for_bit(kw):
    ours, ref = TrigramLanguage(**kw), JaxLanguage(**kw)
    assert np.array_equal(ours.succ, ref.succ) and np.array_equal(ours.succ_cum, ref.succ_cum)
    a, b = ours.sample(64, 32, seed=11), ref.sample(64, 32, seed=11)
    assert a.dtype == np.int32 and np.array_equal(a, b)
    assert ours.per_token_entropy_bound == ref.per_token_entropy_bound


@pytest.mark.parametrize("warmup,n", [(100, 300), (30, 300), (1, 5), (0, 5), (10, 100)])
def test_warmup_cosine_schedule_is_optaxs(warmup, n):
    """Read at every count 0..n+20 (the count before each update: 0 first,
    so the first update has lr 0)."""
    counts = np.arange(n + 20, dtype=np.int32)
    want = np.asarray(optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, n)(jnp.asarray(counts)))
    got = optim.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, n)(torch.from_numpy(counts))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-4 * 2.0 ** -23)
    assert np.array_equal(got.numpy()[:warmup + 1], want[:warmup + 1])
    with pytest.raises(ValueError, match="positive decay_steps"):
        optim.cosine_decay_schedule(1.0, 0)


def test_adamw_is_optax_adamw_bit_for_bit():
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in (("a", (5, 7)), ("b", (3,)))}
    tx = optax.adamw(3e-3, weight_decay=0.01)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    ours = optim.adamw(3e-3, weight_decay=0.01)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = ours.init(tp)
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        u, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = ours.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        tp = optim.apply_updates(tp, tu)
        for k in params:
            assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), k
    assert int(ts.count) == 3


def _subject(lang, rows=256, seed=0):
    jc, tc = jm.LMConfig(**KW), tm.LMConfig(**KW)
    jp = jm.init_params(jax.random.PRNGKey(seed), jc)
    return jc, tc, jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"), lang.sample(rows, 16, seed=3)


def test_five_f32_steps_match_jax(lang):
    jc, tc, jp, tp, toks = _subject(lang)
    kw = dict(n_steps=5, batch_size=8, learning_rate=3e-3, scan_steps=2, compute_dtype=None, warmup=2, seed=4)
    jp2, jstats = jax_pretrain_lm(jp, jc, toks, **kw)
    tp2, tstats = pretrain_lm(tp, tc, toks, device="cpu", **kw)
    for k in ("loss_first", "loss_last"):
        np.testing.assert_allclose(tstats[k], jstats[k], rtol=1e-5, err_msg=k)
    want = tm.tree_leaves(lm_params_from_jax(jax.tree.map(np.asarray, jp2), device="cpu"))
    got = tm.tree_leaves(tp2)
    assert sorted(got) == sorted(want)
    lr_sum = float(sum(optim.warmup_cosine_decay_schedule(0.0, 3e-3, 2, 5)(torch.arange(5))))
    for path, a in got.items():
        assert a.dtype == torch.float32
        a, b = a.numpy().copy(), want[path].numpy().copy()
        if path.endswith("attn.b_qkv"):
            np.testing.assert_allclose(a[1], b[1], atol=lr_sum, rtol=0, err_msg=path)
            a[1], b[1] = 0, 0
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=path)
    moved = max(float((a - tp_a).abs().max()) for a, tp_a in zip(got.values(), tm.tree_leaves(tp).values()))
    assert moved > 1e-4  # the steps did train


def test_bf16_compute_steps_stay_near_jax(lang):
    """The loss on a bf16 cast of the f32 master params, as JAX computes it;
    the params stay f32."""
    jc, tc, jp, tp, toks = _subject(lang)
    kw = dict(n_steps=5, batch_size=8, learning_rate=3e-3, scan_steps=5, warmup=2, seed=4)
    _, jstats = jax_pretrain_lm(jp, jc, toks, compute_dtype=jnp.bfloat16, **kw)
    tp2, tstats = pretrain_lm(tp, tc, toks, compute_dtype="bfloat16", device="cpu", **kw)
    for k in ("loss_first", "loss_last"):
        assert abs(tstats[k] - jstats[k]) < 1e-2, (k, tstats[k], jstats[k])
    assert all(a.dtype == torch.float32 for a in tm.tree_leaves(tp2).values())


def test_pretrain_learns_the_language(lang):
    """The JAX suite's own check at its size: from ~log(64) = 4.16 the loss
    falls by more than a nat in 120 steps, and the trained params still run
    the capture forward."""
    tc = tm.LMConfig(**KW)
    params = tm.init_params(0, tc, device="cpu")
    tokens = lang.sample(n_rows=2048, seq_len=32, seed=3)
    params, stats = pretrain_lm(params, tc, tokens, n_steps=120, batch_size=64, learning_rate=3e-3,
                                compute_dtype=None, seed=0, device="cpu")
    assert stats["loss_first"] > 3.5
    assert stats["loss_last"] < stats["loss_first"] - 1.0, stats
    _, cache = tm.run_with_cache(params, torch.from_numpy(tokens[:4]), tc, ["blocks.1.hook_resid_post"],
                                 stop_at_layer=2)
    assert torch.isfinite(cache["blocks.1.hook_resid_post"]).all()
