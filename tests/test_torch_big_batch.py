"""The port's big-batch trainer (`train/big_batch.py`) and
`data.chunks.load_store_dataset` against the JAX package's, on the CPU, at
the JAX tests' shape (D 24, N 48, B 256, 30 steps) on numpy-seeded data.

Tolerances:
  - one `make_big_batch_step` from the same f32 state and batch (JAX's
    state at steps 0, 1 and 2, carried across): params rtol 1e-6, with an
    atol of 1e-5 x lr for the bias (a few Adam steps from zero, where a
    gradient that cancels moves the update by its f32 rounding), the losses rtol 1e-6, the step exactly, ``c_totals`` within one
    count (a code at the relu's edge may flip between two orders of f32
    sums), the moments within 1e-5 of their largest element (a gradient
    element that cancels keeps only the f32 sums' rounding, which differs
    in another order); the step's optimizer on the same
    gradients: optax's moments and params bit for bit;
  - `resurrect_dead_features`: the dead set, ``n_dead`` and the zeroed
    moment rows exactly, the rewritten rows rtol 1e-6 (the norms' sums);
  - `WorstExamples`: exactly (a numpy copy);
  - 30 steps of `train_big_batch` with JAX's init and index chain fed in:
    the resurrection log exactly, params within 30 x lr absolute (Adam
    moves an element by at most ~lr a step, so f32 noise stays inside it;
    the typical element agrees to 1e-5);
  - the bf16 arm: its MSE within half the f32 arm's
    (`tests/test_train_drivers.py:123-140`'s bound);
  - a resumed run: the uninterrupted run's bits.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparse_coding__tpu.data import RandomDatasetGenerator
from sparse_coding__tpu.data import chunks as jchunks
from sparse_coding__tpu.models import FunctionalTiedSAE as JaxTied
from sparse_coding__tpu.train import big_batch as jbb
from sparse_coding__tpu_torch.data import integrity
from sparse_coding__tpu_torch.data.chunks import load_store_dataset, save_chunk
from sparse_coding__tpu_torch.interop import big_batch_state_from_jax_numpy
from sparse_coding__tpu_torch.models import FunctionalTiedSAE
from sparse_coding__tpu_torch.telemetry.events import RunTelemetry, read_events
from sparse_coding__tpu_torch.train import big_batch as tbb
from sparse_coding__tpu_torch.train import preemption
from sparse_coding__tpu_torch.utils import faults
from sparse_coding__tpu_torch.utils import optim

D, N, B = 24, 48, 256
HP = dict(activation_size=D, n_dict_components=N, l1_alpha=3e-3)


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    for k in ("SC_FAULT", "SC_RESUME", "SC_CHUNK_LOSS_BUDGET", "SC_CHUNK_VERIFY"):
        monkeypatch.delenv(k, raising=False)
    faults.reset()
    preemption.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    faults.reset()
    preemption.reset()


@pytest.fixture(scope="module")
def data():
    gen = RandomDatasetGenerator(activation_dim=D, n_ground_truth_components=N, batch_size=512,
                                 feature_num_nonzero=5, feature_prob_decay=0.995, correlated=False,
                                 key=jax.random.PRNGKey(0))
    return np.asarray(jnp.concatenate([next(gen) for _ in range(4)]))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_state(params, buffers, tx, poison=False):
    opt = tx.init(params)
    if poison:
        opt = jax.tree.map(lambda l: l + 1.0 if hasattr(l, "shape") else l, opt)
    return jbb.BigBatchState(params=params, buffers=buffers, opt_state=opt, c_totals=jnp.zeros((N,)),
                             step=jnp.zeros((), jnp.int32))


def _carry(js) -> tbb.BigBatchState:
    """The JAX state as the port's (`interop.big_batch_state_from_jax_numpy`)."""
    adam_state = js.opt_state[0]
    return big_batch_state_from_jax_numpy(
        _np(js.params), _np(js.buffers), {"count": np.asarray(adam_state.count), "mu": _np(adam_state.mu),
                                          "nu": _np(adam_state.nu)},
        np.asarray(js.c_totals), np.asarray(js.step), device="cpu")


def _assert_close_state(ts, js, rtol, atol, moments_rtol=1e-5):
    for k, v in js.params.items():
        np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(v), rtol=rtol, atol=atol, err_msg=k)
    for which in ("mu", "nu"):
        for k, v in getattr(js.opt_state[0], which).items():
            want = np.asarray(v)
            np.testing.assert_allclose(getattr(ts.opt_state, which)[k].numpy(), want, rtol=0,
                                       atol=moments_rtol * np.abs(want).max(), err_msg=f"{which} {k}")
    assert int(ts.opt_state.count) == int(js.opt_state[0].count) and int(ts.step) == int(js.step)


@pytest.mark.parametrize("warmup", [0, 5])
def test_one_step_matches_jax(data, warmup):
    params, buffers = JaxTied.init(jax.random.PRNGKey(3), **HP)
    tx = optax.adam(1e-3)
    js = _jax_state(params, buffers, tx)
    jstep = jbb.make_big_batch_step(JaxTied, tx, l1_warmup_steps=warmup)
    tstep = tbb.make_big_batch_step(FunctionalTiedSAE, optim.adam(1e-3), l1_warmup_steps=warmup)
    for i in range(3):  # one step from JAX's state at steps 0, 1, 2 (the ramp's first values)
        ts = _carry(js)
        assert ts.opt_state.count.shape == () and ts.step.dtype == torch.int32 and int(ts.step) == i
        batch = data[i * B:(i + 1) * B]
        js, jl, jc = jstep(js, jnp.asarray(batch))
        ts2, tl, tc = tstep(ts, torch.from_numpy(batch.copy()))
        assert ts2 is ts  # written in place
        for k in jl:
            np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-6, err_msg=k)
        # a code at the relu's edge may flip between the packages: one count at most
        assert np.abs(ts.c_totals.numpy() - np.asarray(js.c_totals)).max() <= 1
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
        _assert_close_state(ts, js, rtol=1e-6, atol=1e-5 * 1e-3)
    # the ramp never reaches the stored buffer
    assert float(ts.buffers["l1_alpha"]) == float(js.buffers["l1_alpha"]) == np.float32(3e-3)


def test_the_steps_optimizer_is_optax_adam_bit_for_bit():
    """The step's Adam (the port's, on member-of-one views of the unstacked
    state) on JAX's gradients: optax's moments and params to the bit."""
    rng = np.random.default_rng(0)
    params = {"encoder": rng.standard_normal((N, D)).astype(np.float32),
              "encoder_bias": rng.standard_normal(N).astype(np.float32)}
    tx, ttx = optax.adam(1e-3), optim.adam(1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tst = tbb.init_opt_state(ttx, tp)
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * 1e-3 for k, v in params.items()}
        u, jst = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, u)
        tu, tst = ttx.update(tbb._stack1({k: torch.from_numpy(v) for k, v in g.items()}), tbb._stack1(tst))
        tp = tbb._unstack1(optim.apply_updates(tbb._stack1(tp), tu))
        tst = tbb._unstack1(tst)
        for k in params:
            assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), k
            assert np.array_equal(tst.mu[k].numpy(), np.asarray(jst[0].mu[k])), k
            assert np.array_equal(tst.nu[k].numpy(), np.asarray(jst[0].nu[k])), k
    assert tst.count.shape == () and int(tst.count) == 3


@pytest.mark.parametrize("ratio,threshold", [(0.2, 0), (1.5, 0), (0.2, 2)])
def test_resurrect_dead_features_matches_jax(ratio, threshold):
    key = jax.random.PRNGKey(2)
    params = {"encoder": jax.random.normal(key, (8, 4)), "encoder_bias": jnp.ones((8,))}
    tx = optax.adam(1e-3)
    js = _jax_state(params, {"l1_alpha": jnp.asarray(1e-3, jnp.float32)}, tx, poison=True)
    js = dataclasses.replace(js, c_totals=jnp.asarray([0, 5, 0, 3, 1, 0, 2, 4], jnp.float32))
    ts = _carry(js)
    enc_storage = ts.params["encoder"].data_ptr()
    reps = np.random.default_rng(4).standard_normal((8, 4)).astype(np.float32)
    jnew, jdead = jbb.resurrect_dead_features(js, jnp.asarray(reps), encoder_norm_ratio=ratio, threshold=threshold)
    tnew, tdead = tbb.resurrect_dead_features(ts, torch.from_numpy(reps), encoder_norm_ratio=ratio,
                                              threshold=threshold)
    assert tdead == jdead == int((np.asarray(js.c_totals) <= threshold).sum())
    assert tnew is ts and ts.params["encoder"].data_ptr() == enc_storage  # in place
    dead = np.asarray(js.c_totals) <= threshold
    np.testing.assert_allclose(ts.params["encoder"].numpy(), np.asarray(jnew.params["encoder"]), rtol=1e-6, atol=0)
    assert np.array_equal(ts.params["encoder"].numpy()[~dead], np.asarray(params["encoder"])[~dead])
    assert np.array_equal(ts.params["encoder_bias"].numpy(), np.asarray(jnew.params["encoder_bias"]))
    for which in ("mu", "nu"):
        for k, v in getattr(jnew.opt_state[0], which).items():
            got = getattr(ts.opt_state, which)[k].numpy()
            assert np.array_equal(got, np.asarray(v)), (which, k)
            assert (got[dead] == 0).all() and (got[~dead] != 0).all()
    assert int(ts.opt_state.count) == int(jnew.opt_state[0].count) == 1  # the count is no feature row
    assert not ts.c_totals.any() and int(ts.step) == 0


def test_worst_examples_is_the_jax_ring():
    rng = np.random.default_rng(5)
    ours, ref = tbb.WorstExamples(16), jbb.WorstExamples(16)
    for _ in range(6):
        idx = rng.integers(0, 1000, 10)
        losses = rng.random(10).astype(np.float32)
        ours.update(idx, losses)
        ref.update(idx, losses)
        assert np.array_equal(ours.indices, ref.indices) and np.array_equal(ours.losses, ref.losses)
    assert np.array_equal(ours.get_worst(5), ref.get_worst(5)) and len(ours.get_worst(99)) == 16


def _jax_chain(key, n_steps, n):
    """JAX's init key and its per-step batch indices (`train_big_batch`'s
    split chain)."""
    k_init, key = jax.random.split(key)
    idxs = []
    for _ in range(n_steps):
        key, k = jax.random.split(key)
        idxs.append(np.array(jax.random.randint(k, (B,), 0, n)))
    return k_init, idxs


def _carried_sig(jax_params, jax_buffers):
    """FunctionalTiedSAE whose init returns JAX's draw (the port's own
    generator draws other values)."""

    class Carried(FunctionalTiedSAE):
        @staticmethod
        def init(generator, device=None, **kw):
            to = lambda v: None if v is None else torch.from_numpy(np.array(v)).to(device)  # noqa: E731
            return {k: to(v) for k, v in jax_params.items()}, {k: to(v) for k, v in jax_buffers.items()}

    return Carried


@pytest.mark.parametrize("warmup", [0, 300])
def test_thirty_steps_with_jax_indices_match_jax(data, monkeypatch, warmup):
    n_steps, key = 30, jax.random.PRNGKey(1)
    k_init, idxs = _jax_chain(key, n_steps, data.shape[0])
    jlog, tlog = [], []
    kw = dict(reinit_every=10, l1_warmup_steps=warmup)
    js, _ = jbb.train_big_batch(JaxTied, HP, jnp.asarray(data), B, n_steps, key, resurrection_log=jlog, **kw)
    jp, jbuf = JaxTied.init(k_init, **HP)
    chain = iter(idxs)
    monkeypatch.setattr(tbb, "batch_indices", lambda gen, b, n: next(chain))
    ts, sig = tbb.train_big_batch(_carried_sig(_np(jp), _np(jbuf)), HP, data, B, n_steps, 0, resurrection_log=tlog,
                                  device="cpu", **kw)
    assert [s for s, _ in tlog] == [s for s, _ in jlog] == [10, 20, 30]
    assert tlog == jlog
    for k, v in js.params.items():
        diff = np.abs(ts.params[k].numpy() - np.asarray(v))
        assert diff.max() <= n_steps * 1e-3 and np.median(diff) <= 1e-5, (k, diff.max(), np.median(diff))
    ld = sig.to_learned_dict(ts.params, ts.buffers)
    assert np.isfinite(ld.predict(torch.from_numpy(data[:64])).numpy()).all()


def test_l1_warmup_ramps_and_keeps_the_stored_l1(data):
    """As JAX's test: early in a long ramp the codes are denser and the
    reconstruction better than a control under full l1 from step 0."""
    hp = dict(activation_size=D, n_dict_components=96, l1_alpha=5e-2)
    kw = dict(batch_size=B, n_steps=30, key=7, reinit_every=None, device="cpu")
    s_warm, sig = tbb.train_big_batch(FunctionalTiedSAE, hp, data, l1_warmup_steps=300, **kw)
    s_ctrl, _ = tbb.train_big_batch(FunctionalTiedSAE, hp, data, **kw)
    x = torch.from_numpy(data[:512])
    ld_w, ld_c = sig.to_learned_dict(s_warm.params, s_warm.buffers), sig.to_learned_dict(s_ctrl.params, s_ctrl.buffers)
    l0_w, l0_c = float((ld_w.encode(x) != 0).sum(-1).float().mean()), float((ld_c.encode(x) != 0).sum(-1).float().mean())
    mse_w, mse_c = float(((ld_w.predict(x) - x) ** 2).mean()), float(((ld_c.predict(x) - x) ** 2).mean())
    assert l0_w > l0_c and mse_w < mse_c, (l0_w, l0_c, mse_w, mse_c)
    assert abs(float(s_warm.buffers["l1_alpha"]) - 5e-2) < 1e-8


def test_the_bf16_arm_stays_in_the_f32_arms_basin(data):
    kw = dict(batch_size=B, n_steps=30, key=1, reinit_every=None, device="cpu")
    s32, sig = tbb.train_big_batch(FunctionalTiedSAE, HP, data, **kw)
    s16, _ = tbb.train_big_batch(FunctionalTiedSAE, HP, data, compute_dtype="bfloat16", **kw)
    assert all(v.dtype == torch.float32 for v in s16.params.values())  # f32 master weights
    x = torch.from_numpy(data[:512])
    m32 = float(((sig.to_learned_dict(s32.params, s32.buffers).predict(x) - x) ** 2).mean())
    m16 = float(((sig.to_learned_dict(s16.params, s16.buffers).predict(x) - x) ** 2).mean())
    assert np.isfinite(m16) and np.isfinite(m32) and abs(m16 - m32) < 0.5 * max(m32, 1e-6), (m32, m16)


def test_the_norm_ratio_reaches_every_resurrection(data, monkeypatch):
    seen = []
    orig = tbb.resurrect_dead_features
    monkeypatch.setattr(tbb, "resurrect_dead_features",
                        lambda state, reps, **kw: seen.append(kw.get("encoder_norm_ratio")) or orig(state, reps, **kw))
    tbb.train_big_batch(FunctionalTiedSAE, HP, data, B, 20, 5, reinit_every=10, encoder_norm_ratio=1.5, device="cpu")
    assert seen == [1.5, 1.5]


def _store(folder, data, n_chunks=4):
    rows = data.shape[0] // n_chunks
    for i in range(n_chunks):
        save_chunk(folder, i, data[i * rows:(i + 1) * rows])
    return folder


def test_store_input_skips_a_corrupt_chunk_within_the_budget(data, tmp_path, monkeypatch):
    """A store folder goes through `load_store_dataset`: a torn chunk is
    quarantined and skipped inside ``SC_CHUNK_LOSS_BUDGET`` (the counters
    JAX's load writes), its rows absent; the rest is JAX's array."""
    monkeypatch.setenv("SC_CHUNK_LOSS_BUDGET", "0.25")
    for name in ("port", "jax"):
        _store(tmp_path / name, data)
        with open(tmp_path / name / "2.npy", "ab") as f:  # a torn write: the size no longer matches
            f.write(b"\0")
    tel = RunTelemetry(out_dir=str(tmp_path / "run"))
    log = []
    try:
        state, _ = tbb.train_big_batch(FunctionalTiedSAE, HP, tmp_path / "port", B, 10, 0, reinit_every=5,
                                       resurrection_log=log, telemetry=tel, device="cpu")
    finally:
        tel.close()
    assert [s for s, _ in log] == [5, 10] and int(state.step) == 10
    assert tel.counters["data.chunks_skipped"] == 1 and tel.counters["data.rows_skipped"] == 512
    assert integrity.quarantined_indices(tmp_path / "port") == [2]
    got, budget = load_store_dataset(tmp_path / "port", device="cpu")  # the quarantined chunk: a loss again
    want, jbudget = jchunks.load_store_dataset(str(tmp_path / "jax"))
    assert np.array_equal(got.numpy(), np.asarray(want)) and got.shape == (3 * 512, D)
    assert budget.skipped_chunks == jbudget.skipped_chunks == {2} and budget.rows_skipped == jbudget.rows_skipped
    events = read_events(tmp_path / "run" / "events.jsonl")
    assert [e["chunk"] for e in events if e["event"] == "chunk_skipped"] == [2]
    assert [e["step"] for e in events if e["event"] == "resurrection"] == [5, 10]


def test_store_input_past_the_budget_exits_75(data, tmp_path, monkeypatch):
    monkeypatch.setenv("SC_CHUNK_LOSS_BUDGET", "0.25")
    store = _store(tmp_path / "store", data)
    for i in (1, 3):
        (store / f"{i}.npy").write_bytes(b"garbage")
    with pytest.raises(preemption.ResumableAbort) as exc:
        tbb.train_big_batch(FunctionalTiedSAE, HP, store, B, 5, 0, device="cpu")
    assert exc.value.code == 75


def test_sigterm_at_a_resurrection_boundary_resumes_to_the_same_bits(data, tmp_path, monkeypatch):
    """SIGTERM in step 20 (``SC_FAULT=sigterm:step=19``): the checkpoint
    lands at the step-20 resurrection boundary, the run exits 75; the
    resumed run (the generator's state from the cursor, the ring empty, as
    after a resurrection) gives the uninterrupted run's bits."""
    kw = dict(batch_size=B, key=11, reinit_every=10, device="cpu")
    full, _ = tbb.train_big_batch(FunctionalTiedSAE, HP, data, n_steps=30, **kw)
    monkeypatch.setenv("SC_FAULT", "sigterm:step=19")
    with pytest.raises(preemption.Preempted) as exc:
        tbb.train_big_batch(FunctionalTiedSAE, HP, data, n_steps=30, checkpoint_dir=str(tmp_path / "ck"), **kw)
    assert exc.value.code == 75
    assert sorted(p.name for p in (tmp_path / "ck").glob("ckpt_*")) == ["ckpt_20"]
    monkeypatch.delenv("SC_FAULT")
    faults.reset()
    preemption.reset()
    log = []
    resumed, _ = tbb.train_big_batch(FunctionalTiedSAE, HP, data, n_steps=30, checkpoint_dir=str(tmp_path / "ck"),
                                     resume=True, resurrection_log=log, **kw)
    assert [s for s, _ in log] == [30] and int(resumed.step) == 30
    for k in full.params:
        assert torch.equal(full.params[k], resumed.params[k]), k
    for which in ("mu", "nu"):
        for k in full.params:
            assert torch.equal(getattr(full.opt_state, which)[k], getattr(resumed.opt_state, which)[k])
    assert torch.equal(full.c_totals, resumed.c_totals) and int(resumed.opt_state.count) == 30


def test_a_mesh_and_a_trace_trigger_are_taken_and_a_card_is_required(data, monkeypatch):
    # a mesh is taken now: a world of one's gives the unsharded run's bits
    from sparse_coding__tpu_torch.parallel import make_mesh

    plain, _ = tbb.train_big_batch(FunctionalTiedSAE, HP, data, B, 3, 0, device="cpu")
    meshed, _ = tbb.train_big_batch(FunctionalTiedSAE, HP, data, B, 3, 0, mesh=make_mesh(), device="cpu")
    for k in plain.params:
        assert torch.equal(plain.params[k], meshed.params[k]), k
    from _torch_profiler_stub import stub_profiler
    from sparse_coding__tpu_torch.telemetry import TraceTrigger

    calls = stub_profiler(monkeypatch)
    tt = TraceTrigger(start_step=1, stop_step=2)
    tbb.train_big_batch(FunctionalTiedSAE, HP, data, B, 3, 0, trace_trigger=tt, device="cpu")
    assert calls["started"] == [str(os.path.join("trace", "trace_step1"))] and calls["stopped"] == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbb.train_big_batch(FunctionalTiedSAE, HP, data, B, 1, 0)


def test_the_train_package_exports_the_jax_names():
    from sparse_coding__tpu import train as jtrain
    from sparse_coding__tpu_torch import train as ttrain

    for name in ("BigBatchState", "WorstExamples", "make_big_batch_step", "resurrect_dead_features",
                 "train_big_batch"):
        assert hasattr(ttrain, name) and hasattr(jbb, name), name
    assert {f.name for f in dataclasses.fields(tbb.BigBatchState)} == {
        f.name for f in dataclasses.fields(jbb.BigBatchState)}
    assert all(hasattr(jtrain, n) for n in ("resurrect_dead_features", "train_big_batch"))
    assert os.path.basename(tbb.__file__) == "big_batch.py"
