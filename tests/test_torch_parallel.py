"""The port's mesh, spec rules, DP loss and pod helpers, in one process.

Held against the JAX package's `parallel.mesh` (its 8 virtual CPU devices)
and `models.sae.FunctionalTiedSAEDP` on the same numpy inputs:
  - `make_mesh`'s shape and refusal, `default_mesh_shape` on JAX's cases;
  - `infer_state_specs` equal to JAX's `PartitionSpec`s leaf for leaf on a
    tied, a FISTA and a LISTA state (rank 4: replicated past the model axis);
  - `bind_mesh`'s selection, and the DP loss' gradients against JAX's
    `_tied_pair_dp` and against the plain loss (JAX's measure: the largest
    difference within 1e-5 of the largest gradient, in f32);
  - in a world of one (a gloo group on a `FileStore` under ``tmp_path``,
    destroyed at teardown): the pod exchanges are no-ops, and the degenerate
    mesh gives the unsharded run's bits on every route;
  - the per-process file naming, the heartbeat's gauges and the desync
    anomaly with a faked exchange (JAX `tests/test_multihost_telemetry.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_parity import to_np
from sparse_coding__tpu_torch import FunctionalTiedSAE, build_ensemble
from sparse_coding__tpu_torch.models.sae import FunctionalTiedSAEDP
from sparse_coding__tpu_torch.parallel import mesh as pmesh
from sparse_coding__tpu_torch.telemetry import RunTelemetry, read_events
from sparse_coding__tpu_torch.telemetry import multihost as mh
from sparse_coding__tpu_torch.train import preemption

D, N = 32, 64


def fake_mesh(model, data, dict_):
    """A mesh's layout without a world (the spec rules read only sizes)."""
    shape = {pmesh.MODEL_AXIS: model, pmesh.DATA_AXIS: data, pmesh.DICT_AXIS: dict_}
    return pmesh.Mesh(shape=shape, coords={a: 0 for a in pmesh.AXES}, ranks={a: [0] for a in pmesh.AXES},
                      groups={a: None for a in pmesh.AXES}, backend="none", rank=0, world_size=model * data * dict_)


@pytest.fixture
def world_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_shape_and_refusal(world_of_one):
    mesh = pmesh.make_mesh(1, 1, 1)
    assert mesh.shape == {"model": 1, "data": 1, "dict": 1}
    assert mesh.backend == "gloo" and mesh.world_size == 1 and mesh.groups == {a: None for a in pmesh.AXES}
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        pmesh.make_mesh(2, 2, 2)


@pytest.mark.parametrize("n,m,want_dict", [(8, 4, False), (8, 4, True), (8, 3, False), (6, 4, True), (4, 1, True),
                                            (1, 4, False), (16, 32, False)])
def test_default_mesh_shape_matches_jax(n, m, want_dict):
    from sparse_coding__tpu.parallel import default_mesh_shape as jax_default

    assert pmesh.default_mesh_shape(n, n_models=m, want_dict=want_dict) == jax_default(n, n_models=m,
                                                                                     want_dict=want_dict)
    assert pmesh.default_mesh_shape(8, n_models=4) == (4, 2, 1)
    assert pmesh.default_mesh_shape(8, n_models=4, want_dict=True) == (4, 1, 2)
    assert pmesh.default_mesh_shape(8, n_models=3) == (1, 8, 1)


def _jax_and_port_states(kind, n_models):
    from sparse_coding__tpu import build_ensemble as jax_build
    from sparse_coding__tpu import models as jm
    from sparse_coding__tpu_torch import models as tm

    hp = [{"l1_alpha": 1e-3}] * n_models
    if kind == "lista":
        kw = dict(d_activation=D, n_features=N, n_hidden_layers=3)
        jsig, tsig = jm.FunctionalLISTADenoisingSAE, tm.FunctionalLISTADenoisingSAE
    else:
        kw = dict(activation_size=D, n_dict_components=N)
        jsig, tsig = (jm.FunctionalFista, tm.FunctionalFista) if kind == "fista" else \
            (jm.FunctionalTiedSAE, tm.FunctionalTiedSAE)
    jens = jax_build(jsig, jax.random.PRNGKey(0), hp, optimizer_kwargs={"learning_rate": 1e-3}, **kw)
    tens = build_ensemble(tsig, 0, hp, optimizer_kwargs={"learning_rate": 1e-3}, device="cpu", **kw)
    return jens.state, tens.state


@pytest.mark.parametrize("kind", ["tied", "fista", "lista"])
@pytest.mark.parametrize("shape,shard_dict", [((2, 2, 2), True), ((2, 2, 2), False), ((1, 2, 4), True),
                                              ((4, 1, 2), True)])
def test_infer_state_specs_match_jax(devices, kind, shape, shard_dict):
    from sparse_coding__tpu.parallel import infer_state_specs as jax_specs
    from sparse_coding__tpu.parallel import make_mesh as jax_mesh
    from sparse_coding__tpu_torch.utils.tree import tree_paths

    n_models = 4
    jstate, tstate = _jax_and_port_states(kind, n_models)
    js = jax_specs(jstate, n_models, jax_mesh(*shape, devices=devices), shard_dict)
    ts = pmesh.infer_state_specs(tstate, n_models, fake_mesh(*shape), shard_dict)
    as_tuple = lambda s: tuple(s)  # noqa: E731  (a PartitionSpec is a tuple of axis names)
    jleaf = lambda tree: [as_tuple(s) for s in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(  # noqa: E731
        x, jax.sharding.PartitionSpec))]
    tleaf = lambda tree: [tuple(s) for _, s in tree_paths(tree)]  # noqa: E731
    assert tleaf(ts.params) == jleaf(js.params)
    assert tleaf(ts.buffers) == jleaf(js.buffers)
    jadam = js.opt_state[0]
    assert tleaf(ts.opt_state.mu) == jleaf(jadam.mu) and tleaf(ts.opt_state.nu) == jleaf(jadam.nu)
    assert tleaf(ts.opt_state.count) == jleaf(jadam.count)
    assert ts.step == () == as_tuple(js.step)
    if kind == "lista":  # rank 4: replicated past the model axis
        assert ts.params["encoder_layers"]["W"] == ("model", None, None, None)
    assert isinstance(ts.params["encoder" if kind != "lista" else "decoder"], pmesh.PartitionSpec)


def test_infer_state_specs_refuses_an_indivisible_model_axis():
    _, tstate = _jax_and_port_states("tied", 3)
    with pytest.raises(ValueError, match="divisible by the mesh model axis"):
        pmesh.infer_state_specs(tstate, 3, fake_mesh(2, 1, 1))


def test_bind_mesh_selects_the_dp_loss_only_for_data_axes():
    assert FunctionalTiedSAE.bind_mesh(fake_mesh(8, 1, 1)) is FunctionalTiedSAE
    assert FunctionalTiedSAE.bind_mesh(fake_mesh(1, 8, 1)) is FunctionalTiedSAEDP
    assert FunctionalTiedSAE.bind_mesh(fake_mesh(2, 2, 2)) is FunctionalTiedSAEDP
    assert FunctionalTiedSAEDP.bind_mesh(fake_mesh(1, 8, 1)) is FunctionalTiedSAEDP


@pytest.mark.parametrize("centered", [False, True])
def test_dp_loss_grads_match_jax_and_the_plain_loss(centered):
    from sparse_coding__tpu.models.sae import FunctionalTiedSAE as JaxTied
    from sparse_coding__tpu.models.sae import FunctionalTiedSAEDP as JaxDP
    from sparse_coding__tpu_torch.utils import precision as tpx

    rng = np.random.default_rng(0)
    M, B = 3, 64
    enc = (rng.standard_normal((M, N, D)) * 0.2).astype(np.float32)
    bias = (rng.standard_normal((M, N)) * 0.01).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    trans = rng.standard_normal((M, D)).astype(np.float32) if centered else None
    l1 = np.array([1e-3, 3e-3, 1e-2], np.float32)
    decay = np.full((M,), 1e-4, np.float32)

    def jbuf(i):
        return {"center_rot": None, "center_scale": None, "l1_alpha": l1[i], "bias_decay": decay[i],
                "center_trans": None if trans is None else trans[i]}

    def jgrads(sig, i):
        p = {"encoder": jnp.asarray(enc[i]), "encoder_bias": jnp.asarray(bias[i])}
        g, (ld, _) = jax.grad(lambda p: sig.loss(p, jbuf(i), jnp.asarray(x))[0], has_aux=False)(p), \
            sig.loss(p, jbuf(i), jnp.asarray(x))[1]
        return g, ld

    tb = {"center_rot": None, "center_scale": None, "l1_alpha": torch.from_numpy(l1),
          "bias_decay": torch.from_numpy(decay), "center_trans": None if trans is None else torch.from_numpy(trans)}

    def tgrads(sig, dtype=None):
        p = {"encoder": torch.from_numpy(enc).requires_grad_(True),
             "encoder_bias": torch.from_numpy(bias).requires_grad_(True)}
        with tpx.compute(dtype):
            total, (ld, aux) = sig.loss(p, tb, torch.from_numpy(x))
        g = torch.autograd.grad(total.sum(), [p["encoder"], p["encoder_bias"]])
        return {"encoder": g[0], "encoder_bias": g[1]}, ld

    def max_rel(a, b):  # JAX's test's measure: the largest difference over the largest magnitude
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)

    g_dp, l_dp = tgrads(FunctionalTiedSAEDP)
    g_plain, l_plain = tgrads(FunctionalTiedSAE)
    for k in g_dp:
        assert max_rel(to_np(g_dp[k]), to_np(g_plain[k])) < 1e-5, k
    for k in l_dp:
        np.testing.assert_array_equal(to_np(l_dp[k]), to_np(l_plain[k]))  # one forward, bit for bit
    for i in range(M):
        jg, jl = jgrads(JaxDP, i)
        jg_plain, _ = jgrads(JaxTied, i)
        for k in jg:
            assert max_rel(to_np(g_dp[k][i]), jg[k]) < 1e-5, k
            assert max_rel(jg[k], jg_plain[k]) < 1e-5, k
        np.testing.assert_allclose(to_np(l_dp["loss"][i]), float(jl["loss"]), rtol=1e-5)
    # under the bf16 policy, within the JAX test's 3e-2 of the plain loss' gradient
    g_b, _ = tgrads(FunctionalTiedSAEDP, torch.bfloat16)
    g_bp, _ = tgrads(FunctionalTiedSAE, torch.bfloat16)
    for k in g_b:
        rel = float((g_b[k] - g_bp[k]).abs().max() / g_bp[k].abs().max())
        assert rel < 3e-2, (k, rel)


def test_pod_exchanges_are_no_ops_in_a_world_of_one(world_of_one, tmp_path):
    assert mh.process_info() == (0, 1)
    assert mh.estimate_clock_offset() is None and mh.clock_state() is None
    assert mh.check_desync(config={"a": 1}) is None
    assert mh._kv_allgather("t", "x") is None
    with RunTelemetry(out_dir=str(tmp_path / "run")) as tel:
        assert mh.heartbeat(tel, step=1, window_seconds=1.0) is None
        assert preemption.pod_agree_preempt(tel) is False
    events = read_events(tmp_path / "run" / "events.jsonl")
    assert all(e["event"] != "heartbeat" and "process_index" not in e for e in events)


def test_initialize_distributed_keeps_torchs_group_timeout(tmp_path, monkeypatch):
    """The group's collectives and its store keep torch's own timeout: the
    short telemetry flag must not bound a wait for rank 0's dataset build,
    exports or checkpoint commit."""
    import datetime

    from sparse_coding__tpu_torch.parallel.distributed import choose_backend, initialize_distributed

    monkeypatch.setenv("SC_MH_TIMEOUT_MS", "1000")
    assert choose_backend(2, "cpu") == "gloo"
    assert initialize_distributed(f"file://{tmp_path / 'store'}", 1, 0, device="cpu")
    try:
        assert dist.get_backend() == "gloo"
        assert mh._store().timeout >= datetime.timedelta(minutes=10)
    finally:
        dist.destroy_process_group()


def test_pod_agree_preempt_is_the_local_flag_in_a_world_of_one(world_of_one, monkeypatch):
    monkeypatch.setattr(preemption, "preemption_requested", lambda: True)
    assert preemption.pod_agree_preempt() is True
    monkeypatch.setattr(preemption, "preemption_requested", lambda: False)
    assert preemption.pod_agree_preempt() is False


def test_pod_agree_preempt_any_flagged_rank_preempts_all(monkeypatch, tmp_path):
    monkeypatch.setattr(mh, "process_info", lambda: (0, 2))
    monkeypatch.setattr(preemption, "preemption_requested", lambda: False)
    monkeypatch.setattr(mh, "_kv_allgather", lambda tag, payload: [payload, "1"])
    with RunTelemetry(out_dir=str(tmp_path)) as tel:
        assert preemption.pod_agree_preempt(tel) is True
    assert [e["flagged"] for e in read_events(tel.path) if e["event"] == "preempt_peer"] == [[1]]
    # a failed exchange falls back to the local flag
    monkeypatch.setattr(mh, "_kv_allgather", lambda tag, payload: None)
    assert preemption.pod_agree_preempt() is False


def test_per_process_file_naming_matches_jax(monkeypatch, tmp_path):
    from sparse_coding__tpu.telemetry.multihost import per_process_file_name as jax_name
    from sparse_coding__tpu_torch.utils.logging import MetricLogger

    for base, i, n in (("events.jsonl", 1, 2), ("events.jsonl", 0, 1), ("noext", 3, 4), ("a.b.jsonl", 0, 8)):
        assert mh.per_process_file_name(base, i, n) == jax_name(base, i, n)
    monkeypatch.setattr(mh, "process_info", lambda: (1, 2))
    with RunTelemetry(out_dir=str(tmp_path), run_name="pod") as tel:
        tel.run_start()
        tel.anomaly("nonfinite", step=3, models=[0])
    assert tel.path.name == "events.p1.jsonl"
    events = read_events(tmp_path / "events.p1.jsonl")
    assert events and all(e["process_index"] == 1 for e in events)
    assert events[0]["fingerprint"]["process_index"] == 1 and events[0]["fingerprint"]["process_count"] == 2
    MetricLogger(out_dir=str(tmp_path), run_name="pod").close()
    assert (tmp_path / "pod_p1_metrics.jsonl").exists()


def test_heartbeat_gauges_resync_and_desync_with_a_faked_exchange(monkeypatch, tmp_path):
    from sparse_coding__tpu_torch.telemetry.anomaly import AnomalyAbort

    monkeypatch.setattr(mh, "process_info", lambda: (0, 2))
    monkeypatch.setenv(mh.CLOCK_RESYNC_EVERY_ENV, "2")
    resyncs = []
    monkeypatch.setattr(mh, "estimate_clock_offset", lambda: resyncs.append(1))
    monkeypatch.setattr(mh, "_kv_allgather", lambda tag, payload: [payload, "2.0"])
    with RunTelemetry(out_dir=str(tmp_path)) as tel:
        tel.counter_inc("train.steps", 128)
        rec = mh.heartbeat(tel, step=128, window_seconds=0.5)
        mh.heartbeat(tel, step=129, window_seconds=0.5)
        assert rec["window_seconds_by_process"] == [0.5, 2.0] and rec["skew_seconds"] == pytest.approx(1.5)
        snap = tel.snapshot()
        assert snap["gauges"]["skew.flush.spread_seconds"] == pytest.approx(1.5)
        assert snap["counters"]["heartbeats"] == 2 and len(resyncs) == 1
        monkeypatch.setattr(mh, "_kv_allgather", lambda tag, payload: [payload, payload])
        assert mh.check_desync(tel, config={"a": 1}) == []
        monkeypatch.setattr(mh, "_kv_allgather", lambda tag, payload: [payload, "0" * 16])
        with pytest.warns(RuntimeWarning, match="desync"):
            assert mh.check_desync(tel, config={"a": 1}) == [1]
        with pytest.warns(RuntimeWarning), pytest.raises(AnomalyAbort):
            mh.check_desync(tel, config={"a": 1}, action="abort")
    desync = [e for e in read_events(tel.path) if e.get("kind") == "desync"]
    assert len(desync) == 2 and desync[0]["processes"] == [1]


@pytest.mark.parametrize("route", ["f32", "bf16", "bf16_masked"])
def test_the_degenerate_mesh_gives_the_unsharded_bits(world_of_one, route):
    """(1,1,1) in a world of one: no collective, the same route, the same
    bits (step_batch and step_scan), and `state_dict` the whole state."""
    kw = dict(optimizer_kwargs={"learning_rate": 1e-3}, activation_size=128, n_dict_components=256, device="cpu")
    if route != "f32":
        kw["compute_dtype"] = "bfloat16"

    def build():
        ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": a} for a in (1e-3, 3e-3)], **kw)
        if route == "bf16_masked":
            ens.set_update_mask([1.0, 0.0])
        return ens

    ref, sh = build(), build().shard(pmesh.make_mesh())
    assert sh.fused_adam == ref.fused_adam and sh._route(64, route == "bf16_masked", False) == \
        ref._route(64, route == "bf16_masked", False)
    g = torch.Generator().manual_seed(3)
    xs = torch.randn(3, 64, 128, generator=g)
    for x in xs[:2]:
        assert torch.equal(ref.step_batch(x)[0]["loss"], sh.step_batch(x)[0]["loss"])
    assert torch.equal(ref.step_scan(xs[2:])["loss"], sh.step_scan(xs[2:])["loss"])
    for k, v in ref.state_dict()["state"].params.items():
        assert torch.equal(sh.state_dict()["state"].params[k], v), k
