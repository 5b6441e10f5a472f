"""Worlds of 2 and 4 gloo processes on the CPU: the port's sharded ensemble
step, FISTA update, pod telemetry and pod preemption, held against the JAX
package's `Ensemble.shard(make_mesh(...))` on the same init and batches.

Each world is one spawn of `tests/_torch_mp_worker.py` (a `FileStore` under
``tmp_path``, every process killed at the spawn's timeout) that runs several
scenarios in turn; the JAX references run here, on the 8 virtual CPU
devices. Pins: JAX's own (`tests/test_parallel.py`, `tests/test_multiprocess.py`:
rtol 1e-5 on the losses; the FISTA decoder rtol 1e-4, atol 1e-6); the
params after Adam steps within 1e-2 lr a step, the port-against-JAX pin of
`tests/test_torch_ensemble.py`. The model axis is also held to the
unsharded port run bit for bit: no collective runs inside its step.
"""

import jax
import numpy as np
import torch

from _torch_mp_worker import spawn
from sparse_coding__tpu_torch import Ensemble, FunctionalFista, FunctionalTiedSAE
from sparse_coding__tpu_torch.ensemble import unstack_pytree
from sparse_coding__tpu_torch.interop import state_from_jax_numpy
from sparse_coding__tpu_torch.telemetry import read_events

L1 = (1e-4, 3e-4, 1e-3, 3e-3)
D, N, B, K = 32, 128, 64, 3
LR = 1e-3


def jax_ensemble(fista=False, d=D, n=N):
    from sparse_coding__tpu import build_ensemble
    from sparse_coding__tpu.models import FunctionalFista as JaxFista
    from sparse_coding__tpu.models import FunctionalTiedSAE as JaxTied

    hp = [{"l1_alpha": 1e-3}] * 2 if fista else [{"l1_alpha": a} for a in L1]
    return build_ensemble(JaxFista if fista else JaxTied, jax.random.PRNGKey(5 if fista else 0), hp,
                          optimizer_kwargs={"learning_rate": LR}, activation_size=d, n_dict_components=n)


def port_record(jens, sig, path):
    """The port's `state_dict` of an ensemble at the JAX ensemble's state,
    saved to ``path`` (the workers rebuild from it)."""
    st = jax.device_get(jens.state)
    a = st.opt_state[0]
    state = state_from_jax_numpy(st.params, st.buffers, {"count": np.asarray(a.count), "mu": dict(a.mu),
                                                         "nu": dict(a.nu)}, step=int(st.step), device="cpu")
    models = list(zip(unstack_pytree(state.params, jens.n_models), unstack_pytree(state.buffers, jens.n_models)))
    ens = Ensemble(models, sig, optimizer_kwargs={"learning_rate": LR})
    ens.state = state
    torch.save(ens.state_dict(), path)
    return ens


def jax_steps(mesh_shape, batches, devices, per_model=False):
    from sparse_coding__tpu.parallel import make_mesh

    n = int(np.prod(mesh_shape))
    ens = jax_ensemble().shard(make_mesh(*mesh_shape, devices=devices[:n]))
    losses = [np.asarray(ens.step_batch(jax.numpy.asarray(b), per_model=per_model)[0]["loss"]) for b in batches]
    return np.stack(losses), np.asarray(jax.device_get(ens.state.params["encoder"]))


def assert_params_close(got, want, steps):
    """The port-against-JAX params pin of `tests/test_torch_ensemble.py`:
    within 1e-2 lr per Adam step (Adam turns an f32-noise gradient into a
    step of ~lr, so elementwise rtol would test rounding, not the port)."""
    assert np.abs(np.asarray(got) - want).max() <= 1e-2 * LR * steps


def assert_all_ranks_agree(results, name):
    for r in results[1:]:
        np.testing.assert_array_equal(results[0][name]["losses"], r[name]["losses"])


def test_four_process_world_steps_match_the_jax_mesh(tmp_path, devices):
    rng = np.random.default_rng(0)
    batches = rng.standard_normal((K, B, D)).astype(np.float32)
    pm = rng.standard_normal((2, 4, B, D)).astype(np.float32)
    fbatch = rng.standard_normal((64, D)).astype(np.float32)
    np.save(tmp_path / "b.npy", batches)
    np.save(tmp_path / "pm.npy", pm)
    np.save(tmp_path / "fb.npy", fbatch)
    port_record(jax_ensemble(), FunctionalTiedSAE, tmp_path / "init.pt")
    port_record(jax_ensemble(fista=True), FunctionalFista, tmp_path / "fista.pt")
    common = dict(kind="steps", init=str(tmp_path / "init.pt"))
    scenarios = [
        dict(common, name="t221", mesh=[2, 2, 1], batches=str(tmp_path / "b.npy")),
        dict(common, name="t122", mesh=[1, 2, 2], batches=str(tmp_path / "b.npy"), scan=True),
        dict(common, name="pm221", mesh=[2, 2, 1], batches=str(tmp_path / "pm.npy"), per_model=True),
        dict(kind="fista", name="f221", mesh=[2, 2, 1], init=str(tmp_path / "fista.pt"),
             batch=str(tmp_path / "fb.npy"), num_iter=10),
    ]
    codes, res, errs = spawn(4, scenarios, tmp_path)
    assert codes == [0] * 4, errs
    for name in ("t221", "t122", "pm221", "f221"):
        assert_all_ranks_agree(res, name)

    for name, shape in (("t221", (2, 2, 1)), ("t122", (1, 2, 2))):
        ref_losses, ref_enc = jax_steps(shape, batches, devices)
        np.testing.assert_allclose(res[0][name]["losses"], ref_losses, rtol=1e-5)
        assert_params_close(res[0][name]["state"].params["encoder"].numpy(), ref_enc, K)
    ref_losses, ref_enc = jax_steps((2, 2, 1), pm, devices, per_model=True)
    np.testing.assert_allclose(res[0]["pm221"]["losses"], ref_losses, rtol=1e-5)
    assert_params_close(res[0]["pm221"]["state"].params["encoder"].numpy(), ref_enc, 2)

    # FISTA: the ensemble step and the decoder update on the mesh (JAX's
    # tests/test_parallel.py pins)
    from sparse_coding__tpu.parallel import make_mesh
    from sparse_coding__tpu.train.loop import make_fista_decoder_update

    jf = jax_ensemble(fista=True).shard(make_mesh(2, 2, 1, devices=devices[:4]))
    jl, jaux = jf.step_batch(jax.numpy.asarray(fbatch))
    jf.state = make_fista_decoder_update(num_iter=10, use_pallas=False)(jf.state, jax.numpy.asarray(fbatch), jaux["c"])
    np.testing.assert_allclose(res[0]["f221"]["losses"], np.asarray(jl["loss"]), rtol=1e-5)
    np.testing.assert_allclose(res[0]["f221"]["decoder"], np.asarray(jf.state.params["decoder"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(res[0]["f221"]["hessian"], np.asarray(jf.state.buffers["hessian_diag"]), rtol=1e-4,
                               atol=1e-9)


def test_two_process_world_model_axis_telemetry_and_preemption(tmp_path, devices):
    """One world of two: (a) the model axis gives each member the unsharded
    run's bits (and JAX's values at its pins); (b) the pod layer: per-process
    logs, the straggler's skew gauges, the desync anomaly and its abort;
    (c) pod preemption: one rank SIGTERMed, both checkpoint the same cursor
    and exit 75; (d) rank 0 busy past ``SC_MH_TIMEOUT_MS``: the telemetry
    exchange gives up, the pod barrier (the sweep's dataset wait, the
    checkpoint commits) waits for it."""
    rng = np.random.default_rng(1)
    batches = rng.standard_normal((K, B, D)).astype(np.float32)
    np.save(tmp_path / "b.npy", batches)
    local = port_record(jax_ensemble(), FunctionalTiedSAE, tmp_path / "init.pt")
    local_losses = np.stack([local.step_batch(torch.from_numpy(b))[0]["loss"].numpy() for b in batches])
    sweep_cfg = dict(activation_width=16, n_chunks=2, gen_batch_size=64, chunk_size_gb=64 * 16 * 2 / 1024 ** 3,
                     batch_size=32, dataset_folder=str(tmp_path / "data"), n_ground_truth_components=32,
                     feature_num_nonzero=4)
    sleep_s = 0.25
    timeout_ms, slow_s = 300, 3.0  # a FileStore's waits give up on whole seconds: 300 ms is ~1 s there
    scenarios = [
        dict(kind="slow_root", name="slow", timeout_ms=timeout_ms, sleep_s=slow_s),
        dict(kind="steps", name="t211", mesh=[2, 1, 1], init=str(tmp_path / "init.pt"),
             batches=str(tmp_path / "b.npy")),
        dict(kind="telemetry", name="pod", mesh=[1, 2, 1], run_dir=str(tmp_path / "pod_run")),
        dict(kind="preempt", name="preempt", mesh=[1, 2, 1], builder="synthetic_linear_range",
             out=str(tmp_path / "preempted"), cfg=sweep_cfg, victim=1, fault="sigterm:chunk=0"),
    ]
    env = {0: {"SC_TEST_DESYNC": "1"}, 1: {"SC_TEST_DESYNC": "1", "SC_TEST_CHUNK_SLEEP": str(sleep_s)}}
    codes, res, errs = spawn(2, scenarios, tmp_path, env_by_rank=env)
    assert codes == [75, 75], errs

    # (d) before the rest: the barrier outwaited the flag's timeout, which
    # the telemetry exchange kept
    assert res[1]["slow"]["probe"] is None and res[0]["slow"]["probe"] == ["0", "1"]
    assert res[1]["slow"]["barrier_waited_s"] > timeout_ms / 1e3, res[1]["slow"]

    # (a) the model axis: the unsharded run's bits, member for member
    assert_all_ranks_agree(res, "t211")
    assert res[0]["t211"]["fused_adam"] is False  # f32 compute: autograd, as unsharded
    np.testing.assert_array_equal(res[0]["t211"]["losses"], local_losses)
    for k, v in local.state.params.items():
        assert torch.equal(res[0]["t211"]["state"].params[k], v), k
    ref_losses, ref_enc = jax_steps((2, 1, 1), batches, devices)
    np.testing.assert_allclose(res[0]["t211"]["losses"], ref_losses, rtol=1e-5)
    assert_params_close(local.state.params["encoder"].numpy(), ref_enc, K)

    # (b) per-process logs, every record tagged with its rank
    events = {}
    for pid in range(2):
        events[pid] = read_events(tmp_path / "pod_run" / f"events.p{pid}.jsonl")
        assert all(e["process_index"] == pid for e in events[pid])
        kinds = [e["event"] for e in events[pid]]
        assert kinds.count("heartbeat") == 3 and kinds[0] == "run_start" and kinds[-1] == "run_end"
        fp = events[pid][0]["fingerprint"]
        assert fp["mesh"] == {"model": 1, "data": 2, "dict": 1} and fp["distributed_backend"] == "gloo"
        assert fp["process_count"] == 2
    assert "clock_offset_seconds" in events[1][0]["fingerprint"]
    gauges = [e for e in events[0] if e["event"] == "snapshot"][-1]["gauges"]
    gauges1 = [e for e in events[1] if e["event"] == "snapshot"][-1]["gauges"]
    assert gauges["skew.flush.spread_seconds"] >= 0.6 * sleep_s, gauges
    assert gauges1["skew.flush.spread_seconds"] == gauges["skew.flush.spread_seconds"]
    for pid in range(2):
        desync = [e for e in events[pid] if e["event"] == "anomaly" and e["kind"] == "desync"]
        assert desync and desync[0]["processes"] == [1]
        assert res[pid]["pod"]["mismatched"] == [1] and res[pid]["pod"]["aborted"] is True

    # (c) both ranks checkpointed chunk 0 (rank 1's slice is rank 0's: a data
    # axis holds one slice) and exited 75; rank 0 learned it from its peer
    assert res[0]["preempt"]["preempted"] and res[1]["preempt"]["preempted"]
    out = tmp_path / "preempted"
    assert sorted(p.name for p in out.glob("ckpt_*")) == ["ckpt_0"]
    assert (out / "ckpt_0" / "shards").is_dir()
    for pid in range(2):
        ev = read_events(out / f"events.p{pid}.jsonl")
        pre = [e for e in ev if e["event"] == "preempt"]
        assert len(pre) == 1 and pre[0]["cursor"] == 0
    assert [e["flagged"] for e in read_events(out / "events.p0.jsonl") if e["event"] == "preempt_peer"] == [[1]]
