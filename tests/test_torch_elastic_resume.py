"""Elastic resume: a state saved under one mesh (or by one process) resumes
under any other, and the sharded drivers match their unsharded runs.

  - 5 steps from the JAX init on a (2,2,1) world of 4, a sharded checkpoint,
    then the checkpoint restored onto (1,4,1), (4,1,1), (2,2,1) and, here, on
    no mesh at all; each continuation held to JAX's (5 steps on its (2,2,2)
    mesh, then unsharded) at JAX's pin, rtol 1e-5 / atol 1e-6
    (`tests/test_elastic_resume.py`); a one-process checkpoint restored onto
    (1,2,2) likewise;
  - the sweep (`run_sweep_synthetic` with the catalog's ``mesh=``) in a
    world of 2 against the same sweep in one process: its sharded
    checkpoint restored here by a world of one to the export's bits, and a
    one-process checkpoint resumed by the world of 2; `train_big_batch(mesh=)`
    likewise. Params within 1e-2 lr a step (the data axis sums in another
    order; Adam turns f32 noise into steps of ~lr).
"""

import functools

import jax
import numpy as np
import torch

from _torch_mp_worker import spawn
from sparse_coding__tpu_torch import Ensemble, FunctionalTiedSAE
from sparse_coding__tpu_torch.ensemble import unstack_pytree
from sparse_coding__tpu_torch.interop import state_from_jax_numpy
from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib
from sparse_coding__tpu_torch.utils.tree import tree_leaves

D_ACT, N_DICT, BATCH = 16, 64, 32
L1 = (1e-4, 3e-4, 1e-3, 3e-3)
LR = 1e-3


def _jax_build():
    from sparse_coding__tpu.ensemble import build_ensemble

    return build_ensemble(FunctionalTiedSAEJax(), jax.random.PRNGKey(0), [{"l1_alpha": a} for a in L1],
                          optimizer_kwargs={"learning_rate": LR}, activation_size=D_ACT, n_dict_components=N_DICT)


def FunctionalTiedSAEJax():
    from sparse_coding__tpu.models import FunctionalTiedSAE as JaxTied

    return JaxTied


def _port_of(jens):
    st = jax.device_get(jens.state)
    a = st.opt_state[0]
    state = state_from_jax_numpy(st.params, st.buffers, {"count": np.asarray(a.count), "mu": dict(a.mu),
                                                         "nu": dict(a.nu)}, step=int(st.step), device="cpu")
    models = list(zip(unstack_pytree(state.params, 4), unstack_pytree(state.buffers, 4)))
    ens = Ensemble(models, FunctionalTiedSAE, optimizer_kwargs={"learning_rate": LR})
    ens.state = state
    return ens


def test_a_sharded_checkpoint_resumes_on_every_mesh(tmp_path, devices):
    from sparse_coding__tpu.parallel.mesh import make_mesh as jax_mesh

    batches = np.stack([np.asarray(jax.random.normal(jax.random.PRNGKey(1000 + i), (BATCH, D_ACT)))
                        for i in range(8)])
    np.save(tmp_path / "b.npy", batches)
    torch.save(_port_of(_jax_build()).state_dict(), tmp_path / "init.pt")
    # JAX: 5 steps on its mesh, then the unsharded continuation (its control)
    jens = _jax_build().shard(jax_mesh(2, 2, 2, devices=devices))
    for b in batches[:5]:
        jens.step_batch(jax.numpy.asarray(b))
    from sparse_coding__tpu.ensemble import Ensemble as JaxEnsemble

    control = JaxEnsemble.from_state(jens.state_dict())
    ref = np.stack([np.asarray(control.step_batch(jax.numpy.asarray(b))[0]["loss"]) for b in batches[5:]])
    # a one-process checkpoint of the port's own 5 steps
    single = _port_of(_jax_build())
    for b in batches[:5]:
        single.step_batch(torch.from_numpy(b))
    ckpt_lib.save_ensemble_checkpoint(tmp_path / "ckpt_single", [(single, {"dict_size": 0}, "e")], chunk_cursor=4)

    meshes = [[1, 4, 1], [4, 1, 1], [2, 2, 1]]
    sc = dict(kind="elastic", name="el", init=str(tmp_path / "init.pt"), batches=str(tmp_path / "b.npy"), train=5,
              mesh=[2, 2, 1], root=str(tmp_path), resume_meshes=meshes, single=str(tmp_path / "ckpt_single"),
              single_mesh=[1, 2, 2])
    codes, res, errs = spawn(4, [sc], tmp_path)
    assert codes == [0] * 4, errs
    el = [r["el"] for r in res]
    for shape in meshes:
        for r in range(4):
            np.testing.assert_array_equal(el[r][tuple(shape)]["losses"], el[0][tuple(shape)]["losses"])
        np.testing.assert_allclose(el[0][tuple(shape)]["losses"], ref, rtol=1e-5, atol=1e-6, err_msg=str(shape))
        assert el[0][tuple(shape)]["sharded_record"]
        assert el[0][tuple(shape)]["local_shapes"]["encoder"] == (4 // shape[0], N_DICT // shape[2], D_ACT)
    np.testing.assert_allclose(el[0]["single"]["losses"], ref, rtol=1e-5, atol=1e-6)
    # the shard files: one a (model, dict) slice (the data axis holds copies)
    assert sorted(p.name for p in (tmp_path / "ckpt_sharded" / "shards" / "e").iterdir()) == ["m0_k0.pt", "m1_k0.pt"]

    # a world of one restores the world of 4's checkpoint whole
    ok, why = ckpt_lib.verify_checkpoint(tmp_path / "ckpt_sharded")
    assert ok, why
    tree = ckpt_lib.restore_ensemble_checkpoint(tmp_path / "ckpt_sharded")
    trained = el[0]["trained"]
    for got, want in zip(tree_leaves(tree["ensembles"]["e"]["state"].params),
                         tree_leaves(trained.params)):
        assert torch.equal(got, want)
    assert torch.equal(tree["ensembles"]["e"]["state"].opt_state.nu["encoder"], trained.opt_state.nu["encoder"])
    assert tree["ensembles"]["e"]["state"].step == 5 and int(tree["cursor"]["chunk"]) == 4
    ens = Ensemble.from_state(tree["ensembles"]["e"], device="cpu")
    got = np.stack([ens.step_batch(torch.from_numpy(b))[0]["loss"].numpy() for b in batches[5:]])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def _sweep_cfg(tmp_path, n_epochs):
    return dict(activation_width=D_ACT, n_chunks=2, gen_batch_size=64, chunk_size_gb=64 * D_ACT * 2 / 1024 ** 3,
                batch_size=BATCH, dataset_folder=str(tmp_path / "data"), n_ground_truth_components=32,
                feature_num_nonzero=4, n_epochs=n_epochs)


def _assert_exports_close(got, want, steps):
    assert len(got) == len(want)
    for (ga, gh), (wa, wh) in zip(got, want):
        assert gh == wh
        for f in ("encoder", "encoder_bias"):
            assert np.abs(getattr(ga, f).numpy() - getattr(wa, f).numpy()).max() <= 1e-2 * LR * steps, f


def test_sharded_sweep_and_big_batch_match_one_process(tmp_path):
    from sparse_coding__tpu_torch.train import experiments as texp
    from sparse_coding__tpu_torch.train.big_batch import train_big_batch

    # one process: the sweep for 1 and 2 epochs, the big-batch trainer
    for epochs in (1, 2):
        texp.run_sweep_synthetic(texp.synthetic_linear_range, device="cpu", output_folder=str(tmp_path / f"u{epochs}"),
                                 **_sweep_cfg(tmp_path, epochs))
    data = np.random.default_rng(4).standard_normal((256, D_ACT)).astype(np.float32)
    np.save(tmp_path / "data.npy", data)
    bb = dict(hp=dict(activation_size=D_ACT, n_dict_components=N_DICT, l1_alpha=1e-3), batch=64, steps=6,
              reinit_every=4)
    log = []
    bb_ref, _ = train_big_batch(FunctionalTiedSAE, bb["hp"], torch.from_numpy(data), bb["batch"], bb["steps"], 0,
                                reinit_every=bb["reinit_every"], resurrection_log=log, device="cpu")

    scenarios = [
        dict(kind="sweep", name="fresh", builder="synthetic_linear_range", mesh=[1, 2, 1], out=str(tmp_path / "s1"),
             cfg=_sweep_cfg(tmp_path, 1)),
        dict(kind="sweep", name="resumed", builder="synthetic_linear_range", mesh=[1, 2, 1], out=str(tmp_path / "s2"),
             cfg=_sweep_cfg(tmp_path, 2), copy_from=str(tmp_path / "u1"), resume=True),
        dict(kind="big_batch", name="bb", mesh=[1, 2, 1], data=str(tmp_path / "data.npy"), **bb),
    ]
    codes, res, errs = spawn(2, scenarios, tmp_path)
    assert codes == [0, 0], errs

    load = functools.partial(ckpt_lib.load_learned_dicts, device="cpu", verify=True)
    fresh = load(tmp_path / "s1" / "_1" / "learned_dicts.pkl")
    _assert_exports_close(fresh, load(tmp_path / "u1" / "_1" / "learned_dicts.pkl"), steps=4)
    resumed = load(tmp_path / "s2" / "_3" / "learned_dicts.pkl")
    _assert_exports_close(resumed, load(tmp_path / "u2" / "_3" / "learned_dicts.pkl"), steps=8)
    from sparse_coding__tpu_torch.telemetry import read_events

    for r in range(2):  # both ranks resumed the one-process checkpoint after chunk 1
        resumes = [e for e in read_events(tmp_path / "s2" / f"events.p{r}.jsonl") if e["event"] == "resume"]
        assert [e["cursor"]["chunk"] for e in resumes] == [1]
    # the world of 2's last checkpoint, restored whole by a world of one: the export's bits
    latest = ckpt_lib.latest_checkpoint(tmp_path / "s1")
    assert (latest / "shards").is_dir()
    tree = ckpt_lib.restore_ensemble_checkpoint(latest)
    restored = [ld for name in sorted(tree["ensembles"], key=lambda n: float(n.split("_r")[1]))
                for ld in Ensemble.from_state(tree["ensembles"][name], device="cpu").to_learned_dicts()]
    assert len(restored) == len(fresh)
    for r, (ld, _hp) in zip(restored, fresh):
        assert torch.equal(r.encoder, ld.encoder) and torch.equal(r.encoder_bias, ld.encoder_bias)

    for r in range(2):
        got = res[r]["bb"]
        assert got["log"] == log
        for k, v in bb_ref.params.items():
            assert np.abs(got["params"][k] - v.numpy()).max() <= 1e-2 * LR * bb["steps"], k
        np.testing.assert_allclose(got["c_totals"], bb_ref.c_totals.numpy(), atol=2)
    np.testing.assert_array_equal(res[0]["bb"]["params"]["encoder"], res[1]["bb"]["params"]["encoder"])
