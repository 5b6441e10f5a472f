"""One rank of a multi-process world for the port's scale-out tests.

    python tests/_torch_mp_worker.py <rank> <world> <store file> <plan.json>

Joins a gloo world of ``world`` CPU processes through a `FileStore` (the
file under the test's ``tmp_path``: no TCP port), then runs the plan's
scenarios in turn, each on its own mesh, and after each one saves what it
returned to ``<plan["out"]>/r<rank>.pt`` (`torch.save`), so the parent reads
the results of every scenario that finished. A scenario that ends in a
preemption makes the process exit 75 (the resumable exit), like a driver.

Scenarios (``kind``):
  - ``steps``: an ensemble rebuilt from ``init`` (a `state_dict` file),
    sharded on ``mesh``, stepped on ``batches`` (an .npy of [K, B, D], or
    [K, M, B, D] with ``per_model``), by `step_batch` or one `step_scan`:
    every step's losses, and on rank 0 the gathered final state;
  - ``fista``: the FISTA gradient step and the decoder update on a mesh;
  - ``elastic``: ``train`` steps on ``mesh``, a sharded checkpoint, then
    for each of ``resume_meshes`` the checkpoint restored onto it (and
    ``single``, a one-process checkpoint, onto ``single_mesh``) and
    ``resume`` steps more;
  - ``sweep``: `run_sweep_synthetic` of a catalog builder given ``mesh``;
  - ``big_batch``: `train_big_batch` with ``mesh``;
  - ``telemetry``: the pod layer in a run dir (per-process logs, desync,
    heartbeats with an injected straggler: ``SC_TEST_CHUNK_SLEEP``,
    ``SC_TEST_DESYNC``);
  - ``preempt``: `sweep` with ``SC_FAULT`` set on rank ``victim`` alone;
  - ``slow_root``: rank 0 busy past ``SC_MH_TIMEOUT_MS`` (as when it builds
    a missing dataset) before a telemetry exchange and a pod barrier;
  - ``seqpar``: the sequence-parallel path on a ``(1, world, 1)`` mesh:
    `Mesh.ring_shift` / `Mesh.all_to_all` on rank-numbered tensors, ring and
    Ulysses attention on this rank's slice of ``qkv``, the sharded forward of
    each ``models`` entry (params by `torch.save`, with a shard-local hook),
    Ulysses' refusal of indivisible heads, and the sharded harvest
    (`make_activation_dataset` and `harvest_to_device` with ``mesh=``), with
    the chunk writes and the spans each rank made.
"""

import functools
import json
import os
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _load_state(path):
    import torch

    return torch.load(path, weights_only=False)


def _mesh(shape):
    from sparse_coding__tpu_torch.parallel import make_mesh

    return make_mesh(*shape)


def steps(rank, sc):
    import numpy as np
    import torch

    from sparse_coding__tpu_torch import Ensemble

    ens = Ensemble.from_state(_load_state(sc["init"]), device="cpu", mesh=_mesh(sc["mesh"]),
                              shard_dict=sc.get("shard_dict", True))
    if "mask" in sc:
        ens.set_update_mask(sc["mask"])
    batches = torch.from_numpy(np.load(sc["batches"]))
    per_model = bool(sc.get("per_model", False))
    if sc.get("scan"):
        losses = ens.step_scan(batches, per_model=per_model)["loss"]
    else:
        losses = torch.stack([ens.step_batch(b, per_model=per_model)[0]["loss"] for b in batches])
    out = {"losses": losses.numpy(), "route": ens._route(batches.shape[-2], "update_mask" in ens.state.buffers,
                                                         per_model), "fused_adam": ens.fused_adam is not None}
    sd = ens.state_dict()
    if rank == 0:
        out["state"] = sd["state"]
    return out


def fista(rank, sc):
    import numpy as np
    import torch

    from sparse_coding__tpu_torch import Ensemble
    from sparse_coding__tpu_torch.train.loop import make_fista_decoder_update

    ens = Ensemble.from_state(_load_state(sc["init"]), device="cpu", mesh=_mesh(sc["mesh"]))
    batch = torch.from_numpy(np.load(sc["batch"]))
    loss, aux = ens.step_batch(batch)
    update = make_fista_decoder_update(sc["num_iter"])
    ens.state = update(ens.state, ens.local_batch(batch), aux["c"], mesh=ens.mesh, dict_cut=ens._dict_parallel())
    st = ens.full_state()
    return {"losses": loss["loss"].numpy(), "decoder": st.params["decoder"].numpy(),
            "hessian": st.buffers["hessian_diag"].numpy()}


def elastic(rank, sc):
    import numpy as np
    import torch

    from sparse_coding__tpu_torch import Ensemble
    from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib

    batches = torch.from_numpy(np.load(sc["batches"]))
    ens = Ensemble.from_state(_load_state(sc["init"]), device="cpu", mesh=_mesh(sc["mesh"]))
    for b in batches[: sc["train"]]:
        ens.step_batch(b)
    root = Path(sc["root"])
    ckpt_lib.save_ensemble_checkpoint(root / "ckpt_sharded", [(ens, {"dict_size": 0}, "e")], chunk_cursor=4)
    trained = ens.state_dict()["state"]  # a gather: every rank takes part
    out = {"trained": trained if rank == 0 else None}
    cont = batches[sc["train"]:]

    def resume(src, shape):
        mesh = _mesh(shape)
        tree = ckpt_lib.restore_ensemble_checkpoint(src, template={"ensembles": {"e": {"mesh": mesh}}})
        local = tree["ensembles"]["e"]
        r = Ensemble.from_state(local, device="cpu", mesh=mesh)
        held = {k: tuple(v.shape) for k, v in r.state.params.items()}
        losses = torch.stack([r.step_batch(b)[0]["loss"] for b in cont])
        return {"losses": losses.numpy(), "local_shapes": held, "sharded_record": "local_slice" in local}

    for shape in sc["resume_meshes"]:
        out[tuple(shape)] = resume(root / "ckpt_sharded", shape)
    out["single"] = resume(Path(sc["single"]), sc["single_mesh"])
    return out


def sweep(rank, sc):
    from sparse_coding__tpu_torch.train import experiments as texp

    folder = Path(sc["out"])
    if sc.get("copy_from") and rank == 0 and not folder.exists():
        shutil.copytree(sc["copy_from"], folder)
    _barrier("copy_" + folder.name)
    builder = functools.partial(getattr(texp, sc["builder"]), mesh=_mesh(sc["mesh"]))
    if sc.get("resume"):
        os.environ["SC_RESUME"] = "1"
    else:
        os.environ.pop("SC_RESUME", None)
    dicts = texp.run_sweep_synthetic(builder, device="cpu", output_folder=str(folder), **sc["cfg"])
    return {"n_dicts": len(dicts)}


def _barrier(tag):
    from sparse_coding__tpu_torch.train.checkpoint import _pod_barrier

    _pod_barrier(tag)


def big_batch(rank, sc):
    import numpy as np
    import torch

    from sparse_coding__tpu_torch.models import FunctionalTiedSAE
    from sparse_coding__tpu_torch.train.big_batch import train_big_batch

    data = torch.from_numpy(np.load(sc["data"]))
    log = []
    state, _ = train_big_batch(FunctionalTiedSAE, sc["hp"], data, sc["batch"], sc["steps"], 0,
                               reinit_every=sc["reinit_every"], resurrection_log=log, mesh=_mesh(sc["mesh"]),
                               device="cpu")
    return {"params": {k: v.numpy() for k, v in state.params.items()}, "c_totals": state.c_totals.numpy(),
            "log": log}


def telemetry(rank, sc):
    import torch

    from sparse_coding__tpu_torch import FunctionalTiedSAE, build_ensemble
    from sparse_coding__tpu_torch.telemetry import RunTelemetry, check_desync, heartbeat
    from sparse_coding__tpu_torch.telemetry.anomaly import AnomalyAbort
    from sparse_coding__tpu_torch.utils import flags

    sleep_s = flags.SC_TEST_CHUNK_SLEEP.get() or 0.0
    cfg = {"mode": "telemetry", "batch": 64, "d_act": 16}
    if flags.SC_TEST_DESYNC.get():
        cfg["poison"] = rank  # the ranks now deliberately disagree
    mesh = _mesh(sc["mesh"])
    # host-local training (as the JAX package's drill): a sharded step would
    # wait for the straggler inside its collective and hide the skew
    ens = build_ensemble(FunctionalTiedSAE, 0, [{"l1_alpha": a} for a in (1e-4, 1e-3)],
                         optimizer_kwargs={"learning_rate": 1e-3}, activation_size=16, n_dict_components=64,
                         device="cpu")
    tel = RunTelemetry(out_dir=sc["run_dir"], run_name="podtest", config=cfg)
    tel.run_start(mesh=mesh)
    mismatched = check_desync(tel, config=cfg)  # warn-only: the run continues
    g = torch.Generator().manual_seed(100)
    for step in range(3):
        tel.chunk_start(step)
        if sleep_s:
            time.sleep(sleep_s)  # the injected straggler
        ens.step_batch(torch.randn(64, 16, generator=g))
        tel.counter_inc("train.steps")
        end = tel.chunk_end(step)
        heartbeat(tel, step=step + 1, window_seconds=end.get("seconds"))
    try:
        check_desync(tel, config=cfg, action="abort")
        aborted = False
    except AnomalyAbort:
        aborted = True
    tel.run_end(status="ok")
    tel.close()
    return {"mismatched": mismatched, "aborted": aborted}


def preempt(rank, sc):
    from sparse_coding__tpu_torch.train.preemption import Preempted

    if rank == sc["victim"]:
        os.environ["SC_FAULT"] = sc["fault"]
    try:
        sweep(rank, sc)
    except Preempted:
        return {"preempted": True}
    return {"preempted": False}


def slow_root(rank, sc):
    from sparse_coding__tpu_torch.telemetry.multihost import _kv_allgather
    from sparse_coding__tpu_torch.train.checkpoint import _pod_barrier

    _barrier("slow_root_start")  # the ranks start together
    before = os.environ.get("SC_MH_TIMEOUT_MS")
    os.environ["SC_MH_TIMEOUT_MS"] = str(sc["timeout_ms"])
    try:
        if rank == 0:
            time.sleep(sc["sleep_s"])
        probe = _kv_allgather("slow_root_probe", str(rank))  # the other ranks give up on rank 0
        t0 = time.monotonic()
        _pod_barrier("slow_root")  # they wait for it here
        waited = time.monotonic() - t0
    finally:
        if before is None:
            os.environ.pop("SC_MH_TIMEOUT_MS", None)
        else:
            os.environ["SC_MH_TIMEOUT_MS"] = before
    return {"probe": probe, "barrier_waited_s": waited}


def seqpar(rank, sc):
    import numpy as np
    import torch

    from sparse_coding__tpu_torch.data import activations as tact
    from sparse_coding__tpu_torch.lm import model as tm
    from sparse_coding__tpu_torch.lm.ring_attention import ATTN_IMPLS, make_sequence_parallel_fn, ring_attention
    from sparse_coding__tpu_torch.lm.ring_attention import sequence_parallel_forward, ulysses_attention
    from sparse_coding__tpu_torch.telemetry import RunTelemetry, read_events

    mesh = _mesh(sc["mesh"])
    p = mesh.shape["data"]
    out = {"coords": mesh.coords["data"]}
    base = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) + 100 * rank
    out["ring_shift"] = mesh.ring_shift(base, "data").numpy()
    a2a = torch.arange(2 * 4 * 8, dtype=torch.float32).reshape(2, 4, 8) + 1000 * rank
    out["all_to_all"] = mesh.all_to_all(a2a, "data", split_dim=2, concat_dim=1).numpy()
    out["stats"] = dict(mesh.stats)

    q, k, v = (torch.from_numpy(a) for a in np.load(sc["qkv"]))
    n = q.shape[1] // p
    i = mesh.coords["data"]
    loc = [t[:, i * n:(i + 1) * n] for t in (q, k, v)]
    out["attn"] = {name: ATTN_IMPLS[name]("data", mesh=mesh)(*loc).numpy() for name in ("ring", "ulysses")}
    out["attn_noncausal_ring"] = ring_attention("data", mesh=mesh)(*loc, causal=False).numpy()

    tokens = torch.from_numpy(np.load(sc["tokens"]))
    out["forward"] = {}
    for tag, (cfg_kw, params_path, name) in sc["models"].items():
        cfg = tm.LMConfig(**cfg_kw)
        params = torch.load(params_path, weights_only=False)
        for attn in ("ring", "ulysses"):
            logits, cache = sequence_parallel_forward(params, tokens, cfg, mesh, cache_names=[name],
                                                          attn=attn)
            hooked, _ = make_sequence_parallel_fn(cfg, mesh, hooks={name: lambda t: t * 0.5},
                                                      attn=attn)(params, tokens)
            out["forward"][tag, attn] = {"logits": logits.numpy(), "cache": cache[name].numpy(),
                                         "hooked": hooked.numpy()}
    try:
        ulysses_attention("data", mesh=mesh)(*(torch.zeros(1, 4, 3, 2) for _ in range(3)))
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)

    hv = sc["harvest"]
    cfg = tm.LMConfig(**hv["cfg"])
    params = torch.load(hv["params"], weights_only=False)
    htok = np.load(hv["tokens"])
    writes = []
    real_save = tact.save_chunk
    tact.save_chunk = lambda folder, i, *a, **kw: (writes.append((str(folder), int(i))), real_save(folder, i, *a,
                                                                                                      **kw))[1]
    tel = RunTelemetry(out_dir=Path(hv["root"]) / f"tel_r{rank}", run_name="seqpar")
    try:
        out["harvest"] = {}
        for attn in ("ring", "ulysses"):
            folders = tact.make_activation_dataset(params, cfg, htok, Path(hv["root"]) / attn, hv["layers"],
                                                   ["residual"], batch_size=hv["batch_size"],
                                                   chunk_size_gb=hv["chunk_size_gb"], n_chunks=hv["n_chunks"],
                                                   mesh=mesh, seq_attn=attn, device="cpu")
            out["harvest"][attn] = {str(key): str(f) for key, f in folders.items()}
        chunks = tact.harvest_to_device(params, cfg, htok, hv["layers"], ["residual"], batch_size=hv["batch_size"],
                                        chunk_size_gb=hv["chunk_size_gb"], n_chunks=hv["n_chunks"], mesh=mesh,
                                        seq_attn="ring", save_folder=Path(hv["root"]) / "fused", device="cpu")
        out["to_device"] = [{str(key): c.numpy() for key, c in chunk.items()} for chunk in chunks]
    finally:
        tact.save_chunk = real_save
    tel.close()
    out["writes"] = writes
    out["spans"] = [e.get("name") for e in read_events(tel.path) if e.get("event") == "span"]
    return out


def spawn(world, scenarios, tmp, env_by_rank=None, timeout=180):
    """Run ``scenarios`` in a gloo world of ``world`` processes under
    ``tmp``: ``(return codes, each rank's results)``. Every process is
    killed if any outlives ``timeout`` seconds."""
    import subprocess

    import torch

    tmp = Path(tmp)
    out = tmp / "mp_out"
    out.mkdir(parents=True, exist_ok=True)
    plan = tmp / "mp_plan.json"
    plan.write_text(json.dumps({"out": str(out), "scenarios": scenarios}))
    procs = []
    for r in range(world):
        env = {**os.environ, "PYTHONPATH": str(REPO), **((env_by_rank or {}).get(r, {}))}
        procs.append(subprocess.Popen([sys.executable, __file__, str(r), str(world), str(tmp / "mp_store"), str(plan)],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                                      start_new_session=True))
    logs, deadline = [], time.monotonic() + timeout
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    results = [torch.load(out / f"r{r}.pt", weights_only=False) if (out / f"r{r}.pt").exists() else None
               for r in range(world)]
    return codes, results, [err[-3000:] for _o, err in logs]


SCENARIOS = {"steps": steps, "fista": fista, "elastic": elastic, "sweep": sweep, "big_batch": big_batch,
             "telemetry": telemetry, "preempt": preempt, "slow_root": slow_root, "seqpar": seqpar}


def main():
    rank, world, store, plan_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)  # several ranks share the machine's cores
    from sparse_coding__tpu_torch.parallel import initialize_distributed

    assert initialize_distributed(f"file://{store}", world, rank, device="cpu")
    plan = json.loads(Path(plan_path).read_text())
    out_path = Path(plan["out"]) / f"r{rank}.pt"
    results, code = {}, 0
    try:
        for sc in plan["scenarios"]:
            results[sc["name"]] = SCENARIOS[sc["kind"]](rank, sc)
            torch.save(results, out_path)
            if results[sc["name"]].get("preempted"):
                code = 75
                break
    finally:
        dist.destroy_process_group()
    return code


if __name__ == "__main__":
    sys.exit(main())
