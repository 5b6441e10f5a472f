"""Sweep driver: train ensembles over an activation chunk store, with
checkpoints, preemption and resume.

Counterpart of `sparse_coding__tpu/train/sweep.py::sweep`: build or load the
dataset, build the ensembles, walk a seeded permutation of the chunks
(tiled over the epochs), train every ensemble on each chunk
(`train.loop.ensemble_train_loop`: on the card K1 + K2 for a fusable Adam,
K1 + K3 for an optimizer the kernel cannot fuse), and export the learned
dicts at the exponential save points (`SAVE_CHUNKS` and the last chunk).

Recovery, as in the JAX package:
  - SIGTERM/SIGINT → a committed checkpoint at the next chunk boundary →
    exit 75 (`train.preemption.Preempted`);
  - ``resume=True`` (or ``None`` with ``SC_RESUME`` set) restores the newest
    committed, intact checkpoint and carries on from the next position.
    Each (position, ensemble) pair shuffles its chunk from a seed derived
    from ``cfg.seed`` and the position alone (`chunk_seed`), so a resumed
    run, and one that skipped chunks, trains every later chunk exactly as
    an uninterrupted run would: the resumed export is bit-equal to it;
  - a chunk that fails verification is quarantined and skipped within
    ``SC_CHUNK_LOSS_BUDGET`` (past it: exit 75); a read that keeps failing
    with an `OSError` exits 75 too (`ResumableAbort`).

Sharded ensembles (an init function that calls `Ensemble.shard`, e.g. a
catalog builder given ``mesh=``): every rank runs `sweep` in lockstep over
the same store; the desync check and the fingerprint with the mesh open the
run, each chunk ends on a pod heartbeat, checkpoints hold each rank's slices
(`train.checkpoint`), a resume keeps the init function's mesh (elastic: the
checkpoint may come from another factorization or from one process), and
the exports are written once, by rank 0, from the gathered state. In a
world of several ranks rank 0 builds a missing dataset while the others
wait.

The run explains itself from ``events.jsonl`` (`telemetry.events`) and the
metrics JSONL (`utils.logging`), whose every flush the anomaly guard reads
(`telemetry.anomaly`; ``cfg.anomaly_policy``, default: NaN/Inf and
dead-fraction jumps, no loss spikes, since one logger carries every
ensemble). Everything runs on ``device`` (None = cuda).
"""

from __future__ import annotations

import os
import sys
from itertools import product
from math import isclose
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparse_coding__tpu_torch.data import integrity as data_integrity
from sparse_coding__tpu_torch.data.activations import setup_data
from sparse_coding__tpu_torch.data.chunks import ChunkStore, generate_synthetic_chunks
from sparse_coding__tpu_torch.data.synthetic import SparseMixDataset
from sparse_coding__tpu_torch.ensemble import Ensemble
from sparse_coding__tpu_torch.metrics import standard as sm
from sparse_coding__tpu_torch.telemetry.anomaly import AnomalyGuard, AnomalyPolicy
from sparse_coding__tpu_torch.telemetry.events import RunTelemetry, run_fingerprint
from sparse_coding__tpu_torch.telemetry.multihost import check_desync, heartbeat, process_info
from sparse_coding__tpu_torch.telemetry.profiling import TraceTrigger, record_hbm_watermarks
from sparse_coding__tpu_torch.telemetry.provenance import export_digest, producer_identity
from sparse_coding__tpu_torch.telemetry.spans import span
from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib
from sparse_coding__tpu_torch.train.loop import DriverCheckpointer, ensemble_train_loop
from sparse_coding__tpu_torch.train.preemption import Preempted, ResumableAbort, resume_requested
from sparse_coding__tpu_torch.utils.device import resolve_device
from sparse_coding__tpu_torch.utils.faults import fault_point
from sparse_coding__tpu_torch.utils.logging import MetricLogger, make_hyperparam_name
from sparse_coding__tpu_torch.utils.tree import tree_map

SAVE_CHUNKS = {2**j for j in range(3, 10)}  # 8, 16, ..., 512


def filter_learned_dicts(learned_dicts: List[Tuple[Any, Dict[str, Any]]],
                         hyperparam_filters: Dict[str, Any]) -> List[Tuple[Any, Dict[str, Any]]]:
    """The dicts whose hyperparams match every filter (floats to rel 1e-3);
    a dict without a filtered key does not match."""

    def matches(hp, k, v):
        if k not in hp:
            return False
        return isclose(hp[k], v, rel_tol=1e-3) if isinstance(v, float) else hp[k] == v

    return [(ld, hp) for ld, hp in learned_dicts if all(matches(hp, k, v) for k, v in hyperparam_filters.items())]


def unstacked_to_learned_dicts(ensemble: Ensemble, args: Dict[str, Any], ensemble_hyperparams: Sequence[str],
                               buffer_hyperparams: Sequence[str]) -> List[Tuple[Any, Dict[str, Any]]]:
    """Every member as ``(LearnedDict, hyperparams)``: ensemble-level
    hyperparams from ``args``, member-varying ones from its buffers (0-d
    values as Python numbers)."""
    learned_dicts = []
    for params, buffers in ensemble.unstack():
        hp: Dict[str, Any] = {}
        for ep in ensemble_hyperparams:
            if ep not in args:
                raise ValueError(f"Hyperparameter {ep} not found in args")
            hp[ep] = args[ep]
        for bp in buffer_hyperparams:
            if bp not in buffers:
                raise ValueError(f"Hyperparameter {bp} not found in buffers")
            val = buffers[bp].detach().cpu().numpy()
            hp[bp] = val.item() if val.ndim == 0 else val
        learned_dicts.append((ensemble.sig.to_learned_dict(tree_map(lambda v: v.detach().clone(), params), buffers),
                              hp))
    return learned_dicts


def _feature_activity_counts(ld, batch: torch.Tensor) -> torch.Tensor:
    """Per-feature activation counts on the sample [n_feats]."""
    return (ld.encode(batch) != 0).sum(dim=0)


def log_sweep_metrics(learned_dicts: List[Tuple[Any, Dict[str, Any]]], chunk: torch.Tensor, chunk_num: int,
                      hyperparam_ranges: Dict[str, Sequence], logger: Optional[MetricLogger],
                      output_folder: Optional[str] = None, n_samples: int = 2000, seed: int = 0,
                      images: bool = False) -> Dict[str, Any]:
    """The save-point metrics: per-dict feature-activity counts (``n_active``
    = features firing more than once on a seeded sample of the chunk, and
    its share) through ``logger``, and, when the sweep spans dict sizes, the
    small-vs-larger-dict MMCS grid per setting, written to
    ``<output_folder>/mmcs_grids_<chunk_num>.npz``. Returns the values.
    ``images=True`` also renders them, as the JAX package does whenever a
    logger is given: the feature-activity overlay and each MMCS grid's
    heatmap through ``logger.log_image`` (needs matplotlib: `plotting`)."""
    idx = np.random.default_rng(seed).choice(chunk.shape[0], size=min(n_samples, chunk.shape[0]), replace=False)
    sample = chunk[torch.from_numpy(idx).to(chunk.device)]
    results: Dict[str, Any] = {"n_active": {}, "feat_counts": {}, "mmcs_grids": {}}
    rows = sm.evaluate_dicts([ld for ld, _ in learned_dicts], sample, {"feat_counts": _feature_activity_counts})
    for (ld, setting), row in zip(learned_dicts, rows):
        name = make_hyperparam_name(setting)
        counts = np.asarray(row["feat_counts"])
        n_ever = int((counts > 1).sum())
        results["feat_counts"][name] = counts
        results["n_active"][name] = {"n_active": n_ever, "prop_active": n_ever / ld.n_feats}

    dict_sizes = list(hyperparam_ranges.get("dict_size", []))
    l1_values = list(hyperparam_ranges.get("l1_alpha", []))
    if len(dict_sizes) > 1 and l1_values:
        grid_hyperparams = [k for k in hyperparam_ranges if k not in ("l1_alpha", "dict_size")]
        small = dict_sizes[0]
        for combo in product(*[hyperparam_ranges[k] for k in grid_hyperparams]):
            setting = dict(zip(grid_hyperparams, combo))
            scores = np.full((len(l1_values), len(dict_sizes) - 1), np.nan)  # untrained cells stay NaN
            for i, l1 in enumerate(l1_values):
                small_matches = filter_learned_dicts(learned_dicts, {**setting, "l1_alpha": l1, "dict_size": small})
                if not small_matches:
                    continue
                for j, size in enumerate(dict_sizes[1:]):
                    larger = filter_learned_dicts(learned_dicts, {**setting, "l1_alpha": l1, "dict_size": size})
                    if larger:
                        scores[i, j] = float(sm.mcs_duplicates(small_matches[0][0], larger[0][0]).mean())
            results["mmcs_grids"][make_hyperparam_name(setting) or "default"] = scores

    if logger is not None:
        flat = {}
        for name, vals in results["n_active"].items():
            flat[f"{name}_n_active"] = float(vals["n_active"])
            flat[f"{name}_prop_active"] = vals["prop_active"]
        logger.log(chunk_num, flat)
        logger.flush()
    if output_folder is not None and results["mmcs_grids"]:
        np.savez(Path(output_folder) / f"mmcs_grids_{chunk_num}.npz", **results["mmcs_grids"])
    if images and logger is not None:
        # the in-training image dashboards (reference `big_sweep.py:87-157`)
        import matplotlib.pyplot as plt

        from sparse_coding__tpu_torch.plotting import plots as figs

        fig = figs.feature_activity_overlay(results["feat_counts"], n_samples=len(sample))
        logger.log_image(chunk_num, "feature_activity", fig)
        plt.close(fig)
        for grid_name, scores in results["mmcs_grids"].items():
            fig = figs.grid_heatmap(scores, x_tick_labels=dict_sizes[1:], y_tick_labels=l1_values,
                                    x_label="dict size", y_label="l1_alpha", vmin=0.0, vmax=1.0)
            logger.log_image(chunk_num, f"mmcs_grid_{grid_name}", fig)
            plt.close(fig)
    return results


def init_synthetic_dataset(cfg, device=None) -> ChunkStore:
    """Load the store in ``cfg.dataset_folder``, or materialize it from a
    `SparseMixDataset` seeded by ``cfg.seed`` on ``device`` (uncorrelated
    components unless ``cfg.correlated_components``) and keep its ground
    truth in ``<output_folder>/ground_truth_dict.npy``."""
    store = ChunkStore(cfg.dataset_folder)
    if len(store) > 0:
        print(f"Activations in {cfg.dataset_folder} already exist, loading them")
        return store
    print(f"Activations in {cfg.dataset_folder} do not exist, creating them")
    device = resolve_device(device)
    n = cfg.n_ground_truth_components
    generator = SparseMixDataset(
        cfg.activation_width, n, cfg.gen_batch_size, cfg.feature_num_nonzero, cfg.feature_prob_decay,
        cfg.noise_magnitude_scale, key=cfg.seed,
        sparse_component_covariance=None if cfg.correlated_components else torch.eye(n, device=device),
        device=device,
    )
    generate_synthetic_chunks(generator, cfg.dataset_folder, n_chunks=cfg.n_chunks,
                              chunk_size_gb=cfg.chunk_size_gb, activation_width=cfg.activation_width)
    np.save(Path(cfg.output_folder) / "ground_truth_dict.npy", generator.sparse_component_dict.cpu().numpy())
    return store


def init_model_dataset(cfg, device=None) -> ChunkStore:
    """Load the LM-activation store in ``cfg.dataset_folder``, or harvest it
    there first: `data.activations.setup_data` over ``cfg.model_name``'s
    forward on ``cfg.dataset_name`` (the local HF cache or a checkpoint
    folder, else the network), ``cfg.layer`` / ``cfg.layer_loc``,
    ``cfg.n_chunks`` chunks of ``cfg.chunk_size_gb``, with the config's
    ``center_dataset``, ``harvest_compute_dtype`` and
    ``harvest_store_dtype``, on ``device`` (None = cuda)."""
    store = ChunkStore(cfg.dataset_folder)
    if len(store) > 0:
        print(f"Activations in {cfg.dataset_folder} already exist, loading them")
        return store
    print(f"Activations in {cfg.dataset_folder} do not exist, creating them")
    setup_data(model_name=cfg.model_name, dataset_name=cfg.dataset_name, dataset_folder=cfg.dataset_folder,
               layer=cfg.layer, layer_loc=cfg.layer_loc, n_chunks=cfg.n_chunks, chunk_size_gb=cfg.chunk_size_gb,
               center_dataset=cfg.center_dataset, compute_dtype=cfg.harvest_compute_dtype,
               store_dtype=cfg.harvest_store_dtype, device=device)
    return store


def chunk_seed(seed: int, position: int, ensemble_index: int) -> int:
    """The shuffle seed of one ensemble at one position of the chunk order:
    a function of the three alone, so resume and skips cannot shift it."""
    return int(np.random.SeedSequence([int(seed), int(position), int(ensemble_index)]).generate_state(1)[0])


def sweep(ensemble_init_func: Callable, cfg, resume: Optional[bool] = None,
          device=None) -> List[Tuple[Any, Dict[str, Any]]]:
    """Run the sweep; returns the final ``(LearnedDict, hyperparams)`` list.

    ``ensemble_init_func(cfg) -> (ensembles, ensemble_hyperparams,
    buffer_hyperparams, hyperparam_ranges)``, ``ensembles`` a list of
    ``(Ensemble, args, name)`` built on ``device`` (None = cuda). Outputs in
    ``cfg.output_folder``: ``_<i>/learned_dicts.pkl`` (+ sidecar) and
    ``_<i>/config.yaml`` at each save point, ``ckpt_<i>`` (newest
    ``cfg.checkpoint_keep``, default 3), ``events.jsonl`` and the metrics
    JSONL. ``cfg.wandb_images`` renders the in-training image dashboards
    every 10 chunks (`log_sweep_metrics` with ``images=True``: needs
    matplotlib, so not on the card's machine)."""
    device = resolve_device(device)
    if getattr(cfg, "wandb_images", False):
        import matplotlib  # noqa: F401  (the dashboards need it: fail before any training)
    os.makedirs(cfg.dataset_folder, exist_ok=True)
    os.makedirs(cfg.output_folder, exist_ok=True)
    run_config = {k: v for k, v in sorted(getattr(cfg, "__dict__", {}).items())
                  if isinstance(v, (int, float, str, bool, type(None), list, tuple))}
    run_name = f"sweep_{Path(cfg.output_folder).name}"
    telemetry = RunTelemetry(out_dir=cfg.output_folder, run_name=run_name, config=run_config)
    logger: Optional[MetricLogger] = None
    ckpt: Optional[DriverCheckpointer] = None
    # one logger carries every ensemble, so the loss-spike windows would mix
    # members of different ensembles: spikes off unless the config says
    # triggered trace capture: the env-armed step window (SC_TRACE_WINDOW) or
    # the first anomaly; trace dirs land in events.jsonl and the bundles
    trigger = TraceTrigger.from_env(telemetry=telemetry, out_dir=cfg.output_folder)
    guard = AnomalyGuard(telemetry=telemetry, out_dir=cfg.output_folder,
                         policy=getattr(cfg, "anomaly_policy", None) or AnomalyPolicy(spikes=False),
                         trace_trigger=trigger)
    status = "ok"
    try:
        run_ident = producer_identity(config=run_config, fingerprint=telemetry.run_start()["fingerprint"],
                                      run_dir=cfg.output_folder)
        # pod runs: a cross-rank config/environment mismatch is a hard
        # `desync` anomaly before any training (a no-op in a world of one)
        check_desync(telemetry, config=run_config)
        rank, world = process_info()
        with span(telemetry, "data_wait", name="dataset_init"):
            if rank != 0:
                ckpt_lib._pod_barrier("dataset_init")  # rank 0 builds a missing store first
            store = (init_synthetic_dataset(cfg, device) if getattr(cfg, "use_synthetic_dataset", False)
                     else init_model_dataset(cfg, device))
            if rank == 0:
                ckpt_lib._pod_barrier("dataset_init")
        print("Initialising ensembles...", end=" ")
        ensembles, ensemble_hyperparams, buffer_hyperparams, hyperparam_ranges = ensemble_init_func(cfg)
        print("Ensembles initialised.")
        mesh = next((ens.mesh for ens, _a, _n in ensembles if ens.mesh is not None), None)
        if mesh is not None:
            # the fingerprint with the mesh (and the backend), checked across ranks
            telemetry.event("mesh", fingerprint=run_fingerprint(mesh=mesh))
            check_desync(telemetry, config=run_config, mesh=mesh)
        logger = MetricLogger(out_dir=cfg.output_folder, run_name=run_name, use_wandb=getattr(cfg, "use_wandb", False),
                              on_flush=guard.observe)

        # slots, not len: a quarantined chunk keeps its place in the order and
        # surfaces as a budgeted skip; the permutation is seeded on its own so
        # a resumed run walks the original order
        n_chunks = store.slot_count()
        reps = cfg.n_repetitions if getattr(cfg, "n_repetitions", None) else cfg.n_epochs
        chunk_order = np.tile(np.random.default_rng(cfg.seed).permutation(n_chunks), max(1, reps))

        ckpt = DriverCheckpointer(cfg.output_folder, telemetry=telemetry, keep=getattr(cfg, "checkpoint_keep", 3))
        start_chunk = 0
        if resume_requested(resume):
            # each ensemble resumes on the init function's mesh (elastic: the
            # checkpoint may have been written under another one)
            template = {"ensembles": {name: {"optimizer_kwargs": ens.optimizer_kwargs, "mesh": ens.mesh,
                                             "shard_dict": ens._shard_dict} for ens, _a, name in ensembles}}
            tree = ckpt.restore(template)
            if tree is not None:
                start_chunk = int(tree["cursor"]["chunk"]) + 1
                ensembles = [(Ensemble.from_state(tree["ensembles"][name], sig=ens.sig, device=ens.device,
                                                  mesh=ens.mesh, shard_dict=ens._shard_dict), args, name)
                             for ens, args, name in ensembles]
                print(f"Resumed {cfg.output_folder} at chunk {start_chunk}")

        means: Optional[torch.Tensor] = None
        means_path = Path(cfg.output_folder) / "means.npy"
        if getattr(cfg, "center_activations", False) and means_path.exists():
            means = torch.from_numpy(np.load(means_path)).to(device)

        learned_dicts: List[Tuple[Any, Dict[str, Any]]] = []
        cached: Dict[int, torch.Tensor] = {}

        def _build_iter(pos: int):
            """The chunk stream from position ``pos`` (rebuilt after a skip)."""
            rem = [int(c) for c in chunk_order[pos:]]
            if not getattr(cfg, "hbm_cache_chunks", False):
                return store.iter_chunks(rem, dtype=torch.float32, device=device)
            # upload each chunk once, in the store's float16, and upcast per
            # use (lossless, so training matches the streaming path bit for bit)
            stream = store.iter_chunks([i for i in dict.fromkeys(rem) if i not in cached], dtype=None, device=device)

            def cached_iter():
                for i in rem:
                    if i not in cached:
                        cached[i] = next(stream)
                    yield cached[i].float()

            return cached_iter()

        def _export(ens_list):
            return [ld for ens, args, _n in ens_list
                    for ld in unstacked_to_learned_dicts(ens, args, ensemble_hyperparams, buffer_hyperparams)]

        chunk_iter = _build_iter(start_chunk)
        budget = data_integrity.ChunkLossBudget(n_chunks, telemetry=telemetry)
        for i in range(start_chunk, len(chunk_order)):
            try:
                with span(telemetry, "data_wait", name="chunk_next", chunk=i):
                    chunk = next(chunk_iter)
            except StopIteration:
                break
            except data_integrity.CorruptChunk as e:
                with span(telemetry, "degraded_skip", name="chunk_skip", chunk=int(e.chunk)):
                    budget.skip(e.chunk, e.reason, rows=data_integrity.quarantined_rows(store.folder, e.chunk))
                chunk_iter = _build_iter(i + 1)
                continue
            except (FileNotFoundError, IsADirectoryError, NotADirectoryError, PermissionError):
                raise  # a real bug, not storage churn
            except OSError as e:
                telemetry.event("io_exhausted", chunk=int(chunk_order[i]), error=str(e)[:200])
                raise ResumableAbort(f"chunk {int(chunk_order[i])} unreadable ({e}); exiting resumable") from e
            print(f"Chunk {i+1}/{len(chunk_order)} (file {int(chunk_order[i])})")
            fault_point("chunk_loop", chunk=i)
            telemetry.chunk_start(i, file=int(chunk_order[i]))
            if getattr(cfg, "center_activations", False):
                if means is None:
                    print("Centring activations")
                    means = chunk.mean(dim=0)
                    if rank == 0:
                        np.save(means_path, means.cpu().numpy())
                chunk = chunk - means[None, :]

            with span(telemetry, "step", name="chunk_train", chunk=i):
                for e, (ensemble, args, _name) in enumerate(ensembles):
                    ensemble_train_loop(ensemble, chunk, batch_size=args.get("batch_size", cfg.batch_size),
                                        key=chunk_seed(cfg.seed, i, e), logger=logger, telemetry=telemetry)

            def _save_ckpt(path, _i=i):
                ckpt_lib.save_ensemble_checkpoint(path, ensembles, chunk_cursor=_i, provenance=run_ident)

            want_metrics = getattr(cfg, "wandb_images", False) and i % 10 == 0
            want_save = i == len(chunk_order) - 1 or (i + 1) in SAVE_CHUNKS
            if want_metrics or want_save:
                learned_dicts = _export(ensembles)  # gathered whole on every rank
            if want_metrics and rank == 0:
                log_sweep_metrics(learned_dicts, chunk, i, hyperparam_ranges, logger, cfg.output_folder, images=True)
            if want_save:
                iter_folder = Path(cfg.output_folder) / f"_{i}"
                if rank == 0:  # one export, from the gathered state
                    iter_folder.mkdir(parents=True, exist_ok=True)
                    with span(telemetry, "checkpoint", name="export", chunk=i):
                        export_path = iter_folder / "learned_dicts.pkl"
                        ckpt_lib.save_learned_dicts(export_path, learned_dicts, provenance=run_ident)
                        telemetry.event("provenance", artifact="export", path=str(export_path),
                                        digest=export_digest(export_path), config_sha=run_ident.get("config_sha"),
                                        inputs=[{"kind": "store", "path": str(cfg.dataset_folder)}])
                    if hasattr(cfg, "save_yaml"):
                        cfg.save_yaml(iter_folder / "config.yaml")
                ckpt.save(i, _save_ckpt, reason="schedule")
            end_rec = telemetry.chunk_end(i, saved=bool(want_save))
            # boundary perf attribution: device-memory gauges (a host query, no
            # device sync) and the trace window's arming on train steps
            record_hbm_watermarks(telemetry, [device])
            cum_steps = int(telemetry.counters.get("train.steps", 0))
            trigger.on_step(cum_steps)
            # pod heartbeat + straggler-skew gauges (a no-op in a world of one)
            heartbeat(telemetry, step=cum_steps, window_seconds=end_rec.get("seconds"))
            ckpt.boundary(i, _save_ckpt, already_saved=want_save)

        if not learned_dicts:  # resumed past the last chunk: export the restored state
            learned_dicts = _export(ensembles)
    except ResumableAbort as e:
        status = f"resumable-abort: {e}"
        raise
    except Preempted:
        status = "preempted"
        raise
    except BaseException as e:
        status = f"error: {type(e).__name__}: {e}"
        raise
    finally:
        close_exc = None
        try:
            if logger is not None:
                logger.close()
        except BaseException as e:
            close_exc = e
            if status == "ok":
                status = f"error: {type(e).__name__}: {e}"
        trigger.close(int(telemetry.counters.get("train.steps", 0)))  # before run_end
        if ckpt is not None:
            ckpt.close()
        telemetry.run_end(status=status, masked_models=sorted(guard.masked))
        telemetry.close()
        if close_exc is not None and sys.exc_info()[0] is None:
            raise close_exc
    return learned_dicts
