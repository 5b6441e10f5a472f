"""Single-host FISTA l1-sweep driver.

Counterpart of `sparse_coding__tpu/train/basic_l1_sweep.py`: a
`FunctionalFista` ensemble over an l1 grid, trained on the chunks of a
store (each gradient step followed by the FISTA decoder update: K_f on the
card), saving ``(LearnedDict, hyperparams)`` per epoch or per chunk. The
health pack and the feature sketch are on by default (they turn the fused
kernels off, as in the JAX package), the anomaly guard reads every metric
flush, and the sketch is flushed to a ``feature_stats.trainNNNN.npz``
snapshot at every chunk boundary.

Everything runs on ``device`` (None = cuda). The chunk order is the JAX
driver's (``np.random.default_rng(seed)``, reshuffled each epoch). The
in-chunk shuffle draws a `torch.Generator` seed per trained chunk from
``SeedSequence([seed + 1, n])``, ``n`` the number of chunks trained before
it, so it differs from JAX's PRNG stream, and a skipped chunk consumes no
seed (as a skipped chunk splits no JAX key). A checkpoint's cursor holds the
epoch, the position and ``n``: a resumed run replays the rest bit for bit.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sparse_coding__tpu_torch.data import integrity as data_integrity
from sparse_coding__tpu_torch.data.chunks import ChunkStore
from sparse_coding__tpu_torch.ensemble import Ensemble, build_ensemble
from sparse_coding__tpu_torch.models.fista import FunctionalFista
from sparse_coding__tpu_torch.telemetry.anomaly import AnomalyGuard, AnomalyPolicy
from sparse_coding__tpu_torch.telemetry.events import RunTelemetry
from sparse_coding__tpu_torch.telemetry.feature_stats import flush_ensemble_feature_stats
from sparse_coding__tpu_torch.telemetry.multihost import check_desync, heartbeat
from sparse_coding__tpu_torch.telemetry.profiling import TraceTrigger, record_hbm_watermarks
from sparse_coding__tpu_torch.telemetry.provenance import export_digest, producer_identity
from sparse_coding__tpu_torch.telemetry.spans import span
from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib
from sparse_coding__tpu_torch.train.loop import DriverCheckpointer, ensemble_train_loop
from sparse_coding__tpu_torch.train.preemption import Preempted, ResumableAbort, resume_requested
from sparse_coding__tpu_torch.utils.device import resolve_device
from sparse_coding__tpu_torch.utils.faults import fault_point
from sparse_coding__tpu_torch.utils.logging import MetricLogger
from sparse_coding__tpu_torch.utils.trace import StepTimer


def chunk_key(seed: int, n_trained: int) -> int:
    """The in-chunk shuffle seed of the ``n_trained``-th trained chunk."""
    return int(np.random.SeedSequence([int(seed) + 1, int(n_trained)]).generate_state(1)[0])


def basic_l1_sweep(
    dataset_folder: str,
    output_folder: str,
    activation_width: int,
    l1_values: Optional[Sequence[float]] = None,
    dict_ratio: float = 4.0,
    batch_size: int = 1024,
    n_epochs: int = 1,
    lr: float = 1e-3,
    fista_iters: int = 500,
    fista_tol: float = 0.0,
    seed: int = 0,
    shuffle_chunks: bool = True,
    save_after_every: bool = False,
    hbm_cache: bool = False,
    health: bool = True,
    feature_stats: bool = True,
    anomaly_policy: Optional[AnomalyPolicy] = None,
    resume: Optional[bool] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_keep: int = 3,
    device=None,
) -> List[Tuple[object, dict]]:
    """Train a FISTA ensemble over ``l1_values`` (default
    ``np.logspace(-4, -2, 8)``) on every chunk of ``dataset_folder`` for
    ``n_epochs``; returns the final ``(LearnedDict, hyperparams)`` list.

    Exports go to ``<output_folder>/epoch_{e}/learned_dicts.pkl``, or with
    ``save_after_every`` to ``epoch_{e}/chunk_{pos}/learned_dicts.pkl``
    (named by the position in the epoch's order, not by the store index).
    ``hbm_cache`` keeps each chunk on the device in its stored float16 after
    its first load and upcasts it per use (the same values as a fresh load).
    ``fista_tol > 0`` lets each decoder update's solve stop early.

    Run artifacts: ``events.jsonl`` (``data_wait`` / ``step`` /
    ``checkpoint`` / ``feature_flush`` spans, ``provenance`` events at every
    export and checkpoint, ``run_end`` with the `StepTimer` report), the
    metrics JSONL (losses and, with ``health``, the ``health_*`` metrics),
    with ``feature_stats`` a ``feature_stats.trainNNNN.npz`` snapshot at
    every chunk boundary plus a tail flush, and the guard's bundles under
    ``diagnostics/`` (``anomaly_policy``, default: warn + bundle).

    Recovery, as in the JAX driver: SIGTERM/SIGINT → a checkpoint at the
    next chunk boundary → exit 75; ``resume=True`` (or ``SC_RESUME``)
    restores the newest intact checkpoint and replays the rest bit for bit;
    ``checkpoint_every=N`` also checkpoints every N chunks (the newest
    ``checkpoint_keep`` kept); a corrupt chunk is quarantined and skipped
    within ``SC_CHUNK_LOSS_BUDGET``, past it (or on a read that keeps
    failing) exit 75 (`ResumableAbort`)."""
    device = resolve_device(device)
    if l1_values is None:
        l1_values = list(np.logspace(-4, -2, 8))
    store = ChunkStore(dataset_folder)
    # slots, not len: a quarantined chunk keeps its place in the epoch order
    # and surfaces as a budgeted skip
    n_chunk_slots = store.slot_count()
    assert n_chunk_slots > 0, f"no chunks in {dataset_folder}"
    out = Path(output_folder)
    out.mkdir(parents=True, exist_ok=True)

    dict_size = int(activation_width * dict_ratio)
    ens = build_ensemble(
        FunctionalFista, seed, [{"l1_alpha": float(a)} for a in l1_values], optimizer_kwargs={"learning_rate": lr},
        activation_size=activation_width, n_dict_components=dict_size, health=health, feature_stats=feature_stats,
        device=device,
    )
    model_names = [f"l1_{float(a):.2e}" for a in l1_values]
    run_config = dict(
        dataset_folder=str(dataset_folder), activation_width=activation_width,
        l1_values=[float(a) for a in l1_values], dict_ratio=dict_ratio, dict_size=dict_size, batch_size=batch_size,
        n_epochs=n_epochs, lr=lr, fista_iters=fista_iters, fista_tol=fista_tol, seed=seed,
    )
    telemetry = RunTelemetry(out_dir=output_folder, run_name="basic_l1_sweep", config=run_config)
    run_ident = producer_identity(config=run_config, fingerprint=telemetry.run_start()["fingerprint"],
                                  run_dir=output_folder)

    def _emit_export_provenance(path):
        latest = ckpt_lib.latest_checkpoint(output_folder)
        inputs = [{"kind": "store", "path": str(dataset_folder)}]
        if latest is not None:
            inputs.append({"kind": "checkpoint", "path": str(latest), "digest": ckpt_lib.checkpoint_digest(latest)})
        telemetry.event("provenance", artifact="export", path=str(path), digest=export_digest(path),
                        config_sha=run_ident.get("config_sha"), inputs=inputs)

    # pod runs: ranks disagreeing on config/environment is a hard anomaly,
    # caught before any training (a no-op in a world of one)
    check_desync(telemetry, config=run_config)
    ckpt = DriverCheckpointer(output_folder, telemetry=telemetry, keep=checkpoint_keep, every=checkpoint_every)
    budget = data_integrity.ChunkLossBudget(n_chunk_slots, telemetry=telemetry)
    # (epoch, position) of the last completed chunk before this process
    # started, (-1, -1) on a fresh run; ``n_trained`` counts the chunks
    # trained so far (the in-chunk shuffle seeds' counter)
    start_epoch, start_pos, n_trained = -1, -1, 0
    if resume_requested(resume):
        tree = ckpt.restore({"ensembles": {"ensemble": {"optimizer_kwargs": ens.optimizer_kwargs}}})
        if tree is not None:
            ens = Ensemble.from_state(tree["ensembles"]["ensemble"], sig=ens.sig, device=device)
            start_epoch = int(tree["cursor"]["epoch"])
            start_pos = int(tree["cursor"]["position"])
            n_trained = int(tree["cursor"]["n_trained"])
            print(f"Resumed {output_folder} at epoch {start_epoch} chunk position {start_pos}")
    # triggered trace capture: SC_TRACE_WINDOW="N:M" (steps) arms a profiler
    # window; the guard's first anomaly arms one itself
    trigger = TraceTrigger.from_env(telemetry=telemetry, out_dir=output_folder)
    guard = AnomalyGuard(telemetry=telemetry, out_dir=output_folder, policy=anomaly_policy, ensemble=ens,
                         model_names=model_names, trace_trigger=trigger)
    logger = MetricLogger(out_dir=output_folder, run_name="basic_l1_sweep", model_names=model_names,
                          on_flush=guard.observe)
    timer = StepTimer()
    order_rng = np.random.default_rng(seed)
    learned_dicts: List[Tuple[object, dict]] = []
    cache: dict = {}

    def export():
        return [(ld, {"l1_alpha": float(a), "dict_size": dict_size}) for ld, a in zip(ens.to_learned_dicts(), l1_values)]

    def save_export(path):
        with span(telemetry, "checkpoint", name="export"):
            ckpt_lib.save_learned_dicts(path, learned_dicts, provenance=run_ident)
            _emit_export_provenance(path)

    status = "ok"
    loss_fence = None
    try:
        for epoch in range(n_epochs):
            chunk_order = order_rng.permutation(n_chunk_slots) if shuffle_chunks else range(n_chunk_slots)
            for pos, chunk_idx in enumerate(chunk_order):
                chunk_idx = int(chunk_idx)
                if epoch < start_epoch or (epoch == start_epoch and pos <= start_pos):
                    continue  # completed before the resume
                fault_point("chunk_loop", chunk=pos, epoch=epoch)
                try:
                    with span(telemetry, "data_wait", name="chunk_load", chunk=chunk_idx):
                        if hbm_cache:
                            if chunk_idx not in cache:
                                cache[chunk_idx] = store.load(chunk_idx, dtype=None, device=device)
                            chunk = cache[chunk_idx].float()
                        else:
                            chunk = store.load(chunk_idx, device=device)
                except data_integrity.CorruptChunk as e:
                    with span(telemetry, "degraded_skip", name="chunk_skip", chunk=chunk_idx):
                        budget.skip(e.chunk, e.reason, rows=data_integrity.quarantined_rows(store.folder, e.chunk))
                    continue
                except (FileNotFoundError, IsADirectoryError, NotADirectoryError, PermissionError):
                    raise  # a real bug, not storage churn
                except OSError as e:
                    telemetry.event("io_exhausted", chunk=chunk_idx, epoch=epoch, position=pos, error=str(e)[:200])
                    raise ResumableAbort(f"chunk {chunk_idx} unreadable ({e}); exiting resumable") from e
                key = chunk_key(seed, n_trained)
                n_trained += 1
                telemetry.chunk_start(chunk_idx, epoch=epoch, position=pos)
                with span(telemetry, "step", name="chunk_train", chunk=chunk_idx, epoch=epoch):
                    loss_fence = ensemble_train_loop(ens, chunk, batch_size=batch_size, key=key, logger=logger,
                                                     fista_iters=fista_iters, fista_tol=fista_tol,
                                                     telemetry=telemetry)
                timer.tick()  # one tick a chunk pass; fenced at run_end
                end_rec = telemetry.chunk_end(chunk_idx, epoch=epoch, position=pos,
                                              steps=chunk.shape[0] // batch_size)
                record_hbm_watermarks(telemetry, [device])
                if feature_stats:
                    flush_ensemble_feature_stats(ens, telemetry, output_folder, model_names=model_names)
                cum_steps = int(telemetry.counters.get("train.steps", 0))
                trigger.on_step(cum_steps)
                # pod heartbeat + straggler-skew gauges (a no-op in a world of one)
                heartbeat(telemetry, step=cum_steps, window_seconds=end_rec.get("seconds"))
                if save_after_every:
                    learned_dicts = export()
                    save_export(out / f"epoch_{epoch}" / f"chunk_{pos}" / "learned_dicts.pkl")

                def _save_ckpt(path, _epoch=epoch, _pos=pos, _n=n_trained):
                    ckpt_lib.save_ensemble_checkpoint(
                        path, [(ens, {}, "ensemble")], chunk_cursor=_epoch * n_chunk_slots + _pos,
                        extra={"epoch": _epoch, "position": _pos, "n_trained": _n}, provenance=run_ident,
                    )
                    telemetry.event("provenance", artifact="checkpoint", path=str(path),
                                    digest=ckpt_lib.checkpoint_digest(path), config_sha=run_ident.get("config_sha"),
                                    inputs=[{"kind": "store", "path": str(dataset_folder)}])

                ckpt.boundary(epoch * n_chunk_slots + pos, _save_ckpt)
            # an epoch completed before the resume already has its export
            if not save_after_every and epoch >= start_epoch:
                learned_dicts = export()
                save_export(out / f"epoch_{epoch}" / "learned_dicts.pkl")
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
        # the logger's tail flush can trip the guard (an abort): run_end and
        # close still run, and an exception already unwinding is kept
        close_exc = None
        try:
            logger.close()
        except BaseException as e:
            close_exc = e
            if status == "ok":
                status = f"error: {type(e).__name__}: {e}"
        trigger.close()  # stop any in-flight trace window before run_end
        ckpt.close()
        if feature_stats:
            try:  # the tail window: rows since the last chunk boundary
                flush_ensemble_feature_stats(ens, telemetry, output_folder, model_names=model_names)
            except Exception:
                pass  # a failed tail flush must not mask the unwinding error
        telemetry.run_end(status=status,
                          timer_stats=timer.report(fence=None if loss_fence is None else loss_fence.get("loss")),
                          masked_models=sorted(guard.masked))
        telemetry.close()
        if close_exc is not None and sys.exc_info()[0] is None:
            raise close_exc
    return learned_dicts
