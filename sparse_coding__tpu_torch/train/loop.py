"""Per-chunk ensemble training loop, the FISTA decoder update, and the
drivers' checkpoint/preemption glue.

Counterpart of `sparse_coding__tpu/train/loop.py::ensemble_train_loop`,
`make_fista_decoder_update` and `DriverCheckpointer`. The loop draws a
permutation from a `torch.Generator` on the dataset's device, then takes the
JAX loop's routes: the whole-chunk path (ONE bulk gather of the permuted
rows, then `Ensemble.step_scan` over every batch), or groups of
``scan_steps`` batches through `Ensemble.step_scan_idx`, each batch gathered
from the dataset into the step's input (no staged copy). On the card both
replay the step's CUDA graph. A signature with ``has_fista_decoder_update``
takes one batch at a time instead: the eager gradient step
(`Ensemble.step_batch`), then the FISTA decoder update warm-started from
that step's code (K_f on the card). Losses go to a
`utils.logging.MetricLogger` without a sync per step, and step counts to a
`telemetry.events.RunTelemetry` as host-side counters.
"""

from __future__ import annotations

import warnings
from functools import lru_cache
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from sparse_coding__tpu_torch.ensemble import Ensemble, EnsembleState
from sparse_coding__tpu_torch.models.fista import dictionary_update
from sparse_coding__tpu_torch.models.learned_dict import _norm_rows
from sparse_coding__tpu_torch.ops.fista_kernel import fista_solve
from sparse_coding__tpu_torch.telemetry.audit import allowed_transfer
from sparse_coding__tpu_torch.telemetry.spans import span
from sparse_coding__tpu_torch.train import checkpoint as ckpt_lib
from sparse_coding__tpu_torch.train import preemption
from sparse_coding__tpu_torch.utils.logging import MetricLogger


class DriverCheckpointer:
    """The drivers' checkpoint, resume and preemption glue (the JAX
    package's, single-host).

    Installing the signal handlers on construction, it turns SIGTERM/SIGINT
    into a flag; `boundary(cursor, save_fn)` at each chunk boundary then
    commits a checkpoint through ``save_fn(path)`` (the atomic protocol of
    `train.checkpoint`), writes a ``preempt`` event and raises
    `preemption.Preempted` (exit 75); otherwise, with ``every=N``, it
    checkpoints every N-th boundary (a ``periodic`` save). Every save is
    followed by retention GC (newest ``keep``). In a world of several ranks
    the decision is the pod's (`preemption.pod_agree_preempt`: any rank
    flagged preempts all), and ``sync_every`` bounds how often that exchange
    runs for drivers whose boundaries are per step (`train_big_batch`): only
    every N-th boundary, counted alike on every rank; in a world of one
    every boundary reads the local flag. `close()` stops polling and, once
    no checkpointer polls, puts back the signal handlers that were
    replaced."""

    def __init__(self, output_folder, telemetry=None, keep: int = 3, every: Optional[int] = None,
                 sync_every: int = 1):
        self.out = Path(output_folder)
        self.telemetry = telemetry
        self.keep = keep
        self.every = every
        self._sync_every = max(1, int(sync_every))
        self._n_boundaries = 0
        self._closed = False
        self.handlers_active = preemption.install_signal_handlers()
        preemption.poller_started()

    def close(self) -> None:
        """Idempotent; drivers call it in their ``finally``."""
        if not self._closed:
            self._closed = True
            preemption.poller_stopped()

    def restore(self, template=None) -> Optional[Dict]:
        """The newest committed, intact checkpoint tree (torn or corrupt
        dirs skipped), or None. Writes a ``resume`` event."""
        latest = ckpt_lib.latest_checkpoint(self.out)
        if latest is None:
            return None
        with span(self.telemetry, "checkpoint", name="restore"):
            tree = ckpt_lib.restore_ensemble_checkpoint(latest, template=template)
        if self.telemetry is not None:
            cursor = {k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in (tree.get("cursor") or {}).items()}
            self.telemetry.event("resume", checkpoint=str(latest), cursor=cursor)
            self.telemetry.counter_inc("resumes")
        return tree

    def save(self, cursor_id: int, save_fn: Callable[[Path], None], reason: str = "periodic") -> Path:
        path = self.out / f"ckpt_{int(cursor_id)}"
        category = "preempt_drain" if reason == "preempt" else "checkpoint"
        with span(self.telemetry, category, name=f"save:{reason}", cursor=int(cursor_id)):
            save_fn(path)
            from sparse_coding__tpu_torch.telemetry.multihost import process_info

            if process_info()[0] == 0:  # in a pod, rank 0 alone sweeps (the save ended on a barrier)
                ckpt_lib.gc_checkpoints(self.out, keep=self.keep)
        if self.telemetry is not None:
            self.telemetry.event("checkpoint", path=str(path), cursor=int(cursor_id), reason=reason)
            self.telemetry.counter_inc("checkpoints")
        return path

    def boundary(self, cursor_id: int, save_fn: Callable[[Path], None], already_saved: bool = False) -> None:
        """Raises `Preempted` after the preemption checkpoint commits;
        otherwise saves on the ``every`` cadence. ``already_saved``: the
        driver just checkpointed this cursor on its own schedule, and the
        preemption path reuses it (and the cadence skips it)."""
        from sparse_coding__tpu_torch.telemetry.multihost import process_info

        self._n_boundaries += 1
        _, count = process_info()
        if count > 1 and self._n_boundaries % self._sync_every != 0:
            preempt = False
        else:
            preempt = preemption.pod_agree_preempt(self.telemetry)
        if preempt:
            path = (self.out / f"ckpt_{int(cursor_id)}" if already_saved
                    else self.save(cursor_id, save_fn, reason="preempt"))
            if self.telemetry is not None:
                self.telemetry.event("preempt", signum=preemption.preemption_signal(), checkpoint=str(path),
                                     cursor=int(cursor_id))
            raise preemption.Preempted(f"preempted: checkpoint committed at {path}; exiting resumable")
        if self.every and not already_saved and self._n_boundaries % self.every == 0:
            self.save(cursor_id, save_fn, reason="periodic")


def warn_if_ensemble_dead(ensemble: Ensemble, batch: torch.Tensor, context: str = "") -> bool:
    """Warn when every member's code (the ``c`` of the signature's loss aux,
    as the JAX package probes it; a signature without one counts as alive)
    is identically zero on a probe batch (the Adam-lr x l1 collapse of large
    dictionaries). One host sync."""
    st = ensemble.state
    with torch.no_grad():
        c = ensemble._loss(st.params, st.buffers, batch)[1][1].get("c")
        with allowed_transfer():  # the once-a-chunk probe: a sanctioned sync (telemetry.audit)
            dead = c is not None and not bool((c != 0).any())
    if dead:
        warnings.warn(
            f"DEAD ENSEMBLE{' (' + context + ')' if context else ''}: every member "
            f"of the {ensemble.n_models}-member {ensemble.sig.__name__} ensemble "
            "produced all-zero codes on a probe batch; lower the lr or warm up l1.",
            RuntimeWarning,
            stacklevel=2,
        )
    return dead


@lru_cache(maxsize=None)
def make_fista_decoder_update(num_iter: int = 500, tol: float = 0.0) -> Callable:
    """``update(state, batch, c) -> state``: every member's decoder replaced
    by one FISTA solve + quadratic basis update, warm-started from ``c``
    [M, B, N] (the gradient step's code), in the JAX package's order — the
    rows normalised, the solve (`ops.fista_kernel.fista_solve`: K_f on the
    card, its plain loop on the CPU), the Hessian EMA, the basis update.
    ``tol > 0`` lets each member stop early. A member that the state's
    ``update_mask`` freezes keeps its decoder and Hessian diagonal
    (`torch.where`, so its NaNs stay out). Cached by its arguments.

    On a mesh (``mesh``, the sharded ensemble's: ``batch`` and ``c`` are
    this rank's rows, the state its slice) each rank solves its own rows
    (K_f on the card), the update's two batch reductions are summed over
    the data group, and a dictionary cut on the dict axis
    (``dict_cut``) is gathered whole for the solve, each rank keeping its
    rows of the result (``c`` is then the whole dictionary's code, as the
    gathering loss gives it)."""

    def solve(batch, learned_dict, l1_alpha, c):
        return fista_solve(batch, learned_dict, l1_alpha, c, num_iter, tol=tol)

    @torch.no_grad()
    def update(state: EnsembleState, batch: torch.Tensor, c: torch.Tensor, mesh=None,
               dict_cut: bool = False) -> EnsembleState:
        decoder, hessian = state.params["decoder"], state.buffers["hessian_diag"]
        kw = {}
        whole_decoder, whole_hessian = decoder, hessian
        if mesh is not None:
            from sparse_coding__tpu_torch.parallel.mesh import DATA_AXIS, DICT_AXIS

            kw = dict(row_sum=lambda t: mesh.all_reduce(t, DATA_AXIS), n_rows=batch.shape[0] * mesh.shape[DATA_AXIS])
            if dict_cut:
                whole_decoder = mesh.all_gather(decoder, DICT_AXIS, dim=1)
                whole_hessian = mesh.all_gather(hessian, DICT_AXIS, dim=1)
        new_dict, new_hessian, _ = dictionary_update(
            _norm_rows(whole_decoder), whole_hessian, batch, c, state.buffers["l1_alpha"], num_iter, solver=solve,
            **kw,
        )
        if mesh is not None and dict_cut:
            n = decoder.shape[1]
            rows = slice(mesh.coords[DICT_AXIS] * n, (mesh.coords[DICT_AXIS] + 1) * n)
            new_dict, new_hessian = new_dict[:, rows].contiguous(), new_hessian[:, rows].contiguous()
        mask = state.buffers.get("update_mask")
        if mask is not None:
            keep = mask > 0
            new_dict = torch.where(keep.view(-1, 1, 1), new_dict, decoder)
            new_hessian = torch.where(keep.view(-1, 1), new_hessian, hessian)
        return EnsembleState(
            params={**state.params, "decoder": new_dict},
            buffers={**state.buffers, "hessian_diag": new_hessian},
            opt_state=state.opt_state,
            step=state.step,
        )

    return update


class _StepTiming:
    """CUDA events around the whole-chunk dispatch of graph replays: after
    the logger's flush (which waits for the card) their interval, over the
    steps, is the ``perf.ensemble.step_scan.step_ms`` gauge the report's
    roofline reads. Nothing is read before the flush, and a pass that
    captured a graph (its eager step and capture leave the card idle) sets
    no gauge."""

    GAUGE = "perf.ensemble.step_scan.step_ms"

    def __init__(self, ensemble, dataset, telemetry, logger):
        self.on = telemetry is not None and logger is not None and dataset.is_cuda and ensemble.mesh is None
        self.telemetry, self.ensemble = telemetry, ensemble
        if self.on:
            self.captures = ensemble.captures
            self.start, self.end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            self.start.record()

    def stop(self):
        if self.on:
            self.end.record()

    def report(self, n_steps: int):
        if self.on and self.ensemble.captures == self.captures and self.end.query():
            self.telemetry.gauge_set(self.GAUGE, self.start.elapsed_time(self.end) / n_steps)


def ensemble_train_loop(
    ensemble: Ensemble,
    dataset: torch.Tensor,
    batch_size: int,
    key: int,
    progress_callback: Optional[Callable[[int, int], None]] = None,
    scan_steps: int = 8,
    dead_check: bool = True,
    bulk_shuffle_max_bytes: int = 2 << 30,
    fista_iters: int = 500,
    fista_tol: float = 0.0,
    logger: Optional[MetricLogger] = None,
    log_every: int = 16,
    telemetry=None,
) -> Dict[str, torch.Tensor]:
    """Train the ensemble for one pass over ``dataset`` [N, d] (on the
    ensemble's device). ``key`` seeds the permutation's `torch.Generator` on
    that device. Returns the last step's loss dict (on the device).

    Datasets whose shuffled copy fits ``bulk_shuffle_max_bytes`` take the
    whole-chunk path (`Ensemble.step_scan` over every batch) unless a
    ``progress_callback`` is given or ``scan_steps <= 1``; otherwise
    `Ensemble.step_scan_idx` takes ``scan_steps`` batches at a time (the
    remainder one at a time), gathering each from ``dataset``.

    A signature with ``has_fista_decoder_update`` takes ``scan_steps`` 1,
    and each `Ensemble.step_batch` is followed by
    `make_fista_decoder_update` (``fista_iters``, ``fista_tol``) on the same
    batch and the step's code.

    A sharded ensemble (`Ensemble.shard`): every rank draws the same
    permutation from the same generator and hands `Ensemble.step_scan` the
    global batches, of which each rank steps its part; the zero-copy
    `Ensemble.step_scan_idx` route is for unsharded ensembles only.

    ``logger`` gets each step's losses (left on the device) and is flushed,
    one host copy, every ``log_every`` steps and at the end (the whole-chunk
    path: once, at the end). ``telemetry`` gets the route as gauges
    (``train.fused``, ``train.fused_adam``) and the ``train.steps`` and
    ``train.dispatches`` counters, host-side."""
    if telemetry is not None:
        telemetry.gauge_set("train.fused", float(bool(ensemble.fused)))
        telemetry.gauge_set("train.fused_adam", float(ensemble.fused_adam is not None))
    fista_fn = None
    if getattr(ensemble.sig, "has_fista_decoder_update", False):
        fista_fn = make_fista_decoder_update(fista_iters, tol=fista_tol)
        scan_steps = 1
    n = dataset.shape[0]
    n_batches = n // batch_size
    gen = torch.Generator(device=dataset.device).manual_seed(int(key))
    perm = torch.randperm(n, generator=gen, device=dataset.device)
    loss_dict: Dict[str, torch.Tensor] = {}
    if n_batches == 0:
        return loss_dict
    whole_chunk = (
        scan_steps > 1
        and progress_callback is None
        and dataset.element_size() * dataset.numel() <= bulk_shuffle_max_bytes
    )
    if whole_chunk:
        shuffled = dataset[perm[: n_batches * batch_size]].reshape(n_batches, batch_size, -1)
        timing = _StepTiming(ensemble, dataset, telemetry, logger)
        losses = ensemble.step_scan(shuffled)
        timing.stop()
        del shuffled
        loss_dict = {k: v[-1] for k, v in losses.items()}
        if telemetry is not None:
            telemetry.counter_inc("train.steps", n_batches)
            telemetry.counter_inc("train.dispatches")
        if logger is not None:
            for j in range(n_batches):
                logger.log(j, {name: v[j] for name, v in losses.items()})
            logger.flush()
        timing.report(n_batches)
    else:
        i = 0
        while i < n_batches:
            k = scan_steps if n_batches - i >= scan_steps else 1
            idxs = perm[i * batch_size : (i + k) * batch_size].reshape(k, batch_size)
            if fista_fn is not None:
                batch = dataset[idxs[0]]
                loss_dict, aux = ensemble.step_batch(batch)
                if ensemble.mesh is None:
                    ensemble.state = fista_fn(ensemble.state, batch, aux["c"])
                else:
                    ensemble.state = fista_fn(ensemble.state, ensemble.local_batch(batch), aux["c"],
                                              mesh=ensemble.mesh, dict_cut=ensemble._dict_parallel())
                losses = {name: v[None] for name, v in loss_dict.items()}
            elif ensemble.mesh is not None:
                losses = ensemble.step_scan(dataset[idxs.reshape(-1)].reshape(k, batch_size, -1))
                loss_dict = {name: v[-1] for name, v in losses.items()}
            else:
                losses = ensemble.step_scan_idx(dataset, idxs)
                loss_dict = {name: v[-1] for name, v in losses.items()}
            if logger is not None:
                for j in range(k):
                    logger.log(i + j, {name: v[j] for name, v in losses.items()})
            i += k
            if telemetry is not None:
                telemetry.counter_inc("train.steps", k)
                telemetry.counter_inc("train.dispatches")
            if logger is not None and (i // log_every) != ((i - k) // log_every):
                logger.flush()
            if progress_callback is not None:
                progress_callback(i - 1, n_batches)
        if logger is not None:
            logger.flush()
    if dead_check:
        warn_if_ensemble_dead(ensemble, dataset[perm[:64]], context="after chunk pass")
    return loss_dict
