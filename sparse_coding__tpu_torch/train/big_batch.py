"""Big-batch SAE trainer with dead-feature resurrection, on one card.

Counterpart of `sparse_coding__tpu/train/big_batch.py`: one SAE trained
with very large batches, periodically re-initializing dead dictionary
features from the worst-reconstructed examples, their Adam moments zeroed
(the reference's `huge_batch_size.py:224-254`). The state is JAX's
`BigBatchState` with the same leaves and shapes: one member's params and
buffers (no member axis), optax's Adam state (``count`` a 0-d int32), the
per-feature activity totals and the step. The port's signatures take
stacked params, so the step hands them a member axis of one (views) and the
port's Adam (`utils.optim.adam`, optax's update order) runs on those views.

The step is the autograd of ``sig.loss`` (never the fused kernels, as in
JAX), under the precision policy of ``compute_dtype``, run eagerly: at the
resurrection study's shape the card is busy for the whole step, and a
captured CUDA graph of it measured no faster on the card (PERF.md). The
step and `resurrect_dead_features` write the new state into the state's own
tensors (JAX donates the old state). The per-example MSE still crosses to
the host every step (JAX's semantics): it is read one step late, while the
next step runs, and the worst-example ring takes the updates in step order
before any resurrection reads it.

Randomness: one CPU `torch.Generator` (``key``, an int seed or a generator)
draws the init and then each step's batch indices (`batch_indices`), so a
run on the card and one on the CPU sample the same rows, and a checkpoint's
cursor (the generator's state) replays the rest of the run. These are the
port's own draws, not JAX's PRNG stream.

Data parallelism (``mesh=``, a `parallel.Mesh`): every rank draws the same
batch indices, takes its rows on the data axis, and computes the gradient
of the mesh's loss (`sig.bind_mesh`: the tied SAE's one-contraction DP
backward); the gradients, losses and code-activity counts are summed over
the data group in ONE all-reduce (the gradients and losses then divided by
its size), and every rank applies the same Adam update, so the state stays
replicated. The per-example MSE of every row is gathered over the data
group for the worst-example ring. Ranks on the other axes compute the same
step. A pod heartbeat rides each resurrection boundary and the end of the
run, and the preemption agreement runs every ``preempt_sync_every`` step
boundaries.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from sparse_coding__tpu_torch.ensemble import _copy_into, _map_tensors, _tensors, l1_warmup_buffers
from sparse_coding__tpu_torch.telemetry.profiling import TraceTrigger, record_hbm_watermarks
from sparse_coding__tpu_torch.telemetry.spans import span
from sparse_coding__tpu_torch.utils import precision as px
from sparse_coding__tpu_torch.utils.device import resolve_device
from sparse_coding__tpu_torch.utils.faults import fault_point
from sparse_coding__tpu_torch.utils.optim import adam, apply_updates
from sparse_coding__tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

Pytree = Any


@dataclasses.dataclass
class BigBatchState:
    params: Pytree
    buffers: Pytree
    opt_state: Pytree
    c_totals: torch.Tensor  # per-feature activation counts since the last resurrection [n_feats] f32
    step: torch.Tensor  # [] int32, on the device


class WorstExamples:
    """Track the k worst-reconstructed example indices (host-side ring of the
    reference's `worst_indices` heap, `huge_batch_size.py:208-210`)."""

    def __init__(self, k: int = 1024):
        self.k = k
        self.losses = np.full((k,), -np.inf)
        self.indices = np.zeros((k,), dtype=np.int64)

    def update(self, indices: np.ndarray, losses: np.ndarray):
        all_l = np.concatenate([self.losses, losses])
        all_i = np.concatenate([self.indices, indices])
        order = np.argsort(-all_l)[: self.k]
        self.losses, self.indices = all_l[order], all_i[order]

    def get_worst(self, n: int) -> np.ndarray:
        return self.indices[: min(n, self.k)]


def _stack1(tree):
    """A member axis of one on every tensor of ``tree`` (views)."""
    return tree_map(lambda v: v[None] if isinstance(v, torch.Tensor) else v, tree)


def _unstack1(tree):
    return tree_map(lambda v: v[0] if isinstance(v, torch.Tensor) else v, tree)


def init_opt_state(tx, params):
    """``tx.init`` of one member's params, without a member axis (optax's
    ``count`` is then 0-d, as in JAX)."""
    return _unstack1(tx.init(_stack1(params)))


def batch_indices(generator: torch.Generator, batch_size: int, n: int) -> np.ndarray:
    """One step's batch: ``batch_size`` row indices drawn uniformly from
    ``[0, n)`` by ``generator`` (on the CPU)."""
    return torch.randint(0, n, (batch_size,), generator=generator).numpy()


def _data_sum(mesh, grads, loss_dict, counts):
    """The gradients, losses and code-activity counts summed over the data
    group in one all-reduce; gradients and losses divided by its size."""
    from sparse_coding__tpu_torch.parallel.mesh import DATA_AXIS

    g_leaves, names = tree_leaves(grads), list(loss_dict)
    *summed, counts = mesh.all_reduce_many(g_leaves + [loss_dict[n] for n in names] + [counts], DATA_AXIS)
    out = [t / float(mesh.shape[DATA_AXIS]) for t in summed]
    k = len(g_leaves)
    return tree_unflatten(grads, out[:k]), dict(zip(names, out[k:])), counts


def make_big_batch_step(sig, tx, l1_warmup_steps: int = 0, mesh=None):
    """``step(state, batch) -> (state, loss_dict, c)``: the gradient of
    ``sig.loss``, the optimizer update and the code-activity totals, written
    into ``state``'s own tensors (the same state comes back). The l1 ramp
    (``l1_warmup_steps > 0``: `ensemble.l1_warmup_buffers`, from ~0 to the
    configured ``l1_alpha``) reads the device step counter; the stored
    buffers keep the configured value. Losses are 0-d, ``c`` is
    ``[B, n_feats]`` in the compute dtype. The loss runs under the precision
    policy in effect at the call. With ``mesh`` the batch is this rank's
    rows, and the gradients, losses and counts are the data group's
    (`_data_sum`)."""
    from sparse_coding__tpu_torch.parallel.mesh import DATA_AXIS

    data_parallel = mesh is not None and mesh.groups[DATA_AXIS] is not None

    def step(state: BigBatchState, batch: torch.Tensor):
        buffers = l1_warmup_buffers(state.buffers, state.step, l1_warmup_steps, sig)
        leaves = tree_map(lambda v: v.detach().requires_grad_(True), state.params)
        total, (loss_dict, aux) = sig.loss(_stack1(leaves), _stack1(buffers), batch)
        grads = tree_unflatten(leaves, torch.autograd.grad(total.sum(), tree_leaves(leaves)))
        with torch.no_grad():
            c = aux["c"][0].detach()
            counts = (c != 0).sum(dim=0)
            loss_dict = {k: v.detach() for k, v in loss_dict.items()}
            if data_parallel:
                grads, loss_dict, counts = _data_sum(mesh, grads, loss_dict, counts)
            updates, opt_state = tx.update(_stack1(grads), _stack1(state.opt_state), _stack1(state.params))
            params = apply_updates(_stack1(state.params), updates)
            c_totals = state.c_totals + counts
            _copy_into(state.params, _unstack1(params))
            _copy_into(state.opt_state, _unstack1(opt_state))
            state.c_totals.copy_(c_totals)
            state.step.add_(1)
        return state, {k: v[0] for k, v in loss_dict.items()}, c

    return step


def per_example_mse_from_codes(sig, params, buffers, batch, c) -> torch.Tensor:
    """[B] reconstruction error per example, decoding the codes the train
    step already computed (no second encode forward). A bf16 code is
    promoted to f32 before the decode, as jnp promotes it."""
    ld = sig.to_learned_dict(params, buffers)
    x_hat = ld.uncenter(ld.decode(c.to(torch.promote_types(c.dtype, torch.float32))))
    return ((x_hat - batch) ** 2).mean(dim=-1)


def _l2_rows(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def resurrect_dead_features(
    state: BigBatchState,
    replacement_vectors: torch.Tensor,
    encoder_key: str = "encoder",
    encoder_norm_ratio: float = 0.2,
    threshold: int = 0,
) -> Tuple[BigBatchState, int]:
    """Re-init the features with ``c_totals <= threshold`` from the
    worst-reconstructed examples, zero their Adam moments and reset the
    activity totals; returns ``(state, n_dead)``, ``state`` the same object
    with its tensors rewritten in place.

    ``replacement_vectors`` is ``[n_feats, d]`` (rows of live features are
    ignored). As in JAX, a replacement row is normalized to
    ``encoder_norm_ratio`` times the average encoder-row norm; the dead rows'
    encoder bias is zeroed, and so is every optimizer-state row whose
    leading dimension mirrors the feature axis (Adam's mu and nu of the
    encoder and the bias)."""
    with torch.no_grad():
        dead = state.c_totals <= threshold
        n_dead = int(dead.sum())
        enc = state.params[encoder_key]
        av_norm = _l2_rows(enc).mean()
        reps = replacement_vectors.to(enc.dtype)
        scale = encoder_norm_ratio * av_norm / torch.clamp(_l2_rows(reps)[:, None], min=1e-8)
        enc.copy_(torch.where(dead[:, None], reps * scale, enc))
        if "encoder_bias" in state.params:
            bias = state.params["encoder_bias"]
            bias.copy_(torch.where(dead, torch.zeros_like(bias), bias))
        for leaf in _tensors(state.opt_state):
            if leaf.shape[:1] == dead.shape:
                keep = ~dead.reshape((-1,) + (1,) * (leaf.ndim - 1))
                leaf.copy_(torch.where(keep, leaf, torch.zeros_like(leaf)))
        state.c_totals.zero_()
    return state, n_dead


def train_big_batch(
    sig,
    init_hparams: Dict[str, Any],
    dataset,
    batch_size: int,
    n_steps: int,
    key,
    learning_rate: float = 1e-3,
    mesh=None,
    reinit_every: Optional[int] = 100,
    worst_k: int = 1024,
    compute_dtype=None,
    resurrection_log: Optional[list] = None,
    encoder_norm_ratio: float = 0.2,
    l1_warmup_steps: int = 0,
    telemetry=None,
    trace_trigger=None,
    checkpoint_dir: Optional[str] = None,
    resume: Optional[bool] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_keep: int = 3,
    preempt_sync_every: int = 16,
    device=None,
) -> Tuple[BigBatchState, Any]:
    """Train one SAE with big batches and periodic dead-feature
    resurrection; returns ``(final state, sig)`` (``sig.to_learned_dict(
    state.params, state.buffers)`` exports it). JAX's signature, plus
    ``device`` (None = cuda; raises without a card unless ``"cpu"``).

    ``dataset`` is an ``[N, d]`` tensor or array (moved to ``device`` in
    f32), or a chunk-store folder / `data.ChunkStore`, loaded through
    `data.chunks.load_store_dataset` (verified chunks; a corrupt chunk is
    quarantined and skipped within ``SC_CHUNK_LOSS_BUDGET``, past it
    `ResumableAbort`, exit 75). ``compute_dtype`` (e.g. ``"bfloat16"``)
    runs the loss under the precision policy (f32 master weights and
    moments). ``resurrection_log`` (a caller-owned list) receives one
    ``(step, n_dead)`` per resurrection; ``telemetry`` (a
    `telemetry.events.RunTelemetry`) a ``resurrection`` event, the
    ``resurrections`` / ``resurrected_features`` / ``train.steps`` counters,
    ``step`` span windows between resurrections and the device-memory
    gauges at each resurrection and at the end.

    Preemption: with ``checkpoint_dir`` SIGTERM/SIGINT commits a checkpoint
    (the state and the cursor: completed steps and the generator's state) at
    the next step boundary and exits resumable (75); ``checkpoint_every=N``
    also checkpoints every N steps, keeping ``checkpoint_keep``.
    ``resume=True`` (or ``SC_RESUME=1``) restores the newest committed
    checkpoint and replays the remaining steps; the worst-example ring
    restarts empty, as in JAX, so a checkpoint taken at a resurrection
    boundary resumes to the uninterrupted run's bits. ``trace_trigger`` (a
    `telemetry.profiling.TraceTrigger`; None builds one from
    ``SC_TRACE_WINDOW``) is stepped at every step boundary and closed at the
    end, also on a preemption or a crash. ``mesh`` (a
    `parallel.Mesh`): the batch's rows are spread over its data axis (see
    the module's notes); every rank must call this with the same arguments.
    ``preempt_sync_every``: in a world of several ranks the preemption
    agreement runs every that many step boundaries; in a world of one every
    boundary reads the local flag."""
    from sparse_coding__tpu_torch.data.chunks import ChunkStore, load_store_dataset

    device = resolve_device(device)
    if trace_trigger is None:
        # callers without a trigger still honour SC_TRACE_WINDOW: an unarmed
        # trigger costs one int compare a step
        trace_trigger = TraceTrigger.from_env(telemetry=telemetry)
    if isinstance(dataset, (str, ChunkStore)) or hasattr(dataset, "__fspath__"):
        with span(telemetry, "data_wait", name="load_store_dataset"):
            dataset, _budget = load_store_dataset(dataset, telemetry=telemetry, device=device)
    else:
        if not isinstance(dataset, torch.Tensor):
            dataset = torch.from_numpy(np.require(dataset, requirements=("C", "W")))
        dataset = dataset.to(device=device, dtype=torch.float32)
    with px.compute(compute_dtype):
        return _train_big_batch(
            sig, init_hparams, dataset, batch_size, n_steps, key, learning_rate, reinit_every, worst_k,
            resurrection_log, encoder_norm_ratio, l1_warmup_steps, telemetry, checkpoint_dir, resume,
            checkpoint_every, checkpoint_keep, device, mesh, preempt_sync_every, trace_trigger,
        )


def _train_big_batch(sig, init_hparams, dataset, batch_size, n_steps, key, learning_rate, reinit_every, worst_k,
                     resurrection_log, encoder_norm_ratio, l1_warmup_steps, telemetry, checkpoint_dir, resume,
                     checkpoint_every, checkpoint_keep, device, mesh=None,
                     preempt_sync_every: int = 16, trace_trigger=None) -> Tuple[BigBatchState, Any]:
    from sparse_coding__tpu_torch.telemetry.multihost import heartbeat
    gen = key if isinstance(key, torch.Generator) else torch.Generator().manual_seed(int(key))
    params, buffers = sig.init(gen, **init_hparams, device="cpu")
    to_dev = lambda v: v.to(device) if isinstance(v, torch.Tensor) else v  # noqa: E731
    params, buffers = tree_map(to_dev, params), tree_map(to_dev, buffers)
    tx = adam(learning_rate)
    n_feats = params["encoder"].shape[0]
    state = BigBatchState(params=params, buffers=buffers, opt_state=init_opt_state(tx, params),
                          c_totals=torch.zeros((n_feats,), dtype=torch.float32, device=device),
                          step=torch.zeros((), dtype=torch.int32, device=device))

    ckpt = None
    start_step = 0
    if checkpoint_dir is not None:
        from sparse_coding__tpu_torch.train.loop import DriverCheckpointer
        from sparse_coding__tpu_torch.train.preemption import resume_requested

        ckpt = DriverCheckpointer(checkpoint_dir, telemetry=telemetry, keep=checkpoint_keep, every=checkpoint_every,
                                  sync_every=preempt_sync_every)
        if resume_requested(resume):
            tree = ckpt.restore()
            if tree is not None:
                state = _map_tensors(tree["state"], lambda t: t.to(device))
                start_step = int(tree["cursor"]["step"])
                gen.set_state(tree["cursor"]["key"])
                print(f"Resumed {checkpoint_dir} at step {start_step}")

    track = bool(reinit_every)
    rows = slice(0, batch_size)
    sig_exec = sig
    if mesh is not None:
        from sparse_coding__tpu_torch.parallel.mesh import batch_sharding

        rows = batch_sharding(mesh).rows(batch_size)
        # the mesh's loss (the tied SAE's DP backward); the export keeps `sig`
        sig_exec = sig.bind_mesh(mesh) if hasattr(sig, "bind_mesh") else sig
    step_fn = make_big_batch_step(sig_exec, tx, l1_warmup_steps=l1_warmup_steps, mesh=mesh)
    worst = WorstExamples(worst_k)
    n = dataset.shape[0]
    cuda = device.type == "cuda"
    # the MSE read: copied into alternating host buffers behind each step,
    # and taken into the ring after the next step is enqueued
    mse_host = [torch.empty(batch_size, dtype=torch.float32, pin_memory=cuda) for _ in range(2)]
    pending = []

    def drain():
        for idx_p, buf, ev in pending:
            if ev is not None:
                ev.synchronize()
            worst.update(idx_p, buf.numpy().copy())
        pending.clear()

    # goodput: one "step" span per window between host-sync boundaries
    # (resurrections, the end of the run)
    win = span(telemetry, "step", name="step_window").begin()
    win_start = start_step
    try:
        for i in range(start_step, n_steps):
            fault_point("step_loop", step=i)
            idxs = batch_indices(gen, batch_size, n)
            batch = torch.index_select(dataset, 0, torch.from_numpy(idxs[rows]).to(device, non_blocking=True))
            state, _loss, c = step_fn(state, batch)
            if track:
                mse = per_example_mse_from_codes(sig, state.params, state.buffers, batch, c)
                if mesh is not None:
                    from sparse_coding__tpu_torch.parallel.mesh import DATA_AXIS

                    mse = mesh.all_gather(mse, DATA_AXIS)  # every row's, in the batch's order
                buf = mse_host[i % 2]
                buf.copy_(mse, non_blocking=cuda)
                ev = None
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record()
                drain()
                pending.append((idxs, buf, ev))

            if reinit_every and (i + 1) % reinit_every == 0:
                drain()
                win.end(steps=i + 1 - win_start)
                win_start = i + 1
                worst_idx = worst.get_worst(n_feats)
                reps = dataset[torch.from_numpy(np.resize(worst_idx, n_feats)).to(device)]
                state, n_dead = resurrect_dead_features(state, reps, encoder_norm_ratio=encoder_norm_ratio)
                worst = WorstExamples(worst_k)
                if resurrection_log is not None:
                    resurrection_log.append((i + 1, n_dead))
                if telemetry is not None:
                    telemetry.event("resurrection", step=i + 1, n_dead=int(n_dead), n_feats=int(n_feats))
                    telemetry.counter_inc("resurrections")
                    telemetry.counter_inc("resurrected_features", int(n_dead))
                    # a host-sync boundary: the device-memory watermark sample
                    # and the pod heartbeat (a no-op in a world of one)
                    record_hbm_watermarks(telemetry, [device])
                    heartbeat(telemetry, step=i + 1)
                if n_dead:
                    print(f"step {i+1}: resurrected {n_dead} dead features")
                win = span(telemetry, "step", name="step_window").begin()
            if telemetry is not None:
                telemetry.counter_inc("train.steps")
            if trace_trigger is not None:
                trace_trigger.on_step(i + 1)  # host-side int compares only
            if ckpt is not None:
                # cursor = completed steps + the generator's state after this
                # step's draw (a resumed run replays the same batches)
                def _save_ckpt(path, _done=i + 1):
                    from sparse_coding__tpu_torch.train.checkpoint import save_checkpoint_tree

                    save_checkpoint_tree(path, {"cursor": {"step": _done, "key": gen.get_state()}, "state": state})

                ckpt.boundary(i + 1, _save_ckpt)
        drain()
        if telemetry is not None:
            record_hbm_watermarks(telemetry, [device])
            heartbeat(telemetry, step=n_steps)
    finally:
        # a leaked profiler window would block every later capture in the process
        win.end()  # the open step window: emitted even on preempt/crash
        if trace_trigger is not None:
            trace_trigger.close(n_steps)
        if ckpt is not None:
            ckpt.close()
    return state, sig
