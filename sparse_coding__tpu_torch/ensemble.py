"""Stacked-ensemble runtime: train N dictionary models at once.

Counterpart of `sparse_coding__tpu/ensemble.py`. Params and buffers are trees
(`utils.tree`: nested dicts and lists, as the JAX package's pytrees) of
tensors stacked on a leading member axis; the batch is shared by all
members, or per member (``per_model``: [M, B, D]). A step picks one of three
paths, by the JAX package's rules and independent of the device:

  - fused Adam (tied SAE: K1 + K2 of `ops.tied_sae_kernel`, or K1n + K2
    with ``SC_RECOMPUTE_CODE=1``; TopK: K_s + K_d of `ops.topk_kernel` +
    K2): bf16 compute, a fused signature, a supported shape, no centering,
    an Adam whose kwargs and moment storage (f32, bf16, int8) the kernel
    implements, no update mask, a shared batch and a stacked ensemble;
  - fused grads (K1 or K_s + K_d, then K3) + the port's optimizer (+ the
    NaN-safe update mask): the same, with a masked ensemble or an optimizer
    the kernel cannot fuse (SGD, a learning-rate schedule, an unknown Adam
    kwarg);
  - autograd of the signature's loss under the precision policy otherwise
    (exact f32 with ``compute_dtype=None``; per-member batches; ``unstacked``,
    which differentiates one member at a time); its ``aux`` carries the
    code, which the FISTA decoder update takes as its warm start.

On CUDA tensors the fused paths launch the hand-written kernels; on CPU
tensors they run the kernels' plain versions. The health pack
(`telemetry.health`) and the feature sketch (`telemetry.feature_stats`) read
each step's gradients and code, so either one turns the fused paths off, as
in the JAX package; they run inside the step (and its graph), write the
firing EMA and the sketch back into the buffers, and add the ``health_*``
metrics to the losses. The l1-warmup ramp is computed
on the device from a device step counter, so no value that changes from step
to step crosses from the host.

`Ensemble.shard(mesh)` spreads the ensemble over a ``(model, data, dict)``
mesh of `torch.distributed` ranks (`parallel.mesh`): each rank keeps its
members and dictionary rows, takes its rows of every global batch, and
returns the global losses. The routes under a mesh:
  - model axis only (and a world of one): each rank steps its members on
    the routes above, with no collective inside the step; a member's result
    is the bits of the unsharded run's;
  - data axis > 1: fused grads (K1 + K3) or autograd of the DP loss
    (`FunctionalTiedSAE.bind_mesh`) on the local rows, ONE all-reduce of the
    gradients and the losses over the data group, divided by its size, then
    the port's optimizer (the fused Adam cannot see the summed gradient and
    is refused);
  - dict axis > 1 (``shard_dict``): autograd on the local dictionary rows,
    the partial decode summed over the dict group
    (`FunctionalTiedSAE.dict_parallel_loss`; other signatures gather their
    dict-cut leaves for the loss and keep their part of the gradient).
A step that holds a collective is never captured into a CUDA graph (the
gloo collective is a host exchange): `step_scan` then runs eager steps.

`Ensemble.step_batch` is one eager step. `Ensemble.step_scan` and
`Ensemble.step_scan_idx` (the JAX package's ``lax.scan`` dispatches) run K
steps: on CUDA each step is a replay of a CUDA graph captured from one step
(`_StepGraph`), the batch copied (or gathered) into the graph's static input
before each replay; on CPU tensors they loop over `step_batch`. Every step,
eager or replayed, writes the new state into the state's own tensors, so a
graph stays valid across eager steps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from sparse_coding__tpu_torch.telemetry.feature_stats import (
    FEATURE_STATS_KEYS,
    FeatureStatsConfig,
    feature_stats_pack,
    init_feature_stats,
)
from sparse_coding__tpu_torch.telemetry.audit import allowed_transfer
from sparse_coding__tpu_torch.telemetry.events import compile_active, telemetry_live
from sparse_coding__tpu_torch.telemetry.health import FIRE_EMA_KEY, HealthConfig, health_pack, init_fire_ema, n_feats_of
from sparse_coding__tpu_torch.telemetry.profiling import capture_mode
from sparse_coding__tpu_torch.utils import flags
from sparse_coding__tpu_torch.utils import precision as px
from sparse_coding__tpu_torch.utils.device import resolve_device
from sparse_coding__tpu_torch.utils.optim import apply_updates, f32
from sparse_coding__tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

Params = Dict[str, Any]


def optim_str_to_func(optim_str: str):
    """Name → optimizer factory: ``"adam"`` (`utils.optim.adam`) or
    ``"sgd"`` (`utils.optim.sgd`), as in the JAX package."""
    from sparse_coding__tpu_torch.utils import optim

    if optim_str == "adam":
        return optim.adam
    if optim_str == "sgd":
        return optim.sgd
    raise ValueError(f"Unknown optimizer string: {optim_str}")


def l1_warmup_buffers(buffers: Params, step: torch.Tensor, warmup_steps: int, sig=None) -> Params:
    """``buffers`` with ``l1_alpha`` scaled by a linear ramp from ~0 to 1 over
    ``warmup_steps`` steps: ``min((step + 1) / W, 1)`` in f32 on the device,
    ``step`` an integer tensor there (the JAX step's expression; the
    division is IEEE's between two tensors, never a multiply by a host
    reciprocal). ``<= 0`` is the identity. Raises when the buffers have no
    ``l1_alpha``."""
    if warmup_steps <= 0:
        return buffers
    if "l1_alpha" not in buffers:
        name = getattr(sig, "__name__", sig)
        raise ValueError(
            f"l1_warmup_steps={warmup_steps} but {name} buffers have no "
            f"'l1_alpha' key ({sorted(buffers)}); warmup would silently be "
            "a no-op — drop the flag for this signature"
        )
    ramp = torch.clamp_max((step.to(torch.float32) + 1.0) / f32(float(warmup_steps), step), 1.0)
    return {**buffers, "l1_alpha": buffers["l1_alpha"] * ramp}


# the Adam kwargs the fused kernel implements (every moment storage the
# port's Adam takes — f32, bf16, int8 — is one the kernel implements)
_FUSED_ADAM_KWARGS = {"learning_rate", "b1", "b2", "eps", "mu_dtype", "nu_dtype", "seed"}
_FUSED_ADAM_WARNED: set = set()


def _refuse_fused_adam(sig, reason: str) -> None:
    """The fused-Adam gate's refusal: the step takes fused grads + the
    port's Adam instead, and says so once per (signature, reason)."""
    key = (getattr(sig, "__qualname__", str(sig)), reason)
    if key in _FUSED_ADAM_WARNED:
        return
    _FUSED_ADAM_WARNED.add(key)
    warnings.warn(
        f"fused-Adam kernel refused for {key[0]}: {reason}; falling back to "
        "fused grads + the port's Adam (same update semantics)",
        stacklevel=3,
    )


def _mask_updates(updates: Params, mask: torch.Tensor) -> Params:
    """Zero the updates of masked-out members (``mask`` [M], 1=train,
    0=frozen) with `torch.where`, so NaN updates cannot leak through."""

    def one(u):
        m = mask.reshape(mask.shape + (1,) * (u.ndim - 1))
        return torch.where(m > 0, u, torch.zeros_like(u))

    return tree_map(one, updates)


def stack_pytrees(trees: Sequence[Params]) -> Params:
    """Stack per-member trees on a new leading axis (None stays None)."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def unstack_pytree(tree: Params, n: int) -> List[Params]:
    return [tree_map(lambda v: v[i], tree) for i in range(n)]


def _map_tensors(v, fn):
    """``fn`` applied to every tensor of a state (its trees and dataclasses
    rebuilt around them; None and scalars kept)."""
    return tree_map(lambda t: fn(t) if isinstance(t, torch.Tensor) else t, v)


def _tensors(v) -> List[torch.Tensor]:
    """Every tensor of a state, in JAX's tree order."""
    return [t for t in tree_leaves(v) if isinstance(t, torch.Tensor)]


def _copy_into(dst, src) -> None:
    """Copy every tensor of ``src`` into the tensor at the same place in
    ``dst`` (a tensor that a kernel already updated in place is its own
    source, and is skipped)."""
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
    elif isinstance(dst, dict):
        for k, v in dst.items():
            _copy_into(v, src[k])
    elif isinstance(dst, (list, tuple)):
        for v, w in zip(dst, src):
            _copy_into(v, w)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            _copy_into(getattr(dst, f.name), getattr(src, f.name))


def _member(tree: Params, i: int) -> Params:
    """Member ``i`` of stacked params or buffers, its member axis kept (length 1)."""
    return tree_map(lambda v: v[i : i + 1], tree)


def _stack_losses(losses: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([l[k] for l in losses]) for k in losses[0]}


def _cuts_dict(specs) -> bool:
    """Whether a state's specs cut any param or buffer leaf on the dict axis."""
    from sparse_coding__tpu_torch.parallel.mesh import DICT_AXIS

    return any(DICT_AXIS in spec for spec in tree_leaves((specs.params, specs.buffers)))


class _StepGraph:
    """One captured step: the CUDA graph, its static input ``x`` (the batch
    each replay reads), its static losses [L, M] (``names`` in order), the
    identity of the state's tensors it froze (address, shape, dtype,
    strides; a graph is replayed only while they are the state's) and those
    tensors themselves (so no other tensor can take their addresses while
    the graph lives). The host settings it froze are part of its key
    (`Ensemble._settings`)."""

    def __init__(self, graph, x, losses, names, leaves):
        self.graph, self.x, self.losses, self.names = graph, x, losses, names
        self.leaves = leaves
        self.ident = _identity(leaves)
        self.cost: Optional[Dict[str, Any]] = None  # `Ensemble.step_cost` at its capture


def _scan_entry(per_model: bool) -> str:
    """The JAX package's entry-point name of a `step_scan` dispatch."""
    return "ensemble.step_scan_per_model" if per_model else "ensemble.step_scan"


def _pool_bytes(pool) -> int:
    """Bytes the allocator holds in the private memory ``pool`` (a step
    graph pool's), from its segment snapshot (a host-side query)."""
    want = tuple(pool)
    return sum(int(seg["total_size"]) for seg in torch.cuda.memory_snapshot()
               if seg.get("segment_pool_id") is not None and tuple(seg["segment_pool_id"]) == want)


def _identity(leaves: Sequence[torch.Tensor]) -> List[tuple]:
    return [(t.data_ptr(), t.shape, t.dtype, t.stride()) for t in leaves]


@dataclasses.dataclass
class EnsembleState:
    """The full training state of a stacked ensemble. Every tensor has
    leading dim ``n_models``; ``step`` is shared (a host int: what the
    checkpoint saves; the step also lives on the device for the ramp, see
    `Ensemble`). A step writes the new values into these tensors."""

    params: Params
    buffers: Params
    opt_state: Any
    step: int


class Ensemble:
    """N models of one signature, trained in lockstep.

    ``unstacked`` differentiates the members one at a time (the JAX
    package's ``lax.map`` escape hatch: the code of one member at a time)
    and steps the stacked optimizer; it takes the autograd path.
    ``health`` (True or a `HealthConfig`) and ``feature_stats`` (True or a
    `FeatureStatsConfig`) fuse the health pack and the feature sketch into
    the step; either forces ``fused=False``, also over an explicit
    ``fused=True`` (the JAX package's rule). The step
    count lives twice: ``state.step`` on the host and a counter on the
    device that the l1-warmup ramp reads, refilled from ``state.step``
    whenever a state is assigned (which also drops the captured graphs)."""

    def __init__(
        self,
        models: Sequence[Tuple[Params, Params]],
        sig,
        optimizer: str = "adam",
        optimizer_kwargs: Optional[Dict[str, Any]] = None,
        compute_dtype=None,
        fused: Optional[bool] = None,
        l1_warmup_steps: int = 0,
        unstacked: bool = False,
        health=False,
        feature_stats=False,
    ):
        if not models:
            raise ValueError("Ensemble requires at least one (params, buffers) model")
        if l1_warmup_steps > 0 and "l1_alpha" not in models[0][1]:
            raise ValueError(
                f"l1_warmup_steps={l1_warmup_steps} requested but "
                f"{getattr(sig, '__name__', sig)} buffers have no 'l1_alpha' "
                "key — warmup would silently be a control run"
            )
        self.sig = sig
        self.n_models = len(models)
        self.l1_warmup_steps = int(l1_warmup_steps)
        self.unstacked = bool(unstacked)
        self.compute_dtype = px.as_dtype(compute_dtype)
        self.health: Optional[HealthConfig] = (
            health if isinstance(health, HealthConfig) else (HealthConfig() if health else None))
        self.feature_stats: Optional[FeatureStatsConfig] = (
            feature_stats if isinstance(feature_stats, FeatureStatsConfig)
            else (FeatureStatsConfig() if feature_stats else None))
        if self.health is not None or self.feature_stats is not None:
            fused = False  # the packs read the gradients and the code
        if fused is None:
            fused = (
                self.compute_dtype == torch.bfloat16
                and not self.unstacked
                and hasattr(sig, "fused_grads_stacked")
                and hasattr(sig, "fused_supported")
                and sig.fused_supported(*models[0])
            )
        self.fused = bool(fused)
        self.optimizer_name = optimizer
        self.optimizer_kwargs = dict(optimizer_kwargs or {})
        self.optimizer_kwargs.setdefault("learning_rate", 1e-3)
        self.tx = optim_str_to_func(optimizer)(**self.optimizer_kwargs)
        params = stack_pytrees([p for p, _ in models])
        buffers = stack_pytrees([b for _, b in models])
        dev = tree_leaves(params)[0].device
        if self.health is not None:
            buffers[FIRE_EMA_KEY] = init_fire_ema(self.n_models, n_feats_of(models[0][0]), device=dev)
        if self.feature_stats is not None:
            buffers.update(init_feature_stats(self.n_models, n_feats_of(models[0][0]), self.feature_stats, device=dev))
        self.state = EnsembleState(params, buffers, self.tx.init(params), 0)
        self.fused_adam = self._fused_adam_config()
        self._init_runtime()

    def _init_runtime(self) -> None:
        """What the steps keep beside the state: the device step counter, the
        captured graphs by step signature, their capture stream and their
        one memory pool (the graphs of one ensemble never run at once), the
        number of captures and the host seconds spent in them."""
        self._step_t: Optional[torch.Tensor] = None
        self._mesh = None
        self._shard_dict = True
        self._specs = None
        self._sig_exec = self.sig
        self._graphs: Dict[tuple, _StepGraph] = {}
        self._capture_stream = None
        self._pool = None
        self.captures = 0
        self.capture_seconds = 0.0

    @property
    def state(self) -> EnsembleState:
        return self._state

    @state.setter
    def state(self, state: EnsembleState) -> None:
        """A state assigned from outside (a resume, the FISTA decoder
        update): the graphs, which froze the old state's tensors, are
        dropped, and the device step counter is refilled before the next
        step."""
        self._state = state
        self._graphs = {}
        self._step_stale = True

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.state.params)[0].device

    def _fused_adam_config(self) -> Optional[Dict[str, Any]]:
        """The kernel's Adam constants, or None when the fused-Adam kernel
        will not run (refusals warn once, as in the JAX package). With
        ``SC_RECOMPUTE_CODE=1`` at build time the step rebuilds the code in
        the backward (``recompute_code``; signatures without a stored code
        accept and ignore it)."""
        if not (self.fused and self.optimizer_name == "adam" and hasattr(self.sig, "fused_adam_step")):
            return None
        extra = set(self.optimizer_kwargs) - _FUSED_ADAM_KWARGS
        if extra:
            _refuse_fused_adam(self.sig, f"unknown optimizer kwargs {sorted(extra)}")
            return None
        kw = self.optimizer_kwargs
        if callable(kw.get("learning_rate")):
            _refuse_fused_adam(self.sig, "non-scalar learning_rate (schedule)")
            return None
        cfg = dict(
            lr=float(kw.get("learning_rate", 1e-3)),
            b1=float(kw.get("b1", 0.9)),
            b2=float(kw.get("b2", 0.999)),
            eps=float(kw.get("eps", 1e-8)),
        )
        if flags.recompute_code():
            cfg["recompute_code"] = True
        return cfg

    # -- scale-out -----------------------------------------------------------

    def shard(self, mesh, shard_dict: bool = True) -> "Ensemble":
        """Spread the ensemble over ``mesh`` (a `parallel.Mesh`; in place):
        this rank keeps its members (model axis) and, with ``shard_dict``,
        its rows of each member's dictionary (dict axis); `step_batch` and
        `step_scan` then take global batches and keep their rows (data
        axis). Every rank of the mesh must call it, and then step in
        lockstep."""
        from sparse_coding__tpu_torch.parallel import mesh as mesh_lib

        if self._mesh is not None:
            raise ValueError("this ensemble is already sharded; rebuild it from state_dict() to reshard")
        specs = mesh_lib.infer_state_specs(self.state, self.n_models, mesh, shard_dict)
        collectives = mesh.shape[mesh_lib.DATA_AXIS] > 1 or _cuts_dict(specs)
        if collectives and (self.health is not None or self.feature_stats is not None):
            raise ValueError("the health pack and the feature sketch read the whole batch's code and "
                             "gradients; shard such an ensemble on the model axis only")
        self.state = mesh_lib.shard_state(self.state, mesh, self.n_models, shard_dict)
        self._adopt_slice(mesh, shard_dict, specs)
        return self

    @property
    def mesh(self):
        return self._mesh

    def _dict_parallel(self) -> bool:
        """Whether any param or buffer leaf is cut on the dict axis."""
        return self._mesh is not None and _cuts_dict(self._specs)

    def _step_collectives(self) -> bool:
        """Whether a step exchanges anything between ranks (a data axis, or
        a dictionary cut on the dict axis)."""
        from sparse_coding__tpu_torch.parallel.mesh import DATA_AXIS

        return self._mesh is not None and (self._mesh.shape[DATA_AXIS] > 1 or self._dict_parallel())

    def local_batch(self, batch: torch.Tensor, per_model: bool = False, leading: int = 0) -> torch.Tensor:
        """This rank's rows (and, per member, members) of a global batch
        (``leading`` whole axes first); the batch itself unsharded."""
        if self._mesh is None:
            return batch
        from sparse_coding__tpu_torch.parallel import mesh as mesh_lib

        cut = mesh_lib.per_model_batch_sharding if per_model else mesh_lib.batch_sharding
        return cut(self._mesh, leading)(batch)

    def _gather_losses(self, loss_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The losses of every member (last axis), gathered over the model
        group in one exchange: the same values on every rank."""
        from sparse_coding__tpu_torch.parallel.mesh import MODEL_AXIS

        if self._mesh is None or self._mesh.groups[MODEL_AXIS] is None or not loss_dict:
            return loss_dict
        names = list(loss_dict)
        stacked = self._mesh.all_gather(torch.stack([loss_dict[n] for n in names]), MODEL_AXIS, dim=-1)
        return {n: stacked[i] for i, n in enumerate(names)}

    def _data_mean(self, grads, loss_dict):
        """The gradients and losses averaged over the data group: ONE
        all-reduce of every gradient leaf and loss, divided by the group's
        size."""
        from sparse_coding__tpu_torch.parallel.mesh import DATA_AXIS

        mesh = self._mesh
        if mesh is None or mesh.groups[DATA_AXIS] is None:
            return grads, loss_dict
        g_leaves, names = tree_leaves(grads), list(loss_dict)
        summed = mesh.all_reduce_many(g_leaves + [loss_dict[n] for n in names], DATA_AXIS)
        out = [t / float(mesh.shape[DATA_AXIS]) for t in summed]
        return tree_unflatten(grads, out[: len(g_leaves)]), dict(zip(names, out[len(g_leaves):]))

    def _loss(self, params, exec_buffers, batch):
        """The signature's loss on this rank's part: the plain one (or the
        mesh's `bind_mesh` variant); on a dictionary cut on the dict axis the
        signature's `dict_parallel_loss`, or its loss on the dict-cut leaves
        gathered (each rank keeping its part of their gradient)."""
        if not self._dict_parallel():
            return self._sig_exec.loss(params, exec_buffers, batch)
        from sparse_coding__tpu_torch.parallel import mesh as mesh_lib

        mesh, specs = self._mesh, self._specs

        def whole(leaf, spec, grad):
            if not isinstance(leaf, torch.Tensor) or mesh_lib.DICT_AXIS not in spec:
                return leaf
            dim = spec.index(mesh_lib.DICT_AXIS)
            return mesh_lib.gather_over(leaf, mesh, mesh_lib.DICT_AXIS, dim) if grad else \
                mesh.all_gather(leaf, mesh_lib.DICT_AXIS, dim=dim)

        buffers = tree_map(lambda b, sp: whole(b, sp, False), exec_buffers,
                           {k: specs.buffers.get(k, mesh_lib.PartitionSpec()) for k in exec_buffers})
        enc_spec = specs.params.get("encoder", ()) if isinstance(specs.params, dict) else ()
        if hasattr(self.sig, "dict_parallel_loss") and mesh_lib.DICT_AXIS in enc_spec:
            return self.sig.dict_parallel_loss(params, buffers, batch, mesh_lib.sum_over(mesh, mesh_lib.DICT_AXIS))
        return self._sig_exec.loss(tree_map(lambda p, sp: whole(p, sp, True), params, specs.params), buffers, batch)

    # -- training ------------------------------------------------------------

    def set_update_mask(self, mask) -> "Ensemble":
        """Freeze members: ``mask`` [n_models], 1.0=train, 0.0=frozen. The step
        still computes every member but zeroes the frozen members' updates
        NaN-safely (so the fused-Adam kernel gives way to fused grads). Drops
        the captured graphs."""
        mask = torch.as_tensor(mask, dtype=torch.float32, device=self.device)
        if mask.shape != (self.n_models,):
            raise ValueError(f"mask shape {tuple(mask.shape)} != ({self.n_models},)")
        if self._mesh is not None:
            from sparse_coding__tpu_torch.parallel.mesh import MODEL_AXIS, PartitionSpec, per_model_batch_sharding

            mask = mask[per_model_batch_sharding(self._mesh).members(self.n_models)].clone()
            self._specs.buffers["update_mask"] = PartitionSpec(MODEL_AXIS)
        self.state = dataclasses.replace(self.state, buffers={**self.state.buffers, "update_mask": mask})
        return self

    def _device_step(self) -> torch.Tensor:
        """The device step counter [] int32, equal to ``state.step``: filled
        from it (one launch, no copy from the host) after a state was
        assigned."""
        if self._step_t is None or self._step_t.device != self.device:
            self._step_t = torch.full((), self.state.step, dtype=torch.int32, device=self.device)
        elif self._step_stale:
            self._step_t.fill_(self.state.step)
        self._step_stale = False
        return self._step_t

    def _settings(self) -> tuple:
        """The host settings a step reads (signature, precision, route,
        fused-Adam constants, warm-up length, ``unstacked``, optimizer, the
        health and feature-sketch configs): part of a graph's key, so a
        change to any of them is a new capture."""
        adam = None if self.fused_adam is None else tuple(sorted(self.fused_adam.items()))
        return (self.sig, self.compute_dtype, self.fused, adam, self.l1_warmup_steps, self.unstacked, self.tx,
                self.health, self.feature_stats)

    def _route(self, batch_size: int, masked: bool, per_model: bool) -> str:
        """``"fused_adam"``, ``"fused_grads"`` or ``"autograd"``: the JAX
        package's gate (per-member batches and ``unstacked`` refuse the fused
        kernels; a mask refuses the fused Adam; the signature checks the
        batch size)."""
        if per_model or self.unstacked or not self.fused or self._dict_parallel():
            return "autograd"
        adam = self.fused_adam is not None and not masked
        if hasattr(self.sig, "fused_batch_supported") and not self.sig.fused_batch_supported(
            self.state.params, batch_size, adam_fused=adam
        ):
            return "autograd"
        return "fused_adam" if adam else "fused_grads"

    def _optimizer_step(self, st: EnsembleState, grads, exec_buffers):
        updates, opt_state = self.tx.update(grads, st.opt_state, st.params)
        if "update_mask" in exec_buffers:
            updates = _mask_updates(updates, exec_buffers["update_mask"])
        return apply_updates(st.params, updates), opt_state

    def _advance(self, st: EnsembleState, batch: torch.Tensor, step_t: torch.Tensor, per_model: bool):
        """One step's math from ``st`` (nothing assigned): ``(params,
        opt_state, loss_dict, aux, buffers)``, ``buffers`` the new values of
        the buffers the packs write (empty without them). Every value that
        changes from step to step is read on the device (the ramp and the
        health EMA's bias correction from ``step_t``, the bias corrections
        and stochastic-store seeds from the optimizer's count), so a graph
        captured from this function is right at every replay."""
        exec_buffers = l1_warmup_buffers(st.buffers, step_t, self.l1_warmup_steps, self.sig)
        route = self._route(batch.shape[1 if per_model else 0], "update_mask" in exec_buffers, per_model)
        aux: Dict[str, torch.Tensor] = {}
        if route == "autograd":
            grads, loss_dict, aux = self._autograd(st.params, exec_buffers, batch, per_model)
            grads, loss_dict = self._data_mean(grads, loss_dict)
            loss_dict, extra = self._packs(st, grads, loss_dict, aux, step_t)
            with torch.no_grad():
                params, opt_state = self._optimizer_step(st, grads, exec_buffers)
            return params, opt_state, loss_dict, aux, extra
        with torch.no_grad():
            if route == "fused_adam":
                params, opt_state, loss_dict = self.sig.fused_adam_step(
                    st.params, exec_buffers, batch, st.opt_state, **self.fused_adam
                )
            else:
                grads, loss_dict = self.sig.fused_grads_stacked(st.params, exec_buffers, batch)
                grads, loss_dict = self._data_mean(grads, loss_dict)
                params, opt_state = self._optimizer_step(st, grads, exec_buffers)
        return params, opt_state, loss_dict, aux, {}

    def _packs(self, st: EnsembleState, grads, loss_dict, aux, step_t):
        """The health pack and the feature sketch on this step's gradients
        and code (observation only: nothing the step computes changes) →
        ``(loss_dict with the health metrics, new buffer values)``. They
        write into the stored buffers, never the warm-up's ramped view."""
        extra: Dict[str, torch.Tensor] = {}
        if self.health is not None:
            h, extra[FIRE_EMA_KEY] = health_pack(st.params, grads, loss_dict["loss"], aux,
                                                 st.buffers[FIRE_EMA_KEY], step_t, self.health)
            loss_dict = {**loss_dict, **h}
        if self.feature_stats is not None:
            extra.update(feature_stats_pack(aux, {k: st.buffers[k] for k in FEATURE_STATS_KEYS}, self.feature_stats))
        return loss_dict, extra

    def step_batch(self, batch: torch.Tensor, per_model: bool = False):
        """One eager update on a batch [B, D] shared by the members (or
        [n_models, B, D] with ``per_model``). Returns ``(loss_dict, aux)``,
        losses [n_models] left on the device (aux holds the code ``c`` on the
        autograd path, nothing on the fused paths). The new state is written
        into the state's own tensors, so the captured graphs stay valid.
        Sharded: ``batch`` is the global batch, of which this rank takes its
        part; the losses are every member's (the same on every rank), the
        aux this rank's rows and members."""
        self._device_step()
        loss_dict, aux = self._step_in_place(self.local_batch(batch, per_model), per_model)
        self._state.step += 1
        return self._gather_losses(loss_dict), aux

    def _autograd(self, params, exec_buffers, batch, per_model: bool):
        """Gradients of the signature's loss: of the stacked members at once
        (members are independent, so the gradient of the sum is each
        member's own), or with ``unstacked`` of one member at a time."""
        if not self.unstacked:
            return self._grads(params, exec_buffers, batch)
        parts = [
            self._grads(_member(params, i), _member(exec_buffers, i), batch[i : i + 1] if per_model else batch)
            for i in range(self.n_models)
        ]
        return tuple(tree_map(lambda *xs: torch.cat(xs), *[p[j] for p in parts]) for j in range(3))

    def _grads(self, params, exec_buffers, batch):
        leaves = tree_map(lambda v: v.detach().requires_grad_(True), params)
        with px.compute(self.compute_dtype):
            total, (loss_dict, aux) = self._loss(leaves, exec_buffers, batch)
        grads = tree_unflatten(leaves, torch.autograd.grad(total.sum(), tree_leaves(leaves)))
        return grads, {k: v.detach() for k, v in loss_dict.items()}, {k: v.detach() for k, v in aux.items()}

    def step_scan(self, batches: torch.Tensor, per_model: bool = False) -> Dict[str, torch.Tensor]:
        """K updates, one per batch of ``batches`` [K, B, D] (or [K, n_models,
        B, D] with ``per_model``): the JAX package's ``lax.scan`` dispatch.
        Returns the loss dict with leading dim K, a result of this call's own.
        On CUDA every step is a replay of the step's CUDA graph (captured when
        the step's signature is first seen, a host setting it read changed or
        the state it froze was replaced), each batch copied into the graph's
        input; on CPU tensors a loop over `step_batch`. Sharded, each rank
        takes its part of every batch, and the losses are gathered once at
        the end; a step that exchanges gradients or decodes between ranks is
        never captured (the steps run eagerly)."""
        if self._mesh is not None:
            local = self.local_batch(batches, per_model, leading=1)
            if local.is_cuda and not self._step_collectives():
                losses = self._replay(local.shape[1:], local.dtype, per_model, len(local),
                                      lambda x, k: x.copy_(local[k]), _scan_entry(per_model))
            else:
                losses = _stack_losses([self._eager_step(b, per_model) for b in local])
            return self._gather_losses(losses)
        if not batches.is_cuda:
            return _stack_losses([self.step_batch(b, per_model)[0] for b in batches])
        return self._replay(batches.shape[1:], batches.dtype, per_model, len(batches),
                            lambda x, k: x.copy_(batches[k]), _scan_entry(per_model))

    def _eager_step(self, local_batch: torch.Tensor, per_model: bool) -> Dict[str, torch.Tensor]:
        """One eager step on this rank's part, its losses left local."""
        self._device_step()
        loss_dict, _ = self._step_in_place(local_batch, per_model)
        self._state.step += 1
        return loss_dict

    def step_scan_idx(self, dataset: torch.Tensor, idxs, per_model: bool = False) -> Dict[str, torch.Tensor]:
        """K updates, batch k gathered from ``dataset`` [N, D] by the row
        indices ``idxs[k]`` (``idxs`` [K, B]): `step_scan` without the staged
        [K, B, D] copy. On CUDA each gather writes straight into the graph's
        input (`torch.index_select` with ``out=``). Shared batches only, as
        in the JAX package. Unsharded ensembles only (a sharded loop feeds
        batches through `step_scan`)."""
        if self._mesh is not None:
            raise ValueError("step_scan_idx is single-shard; sharded ensembles batch "
                             "through step_scan with presharded inputs")
        if per_model:
            raise ValueError("step_scan_idx is shared-batch only")
        idxs = torch.as_tensor(idxs, device=dataset.device)
        if not dataset.is_cuda:
            return _stack_losses([self.step_batch(torch.index_select(dataset, 0, i))[0] for i in idxs])
        shape = (idxs.shape[1],) + tuple(dataset.shape[1:])
        return self._replay(shape, dataset.dtype, False, len(idxs),
                            lambda x, k: torch.index_select(dataset, 0, idxs[k], out=x), "ensemble.step_scan_idx")

    def _replay(self, shape, dtype, per_model: bool, K: int, fill,
                entry: str = "ensemble.step_scan") -> Dict[str, torch.Tensor]:
        """K steps on CUDA by graph replays; ``fill(x, k)`` writes batch k
        into the graph's input ``x``. When no valid graph exists, the first
        batch is a real eager step on the capture stream (which also warms
        up the lazy initialisations capture must not meet), then the step is
        captured: the port's compile, recorded as a ``compile`` event named
        ``entry`` with its host seconds and cost (`step_cost`) on every open
        `RunTelemetry` (``SC_COST_CAPTURE``)."""
        self._device_step()
        key = (per_model, tuple(shape), dtype, "update_mask" in self.state.buffers, self._settings())
        g = self._graphs.get(key)
        if g is not None and g.ident != _identity(self._leaves()):
            self._graphs = {}
            g = None
        first = None
        if g is None:
            t0 = time.perf_counter()
            g, first = self._capture(key, shape, dtype, per_model, fill)
            seconds = time.perf_counter() - t0
            self.capture_seconds += seconds
            if g.cost is not None:
                compile_active(entry, seconds, cost=g.cost)
        out = torch.empty((len(g.names), K, self.n_models), dtype=g.losses.dtype, device=self.device)
        k0 = 0
        if first is not None:
            out[:, 0].copy_(first)
            k0 = 1
        for k in range(k0, K):
            fill(g.x, k)
            g.graph.replay()
            out[:, k].copy_(g.losses)
        self._state.step += K - k0
        return {name: out[i] for i, name in enumerate(g.names)}

    def _leaves(self) -> List[torch.Tensor]:
        """The tensors a captured step reads and writes: the state's and
        the device step counter."""
        st = self.state
        return _tensors(st.params) + _tensors(st.buffers) + _tensors(st.opt_state) + [self._step_t]

    def _step_in_place(self, x: torch.Tensor, per_model: bool):
        """One step that copies its new state into the state's own tensors
        and advances the device step counter in place (``state.step`` is the
        caller's): every step, eager or captured, so each graph's tensors
        stay the state's. Returns ``(loss_dict, aux)``."""
        st = self.state
        params, opt_state, loss_dict, aux, buffers = self._advance(st, x, self._step_t, per_model)
        with torch.no_grad():
            _copy_into(st.params, params)
            _copy_into(st.opt_state, opt_state)
            for k, v in buffers.items():
                _copy_into(st.buffers[k], v)
            self._step_t.add_(1)
        return loss_dict, aux

    def _capture(self, key, shape, dtype, per_model: bool, fill):
        """The eager first step on the capture stream, then the capture of
        one step into the ensemble's pool: ``(the _StepGraph, the first
        step's losses [L, M])``. Capture is thread-local: a loader thread may
        copy to the card meanwhile."""
        dev = self.device
        main = torch.cuda.current_stream(dev)
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
        side = self._capture_stream
        x = torch.empty(shape, dtype=dtype, device=dev)
        fill(x, 0)
        # the side stream waits for everything the main stream enqueued, so
        # memory the side stream allocates or reuses is never still in use
        side.wait_stream(main)
        mode = capture_mode() if telemetry_live() else "off"
        route = self._route(shape[-2], "update_mask" in self.state.buffers, per_model)
        counter = nnz = None
        if mode != "off" and route == "autograd":
            from torch.utils.flop_counter import FlopCounterMode

            counter = FlopCounterMode(display=False)
        with torch.cuda.stream(side):
            if mode != "off" and route != "autograd" and hasattr(self.sig, "code_nnz"):
                nnz = self.sig.code_nnz(self.state.params, x)  # the first step's code
            with counter if counter is not None else contextlib.nullcontext():
                first_losses, _ = self._step_in_place(x, per_model)
            self._state.step += 1
            names = list(first_losses)
            first = torch.stack([first_losses[n] for n in names])
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, stream=side, capture_error_mode="thread_local"):
                loss_dict, _ = self._step_in_place(x, per_model)
                losses = torch.stack([loss_dict[n] for n in names])
        main.wait_stream(side)
        g = _StepGraph(graph, x, losses, names, self._leaves())
        if mode != "off":
            if nnz is not None:
                with allowed_transfer():  # one host read a capture, and only with cost capture on
                    nnz = nnz.item()
            g.cost = self.step_cost(shape, dtype, per_model, code_nnz=nnz,
                                    counted_flops=None if counter is None else counter.get_total_flops())
            if g.cost is not None and mode == "full":
                g.cost["pool_bytes"] = _pool_bytes(self._pool)
        self._graphs[key] = g
        self.captures += 1
        return g, first

    def step_cost(self, shape, dtype=torch.float32, per_model: bool = False, code_nnz: Optional[int] = None,
                  counted_flops: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The analytic cost of one step on a batch of ``shape`` ([B, D], or
        [M, B, D] with ``per_model``): the JAX package's ``compile`` cost
        fields, ``flops`` and ``bytes_accessed`` per step, and ``method``.

        On a fused route the signature counts its kernels'
        (``sig.fused_step_work``, `ops.tied_sae_kernel.kernel_work`, the one
        count the kernel table's bounds read too) at the code's ``code_nnz``
        non-zero entries (a capture passes its first step's, and the cost
        records it, ``code_nnz``, and its share; None counts a dense code); on
        the autograd route the FLOPs are ``counted_flops``
        (`torch.utils.flop_counter.FlopCounterMode` over the eager step
        before a capture) and the bytes every state leaf read once and
        written once plus the batch read once. None where no count exists
        (a fused route of a signature without one, or the autograd route
        without ``counted_flops``)."""
        B = int(shape[-2])
        route = self._route(B, "update_mask" in self.state.buffers, per_model)
        if route != "autograd":
            if not hasattr(self.sig, "fused_step_work"):
                return None
            rc = bool((self.fused_adam or {}).get("recompute_code")) if route == "fused_adam" else False
            work = self.sig.fused_step_work(self.state.params, self.state.opt_state, B, route, recompute_code=rc,
                                            nnz=code_nnz)
            cost = {"flops": work["flops"], "bytes_accessed": work["bytes_accessed"], "route": route,
                    "method": "analytic: " + " + ".join(work["kernels"])}
            if code_nnz is None:
                cost["method"] += " (dense code)"
            else:
                M, N = self.state.params["encoder"].shape[:2]
                cost["method"] += " (the captured step's code nnz)"
                cost["code_nnz"], cost["code_nonzero_frac"] = int(code_nnz), code_nnz / (M * B * N)
            return cost
        if counted_flops is None:
            return None
        state_bytes = sum(t.numel() * t.element_size() for t in _tensors(self.state.params)
                          + _tensors(self.state.buffers) + _tensors(self.state.opt_state))
        batch_bytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        return {"flops": float(counted_flops), "bytes_accessed": float(2 * state_bytes + batch_bytes),
                "route": route, "method": "FlopCounterMode; state leaves read and written once, the batch read once"}

    # -- export / checkpoint -------------------------------------------------

    def full_state(self) -> EnsembleState:
        """The whole state: this rank's own when unsharded; sharded, every
        leaf gathered from the ranks' slices (every rank must call it)."""
        if self._mesh is None:
            return self.state
        from sparse_coding__tpu_torch.parallel.mesh import gather_state

        return gather_state(self.state, self._specs, self._mesh)

    def unstack(self) -> List[Tuple[Params, Params]]:
        """Every member's ``(params, buffers)`` (gathered when sharded)."""
        st = self.full_state()
        params = unstack_pytree(st.params, self.n_models)
        buffers = unstack_pytree(st.buffers, self.n_models)
        return list(zip(params, buffers))

    def to_learned_dicts(self) -> List[Any]:
        """Every member as a `LearnedDict` (tensors detached copies)."""
        out = []
        for p, b in self.unstack():
            out.append(self.sig.to_learned_dict(tree_map(lambda v: v.detach().clone(), p), b))
        return out

    def state_dict(self) -> Dict[str, Any]:
        """Checkpointable description; the state is copied to the host
        (sharded: gathered whole first, on every rank)."""
        return {**self._description(), "state": _map_tensors(self.full_state(), lambda t: t.detach().cpu().clone())}

    def local_state_dict(self) -> Dict[str, Any]:
        """`state_dict` with this rank's slice of the state only, and
        ``local_slice``: the mesh's shape, this rank's coordinates, whether
        the dictionary is cut and the leaves' axis tuples (what a sharded
        checkpoint records for its elastic restore)."""
        sd = {**self._description(), "state": _map_tensors(self.state, lambda t: t.detach().cpu().clone())}
        if self._mesh is not None:
            sd["local_slice"] = {"mesh": dict(self._mesh.shape), "coords": dict(self._mesh.coords),
                                 "shard_dict": self._shard_dict, "specs": self._specs}
        return sd

    def _description(self) -> Dict[str, Any]:
        return {
            "n_models": self.n_models,
            "sig": f"{self.sig.__module__}.{self.sig.__qualname__}",
            "optimizer_name": self.optimizer_name,
            "optimizer_kwargs": self.optimizer_kwargs,
            "compute_dtype": None if self.compute_dtype is None else str(self.compute_dtype).split(".")[-1],
            "fused": self.fused,
            "l1_warmup_steps": self.l1_warmup_steps,
            "unstacked": self.unstacked,
            "health": None if self.health is None else dataclasses.asdict(self.health),
            "feature_stats": None if self.feature_stats is None else dataclasses.asdict(self.feature_stats),
        }

    @staticmethod
    def from_state(state_dict: Dict[str, Any], sig=None, device=None, mesh=None,
                   shard_dict: bool = True) -> "Ensemble":
        """Rebuild from `state_dict` on ``device`` (None = cuda). The
        signature is found by its class name among the port's own (a record
        of either package names them alike), unless ``sig`` is given. With
        ``mesh`` the ensemble comes back sharded: a record holding this
        rank's slice for that mesh (``local_slice``, as
        `train.checkpoint.restore_ensemble_checkpoint` assembles it) is taken
        as it is, a whole state is cut (`shard`)."""
        from sparse_coding__tpu_torch import models as m

        device = resolve_device(device)
        if sig is None:
            name = state_dict["sig"].rpartition(".")[2]
            sigs = {s.__name__: s for s in (
                m.FunctionalTiedSAE, m.FunctionalSAE, m.TopKEncoder, m.TopKEncoderApprox, m.FunctionalFista,
                m.FunctionalTiedCenteredSAE, m.FunctionalThresholdingSAE, m.FunctionalMaskedTiedSAE,
                m.FunctionalMaskedSAE, m.FunctionalReverseSAE, m.FunctionalLISTADenoisingSAE,
                m.FunctionalResidualDenoisingSAE, m.FunctionalPositiveTiedSAE, m.SemiLinearSAE, m.RICA,
                m.DirectCoefOptimizer)}
            if name not in sigs:
                raise ValueError(f"unknown signature {state_dict['sig']!r}")
            sig = sigs[name]

        self = Ensemble.__new__(Ensemble)
        self.sig = sig
        self.n_models = state_dict["n_models"]
        self.optimizer_name = state_dict["optimizer_name"]
        self.optimizer_kwargs = dict(state_dict["optimizer_kwargs"])
        self.compute_dtype = px.as_dtype(state_dict.get("compute_dtype"))
        self.fused = bool(state_dict.get("fused", False))
        self.l1_warmup_steps = int(state_dict.get("l1_warmup_steps", 0))
        self.unstacked = bool(state_dict.get("unstacked", False))
        h, fs = state_dict.get("health"), state_dict.get("feature_stats")
        self.health = HealthConfig(**{k: float(v) for k, v in h.items()}) if h else None
        self.feature_stats = (
            FeatureStatsConfig(n_buckets=int(fs["n_buckets"]), hist_lo=float(fs["hist_lo"]),
                               hist_ratio=float(fs["hist_ratio"])) if fs else None)
        self.tx = optim_str_to_func(self.optimizer_name)(**self.optimizer_kwargs)
        # copies: the steps write into the state's tensors, never into the record's
        self.state = _map_tensors(state_dict["state"], lambda t: t.to(device, copy=True))
        self.fused_adam = self._fused_adam_config()
        self._init_runtime()
        local = state_dict.get("local_slice")
        if local is not None:
            if mesh is None or dict(mesh.shape) != dict(local["mesh"]) or dict(mesh.coords) != dict(local["coords"]):
                raise ValueError("this record holds one rank's slice; rebuild it on the mesh and rank it was "
                                 "assembled for (train.checkpoint.restore_ensemble_checkpoint)")
            self._adopt_slice(mesh, bool(local["shard_dict"]), local["specs"])
        elif mesh is not None:
            self.shard(mesh, shard_dict)
        return self

    def _adopt_slice(self, mesh, shard_dict: bool, specs) -> None:
        """The runtime of a state that is this rank's slice on ``mesh``: the
        mesh's loss (`bind_mesh`), and on a data axis no fused Adam."""
        from sparse_coding__tpu_torch.parallel.mesh import DATA_AXIS

        self._mesh, self._shard_dict, self._specs = mesh, bool(shard_dict), specs
        self._sig_exec = self.sig.bind_mesh(mesh) if hasattr(self.sig, "bind_mesh") else self.sig
        if self.fused_adam is not None and mesh.shape[DATA_AXIS] > 1:
            _refuse_fused_adam(self.sig, "data-parallel mesh (the kernel's Adam would see only this rank's "
                                         "gradient)")
            self.fused_adam = None


def build_ensemble(
    sig,
    key: int,
    hparams_list: Sequence[Dict[str, Any]],
    optimizer: str = "adam",
    optimizer_kwargs: Optional[Dict[str, Any]] = None,
    compute_dtype=None,
    fused: Optional[bool] = None,
    l1_warmup_steps: int = 0,
    health=False,
    feature_stats=False,
    device=None,
    **common_hparams,
) -> Ensemble:
    """Init N models of `sig` (one per hparams dict) and stack them.

    ``key`` seeds one `torch.Generator` on ``device`` that draws the members
    in order. ``health`` / ``feature_stats`` as in `Ensemble` (either one
    gives ``fused=False``). ``device=None`` means ``cuda`` and raises where
    there is no CUDA device (pass ``device="cpu"`` for the CPU)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(key))
    models = [sig.init(gen, **common_hparams, **hp, device=device) for hp in hparams_list]
    return Ensemble(
        models, sig, optimizer, optimizer_kwargs, compute_dtype=compute_dtype,
        fused=fused, l1_warmup_steps=l1_warmup_steps, health=health, feature_stats=feature_stats,
    )
