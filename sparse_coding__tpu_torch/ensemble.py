"""Stacked-ensemble runtime: train N dictionary models at once.

Counterpart of `sparse_coding__tpu/ensemble.py`. Params and buffers are dicts
of tensors stacked on a leading member axis; the batch is shared by all
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

`Ensemble.step_batch` is one eager step. `Ensemble.step_scan` and
`Ensemble.step_scan_idx` (the JAX package's ``lax.scan`` dispatches) run K
steps: on CUDA each step is a replay of a CUDA graph captured from one step
(`_StepGraph`), the batch copied (or gathered) into the graph's static input
before each replay; on CPU tensors they loop over `step_batch`. Every step,
eager or replayed, writes the new state into the state's own tensors, so a
graph stays valid across eager steps.
"""

from __future__ import annotations

import dataclasses
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
from sparse_coding__tpu_torch.telemetry.health import FIRE_EMA_KEY, HealthConfig, health_pack, init_fire_ema, n_feats_of
from sparse_coding__tpu_torch.utils import flags
from sparse_coding__tpu_torch.utils import precision as px
from sparse_coding__tpu_torch.utils.device import resolve_device
from sparse_coding__tpu_torch.utils.optim import apply_updates, f32

Params = Dict[str, Optional[torch.Tensor]]


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

    return {k: one(u) for k, u in updates.items()}


def stack_pytrees(trees: Sequence[Params]) -> Params:
    """Stack per-member dicts on a new leading axis (None stays None)."""
    return {
        k: None if trees[0][k] is None else torch.stack([t[k] for t in trees])
        for k in trees[0]
    }


def unstack_pytree(tree: Params, n: int) -> List[Params]:
    return [{k: None if v is None else v[i] for k, v in tree.items()} for i in range(n)]


def _map_tensors(v, fn):
    """``fn`` applied to every tensor of a state (dicts and dataclasses
    rebuilt around them; None and scalars kept)."""
    if isinstance(v, torch.Tensor):
        return fn(v)
    if isinstance(v, dict):
        return {k: _map_tensors(x, fn) for k, x in v.items()}
    if dataclasses.is_dataclass(v):
        return type(v)(**{f.name: _map_tensors(getattr(v, f.name), fn) for f in dataclasses.fields(v)})
    return v


def _tensors(v) -> List[torch.Tensor]:
    """Every tensor of a state, in a fixed order."""
    out: List[torch.Tensor] = []
    _map_tensors(v, out.append)
    return out


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
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            _copy_into(getattr(dst, f.name), getattr(src, f.name))


def _member(tree: Params, i: int) -> Params:
    """Member ``i`` of stacked params or buffers, its member axis kept (length 1)."""
    return {k: None if v is None else v[i : i + 1] for k, v in tree.items()}


def _stack_losses(losses: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([l[k] for l in losses]) for k in losses[0]}


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
        dev = next(iter(params.values())).device
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
        return next(iter(self.state.params.values())).device

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

    # -- training ------------------------------------------------------------

    def set_update_mask(self, mask) -> "Ensemble":
        """Freeze members: ``mask`` [n_models], 1.0=train, 0.0=frozen. The step
        still computes every member but zeroes the frozen members' updates
        NaN-safely (so the fused-Adam kernel gives way to fused grads). Drops
        the captured graphs."""
        mask = torch.as_tensor(mask, dtype=torch.float32, device=self.device)
        if mask.shape != (self.n_models,):
            raise ValueError(f"mask shape {tuple(mask.shape)} != ({self.n_models},)")
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
        if per_model or self.unstacked or not self.fused:
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
        into the state's own tensors, so the captured graphs stay valid."""
        self._device_step()
        loss_dict, aux = self._step_in_place(batch, per_model)
        self._state.step += 1
        return loss_dict, aux

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
        return tuple({k: torch.cat([p[j][k] for p in parts]) for k in parts[0][j]} for j in range(3))

    def _grads(self, params, exec_buffers, batch):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with px.compute(self.compute_dtype):
            total, (loss_dict, aux) = self.sig.loss(leaves, exec_buffers, batch)
        g = torch.autograd.grad(total.sum(), list(leaves.values()))
        grads = dict(zip(leaves, g))
        return grads, {k: v.detach() for k, v in loss_dict.items()}, {k: v.detach() for k, v in aux.items()}

    def step_scan(self, batches: torch.Tensor, per_model: bool = False) -> Dict[str, torch.Tensor]:
        """K updates, one per batch of ``batches`` [K, B, D] (or [K, n_models,
        B, D] with ``per_model``): the JAX package's ``lax.scan`` dispatch.
        Returns the loss dict with leading dim K, a result of this call's own.
        On CUDA every step is a replay of the step's CUDA graph (captured when
        the step's signature is first seen, a host setting it read changed or
        the state it froze was replaced), each batch copied into the graph's
        input; on CPU tensors a loop over `step_batch`."""
        if not batches.is_cuda:
            return _stack_losses([self.step_batch(b, per_model)[0] for b in batches])
        return self._replay(batches.shape[1:], batches.dtype, per_model, len(batches),
                            lambda x, k: x.copy_(batches[k]))

    def step_scan_idx(self, dataset: torch.Tensor, idxs, per_model: bool = False) -> Dict[str, torch.Tensor]:
        """K updates, batch k gathered from ``dataset`` [N, D] by the row
        indices ``idxs[k]`` (``idxs`` [K, B]): `step_scan` without the staged
        [K, B, D] copy. On CUDA each gather writes straight into the graph's
        input (`torch.index_select` with ``out=``). Shared batches only, as
        in the JAX package."""
        if per_model:
            raise ValueError("step_scan_idx is shared-batch only")
        idxs = torch.as_tensor(idxs, device=dataset.device)
        if not dataset.is_cuda:
            return _stack_losses([self.step_batch(torch.index_select(dataset, 0, i))[0] for i in idxs])
        shape = (idxs.shape[1],) + tuple(dataset.shape[1:])
        return self._replay(shape, dataset.dtype, False, len(idxs),
                            lambda x, k: torch.index_select(dataset, 0, idxs[k], out=x))

    def _replay(self, shape, dtype, per_model: bool, K: int, fill) -> Dict[str, torch.Tensor]:
        """K steps on CUDA by graph replays; ``fill(x, k)`` writes batch k
        into the graph's input ``x``. When no valid graph exists, the first
        batch is a real eager step on the capture stream (which also warms
        up the lazy initialisations capture must not meet), then the step is
        captured."""
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
            self.capture_seconds += time.perf_counter() - t0
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
        with torch.cuda.stream(side):
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
        self._graphs[key] = g
        self.captures += 1
        return g, first

    # -- export / checkpoint -------------------------------------------------

    def unstack(self) -> List[Tuple[Params, Params]]:
        params = unstack_pytree(self.state.params, self.n_models)
        buffers = unstack_pytree(self.state.buffers, self.n_models)
        return list(zip(params, buffers))

    def to_learned_dicts(self) -> List[Any]:
        """Every member as a `LearnedDict` (tensors detached copies)."""
        out = []
        for p, b in self.unstack():
            p = {k: v.detach().clone() for k, v in p.items()}
            out.append(self.sig.to_learned_dict(p, b))
        return out

    def state_dict(self) -> Dict[str, Any]:
        """Checkpointable description; the state is copied to the host."""
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
            "state": _map_tensors(self.state, lambda t: t.detach().cpu().clone()),
        }

    @staticmethod
    def from_state(state_dict: Dict[str, Any], sig=None, device=None) -> "Ensemble":
        """Rebuild from `state_dict` on ``device`` (None = cuda). The
        signature is found by its class name among the port's own (a record
        of either package names them alike), unless ``sig`` is given."""
        from sparse_coding__tpu_torch.models.fista import FunctionalFista
        from sparse_coding__tpu_torch.models.sae import FunctionalSAE, FunctionalTiedSAE
        from sparse_coding__tpu_torch.models.topk import TopKEncoder, TopKEncoderApprox

        device = resolve_device(device)
        if sig is None:
            name = state_dict["sig"].rpartition(".")[2]
            sigs = {s.__name__: s for s in (FunctionalTiedSAE, FunctionalSAE, TopKEncoder, TopKEncoderApprox,
                                            FunctionalFista)}
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
        return self


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
