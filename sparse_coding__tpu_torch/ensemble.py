"""Stacked-ensemble runtime: train N dictionary models at once.

Counterpart of `sparse_coding__tpu/ensemble.py`. Params and buffers are dicts
of tensors stacked on a leading member axis; the batch is shared by all
members. A step picks one of three paths, by the JAX package's rules and
independent of the device:

  - fused Adam (tied SAE: K1 + K2 of `ops.tied_sae_kernel`, or K1n + K2
    with ``SC_RECOMPUTE_CODE=1``; TopK: K_s + K_d of `ops.topk_kernel` +
    K2): bf16 compute, a fused signature, a supported shape, no centering,
    an Adam whose kwargs and moment storage (f32, bf16, int8) the kernel
    implements, and no update mask;
  - fused grads (K1 or K_s + K_d, then K3) + the port's Adam (+ the
    NaN-safe update mask): the same, with a masked ensemble or an optimizer
    the kernel cannot fuse;
  - autograd of the signature's loss under the precision policy otherwise
    (exact f32 with ``compute_dtype=None``).

On CUDA tensors the fused paths launch the hand-written kernels; on CPU
tensors they run the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparse_coding__tpu_torch.utils import flags
from sparse_coding__tpu_torch.utils import precision as px
from sparse_coding__tpu_torch.utils.device import resolve_device
from sparse_coding__tpu_torch.utils.optim import apply_updates

Params = Dict[str, Optional[torch.Tensor]]


def optim_str_to_func(optim_str: str):
    """Name → optimizer factory. Only ``"adam"`` is ported; the JAX
    package's ``"sgd"`` raises (ROADMAP A1)."""
    from sparse_coding__tpu_torch.utils import optim

    if optim_str == "adam":
        return optim.adam
    if optim_str == "sgd":
        raise NotImplementedError("optimizer 'sgd' is not ported yet — ROADMAP A1")
    raise ValueError(f"Unknown optimizer string: {optim_str}")


def l1_warmup_buffers(buffers: Params, step: int, warmup_steps: int, sig=None) -> Params:
    """``buffers`` with ``l1_alpha`` scaled by a linear ramp from ~0 to 1 over
    ``warmup_steps`` steps (``min((step + 1) / W, 1)`` in f32). ``<= 0`` is
    the identity. Raises when the buffers have no ``l1_alpha``."""
    if warmup_steps <= 0:
        return buffers
    if "l1_alpha" not in buffers:
        name = getattr(sig, "__name__", sig)
        raise ValueError(
            f"l1_warmup_steps={warmup_steps} but {name} buffers have no "
            f"'l1_alpha' key ({sorted(buffers)}); warmup would silently be "
            "a no-op — drop the flag for this signature"
        )
    # the ramp in f32 on the host, as the JAX step computes it in f32
    ramp = min((np.float32(step) + np.float32(1.0)) / np.float32(warmup_steps), np.float32(1.0))
    return {**buffers, "l1_alpha": buffers["l1_alpha"] * float(ramp)}


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


@dataclasses.dataclass
class EnsembleState:
    """The full training state of a stacked ensemble. Every tensor has
    leading dim ``n_models``; ``step`` is shared."""

    params: Params
    buffers: Params
    opt_state: Any
    step: int


class Ensemble:
    """N models of one signature, trained in lockstep."""

    def __init__(
        self,
        models: Sequence[Tuple[Params, Params]],
        sig,
        optimizer: str = "adam",
        optimizer_kwargs: Optional[Dict[str, Any]] = None,
        compute_dtype=None,
        fused: Optional[bool] = None,
        l1_warmup_steps: int = 0,
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
        self.compute_dtype = px.as_dtype(compute_dtype)
        if fused is None:
            fused = (
                self.compute_dtype == torch.bfloat16
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
        self.state = EnsembleState(params, buffers, self.tx.init(params), 0)
        self.fused_adam = self._fused_adam_config()

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
        NaN-safely (so the fused-Adam kernel gives way to fused grads)."""
        mask = torch.as_tensor(mask, dtype=torch.float32, device=self.device)
        if mask.shape != (self.n_models,):
            raise ValueError(f"mask shape {tuple(mask.shape)} != ({self.n_models},)")
        self.state.buffers = {**self.state.buffers, "update_mask": mask}
        return self

    def _optimizer_step(self, grads, exec_buffers):
        st = self.state
        updates, opt_state = self.tx.update(grads, st.opt_state, st.params)
        if "update_mask" in exec_buffers:
            updates = _mask_updates(updates, exec_buffers["update_mask"])
        return apply_updates(st.params, updates), opt_state

    def step_batch(self, batch: torch.Tensor):
        """One update on a batch [B, D] shared by the members. Returns
        ``(loss_dict, aux)``, losses [n_models] left on the device (aux holds
        the code ``c`` on the autograd path, nothing on the fused paths)."""
        st = self.state
        exec_buffers = l1_warmup_buffers(st.buffers, st.step, self.l1_warmup_steps, self.sig)
        adam_kernel = self.fused_adam is not None and "update_mask" not in exec_buffers
        fused_ok = self.fused and (
            not hasattr(self.sig, "fused_batch_supported")
            or self.sig.fused_batch_supported(st.params, batch.shape[0], adam_fused=adam_kernel)
        )
        aux: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            if fused_ok and adam_kernel:
                params, opt_state, loss_dict = self.sig.fused_adam_step(
                    st.params, exec_buffers, batch, st.opt_state, **self.fused_adam
                )
            elif fused_ok:
                grads, loss_dict = self.sig.fused_grads_stacked(st.params, exec_buffers, batch)
                params, opt_state = self._optimizer_step(grads, exec_buffers)
        if not fused_ok:
            grads, loss_dict, aux = self._autograd(exec_buffers, batch)
            with torch.no_grad():
                params, opt_state = self._optimizer_step(grads, exec_buffers)
        self.state = EnsembleState(params, st.buffers, opt_state, st.step + 1)
        return loss_dict, aux

    def _autograd(self, exec_buffers, batch):
        leaves = {k: v.detach().requires_grad_(True) for k, v in self.state.params.items()}
        with px.compute(self.compute_dtype):
            total, (loss_dict, aux) = self.sig.loss(leaves, exec_buffers, batch)
        # members are independent: the gradient of the sum is each member's own
        g = torch.autograd.grad(total.sum(), list(leaves.values()))
        grads = dict(zip(leaves, g))
        return grads, {k: v.detach() for k, v in loss_dict.items()}, {k: v.detach() for k, v in aux.items()}

    def step_scan(self, batches: torch.Tensor) -> Dict[str, torch.Tensor]:
        """K updates, one per batch of ``batches`` [K, B, D]. Returns the
        loss dict with leading dim K (a Python loop: PyTorch dispatches
        eagerly, so there is no scan to compile)."""
        losses = [self.step_batch(b)[0] for b in batches]
        return {k: torch.stack([l[k] for l in losses]) for k in losses[0]}

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
            "state": _map_tensors(self.state, lambda t: t.detach().cpu().clone()),
        }

    @staticmethod
    def from_state(state_dict: Dict[str, Any], sig=None, device=None) -> "Ensemble":
        """Rebuild from `state_dict` on ``device`` (None = cuda). The
        signature is found by its class name among the port's own (a record
        of either package names them alike), unless ``sig`` is given."""
        from sparse_coding__tpu_torch.models.sae import FunctionalTiedSAE
        from sparse_coding__tpu_torch.models.topk import TopKEncoder, TopKEncoderApprox

        device = resolve_device(device)
        if sig is None:
            name = state_dict["sig"].rpartition(".")[2]
            sigs = {s.__name__: s for s in (FunctionalTiedSAE, TopKEncoder, TopKEncoderApprox)}
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
        self.tx = optim_str_to_func(self.optimizer_name)(**self.optimizer_kwargs)
        self.state = _map_tensors(state_dict["state"], lambda t: t.to(device))
        self.fused_adam = self._fused_adam_config()
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
    device=None,
    **common_hparams,
) -> Ensemble:
    """Init N models of `sig` (one per hparams dict) and stack them.

    ``key`` seeds one `torch.Generator` on ``device`` that draws the members
    in order. ``device=None`` means ``cuda`` and raises where there is no
    CUDA device (pass ``device="cpu"`` for the CPU)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(key))
    models = [sig.init(gen, **common_hparams, **hp, device=device) for hp in hparams_list]
    return Ensemble(
        models, sig, optimizer, optimizer_kwargs, compute_dtype=compute_dtype,
        fused=fused, l1_warmup_steps=l1_warmup_steps,
    )
