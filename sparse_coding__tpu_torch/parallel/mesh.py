"""The ``(model, data, dict)`` mesh over a `torch.distributed` world, and the
rules that cut an ensemble's state and batches across it.

Counterpart of `sparse_coding__tpu/parallel/mesh.py`. One process holds one
device (a rank); the mesh lays the world's ranks out in the JAX package's
``(model, data, dict)`` row-major order (rank ``r`` sits where
``np.arange(world).reshape(model, data, dict_)`` holds ``r``), and holds one
process group per axis: the ranks that differ from this one along that axis
alone. The axes mean what they mean in JAX:

  axis "model" — stacked ensemble members are split across ranks; no
                 collective runs inside a step;
  axis "data"  — the batch's rows are split; the gradients are summed over
                 the data group (the DDP all-reduce) and divided by its size;
  axis "dict"  — each member's ``n_dict_components`` rows are split; the
                 partial decodes are summed over the dict group.

Where JAX's `NamedSharding` places an array, the port cuts it: `shard_state`
keeps this rank's slice of every leaf by `infer_state_specs` (the JAX rules,
leaf for leaf, as axis-name tuples), and `batch_sharding` /
`per_model_batch_sharding` say which rows (and members) of a global batch
this rank takes. Collectives go through `Mesh.all_reduce`,
`Mesh.all_gather`, `Mesh.ring_shift` (JAX's ``ppermute`` around the axis)
and `Mesh.all_to_all` (its tiled ``all_to_all``): NCCL takes CUDA tensors as
they are; gloo, the backend when ranks share a device or run on the CPU,
receives a CUDA tensor's bytes through host memory (the computation never
leaves the card). Every collective's bytes and seconds are counted in
`Mesh.stats`, in all and under its own name (``"ring_shift.bytes"``): through host
memory the clock starts once the card has finished the work queued before
the exchange, so the seconds are the exchange's alone (the copy to the
host would wait for that work anyway); on NCCL, which enqueues the
exchange on the card's stream, they are the host's enqueue time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sparse_coding__tpu_torch.utils.tree import tree_map

MODEL_AXIS = "model"
DATA_AXIS = "data"
DICT_AXIS = "dict"
AXES = (MODEL_AXIS, DATA_AXIS, DICT_AXIS)


@dataclasses.dataclass
class Mesh:
    """A ``(model, data, dict)`` layout of the world's ranks, seen from one
    rank. ``shape`` maps each axis to its size (as JAX's ``mesh.shape``),
    ``coords`` to this rank's index along it, ``ranks`` to the global ranks
    of this rank's group on it, ``groups`` to that group (None where the axis
    has size 1: nothing to exchange). ``backend`` is the world's
    (``"nccl"``, ``"gloo"``, or ``"none"`` for a world of one that was never
    initialised)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    ranks: Dict[str, List[int]]
    groups: Dict[str, Any]
    backend: str
    rank: int
    world_size: int
    stats: Dict[str, float] = dataclasses.field(default_factory=lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})

    def _through_host(self, t: torch.Tensor) -> bool:
        return t.is_cuda and self.backend != "nccl"

    def _start(self, t: torch.Tensor) -> float:
        if self._through_host(t):
            torch.cuda.synchronize(t.device)  # the rank's own queued work stays out of the exchange's time
        return time.perf_counter()

    def _count(self, t: torch.Tensor, t0: float, kind: str) -> None:
        seconds, nbytes = time.perf_counter() - t0, t.numel() * t.element_size()
        for prefix in ("", kind + "."):
            self.stats[prefix + "calls"] = self.stats.get(prefix + "calls", 0) + 1
            self.stats[prefix + "bytes"] = self.stats.get(prefix + "bytes", 0) + nbytes
            self.stats[prefix + "seconds"] = self.stats.get(prefix + "seconds", 0.0) + seconds

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over ``axis``'s group, as a new tensor on ``t``'s
        device (``t`` itself where the axis has size 1)."""
        group = self.groups[axis]
        if group is None:
            return t
        t0 = self._start(t)
        buf = t.detach().to("cpu", copy=True) if self._through_host(t) else t.detach().clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        out = buf.to(t.device) if buf.device != t.device else buf
        self._count(t, t0, "all_reduce")
        return out

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` along ``axis``, concatenated on ``dim`` in the
        axis' order (``t`` itself where the axis has size 1)."""
        group = self.groups[axis]
        if group is None:
            return t
        t0 = self._start(t)
        src = t.detach().to("cpu") if self._through_host(t) else t.detach()
        src = src.contiguous()
        parts = [torch.empty_like(src) for _ in self.ranks[axis]]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=dim)
        out = out.to(t.device) if out.device != t.device else out
        self._count(t, t0, "all_gather")
        return out

    def ring_shift(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """JAX's ``lax.ppermute`` with ``perm = [(i, (i + 1) % p)]``: this
        rank's ``t`` goes to the next rank of ``axis``' group, and the
        previous rank's arrives (``t`` itself where the axis has size 1).
        The send and the receive are posted together before either is
        waited on, so a ring of any size cannot deadlock."""
        group = self.groups[axis]
        if group is None:
            return t
        ranks, i = self.ranks[axis], self.coords[axis]
        t0 = self._start(t)
        src = t.detach().to("cpu") if self._through_host(t) else t.detach()
        src = src.contiguous()
        buf = torch.empty_like(src)
        ops = [dist.P2POp(dist.isend, src, ranks[(i + 1) % len(ranks)], group=group),
               dist.P2POp(dist.irecv, buf, ranks[(i - 1) % len(ranks)], group=group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = buf.to(t.device) if buf.device != t.device else buf
        self._count(t, t0, "ring_shift")
        return out

    def all_to_all(self, t: torch.Tensor, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
        """JAX's tiled ``lax.all_to_all``: ``t`` split into p equal pieces on
        ``split_dim``, piece j sent to the axis' j-th rank, and the pieces
        received concatenated on ``concat_dim`` in the axis' order (``t``
        itself where the axis has size 1)."""
        group = self.groups[axis]
        if group is None:
            return t
        p = len(self.ranks[axis])
        if t.shape[split_dim] % p != 0:
            raise ValueError(f"dim {split_dim} of size {t.shape[split_dim]} does not split into {p} pieces")
        t0 = self._start(t)
        src = t.detach().to("cpu") if self._through_host(t) else t.detach()
        pieces = [c.contiguous() for c in torch.chunk(src, p, dim=split_dim)]
        me = self.coords[axis]
        got = [pieces[me] if j == me else torch.empty_like(c) for j, c in enumerate(pieces)]
        # point to point, every send and receive posted before any wait:
        # gloo has no all_to_all in every torch release
        ops = [op for j, peer in enumerate(self.ranks[axis]) if j != me
               for op in (dist.P2POp(dist.isend, pieces[j], peer, group=group),
                          dist.P2POp(dist.irecv, got[j], peer, group=group))]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = torch.cat(got, dim=concat_dim)
        out = out.to(t.device) if out.device != t.device else out
        self._count(t, t0, "all_to_all")
        return out

    def all_reduce_many(self, tensors: List[torch.Tensor], axis: str) -> List[torch.Tensor]:
        """Each tensor summed over ``axis``' group in ONE exchange (flattened
        into one f32 operand), back in its own shape and dtype."""
        if self.groups[axis] is None:
            return list(tensors)
        flat = self.all_reduce(torch.cat([t.reshape(-1).float() for t in tensors]), axis)
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
            i += t.numel()
        return out


def _world() -> Tuple[int, int, str]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), str(dist.get_backend())
    return 0, 1, "none"


def make_mesh(model: int = 1, data: int = 1, dict_: int = 1) -> Mesh:
    """The ``(model, data, dict)`` mesh over the current `torch.distributed`
    world (a world of one when none was initialised). Axis sizes must
    multiply to the world size; axes of size 1 are kept. Every rank must call
    it, in the same order as the other ranks: it creates each axis' process
    groups (`dist.new_group`) in one fixed order on all of them."""
    rank, world, backend = _world()
    n = model * data * dict_
    if n != world:
        raise ValueError(f"mesh {model}x{data}x{dict_} needs {n} devices, have {world}")
    layout = np.arange(world).reshape(model, data, dict_)
    where = tuple(int(i) for i in np.argwhere(layout == rank)[0])
    shape = {MODEL_AXIS: model, DATA_AXIS: data, DICT_AXIS: dict_}
    coords = dict(zip(AXES, where))
    ranks: Dict[str, List[int]] = {}
    groups: Dict[str, Any] = {}
    for ax, axis in enumerate(AXES):
        # every line of the layout along this axis, in one order on every rank
        lines = np.moveaxis(layout, ax, -1).reshape(-1, layout.shape[ax])
        for line in lines:
            members = [int(r) for r in line]
            group = dist.new_group(members) if len(members) > 1 else None
            if rank in members:
                ranks[axis], groups[axis] = members, group
    return Mesh(shape=shape, coords=coords, ranks=ranks, groups=groups, backend=backend, rank=rank,
                world_size=world)


def default_mesh_shape(n_devices: int, n_models: int = 1, want_dict: bool = False):
    """Heuristic (model, data, dict) factorization of `n_devices`.

    Greedy: give the model axis the largest divisor of `n_devices` that
    divides `n_models` (ensemble members are embarrassingly parallel — the
    cheapest axis); optionally carve a dict axis of 2; the rest is data.
    """
    model = 1
    for cand in range(min(n_models, n_devices), 0, -1):
        if n_devices % cand == 0 and n_models % cand == 0:
            model = cand
            break
    rest = n_devices // model
    dict_ = 2 if (want_dict and rest % 2 == 0) else 1
    data = rest // dict_
    return model, data, dict_


def _part(n: int, size: int, index: int) -> slice:
    if n % size != 0:
        raise ValueError(f"{n} does not split into {size} equal parts")
    step = n // size
    return slice(index * step, (index + 1) * step)


@dataclasses.dataclass(frozen=True)
class BatchSlice:
    """Which part of a global batch this rank holds: ``leading`` axes kept
    whole (e.g. `step_scan`'s step axis), then, for a per-member batch, the
    member axis cut on the model axis, then the rows cut on the data axis;
    the feature axis whole."""

    leading: int
    per_model: bool
    model: Tuple[int, int]  # (this rank's index, axis size)
    data: Tuple[int, int]

    def rows(self, batch_size: int) -> slice:
        return _part(batch_size, self.data[1], self.data[0])

    def members(self, n_models: int) -> slice:
        return _part(n_models, self.model[1], self.model[0])

    def __call__(self, batch: torch.Tensor) -> torch.Tensor:
        """This rank's view of ``batch``."""
        index: List[Any] = [slice(None)] * self.leading
        if self.per_model:
            index.append(self.members(batch.shape[self.leading]))
        index.append(self.rows(batch.shape[len(index)]))
        return batch[tuple(index)]


def batch_sharding(mesh: Mesh, leading: int = 0) -> BatchSlice:
    """A ``[batch, d_activation]`` batch shared by all members: rows on the
    data axis, features whole (``leading`` whole axes first)."""
    return BatchSlice(leading, False, (mesh.coords[MODEL_AXIS], mesh.shape[MODEL_AXIS]),
                      (mesh.coords[DATA_AXIS], mesh.shape[DATA_AXIS]))


def per_model_batch_sharding(mesh: Mesh, leading: int = 0) -> BatchSlice:
    """A ``[n_models, batch, d_activation]`` per-member batch: members on the
    model axis, rows on the data axis."""
    return BatchSlice(leading, True, (mesh.coords[MODEL_AXIS], mesh.shape[MODEL_AXIS]),
                      (mesh.coords[DATA_AXIS], mesh.shape[DATA_AXIS]))


class PartitionSpec:
    """The mesh axis of each dim of one leaf (None: whole), as JAX's
    `PartitionSpec`; equal to the tuple of its axes. Not a tuple itself, so
    a tree of specs keeps one spec per leaf (`utils.tree` walks tuples)."""

    __slots__ = ("axes",)

    def __init__(self, *axes: Optional[str]):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self) -> int:
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __contains__(self, axis) -> bool:
        return axis in self.axes

    def index(self, axis: str) -> int:
        return self.axes.index(axis)

    def __eq__(self, other) -> bool:
        return self.axes == tuple(other) if isinstance(other, (tuple, PartitionSpec)) else NotImplemented

    def __hash__(self) -> int:
        return hash(self.axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.axes!r}"


def infer_state_specs(state, n_models: int, mesh: Mesh, shard_dict: bool = True):
    """The `PartitionSpec` of each leaf of an `EnsembleState` (the JAX
    package's, leaf for leaf).

    Rules (per leaf):
      - leading dim == n_models → that dim goes on the model axis;
      - for rank-2/3 leaves with the model axis assigned, the next dim goes on
        the dict axis when divisible by its size (encoder / decoder / bias /
        optimizer moments, whose dim 1 is n_dict_components). Rank≥4 leaves
        are replicated past the model axis: their dim 1 is a structural axis
        (e.g. the scanned layer stack of LISTA's `encoder_layers`,
        `[n_models, K, n_feats, d]`);
      - everything else replicated (an empty spec).

    Optimizer state leaves (adam mu/nu) mirror the param shapes, so the same
    shape rule cuts them identically — keeping update math local.
    """
    model_size = mesh.shape[MODEL_AXIS]
    if n_models % model_size != 0:
        raise ValueError(
            f"n_models={n_models} must be divisible by the mesh model axis "
            f"({model_size}); pad the ensemble or resize the mesh"
        )
    return tree_map(lambda leaf: spec_for_shape(tuple(getattr(leaf, "shape", ())), n_models, mesh.shape, shard_dict),
                    state)


def spec_for_shape(shape: Tuple[int, ...], n_models: int, sizes: Dict[str, int],
                   shard_dict: bool = True) -> PartitionSpec:
    """`infer_state_specs`' rule for one leaf of global ``shape`` on a mesh
    of axis ``sizes``."""
    dict_size = sizes[DICT_AXIS] if shard_dict else 1
    if len(shape) == 0 or shape[0] != n_models:
        return PartitionSpec()
    axes: List[Optional[str]] = [MODEL_AXIS]
    if 2 <= len(shape) <= 3 and dict_size > 1 and shape[1] % dict_size == 0:
        axes.append(DICT_AXIS)
    axes += [None] * (len(shape) - len(axes))
    return PartitionSpec(*axes)


def leaf_slices(spec, shape: Tuple[int, ...], sizes: Dict[str, int], coords: Dict[str, int]):
    """The index (one slice per dim) that cuts a leaf of global ``shape`` with
    axis tuple ``spec``, on a mesh of axis ``sizes``, down to the part held
    at ``coords``."""
    index = []
    for dim, n in enumerate(shape):
        axis = spec[dim] if dim < len(spec) else None
        index.append(slice(0, n) if axis is None else _part(n, sizes[axis], coords[axis]))
    return tuple(index)


def shard_state(state, mesh: Mesh, n_models: int, shard_dict: bool = True):
    """An `EnsembleState` cut down to this rank's slice of every leaf by
    `infer_state_specs` (copies: the full state may be freed)."""
    specs = infer_state_specs(state, n_models, mesh, shard_dict)

    def cut(leaf, spec):
        if not isinstance(leaf, torch.Tensor) or not spec:
            return leaf
        return leaf[leaf_slices(spec, tuple(leaf.shape), mesh.shape, mesh.coords)].clone()

    return tree_map(cut, state, specs)


class _SumOverAxis(torch.autograd.Function):
    """All-reduce (sum) over one mesh axis forward, identity backward: for a
    value every rank of the group then uses alike (a partial decode summed
    over the dict group), the gradient each rank's partial receives is the
    sum's own."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return mesh.all_reduce(t, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherOverAxis(torch.autograd.Function):
    """All-gather over one mesh axis on ``dim`` forward; backward, this
    rank's part of the gradient. Right when every rank of the group computes
    the same loss from the gathered value (so the whole gradient is the same
    on each)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.part = (mesh.coords[axis], t.shape[dim], dim)
        return mesh.all_gather(t, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        i, n, dim = ctx.part
        return g.narrow(dim, i * n, n), None, None, None


def sum_over(mesh: Mesh, axis: str):
    """``f(t)``: ``t`` summed over ``axis``' group, the gradient passed
    through unchanged (`_SumOverAxis`)."""
    return lambda t: _SumOverAxis.apply(t, mesh, axis)


def gather_over(t: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """``t`` gathered over ``axis``' group on ``dim``, the gradient sliced
    back (`_GatherOverAxis`); ``t`` itself where the axis has size 1."""
    if mesh.groups[axis] is None:
        return t
    return _GatherOverAxis.apply(t, mesh, axis, dim)


def gather_state(state, specs, mesh: Mesh):
    """The inverse of `shard_state`: every leaf assembled whole from the
    ranks' slices (collectives over the dict, then the model group: every
    rank must call it)."""

    def whole(leaf, spec):
        if not isinstance(leaf, torch.Tensor) or not spec:
            return leaf
        if DICT_AXIS in spec:
            leaf = mesh.all_gather(leaf, DICT_AXIS, dim=spec.index(DICT_AXIS))
        if MODEL_AXIS in spec:
            leaf = mesh.all_gather(leaf, MODEL_AXIS, dim=spec.index(MODEL_AXIS))
        return leaf

    return tree_map(whole, state, specs)
