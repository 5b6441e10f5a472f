"""Checkpoints: learned-dict exports and crash-consistent training state.

Counterpart of `sparse_coding__tpu/train/checkpoint.py`.

**Exports** (a shared format): `save_learned_dicts` writes a pickle of
``{class, arrays, statics, hyperparams}`` records (numpy arrays, fields by
name), atomically (same-dir temp + ``os.replace``), with a
``<name>.manifest.json`` sidecar (bytes + sha256, `utils.manifest`). Each
record names the JAX package's class (the port's module path with the
package's ``_torch`` suffix dropped: the two packages lay their modules out
alike), so the JAX package's loader imports its own class; the port's loader
maps the class name through its own registry
(`models.learned_dict.LEARNED_DICT_CLASSES`), so exports of either package
load in either.

**Training state** (the port's own format, read only by the port): a
``state.pt`` written by `torch.save` as plain dicts of CPU tensors (the
state's dataclasses tagged by name and rebuilt on load, so `torch.load`
keeps ``weights_only=True``), committed by the JAX package's protocol
(`save_checkpoint_tree`): the data lands in a dot-prefixed staging dir, the
manifest ``sc_manifest.json`` (``format``, ``created_at``, per-file bytes
and, under ``SC_CKPT_VERIFY=digest``, sha256) is written beside it, and
one ``os.replace`` onto ``ckpt_<i>`` commits. `latest_checkpoint` returns
the newest committed directory that verifies, skipping torn or corrupt ones
(each skip an ``anomaly`` event); `gc_checkpoints` keeps the newest K.

**Sharded ensembles** (`Ensemble.shard` in a world of several ranks): each
rank that holds a distinct slice writes it as ``shards/<name>/m<i>_k<j>.pt``
(its model- and dict-axis coordinates) into the one staging dir; rank 0
writes ``state.pt`` with the ensemble's description, the mesh it was saved
on, every leaf's axis tuple and global shape, and commits after a barrier on
the process group's store. No rank ever holds the whole state. The restore
is elastic: `restore_ensemble_checkpoint` assembles, for the mesh in the
template (or for none: the whole state), the part of every leaf each rank
needs from the slices that overlap it, so a checkpoint saved under one
factorization (or by one process) resumes under any other. A single-process
checkpoint keeps the format above, unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
import time
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# the model modules register their learned-dict classes: `models` imports
# them all, so a process that imports only this module loads every export
import sparse_coding__tpu_torch.models  # noqa: F401
from sparse_coding__tpu_torch.models.learned_dict import (
    LEARNED_DICT_CLASSES,
    LEARNED_DICT_REGISTRY,
)
from sparse_coding__tpu_torch.telemetry.events import counter_inc_active, event_active
from sparse_coding__tpu_torch.telemetry.provenance import manifest_files_digest
from sparse_coding__tpu_torch.utils import flags
from sparse_coding__tpu_torch.utils.device import resolve_device
from sparse_coding__tpu_torch.utils.faults import fault_point
from sparse_coding__tpu_torch.utils.manifest import (
    export_manifest_path,
    sha256_file,
    verify_manifest,
    write_manifest,
)
from sparse_coding__tpu_torch.utils.tree import tree_map

MANIFEST_NAME = "sc_manifest.json"
STATE_FILE = "state.pt"
VERIFY_ENV = flags.SC_CKPT_VERIFY.name

_WARNED_LEGACY_EXPORTS: set = set()

# the port's top-level package and the JAX package's name (the same without
# the suffix), spelled from the port's own name
_PORT_PACKAGE = __name__.split(".")[0]
_JAX_PACKAGE = _PORT_PACKAGE[: -len("_torch")] if _PORT_PACKAGE.endswith("_torch") else _PORT_PACKAGE


def export_class_path(cls) -> str:
    """The ``class`` an export record names: for a class of the port, the JAX
    package's module path of the same class (the layouts match); for any
    other class its own path."""
    module = cls.__module__
    if module == _PORT_PACKAGE or module.startswith(_PORT_PACKAGE + "."):
        module = _JAX_PACKAGE + module[len(_PORT_PACKAGE):]
    return f"{module}.{cls.__qualname__}"


def _to_numpy(v):
    """An array field as the record holds it: tensors as numpy arrays, a tree
    of them (`ThresholdingSAE_export.params`, LISTA's nested layers, the
    semi-linear SAE's list of layers) as the same tree of arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t, v)


def _from_numpy(v, device):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), v)


def save_learned_dicts(path, learned_dicts: List[Tuple[Any, Dict[str, Any]]], manifest: bool = True,
                       provenance: Optional[Dict[str, Any]] = None):
    """Save a ``[(LearnedDict, hyperparams), ...]`` list, atomically, with
    the sidecar manifest (``provenance``, a `telemetry.provenance`
    producer-identity block, rides in it)."""
    records = []
    for ld, hyperparams in learned_dicts:
        if type(ld) not in LEARNED_DICT_REGISTRY:
            raise TypeError(f"{type(ld).__name__} is not a registered LearnedDict")
        array_fields, static_fields = LEARNED_DICT_REGISTRY[type(ld)]
        records.append({
            "class": export_class_path(type(ld)),
            "arrays": {f: _to_numpy(getattr(ld, f)) for f in array_fields},
            "statics": {f: getattr(ld, f, None) for f in static_fields},
            "hyperparams": hyperparams,
        })
    fault_point("export", path=str(path))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.tmp{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            pickle.dump(records, f)
            f.flush()
            os.fsync(f.fileno())
        # the old sidecar must never describe the new bytes
        export_manifest_path(path).unlink(missing_ok=True)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    if manifest:
        write_manifest(export_manifest_path(path), {path.name: path},
                       extra={"provenance": provenance} if provenance else None)


def load_learned_dicts(path, verify: Optional[bool] = None, device=None) -> List[Tuple[Any, Dict[str, Any]]]:
    """Load a `save_learned_dicts` export (of either package) onto ``device``
    (None = cuda). ``verify=None`` verifies the sidecar when present and
    warns once when it is absent; True requires it; False skips it. A
    mismatch raises ``ValueError``. Only exports this program or the JAX
    package wrote should be loaded: unpickling runs code."""
    device = resolve_device(device)
    path = Path(path)
    sidecar = export_manifest_path(path)
    if verify is not False:
        if sidecar.is_file():
            ok, reason = verify_manifest(sidecar, base_dir=path.parent)
            if not ok:
                raise ValueError(f"learned-dict export {path} failed manifest verification: {reason}")
        elif verify:
            raise ValueError(f"learned-dict export {path} has no {sidecar.name} manifest")
        elif str(path) not in _WARNED_LEGACY_EXPORTS:
            _WARNED_LEGACY_EXPORTS.add(str(path))
            warnings.warn(f"learned-dict export {path} has no sidecar manifest", RuntimeWarning)
    with open(path, "rb") as f:
        records = pickle.load(f)
    out = []
    for rec in records:
        if "treedef" in rec:
            raise ValueError(f"{path} uses the removed treedef-pickle learned-dict format")
        name = rec["class"].rpartition(".")[2]
        if name not in LEARNED_DICT_CLASSES:
            raise ValueError(f"{path}: learned-dict class {rec['class']!r} is not ported")
        cls = LEARNED_DICT_CLASSES[name]
        ld = cls.__new__(cls)
        for f, v in rec["arrays"].items():
            setattr(ld, f, _from_numpy(v, device))
        for f, v in rec["statics"].items():
            setattr(ld, f, v)
        if not rec["arrays"]:
            ld.device = device  # a dict without arrays (`Identity`) makes its own on the loading device
        out.append((ld, rec["hyperparams"]))
    return out


# -- training state: the atomic commit protocol --------------------------------

_CALLABLE = "<callable: not saved>"
_TAG = "__dataclass__"


def _state_classes() -> Dict[str, type]:
    from sparse_coding__tpu_torch.ensemble import EnsembleState
    from sparse_coding__tpu_torch.train.big_batch import BigBatchState
    from sparse_coding__tpu_torch.utils.optim import AdamState, QuantMoment, SgdState

    return {c.__name__: c for c in (EnsembleState, BigBatchState, AdamState, QuantMoment, SgdState)}


def _to_plain(v):
    """A tree of dicts, lists, dataclasses and tensors as dicts, lists and
    CPU tensors: dataclasses tagged by class name, callables (a schedule)
    replaced by a marker, so `torch.load(weights_only=True)` reads it."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {_TAG: type(v).__name__, **{f.name: _to_plain(getattr(v, f.name)) for f in dataclasses.fields(v)}}
    if isinstance(v, dict):
        return {k: _to_plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_to_plain(x) for x in v)
    if callable(v):
        return _CALLABLE
    return v


def _from_plain(v, classes):
    if isinstance(v, dict):
        if _TAG in v:
            cls = classes[v[_TAG]]
            return cls(**{k: _from_plain(x, classes) for k, x in v.items() if k != _TAG})
        return {k: _from_plain(x, classes) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_from_plain(x, classes) for x in v)
    return v


def _staging_dir(final: Path) -> Path:
    """Dot-prefixed sibling: no ``ckpt_*`` glob matches a torn save."""
    return final.parent / f".staging_{final.name}"


def _write_manifest(ckpt_dir: Path, extra: Optional[Dict[str, Any]] = None) -> None:
    digest = flags.SC_CKPT_VERIFY.get().lower() == "digest"
    files = {}
    for p in sorted(ckpt_dir.rglob("*")):
        if p.is_file() and p.name != MANIFEST_NAME:
            rel = str(p.relative_to(ckpt_dir))
            files[rel] = {"bytes": p.stat().st_size}
            if digest:
                files[rel]["sha256"] = sha256_file(p)
    manifest = {"format": 1, "created_at": time.time(), "files": files, **(extra or {})}
    with open(ckpt_dir / MANIFEST_NAME, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())


def checkpoint_manifest(ckpt_dir) -> Optional[Dict[str, Any]]:
    """The directory's commit manifest, or None when uncommitted/unreadable."""
    try:
        with open(Path(ckpt_dir) / MANIFEST_NAME) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def checkpoint_digest(ckpt_dir) -> Optional[str]:
    """The checkpoint's content digest from its commit manifest (the JAX
    package's `telemetry.provenance.checkpoint_digest`), or None when it is
    uncommitted."""
    manifest = checkpoint_manifest(ckpt_dir)
    return None if manifest is None else manifest_files_digest(manifest.get("files") or {})


def verify_checkpoint(ckpt_dir, depth: Optional[str] = None) -> Tuple[bool, str]:
    """Is ``ckpt_dir`` a committed, intact checkpoint? ``depth`` overrides
    ``SC_CKPT_VERIFY`` (digest | size | off). Returns (ok, reason)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return False, "not a directory"
    manifest = checkpoint_manifest(ckpt_dir)
    if manifest is None:
        return False, "uncommitted (no manifest)"
    depth = (depth or flags.SC_CKPT_VERIFY.get()).lower()
    if depth == "off":
        return True, "ok (manifest only)"
    for rel, meta in manifest.get("files", {}).items():
        p = ckpt_dir / rel
        if not p.is_file():
            return False, f"missing file {rel}"
        if p.stat().st_size != meta.get("bytes"):
            return False, f"size mismatch on {rel}"
        if depth == "digest" and "sha256" in meta and sha256_file(p) != meta["sha256"]:
            return False, f"digest mismatch on {rel}"
    return True, "ok"


def _pod_barrier(tag: str) -> None:
    """Every rank reaches this point (an exchange on the process group's
    store; a no-op in a world of one). It waits the store's own timeout,
    not ``SC_MH_TIMEOUT_MS``: the ranks wait here for rank 0's writes (a
    manifest's digests, a dataset's build), which take as long as they
    take. A failed exchange raises: a commit must not rename a directory
    another rank is still writing into."""
    from sparse_coding__tpu_torch.telemetry.multihost import _kv_allgather, process_info

    if process_info()[1] > 1 and _kv_allgather(tag, "done", store_timeout=True) is None:
        raise RuntimeError(f"pod barrier {tag!r}: a rank did not arrive within the process group's timeout")


def _save_file(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint_tree(ckpt_dir, tree: Dict[str, Any], extra_manifest: Optional[Dict[str, Any]] = None,
                         shards: Optional[Dict[str, Any]] = None) -> Path:
    """Atomically save ``tree`` to ``ckpt_dir``: `torch.save` into a staging
    dir, the manifest beside it, then the rename (the commit point). A kill
    in between leaves only a staging dir, which `latest_checkpoint` never
    considers and `gc_checkpoints` sweeps. In a world of several ranks every
    rank writes its ``shards`` (``{relative path: tree}``) into the staging
    dir, rank 0 writes ``tree``, and rank 0 commits once a barrier shows
    every rank's writes done."""
    from sparse_coding__tpu_torch.telemetry.multihost import process_info

    final = Path(ckpt_dir).absolute()
    final.parent.mkdir(parents=True, exist_ok=True)
    staging = _staging_dir(final)
    idx, count = process_info()
    if idx == 0 and staging.exists():
        shutil.rmtree(staging)
    _pod_barrier("ckpt_staged")  # nobody writes before a stale staging dir is gone
    staging.mkdir(exist_ok=True)
    for rel, obj in (shards or {}).items():
        _save_file(staging / rel, _to_plain(obj))
    if idx == 0:
        _save_file(staging / STATE_FILE, _to_plain(tree))
    fault_point("checkpoint_commit", path=str(final))
    _pod_barrier("ckpt_written")
    if idx == 0:
        _write_manifest(staging, extra=extra_manifest)
        if final.exists():
            shutil.rmtree(final)
        os.replace(staging, final)
    _pod_barrier("ckpt_committed")
    fault_point("checkpoint_committed", path=str(final))
    return final


def _ckpt_index(p: Path) -> Optional[int]:
    try:
        return int(p.name.split("_", 1)[1])
    except (IndexError, ValueError):
        return None


def gc_checkpoints(output_folder, keep: int = 3) -> List[Path]:
    """Keep the newest ``keep`` committed ``ckpt_*`` dirs; delete older
    committed ones, uncommitted (manifest-less) ones and stale staging dirs.
    A save commits its manifest before the rename, so a ``ckpt_*`` without
    one is never a save in flight. Returns the removed paths."""
    root = Path(output_folder)
    if not root.exists() or keep < 1:
        return []
    committed, stale = [], [p for p in root.glob(".staging_ckpt_*") if p.is_dir()]
    for p in root.glob("ckpt_*"):
        if p.is_dir() and (idx := _ckpt_index(p)) is not None:
            if checkpoint_manifest(p) is None:
                stale.append(p)
            else:
                committed.append((idx, p))
    committed.sort()
    removed = [p for _, p in committed[:-keep]] + stale
    for p in removed:
        shutil.rmtree(p, ignore_errors=True)
    return removed


_SHAPE, _SPEC = "shape:", "spec:"


def _encode_spec(spec) -> str:
    return _SPEC + ",".join(a or "-" for a in spec)


def _decode_spec(text: str) -> Tuple:
    body = text[len(_SPEC):]
    return tuple(None if a == "-" else a for a in body.split(",")) if body else ()


def _shape_of(text: str) -> Tuple[int, ...]:
    body = text[len(_SHAPE):]
    return tuple(int(n) for n in body.split(",")) if body else ()


def _sharded_record(ens, name: str):
    """``(description, {relative path: this rank's slice})`` of a sharded
    ensemble: the description (rank 0 writes it) records the mesh, each
    leaf's axis tuple and global shape, and every slice file; a rank writes
    its slice only if no rank before it on the data axis (and, for a
    dictionary left whole, on the dict axis) holds the same one."""
    from sparse_coding__tpu_torch.parallel.mesh import AXES, DATA_AXIS, DICT_AXIS, MODEL_AXIS

    sd = ens.local_state_dict()
    local = sd.pop("local_slice")
    state = sd.pop("state")
    mesh, specs = ens.mesh, local["specs"]
    cut_dict = ens._dict_parallel()

    def global_shape(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        shape = [n * (mesh.shape[spec[d]] if d < len(spec) and spec[d] else 1) for d, n in enumerate(leaf.shape)]
        return _SHAPE + ",".join(str(n) for n in shape)

    files = {f"m{i}_k{j}": f"shards/{name}/m{i}_k{j}.pt" for i in range(mesh.shape[MODEL_AXIS])
             for j in range(mesh.shape[DICT_AXIS] if cut_dict else 1)}
    sd["sharded"] = {
        "mesh": {a: int(mesh.shape[a]) for a in AXES},
        "dict_cut": cut_dict,
        "specs": tree_map(lambda leaf, spec: _encode_spec(spec) if isinstance(leaf, torch.Tensor) else leaf,
                          state, specs),
        "shapes": tree_map(global_shape, state, specs),
        "files": files,
    }
    mine = {}
    if mesh.coords[DATA_AXIS] == 0 and (cut_dict or mesh.coords[DICT_AXIS] == 0):
        mine[files[f"m{mesh.coords[MODEL_AXIS]}_k{mesh.coords[DICT_AXIS] if cut_dict else 0}"]] = state
    return sd, mine


def save_ensemble_checkpoint(ckpt_dir, ensembles: List[Tuple[Any, Dict[str, Any], str]], chunk_cursor: int = 0,
                             extra: Optional[Dict[str, Any]] = None,
                             provenance: Optional[Dict[str, Any]] = None) -> Path:
    """The sweep's whole state: each ensemble's `state_dict` (params,
    buffers, optimizer state, step, the routing flags) and args, and the
    cursor, committed atomically. ``provenance`` rides in the manifest. An
    ensemble sharded over several ranks is written as its ranks' slices
    (every rank must call this)."""
    records, shards = {}, {}
    for ens, _args, name in ensembles:
        mesh = getattr(ens, "mesh", None)
        if mesh is not None and mesh.world_size > 1:
            records[name], mine = _sharded_record(ens, name)
            shards.update(mine)
        else:
            records[name] = ens.state_dict()
    tree = {
        "cursor": {"chunk": int(chunk_cursor), **(extra or {})},
        "ensembles": records,
        "args": {name: args for _ens, args, name in ensembles},
    }
    return save_checkpoint_tree(ckpt_dir, tree, extra_manifest={"provenance": provenance} if provenance else None,
                                shards=shards)


def _assemble(ckpt_dir: Path, sharded: Dict[str, Any], n_models: int, mesh=None, shard_dict: bool = True):
    """The state of a sharded record, assembled for ``mesh`` (this rank's
    part of every leaf by `parallel.mesh.infer_state_specs`' rules) or whole
    (``mesh=None``), from the slice files that overlap it (read by memory
    map: a rank reads only the bytes it keeps)."""
    from sparse_coding__tpu_torch.parallel.mesh import DATA_AXIS, DICT_AXIS, MODEL_AXIS, leaf_slices, spec_for_shape
    from sparse_coding__tpu_torch.utils.tree import tree_paths, tree_unflatten

    saved = sharded["mesh"]
    shapes = [v for _, v in tree_paths(sharded["shapes"])]
    specs = [v for _, v in tree_paths(sharded["specs"])]
    sources = {}
    for key, rel in sharded["files"].items():
        mi, kj = (int(p[1:]) for p in key.split("_"))
        sources[key] = ({MODEL_AXIS: mi, DATA_AXIS: 0, DICT_AXIS: kj}, ckpt_dir / rel)
    loaded: Dict[str, List[Any]] = {}

    def leaves_of(key):
        if key not in loaded:
            obj = torch.load(sources[key][1], map_location="cpu", weights_only=True, mmap=True)
            loaded[key] = [v for _, v in tree_paths(_from_plain(obj, _state_classes()))]
        return loaded[key]

    out = []
    for j, v in enumerate(shapes):
        if not (isinstance(v, str) and v.startswith(_SHAPE)):
            out.append(v)
            continue
        shape = _shape_of(v)
        spec_saved = _decode_spec(specs[j])
        if mesh is None:
            want = tuple(slice(0, n) for n in shape)
        else:
            want = leaf_slices(spec_for_shape(shape, n_models, mesh.shape, shard_dict), shape, mesh.shape,
                               mesh.coords)
        piece = None
        for key, (coords, _path) in sources.items():
            have = leaf_slices(spec_saved, shape, saved, coords)
            lo = [max(w.start, h.start) for w, h in zip(want, have)]
            hi = [min(w.stop, h.stop) for w, h in zip(want, have)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            src = leaves_of(key)[j]
            if piece is None:
                piece = torch.empty(tuple(w.stop - w.start for w in want), dtype=src.dtype)
            dst_ix = tuple(slice(a - w.start, b - w.start) for a, b, w in zip(lo, hi, want))
            src_ix = tuple(slice(a - h.start, b - h.start) for a, b, h in zip(lo, hi, have))
            piece[dst_ix] = src[src_ix]
        out.append(piece)
    return tree_unflatten(sharded["shapes"], out)


def restore_ensemble_checkpoint(ckpt_dir, template: Optional[Dict[str, Any]] = None):
    """The tree `save_ensemble_checkpoint` wrote (tensors on the CPU, the
    state's dataclasses rebuilt), or None when ``ckpt_dir`` does not exist.
    Read with ``weights_only=True``. ``template`` (``{"ensembles": {name:
    state_dict}}`` of the live ensembles) supplies the optimizer kwargs that
    could not be saved (a schedule) and, as ``"mesh"`` / ``"shard_dict"``,
    the mesh each ensemble resumes on: a sharded record is then assembled
    into this rank's slice for that mesh (the record marked
    ``local_slice``, for `Ensemble.from_state(..., mesh=mesh)`), and into
    the whole state without one."""
    ckpt_dir = Path(ckpt_dir).absolute()
    if not ckpt_dir.exists():
        return None
    with open(ckpt_dir / STATE_FILE, "rb") as f:
        tree = _from_plain(torch.load(f, map_location="cpu", weights_only=True), _state_classes())
    live = (template or {}).get("ensembles", {})
    for name, sd in tree.get("ensembles", {}).items():
        sharded = sd.pop("sharded", None)
        if sharded is not None:
            mesh = live.get(name, {}).get("mesh")
            shard_dict = bool(live.get(name, {}).get("shard_dict", True))
            if mesh is not None and mesh.world_size > 1:
                from sparse_coding__tpu_torch.parallel.mesh import infer_state_specs

                whole_shapes = tree_map(lambda v: _ShapeOnly(_shape_of(v)) if isinstance(v, str) and
                                        v.startswith(_SHAPE) else v, sharded["shapes"])
                sd["state"] = _assemble(ckpt_dir, sharded, sd["n_models"], mesh, shard_dict)
                sd["local_slice"] = {"mesh": dict(mesh.shape), "coords": dict(mesh.coords), "shard_dict": shard_dict,
                                     "specs": infer_state_specs(whole_shapes, sd["n_models"], mesh, shard_dict)}
            else:
                sd["state"] = _assemble(ckpt_dir, sharded, sd["n_models"])
        kw = sd.get("optimizer_kwargs", {})
        missing = [k for k, v in kw.items() if v == _CALLABLE]
        if missing and name not in live:
            raise ValueError(f"checkpoint {ckpt_dir}: ensemble {name!r} was saved with callable optimizer kwargs "
                             f"{missing}; restore it with a template that supplies them")
        for k in missing:
            kw[k] = live[name]["optimizer_kwargs"][k]
    return tree


class _ShapeOnly:
    """A leaf that has only a shape (the specs of a state not in memory)."""

    def __init__(self, shape: Tuple[int, ...]):
        self.shape = shape


def latest_checkpoint(output_folder, depth: Optional[str] = None) -> Optional[Path]:
    """The newest committed ``ckpt_*`` dir under ``output_folder`` that
    verifies. Uncommitted, torn or corrupt dirs are skipped with a warning,
    a ``checkpoint.fallback`` counter and an ``anomaly`` event on any live
    telemetry."""
    root = Path(output_folder)
    if not root.exists():
        return None
    ckpts = sorted((p for p in root.glob("ckpt_*") if p.is_dir() and _ckpt_index(p) is not None), key=_ckpt_index)
    for p in reversed(ckpts):
        ok, reason = verify_checkpoint(p, depth=depth)
        if ok:
            return p
        counter_inc_active("checkpoint.fallback")
        event_active("anomaly", kind="checkpoint_fallback", action="warn", checkpoint=p.name, reason=reason)
        warnings.warn(f"skipping checkpoint {p.name}: {reason} (falling back to the previous good checkpoint)",
                      RuntimeWarning)
    return None
