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

# models.topk and models.fista register TopKLearnedDict and Fista: imported
# so that a process that imports only this module loads their exports too
from sparse_coding__tpu_torch.models import fista as _fista  # noqa: F401
from sparse_coding__tpu_torch.models import topk as _topk  # noqa: F401
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
    """An array field as the record holds it: tensors as numpy arrays, a dict
    of them (`ThresholdingSAE_export.params`) as a dict of arrays."""
    if isinstance(v, dict):
        return {k: _to_numpy(x) for k, x in v.items()}
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def _from_numpy(v, device):
    if isinstance(v, dict):
        return {k: _from_numpy(x, device) for k, x in v.items()}
    return torch.from_numpy(np.array(v)).to(device)


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
    from sparse_coding__tpu_torch.utils.optim import AdamState, QuantMoment, SgdState

    return {c.__name__: c for c in (EnsembleState, AdamState, QuantMoment, SgdState)}


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


def save_checkpoint_tree(ckpt_dir, tree: Dict[str, Any], extra_manifest: Optional[Dict[str, Any]] = None) -> Path:
    """Atomically save ``tree`` to ``ckpt_dir``: `torch.save` into a staging
    dir, the manifest beside it, then the rename (the commit point). A kill
    in between leaves only a staging dir, which `latest_checkpoint` never
    considers and `gc_checkpoints` sweeps."""
    final = Path(ckpt_dir).absolute()
    final.parent.mkdir(parents=True, exist_ok=True)
    staging = _staging_dir(final)
    if staging.exists():
        shutil.rmtree(staging)
    staging.mkdir()
    with open(staging / STATE_FILE, "wb") as f:
        torch.save(_to_plain(tree), f)
        f.flush()
        os.fsync(f.fileno())
    fault_point("checkpoint_commit", path=str(final))
    _write_manifest(staging, extra=extra_manifest)
    if final.exists():
        shutil.rmtree(final)
    os.replace(staging, final)
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


def save_ensemble_checkpoint(ckpt_dir, ensembles: List[Tuple[Any, Dict[str, Any], str]], chunk_cursor: int = 0,
                             extra: Optional[Dict[str, Any]] = None,
                             provenance: Optional[Dict[str, Any]] = None) -> Path:
    """The sweep's whole state: each ensemble's `state_dict` (params,
    buffers, optimizer state, step, the routing flags) and args, and the
    cursor, committed atomically. ``provenance`` rides in the manifest."""
    tree = {
        "cursor": {"chunk": int(chunk_cursor), **(extra or {})},
        "ensembles": {name: ens.state_dict() for ens, _args, name in ensembles},
        "args": {name: args for _ens, args, name in ensembles},
    }
    return save_checkpoint_tree(ckpt_dir, tree, extra_manifest={"provenance": provenance} if provenance else None)


def restore_ensemble_checkpoint(ckpt_dir, template: Optional[Dict[str, Any]] = None):
    """The tree `save_ensemble_checkpoint` wrote (tensors on the CPU, the
    state's dataclasses rebuilt), or None when ``ckpt_dir`` does not exist.
    Read with ``weights_only=True``. ``template`` (``{"ensembles": {name:
    state_dict}}`` of the live ensembles) supplies the optimizer kwargs that
    could not be saved (a schedule)."""
    ckpt_dir = Path(ckpt_dir).absolute()
    if not ckpt_dir.exists():
        return None
    with open(ckpt_dir / STATE_FILE, "rb") as f:
        tree = _from_plain(torch.load(f, map_location="cpu", weights_only=True), _state_classes())
    live = (template or {}).get("ensembles", {})
    for name, sd in tree.get("ensembles", {}).items():
        kw = sd.get("optimizer_kwargs", {})
        missing = [k for k, v in kw.items() if v == _CALLABLE]
        if missing and name not in live:
            raise ValueError(f"checkpoint {ckpt_dir}: ensemble {name!r} was saved with callable optimizer kwargs "
                             f"{missing}; restore it with a template that supplies them")
        for k in missing:
            kw[k] = live[name]["optimizer_kwargs"][k]
    return tree


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
