"""Learned-dict exports: `save_learned_dicts` / `load_learned_dicts`.

Counterpart of the export half of `sparse_coding__tpu/train/checkpoint.py`,
in the same on-disk format: a pickle of ``{class, arrays, statics,
hyperparams}`` records (numpy arrays, fields by name), written atomically
(same-dir temp + ``os.replace``) with a ``<name>.manifest.json`` sidecar
(bytes + sha256, `utils.manifest`). The loader maps class names through the
port's own registry (`models.learned_dict.LEARNED_DICT_CLASSES`), so exports
written by the JAX package load here without importing it.
"""

from __future__ import annotations

import os
import pickle
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# models.topk registers TopKLearnedDict: imported so that a process that
# imports only this module loads TopK exports too
from sparse_coding__tpu_torch.models import topk as _topk  # noqa: F401
from sparse_coding__tpu_torch.models.learned_dict import (
    LEARNED_DICT_CLASSES,
    LEARNED_DICT_REGISTRY,
)
from sparse_coding__tpu_torch.utils.device import resolve_device
from sparse_coding__tpu_torch.utils.manifest import (
    export_manifest_path,
    verify_manifest,
    write_manifest,
)

_WARNED_LEGACY_EXPORTS: set = set()


def _to_numpy(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def save_learned_dicts(path, learned_dicts: List[Tuple[Any, Dict[str, Any]]]):
    """Save a ``[(LearnedDict, hyperparams), ...]`` list, atomically, with
    the sidecar manifest."""
    records = []
    for ld, hyperparams in learned_dicts:
        if type(ld) not in LEARNED_DICT_REGISTRY:
            raise TypeError(f"{type(ld).__name__} is not a registered LearnedDict")
        array_fields, static_fields = LEARNED_DICT_REGISTRY[type(ld)]
        records.append({
            "class": f"{type(ld).__module__}.{type(ld).__qualname__}",
            "arrays": {f: _to_numpy(getattr(ld, f)) for f in array_fields},
            "statics": {f: getattr(ld, f, None) for f in static_fields},
            "hyperparams": hyperparams,
        })
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
    write_manifest(export_manifest_path(path), {path.name: path})


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
            setattr(ld, f, torch.from_numpy(np.array(v)).to(device))
        for f, v in rec["statics"].items():
            setattr(ld, f, v)
        out.append((ld, rec["hyperparams"]))
    return out
