"""Serving-side dictionary registry: verified loads, hot swap, int8 residency.

Counterpart of the JAX package's `serve/registry.py`. The registry is the
serving process's record of which dictionaries exist and what bytes back
them:

  - **Verified loads.** `load_export` takes a ``learned_dicts.pkl`` (held
    to its sidecar manifest by `train.checkpoint.load_learned_dicts(verify=
    True)`; a legacy export without one loads with a warning) or a plain
    directory of them. A fleet run directory (``export_manifest.json``) is
    verified whole first (`fleet.worker.verify_export`), then its pickles
    load without re-hashing.
  - **Hot add/swap/remove** under a lock, each bumping ``generation``; the
    engine re-reads the registry when the generation moves.
  - **int8 residency.** ``weights="int8"`` quantizes every 2-D floating leaf
    by the chunk store's symmetric per-row absmax tier
    (`data.chunks.quantize_rows_int8`, bf16 leaves included); the engine
    dequantizes per micro-batch.

Dicts whose `group_key_of` agree (class, static fields, every array leaf's
shape and dtype: `metrics.standard.group_stackable_dicts`'s rule) share the
engine's lanes. A registry also holds `SubjectLM` entries, the subject
model whose activations ``POST /features`` captures before encoding.

Every tensor the registry makes lives on its ``device`` (None = cuda).
"""

from __future__ import annotations

import threading
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from sparse_coding__tpu_torch.models.learned_dict import dict_leaves, stack_key
from sparse_coding__tpu_torch.utils.device import resolve_device

__all__ = ["ServedDict", "SubjectLM", "DictRegistry", "group_key_of"]


def group_key_of(ld) -> Tuple:
    """The stacking key (`models.learned_dict.stack_key`: class, static
    fields, every array leaf's shape and dtype); dicts with equal keys share
    the engine's lanes. An unregistered dict is a group of its own."""
    return stack_key(ld) or ("unregistered", id(ld))


def _quantize_leaf(leaf, device):
    """The int8-resident form of one leaf: 2-D floating leaves get the chunk
    store's symmetric per-row absmax tier; biases, scalars and keys stay as
    they are. Floating-ness is torch's, so bf16 leaves (the training dtype)
    are quantized too. Quantized from f32 (bf16 and f16 widen exactly); the
    stored dtype name restores the native dtype at dequant time."""
    from sparse_coding__tpu_torch.data.chunks import quantize_rows_int8

    if not isinstance(leaf, torch.Tensor) or leaf.ndim != 2 or not leaf.is_floating_point() or not leaf.numel():
        return None
    q, scales = quantize_rows_int8(leaf.detach().float().cpu().numpy())
    return {"q": torch.from_numpy(q).to(device), "scales": torch.from_numpy(scales).to(device),
            "dtype": str(leaf.dtype).rpartition(".")[2]}


class ServedDict:
    """One registered dictionary: the LearnedDict, its serving metadata and,
    int8-resident, the quantized leaves (`dict_leaves` order; None where a
    leaf stays as it is)."""

    __slots__ = ("dict_id", "ld", "hyperparams", "source", "weights", "group_key", "quant_leaves", "n_feats",
                 "activation_size")

    def __init__(self, dict_id: str, ld, hyperparams=None, source=None, weights: str = "native", device=None):
        if weights not in ("native", "int8"):
            raise ValueError(f"unknown weights residency {weights!r}")
        self.dict_id = str(dict_id)
        self.ld = ld
        self.hyperparams = dict(hyperparams or {})
        self.source = None if source is None else str(source)
        self.weights = weights
        self.n_feats = int(getattr(ld, "n_feats", 0))
        self.activation_size = int(getattr(ld, "activation_size", 0))
        leaves = dict_leaves(ld)
        self.quant_leaves: Optional[List[Any]] = None
        if weights == "int8":
            if not leaves:
                raise ValueError(f"{type(ld).__name__} has no array leaves to quantize — "
                                 "int8 residency needs weight-bearing dictionaries")
            self.quant_leaves = [_quantize_leaf(t, device) for _, _, t in leaves]
        # the key of the SERVED form: int8 residency dequantizes back to the
        # native shapes and dtypes, so int8 and native dicts of one geometry
        # share the key but never lanes (the engine groups by key and weights)
        self.group_key = group_key_of(ld)

    def describe(self) -> Dict[str, Any]:
        return {"dict": self.dict_id, "class": type(self.ld).__name__, "n_feats": self.n_feats,
                "activation_size": self.activation_size, "weights": self.weights,
                "hyperparams": self.hyperparams, "source": self.source}


class SubjectLM:
    """One attached subject language model and its capture point: the
    harvest's geometry (`lm.model.make_tensor_name`, early exit at
    ``layer + 1``, fp16 on the device), so ``/features`` equals
    harvest-then-encode. ``tokenize`` (optional ``text -> List[int]``) lets
    ``/features`` take texts."""

    __slots__ = ("subject_id", "params", "lm_cfg", "layer", "layer_loc", "tensor_name", "stop_at",
                 "activation_size", "tokenize", "source")

    def __init__(self, subject_id: str, params, lm_cfg, layer: int, layer_loc: str = "residual", tokenize=None,
                 source=None):
        from sparse_coding__tpu_torch.lm import model as lm_model

        self.subject_id = str(subject_id)
        self.params = params
        self.lm_cfg = lm_cfg
        self.layer = int(layer)
        self.layer_loc = str(layer_loc)
        self.tensor_name = lm_model.make_tensor_name(self.layer, self.layer_loc)
        self.stop_at = self.layer + 1
        self.activation_size = int(lm_model.get_activation_size(lm_cfg, self.layer_loc))
        self.tokenize = tokenize
        self.source = None if source is None else str(source)

    def describe(self) -> Dict[str, Any]:
        return {"subject": self.subject_id, "arch": self.lm_cfg.arch, "n_layers": self.lm_cfg.n_layers,
                "d_model": self.lm_cfg.d_model, "layer": self.layer, "layer_loc": self.layer_loc,
                "hook": self.tensor_name, "activation_size": self.activation_size,
                "vocab_size": int(self.lm_cfg.vocab_size), "n_ctx": int(self.lm_cfg.n_ctx),
                "tokenizes": self.tokenize is not None, "source": self.source}


class DictRegistry:
    """Thread-safe id → `ServedDict` map with the generation counter the
    engine watches, and the attached `SubjectLM` entries. ``device`` (None =
    cuda) is where loads and int8 residency put their tensors and where the
    engine runs."""

    def __init__(self, telemetry=None, device=None):
        self.telemetry = telemetry
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._dicts: Dict[str, ServedDict] = {}
        self._subjects: Dict[str, SubjectLM] = {}
        # dict id -> export-manifest content digest: the lineage join key
        # `provenance_digest` folds into X-Dict-Provenance
        self._manifest_digests: Dict[str, Optional[str]] = {}
        self.generation = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._dicts)

    def _event(self, etype: str, **fields):
        if self.telemetry is not None:
            self.telemetry.event(etype, **fields)

    # -- mutation --------------------------------------------------------------

    def add(self, dict_id: str, ld, hyperparams=None, source=None, weights: str = "native",
            manifest_digest: Optional[str] = None) -> ServedDict:
        """Register a new dictionary; an id already taken raises (use `swap`)."""
        entry = ServedDict(dict_id, ld, hyperparams=hyperparams, source=source, weights=weights, device=self.device)
        with self._lock:
            if entry.dict_id in self._dicts:
                raise ValueError(f"dict id {entry.dict_id!r} already registered (use swap to replace it)")
            self._dicts[entry.dict_id] = entry
            self._manifest_digests[entry.dict_id] = manifest_digest
            self.generation += 1
            gen = self.generation
        self._event("serve_dict_added", dict=entry.dict_id, weights=weights, source=entry.source, generation=gen,
                    manifest_digest=manifest_digest)
        return entry

    def swap(self, dict_id: str, ld, hyperparams=None, source=None, weights: str = "native",
             manifest_digest: Optional[str] = None) -> ServedDict:
        """Replace an existing dictionary atomically: requests drained after
        the swap encode through the new weights."""
        entry = ServedDict(dict_id, ld, hyperparams=hyperparams, source=source, weights=weights, device=self.device)
        with self._lock:
            if entry.dict_id not in self._dicts:
                raise KeyError(f"dict id {entry.dict_id!r} not registered")
            self._dicts[entry.dict_id] = entry
            self._manifest_digests[entry.dict_id] = manifest_digest
            self.generation += 1
            gen = self.generation
        self._event("serve_dict_swapped", dict=entry.dict_id, weights=weights, source=entry.source, generation=gen,
                    manifest_digest=manifest_digest)
        return entry

    def remove(self, dict_id: str) -> None:
        with self._lock:
            if dict_id not in self._dicts:
                raise KeyError(f"dict id {dict_id!r} not registered")
            del self._dicts[dict_id]
            self._manifest_digests.pop(dict_id, None)
            self.generation += 1
            gen = self.generation
        self._event("serve_dict_removed", dict=dict_id, generation=gen)

    def provenance_digest(self) -> Optional[str]:
        """One short digest over the sorted (dict id, export digest) pairs of
        everything registered: the ``X-Dict-Provenance`` header; None while
        the registry is empty."""
        from sparse_coding__tpu_torch.telemetry.provenance import config_digest

        with self._lock:
            if not self._dicts:
                return None
            pairs = sorted((did, self._manifest_digests.get(did)) for did in self._dicts)
        return config_digest(pairs)[:12]

    # -- subject LMs -------------------------------------------------------------

    def attach_subject(self, subject_id: str, params, lm_cfg, layer: int, layer_loc: str = "residual",
                       tokenize=None, source=None) -> SubjectLM:
        """Attach a subject LM and capture point for ``/features``."""
        entry = SubjectLM(subject_id, params, lm_cfg, layer, layer_loc=layer_loc, tokenize=tokenize, source=source)
        with self._lock:
            if entry.subject_id in self._subjects:
                raise ValueError(f"subject id {entry.subject_id!r} already attached")
            self._subjects[entry.subject_id] = entry
            self.generation += 1
        self._event("serve_subject_attached", subject=entry.subject_id, layer=entry.layer,
                    layer_loc=entry.layer_loc, activation_size=entry.activation_size)
        return entry

    def detach_subject(self, subject_id: str) -> None:
        with self._lock:
            if subject_id not in self._subjects:
                raise KeyError(f"subject id {subject_id!r} not attached")
            del self._subjects[subject_id]
            self.generation += 1
        self._event("serve_subject_detached", subject=subject_id)

    def get_subject(self, subject_id: Optional[str] = None) -> SubjectLM:
        """``subject_id=None`` resolves the registry's sole subject."""
        with self._lock:
            if subject_id is not None:
                entry = self._subjects.get(str(subject_id))
                if entry is None:
                    raise KeyError(f"subject id {subject_id!r} not attached")
                return entry
            if not self._subjects:
                raise KeyError("no subject LM attached (see attach_subject)")
            if len(self._subjects) > 1:
                raise KeyError(f"multiple subjects attached — name one: {sorted(self._subjects)}")
            return next(iter(self._subjects.values()))

    def subjects(self) -> List[str]:
        with self._lock:
            return sorted(self._subjects)

    def describe_subjects(self) -> List[Dict[str, Any]]:
        with self._lock:
            entries = list(self._subjects.values())
        return [e.describe() for e in sorted(entries, key=lambda e: e.subject_id)]

    # -- reads -----------------------------------------------------------------

    def get(self, dict_id: str) -> ServedDict:
        with self._lock:
            entry = self._dicts.get(dict_id)
        if entry is None:
            raise KeyError(f"dict id {dict_id!r} not registered")
        return entry

    def __contains__(self, dict_id: str) -> bool:
        with self._lock:
            return dict_id in self._dicts

    def ids(self) -> List[str]:
        with self._lock:
            return sorted(self._dicts)

    def describe(self) -> List[Dict[str, Any]]:
        with self._lock:
            entries = list(self._dicts.values())
        return [e.describe() for e in sorted(entries, key=lambda e: e.dict_id)]

    def snapshot(self) -> Tuple[int, Dict[str, ServedDict]]:
        """(generation, id → entry) under one lock hold: what the engine
        builds its lanes from. The dict is a copy; entries are immutable."""
        with self._lock:
            return self.generation, dict(self._dicts)

    # -- export loading --------------------------------------------------------

    def load_export(self, path, dict_ids: Optional[List[str]] = None, weights: str = "native",
                    prefix: Optional[str] = None) -> List[str]:
        """Load a learned-dict export; the registered ids in export order.

        ``path`` is one ``learned_dicts.pkl`` (held to its sidecar manifest;
        a legacy export without one warns) or a directory whose every
        ``learned_dicts.pkl`` loads: a fleet run dir's (one with
        ``export_manifest.json``) held to that manifest as a whole, any other
        directory's each to its own sidecar.
        ``dict_ids`` overrides the generated ids (``<stem or prefix>:<i>``).
        Nothing registers unless everything loads and checks out."""
        from sparse_coding__tpu_torch.telemetry.provenance import export_digest
        from sparse_coding__tpu_torch.train.checkpoint import export_manifest_path, load_learned_dicts

        path = Path(path)
        dir_verified = False
        if path.is_dir():
            from sparse_coding__tpu_torch.fleet.worker import EXPORT_MANIFEST, verify_export

            if (path / EXPORT_MANIFEST).is_file():
                ok, reason = verify_export(path)
                if not ok:
                    raise ValueError(f"export dir {path} failed manifest verification: {reason}")
                dir_verified = True
            pkls = sorted(path.rglob("learned_dicts.pkl"))
            if not pkls:
                raise FileNotFoundError(f"no learned_dicts.pkl under {path}")
        elif path.is_file():
            pkls = [path]
        else:
            raise FileNotFoundError(path)

        loaded: List[Tuple[Path, int, Any, Dict[str, Any]]] = []
        for pkl in pkls:
            if dir_verified:  # the dir's manifest digest-verified every pkl already
                records = load_learned_dicts(pkl, verify=False, device=self.device)
            elif export_manifest_path(pkl).is_file():
                records = load_learned_dicts(pkl, verify=True, device=self.device)
            else:
                warnings.warn(f"legacy learned-dict export {pkl} has no sidecar manifest: loaded unverified",
                              RuntimeWarning)
                records = load_learned_dicts(pkl, verify=False, device=self.device)
            for within, (ld, hp) in enumerate(records):
                loaded.append((pkl, within, ld, hp))
        if dict_ids is not None:
            if len(dict_ids) < len(loaded):
                raise ValueError(f"dict_ids lists {len(dict_ids)} ids but the export holds {len(loaded)} dictionaries")
            if len(dict_ids) > len(loaded):
                warnings.warn(f"dict_ids lists {len(dict_ids)} ids but the export holds only {len(loaded)} "
                              "dictionaries", RuntimeWarning)
        planned: List[str] = []
        for next_id, (pkl, within, _ld, _hp) in enumerate(loaded):
            if dict_ids is not None:
                planned.append(str(dict_ids[next_id]))
            else:
                base = prefix if prefix is not None else (pkl.parent.name if len(pkls) > 1 else pkl.stem)
                planned.append(f"{base}:{within}")
        taken = [d for d in planned if d in self or planned.count(d) > 1]
        if taken:
            raise ValueError(f"export ids already registered or duplicated: {sorted(set(taken))}")
        for did, (pkl, _within, ld, hp) in zip(planned, loaded):
            self.add(did, ld, hyperparams=hp, source=pkl, weights=weights, manifest_digest=export_digest(pkl))
        return planned
