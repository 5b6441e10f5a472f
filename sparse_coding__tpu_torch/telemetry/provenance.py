"""Producer identity and content digests for checkpoint and export manifests.

The part of `sparse_coding__tpu/telemetry/provenance.py` that the sweep
stamps into its manifests, with the same digests, so the JAX package's
lineage graph joins the port's artifacts by the same keys. Building that
graph is not ported.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any, Dict, Optional

SIDECAR_SUFFIX = ".manifest.json"


def config_digest(config: Any) -> str:
    """16-hex sha256 over canonical (sorted-key, compact) JSON."""
    blob = json.dumps(config, sort_keys=True, separators=(",", ":"), default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def manifest_files_digest(files: Dict[str, Any]) -> Optional[str]:
    """Content digest of a manifest's ``files`` table ({name: sha256})."""
    shas = {str(name): e.get("sha256") or e.get("bytes") for name, e in files.items() if isinstance(e, dict)}
    return config_digest(shas) if shas else None


def _read_json(path: Path) -> Optional[Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def export_digest(export_path) -> Optional[str]:
    """Content digest of a single-file export from its sidecar manifest."""
    p = Path(export_path)
    man = _read_json(p.with_name(p.name + SIDECAR_SUFFIX))
    return manifest_files_digest(man.get("files") or {}) if isinstance(man, dict) else None


def producer_identity(config: Any = None, fingerprint: Optional[Dict[str, Any]] = None,
                      run_dir=None) -> Dict[str, Any]:
    """The ``provenance`` block manifests carry: who wrote the artifact (the
    fingerprint's git sha, torch and device), from what config, in which
    run directory."""
    ident: Dict[str, Any] = {"format": 1}
    if fingerprint:
        ident["fingerprint"] = {k: fingerprint[k] for k in ("git_sha", "torch", "backend", "device_kind")
                                if fingerprint.get(k) is not None}
    if config is not None:
        ident["config_sha"] = config_digest(config)
    if run_dir is not None:
        ident["run_dir"] = str(run_dir)
    return ident
