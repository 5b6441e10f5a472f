"""Shared size+sha256 file manifests — ONE verified export format.

A copy of `sparse_coding__tpu/utils/manifest.py` (stdlib only), kept here so
the port never imports the JAX package. `train.checkpoint.save_learned_dicts`
writes the sidecar and `load_learned_dicts` verifies it; the format is the
JAX package's, so exports cross between the two.

A manifest is a JSON object::

    {"format": 1, "created_at": <unix ts>,
     "files": {"<rel path>": {"bytes": <int>, "sha256": "<hex>"}, ...}}

written atomically (same-dir temp + ``os.replace``). Verification checks
existence, byte sizes, and digests of every listed file; entries written
without a digest (size-tier writers) verify at size depth only.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

__all__ = [
    "sha256_file",
    "file_entry",
    "write_manifest",
    "read_manifest",
    "verify_manifest",
    "export_manifest_path",
]

MANIFEST_FORMAT = 1


def sha256_file(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def file_entry(path, digest: bool = True) -> Dict[str, Any]:
    """Manifest entry for one file: byte size (+ sha256 unless ``digest``
    is off — the size tier for multi-GB states where the re-read is
    material)."""
    p = Path(path)
    entry: Dict[str, Any] = {"bytes": p.stat().st_size}
    if digest:
        entry["sha256"] = sha256_file(p)
    return entry


def write_manifest(
    manifest_path,
    files: Dict[str, Any],
    extra: Optional[Dict[str, Any]] = None,
    digest: bool = True,
) -> Path:
    """Hash ``files`` ({rel name: path}) into a manifest at ``manifest_path``,
    committed atomically (temp + ``os.replace`` — a kill mid-write leaves
    the previous manifest or none, never a torn one)."""
    manifest_path = Path(manifest_path)
    manifest = {
        "format": MANIFEST_FORMAT,
        "created_at": time.time(),
        "files": {
            str(rel): file_entry(p, digest=digest) for rel, p in sorted(files.items())
        },
        **(extra or {}),
    }
    manifest_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = manifest_path.with_name(f".{manifest_path.name}.tmp{os.getpid()}")
    try:
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, manifest_path)
    finally:
        tmp.unlink(missing_ok=True)
    return manifest_path


def read_manifest(manifest_path) -> Optional[Dict[str, Any]]:
    """The manifest dict, or None when absent/unreadable (legacy export)."""
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return manifest if isinstance(manifest, dict) else None


def verify_manifest(
    manifest_path,
    base_dir=None,
    require_nonempty: bool = True,
) -> Tuple[bool, str]:
    """Does every file listed in the manifest match its recorded size and
    digest? Returns ``(ok, reason)``. ``base_dir`` resolves the relative
    entries (default: the manifest's own directory)."""
    manifest_path = Path(manifest_path)
    manifest = read_manifest(manifest_path)
    if manifest is None:
        return False, "no manifest"
    base = Path(base_dir) if base_dir is not None else manifest_path.parent
    files = manifest.get("files", {})
    if require_nonempty and not files:
        return False, "manifest lists no files"
    for rel, meta in files.items():
        p = base / rel
        if not p.is_file():
            return False, f"missing file {rel}"
        if p.stat().st_size != meta.get("bytes"):
            return False, f"size mismatch on {rel}"
        # entries written at the size tier carry no digest — size-only check
        if "sha256" in meta and sha256_file(p) != meta["sha256"]:
            return False, f"digest mismatch on {rel}"
    return True, "ok"


def export_manifest_path(export_path) -> Path:
    """Sidecar manifest name for a single-file export: ``<file>.manifest.json``
    (the format `save_learned_dicts` emits and `serve.registry` /
    `load_learned_dicts` verify)."""
    p = Path(export_path)
    return p.with_name(p.name + ".manifest.json")
