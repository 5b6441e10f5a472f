"""Chunk-store integrity: verify tiers, quarantine, and the loss budget.

Counterpart of `sparse_coding__tpu/data/integrity.py` (its read side), in
the same on-disk layout, so a store quarantined by either package reads the
same in the other:

- **Verify.** `verify_chunk` checks chunk ``i`` against its commit manifest
  ``sc_chunk.<i>.json`` at a depth from ``SC_CHUNK_VERIFY``: ``size``
  (default: existence + byte sizes), ``digest`` (+ sha256) or ``off``.
  Manifest-less (legacy) chunks pass unless quantized bytes lack their
  scale file.
- **Quarantine.** A chunk that fails is moved into ``<store>/quarantine/``
  with a ``sc_quarantine.<i>.json`` record, never deleted; a ``data.corrupt``
  counter and a ``chunk_corrupt`` anomaly event land on any live telemetry,
  and the load raises `CorruptChunk`.
- **Degraded mode.** Drivers skip a `CorruptChunk` against a
  `ChunkLossBudget` (``SC_CHUNK_LOSS_BUDGET``, default 5% of distinct
  chunks); past it the budget raises `train.preemption.ResumableAbort`
  (exit 75).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from sparse_coding__tpu_torch.telemetry.events import counter_inc_active, event_active
from sparse_coding__tpu_torch.utils import flags
from sparse_coding__tpu_torch.utils.manifest import sha256_file

CHUNK_VERIFY_ENV = flags.SC_CHUNK_VERIFY.name
LOSS_BUDGET_ENV = flags.SC_CHUNK_LOSS_BUDGET.name
DEFAULT_LOSS_BUDGET = 0.05
QUARANTINE_DIR = "quarantine"
_QUANT_DTYPES = ("int8", "uint8")  # on-disk dtypes that need a scale file


class CorruptChunk(RuntimeError):
    """A chunk that failed verification, already quarantined by the raiser.
    Drivers skip it within the loss budget; it never becomes training data."""

    def __init__(self, store, chunk: int, reason: str):
        super().__init__(f"chunk {chunk} of {store} is corrupt: {reason}")
        self.store = str(store)
        self.chunk = int(chunk)
        self.reason = reason


def chunk_path(folder, i: int) -> Path:
    return Path(folder) / f"{i}.npy"


def scale_path(folder, i: int) -> Path:
    """Per-row dequantization scales of a quantized chunk (absent for fp16)."""
    return Path(folder) / f"{i}.scale.npy"


def chunk_manifest_path(folder, i: int) -> Path:
    return Path(folder) / f"sc_chunk.{int(i)}.json"


def verify_depth(depth: Optional[str] = None) -> str:
    """Explicit depth > ``SC_CHUNK_VERIFY`` > ``size``."""
    d = (depth or flags.SC_CHUNK_VERIFY.get()).lower()
    if d not in ("digest", "size", "off"):
        raise ValueError(f"unknown {CHUNK_VERIFY_ENV} depth {d!r} (digest | size | off)")
    return d


def default_loss_budget() -> float:
    raw = flags.SC_CHUNK_LOSS_BUDGET.raw()
    return DEFAULT_LOSS_BUDGET if raw is None or raw == "" else float(raw)


def write_json_atomic(path: Path, obj: Dict[str, Any]) -> Path:
    """Same-dir temp + `os.replace`: the previous file or the new one, never
    a torn one."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.tmp{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def write_chunk_manifest(folder, i: int, files: Dict[str, Path], rows: int, shape, store_dtype: str,
                         provenance: Optional[Dict[str, Any]] = None) -> Path:
    """Commit chunk ``i``: hash its landed data files and replace the
    manifest onto its final name, the one atomic commit point of the
    chunk-pair write (`data.chunks.save_chunk`). Digests are always recorded
    (``SC_CHUNK_VERIFY`` tunes reads only). The JAX package's manifest, key
    for key."""
    manifest = {
        "format": 1,
        "chunk": int(i),
        "created_at": time.time(),
        "rows": int(rows),
        "shape": [int(s) for s in shape],
        "store_dtype": str(store_dtype),
        "files": {name: {"bytes": Path(p).stat().st_size, "sha256": sha256_file(Path(p))}
                  for name, p in files.items()},
    }
    if provenance:
        manifest["provenance"] = provenance
    return write_json_atomic(chunk_manifest_path(folder, i), manifest)


def read_chunk_manifest(folder, i: int) -> Optional[Dict[str, Any]]:
    try:
        with open(chunk_manifest_path(folder, i)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def npy_header(path: Path):
    """(shape, dtype) from a .npy header through numpy's public format API."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        read = np.lib.format.read_array_header_1_0 if version == (1, 0) else np.lib.format.read_array_header_2_0
        shape, _, dtype = read(f)
    return shape, dtype


def verify_chunk(folder, i: int, depth: Optional[str] = None) -> Tuple[bool, str]:
    """Is chunk ``i`` committed and intact at ``depth``? (ok, reason)."""
    folder = Path(folder)
    depth = verify_depth(depth)
    cp = chunk_path(folder, i)
    manifest = read_chunk_manifest(folder, i)
    if manifest is None:
        if not cp.is_file():
            return False, "missing chunk file"
        if depth == "off":
            return True, "ok (verification off)"
        try:
            _, dtype = npy_header(cp)
        except (OSError, ValueError) as e:
            return False, f"unreadable npy header: {e}"
        if dtype.name in _QUANT_DTYPES and not scale_path(folder, i).is_file():
            return False, f"quantized ({dtype.name}) chunk bytes with no scale file — torn pair (legacy, no manifest)"
        return True, "ok (legacy, no manifest)"
    if depth == "off":
        return True, "ok (verification off)"
    for rel, meta in manifest.get("files", {}).items():
        p = folder / rel
        if not p.is_file():
            return False, f"missing file {rel}"
        if p.stat().st_size != meta.get("bytes"):
            return False, f"size mismatch on {rel}"
        if depth == "digest" and "sha256" in meta and sha256_file(p) != meta["sha256"]:
            return False, f"digest mismatch on {rel}"
    sp = scale_path(folder, i)
    if sp.is_file() and sp.name not in manifest.get("files", {}):
        return False, f"stray scale file {sp.name} not in manifest"
    return True, "ok"


def _quarantine_root(folder) -> Path:
    return Path(folder) / QUARANTINE_DIR


def is_quarantined(folder, i: int) -> bool:
    q = _quarantine_root(folder)
    return (q / f"{int(i)}.npy").exists() or (q / f"sc_quarantine.{int(i)}.json").exists()


def quarantined_indices(folder) -> List[int]:
    q = _quarantine_root(folder)
    if not q.is_dir():
        return []
    idx = set()
    for p in q.iterdir():
        if p.suffix == ".npy" and p.stem.isdigit():
            idx.add(int(p.stem))
        elif p.name.startswith("sc_quarantine.") and p.suffix == ".json":
            mid = p.name[len("sc_quarantine."):-len(".json")]
            if mid.isdigit():
                idx.add(int(mid))
    return sorted(idx)


def quarantined_rows(folder, i: int) -> Optional[int]:
    """Rows of a quarantined chunk (its manifest, else its npy header), or
    None when neither can be read."""
    q = _quarantine_root(folder)
    try:
        with open(q / f"sc_chunk.{int(i)}.json") as f:
            manifest = json.load(f)
        if isinstance(manifest.get("rows"), int):
            return manifest["rows"]
    except (OSError, json.JSONDecodeError):
        pass
    try:
        shape, _ = npy_header(q / f"{int(i)}.npy")
        return int(shape[0])
    except (OSError, ValueError, IndexError):
        return None


def quarantine_chunk(folder, i: int, reason: str) -> List[Path]:
    """Move chunk ``i``'s files (data, scale, manifest) into
    ``<store>/quarantine/`` and record why. Idempotent."""
    folder = Path(folder)
    q = _quarantine_root(folder)
    q.mkdir(parents=True, exist_ok=True)
    moved: List[Path] = []
    for p in (chunk_path(folder, i), scale_path(folder, i), chunk_manifest_path(folder, i)):
        if p.is_file():
            dst = q / p.name
            os.replace(p, dst)
            moved.append(dst)
    write_json_atomic(q / f"sc_quarantine.{int(i)}.json",
                      {"chunk": int(i), "reason": reason, "quarantined_at": time.time(),
                       "files": [p.name for p in moved]})
    counter_inc_active("data.corrupt")
    event_active("anomaly", kind="chunk_corrupt", action="quarantine", chunk=int(i), reason=reason,
                 store=str(folder))
    return moved


class ChunkLossBudget:
    """How much of the dataset a run may lose to quarantine. `skip` counts
    distinct chunks (and their rows) and raises `ResumableAbort` once the
    lost fraction exceeds ``budget_frac`` (``SC_CHUNK_LOSS_BUDGET``). The
    counters, gauge and events go to ``telemetry``, or with None to every
    live `RunTelemetry` (library callers still account)."""

    def __init__(self, n_chunks: int, budget_frac: Optional[float] = None, telemetry=None):
        self.n_chunks = max(1, int(n_chunks))
        self.budget_frac = default_loss_budget() if budget_frac is None else float(budget_frac)
        self.telemetry = telemetry
        self.skipped_chunks: set = set()
        self.rows_skipped = 0
        self._gauge(self.budget_frac)

    def _counter(self, name: str, n: int = 1) -> None:
        if self.telemetry is not None:
            self.telemetry.counter_inc(name, n)
        else:
            counter_inc_active(name, n)

    def _gauge(self, remaining: float) -> None:
        from sparse_coding__tpu_torch.telemetry.events import gauge_set_active

        if self.telemetry is not None:
            self.telemetry.gauge_set("data.budget_remaining_frac", remaining)
        else:
            gauge_set_active("data.budget_remaining_frac", remaining)

    def _event(self, etype: str, **fields) -> None:
        if self.telemetry is not None:
            self.telemetry.event(etype, **fields)
        else:
            event_active(etype, **fields)

    @property
    def loss_frac(self) -> float:
        return len(self.skipped_chunks) / self.n_chunks

    @property
    def remaining_frac(self) -> float:
        return max(0.0, self.budget_frac - self.loss_frac)

    @property
    def exceeded(self) -> bool:
        return self.loss_frac > self.budget_frac

    def skip(self, chunk: int, reason: str, rows: Optional[int] = None) -> None:
        """Account one skipped chunk; raise `ResumableAbort` past the budget."""
        self.skipped_chunks.add(int(chunk))
        if rows:
            self.rows_skipped += int(rows)
            self._counter("data.rows_skipped", int(rows))
        self._counter("data.chunks_skipped")
        self._gauge(self.remaining_frac)
        self._event("chunk_skipped", chunk=int(chunk), reason=reason, rows=rows,
                    loss_frac=round(self.loss_frac, 4), budget_frac=self.budget_frac)
        if self.exceeded:
            from sparse_coding__tpu_torch.train.preemption import ResumableAbort

            self._counter("data.budget_exhausted")
            self._event("loss_budget_exhausted", chunks_lost=sorted(self.skipped_chunks),
                        loss_frac=round(self.loss_frac, 4), budget_frac=self.budget_frac)
            raise ResumableAbort(
                f"chunk loss budget exhausted: {len(self.skipped_chunks)}/{self.n_chunks} chunks lost "
                f"({self.loss_frac:.1%} > {self.budget_frac:.1%} {LOSS_BUDGET_ENV}); scrub/repair the store and resume"
            )
