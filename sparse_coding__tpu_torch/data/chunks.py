"""On-disk activation chunk store: the fp16 tier and the int8/int4 tiers.

Counterpart of `sparse_coding__tpu/data/chunks.py`: a folder of numbered
``<i>.npy`` chunks, each ``[rows, d]``, committed by a per-chunk manifest
``sc_chunk.<i>.json`` (byte sizes + sha256 + rows/shape/dtype) that lands
last with an atomic ``os.replace``. Tiers, as in the JAX package:
  - float16 (the default);
  - int8: per-row symmetric absmax codes with an f32 ``<i>.scale.npy``;
  - int4: two 4-bit codes per uint8 byte (offset by 8, the high nibble
    first) with an f32 ``<i>.scale.npy``.
Quantized chunks move to the device as they are stored and are dequantized
there to float16 by plain torch ops (``q · scale`` in float16, as the JAX
package's XLA dequant). The layout is the JAX package's, so a store written
by either package reads in the other. A load verifies the chunk first
(`data.integrity`): one that fails is quarantined and raises `CorruptChunk`;
a transient read error is retried on the shared backoff schedule.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from sparse_coding__tpu_torch.data import integrity
from sparse_coding__tpu_torch.data.integrity import (  # noqa: F401  (the store's names, as in the JAX package)
    CorruptChunk,
    chunk_manifest_path,
    chunk_path,
    scale_path,
)
from sparse_coding__tpu_torch.telemetry.events import counter_inc_active
from sparse_coding__tpu_torch.utils.device import resolve_device
from sparse_coding__tpu_torch.utils.faults import fault_point
from sparse_coding__tpu_torch.utils.manifest import sha256_file
from sparse_coding__tpu_torch.utils.sync import retry_with_backoff


def quantize_rows_int8(array: np.ndarray):
    """Symmetric per-row absmax int8 quantization: ``row ≈ q * scale``,
    scale = absmax / 127 in f32 (all-zero rows get 1)."""
    a = np.asarray(array, dtype=np.float32)
    absmax = np.abs(a).max(axis=1)
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(a / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales


def quantize_rows_int4(array: np.ndarray):
    """Symmetric per-row absmax 4-bit quantization, two values per byte:
    levels -7..7 (scale = absmax / 7) stored offset by 8, byte = ((hi + 8)
    << 4) | (lo + 8) for the pair (hi, lo) of adjacent columns, so the
    stored array is uint8 at width d / 2. Needs an even d."""
    a = np.asarray(array, dtype=np.float32)
    if a.shape[1] % 2 != 0:
        raise ValueError(f"int4 packing needs an even feature dim, got {a.shape[1]}")
    absmax = np.abs(a).max(axis=1)
    scales = np.where(absmax > 0, absmax / 7.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(a / scales[:, None]), -7, 7).astype(np.int8) + 8
    packed = (q[:, 0::2].astype(np.uint8) << 4) | q[:, 1::2].astype(np.uint8)
    return packed, scales


def dequant_int8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 codes [n, d] and f32 scales [n] → float16 ``q · scale``."""
    return q.to(torch.float16) * scales[:, None].to(torch.float16)


def dequant_int4(packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Packed uint8 [n, d/2] and f32 scales [n] → float16 [n, d]."""
    hi = (packed >> 4).to(torch.int8) - 8
    lo = (packed & 0xF).to(torch.int8) - 8
    n, half = packed.shape
    q = torch.stack([hi, lo], dim=-1).reshape(n, half * 2)
    return q.to(torch.float16) * scales[:, None].to(torch.float16)


def _save_npy_staged(final: Path, array: np.ndarray) -> Path:
    """Write ``array`` to a dot-prefixed temp beside ``final`` (invisible to
    the chunk globs) and return the temp's path."""
    tmp = final.with_name(f".{final.name}.tmp{os.getpid()}")
    with open(tmp, "wb") as f:
        np.save(f, array)
        f.flush()
        os.fsync(f.fileno())
    return tmp


def save_chunk(folder, i: int, array, dtype=np.float16, provenance=None) -> Path:
    """Write chunk `i`, committed atomically: the data (and, for a quantized
    tier, its scale file) land through dot-prefixed temps, then the manifest
    ``sc_chunk.<i>.json``, the one commit point, which also carries
    ``provenance`` (the harvest's config fingerprint, layer, location and
    batch range) as the JAX package writes it. ``dtype``: ``np.float16``
    (default), ``np.int8`` or ``"int4"``. Over a quantized chunk, an fp16
    chunk's bytes land before the stale scale file is removed.

    Fault sites (`utils.faults`, the JAX package's): ``chunk_write`` (data
    staged, nothing landed), ``chunk_pair`` (the chunk's bytes landed, its
    scale file and manifest not yet: a kill here leaves a torn pair that
    verification catches) and ``chunk_committed`` (after the manifest)."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    path, sp = chunk_path(folder, i), scale_path(folder, i)
    host = array.detach().cpu().numpy() if isinstance(array, torch.Tensor) else np.asarray(array)
    if isinstance(dtype, str) and dtype == "int4":
        stored, scales = quantize_rows_int4(host)
        tier = "int4"
    elif np.dtype(dtype) == np.int8:
        stored, scales = quantize_rows_int8(host)
        tier = "int8"
    elif np.dtype(dtype) == np.float16:
        stored, scales = host.astype(np.float16), None
        tier = "float16"
    else:
        raise ValueError(f"save_chunk(dtype={dtype}): the tiers are float16, int8 and 'int4'")
    tmp = _save_npy_staged(path, stored)
    stmp = _save_npy_staged(sp, scales) if scales is not None else None
    fault_point("chunk_write", chunk=int(i))
    os.replace(tmp, path)
    fault_point("chunk_pair", chunk=int(i))
    files = {path.name: path}
    if stmp is not None:
        os.replace(stmp, sp)
        files[sp.name] = sp
    elif sp.exists():
        sp.unlink()
    manifest = {
        "format": 1,
        "chunk": int(i),
        "created_at": time.time(),
        "rows": int(host.shape[0]),
        "shape": [int(s) for s in stored.shape],
        "store_dtype": tier,
        "files": {name: {"bytes": p.stat().st_size, "sha256": sha256_file(p)} for name, p in files.items()},
    }
    if provenance:
        manifest["provenance"] = provenance
    integrity.write_json_atomic(chunk_manifest_path(folder, i), manifest)
    fault_point("chunk_committed", chunk=int(i), path=str(path))
    return path


class ChunkStore:
    """A folder of ``<i>.npy`` activation chunks."""

    def __init__(self, folder):
        self.folder = Path(folder)
        self.folder.mkdir(parents=True, exist_ok=True)

    def indices(self) -> List[int]:
        """Sorted chunk indices present on disk."""
        return sorted(
            int(p.stem) for p in self.folder.iterdir() if p.suffix == ".npy" and p.stem.isdigit()
        )

    def __len__(self) -> int:
        return len(self.indices())

    def slot_count(self) -> int:
        """The chunk-index domain: the highest index present or quarantined,
        plus one. Drivers iterate slots, so a quarantined chunk keeps its
        place in the epoch order and surfaces as a budgeted skip."""
        idx = self.indices() + integrity.quarantined_indices(self.folder)
        return max(idx) + 1 if idx else 0

    def n_datapoints(self) -> int:
        """Total rows across chunks: each committed chunk's manifest
        ``rows``, a legacy chunk's .npy header; no chunk data is read."""
        total = 0
        for i in self.indices():
            manifest = integrity.read_chunk_manifest(self.folder, i)
            if manifest is not None and isinstance(manifest.get("rows"), int):
                total += manifest["rows"]
            else:
                total += integrity.npy_header(chunk_path(self.folder, i))[0][0]
        return total

    def _corrupt(self, i: int, reason: str):
        integrity.quarantine_chunk(self.folder, i, reason)
        raise CorruptChunk(self.folder, i, reason)

    def load(self, i: int, dtype=torch.float32, device=None, verify: Optional[str] = None) -> torch.Tensor:
        """Chunk `i` on ``device`` (None = cuda), verified against its manifest
        at ``verify`` (None = ``SC_CHUNK_VERIFY``, default ``size``). A chunk
        that fails is quarantined and raises `CorruptChunk`, as does one
        quarantined earlier; quantized bytes without their scale file fail at
        every depth. The stored bytes (fp16, int8 or packed int4) cross to
        the device as they are; quantized chunks are dequantized there to
        float16, then every tier is upcast there. ``dtype=None`` keeps
        float16.

        Transient read errors (an ``OSError`` from a network filesystem under
        churn) are retried on the shared `utils.sync.retry_with_backoff`
        schedule (``SC_SYNC_RETRIES`` / ``SC_SYNC_BACKOFF``), each retry
        counted as ``io.retry`` on the live telemetry; a missing file, a
        directory or a permission error fails at once; a schedule that burns
        out counts ``io.exhausted`` and re-raises (the drivers exit 75). The
        ``chunk_read`` fault site (chunk, attempt) injects such errors."""
        device = resolve_device(device)
        if not chunk_path(self.folder, i).exists():
            if integrity.is_quarantined(self.folder, i):
                raise CorruptChunk(self.folder, i, f"quarantined: {self._quarantine_reason(i)}")
            if integrity.read_chunk_manifest(self.folder, i) is None:
                raise FileNotFoundError(chunk_path(self.folder, i))
        depth = integrity.verify_depth(verify)
        if depth != "off":
            ok, reason = integrity.verify_chunk(self.folder, i, depth=depth)
            if not ok:
                self._corrupt(i, reason)
            if integrity.read_chunk_manifest(self.folder, i) is not None:
                counter_inc_active("data.chunks_verified")

        def _read(attempt: int):
            fault_point("chunk_read", chunk=int(i), attempt=attempt)
            a = np.load(chunk_path(self.folder, i))
            sp = scale_path(self.folder, i)
            s = np.load(sp) if a.dtype in (np.int8, np.uint8) and sp.exists() else None
            return a, s

        try:
            arr, scales = retry_with_backoff(
                _read, retry_on=(OSError,),
                give_up_on=(FileNotFoundError, IsADirectoryError, NotADirectoryError, PermissionError),
                on_retry=lambda attempt, exc: counter_inc_active("io.retry"),
            )
        except (FileNotFoundError, IsADirectoryError, NotADirectoryError, PermissionError):
            raise
        except ValueError as e:  # truncated or garbled bytes: corruption
            self._corrupt(i, f"unreadable npy: {e}")
        except OSError:
            counter_inc_active("io.exhausted")
            raise
        if arr.dtype in (np.int8, np.uint8):
            if scales is None:
                self._corrupt(i, f"quantized ({arr.dtype.name}) chunk bytes with no scale file — torn pair")
            q = torch.from_numpy(arr).to(device)
            s = torch.from_numpy(scales).to(device)
            x = dequant_int4(q, s) if arr.dtype == np.uint8 else dequant_int8(q, s)
        elif arr.dtype == np.float16:
            x = torch.from_numpy(arr).to(device)
        else:
            self._corrupt(i, f"unknown stored dtype {arr.dtype}")
        return x if dtype is None else x.to(dtype)

    def _quarantine_reason(self, i: int) -> str:
        """Why chunk `i` was quarantined, from its quarantine record."""
        try:
            with open(self.folder / integrity.QUARANTINE_DIR / f"sc_quarantine.{int(i)}.json") as f:
                return str(json.load(f).get("reason", "unknown"))
        except (OSError, ValueError):
            return "unknown"

    def iter_chunks(self, order: Sequence[int], dtype=torch.float32, device=None) -> Iterator[torch.Tensor]:
        """Yield chunks in `order`, reading the next one on a background
        thread while the caller trains on the current one."""
        device = resolve_device(device)
        q: "queue.Queue" = queue.Queue(maxsize=1)
        stop = threading.Event()

        def producer():
            try:
                for i in order:
                    if stop.is_set():
                        return
                    q.put(("ok", self.load(int(i), dtype=dtype, device=device)))
                q.put(("done", None))
            except Exception as e:  # surfaced in the consumer
                q.put(("err", e))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "done":
                    return
                if kind == "err":
                    raise payload
                yield payload
        finally:
            stop.set()
            while not q.empty():
                q.get_nowait()
            t.join(timeout=60)


SYNTHETIC_PRODUCER = "sparse_coding__tpu_torch"  # the stamp `data.scrub`'s repair checks


def synthetic_stamp(generator) -> Dict[str, str]:
    """The ``provenance`` a synthetic chunk's manifest carries: the package,
    the generator class and the device type whose `torch.Generator` stream
    drew it (the CPU's and CUDA's streams differ), so a repair can tell
    whether it can give the chunk's bits back."""
    dev = getattr(generator, "device", None)
    return {"synthetic": {"producer": SYNTHETIC_PRODUCER, "generator": type(generator).__name__,
                          "device": torch.device(dev).type if dev is not None else "cpu"}}


def generate_synthetic_chunks(
    generator, folder, n_chunks: int, chunk_size_gb: float = 2.0,
    activation_width: Optional[int] = None, dtype=np.float16, only_chunks: Optional[Sequence[int]] = None,
) -> ChunkStore:
    """Materialize a generator into chunk files of the ``dtype`` tier (see
    `save_chunk`): each chunk holds the whole batches that fit in
    ``chunk_size_gb`` at ``dtype``'s item size; each manifest carries
    `synthetic_stamp`.

    ``only_chunks``: write just those indices. The generator still draws
    every chunk's batches, so chunk ``k``'s data is the same whichever subset
    is written (what `data.scrub`'s repair refills a hole with, on the
    device type that drew the store)."""
    store = ChunkStore(folder)
    width = activation_width or generator.activation_dim
    rows_per_chunk = int(chunk_size_gb * 1024**3 // (width * np.dtype(dtype).itemsize))
    batches_per_chunk = max(1, rows_per_chunk // generator.batch_size)
    selected = None if only_chunks is None else {int(c) for c in only_chunks}
    stamp = synthetic_stamp(generator)
    for i in range(n_chunks):
        parts = [next(generator) for _ in range(batches_per_chunk)]  # drawn also when skipped
        if selected is None or i in selected:
            save_chunk(folder, i, torch.cat(parts), dtype=dtype, provenance=stamp)
    return store


def load_store_dataset(store, dtype=torch.float32, telemetry=None, budget=None,
                       budget_frac: Optional[float] = None, device=None):
    """Load a whole chunk store into one ``[N, d]`` tensor on ``device``
    (None = cuda), surviving corrupt chunks in degraded mode.

    The admission path for the trainers that sample rows from one array
    (`train.big_batch.train_big_batch` takes a store folder through this):
    every chunk is loaded and verified (``SC_CHUNK_VERIFY``); a chunk that
    fails is quarantined by the load and accounted against a
    `data.integrity.ChunkLossBudget`, and so is a chunk quarantined before
    this run. Inside the budget its rows are absent from the result (the
    ``data.chunks_skipped`` / ``data.rows_skipped`` counters record the
    loss); past it the budget raises `ResumableAbort` (exit 75), as does a
    store with no loadable chunk. Returns ``(dataset, budget)``."""
    device = resolve_device(device)
    if not isinstance(store, ChunkStore):
        store = ChunkStore(store)
    idx = store.indices()
    quarantined = integrity.quarantined_indices(store.folder)
    # a chunk both present and in the quarantine ledger (repaired since) counts once
    n_total = max(len(set(idx) | set(quarantined)), 1)
    if budget is None:
        budget = integrity.ChunkLossBudget(n_total, telemetry=telemetry, budget_frac=budget_frac)
    for q in quarantined:
        if q not in idx:
            budget.skip(q, "quarantined", rows=integrity.quarantined_rows(store.folder, q))
    parts = []
    for i in idx:
        try:
            parts.append(store.load(i, dtype=dtype, device=device))
        except CorruptChunk as e:
            budget.skip(i, e.reason, rows=integrity.quarantined_rows(store.folder, i))
    if not parts:
        from sparse_coding__tpu_torch.train.preemption import ResumableAbort

        raise ResumableAbort(f"no loadable chunks in {store.folder} ({len(budget.skipped_chunks)} quarantined); "
                             "scrub/repair the store")
    return torch.cat(parts, dim=0), budget
