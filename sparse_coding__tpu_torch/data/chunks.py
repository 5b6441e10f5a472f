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
by either package reads in the other.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
import time
from pathlib import Path
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from sparse_coding__tpu_torch.utils.device import resolve_device


class CorruptChunk(RuntimeError):
    """A chunk whose bytes do not match its commit manifest."""


def chunk_path(folder, i: int) -> Path:
    return Path(folder) / f"{i}.npy"


def chunk_manifest_path(folder, i: int) -> Path:
    return Path(folder) / f"sc_chunk.{int(i)}.json"


def scale_path(folder, i: int) -> Path:
    """Per-row dequantization scales of a quantized chunk (absent for fp16)."""
    return Path(folder) / f"{i}.scale.npy"


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


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _save_npy_staged(final: Path, array: np.ndarray) -> Path:
    """Write ``array`` to a dot-prefixed temp beside ``final`` (invisible to
    the chunk globs) and return the temp's path."""
    tmp = final.with_name(f".{final.name}.tmp{os.getpid()}")
    with open(tmp, "wb") as f:
        np.save(f, array)
        f.flush()
        os.fsync(f.fileno())
    return tmp


def save_chunk(folder, i: int, array, dtype=np.float16) -> Path:
    """Write chunk `i`, committed atomically: the data (and, for a quantized
    tier, its scale file) land through dot-prefixed temps, then the manifest.
    ``dtype``: ``np.float16`` (default), ``np.int8`` or ``"int4"``. Over a
    quantized chunk, an fp16 chunk's bytes land before the stale scale file
    is removed."""
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
    os.replace(tmp, path)
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
        "files": {name: {"bytes": p.stat().st_size, "sha256": _sha256(p)} for name, p in files.items()},
    }
    mpath = chunk_manifest_path(folder, i)
    mtmp = mpath.with_name(f".{mpath.name}.tmp{os.getpid()}")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(mtmp, mpath)
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

    def verify(self, i: int, depth: str = "size") -> None:
        """Check chunk `i` against its manifest (``size`` / ``digest`` /
        ``off``); raises `CorruptChunk`. Chunks without a manifest (legacy)
        pass."""
        if depth == "off":
            return
        try:
            with open(chunk_manifest_path(self.folder, i)) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            return
        for rel, meta in manifest.get("files", {}).items():
            p = self.folder / rel
            if not p.is_file():
                raise CorruptChunk(f"chunk {i} of {self.folder}: missing file {rel}")
            if p.stat().st_size != meta.get("bytes"):
                raise CorruptChunk(f"chunk {i} of {self.folder}: size mismatch on {rel}")
            if depth == "digest" and "sha256" in meta and _sha256(p) != meta["sha256"]:
                raise CorruptChunk(f"chunk {i} of {self.folder}: digest mismatch on {rel}")

    def load(self, i: int, dtype=torch.float32, device=None, verify: str = "size") -> torch.Tensor:
        """Chunk `i` on ``device`` (None = cuda), verified against its manifest.
        The stored bytes (fp16, int8 or packed int4) cross to the device as
        they are; quantized chunks are dequantized there to float16, then
        every tier is upcast there. ``dtype=None`` keeps float16. Quantized
        bytes without their scale file raise `CorruptChunk` at every verify
        depth."""
        device = resolve_device(device)
        if not chunk_path(self.folder, i).exists():
            raise FileNotFoundError(chunk_path(self.folder, i))
        self.verify(i, verify)
        arr = np.load(chunk_path(self.folder, i))
        if arr.dtype in (np.int8, np.uint8):
            sp = scale_path(self.folder, i)
            if not sp.exists():
                raise CorruptChunk(
                    f"chunk {i} of {self.folder}: quantized ({arr.dtype.name}) bytes with no scale file"
                )
            q = torch.from_numpy(arr).to(device)
            scales = torch.from_numpy(np.load(sp)).to(device)
            x = dequant_int4(q, scales) if arr.dtype == np.uint8 else dequant_int8(q, scales)
        elif arr.dtype == np.float16:
            x = torch.from_numpy(arr).to(device)
        else:
            raise CorruptChunk(f"chunk {i} of {self.folder}: unknown stored dtype {arr.dtype}")
        return x if dtype is None else x.to(dtype)

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


def generate_synthetic_chunks(
    generator, folder, n_chunks: int, chunk_size_gb: float = 2.0,
    activation_width: Optional[int] = None, dtype=np.float16,
) -> ChunkStore:
    """Materialize a generator into chunk files of the ``dtype`` tier (see
    `save_chunk`): each chunk holds the whole batches that fit in
    ``chunk_size_gb`` at ``dtype``'s item size."""
    store = ChunkStore(folder)
    width = activation_width or generator.activation_dim
    rows_per_chunk = int(chunk_size_gb * 1024**3 // (width * np.dtype(dtype).itemsize))
    batches_per_chunk = max(1, rows_per_chunk // generator.batch_size)
    for i in range(n_chunks):
        save_chunk(folder, i, torch.cat([next(generator) for _ in range(batches_per_chunk)]), dtype=dtype)
    return store
