"""On-disk activation chunk store (the fp16 tier).

Counterpart of `sparse_coding__tpu/data/chunks.py`: a folder of numbered
``<i>.npy`` chunks, each ``[rows, d]`` float16, committed by a per-chunk
manifest ``sc_chunk.<i>.json`` (byte sizes + sha256 + rows/shape/dtype) that
lands last with an atomic ``os.replace``. The layout is the JAX package's, so
a store written by either package reads in the other. The int8/int4
transport tiers are not ported yet and raise (ROADMAP A2).
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


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _quantized_tier_error(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the int8/int4 chunk tiers are not ported yet (ROADMAP A2); "
        "only float16 chunks are"
    )


def save_chunk(folder, i: int, array, dtype=np.float16) -> Path:
    """Write chunk `i` as ``[N, d]`` float16 .npy, committed atomically: the
    data lands through a dot-prefixed temp, then the manifest."""
    if isinstance(dtype, str) or np.dtype(dtype) != np.float16:
        raise _quantized_tier_error(f"save_chunk(dtype={dtype})")
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    path = chunk_path(folder, i)
    host = array.detach().cpu().numpy() if isinstance(array, torch.Tensor) else np.asarray(array)
    stored = host.astype(np.float16)
    tmp = path.with_name(f".{path.name}.tmp{os.getpid()}")
    with open(tmp, "wb") as f:
        np.save(f, stored)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    manifest = {
        "format": 1,
        "chunk": int(i),
        "created_at": time.time(),
        "rows": int(stored.shape[0]),
        "shape": [int(s) for s in stored.shape],
        "store_dtype": "float16",
        "files": {path.name: {"bytes": path.stat().st_size, "sha256": _sha256(path)}},
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
        The fp16 bytes cross to the device as they are and are upcast there;
        ``dtype=None`` keeps float16."""
        device = resolve_device(device)
        if not chunk_path(self.folder, i).exists():
            raise FileNotFoundError(chunk_path(self.folder, i))
        self.verify(i, verify)
        arr = np.load(chunk_path(self.folder, i))
        if arr.dtype != np.float16:
            raise _quantized_tier_error(f"chunk {i} of {self.folder} is {arr.dtype}")
        x = torch.from_numpy(arr).to(device)
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
    """Materialize a generator into fp16 chunk files: each chunk holds the
    whole batches that fit in ``chunk_size_gb``."""
    store = ChunkStore(folder)
    width = activation_width or generator.activation_dim
    rows_per_chunk = int(chunk_size_gb * 1024**3 // (width * np.dtype(dtype).itemsize))
    batches_per_chunk = max(1, rows_per_chunk // generator.batch_size)
    for i in range(n_chunks):
        save_chunk(folder, i, torch.cat([next(generator) for _ in range(batches_per_chunk)]), dtype=dtype)
    return store
