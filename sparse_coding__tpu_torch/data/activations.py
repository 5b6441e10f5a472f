"""LM activation harvesting → the chunked activation store.

Counterpart of `sparse_coding__tpu/data/activations.py`, with its surface,
on-disk results and cursor format, so a store harvested partly by either
package resumes in the other:

  - the subject LM runs over token batches (`MODEL_BATCH_SIZE` sequences a
    forward), every requested (layer, location) captured in one pass, with
    an early exit after the deepest requested layer;
  - the captured tensors are cast to fp16 on the device (`capture_fn`) and
    written through `data.chunks.save_chunk`, one folder per (layer,
    location), ``{i}.npy`` numbered, each chunk committed by its manifest
    with the harvest's provenance;
  - a harvest cursor (``sc_harvest_cursor.json``: next chunk, batch cursor,
    config fingerprint) is committed into every folder after each chunk, so
    ``resume=True`` restarts from the last chunk that verifies.

On the card the batches of a chunk are pipelined: batch b+1's forward is
enqueued before batch b's device-to-host copy is waited on. Each batch's
fp16 activations are copied into pinned host buffers by a side stream
(non-blocking) while the next forward runs; the host waits once, at the end
of the chunk.

Tokenization is the reference's GPT-style concatenate-and-chunk: join
documents with EOS, split the stream into exact ``max_length`` rows, drop
the ragged tail.

``attn="blockwise"`` runs the capture forward on
`lm.ring_attention.blockwise_attention` (one score tile live, so sequences
far past dense attention's memory harvest on one card).

``mesh=`` (a `parallel.make_mesh` mesh; every rank of the world calls the
harvest with the same tokens) runs the sequence-parallel capture over its
"data" axis (``seq_attn``: ``"ring"`` | ``"ulysses"``): each rank captures
its slice of every sequence and casts it to fp16 on its device, and the
shards are gathered over the axis on the sequence dim, so the rows keep the
single-card ``(sequence, position)`` order. Rank 0 alone writes the chunk
store, its manifests, the cursor and the ``events.jsonl`` spans, with the
single-card commit (the store is byte-compatible with it); the other ranks
write nothing and meet rank 0 at a barrier after each commit, so a resume
sees one cursor.
"""

from __future__ import annotations

import contextlib
import math
from functools import lru_cache
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sparse_coding__tpu_torch.data import integrity
from sparse_coding__tpu_torch.data.chunks import ChunkStore, save_chunk
from sparse_coding__tpu_torch.lm import model as lm_model
from sparse_coding__tpu_torch.lm.convert import _canonical_hf_name, load_model
from sparse_coding__tpu_torch.lm.ring_attention import blockwise_attention, make_sequence_parallel_fn
from sparse_coding__tpu_torch.parallel.mesh import DATA_AXIS
from sparse_coding__tpu_torch.telemetry.events import event_active
from sparse_coding__tpu_torch.telemetry.spans import ACTIVE, span
from sparse_coding__tpu_torch.utils.device import resolve_device
from sparse_coding__tpu_torch.utils.precision import as_dtype

MODEL_BATCH_SIZE = 64  # sentences per forward (the reference runs 4)
MAX_SENTENCE_LEN = 256  # the reference's sequence cap


# -- tokenization -------------------------------------------------------------

def chunk_tokens(token_stream: Sequence[int], max_length: int) -> np.ndarray:
    """Split one long token stream into exact-``max_length`` int32 rows,
    dropping the ragged tail."""
    n = (len(token_stream) // max_length) * max_length
    return np.asarray(token_stream[:n], dtype=np.int32).reshape(-1, max_length)


def chunk_and_tokenize_texts(texts: Sequence[str], encode: Callable[[str], List[int]], eos_id: int,
                             max_length: int = MAX_SENTENCE_LEN) -> np.ndarray:
    """GPT-style chunking: EOS-joined documents → ``[n, max_length]`` int32.
    ``encode`` is any text → ids callable (an HF tokenizer, a test stub)."""
    stream: List[int] = []
    for t in texts:
        stream.append(eos_id)
        stream.extend(encode(t))
    return chunk_tokens(stream, max_length)


def make_sentence_dataset(dataset_name: str, max_lines: int = 20_000, start_line: int = 0):
    """HF dataset load, sliced to ``[start_line, start_line + max_lines)``
    (the local cache or the network)."""
    from datasets import load_dataset

    return load_dataset(dataset_name, split=f"train[{start_line}:{start_line + max_lines}]")


def setup_token_data(dataset_name: str, tokenizer, max_length: int = MAX_SENTENCE_LEN,
                     max_lines: int = 20_000) -> np.ndarray:
    """Tokenized ``[n, max_length]`` rows from an HF dataset."""
    ds = make_sentence_dataset(dataset_name, max_lines=max_lines)
    texts = ds["text"][:max_lines]
    return chunk_and_tokenize_texts(texts, lambda t: tokenizer(t)["input_ids"], tokenizer.eos_token_id, max_length)


def load_tokenizer(model_name: str):
    """The HF tokenizer of a model name or a local checkpoint folder."""
    import transformers

    return transformers.AutoTokenizer.from_pretrained(model_name if "/" in model_name
                                                      else _canonical_hf_name(model_name))


# -- harvesting ---------------------------------------------------------------

def _attn_impl(attn: str):
    """The single-card attention of a harvest: ``"dense"`` or ``"blockwise"``."""
    if attn == "dense":
        return lm_model.dense_attention
    if attn == "blockwise":
        return blockwise_attention()
    raise ValueError(f"unknown single-device attn impl: {attn}")


@lru_cache(maxsize=16)
def _capture(lm_cfg: lm_model.LMConfig, names: Tuple[str, ...], stop_at: int, compute_dtype=None,
             attn: str = "dense"):
    attn_impl = _attn_impl(attn)

    def capture(params, tokens):
        with torch.no_grad():
            if compute_dtype is not None:
                params = lm_model.cast_params(params, compute_dtype)  # a no-op on pre-cast params
            _, cache = lm_model.run_with_cache(params, tokens, lm_cfg, list(names), stop_at_layer=stop_at,
                                               attn_impl=attn_impl)
            return {k: v.to(torch.float16) for k, v in cache.items()}

    return capture


def capture_fn(lm_cfg: lm_model.LMConfig, names: Sequence[str], stop_at: int, compute_dtype=None,
               attn: str = "dense"):
    """The harvest's capture forward ``(params, tokens [B, S]) -> {name:
    fp16 [B, S, w]}``, cached per (config, hook set, stop layer, compute
    dtype, attention). The cast to fp16 happens on the device.
    `make_activation_dataset` and `harvest_to_device` run this function, so
    their activations are the same bits for the same tokens. The attention
    pattern cannot be captured under ``attn="blockwise"`` (it raises)."""
    return _capture(lm_cfg, tuple(names), int(stop_at), as_dtype(compute_dtype), attn)


def _build_capture(lm_cfg, names: Dict, stop_at: int, mesh, seq_attn: str, compute_dtype=None,
                   attn: str = "dense"):
    """The capture forward, single-card (`capture_fn`) or sequence-parallel
    over ``mesh``'s data axis; both cast to fp16 on the device. The
    sequence-parallel one returns this rank's shards ``[B, S/p, w]``."""
    compute_dtype = as_dtype(compute_dtype)
    if compute_dtype is not None and mesh is not None:
        raise ValueError("compute_dtype is a single-device capture option")
    if attn != "dense" and mesh is not None:
        raise ValueError(
            "attn is a single-device capture option; with a mesh choose the "
            "sequence-parallel impl via seq_attn ('ring' | 'ulysses')"
        )
    if mesh is None:
        return capture_fn(lm_cfg, tuple(names.values()), stop_at, compute_dtype, attn)
    # built once: the attention and the group binding are reused batch after batch
    seq_fn = make_sequence_parallel_fn(lm_cfg, mesh, cache_names=list(names.values()), stop_at_layer=stop_at,
                                       attn=seq_attn)

    def capture(params, tokens):
        with torch.no_grad():
            return {k: v.to(torch.float16) for k, v in seq_fn(params, tokens)[1].items()}

    return capture


def _gathered(cache: Dict, mesh) -> Dict:
    """Sequence shards ``[B, S/p, w]`` gathered over the data axis on the
    sequence dim (``[B, S, w]``): flattened, the rows are in the single-card
    order. The cache itself on one card."""
    if mesh is None:
        return cache
    return {k: mesh.all_gather(v, DATA_AXIS, dim=1) for k, v in cache.items()}


def _barrier(mesh, tag: str) -> None:
    """Every rank of the world meets here (nothing on one card)."""
    if mesh is not None:
        from sparse_coding__tpu_torch.train.checkpoint import _pod_barrier

        _pod_barrier(tag)


def _probe_activation_size(lm_cfg, name: str, stop_at: int, seq_len: int) -> int:
    """Width of any qualified hook point, from a forward on the ``meta``
    device (shapes only: nothing is computed or allocated)."""
    params = lm_model.init_params(0, lm_cfg, device="meta")
    tok = torch.zeros((1, seq_len), dtype=torch.int32, device="meta")
    _, cache = lm_model.run_with_cache(params, tok, lm_cfg, [name], stop_at_layer=stop_at)
    return int(cache[name].shape[-1])


def _point_width(lm_cfg, loc: str, name: str, stop_at: int, seq_len: int) -> int:
    """A capture point's width: registered, or probed on the meta device."""
    try:
        return lm_model.get_activation_size(lm_cfg, loc, seq_len=seq_len)
    except ValueError:
        return _probe_activation_size(lm_cfg, name, stop_at, seq_len)


def _harvest_plan(lm_cfg: lm_model.LMConfig, layers: Sequence[int], layer_locs: Sequence[str],
                  chunk_size_gb: float, batch_size: int, seq_len: int):
    """Capture-point names, the early-exit layer, and how many batches fill
    one chunk (every point fills at the same row rate; the budget is the
    widest point's)."""
    names = {(layer, loc): lm_model.make_tensor_name(layer, loc) for layer in layers for loc in layer_locs}
    stop_at = max(layers) + 1
    chunk_rows = min(int(chunk_size_gb * 1024**3 // (_point_width(lm_cfg, loc, name, stop_at, seq_len) * 2))
                     for (_, loc), name in names.items())
    batches_per_chunk = max(1, chunk_rows // (batch_size * seq_len))
    return names, stop_at, batches_per_chunk


def harvest_folder_name(base_folder, layer: int, layer_loc: str) -> Path:
    """One folder per (layer, location): ``{base}_l{layer}_{loc}``."""
    return Path(f"{base_folder}_l{layer}_{layer_loc}")


# -- harvest cursor / verified resume -----------------------------------------

HARVEST_CURSOR = "sc_harvest_cursor.json"


def _harvest_config_sha(layers, layer_locs, batch_size, chunk_size_gb, store_dtype, center_dataset,
                        tokens_shape) -> str:
    """Fingerprint of everything that fixes a chunk's content at its index,
    hashed exactly as the JAX package hashes it (``str(store_dtype)``
    included: ``np.float16`` and ``np.dtype("float16")`` differ), so one
    store resumes across the two packages."""
    import hashlib
    import json

    spec = {
        "layers": [int(l) for l in layers],
        "layer_locs": [str(l) for l in layer_locs],
        "batch_size": int(batch_size),
        "chunk_size_gb": float(chunk_size_gb),
        "store_dtype": str(store_dtype),
        "center_dataset": bool(center_dataset),
        "tokens_shape": [int(s) for s in tokens_shape],
    }
    return hashlib.sha256(json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]


def _write_harvest_cursor(folders, next_chunk: int, batch_cursor: int, config_sha: str):
    """Commit the harvest position into every capture-point folder (atomic
    JSON replace)."""
    import time

    rec = {"format": 1, "chunk": int(next_chunk), "batch_cursor": int(batch_cursor), "config_sha": config_sha,
           "updated_at": time.time()}
    for folder in folders.values():
        integrity.write_json_atomic(Path(folder) / HARVEST_CURSOR, rec)


def read_harvest_cursor(folder) -> Optional[Dict]:
    import json

    try:
        with open(Path(folder) / HARVEST_CURSOR) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _verified_skip_chunks(folders, requested: int, config_sha: str) -> int:
    """The longest prefix ``[0, k)``, k ≤ ``requested``, whose chunks verify
    against their manifests in every folder; a cursor written under another
    config fingerprint raises."""
    import warnings

    for folder in folders.values():
        cursor = read_harvest_cursor(folder)
        if cursor is not None and cursor.get("config_sha") not in (None, config_sha):
            raise ValueError(
                f"harvest resume refused: {folder} was harvested under a different configuration (cursor "
                f"config_sha {cursor.get('config_sha')!r} != {config_sha!r}); use a fresh dataset folder or "
                "re-harvest from scratch")
    effective = requested
    for folder in folders.values():
        for i in range(min(requested, effective)):
            ok, reason = integrity.verify_chunk(folder, i)
            if not ok:
                effective = i
                warnings.warn(f"harvest resume: chunk {i} in {folder} does not verify ({reason}) — "
                              f"re-harvesting from chunk {i} instead of skipping {requested}", RuntimeWarning)
                event_active("anomaly", kind="harvest_resume_truncated", action="warn", chunk=i, reason=reason,
                             store=str(folder))
                break
    return effective


def _committed_resume_point(folders, config_sha: str) -> int:
    """The cursor's resume point, clamped to what verifies: a harvest killed
    mid-chunk resumes from the last committed chunk."""
    chunks = []
    for folder in folders.values():
        cursor = read_harvest_cursor(folder)
        chunks.append(0 if cursor is None else int(cursor.get("chunk", 0)))
    return _verified_skip_chunks(folders, min(chunks) if chunks else 0, config_sha)


def _chunk_caches(capture, params, tokens: np.ndarray, batch_cursor: int, batches_per_chunk: int,
                  batch_size: int, device):
    """The capture outputs of one chunk's batches, in order; the chunk's
    token rows move to the device once, as they are (int32)."""
    lo = batch_cursor * batch_size
    toks = torch.from_numpy(np.ascontiguousarray(tokens[lo:lo + batches_per_chunk * batch_size]))
    toks = toks.to(device, non_blocking=True)
    for b in range(batches_per_chunk):
        yield capture(params, toks[b * batch_size:(b + 1) * batch_size])


class _Drain:
    """A chunk's captured batches → host fp16 arrays, one per capture point.

    On CUDA: pinned host buffers of a chunk's rows, filled by non-blocking
    copies on a side stream that waits for each batch's forward, so the
    next forward runs meanwhile; `arrays` waits once. The buffers (sized at
    the first batch: a point's rows a batch are ``B·S``, or ``B·H·S`` for the
    attention pattern) are reused chunk after chunk: read each chunk's
    arrays before the next chunk's `put`s. On the CPU: plain copies."""

    def __init__(self, n_batches: int, device: torch.device):
        self.n_batches = n_batches
        self.cuda = device.type == "cuda"
        self.buffers: Dict = {}
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def put(self, b: int, cache: Dict, names: Dict):
        if self.cuda:
            self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream) if self.cuda else contextlib.nullcontext():
            for key, name in names.items():
                act = cache[name].reshape(-1, cache[name].shape[-1])
                if key not in self.buffers:
                    self.buffers[key] = torch.empty((self.n_batches * act.shape[0], act.shape[1]),
                                                    dtype=torch.float16, pin_memory=self.cuda)
                rows = self.buffers[key][b * act.shape[0]:(b + 1) * act.shape[0]]
                if self.cuda:
                    act.record_stream(self.stream)  # the allocator keeps it until the copy is done
                rows.copy_(act, non_blocking=self.cuda)

    def arrays(self) -> Dict:
        if self.cuda:
            self.stream.synchronize()
        return {k: v.numpy() for k, v in self.buffers.items()}


def make_activation_dataset(
    params,
    lm_cfg: lm_model.LMConfig,
    tokens: np.ndarray,
    dataset_folder: Union[str, Path],
    layers: Sequence[int],
    layer_locs: Sequence[str],
    batch_size: int = MODEL_BATCH_SIZE,
    chunk_size_gb: float = 2.0,
    n_chunks: Optional[int] = None,
    skip_chunks: int = 0,
    center_dataset: bool = False,
    mesh=None,
    seq_attn: str = "ring",
    single_folder: bool = False,
    compute_dtype=None,
    store_dtype=np.float16,
    attn: str = "dense",
    resume: bool = False,
    only_chunks: Optional[Sequence[int]] = None,
    device=None,
) -> Dict[Tuple[int, str], Path]:
    """Run the subject LM over int token rows ``[N, S]``, capturing every
    requested (layer, layer_loc) in one pass; write chunks per capture point.

    Returns {(layer, loc): folder}. ``params`` live on ``device`` (None =
    cuda). ``skip_chunks`` skips a prefix (verified first: it is truncated,
    with a warning, at the first chunk that does not verify);
    ``center_dataset`` subtracts the first chunk's mean from every chunk
    (kept in ``mean.npy``); ``compute_dtype`` (e.g. ``"bfloat16"``) runs the
    forward on params cast once; ``store_dtype`` ``np.float16``, ``np.int8``
    or ``"int4"``; ``resume=True`` restarts from the last committed chunk
    (the cursor clamped to the prefix that verifies; a cursor of another
    configuration raises); ``only_chunks=[...]`` harvests exactly those
    indices (the batch cursor still advances through the rest), which
    refills quarantined holes bit for bit. Spans: ``step`` /
    ``harvest_forward`` and ``checkpoint`` / ``chunk_commit``, broadcast to
    any live `RunTelemetry`; a ``provenance`` event per committed chunk.
    ``mesh`` / ``seq_attn``: the sequence-parallel capture (module
    docstring); every rank returns the folders, rank 0 alone writes them."""
    device = resolve_device(device)
    names, stop_at, batches_per_chunk = _harvest_plan(lm_cfg, layers, layer_locs, chunk_size_gb, batch_size,
                                                      tokens.shape[1])
    capture = _build_capture(lm_cfg, names, stop_at, mesh, seq_attn, compute_dtype, attn)
    writer = mesh is None or mesh.rank == 0
    tel = ACTIVE if writer else None
    if single_folder:
        if len(names) != 1:
            raise ValueError("single_folder requires exactly one capture point")
        folders = {key: Path(dataset_folder) for key in names}
    else:
        folders = {(layer, loc): harvest_folder_name(dataset_folder, layer, loc) for layer, loc in names}
    if writer:
        for f in folders.values():
            f.mkdir(parents=True, exist_ok=True)

    config_sha = _harvest_config_sha(layers, layer_locs, batch_size, chunk_size_gb, store_dtype, center_dataset,
                                     tokens.shape)
    if resume:
        committed = _committed_resume_point(folders, config_sha)
        skip_chunks = committed if skip_chunks == 0 else min(skip_chunks, committed)
    elif skip_chunks:
        skip_chunks = _verified_skip_chunks(folders, skip_chunks, config_sha)
    selected = None if only_chunks is None else {int(c) for c in only_chunks}
    _barrier(mesh, "harvest_start")  # every rank has read the store before rank 0 writes to it

    params = lm_model.cast_params(params, as_dtype(compute_dtype))  # pay the cast once
    drain = _Drain(batches_per_chunk, device) if writer else None

    n_batches_total = tokens.shape[0] // batch_size
    max_chunks = n_chunks if n_chunks is not None else math.inf
    chunk_idx = 0
    batch_cursor = 0
    means: Dict[Tuple[int, str], np.ndarray] = {}
    while chunk_idx < max_chunks and batch_cursor + batches_per_chunk <= n_batches_total:
        if chunk_idx < skip_chunks or (selected is not None and chunk_idx not in selected):
            # a chunk's content is a function of its batch range alone
            batch_cursor += batches_per_chunk
            chunk_idx += 1
            continue
        with span(tel, "step", name="harvest_forward", chunk=chunk_idx):
            for b, cache in enumerate(_chunk_caches(capture, params, tokens, batch_cursor, batches_per_chunk,
                                                    batch_size, device)):
                cache = _gathered(cache, mesh)
                if writer:
                    drain.put(b, cache, names)
            buffers = drain.arrays() if writer else {}
        with span(tel, "checkpoint", name="chunk_commit", chunk=chunk_idx):
            for key in names if writer else ():
                chunk = buffers[key]
                if center_dataset:
                    if chunk_idx == 0 and key not in means:
                        means[key] = chunk.mean(axis=0)
                        np.save(folders[key] / "mean.npy", means[key])
                    elif key not in means:
                        means[key] = np.load(folders[key] / "mean.npy")
                    chunk = chunk - means[key]
                save_chunk(folders[key], chunk_idx, chunk, dtype=store_dtype, provenance={
                    "harvest": {
                        "config_sha": config_sha,
                        "layer": int(key[0]), "loc": str(key[1]),
                        "batches": [batch_cursor, batch_cursor + batches_per_chunk],
                        "centered": bool(center_dataset),
                    }
                })
                event_active("provenance", artifact="chunk", store=str(folders[key]), chunk=int(chunk_idx),
                             config_sha=config_sha)
            batch_cursor += batches_per_chunk
            chunk_idx += 1
            if selected is None and writer:
                # after the chunk landed in every folder: "the last committed
                # chunk" (repair passes fill holes and leave the cursor alone)
                _write_harvest_cursor(folders, chunk_idx, batch_cursor, config_sha)
        _barrier(mesh, "harvest_commit")
    return folders


def harvest_to_device(
    params,
    lm_cfg: lm_model.LMConfig,
    tokens: np.ndarray,
    layers: Sequence[int],
    layer_locs: Sequence[str],
    batch_size: int = MODEL_BATCH_SIZE,
    chunk_size_gb: float = 2.0,
    n_chunks: Optional[int] = None,
    mesh=None,
    seq_attn: str = "ring",
    save_folder: Optional[Union[str, Path]] = None,
    compute_dtype=None,
    store_dtype=np.float16,
    attn: str = "dense",
    device=None,
):
    """Fused harvest → train: yield device-resident chunks ``{(layer, loc):
    [rows, w] fp16}``, the values `make_activation_dataset` writes, without
    a trip through the host. ``save_folder`` also persists each chunk in
    ``store_dtype`` (the yielded chunks stay fp16). With ``mesh`` every
    rank yields the gathered chunk on its own device, in the single-card
    row order, and rank 0 alone saves."""
    device = resolve_device(device)
    names, stop_at, batches_per_chunk = _harvest_plan(lm_cfg, layers, layer_locs, chunk_size_gb, batch_size,
                                                      tokens.shape[1])
    capture = _build_capture(lm_cfg, names, stop_at, mesh, seq_attn, compute_dtype, attn)
    params = lm_model.cast_params(params, as_dtype(compute_dtype))

    folders = None
    if save_folder is not None and (mesh is None or mesh.rank == 0):
        folders = {(layer, loc): harvest_folder_name(save_folder, layer, loc) for (layer, loc) in names}
        for f in folders.values():
            f.mkdir(parents=True, exist_ok=True)

    n_batches_total = tokens.shape[0] // batch_size
    max_chunks = n_chunks if n_chunks is not None else math.inf
    chunk_idx = 0
    batch_cursor = 0
    while chunk_idx < max_chunks and batch_cursor + batches_per_chunk <= n_batches_total:
        parts: Dict[Tuple[int, str], List[torch.Tensor]] = {k: [] for k in names}
        for cache in _chunk_caches(capture, params, tokens, batch_cursor, batches_per_chunk, batch_size, device):
            cache = _gathered(cache, mesh)
            for key, name in names.items():
                parts[key].append(cache[name].reshape(-1, cache[name].shape[-1]))
        chunk = {key: torch.cat(p, dim=0) for key, p in parts.items()}
        # free the per-batch parts before yielding: the paused generator would
        # otherwise hold a second copy of the chunk through the consumer's step
        del parts, cache
        if folders is not None:
            for key, arr in chunk.items():
                save_chunk(folders[key], chunk_idx, arr, dtype=store_dtype)
        yield chunk
        batch_cursor += batches_per_chunk
        chunk_idx += 1


def setup_data(
    model_name: str,
    dataset_name: str,
    dataset_folder: Union[str, Path],
    layer: Union[int, Sequence[int]],
    layer_loc: Union[str, Sequence[str]] = "residual",
    n_chunks: int = 30,
    chunk_size_gb: float = 2.0,
    center_dataset: bool = False,
    max_length: int = MAX_SENTENCE_LEN,
    batch_size: int = MODEL_BATCH_SIZE,
    max_lines: int = 100_000,
    skip_chunks: int = 0,
    compute_dtype=None,
    store_dtype="float16",
    resume: bool = False,
    device=None,
) -> int:
    """HF model + dataset → tokenize → harvest → chunk store. Needs the model,
    tokenizer and dataset in the local HF cache (or a local checkpoint
    folder) or the network. Returns the number of rows written."""
    # resolve the dtypes before the model load: a typo fails at once
    compute_dtype = as_dtype(compute_dtype)
    device = resolve_device(device)
    lm_cfg, params = load_model(model_name, device=device)
    tokens = setup_token_data(dataset_name, load_tokenizer(model_name), max_length=max_length, max_lines=max_lines)
    layers = [layer] if isinstance(layer, int) else list(layer)
    locs = [layer_loc] if isinstance(layer_loc, str) else list(layer_loc)
    folders = make_activation_dataset(
        params, lm_cfg, tokens, dataset_folder, layers, locs, batch_size=batch_size, chunk_size_gb=chunk_size_gb,
        n_chunks=n_chunks, skip_chunks=skip_chunks, center_dataset=center_dataset,
        single_folder=len(layers) == 1 and len(locs) == 1, resume=resume, compute_dtype=compute_dtype,
        # "int4" is a save_chunk format tag, not a numpy dtype
        store_dtype=store_dtype if str(store_dtype) == "int4" else np.dtype(store_dtype), device=device,
    )
    return sum(ChunkStore(f).n_datapoints() for f in folders.values())


def main(argv=None):
    """CLI: ``python -m sparse_coding__tpu_torch.data.activations --dataset_folder D --layers 2 ...``."""
    import argparse

    p = argparse.ArgumentParser(description="Generate LM activation chunks")
    p.add_argument("--model_name", default="EleutherAI/pythia-70m-deduped")
    p.add_argument("--dataset_name", default="NeelNanda/pile-10k")
    p.add_argument("--dataset_folder", required=True)
    p.add_argument("--layers", type=int, nargs="+", required=True)
    p.add_argument("--layer_locs", nargs="+", default=["residual"])
    p.add_argument("--n_chunks", type=int, default=10)
    p.add_argument("--chunk_size_gb", type=float, default=2.0)
    p.add_argument("--center_dataset", action="store_true")
    p.add_argument("--skip_chunks", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="resume from the last committed-and-verified chunk (sc_harvest_cursor.json)")
    p.add_argument("--compute_dtype", default=None, help="e.g. bfloat16")
    p.add_argument("--store_dtype", default="float16", choices=("float16", "int8", "int4"))
    p.add_argument("--device", default=None, help="default cuda; 'cpu' to run on the CPU")
    args = p.parse_args(argv)
    n = setup_data(
        args.model_name, args.dataset_name, args.dataset_folder, layer=args.layers, layer_loc=args.layer_locs,
        n_chunks=args.n_chunks, chunk_size_gb=args.chunk_size_gb, center_dataset=args.center_dataset,
        skip_chunks=args.skip_chunks, compute_dtype=args.compute_dtype, store_dtype=args.store_dtype,
        resume=args.resume, device=args.device,
    )
    print(f"wrote {n} datapoints")


if __name__ == "__main__":
    main()
