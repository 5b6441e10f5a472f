"""Continuous micro-batching encode engine over a `DictRegistry`.

Counterpart of the JAX package's `serve/engine.py`, with its thread model:
one drainer thread owns the device.

  1. requests land in a queue (`submit`, thread-safe);
  2. the drainer pulls what is waiting (up to ``max_batch`` rows, lingering
     ``max_wait_ms`` for stragglers), groups the requests by the registry's
     stacking key, concatenates their rows and pads them to the next
     power-of-two *batch bucket*, so a group only ever sees
     ``len(buckets)`` row counts;
  3. each group runs ONE dispatch over all of its *lanes* (the same-shape
     dictionaries): lane g computes ``lanes[g].encode(x)`` on the padded
     rows, the same op on the same shapes as a stack of one. So a row's
     bits never depend on which other dicts share its micro-batch: each
     lane equals `encode_naive` of the same rows at the same bucket;
  4. each request's slice ``[lane, start:end]`` is copied to the host and
     its future resolved.

On the card each (group, bucket, k-bucket, row dtype) dispatch is a CUDA
graph, captured on its first use (or by `warmup`, which captures the whole
menu) and replayed after: JAX's compiled-step cache. All of an engine's
graphs share one memory pool and replay one after another on the drainer,
which copies each replay's outputs out (or feeds them to the feature
sketch) before the next replay may reuse the pool. Captures run only on
the drainer thread, in ``thread_local`` mode, so handler threads and
registry mutations may use the card meanwhile. A capture that fails
raises; there is no eager fallback on the card. On the CPU the same
dispatch runs eagerly. ``compiled_shapes`` holds the dispatch keys seen
(``serve.compiles`` counts new ones); ``captures`` counts graph captures.

A lane's weights live in buffers the group owns. A `swap` that keeps a
group's lanes copies the new weights into those buffers in place, so its
graphs stay valid; a change of membership builds a new group (and new
graphs).

**Top-k** (``top_k=k``): computed on the device inside the dispatch, in
power-of-two k-buckets (the smallest warmed k-bucket that covers k, else
``k_bucket(k)``), so only ``rows x k-bucket`` indices and values leave the
card. The order is a stable descending one: among equal values the lower
index comes first, as `lax.top_k` orders them (`torch.topk` promises no
order among ties, and every zero after the ReLU is one). Values are the
dense codes gathered at the indices.

**int8 residency**: a group of int8-resident dicts dequantizes its lanes'
weights (the chunk tier's math: fp16 product, cast to the native dtype)
once per micro-batch, a graph of its own, under a ``dequant`` span.

**/features** (`submit_features`): token rows through the attached
subject's capture forward (`data.activations.capture_fn`, the harvest's,
eager), then the group's encode on the device-resident fp16 activations,
with no trip through the host: equal to `harvest_to_device` of the same
tokens followed by the same encode.

Observability as in JAX: ``request_wait`` / ``encode`` / ``dequant`` spans
per micro-batch, ``serve.*`` counters and gauges, per-phase latency
histograms, a ``request_trace`` record per traced request.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparse_coding__tpu_torch.models.learned_dict import dict_leaves, with_leaves

__all__ = ["EncodeEngine", "EngineClosed", "EncodeRequest", "default_buckets", "k_bucket", "topk_stable"]


class EngineClosed(RuntimeError):
    """Raised by `submit` once draining began: the retryable-503 signal."""


def default_buckets(max_batch: int, min_bucket: int = 8) -> Tuple[int, ...]:
    """Power-of-two padded batch sizes up to ``max_batch`` (always included)."""
    out: List[int] = []
    b = min_bucket
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return tuple(out)


def _pow2_ceil(n: int) -> int:
    """Smallest power of two >= max(1, n): the rounding every padded
    dispatch dimension shares (k-buckets, warmup menus, sequence buckets)."""
    n = max(1, int(n))
    b = 1
    while b < n:
        b *= 2
    return b


def k_bucket(k: int, n_feats: int) -> int:
    """The next power of two >= k, capped at ``n_feats`` (the first k of a
    larger sorted top-k are THE top-k)."""
    k = max(1, min(int(k), int(n_feats)))
    return min(_pow2_ceil(k), int(n_feats))


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sequence."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return float(sorted_vals[idx])


def _emit_span(telemetry, category: str, name: str, ts_start: float, seconds: float, **fields) -> None:
    """A span record with an externally measured duration (same counters and
    event as `spans.Span.end`)."""
    if telemetry is None:
        return
    telemetry.counter_inc(f"span.{category}.count")
    telemetry.counter_add_float(f"span.{category}.seconds", seconds)
    telemetry.event("span", category=category, ts_start=round(ts_start, 6), seconds=round(seconds, 6), name=name,
                    **fields)


def topk_stable(codes: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis in a stable descending order: ``(indices
    int32, values)``, values the codes at the indices. Each entry's key is
    its value's order-preserving integer (the total order, -0.0 below +0.0,
    as `lax.top_k` ranks them) times n plus ``n - 1 - index``: unique, so
    `torch.topk` of the keys is exact and puts the lower index first among
    equal values."""
    n = codes.shape[-1]
    key = codes.to(torch.float32).view(torch.int32).to(torch.int64)
    flip = key >> 63  # -1 where negative: flip the magnitude bits there
    key ^= flip.bitwise_and_(0x7FFFFFFF)
    del flip
    key.mul_(n).add_(torch.arange(n - 1, -1, -1, device=codes.device, dtype=torch.int64))
    idx = torch.topk(key, k, dim=-1, largest=True, sorted=True).indices
    return idx.to(torch.int32), torch.gather(codes, -1, idx)


def _float_leaf_dtype(ld, start: torch.dtype) -> torch.dtype:
    dt = start
    for _, _, t in dict_leaves(ld):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            dt = torch.promote_types(dt, t.dtype)
    return dt


# int64 top-k keys held at once (128 MB): lanes are selected in chunks that
# fit, so a large bucket's graph keeps a few lanes' keys, a small one's all
_KEY_BUDGET = 1 << 24


def encode_lanes(lanes: Sequence[Any], x: torch.Tensor, k: Optional[int] = None):
    """Every lane's encode of the same rows ``x`` [B, D]: codes [G, B, N],
    or with ``k`` the stable top-k ``(indices, values)`` [G, B, k]. Lane g
    is ``lanes[g].encode`` alone, on the same shapes whatever G is, written
    into its slice of the output (one lane's temporaries at a time); the
    top-k runs on chunks of lanes within `_KEY_BUDGET` keys, exact, so its
    bits do not depend on the chunk either. Rows and weights meet in their
    promoted dtype (JAX's promotion: f16 or bf16 rows into an f32 dict
    compute in f32)."""
    if k is not None:
        step = max(1, min(len(lanes), _KEY_BUDGET // max(1, x.shape[0] * int(getattr(lanes[0], "n_feats", 1)))))
        out = None
        for lo in range(0, len(lanes), step):
            parts = topk_stable(encode_lanes(lanes[lo:lo + step], x), k)
            if out is None:
                out = tuple(torch.empty((len(lanes), *t.shape[1:]), dtype=t.dtype, device=t.device) for t in parts)
            for o, t in zip(out, parts):
                o[lo:lo + step].copy_(t)
            del parts
        return out
    common = _float_leaf_dtype(lanes[0], x.dtype)
    xc = x.to(common)
    out = None
    for g, ld in enumerate(lanes):
        leaves = [t.to(common) if isinstance(t, torch.Tensor) and t.is_floating_point() else t
                  for _, _, t in dict_leaves(ld)]
        code = (with_leaves(ld, leaves) if leaves else ld).encode(xc)
        if out is None:
            out = torch.empty((len(lanes), *code.shape), dtype=code.dtype, device=code.device)
        out[g].copy_(code)
        del code
    return out


# request-row dtypes served as they are (the dtype round-trip contract);
# anything else (json lists land f64) is coerced to f32
_NATIVE_ROW_DTYPES = (torch.float32, torch.float16, torch.bfloat16)


def _host_rows(rows) -> torch.Tensor:
    """Request rows as a CPU tensor: numpy or torch in, native float dtypes
    kept, anything else coerced to f32."""
    if isinstance(rows, torch.Tensor):
        t = rows.detach().cpu()
    else:
        a = np.asarray(rows)
        if a.dtype not in (np.dtype(np.float32), np.dtype(np.float16)):
            a = np.asarray(a, dtype=np.float32)
        a = np.ascontiguousarray(a)
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
    return t if t.dtype in _NATIVE_ROW_DTYPES else t.to(torch.float32)


def _host_result(t: torch.Tensor):
    """A result on the host: numpy, or a CPU ``torch.bfloat16`` tensor (numpy
    has no bf16)."""
    return t if t.dtype == torch.bfloat16 else t.numpy()


class EncodeRequest:
    """One in-flight encode: rows in, codes (or an error) out. ``kind`` is
    ``"encode"`` (activation rows) or ``"features"`` (int32 token rows
    ``[n_seq, seq_len]`` of ``subject``); ``top_k`` (clamped) makes the
    result ``(indices, values)``. ``bucket`` is the dispatch's padded row
    count once served (a row's bits are those of `encode_naive` at it)."""

    __slots__ = ("dict_id", "rows", "t_enqueue_mono", "t_enqueue_wall", "done", "codes", "error", "latency_ms",
                 "trace", "wait_s", "top_k", "kind", "subject", "bucket")

    def __init__(self, dict_id: str, rows, trace=None, top_k: Optional[int] = None, kind: str = "encode",
                 subject: Optional[str] = None):
        self.dict_id = dict_id
        self.rows = rows
        self.trace = trace
        self.top_k = top_k
        self.kind = kind
        self.subject = subject
        self.t_enqueue_mono = time.monotonic()
        self.t_enqueue_wall = time.time()
        self.done = threading.Event()
        self.codes = None
        self.error: Optional[BaseException] = None
        self.latency_ms: Optional[float] = None
        self.wait_s: Optional[float] = None
        self.bucket: Optional[int] = None

    @property
    def cost_rows(self) -> int:
        """Activation rows this request costs the batch budget."""
        if self.kind == "features":
            return int(self.rows.shape[0]) * int(self.rows.shape[1])
        return int(self.rows.shape[0])

    def result(self, timeout: Optional[float] = None):
        if not self.done.wait(timeout):
            raise TimeoutError(f"encode request for {self.dict_id!r} timed out after {timeout}s")
        if self.error is not None:
            raise self.error
        return self.codes

    def _resolve(self, codes, error: Optional[BaseException] = None) -> None:
        self.codes = codes
        self.error = error
        if self.latency_ms is None:
            self.latency_ms = (time.monotonic() - self.t_enqueue_mono) * 1e3
        self.done.set()


class _Control:
    """Work the drainer runs for another thread (captures, route checks)."""

    __slots__ = ("fn", "done", "value", "error")
    cost_rows = 0

    def __init__(self, fn: Callable[[], Any]):
        self.fn, self.done, self.value, self.error = fn, threading.Event(), None, None

    def _resolve(self, value, error: Optional[BaseException] = None) -> None:
        self.value, self.error = value, error
        self.done.set()


class _Graph:
    """One captured dispatch: the CUDA graph, its static input and outputs."""

    __slots__ = ("graph", "x", "out")

    def __init__(self, graph, x, out):
        self.graph, self.x, self.out = graph, x, out


def _own(t, device):
    return t.detach().to(device, copy=True) if isinstance(t, torch.Tensor) else t


class _Stack:
    """One group's lanes: dict ids in lane order, the buffers that hold each
    lane's weights (int8: also its q and scales; the weights are then the
    dequant's output), the lane dicts over those buffers, and the group's
    captured graphs."""

    __slots__ = ("ids", "entries", "weights", "n_feats", "activation_size", "bufs", "qbufs", "lanes", "graphs")

    def __init__(self, entries, device):
        self.ids = [e.dict_id for e in entries]
        self.entries = list(entries)
        self.weights = entries[0].weights
        self.n_feats = int(entries[0].n_feats)
        self.activation_size = int(entries[0].activation_size)
        self.qbufs = None
        if self.weights == "native":
            self.bufs = [[_own(t, device) for _, _, t in dict_leaves(e.ld)] for e in entries]
        else:
            self.qbufs = [[None if m is None else (_own(m["q"], device), _own(m["scales"], device))
                           for m in e.quant_leaves] for e in entries]
            self.bufs = [[_own(t, device) if m is None else torch.empty(t.shape, dtype=t.dtype, device=device)
                          for (_, _, t), m in zip(dict_leaves(e.ld), e.quant_leaves)] for e in entries]
        self.lanes = [with_leaves(e.ld, b) if b else e.ld for e, b in zip(entries, self.bufs)]
        self.graphs: Dict[Tuple, _Graph] = {}

    @property
    def size(self) -> int:
        return len(self.ids)

    def refresh(self, entries) -> None:
        """Copy swapped-in lanes' weights into the buffers, in place: every
        graph of the group stays valid."""
        with torch.no_grad():
            for i, e in enumerate(entries):
                if e is self.entries[i]:
                    continue
                if self.qbufs is None:
                    pairs = [(b, t) for b, (_, _, t) in zip(self.bufs[i], dict_leaves(e.ld))]
                else:
                    pairs = []
                    for j, ((_, _, t), m) in enumerate(zip(dict_leaves(e.ld), e.quant_leaves)):
                        pairs += [(self.bufs[i][j], t)] if m is None else list(zip(self.qbufs[i][j], (m["q"], m["scales"])))
                for dst, src in pairs:
                    if isinstance(dst, torch.Tensor):
                        dst.copy_(src)
                self.entries[i] = e

    def dequant(self) -> None:
        """Rebuild each int8 lane's weights from its q and scales (the chunk
        tier's fp16 product, cast to the native dtype)."""
        from sparse_coding__tpu_torch.data.chunks import dequant_int8

        with torch.no_grad():
            for bufs, qbufs in zip(self.bufs, self.qbufs):
                for b, qs in zip(bufs, qbufs):
                    if qs is not None:
                        b.copy_(dequant_int8(*qs).to(b.dtype))


class EncodeEngine:
    """See the module docstring. Lifecycle: ``start()`` → submits →
    ``stop()`` (``drain=True`` completes everything already accepted: the
    graceful drain the server's SIGTERM path rides). Runs on the
    registry's device."""

    def __init__(self, registry, max_batch: int = 256, max_wait_ms: float = 2.0,
                 buckets: Optional[Sequence[int]] = None, telemetry=None, latency_window: int = 4096,
                 feature_stats=None):
        self.registry = registry
        self.device = registry.device
        self.telemetry = telemetry
        if feature_stats is not None and not hasattr(feature_stats, "cfg"):
            from sparse_coding__tpu_torch.telemetry.feature_stats import ServeFeatureStats

            feature_stats = ServeFeatureStats(feature_stats) if feature_stats else None
        self.feature_stats = feature_stats
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.buckets = tuple(sorted(buckets)) if buckets else default_buckets(self.max_batch)
        if self.buckets[-1] < self.max_batch:
            raise ValueError("largest bucket must cover max_batch")
        self._q: "queue.Queue" = queue.Queue()
        self._accepting = False
        # orders submit's accepting-check-then-enqueue against stop's flip
        self._submit_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stacks: Dict[Tuple, _Stack] = {}
        self._naive_stacks: Dict[str, Tuple[int, _Stack]] = {}
        self._stacks_generation = -1
        self._lock = threading.Lock()
        self._latencies: List[float] = []
        self._latency_window = int(latency_window)
        self._warm_ks: set = set()
        self._side = None  # capture stream
        self._pool = None  # the engine's one graph pool
        # dispatch keys seen; a new one is a new graph on the card (a steady
        # set under varied traffic is the no-capture-after-warmup proof)
        self.compiled_shapes: set = set()
        self.captures = 0
        self.capture_seconds = 0.0
        self.stats = {"requests": 0, "rows": 0, "batches": 0, "padded_rows": 0, "rejected": 0, "errors": 0}

    @property
    def _graphs_on(self) -> bool:
        return self.device.type == "cuda"

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "EncodeEngine":
        if self._thread is not None:
            return self
        self._accepting = True
        self._thread = threading.Thread(target=self._loop, daemon=True, name="encode-engine")
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop accepting and shut the drainer down. ``drain=True`` completes
        every request already accepted; ``drain=False`` fails them with
        `EngineClosed`."""
        with self._submit_lock:
            self._accepting = False
        if self._thread is None:
            self._fail_pending(EngineClosed("engine never started"))
            return
        if not drain:
            self._fail_pending(EngineClosed("engine stopped without drain"))
        self._q.put(None)  # wake the drainer so it sees _accepting=False
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("encode engine failed to drain in time")
        self._thread = None
        self._fail_pending(EngineClosed("engine stopped"))

    def _fail_pending(self, exc: BaseException) -> None:
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            if req is not None:
                req._resolve(None, exc)

    def _on_drainer(self, fn: Callable[[], Any], timeout: Optional[float] = None):
        """Run ``fn`` on the drainer thread (inline when the engine is not
        running or this is the drainer): graphs are captured and replayed
        there only."""
        t = self._thread
        if t is None or not t.is_alive() or threading.current_thread() is t:
            return fn()
        ctl = _Control(fn)
        self._q.put(ctl)
        if not ctl.done.wait(timeout):
            raise TimeoutError("the encode engine's drainer did not run the request in time")
        if ctl.error is not None:
            raise ctl.error
        return ctl.value

    # -- submission ------------------------------------------------------------

    def _validate(self, dict_id: str, rows) -> torch.Tensor:
        entry = self.registry.get(dict_id)  # KeyError → 404 upstream
        arr = _host_rows(rows)
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.ndim != 2 or arr.shape[0] == 0:
            raise ValueError(f"rows must be [n, {entry.activation_size}], got {tuple(arr.shape)}")
        if arr.shape[1] != entry.activation_size:
            raise ValueError(f"dict {dict_id!r} encodes width {entry.activation_size}, "
                             f"got rows of width {arr.shape[1]}")
        if arr.shape[0] > self.max_batch:
            raise ValueError(f"request of {arr.shape[0]} rows exceeds max_batch {self.max_batch} — "
                             "split it client-side")
        return arr

    def clamp_k(self, dict_id: str, top_k) -> Optional[int]:
        """The served k for a requested top-k, clamped into ``[1, n_feats]``."""
        if top_k is None:
            return None
        entry = self.registry.get(dict_id)
        if entry.n_feats <= 0:
            raise ValueError(f"dict {dict_id!r} reports no n_feats — top-k unsupported")
        return max(1, min(int(top_k), int(entry.n_feats)))

    def _enqueue(self, req: EncodeRequest) -> EncodeRequest:
        with self._submit_lock:
            if not self._accepting:
                with self._lock:
                    self.stats["rejected"] += 1
                if self.telemetry is not None:
                    self.telemetry.counter_inc("serve.rejected")
                raise EngineClosed("engine is draining — retry against a live replica")
            self._q.put(req)
        if self.telemetry is not None:
            self.telemetry.gauge_set("serve.queue_depth", self._q.qsize())
        return req

    def submit(self, dict_id: str, rows, trace=None, top_k: Optional[int] = None) -> EncodeRequest:
        """Enqueue one encode; returns the request future. Raises
        `EngineClosed` when draining, `KeyError` for an unknown dict,
        `ValueError` for bad rows. ``top_k=k`` makes the result a sparse
        ``(indices, values)`` pair."""
        arr = self._validate(dict_id, rows)
        k = self.clamp_k(dict_id, top_k)
        return self._enqueue(EncodeRequest(dict_id, arr, trace=trace, top_k=k))

    def encode(self, dict_id: str, rows, timeout: Optional[float] = 60.0, trace=None, top_k: Optional[int] = None):
        """Blocking convenience wrapper around `submit`."""
        return self.submit(dict_id, rows, trace=trace, top_k=top_k).result(timeout)

    def encode_topk(self, dict_id: str, rows, k: int, timeout: Optional[float] = 60.0, trace=None):
        """Sparse encode: ``(indices int32 [n, k], values [n, k])``, values
        the dense codes at the indices, stable descending per row."""
        return self.encode(dict_id, rows, timeout=timeout, trace=trace, top_k=int(k))

    # -- /features -------------------------------------------------------------

    def _validate_features(self, dict_id: str, tokens, subject: Optional[str]) -> Tuple[torch.Tensor, str]:
        entry = self.registry.get(dict_id)  # KeyError → 404 upstream
        subj = self.registry.get_subject(subject)  # KeyError → 404 upstream
        if subj.activation_size != entry.activation_size:
            raise ValueError(f"dict {dict_id!r} encodes width {entry.activation_size} but subject "
                             f"{subj.subject_id!r} captures width {subj.activation_size} at {subj.tensor_name}")
        arr = np.asarray(tokens.detach().cpu() if isinstance(tokens, torch.Tensor) else tokens)
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.ndim != 2 or arr.shape[0] == 0 or arr.shape[1] == 0:
            raise ValueError(f"tokens must be [n_seq, seq_len], got {arr.shape}")
        if arr.dtype.kind not in ("i", "u"):
            raise ValueError(f"tokens must be integers, got dtype {arr.dtype}")
        if arr.shape[1] > subj.lm_cfg.n_ctx:
            raise ValueError(f"seq_len {arr.shape[1]} exceeds subject n_ctx {subj.lm_cfg.n_ctx}")
        cap = self._seq_cap(arr.shape[1])
        if arr.shape[1] > self.max_batch or arr.shape[0] > cap:
            raise ValueError(f"request of {arr.shape[0]}x{arr.shape[1]} token rows exceeds the {cap}-sequence "
                             f"dispatch cap at seq_len {arr.shape[1]} (max_batch {self.max_batch}) — split it "
                             "client-side")
        return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32)), subj.subject_id

    def _seq_cap(self, seq_len: int) -> int:
        """Largest power-of-two sequence count whose padded dispatch stays in
        the ``max_batch`` row budget at this seq_len: the shared ceiling of
        validation, warmup and the drainer's chunking."""
        cap = _pow2_ceil(max(1, self.max_batch // max(1, int(seq_len))))
        while cap > 1 and cap * int(seq_len) > self.max_batch:
            cap //= 2
        return cap

    def submit_features(self, dict_id: str, tokens, subject: Optional[str] = None, trace=None,
                        top_k: Optional[int] = None) -> EncodeRequest:
        """Enqueue one capture-then-encode of int token rows ``[n_seq,
        seq_len]``: codes (or top-k) for all ``n_seq x seq_len`` positions."""
        arr, subject_id = self._validate_features(dict_id, tokens, subject)
        k = self.clamp_k(dict_id, top_k)
        return self._enqueue(EncodeRequest(dict_id, arr, trace=trace, top_k=k, kind="features",
                                           subject=subject_id))

    def encode_features(self, dict_id: str, tokens, subject: Optional[str] = None, timeout: Optional[float] = 60.0,
                        trace=None, top_k: Optional[int] = None):
        """Blocking convenience wrapper around `submit_features`."""
        return self.submit_features(dict_id, tokens, subject=subject, trace=trace, top_k=top_k).result(timeout)

    # -- the stack-of-one reference --------------------------------------------

    def encode_naive(self, dict_id: str, rows, top_k: Optional[int] = None, bucket: Optional[int] = None):
        """This request alone: a stack of one at the request's bucket (or the
        given one), eager, on the calling thread. Each lane of the
        micro-batched path equals it bit for bit at the same bucket."""
        arr = self._validate(dict_id, rows)
        k = self.clamp_k(dict_id, top_k)
        stack = self._naive_stack(dict_id)
        bucket = self._bucket_for(arr.shape[0]) if bucket is None else int(bucket)
        if bucket < arr.shape[0]:
            raise ValueError(f"bucket {bucket} is smaller than the request's {arr.shape[0]} rows")
        kb = None if k is None else self._dispatch_k(k, stack.n_feats)
        if stack.weights == "int8":
            stack.dequant()
        out = encode_lanes(stack.lanes, self._padded_on_device(arr, bucket), kb)
        return self._fetch([(out, 0, 0, arr.shape[0], k)])[0]

    def features_naive(self, dict_id: str, tokens, subject: Optional[str] = None, top_k: Optional[int] = None,
                       seq_bucket: Optional[int] = None):
        """`encode_naive` for token rows: the capture forward at the request's
        sequence bucket (or the given one), then the stack-of-one encode."""
        toks, subject_id = self._validate_features(dict_id, tokens, subject)
        subj = self.registry.get_subject(subject_id)
        k = self.clamp_k(dict_id, top_k)
        stack = self._naive_stack(dict_id)
        seq_bucket = _pow2_ceil(toks.shape[0]) if seq_bucket is None else int(seq_bucket)
        if stack.weights == "int8":
            stack.dequant()
        rows = self._capture_rows(subj, self._padded_on_device(toks, seq_bucket))
        kb = None if k is None else self._dispatch_k(k, stack.n_feats)
        out = encode_lanes(stack.lanes, rows, kb)
        return self._fetch([(out, 0, 0, toks.shape[0] * toks.shape[1], k)])[0]

    def compare_routes(self, dict_id: str, rows, top_k: Optional[int] = None) -> Dict[str, Any]:
        """The three routes one request's rows can take, at its bucket: the
        group's dispatch as the drainer runs it (a graph replay on the card),
        the same dispatch eagerly, and the stack of one (`encode_naive`).
        The contract holds the three equal bit for bit."""
        arr = self._validate(dict_id, rows)
        k = self.clamp_k(dict_id, top_k)

        def run():
            stack = self._group_stack_for(dict_id)
            lane = stack.ids.index(dict_id)
            bucket = self._bucket_for(arr.shape[0])
            kb = None if k is None else self._dispatch_k(k, stack.n_feats)
            routed, _ = self._dispatch(stack, arr, bucket, kb)
            got = self._fetch([(routed, lane, 0, arr.shape[0], k)])[0]
            eager = encode_lanes(stack.lanes, self._padded_on_device(arr, bucket), kb)
            return got, self._fetch([(eager, lane, 0, arr.shape[0], k)])[0]

        graph, eager = self._on_drainer(run)
        return {"graph": graph, "eager": eager, "naive": self.encode_naive(dict_id, arr, top_k=k)}

    # -- internals -------------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _dispatch_k(self, k: int, n_feats: int) -> int:
        """The dispatch's k-bucket: the smallest warmed k-bucket covering
        ``k_bucket(k)``, else that bucket itself."""
        kb = k_bucket(k, n_feats)
        warmed = [w for w in {k_bucket(w, n_feats) for w in self._warm_ks} if w >= kb]
        return min(warmed, default=kb)

    def _padded_on_device(self, arr: torch.Tensor, rows: int) -> torch.Tensor:
        out = torch.zeros((rows, *arr.shape[1:]), dtype=arr.dtype, device=self.device)
        out[: arr.shape[0]].copy_(arr)
        return out

    def _rebuild_stacks(self) -> None:
        gen, entries = self.registry.snapshot()
        groups: Dict[Tuple, List] = {}
        for e in entries.values():
            groups.setdefault((e.group_key, e.weights), []).append(e)
        stacks: Dict[Tuple, _Stack] = {}
        for key, es in groups.items():
            es = sorted(es, key=lambda e: e.dict_id)
            old = self._stacks.get(key)
            if old is not None and old.ids == [e.dict_id for e in es]:
                old.refresh(es)  # same lanes: new weights in place, graphs kept
                stacks[key] = old
            else:
                stacks[key] = _Stack(es, self.device)
        self._stacks = stacks
        self._stacks_generation = gen

    def _stacks_current(self) -> Dict[Tuple, _Stack]:
        if self._stacks_generation != self.registry.generation:
            self._rebuild_stacks()
        return self._stacks

    def _group_stack_for(self, dict_id: str) -> _Stack:
        entry = self.registry.get(dict_id)
        return self._stacks_current()[(entry.group_key, entry.weights)]

    def _naive_stack(self, dict_id: str) -> _Stack:
        """The stack of one of ``dict_id``, cached per generation."""
        entry = self.registry.get(dict_id)
        cached = self._naive_stacks.get(dict_id)
        if cached is not None and cached[0] == self.registry.generation:
            return cached[1]
        stack = _Stack([entry], self.device)
        self._naive_stacks[dict_id] = (self.registry.generation, stack)
        return stack

    def _note_compile_key(self, key: Tuple) -> bool:
        if key in self.compiled_shapes:
            return False
        self.compiled_shapes.add(key)
        if self.telemetry is not None:
            self.telemetry.counter_inc("serve.compiles")
        return True

    def _capture(self, fn: Callable[[], Any]):
        """``fn`` once eagerly on the capture stream, then captured into the
        engine's pool: ``(graph, fn's outputs)``. Thread-local capture, on
        the drainer only."""
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        side = self._side
        side.wait_stream(main)
        with torch.cuda.stream(side), torch.no_grad():
            fn()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool, stream=side, capture_error_mode="thread_local"):
                out = fn()
        main.wait_stream(side)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return graph, out

    def _dequant_stacked(self, stack: _Stack, traces: Optional[List[str]] = None) -> float:
        """int8 groups rebuild their lanes' weights for this micro-batch
        (fenced, span-attributed); the dequant's seconds."""
        if stack.weights != "int8":
            return 0.0
        t0, t0m = time.time(), time.monotonic()
        if self._graphs_on:
            g = stack.graphs.get(("dequant",))
            if g is None:
                self._note_compile_key(("dequant", tuple(stack.ids)))
                graph, _ = self._capture(stack.dequant)
                g = stack.graphs[("dequant",)] = _Graph(graph, None, None)
            g.graph.replay()
            torch.cuda.current_stream(self.device).synchronize()
        else:
            stack.dequant()
        dequant_s = time.monotonic() - t0m
        _emit_span(self.telemetry, "dequant", "dequant_int8", t0, dequant_s, lanes=stack.size,
                   **({"traces": traces} if traces else {}))
        if self.telemetry is not None:
            self.telemetry.hist_observe("serve.phase.dequant_ms", dequant_s * 1e3)
        return dequant_s

    def _run_lanes(self, stack: _Stack, key: Tuple, x_shape, x_dtype, kb: Optional[int], fill) -> Any:
        """The group's dispatch at ``key``: a replay of its graph on the card
        (captured on first use) after ``fill(x)`` writes the static input;
        on the CPU the same encode eagerly."""
        if not self._graphs_on:
            x = torch.empty(x_shape, dtype=x_dtype, device=self.device)
            fill(x)
            return encode_lanes(stack.lanes, x, kb)
        g = stack.graphs.get(key)
        if g is None:
            x = torch.zeros(x_shape, dtype=x_dtype, device=self.device)
            graph, out = self._capture(lambda: encode_lanes(stack.lanes, x, kb))
            g = stack.graphs[key] = _Graph(graph, x, out)
        fill(g.x)
        g.graph.replay()
        return g.out

    def _dispatch(self, stack: _Stack, rows: torch.Tensor, bucket: int, kb: Optional[int] = None,
                  traces: Optional[List[str]] = None) -> Tuple[Any, float]:
        """One micro-batch of host rows [n, D] through the group, padded to
        ``bucket`` (int8 groups dequantize first). Returns ``(device
        outputs, dequant seconds)``; the outputs are valid until the next
        dispatch."""
        dequant_s = self._dequant_stacked(stack, traces)
        dt = str(rows.dtype).rpartition(".")[2]
        key = ("encode", stack.weights, tuple(stack.ids), bucket, dt, kb)
        self._note_compile_key(key)
        n = rows.shape[0]
        src = rows.pin_memory() if self._graphs_on else rows

        def fill(x):
            x[:n].copy_(src, non_blocking=True)
            x[n:].zero_()

        return self._run_lanes(stack, key[3:], (bucket, rows.shape[1]), rows.dtype, kb, fill), dequant_s

    def _capture_rows(self, subject, tokens: torch.Tensor) -> torch.Tensor:
        """The harvest's capture forward over token rows on the device: fp16
        activations [n_seq * seq_len, width]."""
        from sparse_coding__tpu_torch.data.activations import capture_fn

        capture = capture_fn(subject.lm_cfg, (subject.tensor_name,), subject.stop_at)
        act = capture(subject.params, tokens)[subject.tensor_name]
        return act.reshape(-1, act.shape[-1])

    def _dispatch_features(self, subject, stack: _Stack, tokens: torch.Tensor, kb: Optional[int] = None,
                           traces: Optional[List[str]] = None) -> Tuple[Any, float]:
        """One capture-then-encode of padded host token rows: the capture
        forward eagerly, its fp16 activations copied on the device into the
        group's dispatch (no host round trip in between)."""
        dequant_s = self._dequant_stacked(stack, traces)
        key = ("features", subject.subject_id, stack.weights, tuple(stack.ids), tuple(tokens.shape), kb)
        self._note_compile_key(key)
        act = self._capture_rows(subject, tokens.to(self.device, non_blocking=True))

        def fill(x):
            x.copy_(act)

        return self._run_lanes(stack, key[4:], tuple(act.shape), act.dtype, kb, fill), dequant_s

    def _fetch(self, parts) -> List[Any]:
        """Copy request slices of dispatch outputs to the host in one sync:
        ``parts`` of ``(out, lane, lo, hi, k)`` (``k`` None for dense codes,
        else the request's k out of the dispatch's k-bucket)."""
        staged = []
        for out, lane, lo, hi, k in parts:
            srcs = [out[lane, lo:hi]] if k is None else [t[lane, lo:hi] for t in out]
            if self._graphs_on:
                dsts = [torch.empty(s.shape, dtype=s.dtype, pin_memory=True) for s in srcs]
                for d, s in zip(dsts, srcs):
                    d.copy_(s, non_blocking=True)
            else:
                dsts = [s.clone() for s in srcs]
            staged.append((dsts, k))
        if self._graphs_on:
            torch.cuda.current_stream(self.device).synchronize()
        return [_host_result(d[0]) if k is None else (d[0][:, :k].numpy(), _host_result(d[1][:, :k].contiguous()))
                for d, k in staged]

    def _drain_once(self, block_s: float) -> bool:
        """One scheduler cycle. Returns False when the engine should exit."""
        try:
            first = self._q.get(timeout=block_s)
        except queue.Empty:
            return self._accepting or not self._q.empty()
        if first is None:
            return not self._q.empty()  # sentinel: exit once drained
        if isinstance(first, _Control):
            self._run_control(first)
            return True
        batch_reqs: List[EncodeRequest] = [first]
        controls: List[_Control] = []
        rows_budget = self.max_batch - first.cost_rows
        deadline = time.monotonic() + self.max_wait_ms / 1e3
        saw_sentinel = False
        while rows_budget > 0:
            wait = deadline - time.monotonic()
            try:
                nxt = self._q.get(timeout=max(0.0, wait) if wait > 0 else 0.0)
            except queue.Empty:
                break
            if nxt is None:
                saw_sentinel = True
                break
            if isinstance(nxt, _Control):
                controls.append(nxt)
                continue
            if nxt.cost_rows > rows_budget:
                self._q.put(nxt)  # over budget: the next cycle's
                break
            batch_reqs.append(nxt)
            rows_budget -= nxt.cost_rows
        try:
            self._process(batch_reqs)
        except Exception as e:
            # the drainer must never die: a failure resolves the batch with it
            for r in batch_reqs:
                if not r.done.is_set():
                    self._record_error(r, e)
        for c in controls:
            self._run_control(c)
        if saw_sentinel:
            return not self._q.empty()
        return True

    @staticmethod
    def _run_control(ctl: _Control) -> None:
        try:
            ctl._resolve(ctl.fn())
        except BaseException as e:  # handed to the waiting thread
            ctl._resolve(None, e)

    def _process(self, reqs: List[EncodeRequest]) -> None:
        t_drain_wall = time.time()
        t_drain_mono = time.monotonic()
        # one request_wait span per drained batch: the window from the
        # earliest enqueue to the drain (per-request waits overlap)
        oldest = min(r.t_enqueue_mono for r in reqs)
        waits_ms = []
        for r in reqs:
            r.wait_s = t_drain_mono - r.t_enqueue_mono
            waits_ms.append(r.wait_s * 1e3)
            if self.telemetry is not None:
                self.telemetry.hist_observe("serve.phase.request_wait_ms", r.wait_s * 1e3)
        traced = [r.trace.trace_id for r in reqs if r.trace is not None]
        _emit_span(self.telemetry, "request_wait", "queue", min(r.t_enqueue_wall for r in reqs),
                   t_drain_mono - oldest, n_requests=len(reqs), mean_wait_ms=round(sum(waits_ms) / len(waits_ms), 3),
                   **({"traces": traced} if traced else {}))
        # the batch key: the lanes (group key, residency) and what one
        # dispatch must agree on: kind, row dtype (a concat would promote
        # mixed dtypes), dense or sparse, and for features (subject, seq_len)
        by_group: Dict[Tuple, List[EncodeRequest]] = {}
        for r in reqs:
            try:
                entry = self.registry.get(r.dict_id)
                if r.kind == "features":
                    sig = ("features", r.subject, int(r.rows.shape[1]))
                else:
                    sig = ("encode", str(r.rows.dtype))
                by_group.setdefault((entry.group_key, entry.weights, sig, r.top_k is not None), []).append(r)
            except KeyError as e:  # removed between submit and drain
                self._record_error(r, e)
        stacks = self._stacks_current()
        for key, group_reqs in by_group.items():
            stack_key = key[:2]
            stack = stacks.get(stack_key)
            if stack is None:
                # registry mutated between lookup and stack build: retry once
                self._rebuild_stacks()
                stack = self._stacks.get(stack_key)
            if stack is None:
                for r in group_reqs:
                    self._record_error(r, KeyError(r.dict_id))
                continue
            if key[2][0] == "features":
                self._run_features_group(stack, group_reqs, t_drain_wall)
            else:
                self._run_group(stack, group_reqs, t_drain_wall)

    def _filter_lanes(self, stack: _Stack, reqs: List[EncodeRequest]):
        # a dict hot-removed after grouping while its group survives: its
        # requests error, the rest of the batch serves
        lane_of = {did: i for i, did in enumerate(stack.ids)}
        for r in reqs:
            if r.dict_id not in lane_of:
                self._record_error(r, KeyError(r.dict_id))
        return lane_of, [r for r in reqs if r.dict_id in lane_of]

    def _request_trace_record(self, r: EncodeRequest, encode_s: float, dequant_s: float, bucket: int, lanes: int,
                              n_requests: int) -> None:
        if r.trace is None or self.telemetry is None:
            return
        fields = {}
        if r.top_k is not None:
            fields["k"] = int(r.top_k)
        if r.kind == "features":
            fields["kind"] = "features"
        self.telemetry.event(
            "request_trace", trace_id=r.trace.trace_id, span_id=r.trace.span_id, parent_span=r.trace.parent_span,
            dict=r.dict_id, rows=r.cost_rows, ts_start=round(r.t_enqueue_wall, 6), latency_ms=round(r.latency_ms, 3),
            phases={"request_wait": round(r.wait_s or 0.0, 6), "encode": round(encode_s, 6),
                    "dequant": round(dequant_s, 6)},
            bucket=bucket, lanes=lanes, n_requests=n_requests, **fields)

    def _serve(self, stack: _Stack, lane_of: Dict[str, int], reqs: List[EncodeRequest], name: str, n_rows: int,
               bucket: int, kb: Optional[int], run: Callable[[], Tuple[Any, float]], row_span: Callable,
               counter: Optional[str] = None, **span_fields) -> None:
        """Run one dispatch for ``reqs``, feed the sketch, book the stats
        (and ``counter``), then resolve each request with its slice
        (``row_span(r)`` = its rows in the dispatch): a caller that has its
        result finds it counted."""
        traced = [r.trace.trace_id for r in reqs if r.trace is not None]
        extra = {"traces": traced} if traced else {}
        if kb is not None:
            extra["k"] = kb
        try:
            t0_wall, t0 = time.time(), time.monotonic()
            out, dequant_s = run()
            spans = [row_span(r) for r in reqs]
            results = self._fetch([(out, lane_of[r.dict_id], lo, hi, r.top_k) for r, (lo, hi) in zip(reqs, spans)])
            encode_s = time.monotonic() - t0
            _emit_span(self.telemetry, "encode", name, t0_wall, encode_s, lanes=stack.size, rows=n_rows,
                       bucket=bucket, n_requests=len(reqs), **span_fields, **extra)
            if self.telemetry is not None:
                self.telemetry.hist_observe("serve.phase.encode_ms", encode_s * 1e3)
        except Exception as e:  # a failed dispatch must not kill the drainer
            for r in reqs:
                self._record_error(r, e)
            return
        done = time.monotonic()
        for r in reqs:
            r.bucket, r.latency_ms = bucket, (done - r.t_enqueue_mono) * 1e3
        if self.feature_stats is not None:
            # only the owning lane's rows are served: the sketch counts those
            fmask = np.zeros((stack.size, bucket), np.float32)
            for r, (lo, hi) in zip(reqs, spans):
                fmask[lane_of[r.dict_id], lo:hi] = 1.0
            if kb is not None:
                self.feature_stats.accumulate_topk(stack.ids, stack.n_feats, out[0], out[1], fmask)
            else:
                self.feature_stats.accumulate_dense(stack.ids, stack.n_feats, out, fmask)
        self._note_served(reqs, n_rows, bucket)
        if counter is not None and self.telemetry is not None:
            self.telemetry.counter_inc(counter, len(reqs))
        for r, res in zip(reqs, results):
            r._resolve(res)
            self._request_trace_record(r, encode_s, dequant_s, bucket, stack.size, len(reqs))

    def _run_group(self, stack: _Stack, reqs: List[EncodeRequest], t_wall: float) -> None:
        lane_of, reqs = self._filter_lanes(stack, reqs)
        if not reqs:
            return
        rows = torch.cat([r.rows for r in reqs], dim=0)
        bucket = self._bucket_for(rows.shape[0])
        sparse = reqs[0].top_k is not None  # the batch key makes a group all dense or all sparse
        kb = self._dispatch_k(max(r.top_k for r in reqs), stack.n_feats) if sparse else None
        starts = np.cumsum([0] + [r.rows.shape[0] for r in reqs])
        span_of = {id(r): (int(starts[i]), int(starts[i + 1])) for i, r in enumerate(reqs)}
        traced = [r.trace.trace_id for r in reqs if r.trace is not None] or None
        self._serve(stack, lane_of, reqs, f"encode_g{stack.size}_b{bucket}", int(rows.shape[0]), bucket, kb,
                    lambda: self._dispatch(stack, rows, bucket, kb, traces=traced), lambda r: span_of[id(r)],
                    counter="serve.sparse_requests" if sparse else None)

    def _run_features_group(self, stack: _Stack, reqs: List[EncodeRequest], t_wall: float) -> None:
        """Token requests of one (subject, seq_len, group): concatenated on
        the sequence axis and padded to a power-of-two sequence bucket
        capped by `_seq_cap`, in as many chunks as the cap needs, so no
        dispatch exceeds a shape `warmup_features` warmed."""
        lane_of, reqs = self._filter_lanes(stack, reqs)
        if not reqs:
            return
        seq_len = int(reqs[0].rows.shape[1])
        cap = self._seq_cap(seq_len)
        chunk: List[EncodeRequest] = []
        n_seqs = 0
        for r in reqs:
            if chunk and n_seqs + r.rows.shape[0] > cap:
                self._run_features_chunk(stack, lane_of, chunk, seq_len)
                chunk, n_seqs = [], 0
            chunk.append(r)
            n_seqs += int(r.rows.shape[0])
        if chunk:
            self._run_features_chunk(stack, lane_of, chunk, seq_len)

    def _run_features_chunk(self, stack: _Stack, lane_of: Dict[str, int], reqs: List[EncodeRequest],
                            seq_len: int) -> None:
        try:
            subject = self.registry.get_subject(reqs[0].subject)
        except KeyError as e:  # detached between submit and drain
            for r in reqs:
                self._record_error(r, e)
            return
        tokens = torch.cat([r.rows for r in reqs], dim=0)
        seq_bucket = _pow2_ceil(tokens.shape[0])
        padded = torch.zeros((seq_bucket, seq_len), dtype=torch.int32)
        padded[: tokens.shape[0]] = tokens
        sparse = reqs[0].top_k is not None
        kb = self._dispatch_k(max(r.top_k for r in reqs), stack.n_feats) if sparse else None
        starts = np.cumsum([0] + [r.rows.shape[0] * seq_len for r in reqs])
        span_of = {id(r): (int(starts[i]), int(starts[i + 1])) for i, r in enumerate(reqs)}
        traced = [r.trace.trace_id for r in reqs if r.trace is not None] or None
        self._serve(stack, lane_of, reqs, f"features_g{stack.size}_s{seq_bucket}x{seq_len}",
                    int(tokens.shape[0]) * seq_len, seq_bucket * seq_len, kb,
                    lambda: self._dispatch_features(subject, stack, padded, kb, traces=traced),
                    lambda r: span_of[id(r)], counter="serve.feature_requests", subject=subject.subject_id)

    def _record_error(self, req: EncodeRequest, exc: BaseException) -> None:
        with self._lock:
            self.stats["errors"] += 1
        if self.telemetry is not None:
            self.telemetry.counter_inc("serve.errors")
        req._resolve(None, exc)

    def _note_served(self, reqs: List[EncodeRequest], n_rows: int, bucket: int) -> None:
        with self._lock:
            self.stats["requests"] += len(reqs)
            self.stats["rows"] += n_rows
            self.stats["batches"] += 1
            self.stats["padded_rows"] += bucket - n_rows
            self._latencies.extend(r.latency_ms for r in reqs if r.latency_ms is not None)
            if self.telemetry is not None:
                for r in reqs:
                    if r.latency_ms is not None:
                        self.telemetry.hist_observe("serve.latency_ms", r.latency_ms)
            if len(self._latencies) > self._latency_window:
                self._latencies = self._latencies[-self._latency_window:]
            lat = sorted(self._latencies)
        if self.telemetry is not None:
            self.telemetry.counter_inc("serve.requests", len(reqs))
            self.telemetry.counter_inc("serve.rows", n_rows)
            self.telemetry.counter_inc("serve.batches")
            self.telemetry.counter_inc("serve.padded_rows", bucket - n_rows)
            self.telemetry.gauge_set("serve.queue_depth", self._q.qsize())
            self.telemetry.gauge_set("serve.batch_occupancy", n_rows / bucket)
            self.telemetry.gauge_set("serve.latency_p50_ms", _percentile(lat, 0.50))
            self.telemetry.gauge_set("serve.latency_p95_ms", _percentile(lat, 0.95))
            self.telemetry.gauge_set("serve.latency_p99_ms", _percentile(lat, 0.99))

    def _loop(self) -> None:
        while self._drain_once(block_s=0.05):
            pass

    # -- warmup / introspection ------------------------------------------------

    def warmup(self, buckets: Optional[Sequence[int]] = None, topk_ks: Sequence[int] = (),
               dtypes: Sequence[str] = ("float32",)) -> int:
        """Capture (on the card) the dispatch of every registered group x
        bucket (x k-bucket x row dtype), so no request meets a capture.
        ``topk_ks`` lists requested ks; a request's k then dispatches at the
        smallest warmed k-bucket covering it. Returns the number of
        dispatches run."""
        from sparse_coding__tpu_torch.serve.wire import dtype_by_name

        self._warm_ks.update(int(k) for k in topk_ks)

        def run() -> int:
            n = 0
            for stack in list(self._stacks_current().values()):
                kbs: List[Optional[int]] = [None] + sorted({k_bucket(k, stack.n_feats) for k in topk_ks})
                for dt in dtypes:
                    dtype = dtype_by_name(str(dt))
                    dtype = dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype.name)
                    for b in buckets or self.buckets:
                        zeros = torch.zeros((int(b), stack.activation_size), dtype=dtype)
                        for kb in kbs:
                            self._dispatch(stack, zeros, int(b), kb)
                            n += 1
            if self._graphs_on:
                torch.cuda.current_stream(self.device).synchronize()
            return n

        return self._on_drainer(run)

    def warmup_features(self, seq_len: int, subject: Optional[str] = None, max_seqs: Optional[int] = None,
                        topk_ks: Sequence[int] = ()) -> int:
        """Capture the capture-then-encode dispatch of every group x
        power-of-two sequence bucket at ``seq_len`` (x asked k-bucket).
        Returns the number of dispatches run."""
        subj = self.registry.get_subject(subject)
        seq_len = int(seq_len)
        cap = self._seq_cap(seq_len)
        if max_seqs is not None:
            cap = min(cap, _pow2_ceil(max_seqs))
        self._warm_ks.update(int(k) for k in topk_ks)

        def run() -> int:
            n = 0
            for stack in list(self._stacks_current().values()):
                if stack.activation_size != subj.activation_size:
                    continue
                kbs: List[Optional[int]] = [None] + sorted({k_bucket(int(k), stack.n_feats) for k in topk_ks})
                b = 1
                while b <= cap:
                    tokens = torch.zeros((b, seq_len), dtype=torch.int32)
                    for kb in kbs:
                        self._dispatch_features(subj, stack, tokens, kb)
                        n += 1
                    b *= 2
            if self._graphs_on:
                torch.cuda.current_stream(self.device).synchronize()
            return n

        return self._on_drainer(run)

    def latency_snapshot(self) -> Dict[str, float]:
        with self._lock:
            lat = sorted(self._latencies)
        return {"n": len(lat), "p50_ms": _percentile(lat, 0.50), "p95_ms": _percentile(lat, 0.95),
                "p99_ms": _percentile(lat, 0.99)}

    @property
    def queue_depth(self) -> int:
        return self._q.qsize()

    @property
    def batch_occupancy(self) -> float:
        """Lifetime fraction of dispatched rows that were real (not padding)."""
        with self._lock:
            rows = self.stats["rows"]
            padded = self.stats["padded_rows"]
        total = rows + padded
        return round(rows / total, 4) if total else 1.0
