"""Structured run-event log: ``events.jsonl`` beside the metrics JSONL.

Counterpart of `sparse_coding__tpu/telemetry/events.py`, in the same on-disk
format (a shared one: the JAX package's `read_events`, report and goodput
tools read the port's logs). One record per line::

    {"seq": <monotonic int>, "ts": <unix float>, "mono": <float>, "event": <kind>, ...fields}

Kinds the port writes: ``run_start`` (config + environment fingerprint),
``chunk_start`` / ``chunk_end``, ``span`` (`telemetry.spans`), ``resume``,
``checkpoint``, ``preempt``, ``anomaly``, ``chunk_skipped``,
``provenance``, ``feature_stats``, ``compile`` (a step's CUDA-graph capture
with its cost: `Ensemble.step_cost`), ``trace`` (a profiler window),
``snapshot`` (counters + gauges) and ``run_end``.

Counters, gauges and fixed-bucket histograms (`RunTelemetry.hist_observe`,
the serving tier's latency histograms) are host-side Python numbers:
bumping them never touches the card. ``tags`` are constant fields stamped
into every record (a serve replica's ``{"replica": ...}``). The JAX package's compile bridge (``jax.monitoring``,
``tracked_jit``) has no counterpart here: the port's ``compile`` records come
from `Ensemble`'s graph captures (`compile_active`).
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

__all__ = ["DEFAULT_LATENCY_BUCKETS_MS", "RunTelemetry", "compile_active", "counter_add_float_active", "counter_inc_active",
           "event_active", "gauge_set_active",
           "read_events",
           "run_fingerprint"]

# fixed log-spaced latency buckets (ms): 0.25 ms ... 2048 ms, each bound 2x
# the previous (the JAX package's): histograms of different writers merge
# by adding their buckets
DEFAULT_LATENCY_BUCKETS_MS = tuple(0.25 * 2 ** i for i in range(14))

# live instances receiving handle-less signals (removed on close)
_ACTIVE: List["RunTelemetry"] = []


def counter_inc_active(name: str, n: int = 1) -> None:
    """Bump a counter on every live RunTelemetry (no live one: a no-op)."""
    for t in list(_ACTIVE):
        t.counter_inc(name, n)


def counter_add_float_active(name: str, v: float) -> None:
    """Float-add a counter on every live RunTelemetry (handle-less span
    seconds); no live one: a no-op."""
    for t in list(_ACTIVE):
        t.counter_add_float(name, v)


def gauge_set_active(name: str, value: float) -> None:
    """Set a gauge on every live RunTelemetry (no live one: a no-op)."""
    for t in list(_ACTIVE):
        t.gauge_set(name, value)


def event_active(etype: str, **fields) -> None:
    """Emit an event on every live RunTelemetry (layers without a handle)."""
    for t in list(_ACTIVE):
        t.event(etype, **fields)


def telemetry_live() -> bool:
    """Whether any RunTelemetry is open (a handle-less layer's cheap check)."""
    return bool(_ACTIVE)


def compile_active(name: str, seconds: float, cost: Optional[Dict[str, Any]] = None) -> None:
    """A ``compile`` record on every live RunTelemetry (no live one: a no-op)."""
    for t in list(_ACTIVE):
        t.compile(name, seconds, cost=cost)


def run_fingerprint(mesh=None) -> Dict[str, Any]:
    """Environment fingerprint for ``run_start``: python, torch, CUDA and the
    device, where the JAX package reports jax and its devices; the rank and
    world size, the `torch.distributed` backend and, in a pod, the clock
    offset to rank 0; ``mesh`` (a `parallel.Mesh`) adds its axis sizes.
    Best-effort: a group that fails lands in ``fingerprint_error``, never
    fails the run."""
    fp: Dict[str, Any] = {"python": sys.version.split()[0]}
    errors: List[str] = []
    try:
        import torch

        fp["torch"] = torch.__version__
        fp["cuda"] = torch.version.cuda
        if torch.cuda.is_available():
            fp["backend"] = "gpu"
            fp["device_kind"] = torch.cuda.get_device_name(0)
            fp["device_count"] = torch.cuda.device_count()
        else:
            fp["backend"] = "cpu"
            fp["device_kind"] = "cpu"
            fp["device_count"] = 1
    except (ImportError, RuntimeError, AssertionError) as e:
        errors.append(f"torch: {e!r}")
    from sparse_coding__tpu_torch.telemetry import multihost as _mh

    fp["process_index"], fp["process_count"] = _mh.process_info()
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            fp["distributed_backend"] = str(dist.get_backend())
    except (ImportError, RuntimeError) as e:
        errors.append(f"distributed: {e!r}")
    clock = _mh.clock_state()
    if clock:
        fp["clock_offset_seconds"] = clock.get("offset_seconds")
        fp["clock_uncertainty_seconds"] = clock.get("uncertainty_seconds")
    if errors:
        fp["fingerprint_error"] = "; ".join(errors)
    try:
        sha = subprocess.run(["git", "rev-parse", "HEAD"], cwd=Path(__file__).resolve().parents[2],
                             capture_output=True, text=True, timeout=5)
        if sha.returncode == 0:
            fp["git_sha"] = sha.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    if mesh is not None:
        fp["mesh"] = {str(k): int(v) for k, v in mesh.shape.items()}
    return fp


class RunTelemetry:
    """Append-only structured event log + host-side counters and gauges.

    ``out_dir=None`` keeps everything in memory. A resumed process appends to
    the same log; ``generation`` counts the ``run_start`` records already
    there. `close` writes ``run_end`` unless one was written. In a world of
    several ranks (`telemetry.multihost.process_info`) the file is
    ``events.p<i>.jsonl`` and every record carries ``process_index``; a
    world of one keeps ``events.jsonl``, untagged."""

    def __init__(self, out_dir: Optional[str] = None, run_name: str = "run",
                 config: Optional[Dict[str, Any]] = None, file_name: str = "events.jsonl",
                 tags: Optional[Dict[str, Any]] = None):
        self.run_name = run_name
        self._config = config
        self.tags = dict(tags or {})
        self._lock = threading.Lock()
        self._seq = 0
        self._t0 = time.time()
        self._t0_mono = time.monotonic()
        self._chunk_t0_mono: Optional[float] = None
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Dict[str, Any]] = {}
        self._run_end_written = False
        self._fh = None
        self.path: Optional[Path] = None
        self.generation = 0
        from sparse_coding__tpu_torch.telemetry import multihost as _mh

        idx, count = _mh.process_info()
        self.process_index: Optional[int] = idx if count > 1 else None
        if out_dir is not None:
            d = Path(out_dir)
            d.mkdir(parents=True, exist_ok=True)
            self.path = d / _mh.per_process_file_name(file_name, idx, count)
            self.generation = self._count_prior_generations()
            self._fh = open(self.path, "a")
        _ACTIVE.append(self)

    def _count_prior_generations(self) -> int:
        if self.path is None or not self.path.exists():
            return 0
        try:
            with open(self.path, "r", errors="replace") as f:
                return sum('"event": "run_start"' in line for line in f)
        except OSError:
            return 0

    def event(self, etype: str, **fields) -> Dict[str, Any]:
        """Write one record of kind ``etype`` and return it."""
        with self._lock:
            self._seq += 1
            rec = {"seq": self._seq, "ts": time.time(), "mono": round(time.monotonic(), 6), "event": etype, **self.tags,
                   **fields}
            if self.process_index is not None:
                rec["process_index"] = self.process_index
            if self._fh is not None:
                self._fh.write(json.dumps(rec, default=str) + "\n")
                self._fh.flush()
        return rec

    def run_start(self, config: Optional[Dict[str, Any]] = None, mesh=None):
        return self.event("run_start", run_name=self.run_name, generation=self.generation,
                          config=config if config is not None else self._config, fingerprint=run_fingerprint(mesh=mesh))

    def compile(self, name: str, seconds: float, cache_hit: Optional[bool] = None,
                cost: Optional[Dict[str, Any]] = None):
        """One capture of entry point ``name`` (the port's jit compile: a
        step's CUDA graph), its host seconds and, given, its ``cost``
        (``flops``, ``bytes_accessed``, ...) for the report's roofline.
        The JAX package's record and counters."""
        self.counter_inc(f"compile.{name}.count")
        self.counter_add_float(f"compile.{name}.seconds", seconds)
        fields: Dict[str, Any] = {"name": name, "seconds": round(seconds, 4)}
        if cache_hit is not None:
            fields["cache_hit"] = bool(cache_hit)
        if cost:
            fields["cost"] = cost
        return self.event("compile", **fields)

    def chunk_start(self, chunk: int, **fields):
        self._chunk_t0_mono = time.monotonic()
        return self.event("chunk_start", chunk=int(chunk), **fields)

    def chunk_end(self, chunk: int, **fields):
        """Wall seconds since `chunk_start` (monotonic; None without one).
        Reads no device state, so it adds no sync."""
        t0, self._chunk_t0_mono = self._chunk_t0_mono, None
        self.counter_inc("chunks")
        if t0 is None:
            return self.event("chunk_end", chunk=int(chunk), seconds=None, **fields)
        dt = time.monotonic() - t0
        self.counter_add_float("chunk.seconds", dt)
        return self.event("chunk_end", chunk=int(chunk), seconds=round(dt, 3), **fields)

    def anomaly(self, kind: str, **fields):
        """An ``anomaly`` record (the guard's detections), counted."""
        self.counter_inc("anomalies")
        return self.event("anomaly", kind=kind, **fields)

    def run_end(self, status: str = "ok", timer_stats: Optional[Dict[str, Any]] = None, **fields):
        """The final record (after a closing `snapshot`): status, this
        generation's wall seconds, the step totals from the counters and,
        given, a `utils.trace.StepTimer` report under ``timer``."""
        self.snapshot()
        self._run_end_written = True
        wall = time.monotonic() - self._t0_mono
        rec: Dict[str, Any] = {"status": status, "run_name": self.run_name, "generation": self.generation,
                               "wall_seconds": round(wall, 3), **fields}
        steps = self._counters.get("train.steps")
        if steps is not None:
            rec["steps"] = int(steps)
            rec.setdefault("steps_per_sec", round(steps / wall, 3) if wall > 0 else None)
        if timer_stats:
            rec["timer"] = {k: round(v, 4) if isinstance(v, float) else v for k, v in timer_stats.items()}
        return self.event("run_end", **rec)

    def counter_inc(self, name: str, n: int = 1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counter_add_float(self, name: str, v: float):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + float(v)

    def gauge_set(self, name: str, value: float):
        with self._lock:
            self._gauges[name] = float(value)

    def hist_observe(self, name: str, value: float, buckets: Optional[tuple] = None):
        """One observation into a fixed-bucket histogram (made on the first
        observe; ``buckets`` matters only then, default
        `DEFAULT_LATENCY_BUCKETS_MS`). Flushed by `snapshot`, rendered by
        `telemetry.metrics_http`."""
        v = float(value)
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                bounds = tuple(float(b) for b in (buckets or DEFAULT_LATENCY_BUCKETS_MS))
                h = self._hists[name] = {"bounds": bounds, "counts": [0] * (len(bounds) + 1), "sum": 0.0, "count": 0}
            h["sum"] += v
            h["count"] += 1
            for i, b in enumerate(h["bounds"]):
                if v <= b:
                    h["counts"][i] += 1
                    break
            else:
                h["counts"][-1] += 1  # overflow

    @property
    def counters(self) -> Dict[str, float]:
        return dict(self._counters)

    @property
    def hists(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {k: {"bounds": list(h["bounds"]), "counts": list(h["counts"]), "sum": h["sum"], "count": h["count"]}
                    for k, h in self._hists.items()}

    @property
    def gauges(self) -> Dict[str, float]:
        return dict(self._gauges)

    def snapshot(self):
        """One record of every counter and gauge (and of the histograms, only
        when there are any, as the JAX package writes it)."""
        with self._lock:
            counters = {k: round(v, 4) if isinstance(v, float) else v for k, v in sorted(self._counters.items())}
            gauges = dict(sorted(self._gauges.items()))
            hists = {k: {"bounds": list(h["bounds"]), "counts": list(h["counts"]), "sum": round(h["sum"], 4),
                         "count": h["count"]} for k, h in sorted(self._hists.items())}
        if hists:
            return self.event("snapshot", counters=counters, gauges=gauges, hists=hists)
        return self.event("snapshot", counters=counters, gauges=gauges)

    def close(self, status: str = "ok"):
        if self in _ACTIVE:
            _ACTIVE.remove(self)
        if not self._run_end_written:
            self.run_end(status=status)
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close(status="ok" if exc_type is None else f"error: {exc_type.__name__}: {exc}")
        return False


def read_events(path) -> List[Dict[str, Any]]:
    """Parse an events.jsonl back into records."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
