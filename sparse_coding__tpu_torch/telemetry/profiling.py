"""Performance attribution: step cost and roofline, device-memory gauges,
triggered trace windows.

Counterpart of `sparse_coding__tpu/telemetry/profiling.py`:

  - **Cost capture.** Where the JAX package reads XLA's cost analysis of a
    compiled program, the port counts: a CUDA-graph capture of a step plays
    the part of a jit compile, and `Ensemble` emits a ``compile`` event for
    each capture with its ``cost`` (`Ensemble.step_cost`: the analytic count
    of the step's kernels at its shape, one function,
    `ops.tied_sae_kernel.kernel_work`, or `torch.utils.flop_counter` on the
    autograd route). ``SC_COST_CAPTURE`` sets the depth: ``0``/``off`` none,
    ``full`` adds the step graph pool's bytes (`capture_mode`).
  - **Roofline attribution** (`roofline_summary`): FLOPs and bytes against
    the card's peaks from the port's own table (`PEAKS`, keyed by
    ``torch.cuda.get_device_name()``), compute- or bandwidth-bound, and with
    a measured time the achieved share of what is attainable. A device the
    table does not name takes `DEFAULT_PEAK` (the H100 SXM's figures).
  - **Device-memory watermarks** (`record_hbm_watermarks`): the CUDA caching
    allocator's statistics (a host-side query, no device sync) into the
    JAX package's gauge names.
  - **Triggered traces** (`TraceTrigger`): `utils.trace`'s torch.profiler
    window armed by a step window (``SC_TRACE_WINDOW=N:M`` with optional
    ``SC_TRACE_DIR``, or constructor arguments) or by `AnomalyGuard` on the
    first anomaly; each window's directory goes into the event log and the
    diagnostic bundle.
"""

from __future__ import annotations

import time
import warnings
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import torch

from sparse_coding__tpu_torch.utils import flags

__all__ = ["DEFAULT_PEAK", "PEAKS", "TraceTrigger", "capture_mode", "hbm_gbps", "hbm_watermarks", "peak_tflops",
           "record_hbm_watermarks", "roofline_summary"]

COST_CAPTURE_ENV = flags.SC_COST_CAPTURE.name

# card -> (dense bf16 tensor-core TFLOP/s, HBM GB/s), from the data sheets;
# the first key that is a substring of the device name wins
PEAKS = {
    "H100": (989.0, 3350.0),  # H100 SXM (NVIDIA H100 80GB HBM3)
}
DEFAULT_PEAK = ("H100 SXM (default: device not in the table)", 989.0, 3350.0)


def _peak_for(device_kind: Optional[str]):
    for key, (tf, bw) in PEAKS.items():
        if key in str(device_kind or ""):
            return tf, bw
    return DEFAULT_PEAK[1], DEFAULT_PEAK[2]


def peak_tflops(device_kind: Optional[str]) -> float:
    """Dense bf16 TFLOP/s of ``device_kind`` (`DEFAULT_PEAK` when unknown)."""
    return _peak_for(device_kind)[0]


def hbm_gbps(device_kind: Optional[str]) -> float:
    """Device-memory GB/s of ``device_kind`` (`DEFAULT_PEAK` when unknown)."""
    return _peak_for(device_kind)[1]


def capture_mode(env=None) -> str:
    """``SC_COST_CAPTURE``: "off" (``0``/``false``/``no``/``off``), "full"
    (``full``/``2``/``memory``: the cost and the graph pool's bytes) or
    "cost" (anything else, the default)."""
    v = flags.SC_COST_CAPTURE.get(env).lower()
    if v in ("0", "false", "no", "off"):
        return "off"
    if v in ("full", "2", "memory"):
        return "full"
    return "cost"


# -- roofline attribution -----------------------------------------------------

def roofline_summary(flops: float, bytes_accessed: float, device_kind: str, seconds: Optional[float] = None,
                     peak_tflops: Optional[float] = None, hbm_gbps: Optional[float] = None) -> Dict[str, Any]:
    """Classify one step against its card's roofline.

    ``flops`` / ``bytes_accessed`` per step; ``device_kind`` picks the peaks
    from `PEAKS` unless ``peak_tflops`` / ``hbm_gbps`` are given;
    ``seconds`` (optional) is the measured time of one step. Returns the JAX
    package's fields: ``arithmetic_intensity``, ``ridge_intensity``,
    ``bound`` ("compute" | "bandwidth"), ``peak_tflops``, ``hbm_gbps``,
    ``attainable_tflops`` and, with ``seconds``, ``achieved_tflops``,
    ``achieved_fraction``, ``achieved_gbps``."""
    peak = _peak_for(device_kind)[0] if peak_tflops is None else peak_tflops
    bw = _peak_for(device_kind)[1] if hbm_gbps is None else hbm_gbps
    intensity = flops / bytes_accessed if bytes_accessed > 0 else float("inf")
    ridge = peak * 1e12 / (bw * 1e9)  # FLOPs per byte at the knee
    attainable = min(peak, intensity * bw * 1e9 / 1e12)
    out: Dict[str, Any] = {
        "flops": float(flops),
        "bytes_accessed": float(bytes_accessed),
        "arithmetic_intensity": round(intensity, 3),
        "ridge_intensity": round(ridge, 3),
        "bound": "compute" if intensity >= ridge else "bandwidth",
        "peak_tflops": peak,
        "hbm_gbps": bw,
        "attainable_tflops": round(attainable, 3),
    }
    if seconds is not None and seconds > 0:
        achieved = flops / seconds / 1e12
        out["achieved_tflops"] = round(achieved, 4)
        out["achieved_fraction"] = round(achieved / attainable, 4) if attainable > 0 else None
        out["achieved_gbps"] = round(bytes_accessed / seconds / 1e9, 2)
    return out


# -- device-memory watermarks -------------------------------------------------

def hbm_watermarks(devices: Sequence) -> Dict[str, Dict[str, int]]:
    """``{"d<i>": {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}}``
    for each CUDA device among ``devices``: the allocator's current and peak
    allocated bytes and the device's memory. Empty for a CPU run, as on the
    JAX package's CPU backend. In a world of several ranks the keys are
    ``"p<rank>.d<i>"``, so the ranks' gauges stay apart once their logs are
    merged (two ranks may share one card)."""
    from sparse_coding__tpu_torch.telemetry.multihost import process_info

    idx, count = process_info()
    prefix = f"p{idx}." if count > 1 else ""
    out: Dict[str, Dict[str, int]] = {}
    for d in devices:
        d = torch.device(d)
        if d.type != "cuda":
            continue
        i = d.index if d.index is not None else torch.cuda.current_device()
        stats = torch.cuda.memory_stats(i)
        out[f"{prefix}d{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
        }
    return out


def record_hbm_watermarks(telemetry, devices: Sequence) -> Dict[str, Dict[str, int]]:
    """Sample `hbm_watermarks` into ``telemetry`` gauges
    (``hbm.d<i>.<field>``); they reach ``events.jsonl`` with the next
    ``snapshot`` record. Returns the sample."""
    marks = hbm_watermarks(devices)
    if telemetry is not None:
        for dev, stats in marks.items():
            for field, v in stats.items():
                telemetry.gauge_set(f"hbm.{dev}.{field}", float(v))
    return marks


# -- triggered trace capture --------------------------------------------------

class TraceTrigger:
    """Programmatic arming of `utils.trace` profiler windows.

    Two arming paths, both through the safe `start_trace_safe` /
    `stop_trace_safe` pair (a trigger firing while another window is open
    degrades to a warning, never an exception):

      - **step window**: ``TraceTrigger(..., start_step=N, stop_step=M)``;
        drivers call ``on_step(cumulative_steps)`` at flush/chunk
        boundaries; the capture starts at the first boundary at or past N
        and stops at the first at or past M (when one boundary jumps the
        whole window, one boundary-to-boundary window is captured). It is
        written into ``<out_dir>/trace_step<N>``. `from_env` reads
        ``SC_TRACE_WINDOW="N:M"`` and ``SC_TRACE_DIR``.
      - **anomaly** (``on_anomaly=True``, the default): `AnomalyGuard` calls
        ``fire(reason=...)`` on the first anomaly; the capture starts at once
        and stops after ``anomaly_windows`` further ``on_step`` calls (at
        least 1). One a run. With ``on_anomaly=False`` `fire` starts
        nothing.

    Every capture emits a ``trace`` event (``dir``, ``reason``,
    ``start_step``, ``stop_step``, and the host seconds the profiler took
    to open the window, ``start_s``, and to close it and write the trace,
    ``stop_s``: what a window costs the run beyond the steps it watches)
    and bumps ``trace.captures``; `last_trace_dir` is the newest window's
    directory."""

    def __init__(self, telemetry=None, out_dir: Optional[str] = None, start_step: Optional[int] = None,
                 stop_step: Optional[int] = None, on_anomaly: bool = True, anomaly_windows: int = 1,
                 trace_dir: Optional[str] = None):
        self.telemetry = telemetry
        self.out_dir = Path(out_dir) if out_dir is not None else None
        self.start_step = start_step
        self.stop_step = stop_step
        self.on_anomaly = bool(on_anomaly)
        self.anomaly_windows = max(1, int(anomaly_windows))
        self._trace_dir_override = trace_dir
        self._active: Optional[str] = None       # dir of the window WE started
        self._active_reason: Optional[str] = None
        self._active_start_step: Optional[int] = None
        self._active_start_s: Optional[float] = None
        self._window_done = False                # the step window fires once
        self._anomaly_fired = False              # the first anomaly only
        self._stop_after: Optional[int] = None   # countdown of on_step calls
        self.last_trace_dir: Optional[str] = None

    @classmethod
    def from_env(cls, telemetry=None, out_dir: Optional[str] = None, env=None, **kw):
        """Build from ``SC_TRACE_WINDOW="N:M"`` / ``SC_TRACE_DIR``. A
        malformed window warns and is ignored."""
        window = flags.SC_TRACE_WINDOW.get(env)
        start = stop = None
        if window:
            try:
                lo, _, hi = window.partition(":")
                start, stop = int(lo), int(hi)
            except ValueError:
                warnings.warn(f"ignoring malformed SC_TRACE_WINDOW={window!r} (expected 'start:stop' in steps)",
                              RuntimeWarning)
                start = stop = None
        return cls(telemetry=telemetry, out_dir=out_dir, start_step=start, stop_step=stop,
                   trace_dir=flags.SC_TRACE_DIR.get(env), **kw)

    def _dir_for(self, tag: str) -> str:
        if self._trace_dir_override:
            return self._trace_dir_override
        base = self.out_dir if self.out_dir is not None else Path("trace")
        return str(base / f"trace_{tag}")

    def _start(self, log_dir: str, reason: str, step: Optional[int]) -> Optional[str]:
        from sparse_coding__tpu_torch.utils.trace import start_trace_safe

        t0 = time.perf_counter()
        if not start_trace_safe(log_dir):
            return None
        self._active, self._active_reason, self._active_start_step = log_dir, reason, step
        self._active_start_s = time.perf_counter() - t0
        return log_dir

    def _stop(self, step: Optional[int] = None):
        from sparse_coding__tpu_torch.utils.trace import stop_trace_safe

        if self._active is None:
            return
        t0 = time.perf_counter()
        stop_trace_safe()
        stop_s = time.perf_counter() - t0
        self.last_trace_dir = self._active
        if self.telemetry is not None:
            self.telemetry.event("trace", dir=self._active, reason=self._active_reason,
                                 start_step=self._active_start_step, stop_step=step,
                                 start_s=round(self._active_start_s, 4), stop_s=round(stop_s, 4))
            self.telemetry.counter_inc("trace.captures")
        self._active = self._active_reason = None
        self._stop_after = None

    @property
    def active(self) -> bool:
        return self._active is not None

    def on_step(self, step: int):
        """Drive the trigger from a boundary: ``step`` is the cumulative
        train-step count. Host-side integer compares only."""
        step = int(step)
        if self._active is not None:
            if self._stop_after is not None:
                self._stop_after -= 1
                if self._stop_after <= 0:
                    self._stop(step)
            elif self.stop_step is not None and step >= self.stop_step:
                self._stop(step)
            return
        if (not self._window_done and self.start_step is not None and self.stop_step is not None
                and step >= self.start_step):
            self._window_done = True
            started = self._start(self._dir_for(f"step{step}"), "step_window", step)
            if started is not None and step >= self.stop_step:
                # boundaries coarser than the window: capture one
                # boundary-to-boundary window from here, not nothing
                self._stop_after = 1

    def fire(self, reason: str = "anomaly", step: Optional[int] = None) -> Optional[str]:
        """Anomaly-path arming: start a capture now, stopping after
        `anomaly_windows` further `on_step` calls. Returns its directory when
        a capture started (anomaly arming on, the first anomaly, profiler
        free), else None; a refused start leaves the run's one anomaly
        capture unused."""
        if not self.on_anomaly or self._anomaly_fired or self._active is not None:
            return None
        tag = f"anomaly_step{step}" if step is not None else "anomaly"
        started = self._start(self._dir_for(tag), reason, step)
        if started is not None:
            self._anomaly_fired = True
            self._stop_after = self.anomaly_windows
        return started

    def close(self, step: Optional[int] = None):
        """Stop any in-flight capture (drivers call this before run_end)."""
        self._stop(step)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
