"""Profiling and progress helpers.

Counterpart of `sparse_coding__tpu/utils/trace.py`:

  - `trace(...)`: a context manager around a `torch.profiler` session (CPU
    activity, and CUDA activity where a card is present) that writes a
    Chrome trace, ``trace.json``, into its directory;
  - `start_trace_safe` / `stop_trace_safe`: the same window started and
    stopped from code (`telemetry.profiling.TraceTrigger` drives them);
  - `annotate(...)`: `torch.profiler.record_function`, a labelled range
    inside an active trace;
  - `timed(...)`: a named phase's wall seconds into a run's event log;
  - `StepTimer`: wall-clock step timing without a device sync per step;
  - `Progress`: a minimal progress printer.

One profiler session runs in a process at a time, as with `jax.profiler`:
a second start while a window is open warns and does not raise.
"""

from __future__ import annotations

import contextlib
import threading
import time
import warnings
from pathlib import Path
from typing import Dict, List, Optional

import torch

TRACE_FILE = "trace.json"  # the Chrome trace a window writes into its directory

# the session is process-global: every start/stop goes through the two
# helpers below, so a nested or concurrent request degrades to a warning
_TRACE_LOCK = threading.Lock()
_TRACE_DIR: Optional[str] = None
_PROFILER = None


def trace_active() -> Optional[str]:
    """The directory of the open profiler window, or None."""
    return _TRACE_DIR


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_trace_safe(log_dir: str) -> bool:
    """Open a profiler window into ``log_dir`` unless one is open. True when
    THIS call opened it (the caller then owns the matching stop); False when
    a window was already open (warned) or the profiler refused."""
    global _TRACE_DIR, _PROFILER
    with _TRACE_LOCK:
        if _TRACE_DIR is not None:
            warnings.warn(
                f"trace requested for {log_dir!r} while a trace into {_TRACE_DIR!r} is already active — "
                "torch.profiler runs one session per process; ignoring the nested request",
                RuntimeWarning,
                stacklevel=3,
            )
            return False
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof = torch.profiler.profile(activities=_activities())
        try:
            prof.start()
        except Exception as e:  # a session opened outside these helpers
            warnings.warn(f"torch.profiler start into {log_dir!r} failed: {e!r} — continuing untraced",
                          RuntimeWarning, stacklevel=3)
            return False
        _TRACE_DIR, _PROFILER = log_dir, prof
        return True


def stop_trace_safe() -> Optional[str]:
    """Close the open window (no-op when none) and write its Chrome trace;
    never raises. Returns the closed window's directory, or None."""
    global _TRACE_DIR, _PROFILER
    with _TRACE_LOCK:
        stopped, prof = _TRACE_DIR, _PROFILER
        _TRACE_DIR = _PROFILER = None
        if stopped is None:
            return None
        try:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()  # the window's kernels are done before it closes
            prof.stop()
            prof.export_chrome_trace(str(Path(stopped) / TRACE_FILE))
        except Exception as e:  # pragma: no cover - profiler-build dependent
            warnings.warn(f"torch.profiler stop failed: {e!r}", RuntimeWarning)
        return stopped


@contextlib.contextmanager
def trace(log_dir: str = "trace"):
    """Profile the enclosed block into ``log_dir``/trace.json (Perfetto or
    chrome://tracing read it). When a window is already open the block runs
    untraced with a RuntimeWarning; only the start that opened the window
    closes it."""
    started = start_trace_safe(log_dir)
    try:
        yield log_dir
    finally:
        if started:
            stop_trace_safe()


def annotate(name: str):
    """Label a region inside an active trace."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def timed(telemetry, name: str, **fields):
    """Emit a ``phase`` event with the block's wall seconds to `telemetry`
    (no-op when it is None) — e.g. ``with timed(tel, "harvest"): ...``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if telemetry is not None:
            telemetry.event("phase", name=name, seconds=round(time.perf_counter() - t0, 4), **fields)


class StepTimer:
    """`tick()` each step (host timestamps only); `report(fence=x)` copies
    ``x`` (any tensor) to the host once as the completion barrier, then
    returns steps/s statistics in two rates:

      - ``dispatch_steps_per_sec`` / ``dispatch_mean_step_ms``: the host's,
        from the first tick to the last (how fast it enqueues work);
      - ``steps_per_sec`` / ``mean_step_ms``: fenced, the window extended to
        the fence's arrival (the device queue drained)."""

    def __init__(self):
        self._times: List[float] = []
        self.reset()

    def reset(self):
        self._times = [time.perf_counter()]

    def tick(self):
        self._times.append(time.perf_counter())

    def report(self, fence=None) -> Dict[str, float]:
        n_steps = len(self._times) - 1  # ticks only; the fence is not a step
        end = self._times[-1]
        dispatch_total = end - self._times[0]
        if fence is not None:
            # a sanctioned sync point: report() is a flush-boundary act, legal
            # inside telemetry.audit.transfer_audit
            from sparse_coding__tpu_torch.telemetry.audit import allowed_transfer

            with allowed_transfer():
                fence.detach().cpu()  # waits for the work that produced it
            end = time.perf_counter()
        if n_steps <= 0:
            return {"steps": 0, "total_s": 0.0, "steps_per_sec": 0.0, "mean_step_ms": 0.0,
                    "dispatch_steps_per_sec": 0.0, "dispatch_mean_step_ms": 0.0}
        total = end - self._times[0]
        return {
            "steps": n_steps,
            "total_s": total,
            "steps_per_sec": n_steps / total if total > 0 else 0.0,
            "mean_step_ms": 1000.0 * total / n_steps,
            "dispatch_steps_per_sec": n_steps / dispatch_total if dispatch_total > 0 else 0.0,
            "dispatch_mean_step_ms": 1000.0 * dispatch_total / n_steps,
        }


class Progress:
    """Prints ``label i/total (p%)`` every ``every`` fraction of the way."""

    def __init__(self, total: int, label: str = "", every: float = 0.1):
        self.total = max(total, 1)
        self.label = label
        self.every = every
        self._last = -1.0

    def update(self, i: int):
        frac = (i + 1) / self.total
        if frac - self._last >= self.every or i + 1 == self.total:
            self._last = frac
            print(f"{self.label} {i+1}/{self.total} ({100*frac:.0f}%)", flush=True)
