"""Wall-clock step timing without a device sync per step.

A copy of `sparse_coding__tpu/utils/trace.py::StepTimer` for the port. The
profiler helpers of that module (`trace`, `annotate`, the trace lock) wait
for ROADMAP A9.
"""

from __future__ import annotations

import time
from typing import Dict, List


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
