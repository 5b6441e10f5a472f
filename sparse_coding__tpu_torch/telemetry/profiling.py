"""Flush-boundary device-memory gauges, and the trace window's refusal.

Counterpart of the part of `sparse_coding__tpu/telemetry/profiling.py` the
training drivers call at each chunk boundary: `record_hbm_watermarks` reads
the CUDA caching allocator's statistics (a host-side query: no device sync)
into the JAX package's gauge names. The profiler attribution and the
triggered trace window (`TraceTrigger`, ``SC_TRACE_WINDOW``) wait for
ROADMAP A9.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from sparse_coding__tpu_torch.utils import flags

__all__ = ["hbm_watermarks", "record_hbm_watermarks", "refuse_trace_window"]


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


def refuse_trace_window() -> None:
    """Raise when ``SC_TRACE_WINDOW`` asks for a profiler window: the
    trigger is not ported yet, and a run must not pretend to trace."""
    if flags.SC_TRACE_WINDOW.get():
        raise NotImplementedError("SC_TRACE_WINDOW (the triggered profiler trace) is not ported yet — "
                                  "ROADMAP A9; unset it")
