"""Span records: categorized wall-time intervals for goodput accounting.

Counterpart of `sparse_coding__tpu/telemetry/spans.py`, in the same record
format. One ``span`` event is written when a span closes::

    {"event": "span", "category": "data_wait", "name": "chunk_next",
     "ts_start": <wall clock at begin>, "seconds": <monotonic duration>, ...}

``telemetry=None`` makes a span a no-op. ``telemetry=ACTIVE`` (the explicit
sentinel) broadcasts the span to every live `RunTelemetry`: the hook for
layers that hold no handle, such as the activation harvest (its
``harvest_forward`` ``step`` spans and ``chunk_commit`` ``checkpoint``
spans land in whatever run is live, e.g. the sweep's during
`init_model_dataset`). The sweep opens ``data_wait`` (dataset init, each
chunk's wait), ``step`` (each chunk's training), ``checkpoint`` (exports,
saves, restores), ``preempt_drain`` and ``degraded_skip`` spans. A ``step``
span closes on the host clock, after the chunk's work is enqueued, not when
the card finishes it.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from sparse_coding__tpu_torch.telemetry import events as _events

__all__ = ["ACTIVE", "BADPUT_CATEGORIES", "CATEGORIES", "DERIVED_CATEGORIES", "GOODPUT_CATEGORIES", "INNER_CATEGORIES",
           "Span", "span"]


class _ActiveSentinel:
    """Broadcast to every live RunTelemetry. Distinct from None (telemetry
    off, the span is a no-op), so a handle-less layer opts in explicitly."""

    def __repr__(self) -> str:
        return "<spans.ACTIVE>"


ACTIVE = _ActiveSentinel()

GOODPUT_CATEGORIES = ("step", "encode")
BADPUT_CATEGORIES = (
    "compile", "data_wait", "checkpoint", "preempt_drain", "degraded_skip", "export_verify",
    "restart_backoff", "request_wait", "dequant", "forward", "feature_flush", "tower_poll", "lineage_verify",
)
# derived-only badput: reconstructed by `telemetry.goodput` from event
# adjacency, never emitted as live spans
DERIVED_CATEGORIES = (
    "preempted_down",  # inter-generation downtime after a preemption
    "reassign_gap",    # fleet lease-loss -> next-claim gap (item lineage)
    "straggler_idle",  # fast ranks waiting on the slowest (skew windows)
    "unaccounted",     # the honest remainder
)
# categories that may open INSIDE an enclosing goodput span; the ledger's
# timestamp sweep handles nesting exactly, and the monitor's live
# approximation subtracts these from its goodput sum so the two agree
INNER_CATEGORIES = ("compile", "checkpoint", "preempt_drain", "dequant")
CATEGORIES = GOODPUT_CATEGORIES + BADPUT_CATEGORIES + DERIVED_CATEGORIES


class Span:
    """One categorized wall-time interval; emits a ``span`` event on close,
    also when the block raised."""

    __slots__ = ("telemetry", "category", "name", "fields", "_t0_mono", "_t0_wall", "_done")

    def __init__(self, telemetry, category: str, name: Optional[str] = None, **fields):
        if category not in GOODPUT_CATEGORIES + BADPUT_CATEGORIES:
            raise ValueError(f"unknown span category {category!r}")
        self.telemetry, self.category, self.name, self.fields = telemetry, category, name, fields
        self._t0_mono: Optional[float] = None
        self._t0_wall: Optional[float] = None
        self._done = False

    def begin(self) -> "Span":
        self._t0_mono, self._t0_wall, self._done = time.monotonic(), time.time(), False
        return self

    def end(self, **extra) -> Optional[Dict[str, Any]]:
        if self._done or self._t0_mono is None:
            return None
        self._done = True
        if self.telemetry is None:
            return None
        seconds = time.monotonic() - self._t0_mono
        fields = {**self.fields, **extra}
        if self.name is not None:
            fields.setdefault("name", self.name)
        payload = dict(category=self.category, ts_start=round(self._t0_wall, 6), seconds=round(seconds, 6), **fields)
        if self.telemetry is ACTIVE:
            _events.counter_inc_active(f"span.{self.category}.count")
            _events.counter_add_float_active(f"span.{self.category}.seconds", seconds)
            _events.event_active("span", **payload)
            return None
        self.telemetry.counter_inc(f"span.{self.category}.count")
        self.telemetry.counter_add_float(f"span.{self.category}.seconds", seconds)
        return self.telemetry.event("span", **payload)

    def __enter__(self) -> "Span":
        return self.begin()

    def __exit__(self, exc_type, exc, tb):
        self.end()
        return False


def span(telemetry, category: str, name: Optional[str] = None, **fields) -> Span:
    """A `Span`, not yet begun (``with`` or ``.begin()`` starts it)."""
    return Span(telemetry, category, name=name, **fields)
