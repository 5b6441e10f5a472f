"""Request-level trace contexts for the serving tier.

Counterpart of the context half of the JAX package's `telemetry/tracing.py`:
``X-Trace-Id`` (32 hex chars) names a request, ``X-Parent-Span`` (16 hex
chars) the caller's hop; the server parses them into a `TraceContext` per
POST and the engine writes one ``request_trace`` record per traced request.
The collectors and renderers that rebuild trace trees from a run directory
(`collect_traces`, `render_trace`, the ``trace`` CLI) are not ported yet
(ROADMAP A9) and raise.
"""

from __future__ import annotations

import uuid
from typing import Dict, Optional

__all__ = ["TRACE_HEADER", "PARENT_HEADER", "TraceContext", "mint_trace_id", "mint_span_id",
           "collect_traces", "render_trace"]

TRACE_HEADER = "X-Trace-Id"
PARENT_HEADER = "X-Parent-Span"


def mint_trace_id() -> str:
    """A fresh 128-bit trace id (32 lowercase hex chars)."""
    return uuid.uuid4().hex


def mint_span_id() -> str:
    """A fresh 64-bit span id (16 lowercase hex chars)."""
    return uuid.uuid4().hex[:16]


class TraceContext:
    """One hop's view of a trace: the trace id, this hop's span id, and the
    parent hop's span id (None at the edge)."""

    __slots__ = ("trace_id", "span_id", "parent_span")

    def __init__(self, trace_id: str, span_id: Optional[str] = None, parent_span: Optional[str] = None):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id) if span_id else mint_span_id()
        self.parent_span = str(parent_span) if parent_span else None

    def child(self) -> "TraceContext":
        """The next hop's context: same trace, fresh span, parented here."""
        return TraceContext(self.trace_id, parent_span=self.span_id)

    def headers(self) -> Dict[str, str]:
        """The propagation headers this hop sends downstream."""
        return {TRACE_HEADER: self.trace_id, PARENT_HEADER: self.span_id}

    @classmethod
    def from_headers(cls, headers) -> Optional["TraceContext"]:
        """The receiver's context for an incoming request's headers (fresh
        span id, parented on the sender's); None without a trace id."""
        trace_id = headers.get(TRACE_HEADER) or headers.get(TRACE_HEADER.lower())
        if not trace_id:
            return None
        parent = headers.get(PARENT_HEADER) or headers.get(PARENT_HEADER.lower())
        return cls(str(trace_id), parent_span=parent)

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id!r}, span={self.span_id!r}, parent={self.parent_span!r})"


def _not_ported(*_a, **_k):
    raise NotImplementedError("trace reconstruction and rendering are not ported yet — ROADMAP A9")


collect_traces = render_trace = _not_ported
