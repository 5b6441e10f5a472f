"""Finding records and the baseline (grandfathered-findings) format, as the
JAX package's `analysis/findings.py` has them."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location.

    ``path`` is repo-relative and POSIX-style, so keys are stable across
    checkouts. ``key`` (rule:path:line) is the baseline identity: coarse
    enough to survive edits elsewhere in the file, precise enough that a
    *new* violation of the same rule in the same file still fails the gate.
    """

    rule: str
    path: str
    line: int
    col: int
    message: str

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.line}"

    def to_json(self) -> Dict[str, Any]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "key": self.key,
        }

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def sort_key(self):
        return (self.path, self.line, self.col, self.rule)
