"""The port's registries the rules check call sites against.

Each is derived from the single source of truth its contract already has in
the port: `telemetry/spans.py`'s category tuples, `utils/flags.py`'s flag
registry, the package's own ``fault_point(...)`` call sites with
`utils/faults.py`'s aliases and default sites, and `telemetry/metrics_http.py`'s
exposition-name sanitizer. The span tables are read by literal-AST
evaluation (they are pure literals by construction); the flag and fault
registries are small modules and are imported.
"""

from __future__ import annotations

import ast
import functools
import re
from pathlib import Path
from typing import Dict, FrozenSet, List, Tuple

# the port's package root (…/sparse_coding__tpu_torch): where the registries
# live, and which scanned files are package-internal
PACKAGE_ROOT = Path(__file__).resolve().parents[1]

# `telemetry/metrics_http.py::_NAME_RE`, pinned against it by
# tests/test_torch_analysis.py so the two cannot drift
_METRIC_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _literal_tuple_assigns(path: Path) -> Dict[str, Tuple]:
    """Top-level ``NAME = (<str literals>)`` assignments of a module."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out: Dict[str, Tuple] = {}
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tgt = node.targets[0]
        if not isinstance(tgt, ast.Name):
            continue
        try:
            val = ast.literal_eval(node.value)
        except ValueError:
            continue
        if isinstance(val, tuple):
            out[tgt.id] = val
    return out


class RepoContext:
    """Lazily-built registries shared by every rule invocation."""

    # -- span categories (telemetry/spans.py) --------------------------------

    @functools.cached_property
    def span_tables(self) -> Dict[str, Tuple[str, ...]]:
        path = PACKAGE_ROOT / "telemetry" / "spans.py"
        tables = _literal_tuple_assigns(path)
        needed = ("GOODPUT_CATEGORIES", "BADPUT_CATEGORIES", "DERIVED_CATEGORIES", "INNER_CATEGORIES")
        missing = [k for k in needed if k not in tables]
        if missing:
            raise RuntimeError(
                f"telemetry/spans.py no longer defines literal {missing} — "
                "update analysis/context.py alongside the spans registry"
            )
        return {k: tables[k] for k in needed}

    @functools.cached_property
    def emittable_categories(self) -> FrozenSet[str]:
        t = self.span_tables
        return frozenset(t["GOODPUT_CATEGORIES"] + t["BADPUT_CATEGORIES"])

    @functools.cached_property
    def all_categories(self) -> FrozenSet[str]:
        t = self.span_tables
        return frozenset(t["GOODPUT_CATEGORIES"] + t["BADPUT_CATEGORIES"] + t["DERIVED_CATEGORIES"])

    @functools.cached_property
    def goodput_categories(self) -> FrozenSet[str]:
        return frozenset(self.span_tables["GOODPUT_CATEGORIES"])

    @functools.cached_property
    def inner_categories(self) -> FrozenSet[str]:
        return frozenset(self.span_tables["INNER_CATEGORIES"])

    # -- SC_* flag registry (utils/flags.py) ---------------------------------

    @functools.cached_property
    def registered_flags(self) -> FrozenSet[str]:
        from sparse_coding__tpu_torch.utils import flags

        return frozenset(flags.FLAGS)

    # -- fault sites (utils/faults.py + package fault_point call sites) ------

    @property
    def fault_sites(self) -> FrozenSet[str]:
        """Every site name a spec can legally select: the package's literal
        ``fault_point("<site>")`` call sites, plus the grammar's aliases and
        per-action default sites."""
        return _package_fault_sites()

    def parse_fault_spec(self, text: str) -> List:
        from sparse_coding__tpu_torch.utils import faults

        return faults.parse_faults(text)

    # -- Prometheus sanitization (telemetry/metrics_http.py semantics) -------

    @staticmethod
    def sanitize_metric(name: str) -> str:
        return _METRIC_NAME_RE.sub("_", str(name))


@functools.lru_cache(maxsize=None)
def _package_fault_sites() -> FrozenSet[str]:
    """`RepoContext.fault_sites`, parsed once a process (the package's files
    do not change under a lint run)."""
    from sparse_coding__tpu_torch.utils import faults

    sites = set()
    for py in sorted(PACKAGE_ROOT.rglob("*.py")):
        if "__pycache__" in py.parts:
            continue
        text = py.read_text()
        if "fault_point" not in text:  # most modules: no parse needed
            continue
        try:
            tree = ast.parse(text, filename=str(py))
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Call)
                and _last_name(node.func) == "fault_point"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                sites.add(node.args[0].value)
    sites.update(faults._SITE_ALIASES)
    sites.update(faults._SITE_ALIASES.values())
    sites.update(faults._DEFAULT_SITE.values())
    return frozenset(sites)


def _last_name(func: ast.AST) -> str:
    """The rightmost identifier of a call target (``a.b.c`` -> ``c``)."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def dotted_name(node: ast.AST) -> str:
    """Best-effort dotted name of an expression (``torch.cuda.synchronize``
    -> ``"torch.cuda.synchronize"``; non-name parts render as ``?``)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return f"{dotted_name(node.value)}.{node.attr}"
    return "?"
