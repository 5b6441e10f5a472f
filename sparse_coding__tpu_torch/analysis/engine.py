"""The sclint walker: file discovery, single-parse modules, rule dispatch
(the JAX package's `analysis/engine.py`, over the port's rules).

Each file is parsed exactly once into a `ModuleFile`; module-scope rules
then walk the shared tree and repo-scope rules (cross-file contracts like
the SC006 collision check) receive the whole module list. Suppressions and
the baseline are applied here, not in the rules, so every rule stays a pure
``tree -> findings`` generator.
"""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from sparse_coding__tpu_torch.analysis.context import PACKAGE_ROOT, RepoContext
from sparse_coding__tpu_torch.analysis.findings import Finding
from sparse_coding__tpu_torch.analysis.rules import RULES, RawFinding

REPO_ROOT = PACKAGE_ROOT.parent

# `# sclint: allow(SC003) reason` / `# sclint: allow(SC001, SC004) reason`
_ALLOW_RE = re.compile(r"#\s*sclint:\s*allow\(([^)]*)\)")

# directories never worth scanning
_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules", ".pytest_cache"}


class ModuleFile:
    """One parsed source file plus the line-level metadata rules need."""

    def __init__(self, path: Path, text: str, tree: ast.Module):
        self.path = path
        self.text = text
        self.tree = tree
        try:
            rel = path.resolve().relative_to(REPO_ROOT)
            self.relpath = rel.as_posix()
        except ValueError:
            self.relpath = path.as_posix()
        self.in_package = PACKAGE_ROOT in path.resolve().parents

    @property
    def nodes(self) -> List[ast.AST]:
        """Every node of the tree, walked once and shared by the rules."""
        if not hasattr(self, "_nodes"):
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    # -- suppression comments -------------------------------------------------

    @property
    def allowed(self) -> Dict[int, Set[str]]:
        """line -> rule ids sanctioned there. A comment on the first line of
        a multi-line statement sanctions the whole statement's extent; a
        comment-only line (or block of them) sanctions the next code line."""
        if not hasattr(self, "_allowed"):
            per_line: Dict[int, Set[str]] = {}
            pending: Set[str] = set()
            for i, line in enumerate(self.text.splitlines(), start=1):
                m = _ALLOW_RE.search(line)
                rules = (
                    {r.strip() for r in m.group(1).split(",") if r.strip()}
                    if m else set()
                )
                if line.strip().startswith("#"):
                    pending |= rules
                    continue
                rules |= pending
                pending = set()
                if rules:
                    per_line.setdefault(i, set()).update(rules)
            if per_line:
                for node in self.nodes:
                    if not isinstance(node, ast.stmt):
                        continue
                    rules = per_line.get(node.lineno)
                    if not rules:
                        continue
                    for ln in range(node.lineno, (node.end_lineno or node.lineno) + 1):
                        per_line.setdefault(ln, set()).update(rules)
            self._allowed = per_line
        return self._allowed

    def is_allowed(self, rule: str, line: int) -> bool:
        return rule in self.allowed.get(line, ())

    # -- docstring extents (SC005 ignores flag names quoted in prose) ---------

    @property
    def docstring_lines(self) -> Set[int]:
        if not hasattr(self, "_doc_lines"):
            lines: Set[int] = set()
            for node in self.nodes:
                if (
                    isinstance(node, ast.Expr)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)
                ):
                    lines.update(
                        range(node.lineno, (node.end_lineno or node.lineno) + 1)
                    )
            self._doc_lines = lines
        return self._doc_lines


def iter_python_files(paths: Sequence[str | Path]) -> List[Path]:
    """Expand files/directories into a sorted, deduplicated ``.py`` list."""
    seen: Set[Path] = set()
    out: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            candidates: Iterable[Path] = sorted(p.rglob("*.py"))
        elif p.suffix == ".py" and p.is_file():
            candidates = [p]
        else:
            candidates = []
        for c in candidates:
            if any(part in _SKIP_DIRS for part in c.parts):
                continue
            r = c.resolve()
            if r not in seen:
                seen.add(r)
                out.append(c)
    return out


def parse_module(path: Path) -> Tuple[Optional[ModuleFile], Optional[Finding]]:
    """Parse one file; a syntax error becomes an SC000 finding rather than
    aborting the run (a tree that doesn't parse can't be audited)."""
    text = path.read_text(encoding="utf-8", errors="replace")
    try:
        tree = ast.parse(text, filename=str(path))
    except SyntaxError as e:
        try:
            rel = path.resolve().relative_to(REPO_ROOT).as_posix()
        except ValueError:
            rel = path.as_posix()
        return None, Finding(
            rule="SC000",
            path=rel,
            line=e.lineno or 1,
            col=(e.offset or 1) - 1,
            message=f"file does not parse: {e.msg}",
        )
    return ModuleFile(path, text, tree), None


def _materialize(module: ModuleFile, raw: RawFinding) -> Finding:
    node = raw.node
    return Finding(
        rule=raw.rule,
        path=module.relpath,
        line=getattr(node, "lineno", 1),
        col=getattr(node, "col_offset", 0),
        message=raw.message,
    )


def lint_paths(
    paths: Sequence[str | Path],
    *,
    select: Optional[Set[str]] = None,
    baseline: Optional[Set[str]] = None,
    context: Optional[RepoContext] = None,
) -> Tuple[List[Finding], int]:
    """Run the registered rules over ``paths``.

    Returns ``(findings, files_scanned)`` with suppression comments and the
    baseline already applied, sorted by location.
    """
    repo = context or RepoContext()
    files = iter_python_files(paths)
    modules: List[ModuleFile] = []
    findings: List[Finding] = []

    for path in files:
        module, parse_finding = parse_module(path)
        if parse_finding is not None:
            findings.append(parse_finding)
            continue
        modules.append(module)

    active = [
        spec for rid, spec in sorted(RULES.items())
        if select is None or rid in select
    ]

    for module in modules:
        for spec in active:
            if spec.scope != "module":
                continue
            for raw in spec.fn(module, repo):
                if not module.is_allowed(raw.rule, getattr(raw.node, "lineno", 1)):
                    findings.append(_materialize(module, raw))

    for spec in active:
        if spec.scope != "repo":
            continue
        for module, raw in spec.fn(modules, repo):
            if not module.is_allowed(raw.rule, getattr(raw.node, "lineno", 1)):
                findings.append(_materialize(module, raw))

    if baseline:
        findings = [f for f in findings if f.key not in baseline]

    findings.sort(key=Finding.sort_key)
    return findings, len(files)


# -- baseline (grandfathered findings) ----------------------------------------

def load_baseline(path: str | Path) -> Set[str]:
    """Read an allowlist of grandfathered finding keys (``rule:path:line``).

    JSON format (written by ``--write-baseline``): ``{"version": 1,
    "allow": [{"key": ..., "message": ...}, ...]}``. Plain-text files with
    one key per line (``#`` comments) are accepted too.
    """
    text = Path(path).read_text(encoding="utf-8")
    stripped = text.lstrip()
    if stripped.startswith("{"):
        data = json.loads(text)
        entries = data.get("allow", [])
        return {
            e["key"] if isinstance(e, dict) else str(e)
            for e in entries
        }
    keys: Set[str] = set()
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            keys.add(line.split()[0])
    return keys


def write_baseline(path: str | Path, findings: Sequence[Finding]) -> None:
    data = {
        "version": 1,
        "allow": [
            {"key": f.key, "message": f.message} for f in findings
        ],
    }
    Path(path).write_text(json.dumps(data, indent=2) + "\n", encoding="utf-8")
