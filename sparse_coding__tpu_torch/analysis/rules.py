"""The sclint rule registry for the port: the JAX package's seven rule ids,
scopes and suppression semantics, each in the port's terms.

| id    | contract                                                           |
| ----- | ------------------------------------------------------------------ |
| SC001 | floating-ness via ``dtype.kind`` (numpy's bf16 is kind ``'V'``)    |
| SC002 | span/event category literals vs `telemetry.spans` tables           |
| SC003 | host syncs in the train loop / serve drainer call graphs (torch)   |
| SC004 | bare parameters sizing tensors under CUDA-graph capture or         |
|       | ``torch.compile`` (a capture or a recompile per value)             |
| SC005 | ``SC_*`` env reads outside the `utils.flags` registry              |
| SC006 | metric names colliding after Prometheus sanitization               |
| SC007 | ``SC_FAULT`` specs naming sites absent from the port               |

A rule is a generator ``(module, repo) -> findings`` registered with
:func:`rule`; ``scope="repo"`` rules instead receive the full module list
(for cross-file contracts like SC006's collision check). Findings carry the
AST node so the engine can honor line- and statement-anchored
``# sclint: allow(SCxxx)`` suppressions.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, NamedTuple, Optional, Set, Tuple

from sparse_coding__tpu_torch.analysis.context import RepoContext, _last_name, dotted_name

__all__ = ["RULES", "RuleSpec", "RawFinding", "rule"]


class RawFinding(NamedTuple):
    """A rule hit before suppression/baseline filtering: the engine turns
    these into `findings.Finding` records."""

    rule: str
    node: ast.AST
    message: str


class RuleSpec(NamedTuple):
    id: str
    title: str
    scope: str  # "module" | "repo"
    fn: object
    doc: str


RULES: Dict[str, RuleSpec] = {}


def rule(rule_id: str, title: str, scope: str = "module"):
    def deco(fn):
        RULES[rule_id] = RuleSpec(rule_id, title, scope, fn, fn.__doc__ or "")
        return fn

    return deco


def _str_values(node: ast.AST) -> List[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return [e.value for e in node.elts if isinstance(e, ast.Constant) and isinstance(e.value, str)]
    return []


def _functions(tree: ast.AST) -> Dict[str, ast.AST]:
    """The module's functions and methods by bare name (the first of a name)."""
    table: Dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            table.setdefault(node.name, node)
    return table


def _collect_calls(fn: ast.AST) -> Set[str]:
    """Bare and ``self.``-qualified callee names inside a function body."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Name):
            out.add(f.id)
        elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) and f.value.id in ("self", "cls"):
            out.add(f.attr)
    return out


def _reachable(table: Dict[str, ast.AST], roots: Iterable[ast.AST]) -> List[ast.AST]:
    """``roots`` and every same-module function they call, transitively."""
    out: List[ast.AST] = []
    seen: Set[int] = set()
    frontier = list(roots)
    while frontier:
        fn = frontier.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        out.append(fn)
        frontier += [table[c] for c in _collect_calls(fn) if c in table and id(table[c]) not in seen]
    return out


# -- SC001: dtype.kind floating-ness ------------------------------------------

def _is_dtype_kind(node: ast.AST) -> bool:
    """``<x>.dtype.kind``, ``<name containing 'dtype'>.kind`` or
    ``np.dtype(x).kind``."""
    if not (isinstance(node, ast.Attribute) and node.attr == "kind"):
        return False
    base = node.value
    if isinstance(base, ast.Attribute) and base.attr == "dtype":
        return True
    if isinstance(base, ast.Name) and "dtype" in base.id.lower():
        return True
    return isinstance(base, ast.Call) and _last_name(base.func) == "dtype"


@rule("SC001", "floating-ness tested via dtype.kind")
def sc001(module, repo: RepoContext) -> Iterable[RawFinding]:
    """The bf16 bug class: numpy (ml_dtypes) reports bfloat16 as kind
    ``'V'`` (void), so ``dtype.kind == 'f'`` silently excludes the dtype
    this codebase trains in. numpy dtypes still flow through the port (the
    chunk store, exports, the wire codecs), so floating-ness goes through
    ``np.issubdtype(dtype, np.floating)`` for numpy and
    ``torch.is_floating_point`` / ``dtype.is_floating_point`` for torch.
    Integer/raw-codec kind checks (``'i'``/``'u'``/``'b'``/``'V'`` without
    ``'f'``) are legitimate wire idioms and are not flagged."""
    for node in module.nodes:
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left] + list(node.comparators)
        if not any(_is_dtype_kind(s) for s in sides):
            continue
        if "f" in [v for s in sides for v in _str_values(s)]:
            yield RawFinding(
                "SC001", node,
                "floating-ness tested via dtype.kind — bfloat16 is numpy kind 'V', so this check "
                "silently misses it; use np.issubdtype(dtype, np.floating) for numpy, "
                "torch.is_floating_point(t) / dtype.is_floating_point for torch",
            )


# -- SC002: span/event categories ---------------------------------------------

_SPAN_FUNCS = ("span", "Span", "_emit_span")


def _span_category_arg(call: ast.Call) -> Optional[ast.Constant]:
    """The category literal of a span-constructor call, if any: positional
    index 1 (after the telemetry handle) or the ``category=`` keyword."""
    if len(call.args) > 1:
        a = call.args[1]
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            return a
    for kw in call.keywords:
        if kw.arg == "category" and isinstance(kw.value, ast.Constant) and isinstance(kw.value.value, str):
            return kw.value
    return None


@rule("SC002", "span/event category not in telemetry.spans registry")
def sc002(module, repo: RepoContext) -> Iterable[RawFinding]:
    """The dequant double-count class: a span emitted with a category the
    port's `telemetry.spans` tables don't know is either dropped by the
    goodput ledger (invisible wall time) or — when it legitimately nests
    inside a goodput span but is missing from ``INNER_CATEGORIES`` —
    double-counted. Checks every literal category handed to
    ``span(...)``/``Span(...)``/``_emit_span(...)`` and every ``category=``
    keyword on ``event(...)`` calls, plus lexically nested ``with
    span(...)`` blocks whose inner category is not registered as
    nestable."""
    emittable = repo.emittable_categories
    for node in module.nodes:
        if not isinstance(node, ast.Call):
            continue
        name = _last_name(node.func)
        if name in _SPAN_FUNCS:
            cat = _span_category_arg(node)
            if cat is not None and cat.value not in emittable:
                yield RawFinding(
                    "SC002", cat,
                    f"span category {cat.value!r} is not an emittable category in telemetry/spans.py "
                    "(register it in GOODPUT_CATEGORIES/BADPUT_CATEGORIES — and in INNER_CATEGORIES if it "
                    "nests — or the goodput ledger will drop or double-count it)",
                )
        elif name in ("event", "event_active"):
            for kw in node.keywords:
                if (
                    kw.arg == "category"
                    and isinstance(kw.value, ast.Constant)
                    and isinstance(kw.value.value, str)
                    and kw.value.value not in repo.all_categories
                ):
                    yield RawFinding(
                        "SC002", kw.value,
                        f"event category {kw.value.value!r} is not in telemetry/spans.py CATEGORIES — the "
                        "goodput ledger will not account it",
                    )

    # lexically nested spans: an inner category that is not registered
    # nestable double-counts against its enclosing goodput span
    for outer in module.nodes:
        if not isinstance(outer, ast.With):
            continue
        outer_cats = [
            c.value for item in outer.items
            if isinstance(item.context_expr, ast.Call)
            and _last_name(item.context_expr.func) in _SPAN_FUNCS
            and (c := _span_category_arg(item.context_expr)) is not None
        ]
        if not any(c in repo.goodput_categories for c in outer_cats):
            continue
        for inner in ast.walk(outer):
            if inner is outer or not isinstance(inner, ast.With):
                continue
            for item in inner.items:
                if not (isinstance(item.context_expr, ast.Call)
                        and _last_name(item.context_expr.func) in _SPAN_FUNCS):
                    continue
                cat = _span_category_arg(item.context_expr)
                if cat is not None and cat.value not in repo.inner_categories:
                    yield RawFinding(
                        "SC002", cat,
                        f"span category {cat.value!r} opens inside a goodput span but is not in "
                        "INNER_CATEGORIES — its seconds will be counted twice (the dequant bug class)",
                    )


# -- SC003: host syncs in hot loops -------------------------------------------

# entry points whose same-module call graphs form the audited hot paths
_HOT_ENTRIES: Dict[str, Tuple[str, ...]] = {
    "sparse_coding__tpu_torch/train/loop.py": ("ensemble_train_loop",),
    "sparse_coding__tpu_torch/serve/engine.py": ("_drain_once", "_loop"),
}

# tensor methods that copy to the host (and so wait for the card)
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")
# call-chain roots and methods that produce tensors (the float()/int()/bool()
# and np.asarray() checks)
_TENSOR_ROOTS = ("torch",)
_STEP_METHODS = ("step_batch", "step_scan", "step_scan_idx")
# tensor methods whose result is a host value (no sync)
_HOST_METHODS = ("numel", "nelement", "size", "dim", "element_size", "stride", "data_ptr", "is_contiguous",
                 "get_device")


def _allowed_transfer_lines(fn: ast.AST) -> Set[int]:
    """Lines covered by a ``with allowed_transfer():`` block — the port's
    sanctioned-sync marker (`telemetry.audit`)."""
    lines: Set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.With) and any(
            isinstance(i.context_expr, ast.Call) and _last_name(i.context_expr.func) == "allowed_transfer"
            for i in node.items
        ):
            lines.update(range(node.lineno, (node.end_lineno or node.lineno) + 1))
    return lines


def _is_tensor_expr(node: ast.AST, tainted: Set[str]) -> bool:
    """A value that is (or is computed from) a tensor: a ``torch.`` call, an
    ensemble step's result, a tainted name, a subscript of one, or a tensor
    method's result (but not the host-valued ``numel``/``size``/...)."""
    if isinstance(node, ast.Call):
        f = node.func
        if dotted_name(f).split(".")[0] in _TENSOR_ROOTS or _last_name(f) in _STEP_METHODS:
            return True
        return (isinstance(f, ast.Attribute) and f.attr not in _HOST_METHODS + _SYNC_METHODS
                and _is_tensor_expr(f.value, tainted))
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Subscript):
        return _is_tensor_expr(node.value, tainted)
    if isinstance(node, ast.BinOp):
        return _is_tensor_expr(node.left, tainted) or _is_tensor_expr(node.right, tainted)
    return False


def _tensor_tainted_names(fn: ast.AST) -> Set[str]:
    """Names assigned from tensor expressions (`_is_tensor_expr`), to a
    fixed point: their ``float()``/``int()``/``bool()`` coercion is a sync."""
    tainted: Set[str] = set()
    while True:
        before = len(tainted)
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _is_tensor_expr(node.value, tainted):
                tainted.update(n.id for tgt in node.targets for n in ast.walk(tgt) if isinstance(n, ast.Name))
        if len(tainted) == before:
            return tainted


def _hot_entries(module) -> Optional[Tuple[str, ...]]:
    entries = None
    for suffix, names in _HOT_ENTRIES.items():
        if module.relpath.endswith(suffix):
            entries = names
    for node in module.tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == "__sclint_hot_entries__"
        ):
            try:
                declared = ast.literal_eval(node.value)
            except ValueError:
                continue
            entries = tuple(entries or ()) + tuple(declared)
    return entries


@rule("SC003", "host sync inside a hot loop")
def sc003(module, repo: RepoContext) -> Iterable[RawFinding]:
    """A host sync in the graph-replayed train loop or the serve drainer
    stalls the card's queue (the reference's per-batch ``.item()`` stall).
    Flags ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
    ``torch.cuda.synchronize()``, a stream's or event's ``.synchronize()``,
    ``np.asarray(<tensor>)`` and ``float()``/``int()``/``bool()`` on tensor
    values (tensors: ``torch.`` calls, ensemble steps and what is computed
    from them) inside `train/loop.py::ensemble_train_loop`,
    `serve/engine.py::_drain_once` / ``_loop`` and every same-module
    function they (transitively) call. Sanctioned syncs say so: a ``with
    allowed_transfer():`` block (`telemetry.audit`) or an inline ``#
    sclint: allow(SC003) <why>`` on the statement. New hot loops opt in by
    declaring ``__sclint_hot_entries__ = ("fn_name", ...)`` at module top
    level."""
    entries = _hot_entries(module)
    if entries is None:
        return
    table = _functions(module.tree)
    for fn in _reachable(table, [table[n] for n in entries if n in table]):
        sanctioned = _allowed_transfer_lines(fn)
        tainted = _tensor_tainted_names(fn)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call) or node.lineno in sanctioned:
                continue
            f = node.func
            msg = None
            if isinstance(f, ast.Attribute) and f.attr in _SYNC_METHODS and not node.args:
                msg = f".{f.attr}() copies to the host and waits for the card"
            elif isinstance(f, ast.Attribute) and f.attr == "synchronize":
                msg = f"{dotted_name(f)}() blocks the host on the card"
            elif (isinstance(f, ast.Attribute) and f.attr in ("asarray", "array")
                  and dotted_name(f.value) in ("np", "numpy") and node.args
                  and _is_tensor_expr(node.args[0], tainted)):
                msg = f"np.{f.attr}(<tensor>) materializes device data on the host"
            elif (isinstance(f, ast.Name) and f.id in ("float", "int", "bool") and len(node.args) == 1
                  and _is_tensor_expr(node.args[0], tainted)):
                msg = f"{f.id}() on a tensor is a host sync"
            if msg is not None:
                yield RawFinding(
                    "SC003", node,
                    f"{msg} inside the hot path reachable from {'/'.join(entries)} — move it off the step "
                    "path, wrap a sanctioned once-per-chunk sync in allowed_transfer(), or annotate "
                    "'# sclint: allow(SC003) <why>'",
                )


# -- SC004: CUDA-graph capture and torch.compile hazards -----------------------

# (callable, shape-determining argument positions; None = every argument).
# torch's factories take sizes as varargs or one tuple, so every positional
# argument of zeros/ones/empty is a size.
_SHAPE_FUNCS: Dict[str, Optional[Tuple[int, ...]]] = {
    "zeros": None,
    "ones": None,
    "empty": None,
    "full": (0,),
    "arange": None,
    "eye": (0, 1),
    "topk": (1,),
    "reshape": (1,),
    "narrow": (2, 3),
}
# the same as tensor methods: x.reshape(*shape), x.view(*shape),
# x.expand(*sizes), x.topk(k), x.narrow(dim, start, length)
_SHAPE_METHODS: Dict[str, Optional[Tuple[int, ...]]] = {
    "reshape": None,
    "view": None,
    "expand": None,
    "topk": (0,),
    "narrow": (1, 2),
}
_SHAPE_KEYWORDS = ("size", "k", "length", "start", "end", "n", "m", "shape")
_SHAPE_ATTRS = ("shape", "dtype", "ndim", "size", "device")


def _is_capture_block(node: ast.AST) -> bool:
    """``with torch.cuda.graph(...)`` (any spelling ending ``cuda.graph``)."""
    return isinstance(node, ast.With) and any(
        isinstance(i.context_expr, ast.Call) and dotted_name(i.context_expr.func).endswith("cuda.graph")
        for i in node.items
    )


def _is_compile(node: ast.AST) -> bool:
    """``torch.compile`` / ``compile`` referenced as a decorator or callee."""
    return dotted_name(node) in ("torch.compile", "compile")


def _compiled_functions(tree: ast.AST, table: Dict[str, ast.AST]) -> List[ast.AST]:
    """Functions the module hands to ``torch.compile``: decorator form
    (``@torch.compile`` / ``@torch.compile(...)``) or call form
    (``torch.compile(fn_or_lambda, ...)``)."""
    out: List[ast.AST] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if any(_is_compile(d) or (isinstance(d, ast.Call) and _is_compile(d.func)) for d in node.decorator_list):
                out.append(node)
        elif isinstance(node, ast.Call) and _is_compile(node.func) and node.args:
            target = node.args[0]
            if isinstance(target, ast.Lambda):
                out.append(target)
            elif isinstance(target, ast.Name) and target.id in table:
                out.append(table[target.id])
    return out


def _shape_args(call: ast.Call) -> List[ast.AST]:
    """The arguments of ``call`` in shape positions, or [] if it is no
    shape-taking call."""
    f = call.func
    name = _last_name(f)
    method = isinstance(f, ast.Attribute) and dotted_name(f.value).split(".")[0] != "torch"
    table = _SHAPE_METHODS if method else _SHAPE_FUNCS
    if name not in table:
        return []
    positions = table[name]
    args = list(call.args) if positions is None else [call.args[i] for i in positions if i < len(call.args)]
    return args + [kw.value for kw in call.keywords if kw.arg in _SHAPE_KEYWORDS]


def _bare_params(arg: ast.AST, params: Set[str]) -> List[ast.Name]:
    """Names of ``params`` in ``arg`` that are not read through a tensor's
    ``.shape``/``.size()``/``.dtype`` (those are fixed by the static
    buffers a capture or a compile already keys on)."""
    exempt: Set[int] = set()
    for n in ast.walk(arg):
        if isinstance(n, ast.Attribute) and n.attr in _SHAPE_ATTRS:
            exempt.update(id(m) for m in ast.walk(n.value))
    return [n for n in ast.walk(arg) if isinstance(n, ast.Name) and n.id in params and id(n) not in exempt]


def _params_of(fn: ast.AST) -> Set[str]:
    a = fn.args
    return {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs} - {"self", "cls"}


@rule("SC004", "bare parameter sizes a tensor under CUDA-graph capture or torch.compile")
def sc004(module, repo: RepoContext) -> Iterable[RawFinding]:
    """A CUDA graph replays the Python values it was captured with: a bare
    function parameter that sizes a tensor (``torch.zeros/ones/empty/full/
    arange/eye``, ``.reshape/.view/.expand``, ``torch.topk``'s k,
    ``.narrow``) inside a ``with torch.cuda.graph(...)`` block, or inside a
    same-module function the block calls, needs its own capture (and its own
    pool) for every value it takes, and replays stale sizes if the key
    misses it. Inside a ``torch.compile``d function the same parameter
    recompiles per value. Sizes come from the static buffers' ``.shape``,
    the bucketing helpers (`serve.engine._pow2_ceil` / ``k_bucket``) that
    bound the values a graph key can take, or an ``lru_cache``'d builder.
    Closure scalars are exempt: a cached builder bakes them per capture
    deliberately."""
    if not any(marker in module.text for marker in ("cuda.graph", "torch.compile", "import compile")):
        return
    table = _functions(module.tree)
    sites: List[Tuple[ast.AST, ast.AST, str]] = []  # (function, region, form)
    for fn in table.values():
        for node in ast.walk(fn):
            if _is_capture_block(node):
                sites.append((fn, node, "CUDA-graph capture"))
                callees = [table[c] for c in _collect_calls(node) if c in table]
                sites += [(callee, callee, "CUDA-graph capture") for callee in _reachable(table, callees)]
    sites += [(fn, fn, "torch.compile") for fn in _compiled_functions(module.tree, table)]
    seen: Set[int] = set()
    for fn, region, form in sites:
        params = _params_of(fn)
        if not params:
            continue
        for node in ast.walk(region):
            if not isinstance(node, ast.Call):
                continue
            for arg in _shape_args(node):
                for name in _bare_params(arg, params):
                    if id(name) in seen:
                        continue
                    seen.add(id(name))
                    yield RawFinding(
                        "SC004", name,
                        f"parameter {name.id!r} sizes a tensor ({_last_name(node.func)}) under {form} — each "
                        "value needs its own capture (or compile); take sizes from the static buffers' .shape, "
                        "bucket callers via _pow2_ceil/k_bucket, or build through an lru_cache'd builder",
                    )


# -- SC005: SC_* env reads outside the flag registry --------------------------

_FLAGS_MODULE_SUFFIX = "utils/flags.py"
_FLAG_RE = re.compile(r"^SC_[A-Z0-9_]+$")


def _env_read_literal(node: ast.Call) -> Optional[ast.Constant]:
    """The key literal of ``os.environ.get(k)`` / ``os.getenv(k)``."""
    f = node.func
    if isinstance(f, ast.Attribute) and node.args:
        a = node.args[0]
        literal = isinstance(a, ast.Constant) and isinstance(a.value, str)
        if f.attr == "get" and dotted_name(f.value).endswith("environ") and literal:
            return a
        if f.attr == "getenv" and literal:
            return a
    return None


@rule("SC005", "SC_* env flag read outside utils.flags")
def sc005(module, repo: RepoContext) -> Iterable[RawFinding]:
    """Every ``SC_*`` env flag is declared once in the port's
    `utils.flags.FLAGS` (name, kind, default, owner, doc) and read through
    its accessor. A direct ``os.environ`` read re-scatters the default and
    parse to the call site. Also flags ``SC_*`` names (read *or* written)
    that are not registered at all: an unregistered flag is invisible to
    the generated docs table and to this rule's own accounting."""
    in_registry = module.relpath.endswith(_FLAGS_MODULE_SUFFIX)
    registered = repo.registered_flags
    doc_lines = module.docstring_lines
    for node in module.nodes:
        if isinstance(node, ast.Call):
            lit = _env_read_literal(node)
            if lit is not None and _FLAG_RE.match(lit.value) and not in_registry:
                yield RawFinding(
                    "SC005", lit,
                    f"direct os.environ read of {lit.value!r} — go through sparse_coding__tpu_torch.utils.flags "
                    f"(flags.{lit.value}.get()/.raw()) so the default and parse live in the registry",
                )
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and _FLAG_RE.match(node.value)
            and node.value not in registered
            and node.lineno not in doc_lines
        ):
            yield RawFinding(
                "SC005", node,
                f"{node.value!r} is not declared in utils/flags.py FLAGS — register it (name, kind, default, "
                "owner, doc) or the docs table and lint accounting cannot see it",
            )


# -- SC006: metric name collisions after Prometheus sanitization --------------

_METRIC_FUNCS = {
    "counter_inc": "_total",
    "counter_add_float": "_total",
    "counter_inc_active": "_total",
    "counter_add_float_active": "_total",
    "gauge_set": "",
    "gauge_set_active": "",
    "hist_observe": "",
}


@rule("SC006", "metric names collide after Prometheus sanitization", scope="repo")
def sc006(modules, repo: RepoContext) -> Iterable[Tuple[object, RawFinding]]:
    """`telemetry.metrics_http` sanitizes telemetry keys (dots and illegal
    characters become ``_``) and suffixes counters with ``_total``. Two
    distinct registered names that sanitize to the same exposition name
    silently merge into one Prometheus series — scrapes can't tell them
    apart and SLO lookups read the wrong one. Collects every literal
    counter/gauge/histogram name across the tree and reports each site of
    a colliding group."""
    by_final: Dict[str, List[Tuple[object, ast.AST, str]]] = {}
    for module in modules:
        for node in module.nodes:
            if not isinstance(node, ast.Call):
                continue
            name = _last_name(node.func)
            if name not in _METRIC_FUNCS or not node.args:
                continue
            a = node.args[0]
            if not (isinstance(a, ast.Constant) and isinstance(a.value, str)):
                continue
            final = "sc_" + repo.sanitize_metric(a.value) + _METRIC_FUNCS[name]
            by_final.setdefault(final, []).append((module, a, a.value))
    for final, sites in by_final.items():
        raws = {s[2] for s in sites}
        if len(raws) < 2:
            continue
        for module, node, raw in sites:
            yield module, RawFinding(
                "SC006", node,
                f"metric name {raw!r} collides with {sorted(raws - {raw})} after Prometheus sanitization (both "
                f"expose as {final!r}) — rename one; the exposition would silently merge the series",
            )


# -- SC007: SC_FAULT sites that don't exist -----------------------------------

def _fault_spec_literals(nodes: Iterable[ast.AST]) -> List[ast.Constant]:
    """String literals positioned as SC_FAULT values: ``env["SC_FAULT"] =
    v``, ``setenv("SC_FAULT", v)``, ``f(SC_FAULT=v)``, ``{"SC_FAULT": v}``."""
    out: List[ast.Constant] = []

    def is_fault_key(n: ast.AST) -> bool:
        return isinstance(n, ast.Constant) and n.value == "SC_FAULT"

    def is_str(n: ast.AST) -> bool:
        return isinstance(n, ast.Constant) and isinstance(n.value, str)

    for node in nodes:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript) and is_fault_key(tgt.slice) and is_str(node.value):
                    out.append(node.value)
        elif isinstance(node, ast.Call):
            # positional key/value pairs only for env-writer callables —
            # not every call that happens to mention the literal
            if _last_name(node.func) in ("setenv", "putenv", "setdefault"):
                for i, a in enumerate(node.args[:-1]):
                    if is_fault_key(a) and is_str(node.args[i + 1]):
                        out.append(node.args[i + 1])
            out += [kw.value for kw in node.keywords if kw.arg == "SC_FAULT" and is_str(kw.value)]
        elif isinstance(node, ast.Dict):
            out += [v for k, v in zip(node.keys, node.values) if k is not None and is_fault_key(k) and is_str(v)]
    return out


@rule("SC007", "SC_FAULT spec names a nonexistent fault site")
def sc007(module, repo: RepoContext) -> Iterable[RawFinding]:
    """A chaos run whose ``SC_FAULT`` spec names a site no
    ``fault_point(...)`` in the port declares injects *nothing* — the run
    silently becomes a control run (chip_smoke.py's chaos phases included).
    Valid sites are the port's literal fault_point call sites plus the
    grammar's aliases and per-action defaults (`utils.faults`). Malformed
    specs (unknown action, uninferrable site) are flagged too. Non-package
    files calling ``fault_point`` with an unknown literal site get the same
    treatment."""
    sites = repo.fault_sites
    for lit in _fault_spec_literals(module.nodes):
        try:
            specs = repo.parse_fault_spec(lit.value)
        except ValueError as e:
            yield RawFinding("SC007", lit, f"malformed SC_FAULT spec: {e}")
            continue
        for spec in specs:
            if spec.site is not None and spec.site not in sites:
                yield RawFinding(
                    "SC007", lit,
                    f"SC_FAULT spec {lit.value!r} selects site {spec.site!r}, but no fault_point({spec.site!r}) "
                    "exists in the port — the fault would never fire and the run silently becomes a control",
                )
    if not module.in_package:
        for node in module.nodes:
            if (
                isinstance(node, ast.Call)
                and _last_name(node.func) == "fault_point"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
                and node.args[0].value not in sites
            ):
                yield RawFinding(
                    "SC007", node.args[0],
                    f"fault_point site {node.args[0].value!r} is not declared by any package fault_point call",
                )
