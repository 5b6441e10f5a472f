"""Param trees: nested dicts, lists, tuples and dataclasses of tensors.

The JAX package's params, buffers and optimizer states are pytrees; the
port's are the same trees of tensors. One walker serves them all: leaves are
visited in JAX's pytree order (dict keys sorted, lists and tuples in order,
dataclass fields in declaration order) and a mapped dict keeps its own key
order. ``None`` is an empty subtree, as in JAX: it has no leaves and maps to
``None``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

Tree = Any
_END = object()


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn(leaf, *leaves of rest at the same place)`` over ``tree``'s
    leaves, in JAX's order; ``rest`` trees follow ``tree``'s structure down
    to its leaves (what they hold there, a subtree or a `QuantMoment`, is
    passed whole)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = dict.fromkeys(tree)
        for k in sorted(tree):
            out[k] = tree_map(fn, tree[k], *(r[k] for r in rest))
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)([tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)])
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
                             for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_paths(tree: Tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs in JAX's order, a path the tuple of keys,
    indices and field names from the root."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    else:
        return [(prefix, tree)]
    out: List[Tuple[Tuple, Any]] = []
    for k, v in items:
        out += tree_paths(v, prefix + (k,))
    return out


def tree_leaves(tree: Tree) -> List[Any]:
    """The leaves in JAX's order (``jax.tree.leaves``)."""
    return [v for _, v in tree_paths(tree)]


def tree_unflatten(like: Tree, leaves) -> Tree:
    """``like``'s structure with ``leaves`` (JAX's order) in place of its
    own."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree has places")
    return out
