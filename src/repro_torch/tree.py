"""Leaf flattening in ``jax.tree.leaves`` order.

Per-leaf budgets k^(l), global leaf ids and health labels all follow the
JAX flatten order, so the port must reproduce it: dict keys sorted,
lists and tuples in order, anything else a leaf.

The walkers are module-level functions, not nested closures: a
recursive closure refers to itself through its cell, and that cycle
would keep every leaf it collected (gigabytes of device memory on the
training path) alive until Python's cyclic collector ran.
"""
from __future__ import annotations

from typing import Any, Callable


def _flatten_into(x, leaves: list):
    if isinstance(x, dict):
        keys = sorted(x)
        return ("dict", keys, [_flatten_into(x[k], leaves) for k in keys])
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, None, [_flatten_into(v, leaves) for v in x])
    leaves.append(x)
    return None


def flatten(tree) -> tuple[list, Any]:
    """(leaves, treedef); ``treedef`` rebuilds the structure in
    :func:`unflatten`."""
    leaves: list = []
    return leaves, _flatten_into(tree, leaves)


def _build(node, it):
    if node is None:
        return next(it)
    kind, keys, children = node
    vals = [_build(c, it) for c in children]
    if kind == "dict":
        return dict(zip(keys, vals))
    return tuple(vals) if kind == "tuple" else list(vals)


def unflatten(treedef, leaves) -> Any:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def leaves(tree) -> list:
    return flatten(tree)[0]


def _up_to_into(node, x, out: list) -> None:
    if node is None:
        out.append(x)
        return
    kind, keys, children = node
    if kind == "dict":
        for k, c in zip(keys, children):
            _up_to_into(c, x[k], out)
        return
    if len(x) != len(children):
        raise ValueError("tree structures differ")
    for c, v in zip(children, x):
        _up_to_into(c, v, out)


def flatten_up_to(treedef, tree) -> list:
    """The subtrees of ``tree`` at the leaf positions of ``treedef``, in
    flatten order (``jax``'s ``treedef.flatten_up_to``): a tree of
    per-leaf tuples gives one tuple per leaf."""
    out: list = []
    _up_to_into(treedef, tree, out)
    return out


def _paths_into(x, path: tuple, out: list) -> None:
    if isinstance(x, dict):
        for k in sorted(x):
            _paths_into(x[k], path + (str(k),), out)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _paths_into(v, path + (str(i),), out)
    else:
        out.append("/".join(path))


def leaf_paths(tree) -> list[str]:
    """'/'-joined key paths of the leaves, in flatten order."""
    out: list[str] = []
    _paths_into(tree, (), out)
    return out


def map(fn: Callable, tree, *rest) -> Any:
    """``jax.tree.map``: ``fn`` over the leaves of ``tree`` (and the
    matching leaves of each tree in ``rest``)."""
    flat, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError("tree structures differ")
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])
