"""Nested-dict parameter trees, walked in ``jax.tree_util`` order.

A tree is a dict (keys visited **sorted**, as ``jax.tree_util`` visits
them), a list or tuple (in order), or a leaf (anything else: a tensor or a
numpy array).  ``FlatBacking``'s offsets and a mask's ``idx_tree`` depend on
this order, so a JAX parameter pytree and its port flatten identically.

The walkers are module-level functions, not closures that call themselves:
a self-referencing closure is a reference cycle, and one holding the leaf
list keeps every leaf tensor (whole flat parameter vectors on the ZO path)
alive until Python's cycle collector happens to run.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _walk(t, leaves: list):
    if isinstance(t, dict):
        keys = sorted(t)
        return ("dict", keys, [_walk(t[k], leaves) for k in keys])
    if isinstance(t, (list, tuple)):
        return (type(t).__name__, None, [_walk(c, leaves) for c in t])
    leaves.append(t)
    return None


def _build(d, it):
    if d is None:
        return next(it)
    kind, keys, children = d
    built = [_build(c, it) for c in children]
    if kind == "dict":
        return dict(zip(keys, built))
    return tuple(built) if kind == "tuple" else built


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves, treedef); ``treedef`` rebuilds the tree in tree_unflatten."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def tree_unflatten(treedef: Any, leaves) -> Any:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef,
                          [fn(*args) for args in zip(leaves, *others)])
