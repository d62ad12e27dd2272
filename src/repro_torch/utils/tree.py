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


def _walk(t, leaves: list, path=None):
    """Append the leaves to ``leaves`` (as ``(keystr, leaf)`` pairs when a
    ``path`` prefix is given) and return the treedef."""
    if isinstance(t, dict):
        keys = sorted(t)
        return ("dict", keys, [
            _walk(t[k], leaves, None if path is None else f"{path}[{k!r}]")
            for k in keys])
    if isinstance(t, (list, tuple)):
        return (type(t).__name__, None, [
            _walk(c, leaves, None if path is None else f"{path}[{i}]")
            for i, c in enumerate(t)])
    leaves.append(t if path is None else (path, t))
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


def tree_flatten_with_keys(tree: Any, prefix: str = ""
                           ) -> Tuple[List[Tuple[str, Any]], Any]:
    """``([(keystr, leaf)], treedef)``: each leaf's path as
    ``jax.tree_util.keystr`` writes it (``['params']['layers'][0]``), after
    ``prefix``, in the same order as :func:`tree_flatten`."""
    leaves: List[Tuple[str, Any]] = []
    return leaves, _walk(tree, leaves, prefix)


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


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed`` DTensor, without importing
    DTensor where nothing has (its first import takes seconds)."""
    import sys
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


# ------------------------------------------- flat vectors (repro.utils.tree)
def leaf_paths(tree: Any) -> List[str]:
    """Each leaf's path as ``jax.tree_util.keystr`` writes it
    (``"['blocks'][0]['wq']"``), in :func:`tree_flatten` order."""
    return [p for p, _ in tree_flatten_with_keys(tree)[0]]


def _numel(leaf) -> int:
    n = 1
    for d in leaf.shape:
        n *= int(d)
    return n


def flat_size(tree: Any) -> int:
    return sum(_numel(leaf) for leaf in tree_leaves(tree))


def tree_concat_flat(tree: Any):
    """All leaves, raveled in :func:`tree_flatten` order, as one f32
    vector."""
    import torch
    return torch.cat([torch.as_tensor(leaf).reshape(-1).float()
                      for leaf in tree_leaves(tree)])


def tree_from_flat(template: Any, vec) -> Any:
    """Inverse of :func:`tree_concat_flat` given a template: each leaf of
    the template's shape, in its dtype."""
    import torch
    leaves, treedef = tree_flatten(template)
    out, off = [], 0
    for leaf in leaves:
        n = _numel(leaf)
        dtype = leaf.dtype if isinstance(leaf, torch.Tensor) else \
            getattr(torch, str(leaf.dtype))
        out.append(vec[off:off + n].reshape(tuple(leaf.shape)).to(dtype))
        off += n
    return tree_unflatten(treedef, out)


def tree_zeros_like_flat(tree: Any):
    """A zero f32 vector of :func:`flat_size` entries, on the device of
    the tree's first tensor leaf (the CPU for numpy leaves)."""
    import torch
    dev = next((leaf.device for leaf in tree_leaves(tree)
                if isinstance(leaf, torch.Tensor)), None)
    return torch.zeros((flat_size(tree),), dtype=torch.float32, device=dev)


def leaf_offsets(tree: Any) -> List[Tuple[str, int, int]]:
    """(path, offset, size) of each leaf in :func:`tree_flatten` order."""
    out, off = [], 0
    for path, leaf in tree_flatten_with_keys(tree)[0]:
        n = _numel(leaf)
        out.append((path, off, n))
        off += n
    return out
