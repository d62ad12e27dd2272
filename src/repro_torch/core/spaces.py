"""Trainable-parameter spaces for sparse zeroth-order optimization
(``repro.core.spaces``).

A *space* is the subset of coordinates that ZO perturbs and updates.  It maps
a flat value vector ``v in R^n`` into the parameter tree:

* :class:`MaskedSpace` — MEERKAT: ``n = u * d`` sparse coordinates given by
  per-leaf flat indices (paper Eq. 1: ``z (.) m`` — z is sampled only at the
  masked coordinates, mathematically identical, O(n) memory).
* :class:`DenseSpace`  — Full-FedZO: all parameters.
* :class:`LoRASpace`   — LoRA-FedZO: every coordinate of the ``lora_*``
  adapter leaves, none of the base weights.

z comes from ``core/prng.py`` on the space's device, so a space built from a
JAX mask draws the same uniform bits as ``repro``'s.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.utils.tree import (tree_flatten, tree_flatten_with_keys,
                                   tree_leaves, tree_unflatten)


class _FlatSpace:
    """Flat-vector backing shared by every space (kernel dispatch).

    Subclasses provide ``leaf_index_arrays(template)`` — per-leaf int64 flat
    indices of the selected coordinates, in the leaf order of
    ``tree_leaves(template)``."""

    def leaf_index_arrays(self, template):
        raise NotImplementedError

    def identity_layout(self) -> bool:
        """True if this space structurally covers every coordinate in
        storage order (no index materialization needed)."""
        return False

    def sample_z(self, key):
        return prng.normal(key, self.n, self.device)


class MaskedSpace(_FlatSpace):
    """Sparse coordinate space from per-leaf flat index tensors.

    ``idx_tree`` has the structure of ``params``; each leaf is an int64
    tensor of flat indices into the (raveled) parameter leaf, on the device
    the space samples on.  Leaves with no selected coordinates hold an empty
    tensor."""

    def __init__(self, idx_tree):
        self.idx_tree = idx_tree
        leaves = tree_leaves(idx_tree)
        self.device = leaves[0].device
        self.sizes = [int(l.shape[0]) for l in leaves]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).astype(int)
        self.n = int(self.offsets[-1])

    def _segments(self, vec):
        return [vec[self.offsets[i]:self.offsets[i + 1]]
                for i in range(len(self.sizes))]

    def add(self, params, vec):
        """params + scatter(vec) at the masked coordinates (a new tree)."""
        p_leaves, treedef = tree_flatten(params)
        out = []
        for p, idx, s in zip(p_leaves, tree_leaves(self.idx_tree),
                             self._segments(vec)):
            if idx.shape[0] == 0:
                out.append(p)
                continue
            out.append(p.reshape(-1).index_add(0, idx, s.to(p.dtype))
                       .reshape(p.shape))
        return tree_unflatten(treedef, out)

    def slice(self, tree):
        """Restrict a tree (e.g. a gradient) to the masked coords -> [n]."""
        segs = [l.reshape(-1)[idx].float()
                for l, idx in zip(tree_leaves(tree),
                                  tree_leaves(self.idx_tree))]
        return torch.cat(segs) if segs else torch.zeros(0, device=self.device)

    def leaf_index_arrays(self, template):
        return tree_leaves(self.idx_tree)


class DenseSpace(_FlatSpace):
    """All parameters, flattened (Full-FedZO)."""

    def __init__(self, template):
        leaves = tree_leaves(template)
        self.template = template
        self.device = leaves[0].device
        self.sizes = [int(l.numel()) for l in leaves]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).astype(int)
        self.n = int(self.offsets[-1])

    def add(self, params, vec):
        p_leaves, treedef = tree_flatten(params)
        out = [p + vec[self.offsets[i]:self.offsets[i + 1]]
               .reshape(p.shape).to(p.dtype) for i, p in enumerate(p_leaves)]
        return tree_unflatten(treedef, out)

    def slice(self, tree):
        return torch.cat([l.reshape(-1).float() for l in tree_leaves(tree)])

    def leaf_index_arrays(self, template):
        return [torch.arange(l.numel(), device=self.device)
                for l in tree_leaves(template)]

    def identity_layout(self) -> bool:
        return True


class LoRASpace(_FlatSpace):
    """Only the ``lora_*`` adapter leaves, dense within them (LoRA-FedZO).

    ``template``'s leaves whose path holds ``lora_`` are the space, in
    ``tree_leaves`` order; the base weights are never perturbed or
    updated.  Raises when the template has no adapter (a config with
    ``lora_rank`` 0)."""

    def __init__(self, template):
        paths, _ = tree_flatten_with_keys(template)
        self._is_lora = ["lora_" in path for path, _ in paths]
        leaves = [leaf for _, leaf in paths]
        self.device = leaves[0].device
        self.sizes = [int(l.numel()) if m else 0
                      for l, m in zip(leaves, self._is_lora)]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).astype(int)
        self.n = int(self.offsets[-1])
        if self.n == 0:
            raise ValueError("no lora_* leaves found; set cfg.lora_rank > 0")

    def add(self, params, vec):
        """params + vec at the adapter coordinates (a new tree; the base
        leaves are the same tensors)."""
        p_leaves, treedef = tree_flatten(params)
        out = [p + vec[self.offsets[i]:self.offsets[i + 1]]
               .reshape(p.shape).to(p.dtype) if m else p
               for i, (p, m) in enumerate(zip(p_leaves, self._is_lora))]
        return tree_unflatten(treedef, out)

    def slice(self, tree):
        return torch.cat([l.reshape(-1).float() for l, m in
                          zip(tree_leaves(tree), self._is_lora) if m])

    def leaf_index_arrays(self, template):
        return [torch.arange(l.numel(), device=self.device) if m
                else torch.zeros(0, dtype=torch.int64, device=self.device)
                for l, m in zip(tree_leaves(template), self._is_lora)]

    def identity_layout(self) -> bool:
        return all(self._is_lora)
