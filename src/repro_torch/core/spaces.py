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

:func:`sharded` maps a space onto parameters that are DTensors (the
tensor-parallel compute view, ``sharding/fl.py``): :class:`ShardedMask`
holds, per leaf, the space's coordinates that fall inside this rank's
shard, as offsets into the local tensor, and perturbs and updates the
local tensors in place with no collective, by the arithmetic of
``space.add`` (``p[i] + s[i]`` in the leaf's dtype), element for element.
"""
from __future__ import annotations

import math

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


class ShardedMask:
    """A space's coordinates on this rank's shards (module doc).

    ``params``' leaves are DTensors on a 1-D mesh (one ``Shard(d)`` or
    ``Replicate()`` placement each) or plain tensors.  For each leaf it
    keeps ``lidx`` (the coordinates' offsets into the flat local tensor)
    and ``vsel`` (their positions in the space's [n] vector); the
    replicated global indices are translated once, here."""

    def __init__(self, space, params):
        # the indices are real even where the parameters are fake (the dry
        # run, launch/dryrun.py): translate them outside any fake mode
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        with unset_fake_temporarily():
            self._translate(space, params)

    def _translate(self, space, params):
        leaves = tree_leaves(params)
        idx_leaves = space.leaf_index_arrays(params)
        self.n = space.n
        self.lidx, self.vsel = [], []
        off = 0
        for p, idx in zip(leaves, idx_leaves):
            idx = idx.to(torch.int64)
            dev = idx.device
            pos = torch.arange(off, off + idx.shape[0], device=dev)
            off += idx.shape[0]
            dim = _shard_dim(p)
            if dim is None:
                self.lidx.append(idx)
                self.vsel.append(pos)
                continue
            r = p.device_mesh.get_local_rank()
            shape = tuple(p.shape)
            inner = math.prod(shape[dim + 1:])
            chunk = p.to_local().shape[dim]   # the rules shard dims that divide
            coord = torch.div(idx, inner, rounding_mode="floor") % shape[dim]
            keep = (coord >= r * chunk) & (coord < (r + 1) * chunk)
            gi, c = idx[keep], coord[keep] - r * chunk
            outer = torch.div(gi, inner * shape[dim], rounding_mode="floor")
            self.lidx.append(outer * (chunk * inner) + c * inner
                             + gi % inner)
            self.vsel.append(pos[keep])
        if off != self.n:
            raise ValueError(f"index arrays hold {off} coordinates, the "
                             f"space {self.n}")

    @staticmethod
    def _flat(p):
        return (p.to_local() if _is_dt(p) else p).view(-1)

    def values(self, params):
        """The current values at this rank's coordinates, per leaf."""
        return [self._flat(p)[i] for p, i in zip(tree_leaves(params),
                                                   self.lidx)]

    def add_(self, params, vec):
        """``params + scatter(vec)`` at the coordinates, in place (the
        arithmetic of ``space.add``); returns ``params``."""
        for p, i, v in zip(tree_leaves(params), self.lidx, self.vsel):
            if i.shape[0]:
                flat = self._flat(p)
                flat.index_add_(0, i, vec[v].to(flat.dtype))
        return params

    def set_(self, params, base, vec=None):
        """The coordinates set to ``base + vec`` (``base`` from
        :meth:`values`; the value ``space.add(params_at_base, vec)``
        gives), or back to ``base`` with no ``vec``; returns ``params``."""
        for p, i, v, b in zip(tree_leaves(params), self.lidx, self.vsel,
                              base):
            if not i.shape[0]:
                continue
            flat = self._flat(p)
            flat[i] = b if vec is None else b + vec[v].to(flat.dtype)
        return params


def _is_dt(t) -> bool:
    from repro_torch.utils.tree import is_dtensor
    return is_dtensor(t)


def _shard_dim(p):
    """The tensor dim a DTensor leaf is sharded on over its 1-D mesh (None:
    a plain tensor or a replicated leaf, whose local tensor is whole)."""
    if not _is_dt(p):
        return None
    if p.device_mesh.ndim != 1:
        raise ValueError("ShardedMask takes leaves on a 1-D mesh (the tp "
                         "compute view)")
    pl = p.placements[0]
    return pl.dim if pl.is_shard() else None


def shard_layout_key(params) -> tuple:
    """What a translation of the space's coordinates to this rank's shards
    depends on, leaf by leaf: the global shape, the placements, the size of
    the leaf's mesh and this rank's coordinate on it (and dtype and device,
    for a flat layout over the shards, ``core/dispatch.ShardedBacking``)."""
    return tuple((tuple(p.shape), str(p.dtype), str(p.device),
                  (str(p.placements), p.device_mesh.size(),
                   p.device_mesh.get_local_rank()) if _is_dt(p) else None)
                 for p in tree_leaves(params))


def sharded(space, params) -> ShardedMask:
    """The :class:`ShardedMask` of ``space`` on ``params``, cached on the
    space per :func:`shard_layout_key`, so a round translates the indices
    once."""
    key = shard_layout_key(params)
    cached = getattr(space, "_sharded", None)
    if cached is None or cached[0] != key:
        space._sharded = cached = (key, ShardedMask(space, params))
    return cached[1]


def has_dtensors(params) -> bool:
    """Whether a parameter tree holds DTensors (the tp compute view)."""
    return any(_is_dt(p) for p in tree_leaves(params))
