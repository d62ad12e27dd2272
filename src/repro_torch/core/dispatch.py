"""Kernel-dispatch layer: flat-vector backing for the sparse-ZO hot path
(``repro.core.dispatch``).

The fused kernels (``kernels/csrc/zo_update.cu``) operate on one flat
``[N]`` vector.  :class:`FlatBacking` bridges that and the parameter tree
for a (space, param-template) pair: it caches the static layout (leaf
shapes, dtypes, offsets in ``tree_leaves`` order — the JAX package's order,
so its offsets are identical) and the int64 global scatter indices that map
the space's ``[n]`` sparse vectors into the flat coordinate system:

* ``flatten(params)``   tree -> ``[n_pad]`` (leaf-concatenation order)
* ``unflatten(flat)``   ``[n_pad]`` -> tree of **views** into ``flat``
* ``expand(vec)``       ``[n]`` sparse values -> dense ``[n_pad]`` f32
* ``restrict(flat)``    dense ``[n_pad]`` -> ``[n]`` values at the coords
* ``scatter_into``      refresh the coords of a dense buffer in place

Parameters that are DTensors (the tensor-parallel compute view,
``sharding/fl.py``) get a :class:`ShardedBacking` instead: the same layout
over each rank's local shards, so the fused kernels run on those shards
with no collective.

Backend selection (``resolve_backend``): ``"kernel"`` — the flat route
through ``zo_dual_perturb_flat`` / ``zo_fused_update_flat``; ``"ref"`` — the
tree route through ``space.add``; ``"auto"`` — kernel when the layout
supports it and the flat route's dense vectors fit the device's budget.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.spaces import has_dtensors, shard_layout_key, sharded
from repro_torch.utils.tree import (is_dtensor, tree_flatten, tree_leaves,
                                    tree_unflatten)

# flat vectors are carried at a multiple of 1024 elements (repro's (8, 128)
# tile quantum), so every flat operand is 16-byte aligned for packed loads
_TILE = 1024
BACKENDS = ("auto", "kernel", "ref")


class FlatBacking:
    """Flat [N] view of a space over a parameter template (module doc)."""

    def __init__(self, space, template):
        # the space caches its backing (get_backing); keeping only its size
        # here, not the space, leaves no reference cycle between the two
        self.n_space = space.n
        leaves, self.treedef = tree_flatten(template)
        if not leaves:
            raise ValueError("empty parameter template")
        self.device = leaves[0].device
        self.shapes = [tuple(l.shape) for l in leaves]
        self.dtypes = [l.dtype for l in leaves]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.offsets = [0, *np.cumsum(self.sizes).tolist()]
        self.n_flat = int(self.offsets[-1])
        self.n_pad = -(-self.n_flat // _TILE) * _TILE
        self.dtype = self.dtypes[0] if len(set(self.dtypes)) == 1 else None
        # identity: the space covers every coordinate in storage order
        # (DenseSpace, or a full mask whose indices equal arange)
        self.identity = bool(space.identity_layout()
                             and space.n == self.n_flat)
        self._idx_leaves = None
        if not self.identity:
            idx_leaves = space.leaf_index_arrays(template)
            if space.n == self.n_flat:
                self.identity = all(
                    torch.equal(i.cpu(), torch.arange(s))
                    for i, s in zip(idx_leaves, self.sizes))
            if not self.identity:
                self._idx_leaves = idx_leaves
        self._global_index = None

    @property
    def global_index(self):
        """[n] int64 flat positions of the space coords (None if identity),
        built on first use."""
        if self.identity:
            return None
        if self._global_index is None:
            self._global_index = torch.cat(
                [i.to(self.device, torch.int64) + off
                 for i, off in zip(self._idx_leaves, self.offsets[:-1])])
        return self._global_index

    @property
    def supported(self) -> bool:
        """Whether the flat kernel route is usable for this layout."""
        return (self.dtype in (torch.float32, torch.bfloat16)
                and self.n_space > 0)

    def flatten(self, params):
        """Concatenate raveled leaves -> [n_pad] (uniform dtype, or f32),
        zero tail beyond ``n_flat``."""
        dt = self.dtype or torch.float32
        segs = [l.reshape(-1).to(dt) for l in tree_leaves(params)]
        if self.n_pad > self.n_flat:
            segs.append(torch.zeros(self.n_pad - self.n_flat, dtype=dt,
                                    device=self.device))
        return torch.cat(segs)

    def unflatten(self, flat):
        """Split a flat [n_pad] (or [N]) vector back into the tree: views
        of ``flat`` wherever the leaf dtype matches (no copy).  Leading
        axes of ``flat`` ([..., n_pad]: the stacked (w+, w-) pair) lead
        every leaf."""
        out = []
        lead = tuple(flat.shape[:-1])
        for o, s, sh, dt in zip(self.offsets[:-1], self.sizes, self.shapes,
                                self.dtypes):
            seg = flat[..., o:o + s].view(*lead, *sh)
            out.append(seg if seg.dtype == dt else seg.to(dt))
        return tree_unflatten(self.treedef, out)

    def expand(self, vec):
        """Sparse [n] values -> dense [n_pad] f32 (zeros elsewhere)."""
        buf = torch.zeros(self.n_pad, dtype=torch.float32, device=self.device)
        return self.scatter_into(buf, vec)

    def restrict(self, flat):
        """Dense [n_pad] (or [N]) -> the [n] values at the space coords."""
        if self.identity:
            return flat[:self.n_flat].float()
        return flat[self.global_index].float()

    def scatter_into(self, buf, vec):
        """Overwrite the space's coordinates of a dense [n_pad] f32 buffer
        with ``vec`` [n], **in place**, and return it.  Equal to
        :meth:`expand` whenever ``buf`` is zero off the coordinates (the
        coordinate set is static); the hot loop refreshes one z buffer each
        step instead of writing a new n_pad vector."""
        v = vec.to(torch.float32)
        if self.identity:
            buf[:self.n_flat].copy_(v)
        else:
            buf.index_copy_(0, self.global_index, v)
        return buf


class ShardedBacking:
    """:class:`FlatBacking` over this rank's local shards of DTensor
    parameters: ``flatten``, ``unflatten`` (each segment wrapped back into
    a DTensor of its leaf's placement), ``expand`` and ``scatter_into``
    over the local tensors, at the space's coordinates that fall inside
    them (``core/spaces.ShardedMask``).  On a one-rank model mesh the
    shards are the whole leaves and every vector equals
    :class:`FlatBacking`'s, bit for bit.  A rank holds only its own
    coordinates, so there is no ``restrict``: the callers carry the [n]
    vectors themselves."""

    def __init__(self, space, template):
        sm = sharded(space, template)
        self.n_space = space.n
        leaves, self.treedef = tree_flatten(template)
        self.meta = [(p.device_mesh, p.placements, p.shape, p.stride())
                     if is_dtensor(p) else None for p in leaves]
        local = [p.to_local() if is_dtensor(p) else p for p in leaves]
        self.device = local[0].device
        self.shapes = [tuple(l.shape) for l in local]
        self.dtypes = [l.dtype for l in local]
        self.sizes = [l.numel() for l in local]
        self.offsets = [0, *np.cumsum(self.sizes).tolist()]
        self.n_flat = int(self.offsets[-1])
        self.n_pad = -(-self.n_flat // _TILE) * _TILE
        self.dtype = self.dtypes[0] if len(set(self.dtypes)) == 1 else None
        self.index = torch.cat([i + off for i, off in
                                zip(sm.lidx, self.offsets[:-1])]).to(
                                    self.device)
        self.sel = torch.cat(sm.vsel).to(self.device)

    supported = FlatBacking.supported

    def flatten(self, params):
        return FlatBacking.flatten(self, [p.to_local() if is_dtensor(p)
                                          else p
                                          for p in tree_leaves(params)])

    def unflatten(self, flat):
        from torch.distributed.tensor import DTensor
        out = []
        for leaf, meta in zip(tree_leaves(FlatBacking.unflatten(self, flat)),
                              self.meta):
            out.append(leaf if meta is None else DTensor.from_local(
                leaf, meta[0], meta[1], run_check=False, shape=meta[2],
                stride=meta[3]))
        return tree_unflatten(self.treedef, out)

    def expand(self, vec):
        buf = torch.zeros(self.n_pad, dtype=torch.float32, device=self.device)
        return self.scatter_into(buf, vec)

    def scatter_into(self, buf, vec):
        buf.index_copy_(0, self.index, vec.to(torch.float32)[self.sel])
        return buf


def _layout_key(template):
    leaves, treedef = tree_flatten(template)
    return (repr(treedef), tuple((tuple(l.shape), str(l.dtype), str(l.device))
                                 for l in leaves))


def get_backing(space, template):
    """FlatBacking for (space, template), cached on the space instance (it
    depends on shapes, dtypes and the index tree, never on values); a
    :class:`ShardedBacking` where the template's leaves are DTensors."""
    if has_dtensors(template):
        # the meshes by identity too: unflatten wraps the shards on them
        # (the cached backing holds them, so no id is reused meanwhile)
        meshes = tuple(id(p.device_mesh) if is_dtensor(p) else None
                       for p in tree_leaves(template))
        key, cls = (shard_layout_key(template), meshes), ShardedBacking
    else:
        key, cls = _layout_key(template), FlatBacking
    cached = getattr(space, "_flat_backing", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    backing = cls(space, template)
    space._flat_backing = (key, backing)
    return backing


# The flat route keeps about six dense f32 [n_pad] vectors alive at once:
# w_flat, the dense delta, the z buffer, base = w_flat + delta, w+ and w-.
# On a CUDA card "auto" takes it while those fit in half of the card's
# memory, leaving the other half for the parameter tree and the forward's
# activations (Llama-3.2-1B: 6 x 4.95 GB = 30 GB of 80 GB).  On the CPU the
# budget is the JAX package's 256 MiB for CPU simulations.
FLAT_ROUTE_VECTORS = 6
DENSE_CARRY_AUTO_BYTES_CPU = 256 * 1024 * 1024


def flat_route_budget(device) -> int:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory // 2
    return DENSE_CARRY_AUTO_BYTES_CPU


def resolve_backend(backend: Optional[str], backing: FlatBacking) -> str:
    """Map a requested backend ('auto'/None included) to 'kernel' | 'ref'.
    An explicit backend is always honoured."""
    backend = backend or "auto"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "auto":
        if not backing.supported:
            return "ref"
        if FLAT_ROUTE_VECTORS * 4 * backing.n_pad > \
                flat_route_budget(backing.device):
            return "ref"
        return "kernel"
    return backend
