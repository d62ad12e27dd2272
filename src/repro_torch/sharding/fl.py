"""Sharding plan for the federated ZO round (``repro.sharding.fl``): the
mesh route of ``core/server.FederatedZO`` and ``core/fl_step``.

The round's layout is the paper's own: clients over devices, parameters
ZeRO-3-sharded at rest, and only scalars crossing the wire.

* **clients** (the cohort of a T-group) split over the mesh batch axes —
  every mesh axis under ``rule="fsdp"`` and ``"replicate"`` (ZO has no
  tensor parallelism to spend the ``'model'`` axis on) — in contiguous
  blocks, one a rank, when the group size divides by :attr:`dp`; a ragged
  group runs every client on every rank, as in the JAX package.
* **parameters** rest as DTensors (:meth:`FLShardPlan.place_params`) per
  ``sharding/rules.py``: ``"fsdp"`` shards each leaf over all mesh axes on
  its largest divisible dim (:func:`rules.fsdp_only_specs`),
  ``"replicate"`` keeps a whole copy a rank.  The round body gathers them
  once at entry (:meth:`FLShardPlan.compute_view`, ``full_tensor()``) and
  computes unsharded: each rank runs its clients through the unsharded
  server's own client loop, so every route and kernel stays as it is
  (ROADMAP C20), and the sharded round is bit-identical to the unsharded
  one.
* **scalars** (the uploaded projected gradients) ``all_gather`` in client
  order; every rank then replays, aggregates and applies the identical
  update and re-places the parameters.

``rule="tp"`` computes tensor-parallel (Megatron specs,
:func:`rules.param_specs`): clients split over the batch axes only, and
the ``'model'`` axis splits each matmul.  At rest a leaf also carries the
rules' ZeRO-3 second axis; :meth:`FLShardPlan.compute_view` gathers that
axis once a round and leaves each leaf a DTensor on the 1-D ``'model'``
sub-mesh with its Megatron placement (:func:`compute_placements`), and the
model code runs on those DTensors (``models/transformer.ModelCtx``).  Each
rank's batch rows are its own, so no DTensor op ever splits or gathers
over a batch axis.  The masked perturbation and update work on each
rank's local shard in place, with no collective
(``core/spaces.ShardedMask``).  Row-parallel contractions reorder float
sums, so on more than one model rank the round is held to the JAX tool's
tolerance (ROADMAP C21); on ``1x1`` it is bit-equal.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import MeshConfig
from repro_torch.sharding.rules import (Spec, fsdp_only_specs, param_specs,
                                        to_placements)
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

P = Spec

PARAM_RULES = ("fsdp", "tp", "replicate")


@dataclasses.dataclass(frozen=True)
class FLShardPlan:
    """How one federated round maps onto a device mesh.

    ``mesh``     — a ``DeviceMesh`` (``launch/mesh.make_mesh_from_config``).
    ``mesh_cfg`` — its :class:`MeshConfig` (axis sizes/names).
    ``rule``     — parameter sharding rule: ``"fsdp"`` (default, bit-exact
    against the unsharded round), ``"replicate"``, or ``"tp"``
    (tensor-parallel compute, module docstring).
    """
    mesh: Any
    mesh_cfg: MeshConfig
    rule: str = "fsdp"

    def __post_init__(self):
        if self.rule not in PARAM_RULES:
            raise ValueError(
                f"rule must be one of {PARAM_RULES}, got {self.rule!r}")

    # -- basic wrappers ------------------------------------------------------
    @property
    def batch_axes(self):
        """Mesh axes acting as the FL-client axis: every axis under
        ``"fsdp"``/``"replicate"``, ``('pod', 'data')`` under ``"tp"``.
        Under client sampling it spans the round's sampled cohort."""
        if self.rule == "tp":
            return self.mesh_cfg.batch_axes
        return tuple(self.mesh_cfg.axis_names)

    @property
    def dp(self) -> int:
        """Data-parallel width: product of :attr:`batch_axes` sizes."""
        n = self.mesh_cfg.data * self.mesh_cfg.pods
        if self.rule != "tp":
            n *= self.mesh_cfg.model
        return n

    def _index(self, axes) -> int:
        """This rank's index along ``axes`` of the mesh, the first major."""
        coord = dict(zip(self.mesh_cfg.axis_names,
                         self.mesh.get_coordinate()))
        sizes = dict(zip(self.mesh_cfg.axis_names, self.mesh_cfg.shape))
        i = 0
        for a in axes:
            i = i * sizes[a] + coord[a]
        return i

    @property
    def dp_index(self) -> int:
        """This rank's index along the batch axes."""
        return self._index(self.batch_axes)

    # -- parameter placement -------------------------------------------------
    def param_specs(self, params):
        """Spec tree for ``params`` under :attr:`rule`."""
        if self.rule == "replicate":
            return tree_map(lambda l: P(*([None] * l.dim())), params)
        fn = fsdp_only_specs if self.rule == "fsdp" else param_specs
        return fn(None, params, self.mesh_cfg)

    def _local(self, t: torch.Tensor, spec: Spec,
               skip=()) -> torch.Tensor:
        """This rank's shard of the full tensor ``t`` under ``spec`` (the
        rules shard only dims their axes divide), leaving the axes in
        ``skip`` whole: ``t`` itself where nothing is cut, else a copy of
        the shard (so the full tensor can go)."""
        sizes = dict(zip(self.mesh_cfg.axis_names, self.mesh_cfg.shape))
        out = t
        for d, entry in enumerate(spec):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            axes = tuple(a for a in axes if a not in skip)
            n = math.prod(sizes[a] for a in axes)
            if n > 1:
                chunk = t.shape[d] // n
                out = out.narrow(d, self._index(axes) * chunk, chunk)
        return out if out.shape == t.shape else out.clone()

    def place_params(self, params):
        """Distribute a parameter tree as DTensors at rest (ZeRO-3), each
        leaf placed per its spec (``rules.to_placements``, the counterpart
        of JAX's ``param_shardings``), one shard a rank.  The leaves are
        full tensors (a leaf the rule leaves whole here is not copied,
        but under ``"tp"``, whose round updates the shards in place, it
        is), or under ``"tp"`` :meth:`compute_view`'s DTensors, whose
        local shards are cut down to the rest layout here."""
        from torch.distributed.tensor import DTensor
        leaves, treedef = tree_flatten(params)
        specs, _ = tree_flatten(self.param_specs(params))
        model = self.mesh_cfg.axis_names[-1]
        out = []
        for t, spec in zip(leaves, specs):
            if isinstance(t, DTensor):      # a tp compute view's leaf
                local = self._local(t.to_local(), spec, skip=(model,))
            else:
                local = self._local(t, spec)
                if self.rule == "tp" and local is t:
                    local = t.clone()
            out.append(DTensor.from_local(
                local, self.mesh, to_placements(spec, self.mesh),
                run_check=False, shape=t.shape, stride=t.stride()))
        return tree_unflatten(treedef, out)

    def full(self, params):
        """Every leaf gathered whole (``full_tensor()``): what a checkpoint
        or an evaluation reads."""
        from torch.distributed.tensor import DTensor
        return tree_map(lambda t: t.full_tensor()
                        if isinstance(t, DTensor) else t, params)

    def compute_view(self, params):
        """The parameters the round body computes with.  ``"fsdp"`` and
        ``"replicate"``: each leaf gathered once (``full_tensor()``), the
        ZeRO-3 gather at round entry.  ``"tp"``: each leaf's ZeRO-3 axis
        gathered once, the leaf left a DTensor on the ``'model'`` sub-mesh
        with its Megatron placement (:func:`compute_placements`); its
        local shard is the rest layout's storage where no axis was
        gathered, so the round's in-place work updates it (JAX donates
        the parameters)."""
        if self.rule != "tp":
            return self.full(params)
        from torch.distributed.tensor import DTensor, Replicate
        specs = tree_flatten(self.param_specs(params))[0]
        leaves, treedef = tree_flatten(params)
        out = []
        for t, spec in zip(leaves, specs):
            sub, pl = compute_placements(self.mesh, spec)
            if not isinstance(t, DTensor):
                t = DTensor.from_local(t, self.mesh,
                                       [Replicate()] * self.mesh.ndim,
                                       run_check=False)
            want = [Replicate()] * (self.mesh.ndim - 1) + pl
            if list(t.placements) != want:
                t = t.redistribute(self.mesh, want)
            out.append(DTensor.from_local(t.to_local(), sub, pl,
                                          run_check=False, shape=t.shape,
                                          stride=t.stride()))
        return tree_unflatten(treedef, out)

    def constrain_params_fn(self):
        """``params -> params`` re-placing the parameters per the plan's
        rule: the ``constrain_params`` of ``core/fl_step``'s mesh route,
        which reads the plan from it (``.plan``)."""
        return _Constrain(self)

    def model_ctx(self, base_ctx):
        """``base_ctx`` (a ``models.transformer.ModelCtx``) with this
        plan's mesh and batch axes: JAX's ``FLShardPlan.shard_ctx``."""
        return dataclasses.replace(base_ctx, mesh=self.mesh,
                                   batch_axes=tuple(self.batch_axes))

    # -- the client axis -----------------------------------------------------
    def client_block(self, n_clients: int) -> range:
        """The clients this rank runs of a group of ``n_clients``: its
        contiguous block when :attr:`dp` divides the group, every client
        when the group is ragged."""
        if n_clients % self.dp:
            return range(n_clients)
        k = n_clients // self.dp
        return range(self.dp_index * k, (self.dp_index + 1) * k)

    def gather_clients(self, local: torch.Tensor, n_clients: int):
        """The group's per-client values in client order from each rank's
        block ``local`` (leading axis its clients): one ``all_gather`` over
        the ranks, nothing where the group is ragged (every rank holds every
        client)."""
        if n_clients % self.dp:
            return local
        # the batch axes lead the mesh, whose row-major coordinate is the
        # rank (launch/mesh.py): rank = dp_index * tp + model index, so
        # the ranks of model index 0 hold the blocks in client order
        tp = self.mesh_cfg.n_devices // self.dp
        parts = [torch.empty_like(local) for _ in range(self.dp * tp)]
        dist.all_gather(parts, local.contiguous())
        return torch.cat(parts[::tp])

    def broadcast(self, tree):
        """Rank 0's tree of tensors on every rank, each leaf on the device
        of this rank's own: for values every rank computes but only rank
        0's may be used (a mask or gradient from a backward pass, which two
        cards may round differently)."""
        import numpy as np
        leaves, treedef = tree_flatten(tree)
        obj = [[np.asarray(t.detach().cpu()) for t in leaves]]
        dist.broadcast_object_list(obj, src=0)
        return tree_unflatten(treedef, [
            torch.as_tensor(a, device=t.device)
            for a, t in zip(obj[0], leaves)])

    def client_batch_spec(self, n_clients: int, ndim: int) -> Spec:
        """Spec of one stacked client-batch leaf ``[K, T, b, ...]``: the
        client axis over :attr:`batch_axes` when divisible, else
        replicated (a ragged fleet still runs, without the split)."""
        k_spec = self.batch_axes if n_clients % self.dp == 0 else None
        return P(k_spec, *([None] * (ndim - 1)))

    def place_client_batches(self, batches, n_clients: int):
        """A stacked batch dict (leaves ``[K, T, b, ...]``, full on every
        rank) as DTensors, the client axis over :attr:`batch_axes`: each
        rank keeps its block (:meth:`client_block`)."""
        from torch.distributed.tensor import DTensor
        blk = self.client_block(n_clients)
        out = {}
        for k, v in batches.items():
            spec = self.client_batch_spec(n_clients, v.dim())
            local = v if len(blk) == n_clients else \
                v[blk.start:blk.stop].clone()
            out[k] = DTensor.from_local(
                local, self.mesh, to_placements(spec, self.mesh),
                run_check=False, shape=v.shape, stride=v.stride())
        return out

    def place_replicated(self, x: torch.Tensor):
        """``x`` (PRNG keys, scalars) as a DTensor replicated on the mesh."""
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(
            x, self.mesh, to_placements(P(*([None] * x.dim())), self.mesh),
            run_check=False)


@dataclasses.dataclass(frozen=True)
class _Constrain:
    """:meth:`FLShardPlan.constrain_params_fn`'s callable."""
    plan: FLShardPlan

    def __call__(self, params):
        return self.plan.place_params(params)


def make_fl_plan(mesh_cfg: Optional[MeshConfig] = None, *,
                 spec: Optional[str] = None, rule: str = "fsdp",
                 device_type: Optional[str] = None) -> FLShardPlan:
    """Build an :class:`FLShardPlan` from a :class:`MeshConfig` or a CLI
    mesh spec string (``"2x2"``; ``launch/mesh.parse_mesh_spec``).

    The process must be a rank of a process group of the mesh's size
    (``launch/mesh.spawn`` or ``launch/mesh.process_group``)."""
    from repro_torch.launch.mesh import make_mesh_from_config, parse_mesh_spec
    if (mesh_cfg is None) == (spec is None):
        raise ValueError("pass exactly one of mesh_cfg= or spec=")
    if mesh_cfg is None:
        mesh_cfg = parse_mesh_spec(spec)
    return FLShardPlan(make_mesh_from_config(mesh_cfg, device_type),
                       mesh_cfg, rule)


def compute_placements(mesh, spec: Spec, full: bool = False):
    """(mesh, placements) a leaf of ``spec`` computes with under
    tensor parallelism: by default the 1-D ``'model'`` sub-mesh of
    ``mesh``, ``Shard(d)`` where dim ``d``'s entry holds ``'model'`` and
    ``Replicate()`` otherwise (a batch-axis entry holds by construction:
    each rank keeps its own rows); with ``full`` the whole mesh
    (``rules.to_placements``), where every rank holds the same rows (the
    B=1 ``seq_shard`` decode)."""
    from torch.distributed.tensor import Replicate, Shard
    if full:
        return mesh, to_placements(spec, mesh)
    model = mesh.mesh_dim_names[-1]
    pl = [Replicate()]
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        if model in axes:
            pl = [Shard(d)]
    return mesh[model], pl


def local_shape(shape, mesh, placements) -> tuple:
    """The shape of one rank's shard of a ``shape`` tensor under
    ``placements`` on ``mesh`` (the rules shard only dims that divide)."""
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def tp_params(params, mesh, mesh_cfg: MeshConfig, full: bool = False):
    """A full parameter tree as the tensor-parallel compute layout that
    serving reads (Megatron specs without the ZeRO-3 axis,
    ``rules.param_specs(train=False)``): DTensors on the ``'model'``
    sub-mesh, or with ``full`` on the whole mesh (the B=1 ``seq_shard``
    decode, :func:`compute_placements`), each rank keeping its shard."""
    from torch.distributed.tensor import DTensor, Replicate
    leaves, treedef = tree_flatten(params)
    specs = tree_flatten(param_specs(None, params, mesh_cfg, train=False))[0]
    out = []
    for t, spec in zip(leaves, specs):
        m, pl = compute_placements(mesh, spec, full)
        whole = DTensor.from_local(t, m, [Replicate()] * m.ndim,
                                   run_check=False)
        out.append(whole.redistribute(m, pl))
    return tree_unflatten(treedef, out)
