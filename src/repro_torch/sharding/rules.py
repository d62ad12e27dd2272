"""Logical -> mesh sharding rules for every architecture
(``repro.sharding.rules``).

Megatron-style tensor parallelism over the 'model' axis:
  * column-parallel: QKV projections, MLP up/gate, router-free expert stacks
  * row-parallel: attention out-proj, MLP down
  * expert-parallel: MoE expert stacks sharded on the expert dim
  * vocab-parallel embeddings / LM head
Batch (= FL client) dims shard over ('pod','data'); the long_500k decode
shape (B=1) shards KV caches over the *sequence* dim instead.

A spec is a :class:`Spec`, the port's counterpart of JAX's
``PartitionSpec``: one entry per tensor dim, each ``None``, a mesh axis
name, or a tuple of axis names (the dim split over their product, the
first axis major).  The functions take trees of anything with a
``.shape`` (meta tensors for a full-size model) and give trees of specs
entry for entry equal to the JAX package's.  :func:`to_placements` maps a
spec onto a ``DeviceMesh`` as DTensor placements.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.configs.base import InputShape, MeshConfig, ModelConfig
from repro_torch.utils.tree import (tree_flatten, tree_flatten_with_keys,
                                    tree_unflatten)


class Spec:
    """Per-dim sharding of one tensor, as ``PartitionSpec`` writes it: a
    one-axis tuple entry is stored as the axis name, as JAX stores it.  It
    iterates and compares as the tuple of its entries, but is not a tuple,
    so the tree walkers (``utils/tree.py``) keep it as a leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                             else e for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        if isinstance(other, Spec):
            other = other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"Spec{self.entries!r}".replace(",)", ")")


P = Spec

# leaf name -> how to shard (see _leaf_spec)
_COL = {"wq", "wk", "wv", "bq", "bk", "bv", "w1", "w3", "sw1", "sw3",
        "in_proj", "up_proj", "w_gates", "b_gates", "dt_proj", "conv_w",
        "lora_qb", "lora_vb"}
_ROW = {"wo", "w2", "sw2", "down_proj", "out_proj"}
_EDIM1 = {"conv_b", "dt_bias", "A_log", "D"}  # mamba per-E leaves: dim after n


def _div(n: int, by: int) -> bool:
    return n % by == 0


def _name(path: str) -> str:
    return path.rsplit("'", 2)[-2] if "'" in path else path


def _leaf_spec(path: str, shape: Tuple[int, ...], tp: int):
    name = _name(path)
    nd = len(shape)
    if name == "embed":
        return P("model", None) if _div(shape[0], tp) else P(None, None)
    if name == "lm_head":
        return P(None, "model") if _div(shape[1], tp) else P(None, None)
    if name in ("w1", "w2", "w3") and nd == 4:  # MoE expert stacks [n,E,D,F]
        if _div(shape[1], tp):
            return P(None, "model", None, None)
        return P(*([None] * nd))
    if name in _COL and nd >= 2:
        if _div(shape[-1], tp):
            return P(*([None] * (nd - 1)), "model")
    if name in _ROW and nd >= 2:
        if _div(shape[-2], tp):
            return P(*([None] * (nd - 2)), "model", None)
    if name in _EDIM1 and nd >= 2:
        if _div(shape[1], tp):
            return P(None, "model", *([None] * (nd - 2)))
    return P(*([None] * nd))


_FSDP_THRESHOLD = 64 * 1024 * 1024  # bytes per (tp-sharded) leaf shard


def _add_fsdp(spec: Spec, shape: Tuple[int, ...], mesh_cfg: MeshConfig,
              itemsize: int = 2):
    """ZeRO-3-style second sharding axis: if a leaf's per-shard size still
    exceeds the threshold after tensor parallelism, also shard the largest
    free dim over the batch axes."""
    dp = mesh_cfg.data * mesh_cfg.pods
    used = {a for s in spec if s for a in ((s,) if isinstance(s, str) else s)}
    per_shard = np.prod(shape) * itemsize
    for s, dim in zip(spec, shape):
        if s is not None:
            per_shard //= mesh_cfg.model if s == "model" else 1
    if per_shard <= _FSDP_THRESHOLD or "data" in used:
        return spec
    dims = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in dims:
        if spec[i] is None and shape[i] % dp == 0 and shape[i] >= dp:
            new = list(spec)
            new[i] = mesh_cfg.batch_axes if mesh_cfg.pods > 1 else "data"
            return P(*new)
    return spec


def _map_keyed(fn, tree):
    flat, treedef = tree_flatten_with_keys(tree)
    return tree_unflatten(treedef, [fn(path, tuple(l.shape))
                                    for path, l in flat])


def param_specs(cfg: ModelConfig, abstract_params, mesh_cfg: MeshConfig,
                train: bool = True):
    """Spec tree matching the parameter tree.

    ``train=False`` (prefill/decode) skips the ZeRO-3 second axis:
    inference re-reads weights every step, so FSDP would all-gather large
    leaves per token."""
    tp = mesh_cfg.model

    def one(path, shape):
        s = _leaf_spec(path, shape, tp)
        return _add_fsdp(s, shape, mesh_cfg) if train else s

    return _map_keyed(one, abstract_params)


def fsdp_only_specs(cfg: ModelConfig, abstract_params, mesh_cfg: MeshConfig):
    """Pure-DP + FSDP sharding for the ZO step: every device is a data
    shard, and each weight leaf is sharded over all mesh axes on its
    largest dim that the device count divides (replicated where none
    does)."""
    axes = tuple(mesh_cfg.axis_names)
    n = mesh_cfg.n_devices

    def one(path, shape):
        spec = [None] * len(shape)
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if shape[i] % n == 0:
                spec[i] = axes
                break
        return P(*spec)

    return _map_keyed(one, abstract_params)


def token_spec(shape: InputShape, mesh_cfg: MeshConfig):
    ba = mesh_cfg.batch_axes
    dp = mesh_cfg.data * mesh_cfg.pods
    if shape.global_batch % dp:
        return P(None, None)
    return P(ba, None)


def batch_specs(cfg: ModelConfig, shape: InputShape, mesh_cfg: MeshConfig):
    """Specs for the input batch dict (the keys of the model's inputs)."""
    ba = mesh_cfg.batch_axes
    dp = mesh_cfg.data * mesh_cfg.pods
    bspec = ba if shape.global_batch % dp == 0 else None
    out = {}
    if shape.kind == "decode":
        out["token"] = P(bspec)
    else:
        out["tokens"] = P(bspec, None)
        if cfg.frontend == "audio_stub":
            out["audio_embeds"] = P(bspec, None, None)
        elif cfg.frontend == "vision_stub":
            out["patch_embeds"] = P(bspec, None, None)
    return out


def _cache_leaf_spec(path: str, shape: Tuple[int, ...], mesh_cfg: MeshConfig,
                     seq_shard: bool):
    """Cache leaves: [n, B, ...] stacked over periods on dim 0."""
    ba = mesh_cfg.batch_axes
    dp = mesh_cfg.data * mesh_cfg.pods
    tp = mesh_cfg.model
    name = _name(path)
    nd = len(shape)
    if name == "pos":
        return P()
    b_ok = nd >= 2 and shape[1] % dp == 0 and not seq_shard
    bspec = ba if b_ok else None
    if name in ("k", "v", "ck", "cv"):  # [n, B, W, KV, hd]
        # KV heads over 'model', then the sequence over 'model', then
        # head_dim as the last resort (a sharded contraction dim gathers
        # the whole cache per layer)
        hspec = "model" if shape[3] % tp == 0 else None
        sspec = None
        if seq_shard and shape[2] % dp == 0:
            # B=1 long-context: sequence over batch axes (+ model if free)
            if hspec is None and shape[2] % (dp * tp) == 0:
                sspec = tuple(ba) + ("model",)
            else:
                sspec = ba
        elif hspec is None and shape[2] % tp == 0:
            sspec = "model"
        dspec = ("model" if (hspec is None and sspec is None
                             and shape[4] % tp == 0) else None)
        return P(None, bspec, sspec, hspec, dspec)
    if name == "conv":      # [n, B, K-1, E]
        espec = "model" if shape[3] % tp == 0 else None
        return P(None, bspec, None, espec)
    if name == "state":     # [n, B, E, N]
        espec = "model" if shape[2] % tp == 0 else None
        return P(None, bspec, espec, None)
    if name in ("c", "n", "h", "m") and nd == 3:  # slstm [n, B, E]
        espec = "model" if shape[2] % tp == 0 else None
        return P(None, bspec, espec)
    if name in ("C",):      # mlstm [n, B, H, dh, dh]
        return P(None, bspec, *([None] * (nd - 2)))
    return P(None, bspec, *([None] * max(nd - 2, 0)))


def cache_specs(cfg: ModelConfig, abstract_cache, shape: InputShape,
                mesh_cfg: MeshConfig):
    dp = mesh_cfg.data * mesh_cfg.pods
    seq_shard = shape.global_batch % dp != 0  # B=1 long-context decode
    return _map_keyed(lambda path, s: _cache_leaf_spec(path, s, mesh_cfg,
                                                       seq_shard),
                      abstract_cache)


def mask_specs(abstract_idx_tree, mesh_cfg: MeshConfig, replicate=True):
    """Sparse-mask index arrays: replicated (each device holds the full
    coordinate list)."""
    leaves, treedef = tree_flatten(abstract_idx_tree)
    return tree_unflatten(treedef, [P(None) for _ in leaves])


def to_placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (its dims named
    ``mesh.mesh_dim_names``): ``Shard(d)`` on every mesh dim whose axis
    shards tensor dim ``d``, ``Replicate()`` on the rest.  A tuple entry
    puts ``Shard(d)`` on each of its axes' mesh dims; DTensor splits a dim
    over them in mesh-dim order, which is JAX's major-to-minor order for
    the axis orders the rules write."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                     for a in axes):
            raise ValueError(f"spec {spec!r}: axes {axes} are not in the "
                             f"mesh's order {tuple(names)}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return out
