"""Transferable sparse-mask selection (paper §2.1; ``repro.core.masks``).

MEERKAT's mask marks the top-``u`` fraction of parameters by *average squared
gradient on pre-training data* (the C4 proxy corpus here).  Baselines:
weight-magnitude, random.  The gradients come from torch autograd through
whatever attention route the model resolves (at S >= 256 the flash kernels
and their recompute backward); the global top-k runs on the parameters'
device.
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.core.gradip import grad_tree
from repro_torch.core.spaces import MaskedSpace
from repro_torch.utils.device import check_params_on, resolve_device
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten


def _n_select(total: int, density: float) -> int:
    return max(1, int(round(total * density)))


def sensitivity_scores(loss_fn: Callable, params, batches: Iterable):
    """Average squared per-parameter gradient over pre-training batches."""
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    n = 0
    for batch in batches:
        g = grad_tree(loss_fn, params, batch)
        acc = tree_map(lambda a, gg: a.add_(gg.float().square()), acc, g)
        del g
        n += 1
    return tree_map(lambda a: a.div_(max(n, 1)), acc)


# torch.topk on CUDA fails a device assert past ~2^31 elements (seen at
# Jamba's 4.9 B on an H100), so longer vectors are cut into chunks of 2^30
TOPK_CHUNK = 1 << 30


def _topk_indices(flat, k: int):
    """Indices of the k largest entries of a 1-D tensor of any length: the
    top k of each TOPK_CHUNK-long chunk, then the top k of their union
    (which holds every global winner)."""
    if flat.numel() <= TOPK_CHUNK:
        return torch.topk(flat, k, sorted=False).indices
    vals, idx = [], []
    for off in range(0, flat.numel(), TOPK_CHUNK):
        part = flat[off:off + TOPK_CHUNK]
        v, i = torch.topk(part, min(k, part.numel()), sorted=False)
        vals.append(v)
        idx.append(i + off)
    idx = torch.cat(idx)
    return idx[torch.topk(torch.cat(vals), k, sorted=False).indices]


def _global_topk_indices(score_tree, density: float):
    """Per-leaf int64 flat-index tensors of the global top-k scores, each
    sorted ascending."""
    leaves, treedef = tree_flatten(score_tree)
    sizes = [int(l.numel()) for l in leaves]
    total = sum(sizes)
    k = _n_select(total, density)
    flat = torch.cat([l.reshape(-1).float() for l in leaves])
    top = _topk_indices(flat, k)
    del flat
    top = torch.sort(top).values
    idx_leaves, off = [], 0
    for s in sizes:
        lo, hi = torch.searchsorted(
            top, torch.tensor([off, off + s], device=top.device)).tolist()
        idx_leaves.append(top[lo:hi] - off)
        off += s
    return tree_unflatten(treedef, idx_leaves)


def sensitivity_mask(loss_fn, params, pretrain_batches, density: float,
                     device=None) -> MaskedSpace:
    """MEERKAT's mask: global top-u by avg squared pre-training gradient.

    Runs on the CUDA card unless ``device`` says otherwise; ``params`` must
    already live there."""
    check_params_on(params, resolve_device(device))
    scores = sensitivity_scores(loss_fn, params, pretrain_batches)
    return MaskedSpace(_global_topk_indices(scores, density))


def magnitude_mask(params, density: float) -> MaskedSpace:
    """Weight-magnitude baseline: top-u by |w|, on the parameters' device."""
    scores = tree_map(lambda p: p.detach().float().abs(), params)
    return MaskedSpace(_global_topk_indices(scores, density))


def random_mask(params, density: float, seed: int = 0,
                balanced: bool = True) -> MaskedSpace:
    """Uniform random mask.  ``balanced`` selects round(n_i * u) coords per
    leaf (the shard-friendly layout used for the large-arch dry-runs).  The
    indices come from numpy's ``default_rng(seed)`` exactly as the JAX
    package draws them, so both packages pick the same coordinates."""
    rng = np.random.default_rng(seed)
    leaves, treedef = tree_flatten(params)
    sizes = [int(l.numel()) for l in leaves]
    if balanced:
        picks = []
        for s in sizes:
            k = max(1, int(round(s * density)))
            picks.append(np.sort(rng.choice(s, size=min(k, s),
                                            replace=False)))
    else:
        top = np.sort(rng.choice(sum(sizes), size=_n_select(sum(sizes),
                                                            density),
                                 replace=False))
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        picks = [top[(top >= offsets[i]) & (top < offsets[i + 1])]
                 - offsets[i] for i in range(len(leaves))]
    return MaskedSpace(tree_unflatten(treedef, [
        torch.as_tensor(np.asarray(i, np.int64), device=l.device)
        for i, l in zip(picks, leaves)]))


def abstract_mask(abstract_params, density: float,
                  max_coords: int = 8_388_608):
    """The index tree of a balanced mask on the meta device, for the dry
    run (``repro.core.masks.abstract_mask``): leaf i holds
    ``max(1, int(n_i * eff_density))`` int32 indices, the density clamped
    so that the coordinates stay <= ``max_coords`` (the paper validates
    densities down to 5e-5, Table 7).  Returns (idx tree, eff_density)."""
    leaves, treedef = tree_flatten(abstract_params)
    sizes = [int(np.prod(l.shape)) for l in leaves]
    eff = min(density, max_coords / sum(sizes))
    return tree_unflatten(treedef, [
        torch.empty((max(1, int(s * eff)),), dtype=torch.int32,
                    device="meta") for s in sizes]), eff


def concrete_balanced_mask_like(abstract_idx_tree, abstract_params, seed=0,
                                device="cpu"):
    """Random concrete indices of :func:`abstract_mask`'s shapes, drawn as
    the JAX package draws them (numpy ``default_rng(seed)``, sorted), as
    int64 tensors on ``device``."""
    rng = np.random.default_rng(seed)
    p_leaves = tree_flatten(abstract_params)[0]
    i_leaves, treedef = tree_flatten(abstract_idx_tree)
    out = []
    for p, i in zip(p_leaves, i_leaves):
        size = int(np.prod(p.shape))
        k = min(int(i.shape[0]), size)
        out.append(torch.as_tensor(
            np.sort(rng.choice(size, size=k, replace=False)).astype(np.int64),
            device=device))
    return tree_unflatten(treedef, out)
