"""Transferable sparse-mask selection (paper §2.1; ``repro.core.masks``).

MEERKAT's mask marks the top-``u`` fraction of parameters by *average squared
gradient on pre-training data* (the C4 proxy corpus here).  The gradients
come from torch autograd through the model's dense attention route; the
global top-k runs on the parameters' device.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch

from repro_torch.core.gradip import grad_tree
from repro_torch.core.spaces import MaskedSpace
from repro_torch.utils.device import resolve_device
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


def _global_topk_indices(score_tree, density: float):
    """Per-leaf int64 flat-index tensors of the global top-k scores, each
    sorted ascending."""
    leaves, treedef = tree_flatten(score_tree)
    sizes = [int(l.numel()) for l in leaves]
    total = sum(sizes)
    k = _n_select(total, density)
    flat = torch.cat([l.reshape(-1).float() for l in leaves])
    top = torch.topk(flat, k, sorted=False).indices
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
    device = resolve_device(device)
    for p in tree_flatten(params)[0]:
        if p.device.type != device.type:
            raise ValueError(f"params live on {p.device}, not {device}")
    scores = sensitivity_scores(loss_fn, params, pretrain_batches)
    return MaskedSpace(_global_topk_indices(scores, density))
