"""Bridges from the JAX package's numpy-converted trees to the port's
tensors, so that both packages can be fed the same parameters and masks.

``params_from_numpy`` takes the pytree ``jax.tree.map(np.asarray, params)``
(nested dicts of numpy arrays); ``space_from_numpy`` takes a mask's
``idx_tree`` converted the same way.  Dict keys keep their names, and the
port's ``tree_leaves`` walks them sorted as ``jax.tree_util`` does, so the
flat layouts agree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.spaces import MaskedSpace
from repro_torch.utils.tree import tree_map


def params_from_numpy(tree, device="cpu"):
    """Nested dict of numpy arrays -> the port's dict of tensors."""
    return tree_map(lambda a: torch.as_tensor(np.array(a), device=device),
                    tree)


def space_from_numpy(idx_tree, device="cpu") -> MaskedSpace:
    """A JAX ``MaskedSpace.idx_tree`` (numpy int32 leaves) -> the port's
    ``MaskedSpace`` with int64 index tensors on ``device``."""
    return MaskedSpace(tree_map(
        lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device),
        idx_tree))
