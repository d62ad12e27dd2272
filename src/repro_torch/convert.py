"""Bridges from the JAX package's numpy-converted trees to the port's
tensors, so that both packages can be fed the same parameters, caches and
masks.

``params_from_numpy`` takes the pytree ``jax.tree.map(np.asarray, params)``
(nested dicts of numpy arrays); ``cache_from_numpy`` a serving cache and
``space_from_numpy`` a mask's ``idx_tree``, converted the same way.  Each
lands on ``device``: the CUDA card unless the caller says otherwise
(``utils.device.resolve_device``; the tests pass ``"cpu"``).  Dict
keys keep their names, and the port's ``tree_leaves`` walks them sorted as
``jax.tree_util`` does, so the flat layouts agree.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.spaces import MaskedSpace
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


def params_from_numpy(tree, device=None):
    """Nested dict of numpy arrays -> the port's dict of tensors."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.as_tensor(np.array(a), device=device),
                    tree)


def cache_from_numpy(cache, device=None):
    """A JAX serving cache converted by ``jax.tree.map(np.asarray, cache)``
    -> the port's cache of tensors on ``device``, so both packages can
    decode from one cache.  Every family has one layout in both packages
    (``models/decode.py``): ``{"stack": {"p{i}": leaves}, "pos": [B]}``
    with the leaves of layer ``i``'s mixer, each stacked over periods:
    ``k``, ``v`` [n,B,W,KV,hd] (attention; Whisper's decoder layers also
    ``ck``, ``cv`` [n,B,Senc,KV,hd]); ``conv`` [n,B,K-1,E] and ``state``
    [n,B,E,N] (Mamba); ``C`` [n,B,H,dh,dh], ``n`` [n,B,H,dh] and ``m``
    [n,B,H] (mLSTM); ``c``, ``n``, ``h``, ``m`` [n,B,E] (sLSTM)."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.as_tensor(np.array(a), device=device),
                    cache)


def space_from_numpy(idx_tree, device=None) -> MaskedSpace:
    """A JAX ``MaskedSpace.idx_tree`` (numpy int32 leaves) -> the port's
    ``MaskedSpace`` with int64 index tensors on ``device``."""
    device = resolve_device(device)
    return MaskedSpace(tree_map(
        lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device),
        idx_tree))
