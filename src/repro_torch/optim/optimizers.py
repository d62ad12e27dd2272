"""Minimal optimizer library over parameter trees (``repro.optim``).

Plain functions on tensors, not ``torch.optim``: each update follows the
JAX package's arithmetic order (Adam's step is
``-lr * (m / bc1) / (sqrt(v / bc2) + eps)`` with f32 bias corrections), so
the two packages take the same steps to an f32 rounding.  Updates are
returned, not applied, and the state is rebuilt each step, as in JAX.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32, on the parameters' device
    mu: Any = None
    nu: Any = None


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def sgd(lr: float, momentum: float = 0.0):
    def init(params):
        return OptState(_step0(params),
                        mu=_zeros_f32(params) if momentum else None)

    def update(grads, state, params=None):
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.float(), state.mu,
                          grads)
            return tree_map(lambda m: -lr * m, mu), \
                OptState(state.step + 1, mu=mu)
        return tree_map(lambda g: -lr * g, grads), OptState(state.step + 1)

    return init, update


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    def init(params):
        return OptState(_step0(params), mu=_zeros_f32(params),
                        nu=_zeros_f32(params))

    def update(grads, state, params=None):
        t = state.step + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu,
                      grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                      state.nu, grads)
        bc1 = 1 - b1 ** t.float()
        bc2 = 1 - b2 ** t.float()
        upd = tree_map(lambda m, v: -lr * (m / bc1) / (torch.sqrt(v / bc2)
                                                        + eps), mu, nu)
        return upd, OptState(t, mu=mu, nu=nu)

    return init, update


def zo_sgd(lr: float, momentum: float = 0.0):
    """ZO-SGD over a flat sparse value vector (MEERKAT client optimizer)."""
    def init(n: int, device=None):
        """State for an [n] vector, on the CUDA card unless ``device``
        says otherwise."""
        device = resolve_device(device)
        mu = (torch.zeros((n,), dtype=torch.float32, device=device)
              if momentum else None)
        return OptState(torch.zeros((), dtype=torch.int32, device=device),
                        mu=mu)

    def update(gz, state, _=None):
        """gz = g * z (the reconstructed sparse ZO gradient)."""
        if momentum:
            mu = momentum * state.mu + gz
            return -lr * mu, OptState(state.step + 1, mu=mu)
        return -lr * gz, OptState(state.step + 1)

    return init, update


def make_optimizer(name: str, lr: float, **kw):
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "adam":
        return adam(lr, **kw)
    raise ValueError(name)
