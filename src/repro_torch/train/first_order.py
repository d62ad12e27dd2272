"""First-order (backprop) training (``repro.train.first_order``): the FedAvg
/ data-parallel baseline MEERKAT is compared against.  The sensitivity mask
and the server's pre-training gradient take the same autograd path
(``core/masks.py``, ``core/gradip.py``).

Gradients come from torch autograd through whatever attention route the
model resolves: at S >= 256 the flash kernels, whose recompute backward
keeps only O(S*dh) per layer (``kernels.ops.FlashAttentionFn``).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core.gradip import grad_tree, value_and_grad_tree
from repro_torch.optim import make_optimizer
from repro_torch.utils.device import check_params_on, resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map


def make_train_step(loss_fn: Callable, optimizer: str = "sgd",
                    lr: float = 1e-3, device=None, **kw):
    """Returns (init, step): ``init(params)`` is the optimizer state and
    ``step(params, opt_state, batch)`` returns (params, opt_state, loss).

    Runs on the CUDA card unless ``device`` says otherwise; ``params`` must
    already live there.  ``kw`` goes to the optimizer."""
    device = resolve_device(device)
    init, update = make_optimizer(optimizer, lr, **kw)

    def step(params, opt_state, batch):
        check_params_on(params, device)
        loss, grads = value_and_grad_tree(loss_fn, params, batch)
        upd, opt_state = update(grads, opt_state, params)
        del grads
        params = tree_map(lambda p, u: p + u.to(p.dtype), params, upd)
        return params, opt_state, loss

    return init, step


def fedavg_round(loss_fn: Callable, params, client_batches, lr: float,
                 local_steps: int = 1, device=None):
    """One FedAvg round (first-order baseline): each client runs SGD
    locally, the server averages the resulting models.

    ``client_batches``: a dict of arrays (numpy or tensors) with leading
    [K, T, b, ...]; each client takes its T batches in order, and
    ``local_steps`` must equal T (the JAX package reads T from the batches
    alone).  Where the JAX package ``vmap``s the K clients and takes the
    mean of K models, the port runs them one after another and keeps a
    running f32 sum, so memory is O(params) rather than O(K * params); the
    sum is taken in client order, so the average can differ from the JAX
    one by f32 rounding.  Runs on the CUDA card unless ``device`` says
    otherwise; ``params`` must already live there."""
    check_params_on(params, resolve_device(device))
    K, T = next(iter(client_batches.values())).shape[:2]
    if T != local_steps:
        raise ValueError(f"client_batches hold T={T} steps per client, "
                         f"local_steps={local_steps}")
    total = None
    for c in range(K):
        p = params
        for t in range(T):
            batch = {k: v[c, t] for k, v in client_batches.items()}
            g = grad_tree(loss_fn, p, batch)
            p = tree_map(lambda w, gg: w - lr * gg.to(w.dtype), p, g)
            del g
        if total is None:
            total = tree_map(lambda w: w.float().clone(), p)
        else:
            for a, w in zip(tree_leaves(total), tree_leaves(p)):
                a.add_(w.float())  # in place: one running sum
        del p
    return tree_map(lambda a, w: (a / K).to(w.dtype), total, params)
