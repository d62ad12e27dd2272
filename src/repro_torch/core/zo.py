"""Sparse zeroth-order estimator (paper Eq. 1), ``repro.core.zo`` in torch.

g = (f(w + eps*(z(.)m); B) - f(w - eps*(z(.)m); B)) / (2 eps)
grad_hat = g * (z (.) m)

z is sampled only at the masked coordinates (space semantics), which is
mathematically identical to the dense ``z (.) m`` formulation.

Every entry point dispatches between two routes (``core/dispatch.py``):

* ``backend="kernel"`` — the hot path.  Parameters live as one flat [N]
  vector; each perturb phase is one ``zo_dual_perturb_flat`` launch (one
  read of (w, z) producing both perturbed copies) and each update one
  ``zo_fused_update_flat`` launch.
* ``backend="ref"``    — the ``space.add`` tree route (reference semantics).
* ``backend=None``/"auto" picks the kernel route whenever the flat layout
  supports it and fits the device's budget.

Everything here runs under ``torch.no_grad()``: a ZO step takes no
gradients, and the attention dispatch then may route to its forward kernel.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import prng
from repro_torch.core.dispatch import get_backing, resolve_backend
from repro_torch.kernels.ops import zo_dual_perturb_flat, zo_fused_update_flat


def _dual_losses(loss_fn, backing, base_flat, z_flat, eps, batch):
    """Fused perturb + the two loss evaluations; returns (l+, l-).

    z_flat comes pre-masked (zero off the space coordinates), so the kernel
    runs without the mask operand; the perturbed trees are views of w+ and
    w-."""
    w_plus, w_minus = zo_dual_perturb_flat(base_flat, z_flat, None, eps)
    lp = loss_fn(backing.unflatten(w_plus), batch)
    del w_plus
    return lp, loss_fn(backing.unflatten(w_minus), batch)


def _multi_dir_update(loss_fn, backing, space, base_flat, key, eps: float,
                      n_dirs: int, batch):
    """K-direction fused estimator at ``base_flat``: splits the step key
    into K direction keys (matching ``reconstruct_delta``'s [T, K] replay)
    and returns (mean_k g_k * z_k as a dense flat vector, gs [K])."""
    acc = torch.zeros(backing.n_pad, dtype=torch.float32,
                      device=backing.device)
    gs = []
    for k in prng.split(key, n_dirs):
        z_flat = backing.expand(space.sample_z(k))
        lp, lm = _dual_losses(loss_fn, backing, base_flat, z_flat, eps, batch)
        g = (lp - lm) / (2.0 * eps)
        acc = acc + g * z_flat
        gs.append(g)
    return acc / n_dirs, torch.stack(gs)


@torch.no_grad()
def projected_gradient(loss_fn: Callable, params, space, delta, z, eps: float,
                       batch, backend: Optional[str] = None):
    """Scalar projected gradient g at (params + delta) along z."""
    backing = get_backing(space, params)
    if resolve_backend(backend, backing) == "ref":
        lp = loss_fn(space.add(params, delta + eps * z), batch)
        lm = loss_fn(space.add(params, delta - eps * z), batch)
        return (lp - lm) / (2.0 * eps)
    base = backing.flatten(params) + backing.expand(delta)
    lp, lm = _dual_losses(loss_fn, backing, base, backing.expand(z), eps,
                          batch)
    return (lp - lm) / (2.0 * eps)


@torch.no_grad()
def local_step(loss_fn: Callable, params, space, delta, key, eps: float,
               lr: float, batch, n_dirs: int = 1,
               backend: Optional[str] = None):
    """One client-side ZO step on the sparse delta. Returns (delta', g).

    ``n_dirs > 1`` (beyond-paper) averages the estimator over K directions
    per step, whose keys derive from the step key."""
    backing = get_backing(space, params)
    if resolve_backend(backend, backing) == "ref":
        return _local_step_ref(loss_fn, params, space, delta, key, eps, lr,
                               batch, n_dirs)
    base = backing.flatten(params) + backing.expand(delta)
    if n_dirs == 1:
        z = space.sample_z(key)
        lp, lm = _dual_losses(loss_fn, backing, base, backing.expand(z), eps,
                              batch)
        g = (lp - lm) / (2.0 * eps)
        return delta - lr * g * z, g
    upd, gs = _multi_dir_update(loss_fn, backing, space, base, key, eps,
                                n_dirs, batch)
    return delta - lr * backing.restrict(upd), gs


def _local_step_ref(loss_fn, params, space, delta, key, eps, lr, batch,
                    n_dirs):
    if n_dirs == 1:
        z = space.sample_z(key)
        g = projected_gradient(loss_fn, params, space, delta, z, eps, batch,
                               backend="ref")
        return delta - lr * g * z, g
    gz, gs = [], []
    for k in prng.split(key, n_dirs):
        z = space.sample_z(k)
        g = projected_gradient(loss_fn, params, space, delta, z, eps, batch,
                               backend="ref")
        gz.append(g * z)
        gs.append(g)
    return delta - lr * torch.stack(gz).mean(0), torch.stack(gs)


def make_local_run(loss_fn: Callable, space, eps: float, lr: float,
                   n_dirs: int = 1, backend: Optional[str] = None):
    """T-step client loop.

    ``run(params, keys [T, 2], batches, delta0)``: ``batches`` is a dict of
    arrays with a leading [T, ...] axis.  Returns (delta_T [n], gs [T])
    (gs: [T, K] when n_dirs > 1).

    On the kernel route the flat parameter vector is built once and the loop
    carries the *dense* flat delta, so every local step is one fused
    dual-perturb launch plus one fused update launch over the flat vector,
    with no per-step tree scatter."""

    @torch.no_grad()
    def run(params, keys, batches, delta0):
        T = int(keys.shape[0])
        step_batches = [{k: v[t] for k, v in batches.items()}
                        for t in range(T)]
        backing = get_backing(space, params)
        if resolve_backend(backend, backing) == "ref":
            delta, gs = delta0, []
            for key, batch in zip(keys, step_batches):
                delta, g = _local_step_ref(loss_fn, params, space, delta,
                                           key, eps, lr, batch, n_dirs)
                gs.append(g)
            return delta, torch.stack(gs)

        w_flat = backing.flatten(params)
        # dense z buffer carried across steps: the coordinate set is static,
        # so each step refreshes the sparse values in place (scatter_into)
        z_buf = torch.zeros(backing.n_pad, dtype=torch.float32,
                            device=backing.device)
        delta_dense = backing.expand(delta0)
        gs = []
        for key, batch in zip(keys, step_batches):
            base = w_flat + delta_dense
            if n_dirs == 1:
                z_flat = backing.scatter_into(z_buf, space.sample_z(key))
                lp, lm = _dual_losses(loss_fn, backing, base, z_flat, eps,
                                      batch)
                del base
                g = (lp - lm) / (2.0 * eps)
                delta_dense = zo_fused_update_flat(delta_dense, z_flat, None,
                                                   -lr * g)
            else:
                upd, g = _multi_dir_update(loss_fn, backing, space, base,
                                           key, eps, n_dirs, batch)
                del base
                delta_dense = zo_fused_update_flat(delta_dense, upd, None,
                                                   -lr)
            gs.append(g)
        return backing.restrict(delta_dense), torch.stack(gs)

    return run
