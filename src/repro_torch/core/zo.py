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

Parameters that are DTensors (the tensor-parallel compute view,
``sharding/fl.py``) run :func:`make_local_run` on each rank's local shards,
with no collective beyond the forwards' own: the kernel route launches the
same kernels over a flat vector of the shards
(``core/dispatch.ShardedBacking``) and carries the [n] delta, the ``ref``
route sets the shards' coordinates in place (``core/spaces.ShardedMask``)
and restores them after each step.

Everything here runs under ``torch.no_grad()``: a ZO step takes no
gradients, and the attention dispatch then may route to its forward kernel.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import prng
from repro_torch.core.dispatch import get_backing, resolve_backend
from repro_torch.core.spaces import has_dtensors, sharded
from repro_torch.kernels.ops import zo_dual_perturb_flat, zo_fused_update_flat


def _maybe_quantize(g, key, quantize):
    """Exact-replay quantization hook (``core/quantize.py``): the client
    rounds each projected-gradient scalar to the wire grid *before*
    applying it, so the value it uploads (and the server decodes) is bit
    for bit the value its local trajectory used.  The rounding key is the
    step or direction key folded with ``QUANT_FOLD``, derivable from the
    seed ladder.  The same on both routes."""
    if quantize is None:
        return g
    return quantize.apply(g, key)


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
                      n_dirs: int, batch, quantize=None, dense=True):
    """K-direction fused estimator at ``base_flat``: splits the step key
    into K direction keys (matching ``reconstruct_delta``'s [T, K] replay)
    and returns (mean_k g_k * z_k as a dense flat vector, or with ``dense``
    off as the [n] vector, gs [K])."""
    acc = torch.zeros(backing.n_pad if dense else space.n,
                      dtype=torch.float32, device=backing.device)
    gs = []
    for k in prng.split(key, n_dirs):
        z = space.sample_z(k)
        z_flat = backing.expand(z)
        lp, lm = _dual_losses(loss_fn, backing, base_flat, z_flat, eps, batch)
        g = _maybe_quantize((lp - lm) / (2.0 * eps), k, quantize)
        acc = acc + g * (z_flat if dense else z)
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
               backend: Optional[str] = None, quantize=None):
    """One client-side ZO step on the sparse delta. Returns (delta', g).

    ``n_dirs > 1`` (beyond-paper) averages the estimator over K directions
    per step, whose keys derive from the step key.  ``quantize`` (a
    :class:`repro_torch.core.quantize.QuantSpec`) rounds each g to the
    uplink wire grid before the update (exact-replay mode)."""
    backing = get_backing(space, params)
    if resolve_backend(backend, backing) == "ref":
        return _local_step_ref(loss_fn, params, space, delta, key, eps, lr,
                               batch, n_dirs, quantize)
    base = backing.flatten(params) + backing.expand(delta)
    if n_dirs == 1:
        z = space.sample_z(key)
        lp, lm = _dual_losses(loss_fn, backing, base, backing.expand(z), eps,
                              batch)
        g = _maybe_quantize((lp - lm) / (2.0 * eps), key, quantize)
        return delta - lr * g * z, g
    upd, gs = _multi_dir_update(loss_fn, backing, space, base, key, eps,
                                n_dirs, batch, quantize)
    return delta - lr * backing.restrict(upd), gs


def _local_step_ref(loss_fn, params, space, delta, key, eps, lr, batch,
                    n_dirs, quantize=None):
    if n_dirs == 1:
        z = space.sample_z(key)
        g = projected_gradient(loss_fn, params, space, delta, z, eps, batch,
                               backend="ref")
        g = _maybe_quantize(g, key, quantize)
        return delta - lr * g * z, g
    gz, gs = [], []
    for k in prng.split(key, n_dirs):
        z = space.sample_z(k)
        g = projected_gradient(loss_fn, params, space, delta, z, eps, batch,
                               backend="ref")
        g = _maybe_quantize(g, k, quantize)
        gz.append(g * z)
        gs.append(g)
    return delta - lr * torch.stack(gz).mean(0), torch.stack(gs)


def make_local_run(loss_fn: Callable, space, eps: float, lr: float,
                   n_dirs: int = 1, backend: Optional[str] = None,
                   quantize=None):
    """T-step client loop.

    ``run(params, keys [T, 2], batches, delta0)``: ``batches`` is a dict of
    arrays with a leading [T, ...] axis.  Returns (delta_T [n], gs [T])
    (gs: [T, K] when n_dirs > 1).  ``quantize`` (a
    :class:`repro_torch.core.quantize.QuantSpec`) turns on exact-replay
    uplink quantization: each step's g (each direction's, when n_dirs > 1)
    is rounded to the wire grid before it is applied and returned.

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
        route = resolve_backend(backend, backing)
        if route == "ref" and has_dtensors(params):
            return _run_sharded(loss_fn, params, space, keys, step_batches,
                                delta0, eps, lr, n_dirs, quantize)
        if route == "ref":
            delta, gs = delta0, []
            for key, batch in zip(keys, step_batches):
                delta, g = _local_step_ref(loss_fn, params, space, delta,
                                           key, eps, lr, batch, n_dirs,
                                           quantize)
                gs.append(g)
            return delta, torch.stack(gs)

        w_flat = backing.flatten(params)
        # dense z buffer carried across steps: the coordinate set is static,
        # so each step refreshes the sparse values in place (scatter_into)
        z_buf = torch.zeros(backing.n_pad, dtype=torch.float32,
                            device=backing.device)
        # the delta is carried dense, or on a rank's shards (which hold only
        # that rank's coordinates) as the [n] vector, updated by the same
        # kernel element for element
        dense = not has_dtensors(params)
        delta = backing.expand(delta0) if dense else delta0
        gs = []
        for key, batch in zip(keys, step_batches):
            base = w_flat + (delta if dense else backing.expand(delta))
            if n_dirs == 1:
                z = space.sample_z(key)
                z_flat = backing.scatter_into(z_buf, z)
                lp, lm = _dual_losses(loss_fn, backing, base, z_flat, eps,
                                      batch)
                del base
                g = _maybe_quantize((lp - lm) / (2.0 * eps), key, quantize)
                delta = zo_fused_update_flat(delta, z_flat if dense else z,
                                             None, -lr * g)
            else:
                upd, g = _multi_dir_update(loss_fn, backing, space, base,
                                           key, eps, n_dirs, batch, quantize,
                                           dense)
                del base
                delta = zo_fused_update_flat(delta, upd, None, -lr)
            gs.append(g)
        return (backing.restrict(delta) if dense else delta), torch.stack(gs)

    return run


def _run_sharded(loss_fn, params, space, keys, step_batches, delta, eps, lr,
                 n_dirs, quantize):
    """:func:`make_local_run`'s T steps on DTensor parameters by the ref
    route: each forward sets this rank's coordinates to ``base + (delta +-
    eps z)`` in place (``space.add``'s value, element for element) and the
    step restores them, so ``params`` leave as they came."""
    sm = sharded(space, params)
    base = sm.values(params)
    gs = []
    try:
        for key, batch in zip(keys, step_batches):
            gz, gk = [], []
            for k in ([key] if n_dirs == 1 else prng.split(key, n_dirs)):
                z = space.sample_z(k)
                lp = loss_fn(sm.set_(params, base, delta + eps * z), batch)
                lm = loss_fn(sm.set_(params, base, delta - eps * z), batch)
                g = _maybe_quantize((lp - lm) / (2.0 * eps), k, quantize)
                gz.append(z)
                gk.append(g)
            if n_dirs == 1:     # _local_step_ref's association
                delta = delta - lr * gk[0] * gz[0]
                gs.append(gk[0])
            else:
                gz = [g * z for g, z in zip(gk, gz)]
                delta = delta - lr * torch.stack(gz).mean(0)
                gs.append(torch.stack(gk))
    finally:
        sm.set_(params, base)
    return delta, torch.stack(gs)
