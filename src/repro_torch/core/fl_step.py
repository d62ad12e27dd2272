"""Federated-ZO train steps (``repro.core.fl_step``) in torch.

With the shared per-step seeds of Alg. 2/3 every client perturbs with the
*same* z, so the high-frequency (T=1) MEERKAT step is exactly:

    z  = N(0, I_n)                       (n = sparse coords, same everywhere)
    f+ = per-client loss at w + eps*z
    f- = per-client loss at w - eps*z
    g_k = (f+_k - f-_k) / 2 eps          (K scalars)
    w' = w - lr * mean_k(g_k) * z        (one sparse update)

Every factory dispatches between the flat kernel route and the tree route
(``core/dispatch.py``).  On the flat route the perturb phase is one
``zo_dual_perturb_flat`` launch producing both perturbed copies and the
weight update one ``zo_fused_update_flat`` launch.

``quantize`` (a :class:`repro_torch.core.quantize.QuantSpec`) rounds the
per-client scalars to the uplink wire grid under each step's key before
the masked mean, as the JAX package does.

``constrain_params`` (``FLShardPlan.constrain_params_fn()``) is the mesh
route: each rank gathers the parameters once a call, computes the
per-example losses of its block of the clients' rows, and the blocks are
``all_gather``-ed in client order, so every rank forms the same scalars
and applies the same update, then re-places the parameters.  The routes
and kernels are the unsharded ones (ROADMAP C20).  JAX sums the scalars
with a mesh-ordered ``psum``; the port keeps the client order (ROADMAP
C21), and row-split forwards may differ from the whole batch's in the
last bits, so the route is held to the JAX tool's tolerance.

Under ``rule="tp"`` the compute view's leaves are DTensors (Megatron
shards on the model sub-mesh): each step perturbs, and then updates, this
rank's local shards with no collective beyond the forwards' own: the
flat route runs its kernels on a flat vector of the rank's shards
(``core/dispatch.ShardedBacking``), the ``ref`` route adds at the mask
coordinates in place (``core/spaces.ShardedMask``; the placed parameters
are updated in place, as JAX donates them).  The batch rows split over the
batch axes only.

The train loop's flat route may stack the (w+, w-) pair, as the JAX
package does (``stack_forwards``; None picks it up to
:data:`STACK_FORWARDS_MAX_PARAMS` flat parameters): ``zo_dual_perturb_flat``
writes both rows of one [2, n_pad] buffer and ``torch.func.vmap`` runs the
per-example loss over them, one forward of twice the batch.  The kernels a
forward reaches fold the pair into their batch (``kernels/ops.py``'s vmap
rules): one flash-attention launch per attention layer for the pair, not
two.  Under a mesh plan only the loss is vmapped and the stacked losses are
gathered once; under ``rule="tp"`` (DTensor leaves) stacking raises
``ValueError`` (ROADMAP C9).

Everything runs under ``torch.no_grad()`` and eagerly: ``n_steps`` is a
Python loop in place of ``jax.lax.scan``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import prng
from repro_torch.core.dispatch import (ShardedBacking, get_backing,
                                       resolve_backend)
from repro_torch.core.spaces import has_dtensors, sharded
from repro_torch.kernels.ops import zo_dual_perturb_flat, zo_fused_update_flat


# Below this many backed parameters the JAX package's measurements found
# the per-step cost dominated by op dispatch, and the stacked (w+, w-)
# forward, which halves the dispatches, the faster; the same rule picks the
# route here (PERF.md has the port's times of both routes on an H100).
STACK_FORWARDS_MAX_PARAMS = 1 << 20


def stacks_forwards(stack_forwards: Optional[bool], backing) -> bool:
    """Whether the flat route stacks the pair: ``stack_forwards`` where it
    is given, else whether ``backing.n_flat`` is at most
    :data:`STACK_FORWARDS_MAX_PARAMS` (the JAX package's pick)."""
    if stack_forwards is None:
        return backing.n_flat <= STACK_FORWARDS_MAX_PARAMS
    return bool(stack_forwards)


def _masked_mean(g_clients, report_mask):
    """Survivor/cohort mean of the per-client scalars: ``None`` (and an
    all-ones mask) is the plain mean; a 0/1 mask excludes clients as a
    runtime operand, so every fault pattern runs the same code."""
    if report_mask is None:
        return g_clients.mean()
    m = report_mask.to(g_clients.dtype)
    return (g_clients * m).sum() / torch.clamp(m.sum(), min=1.0)


def _g_clients(l_plus, l_minus, n_clients: int, eps: float):
    return (l_plus - l_minus).reshape(n_clients, -1).mean(-1) / (2.0 * eps)


def _mesh_plan(constrain_params):
    """The plan of the mesh route (None without one)."""
    if constrain_params is None:
        return None
    plan = getattr(constrain_params, "plan", None)
    if plan is None:
        raise TypeError("constrain_params is the callable that "
                        "FLShardPlan.constrain_params_fn() returns")
    return plan


def _rank_rows(plan, n_clients: int):
    """``batch -> batch``: this rank's block of the clients' rows (dim 0 of
    every leaf, K clients' rows in order); the identity without a plan."""
    if plan is None:
        return lambda batch: batch
    blk = plan.client_block(n_clients)

    def rows(batch):
        b = next(iter(batch.values())).shape[0] // n_clients
        return {k: v[blk.start * b:blk.stop * b] for k, v in batch.items()}

    return rows


def pair_losses(per_example_loss: Callable, backing, w_flat, z_flat, batch,
                eps: float, *, stack: bool, gather=None):
    """(l+, l-): the per-example losses at w +- eps z on the flat route,
    from one ``zo_dual_perturb_flat``.  ``stack`` writes the pair into the
    rows of one [2, n_pad] buffer and runs ``per_example_loss`` once under
    ``torch.func.vmap`` over its leading axis (the kernels fold the pair
    into their batch); otherwise the two forwards run in sequence, each
    perturbed vector freed after its own.  ``gather`` (the mesh route's)
    takes each rank's losses to the group's, once, outside vmap."""
    if not stack:
        wp, wm = zo_dual_perturb_flat(w_flat, z_flat, None, eps)
        l_plus = per_example_loss(backing.unflatten(wp), batch)
        del wp
        l_minus = per_example_loss(backing.unflatten(wm), batch)
        del wm
        if gather is not None:
            l_plus, l_minus = gather(l_plus), gather(l_minus)
        return l_plus, l_minus
    if isinstance(backing, ShardedBacking):
        raise ValueError("stack_forwards: the tensor-parallel route "
                         "(rule='tp', DTensor parameters) cannot run its "
                         "forward under torch.func.vmap; pass "
                         "stack_forwards=False (ROADMAP C9)")
    pair = torch.empty((2, backing.n_pad), dtype=w_flat.dtype,
                       device=w_flat.device)
    zo_dual_perturb_flat(w_flat, z_flat, None, eps, out=pair)
    both = torch.func.vmap(per_example_loss, in_dims=(0, None))(
        backing.unflatten(pair), batch)                      # [2, rows]
    del pair
    if gather is not None:
        both = gather(both.T.contiguous()).T
    return both[0], both[1]


def _step_bodies(per_example_loss: Callable, space, eps: float, lr: float,
                 n_clients: int, quantize=None, plan=None):
    """The T=1 step on each route, shared by the step and the loop:
    ``ref(p, z, batch, mask, key)`` over the parameter tree (on DTensor
    parameters, in place on the shards) and ``flat(backing, w_flat, z_flat,
    batch, mask, key, stack=False)`` over the flat vector (of the rank's
    shards, on a ``ShardedBacking``; ``stack``: :func:`pair_losses`); each
    returns (the new params or flat vector, g_clients [K], g, loss).
    ``key`` is the step's, for the quantizer's rounding draw.  Under a
    ``plan`` the batch holds the rank's rows, and the per-example losses of
    every rank's rows are gathered before the scalars."""
    per_example, gather = per_example_loss, None
    if plan is not None:
        def gather(losses):
            return plan.gather_clients(losses, n_clients)

        def per_example(p, batch):
            return gather(per_example_loss(p, batch))

    def finish(l_plus, l_minus, mask, key):
        g_clients = _g_clients(l_plus, l_minus, n_clients, eps)
        if quantize is not None:
            g_clients = quantize.apply(g_clients, key)
        return (g_clients, _masked_mean(g_clients, mask),
                (l_plus + l_minus).mean() / 2.0)

    def tp(p, z, batch, mask, key):
        """``ref`` on the DTensor shards, in place (module docstring)."""
        sm = sharded(space, p)
        l_plus = per_example(sm.add_(p, eps * z), batch)
        l_minus = per_example(sm.add_(p, (-2.0 * eps) * z), batch)
        g_clients, g, loss = finish(l_plus, l_minus, mask, key)
        return sm.add_(p, (eps - lr * g) * z), g_clients, g, loss

    def ref(p, z, batch, mask, key):
        if has_dtensors(p):
            return tp(p, z, batch, mask, key)
        w_plus = space.add(p, eps * z)
        l_plus = per_example(w_plus, batch)
        w_minus = space.add(w_plus, (-2.0 * eps) * z)
        del w_plus
        l_minus = per_example(w_minus, batch)
        g_clients, g, loss = finish(l_plus, l_minus, mask, key)
        return space.add(w_minus, (eps - lr * g) * z), g_clients, g, loss

    def flat(backing, w_flat, z_flat, batch, mask, key, stack=False):
        l_plus, l_minus = pair_losses(per_example_loss, backing, w_flat,
                                      z_flat, batch, eps, stack=stack,
                                      gather=gather)
        g_clients, g, loss = finish(l_plus, l_minus, mask, key)
        return (zo_fused_update_flat(w_flat, z_flat, None, -lr * g),
                g_clients, g, loss)

    return ref, flat


def make_fl_train_step(per_example_loss: Callable, space, *, eps: float,
                       lr: float, n_clients: int, constrain_params=None,
                       backend: Optional[str] = None, quantize=None):
    """T=1 high-frequency MEERKAT step (Alg. 3).  Returns
    ``step(params, key, batch, report_mask=None) -> (params', g_clients [K],
    metrics)``; ``per_example_loss(params, batch)`` gives the [B] losses of
    a batch whose rows are the K clients' in order.  ``report_mask`` ([K]
    0/1) leaves the clients whose upload was lost out of the mean;
    ``quantize`` rounds the K scalars to the wire grid first.
    ``constrain_params`` is the mesh route (module docstring): ``params``
    rest on the plan's mesh, and so do ``params'``."""
    plan = _mesh_plan(constrain_params)
    ref, flat = _step_bodies(per_example_loss, space, eps, lr, n_clients,
                             quantize, plan)
    rows = _rank_rows(plan, n_clients)

    @torch.no_grad()
    def step(params, key, batch, report_mask=None):
        if plan is not None:
            params = plan.compute_view(params)
        batch = rows(batch)
        z = space.sample_z(key)
        backing = get_backing(space, params)
        if resolve_backend(backend, backing) == "ref":
            new_params, g_clients, g, loss = ref(params, z, batch,
                                                 report_mask, key)
        else:
            w_flat, g_clients, g, loss = flat(
                backing, backing.flatten(params), backing.expand(z), batch,
                report_mask, key)
            new_params = backing.unflatten(w_flat)
        if plan is not None:
            new_params = constrain_params(new_params)
        return new_params, g_clients, {"loss": loss, "g": g}

    return step


def make_fl_train_loop(per_example_loss: Callable, space, *, eps: float,
                       lr: float, n_clients: int, n_steps: int,
                       backend: Optional[str] = None,
                       stack_forwards: Optional[bool] = None,
                       constrain_params=None, quantize=None):
    """``n_steps`` T=1 MEERKAT steps in one call, the training burst.

    Returns ``loop(params, key, batches, report_masks=None) -> (params',
    g_clients [n_steps, K], metrics)``; ``batches`` carries a leading
    [n_steps, ...] axis and ``report_masks`` is [n_steps, K].  Step i runs
    :func:`make_fl_train_step`'s body under ``prng.split(key, n_steps)[i]``,
    so the loop equals that step folded over the batches bit for bit.

    On the flat route the flat parameter vector is built once before the
    loop and carried across it, as is one dense z buffer whose sparse
    coordinates each step overwrites in place: each step is one
    ``zo_dual_perturb_flat``, the two forwards and one
    ``zo_fused_update_flat``.  ``stack_forwards`` picks how the flat route
    runs the forwards, as in the JAX package: True stacks w+ and w- into
    one [2, n_pad] buffer and runs one vmapped forward of twice the batch
    (each kernel of the forward launched once for the pair), False runs
    the two in sequence, each perturbed vector freed after its forward;
    None stacks up to :data:`STACK_FORWARDS_MAX_PARAMS` flat parameters
    (:func:`stacks_forwards`).  The ``ref`` route never stacks.  Stacking
    raises ``ValueError`` on tensor-parallel (DTensor) parameters.
    ``quantize`` and ``constrain_params`` mirror :func:`make_fl_train_step`,
    ``quantize`` under each step's key; the mesh route gathers the
    parameters once a burst."""
    plan = _mesh_plan(constrain_params)
    ref, flat = _step_bodies(per_example_loss, space, eps, lr, n_clients,
                             quantize, plan)
    rows = _rank_rows(plan, n_clients)

    @torch.no_grad()
    def loop(params, key, batches, report_masks=None):
        if plan is not None:
            params = plan.compute_view(params)  # once a burst
        keys = prng.split(key, n_steps)
        masks = ([None] * n_steps if report_masks is None
                 else list(report_masks))
        steps = [(rows({k: v[i] for k, v in batches.items()}), keys[i],
                  masks[i]) for i in range(n_steps)]
        gs, losses = [], []
        backing = get_backing(space, params)
        if resolve_backend(backend, backing) == "ref":
            p = params
            for b, k, mask in steps:
                p, g_cl, _, loss = ref(p, space.sample_z(k), b, mask, k)
                gs.append(g_cl)
                losses.append(loss)
        else:
            w_flat = backing.flatten(params)  # once per burst, not per step
            z_buf = torch.zeros(backing.n_pad, dtype=torch.float32,
                                device=backing.device)
            stack = stacks_forwards(stack_forwards, backing)
            for b, k, mask in steps:
                z_flat = backing.scatter_into(z_buf, space.sample_z(k))
                w_flat, g_cl, _, loss = flat(backing, w_flat, z_flat, b, mask,
                                             k, stack)
                gs.append(g_cl)
                losses.append(loss)
            p = backing.unflatten(w_flat)
        if plan is not None:
            p = constrain_params(p)
        gs = torch.stack(gs)
        return p, gs, {"loss": losses[-1], "g": gs[-1].mean()}

    return loop


def make_fl_round_step(loss_fn: Callable, space, *, eps: float, lr: float,
                       T: int, backend: Optional[str] = None):
    """Full MEERKAT round with T > 1 local steps per client.

    ``round_step(params, keys [T, 2], batches) -> (params', gs [K, T])``;
    ``batches`` has a leading [K, T, b, ...] axis and the keys are shared
    by the clients (Alg. 2).  The clients run one after another (the JAX
    package vmaps them); their deltas are averaged and added once.

    Flat route: the parameter vector is flattened once per round, and each
    client carries its dense flat delta through its T steps, one fused
    dual-perturb and one fused update launch per step."""

    @torch.no_grad()
    def round_step(params, keys, batches):
        backing = get_backing(space, params)
        K = next(iter(batches.values())).shape[0]
        if int(keys.shape[0]) != T:
            raise ValueError(f"round_step takes {T} keys, got "
                             f"{int(keys.shape[0])}")
        flat = resolve_backend(backend, backing) != "ref"
        w_flat = backing.flatten(params) if flat else None
        deltas, gs = [], []
        for c in range(K):
            per_step = [{k: v[c, t] for k, v in batches.items()}
                        for t in range(T)]
            g_c = []
            if flat:
                d = torch.zeros(backing.n_pad, dtype=torch.float32,
                                device=backing.device)
                for key, b in zip(keys, per_step):
                    z_flat = backing.expand(space.sample_z(key))
                    wp, wm = zo_dual_perturb_flat(w_flat + d, z_flat, None,
                                                  eps)
                    lp = loss_fn(backing.unflatten(wp), b)
                    del wp
                    lm = loss_fn(backing.unflatten(wm), b)
                    del wm
                    g = (lp - lm) / (2.0 * eps)
                    d = zo_fused_update_flat(d, z_flat, None, -lr * g)
                    g_c.append(g)
                deltas.append(backing.restrict(d))
            else:
                delta = torch.zeros(space.n, dtype=torch.float32,
                                    device=space.device)
                for key, b in zip(keys, per_step):
                    z = space.sample_z(key)
                    lp = loss_fn(space.add(params, delta + eps * z), b)
                    lm = loss_fn(space.add(params, delta - eps * z), b)
                    g = (lp - lm) / (2.0 * eps)
                    delta = delta - lr * g * z
                    g_c.append(g)
                deltas.append(delta)
            gs.append(torch.stack(g_c))
        agg = torch.stack(deltas).mean(0)
        return space.add(params, agg), torch.stack(gs)

    return round_step
