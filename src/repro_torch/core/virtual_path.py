"""Server-side virtual-path reconstruction (paper Alg. 2 step 2;
``repro.core.virtual_path``).

The server holds the round's seed list and receives each client's projected
gradients ``{g_k^t}``, so it regenerates every ``z_t`` and replays the
client's local trajectory without any client data.  Updates only touch the
masked coordinates, so the server tracks the sparse value vector (delta).
"""
from __future__ import annotations

import torch

from repro_torch.core import prng


def _fma(a, b, c):
    """``a * b + c`` rounded once to f32, as XLA's CPU backend contracts
    the replay's ``delta - lr * upd``.  The product of two f32 numbers is
    exact in f64, Knuth's two-sum gives the f64 sum's error, and rounding
    that sum to odd before the f32 rounding makes the double rounding
    exact."""
    p = a.double() * b.double()
    c = c.double()
    s = c + p
    bb = s - c
    err = (c - (s - bb)) + (p - bb)
    bits = s.view(torch.int64)
    # inexact and even: step to the odd neighbour on the error's side
    away = (err > 0) == (s > 0)
    odd = torch.where(away, bits + 1, bits - 1)
    fix = (err != 0) & ((bits & 1) == 0)
    return torch.where(fix, odd, bits).view(torch.float64).float()


@torch.no_grad()
def reconstruct_delta(space, keys, gs, lr: float, delta0=None):
    """Replay T local steps. gs: [T] (paper) or [T, K] (multi-direction ZO,
    K scalars per step); keys: [T, 2]. Returns delta_T [n].

    Each step is ``delta - lr * (g * z)`` with the last multiply-subtract
    rounded once, as the JAX package's replay compiles on a CPU; the K
    directions' ``g_k * z_k`` are summed in order and scaled by ``1/K``."""
    gs = torch.as_tensor(gs, dtype=torch.float32, device=space.device)
    delta = (torch.zeros(space.n, dtype=torch.float32, device=space.device)
             if delta0 is None else delta0)
    neg_lr = torch.full((), -lr, dtype=torch.float32, device=space.device)
    for key, g in zip(keys, gs):
        if gs.dim() == 2:
            upd = None
            for k, g_k in zip(prng.split(key, g.shape[0]), g):
                gz = g_k * space.sample_z(k)
                upd = gz if upd is None else upd + gz
            upd = upd * torch.full((), 1.0 / g.shape[0], dtype=torch.float32,
                                   device=space.device)
        else:
            upd = g * space.sample_z(key)
        delta = _fma(upd, neg_lr, delta)
    return delta


def reconstruct_from_wire(space, keys, wire, codec, lr: float, delta0=None):
    """Replay a client's local trajectory from its **encoded uplink
    payload**: the fleet-scale server's whole per-client knowledge is (seed
    keys, wire bytes).  In exact-replay mode (``core/quantize.py``: the
    client applies the wire-grid value at every local step, and on-grid
    values survive the codec bit for bit) ``codec.decode(wire)`` returns
    exactly the scalars the client's trajectory used."""
    return reconstruct_delta(space, keys, codec.decode(wire), lr, delta0)


@torch.no_grad()
def reconstruct_grad_vecs(space, keys, gs):
    """The reconstructed ZO gradient vectors grad_hat_t = g_t * z_t, [T, n]
    (sparse-coordinate representation)."""
    gs = torch.as_tensor(gs, dtype=torch.float32, device=space.device)
    return torch.stack([g * space.sample_z(k) for k, g in zip(keys, gs)])


def aggregate(deltas, n_reporting=None):
    """FedAvg aggregation of reconstructed sparse client deltas [K, n]
    (rows in the server's summation order).

    ``n_reporting`` makes the normalization explicit for fault-tolerant
    rounds (the mean is over whichever subset actually reported).  It
    defaults to ``deltas.shape[0]``.  A zero-survivor round has no rows to
    average: callers apply a zero update instead of calling this with an
    empty stack."""
    n = deltas.shape[0] if n_reporting is None else int(n_reporting)
    if n <= 0 or deltas.shape[0] == 0:
        raise ValueError(
            f"aggregate needs >= 1 reporting client (got rows="
            f"{deltas.shape[0]}, n_reporting={n_reporting}); zero-survivor "
            "rounds apply a zero update instead")
    total = deltas[0]
    for d in deltas[1:]:  # row by row, the JAX package's CPU reduction order
        total = total + d
    return total / n
