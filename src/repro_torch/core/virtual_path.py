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


@torch.no_grad()
def reconstruct_delta(space, keys, gs, lr: float, delta0=None):
    """Replay T local steps. gs: [T] (paper) or [T, K] (multi-direction ZO,
    K scalars per step); keys: [T, 2]. Returns delta_T [n]."""
    gs = torch.as_tensor(gs, dtype=torch.float32, device=space.device)
    delta = (torch.zeros(space.n, dtype=torch.float32, device=space.device)
             if delta0 is None else delta0)
    for key, g in zip(keys, gs):
        if gs.dim() == 2:
            zs = torch.stack([space.sample_z(k)
                              for k in prng.split(key, g.shape[0])])
            upd = (g[:, None] * zs).mean(0)
        else:
            upd = g * space.sample_z(key)
        delta = delta - lr * upd
    return delta


def aggregate(deltas):
    """FedAvg aggregation of reconstructed sparse client deltas [K, n]."""
    if deltas.shape[0] == 0:
        raise ValueError("aggregate needs >= 1 reporting client")
    return torch.sum(deltas, dim=0) / deltas.shape[0]
