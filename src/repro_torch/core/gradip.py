"""GradIP score (paper Definition 2.3) and trajectory computation
(``repro.core.gradip``).

GradIP_t = < grad_f_pretrain , grad_hat_k^t >  where grad_hat_k^t is the
ZO-reconstructed client gradient.  In sparse coordinates this is
``g_k^t * dot(gp[mask], z_t)``: the server never materializes dense
gradients.

The inner reduction is the one-launch deterministic reduction kernel
(``kernels/csrc/gradip.cu`` via ``kernels.ops.gradip_flat``, whose plain
version runs on the CPU).  The JAX package's jnp-dot route served traced
and mesh-sharded vectors, which the port does not have.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.ops import gradip_flat
from repro_torch.utils.tree import tree_flatten, tree_unflatten


@torch.no_grad()
def gradip_trajectory(space, keys, gs, gp_vec):
    """Per-step GradIP of one client's virtual path.

    Args:
      space: the sparse coordinate space (``sample_z`` regenerates each
        step's direction from the shared seed ladder).
      keys: [T, 2] keys (the round's seed list).
      gs: [T] f32 projected-gradient scalars uploaded by the client (host
        numbers: a numpy array or a CPU tensor).
      gp_vec: [n] f32 pre-training gradient restricted to the space.

    Returns (gradip [T], grad_norm [T], cosine [T]) f32 tensors on the
    space's device: ``gradip_t = g_t * <gp, z_t>``, ``grad_norm_t =
    |g_t| * ||z_t||`` and the cosine between the reconstructed gradient and
    ``gp``."""
    gp = gp_vec.float().contiguous()
    gp_norm = torch.linalg.vector_norm(gp) + 1e-12
    gs_host = torch.as_tensor(gs, dtype=torch.float32).cpu()
    ips, norms, coss = [], [], []
    for key, g in zip(keys, gs_host):
        z = space.sample_z(key)
        ip = gradip_flat(gp, z, float(g))
        gnorm = torch.abs(g.to(gp.device)) * torch.linalg.vector_norm(z)
        ips.append(ip)
        norms.append(gnorm)
        coss.append(ip / (gp_norm * gnorm + 1e-12))
    return torch.stack(ips), torch.stack(norms), torch.stack(coss)


def gradip_matrix(entries, T: Optional[int] = None):
    """Stack one client's per-round GradIP log into a dense matrix with
    explicit gaps.

    ``entries`` is ``FederatedZO.gradip_log[cid]``: one [T_r] array per
    round the client reported, ``None`` for rounds it was dropped,
    straggling (until arrival) or unsampled.  Returns ``(mat [R, T] f32,
    present [R] bool)``: gap rounds are NaN rows; shorter entries (an
    early-stopped client's T=1 rounds) are NaN-padded on the right.  ``T``
    defaults to the longest present entry and must be given when the log
    is all gaps."""
    entries = list(entries)
    present = np.array([e is not None for e in entries], bool)
    lens = [int(np.asarray(e).reshape(-1).shape[0])
            for e in entries if e is not None]
    if T is None:
        if not lens:
            raise ValueError("gradip_matrix: all-gap log needs explicit T")
        T = max(lens)
    mat = np.full((len(entries), int(T)), np.nan, np.float32)
    for i, e in enumerate(entries):
        if e is not None:
            row = np.asarray(e, np.float32).reshape(-1)
            mat[i, :row.shape[0]] = row
    return mat, present


def value_and_grad_tree(loss_fn, params, batch):
    """(loss, gradient tree) of the scalar ``loss_fn(params, batch)``, by
    autograd through whatever attention route the model resolves (the flash
    kernels' recompute backward at S >= 256).  The loss is detached."""
    leaves, treedef = tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(treedef, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(treedef, list(grads))


def grad_tree(loss_fn, params, batch):
    """Gradient tree of the scalar ``loss_fn(params, batch)``."""
    return value_and_grad_tree(loss_fn, params, batch)[1]


def pretrain_gradient_vec(loss_fn, params, space, batches):
    """Server-held pre-training gradient restricted to the space: the mean
    gradient over the batches at the space's coordinates, [n] f32."""
    acc = torch.zeros(space.n, dtype=torch.float32, device=space.device)
    n = 0
    for b in batches:
        acc = acc + space.slice(grad_tree(loss_fn, params, b))
        n += 1
    return acc / max(n, 1)
