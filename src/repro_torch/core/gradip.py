"""GradIP score (paper Definition 2.3) and trajectory computation
(``repro.core.gradip``).

GradIP_t = < grad_f_pretrain , grad_hat_k^t >  where grad_hat_k^t is the
ZO-reconstructed client gradient.  In sparse coordinates this is
``g_k^t * dot(gp[mask], z_t)``: the server never materializes dense
gradients.

The inner reduction is the two-pass reduction kernel
(``kernels/csrc/gradip.cu`` via ``kernels.ops.gradip_flat``, whose plain
version runs on the CPU).  The JAX package's jnp-dot route served traced
and mesh-sharded vectors, which the port does not have.
"""
from __future__ import annotations

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


def grad_tree(loss_fn, params, batch):
    """Gradient tree of the scalar ``loss_fn(params, batch)`` (autograd
    through the model's dense attention route)."""
    leaves, treedef = tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(treedef, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return tree_unflatten(treedef, list(grads))


def pretrain_gradient_vec(loss_fn, params, space, batches):
    """Server-held pre-training gradient restricted to the space: the mean
    gradient over the batches at the space's coordinates, [n] f32."""
    acc = torch.zeros(space.n, dtype=torch.float32, device=space.device)
    n = 0
    for b in batches:
        acc = acc + space.slice(grad_tree(loss_fn, params, b))
        n += 1
    return acc / max(n, 1)
