"""Plain PyTorch versions of the port's kernels (``repro.kernels.ref``).

The wrappers in ``ops.py`` run these only for tensors on the CPU; on the card
they launch the CUDA kernels, and ``chip_smoke.py`` holds each kernel
against its plain version on the same inputs.  The arithmetic order follows
the TPU kernels: the perturbation is taken in f32 (``eps * z``, then ``* m``),
cast to w's dtype, and then added.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30  # the flash kernel's masked-logit value


def dual_perturb_ref(w, z, m, eps):
    """(w + eps*z*m, w - eps*z*m); ``m=None`` means z is pre-masked."""
    pert = eps * z if m is None else eps * z * m
    pert = pert.to(w.dtype)
    return w + pert, w - pert


def fused_update_ref(w, z, m, scale):
    """w + scale*z*m (scale = -lr*g); ``m=None`` means z is pre-masked."""
    upd = scale * z if m is None else scale * z * m
    return w + upd.to(w.dtype)


def gradip_reduce_ref(gp, z, g):
    """g * sum(gp * z) in f32."""
    return torch.as_tensor(g, dtype=torch.float32, device=gp.device) * \
        torch.sum(gp.float() * z.float())


def attention_valid(S: int, lengths, *, window: int, causal: bool):
    """[B, S_q, S_k] bool: key p is live for query t when p < lengths[b],
    p <= t (causal) and t - window < p (window > 0)."""
    pos = torch.arange(S, device=lengths.device)
    valid = (pos[None, None, :] < lengths[:, None, None]).expand(
        -1, S, -1)
    if causal:
        valid = valid & (pos[None, :] <= pos[:, None])[None]
    if window:
        valid = valid & (pos[None, :] > pos[:, None] - window)[None]
    return valid


def flash_attention_ref(q, k, v, lengths, *, window: int = 0,
                        softcap: float = 0.0, causal: bool = True):
    """Dense version of the flash forward, with the same softmax state.

    q [B, S, H, dh]; k, v [B, S, KVH, dh]; lengths [B] int (<= S).  Returns
    O [B, S, H, dh] in q's dtype and lse [B, KVH, S, G] f32.  A row with no
    live key gets O = 0 and lse = NEG_INF + log(1e-30), as the kernel
    leaves it."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, S, KV, G, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (dh ** -0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = attention_valid(S, lengths, window=window, causal=causal)
    valid = valid[:, None, None]                  # [B, 1, 1, Sq, Sk]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float()) / \
        l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l))[..., 0].permute(0, 1, 3, 2)  # [B, KV, S, G]
    return out.reshape(B, S, H, dh).to(q.dtype), lse.contiguous()
