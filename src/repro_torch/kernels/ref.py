"""Plain PyTorch versions of the port's kernels (``repro.kernels.ref``).

The wrappers in ``ops.py`` run these only for tensors on the CPU; on the card
they launch the CUDA kernels, and ``chip_smoke.py`` holds each kernel
against its plain version on the same inputs.  The arithmetic order follows
the TPU kernels: the perturbation is taken in f32 (``eps * z``, then ``* m``),
cast to w's dtype, and then added; the flash backward recomputes the
probabilities from the forward's logsumexp, as the TPU's recompute kernels
do; the decode attention masks with an explicit zero, so a row without a
live key is zeros; the selective scan steps through the sequence one
position at a time, as the JAX oracle does.
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


def fixture_double_ref(x):
    """x * 2: the analyzer's memory-ceiling fixture (``fixture_double``)."""
    return x * 2.0


def mamba_scan_ref(dt, B_in, C_in, x, A):
    """Serial selective scan (``repro.kernels.ref.mamba_scan_ref``).

    dt, x [B, S, E] (dt after softplus); B_in, C_in [B, S, N]; A [E, N], or
    [G, E, N] for G runs of B / G rows each (the kernel's per-member A).
    ``h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t``, ``y_t = <h_t, C_t>``
    from h = 0.  Returns (y [B, S, E] f32, h_last [B, E, N] f32)."""
    B, S, E = dt.shape
    N = B_in.shape[-1]
    dt, B_in, C_in, x, A = (t.float() for t in (dt, B_in, C_in, x, A))
    if A.dim() == 3:
        A = A.repeat_interleave(B // A.shape[0], 0)         # [B, E, N]
    h = torch.zeros((B, E, N), dtype=torch.float32, device=dt.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t, :, None] * A)            # [B, E, N]
        h = decay * h + (dt[:, t] * x[:, t])[..., None] * B_in[:, t, None, :]
        ys.append(torch.einsum("ben,bn->be", h, C_in[:, t]))
    return torch.stack(ys, 1), h


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


def decode_attention_ref(q, k, v, length, softcap: float = 0.0):
    """One-token GQA decode (``repro.kernels.ref.decode_attention_ref``):
    q [B, KVH, G, dh]; k, v [B, S, KVH, dh]; ``length`` a scalar or per-row
    [B] int (the live cache prefix).  Scores (q.k) * dh^-0.5, then the tanh
    ``softcap``, then the mask ``pos < length``; softmax in f32; out
    [B, KVH, G, dh] in q's dtype.

    A row of length <= 0 has no live key and gets zeros, as the kernel
    leaves it (the port's rule: the JAX package's kernel and plain version
    average V over the whole capacity there)."""
    B, KV, G, dh = q.shape
    S = k.shape[1]
    s = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) * (dh ** -0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    L = torch.as_tensor(length, device=q.device).reshape(-1).expand(B)
    valid = (torch.arange(S, device=q.device)[None, :] < L[:, None])
    valid = valid[:, None, None, :]               # [B, 1, 1, S]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float()) / l
    return out.to(q.dtype)


def flash_attention_delta(out, do, n_kv_heads: int):
    """delta = rowsum(dO * O) in f32, [B, KVH, S, G]: the backward's
    per-row term, taken outside the kernels as the JAX package does
    (``_flash_attention_bwd``).  out, do: [B, S, H, dh]."""
    B, S, H, _ = out.shape
    delta = (do.float() * out.float()).sum(-1)     # [B, S, H]
    return delta.reshape(B, S, n_kv_heads, H // n_kv_heads).permute(
        0, 2, 1, 3).contiguous()


def _recompute_p_ds(q, k, v, lengths, lse, delta, do, *, window, softcap,
                    causal):
    """Dense counterpart of the TPU kernels' ``_recompute_p_ds``: p and ds
    [B, KVH, G, Sq, Sk] f32, and q, dO grouped [B, S, KVH, G, dh] f32."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.float().reshape(B, S, KV, G, dh)
    dog = do.float().reshape(B, S, KV, G, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (dh ** -0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = attention_valid(S, lengths, window=window, causal=causal)
    valid = valid[:, None, None]                  # [B, 1, 1, Sq, Sk]
    row = lambda t: t.permute(0, 1, 3, 2)[..., None]  # [B, KV, G, Sq, 1]
    # explicit zero where invalid: on a row with no live key lse is ~-1e30
    # and exp(s - lse) would overflow, not vanish
    p = torch.where(valid, torch.exp(s - row(lse)), 0.0)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    ds = p * (dp - row(delta))
    if softcap:
        # s is the capped logit: d(tanh cap)/d(raw) = 1 - (s/cap)^2
        ds = ds * (1.0 - torch.square(s / softcap))
    return p, ds, qg, dog


def flash_attn_bwd_dq_ref(q, k, v, lengths, lse, delta, do, *, window: int,
                          softcap: float, causal: bool = True):
    """dQ of the flash attention, [B, S, H, dh] f32 (``_bwd_dq_call``).

    q, do [B, S, H, dh]; k, v [B, S, KVH, dh]; lengths [B] int (<= S); lse,
    delta [B, KVH, S, G] f32 (the forward's lse, rowsum(dO * O))."""
    B, S, H, dh = q.shape
    _, ds, _, _ = _recompute_p_ds(q, k, v, lengths, lse, delta, do,
                                  window=window, softcap=softcap,
                                  causal=causal)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * (dh ** -0.5)
    return dq.reshape(B, S, H, dh)


def flash_attn_bwd_dkv_ref(q, k, v, lengths, lse, delta, do, *, window: int,
                           softcap: float, causal: bool = True):
    """(dK, dV) of the flash attention, each [B, S, KVH, dh] f32
    (``_bwd_dkv_call``); arguments as :func:`flash_attn_bwd_dq_ref`."""
    dh = q.shape[-1]
    p, ds, qg, dog = _recompute_p_ds(q, k, v, lengths, lse, delta, do,
                                     window=window, softcap=softcap,
                                     causal=causal)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * (dh ** -0.5)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return dk, dv
