"""Transformer layers of the dense decoder family, in torch
(``repro.models.layers``): RMSNorm, RoPE, GQA attention with QKV bias,
softcap and sliding window, gated MLPs.

Parameters are plain dicts of tensors (``models/init.py``).  Forward
attention runs through one dispatch point, :func:`forward_attention`, which
selects between two routes of the same function per ``ctx.attn_backend``
(see :func:`resolve_attn_backend`):

* ``"kernel"`` — the flash-attention kernels (``kernels.ops.flash_attention``:
  the forward of ``kernels/csrc/flash_attn.cu`` and, under autograd, the
  recompute backward of ``kernels/csrc/flash_attn_bwd.cu``): GQA-grouped,
  no [S, S] scores in either direction;
* ``"dense"``  — materialized scores, differentiated by autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import KERNEL_HEAD_DIMS

NEG_INF = -1e9  # large-negative for masking (bf16-safe)


# ---------------------------------------------------------------- norms ----
def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ----------------------------------------------------------------- RoPE ----
def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [..., S, n_heads, head_dim]; positions: [..., S] integer."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs      # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]               # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention ----
def _project_qkv(x, p, cfg):
    """Return q [B,S,H,hd], k,v [B,S,KV,hd]."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(cfg.n_heads, hd)
        k = k + p["bk"].reshape(cfg.n_kv_heads, hd)
        v = v + p["bv"].reshape(cfg.n_kv_heads, hd)
    return q, k, v


def gqa_attention(q, k, v, mask, cfg):
    """q: [B,Sq,H,hd]; k,v: [B,Sk,KV,hd]; mask: [B|1, Sq, Sk] bool or None.

    Scores use the grouped [B, KV, G, Sq, Sk] layout, so K/V are never
    repeated G-fold."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)  # head h -> (kv h//G, g h%G)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k.float()) * (hd ** -0.5)
    scores = softcap(scores, cfg.attn_softcap)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, Sq, H, hd).to(v.dtype)


def causal_mask(S: int, window: int = 0, device=None):
    """[1, S, S] causal (optionally banded) mask."""
    qi = torch.arange(S, device=device)[:, None]
    ki = torch.arange(S, device=device)[None, :]
    m = ki <= qi
    if window:
        m = m & (ki > qi - window)
    return m[None]


# ---------------------------------------- forward-attention dispatch ----
ATTN_BACKENDS = ("auto", "kernel", "dense")

# below this the [S, S] score tile is small and the dense route's single
# fused matmul serves; at and above it the kernel avoids the O(S^2)
# materialization that dominates forward memory (repro's threshold)
ATTN_AUTO_MIN_S = 256


def kernel_supports(cfg) -> bool:
    """Whether the flash kernel takes this head layout."""
    G = cfg.n_heads // cfg.n_kv_heads
    return cfg.resolved_head_dim in KERNEL_HEAD_DIMS and G <= 64


def resolve_attn_backend(backend, cfg, *, S: int = 0,
                         differentiable: bool = False) -> str:
    """Map a requested forward-attention backend to 'kernel' | 'dense'.

    Explicit backends are honoured.  "auto" resolves to "dense" below
    ``ATTN_AUTO_MIN_S`` or for a head layout the kernel does not take, and
    to "kernel" otherwise, whether or not autograd records
    (``differentiable``): the kernel route differentiates through the
    recompute backward kernels, whose saved state is O(S*dh).

    This is the port's own rule.  Under grad, the JAX package on a compiled
    TPU sends head dims off its 128-lane tile (Llama-3.2-1B's 64) to its
    ``online`` jnp route, which the port does not have; the port's kernels
    take head_dim 64 and 128 alike, so it takes the kernel there too."""
    backend = backend or "auto"
    if backend not in ATTN_BACKENDS:
        raise ValueError(
            f"attn backend must be one of {ATTN_BACKENDS}, got {backend!r}")
    if backend != "auto":
        return backend
    if S < ATTN_AUTO_MIN_S or not kernel_supports(cfg):
        return "dense"
    return "kernel"


def forward_attention(q, k, v, cfg, ctx=None, *, window: int = 0):
    """Unified forward-attention entry: q [B,S,H,hd]; k,v [B,S,KV,hd] ->
    [B,S,H,hd], causal (optionally banded to ``window``), on the route
    ``ctx.attn_backend`` resolves to."""
    S = q.shape[1]
    be = resolve_attn_backend(getattr(ctx, "attn_backend", None), cfg, S=S)
    if be == "kernel":
        from repro_torch.kernels.ops import flash_attention
        out = flash_attention(q, k, v, window=window,
                              softcap=cfg.attn_softcap)
        return out.to(v.dtype)
    return gqa_attention(q, k, v, causal_mask(S, window, device=q.device),
                         cfg)


def self_attention(x, p, cfg, positions, *, local: bool, ctx=None):
    """Full training/prefill self-attention. x: [B,S,D] -> [B,S,D]."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window if local else 0
    out = forward_attention(q, k, v, cfg, ctx, window=window)
    return out.reshape(B, S, -1) @ p["wo"]


# ------------------------------------------------------------------ MLP ----
def mlp(x, p, cfg):
    """Gated MLP: act(x W1) * (x W3) W2, act = silu or tanh-gelu."""
    h = F.silu(x @ p["w1"]) if cfg.act == "silu" \
        else F.gelu(x @ p["w1"], approximate="tanh")
    return (h * (x @ p["w3"])) @ p["w2"]
