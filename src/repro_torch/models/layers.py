"""Transformer layers of the dense decoder and hybrid families, in torch
(``repro.models.layers``): RMSNorm, RoPE (or no positional encoding, as in
Jamba), GQA attention with QKV bias, softcap and sliding window, gated
MLPs.

Parameters are plain dicts of tensors (``models/init.py``).  Forward
attention runs through one dispatch point, :func:`forward_attention`, which
selects between two routes of the same function per ``ctx.attn_backend``
(see :func:`resolve_attn_backend`):

* ``"kernel"`` — the flash-attention kernels (``kernels.ops.flash_attention``:
  the forward of ``kernels/csrc/flash_attn.cu`` and, under autograd, the
  recompute backward of ``kernels/csrc/flash_attn_bwd.cu``): GQA-grouped,
  no [S, S] scores in either direction;
* ``"dense"``  — materialized scores, differentiated by autograd.

One-token decode runs through :func:`decode_self_attention`, on the route
``ctx.decode_backend`` resolves to (:func:`resolve_decode_backend`): the
flash-decode kernel (``kernels.ops.flash_decode``) or its plain version
(``kernels.ref.decode_attention_ref``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import plans, ref
from repro_torch.kernels.ops import (BWD_HEAD_DIMS, DECODE_HEAD_DIMS,
                                     DECODE_MAX_G, KERNEL_HEAD_DIMS,
                                     flash_decode)

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


def kernel_supports(cfg, differentiable: bool = False) -> bool:
    """Whether the flash kernels take this head layout: the forward's
    head dims and G <= 64, and under autograd the backward's too (G up to
    its query tile's rows: 32 at head_dim 256)."""
    G = cfg.n_heads // cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    if differentiable:
        return hd in BWD_HEAD_DIMS and G <= plans.flash_bwd_rows(hd)
    return hd in KERNEL_HEAD_DIMS and G <= 64


def resolve_attn_backend(backend, cfg, *, S: int = 0,
                         differentiable: bool = False) -> str:
    """Map a requested forward-attention backend to 'kernel' | 'dense'.

    Explicit backends are honoured.  "auto" resolves to "dense" below
    ``ATTN_AUTO_MIN_S`` or for a head layout the kernels do not take, and
    to "kernel" otherwise, whether or not autograd records
    (``differentiable``): the kernel route differentiates through the
    recompute backward kernels, whose saved state is O(S*dh).  Both the
    forward and the backward kernels take head_dim 64, 128 and 256, so
    Gemma-2 (head_dim 256) takes the kernel under autograd too.

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
    if S < ATTN_AUTO_MIN_S or not kernel_supports(cfg, differentiable):
        return "dense"
    return "kernel"


def forward_attention(q, k, v, cfg, ctx=None, *, window: int = 0,
                      kv_mask=None, lengths=None):
    """Unified forward-attention entry: q [B,S,H,hd]; k,v [B,S,KV,hd] ->
    [B,S,H,hd], causal (optionally banded to ``window``), on the route
    ``ctx.attn_backend`` resolves to.

    Right-padded batches (prefill) give key validity as per-row ``lengths``
    [B] and/or ``kv_mask`` [B, 1, S], a valid prefix per row: the kernel
    route passes the lengths (or the mask's row sums) to the kernel, the
    dense route ANDs the key mask into the causal one."""
    B, S = q.shape[:2]
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    be = resolve_attn_backend(getattr(ctx, "attn_backend", None), cfg, S=S,
                              differentiable=grad)
    if be == "kernel":
        from repro_torch.kernels.ops import flash_attention
        L = lengths
        if L is None and kv_mask is not None:
            L = kv_mask.reshape(B, S).sum(-1).to(torch.int32)
        out = flash_attention(q, k, v, L, window=window,
                              softcap=cfg.attn_softcap)
        return out.to(v.dtype)
    mask = causal_mask(S, window, device=q.device)
    if kv_mask is None and lengths is not None:
        L = torch.as_tensor(lengths, device=q.device).reshape(-1).expand(B)
        kv_mask = (torch.arange(S, device=q.device)[None, :]
                   < L[:, None])[:, None, :]
    if kv_mask is not None:
        mask = mask & kv_mask.reshape(B, 1, S)
    return gqa_attention(q, k, v, mask, cfg)


def self_attention(x, p, cfg, positions, *, local: bool, ctx=None):
    """Full training/prefill self-attention. x: [B,S,D] -> [B,S,D]."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg)
    if cfg.rope_style != "none":  # Jamba's attention has no positions
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.sliding_window if local else 0
    out = forward_attention(q, k, v, cfg, ctx, window=window)
    return out.reshape(B, S, -1) @ p["wo"]


# -------------------------------------------------- decode-mode attention ----
DECODE_BACKENDS = ("auto", "kernel", "ref")


def decode_kernel_supports(cfg) -> bool:
    """Whether the flash-decode kernel takes this head layout."""
    G = cfg.n_heads // cfg.n_kv_heads
    return cfg.resolved_head_dim in DECODE_HEAD_DIMS and G <= DECODE_MAX_G


def resolve_decode_backend(backend, cfg) -> str:
    """Map a requested decode-attention backend to 'kernel' | 'ref'.

    Explicit backends are honoured; "auto" takes the flash-decode kernel
    whenever it takes the head layout, else its plain version.  This
    is the port's own rule and naming: the JAX package says "pallas" for
    the kernel and also sends a sharded mesh, or on a compiled TPU a
    head_dim off the 128-lane tile, to "ref"; the port runs on one device
    and its kernel takes head_dim 64, 128 and 256."""
    backend = backend or "auto"
    if backend not in DECODE_BACKENDS:
        raise ValueError(
            f"decode backend must be one of {DECODE_BACKENDS}, got "
            f"{backend!r}")
    if backend != "auto":
        return backend
    return "kernel" if decode_kernel_supports(cfg) else "ref"


def decode_self_attention(x1, p, cfg, cache_k, cache_v, cur_pos, *,
                          local: bool, ctx=None, active=None):
    """One-token decode. x1: [B,1,D]; cache_k/v: [B,W,KV,hd] (rolling when
    local); cur_pos: per-row [B] positions.  Returns (out [B,1,D], cache_k,
    cache_v).

    The new key and value go into the cache **in place**, in the cache's
    dtype and before the read: slot ``pos % W`` on a rolling (local) cache,
    ``min(pos, W-1)`` on a global one.  Rows where ``active`` ([B] bool) is
    False keep their cache bit for bit (their slot is rewritten with its
    old value); their output is not meaningful.  The JAX package computes
    every row and restores inactive ones in ``decode_step``; the caches
    agree."""
    B = x1.shape[0]
    hd = cfg.resolved_head_dim
    W = cache_k.shape[1]
    q, k, v = _project_qkv(x1, p, cfg)  # [B,1,H,hd], [B,1,KV,hd]
    pos = torch.as_tensor(cur_pos, device=x1.device).reshape(-1).expand(B)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    rolling = bool(local and cfg.sliding_window)
    slot = torch.remainder(pos, W) if rolling else torch.clamp(pos, max=W - 1)
    rows = torch.arange(B, device=x1.device)
    k_new, v_new = k[:, 0].to(cache_k.dtype), v[:, 0].to(cache_v.dtype)
    if active is not None:
        keep = active.reshape(B, 1, 1)
        k_new = torch.where(keep, k_new, cache_k[rows, slot])
        v_new = torch.where(keep, v_new, cache_v[rows, slot])
    cache_k[rows, slot] = k_new
    cache_v[rows, slot] = v_new
    # both cache layouts hold a per-row live *prefix*: a global cache
    # positions [0, pos], a rolling one min(pos + 1, W) slots
    lengths = torch.clamp(pos + 1, max=W)
    KV = cfg.n_kv_heads
    qg = q[:, 0].reshape(B, KV, cfg.n_heads // KV, hd)  # a view, no copy
    backend = resolve_decode_backend(getattr(ctx, "decode_backend", None),
                                     cfg)
    if backend == "kernel":
        out = flash_decode(qg, cache_k, cache_v, lengths,
                           softcap=cfg.attn_softcap)
    else:
        out = ref.decode_attention_ref(qg, cache_k, cache_v, lengths,
                                       cfg.attn_softcap)
    out = out.to(cache_v.dtype)
    return out.reshape(B, 1, -1) @ p["wo"], cache_k, cache_v


# ------------------------------------------------------------------ MLP ----
def mlp(x, p, cfg):
    """Gated MLP: act(x W1) * (x W3) W2, act = silu or tanh-gelu."""
    h = F.silu(x @ p["w1"]) if cfg.act == "silu" \
        else F.gelu(x @ p["w1"], approximate="tanh")
    return (h * (x @ p["w3"])) @ p["w2"]
