"""Transformer layers of the dense decoder and hybrid families, in torch
(``repro.models.layers``): RMSNorm and LayerNorm, full or partial RoPE (or
no positional encoding, as in Jamba), GQA attention with QKV bias, qk-norm,
LoRA adapters on q and v, softcap and sliding window, gated and plain MLPs,
and Whisper's encoder (bidirectional) and cross-attention, which take the
dense GQA route as the JAX package's do.

Parameters are plain dicts of tensors (``models/init.py``).  Forward
attention runs through one dispatch point, :func:`forward_attention`, which
selects between three routes of the same function per ``ctx.attn_backend``
(see :func:`resolve_attn_backend`):

* ``"kernel"`` — the flash-attention kernels (``kernels.ops.flash_attention``:
  the forward of ``kernels/csrc/flash_attn.cu`` and, under autograd, the
  recompute backward of ``kernels/csrc/flash_attn_bwd.cu``): GQA-grouped,
  no [S, S] scores in either direction;
* ``"online"`` — online softmax over key blocks in plain torch
  (:func:`online_gqa_attention`), differentiated by autograd, no [S, S]
  scores either: the route of head layouts the kernels do not take;
* ``"dense"``  — materialized scores (chunked per query block when
  ``ctx.attn_q_block`` is set, :func:`blocked_gqa_attention`),
  differentiated by autograd.

One-token decode runs through :func:`decode_self_attention`, on the route
``ctx.decode_backend`` resolves to (:func:`resolve_decode_backend`): the
flash-decode kernel (``kernels.ops.flash_decode``) or, as in the JAX
package, :func:`grouped_gqa_attention` over the live prefix.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import plans, ref
from repro_torch.kernels.ops import (BWD_HEAD_DIMS, DECODE_HEAD_DIMS,
                                     DECODE_MAX_G, KERNEL_HEAD_DIMS,
                                     flash_decode)
from repro_torch.utils.tree import is_dtensor

NEG_INF = -1e9  # large-negative for masking (bf16-safe)


# ---------------------------------------------------------------- norms ----
def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    """LayerNorm: (x - mean) / std * scale + bias (scale initialised at 1,
    unlike RMSNorm's 1 + scale)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def apply_norm(x, p, kind: str, eps: float):
    """The norm ``kind`` ("rmsnorm" | "layernorm") with its parameters
    ``p`` (``{"scale"}`` or ``{"scale", "bias"}``)."""
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"], eps)
    return layernorm(x, p["scale"], p["bias"], eps)


def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def replicated(y):
    """A layer's output ready for the residual add: under tensor
    parallelism a row-parallel product is a partial sum on each rank, and
    Megatron all-reduces it here, so the residual stream stays whole on
    every rank (left to itself DTensor may reduce-scatter it over the
    hidden dim instead, and every later column-parallel product would
    then gather its weight).  A plain tensor passes as it is."""
    if not is_dtensor(y):
        return y
    from torch.distributed.tensor import Replicate
    mesh = y.device_mesh
    want = [Replicate()] * mesh.ndim
    return y if list(y.placements) == want else y.redistribute(mesh, want)


def merge_heads(out, *shape):
    """``out`` [B,S,H,hd] reshaped to ``shape`` (heads merged).  A DTensor
    sharded on any dim but the heads (the head_dim or the sequence of a
    sharded cache) is gathered on that dim first, so the merged dim keeps
    a plain placement."""
    if is_dtensor(out) and any(p.is_shard() and p.dim != 2
                               for p in out.placements):
        from torch.distributed.tensor import Replicate
        out = out.redistribute(out.device_mesh, [
            Replicate() if p.is_shard() and p.dim != 2 else p
            for p in out.placements])
    return out.reshape(*shape)


def split_heads(t, *shape):
    """``t.reshape(*shape)``, splitting a dim into heads.  A DTensor whose
    sharded dim does not split evenly over its mesh (KV heads fewer than
    the model axis) is replicated first, as GSPMD would gather it."""
    if not is_dtensor(t):
        return t.reshape(*shape)
    try:
        return t.reshape(*shape)
    except RuntimeError:
        from torch.distributed.tensor import Replicate
        mesh = t.device_mesh
        return t.redistribute(mesh, [Replicate()] * mesh.ndim).reshape(
            *shape)


# ----------------------------------------------------------------- RoPE ----
def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float, partial: float = 1.0):
    """x: [..., S, n_heads, head_dim]; positions: [..., S] integer.

    ``partial`` < 1 rotates only the first ``partial * head_dim`` dims,
    rounded down to even (ChatGLM's "2d" RoPE), with the frequencies taken
    over those dims; the rest pass through unchanged."""
    hd = x.shape[-1]
    rot = int(hd * partial)
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    freqs = rope_freqs(rot, theta, x.device)
    ang = positions[..., None].float() * freqs      # [..., S, rot/2]
    cos = torch.cos(ang)[..., None, :]               # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = xr.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rot == hd:
        return out.to(x.dtype)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def rope(q, k, positions, cfg):
    """q and k rotated as ``cfg.rope_style`` says ("full", "partial" by
    ``cfg.rope_partial_factor``, or "none": Jamba's attention has no
    positions)."""
    if cfg.rope_style == "none":
        return q, k
    partial = cfg.rope_partial_factor if cfg.rope_style == "partial" else 1.0
    return (apply_rope(q, positions, cfg.rope_theta, partial),
            apply_rope(k, positions, cfg.rope_theta, partial))


# ------------------------------------------------------------ attention ----
def _project_qkv(x, p, cfg):
    """Return q [B,S,H,hd], k,v [B,S,KV,hd]: the projections, the LoRA
    adapters on q and v where the layer has them (``s * ((x qa) qb)``, s =
    lora_alpha / lora_rank, in the JAX package's association), the QKV
    bias, then qk-norm (an RMSNorm over head_dim) before RoPE."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = split_heads(x @ p["wk"], B, S, cfg.n_kv_heads, hd)
    v = x @ p["wv"]
    if "lora_qa" in p:
        s = cfg.lora_alpha / cfg.lora_rank
        q = q + s * ((x @ p["lora_qa"]) @ p["lora_qb"])
        v = v + s * ((x @ p["lora_va"]) @ p["lora_vb"])
    q = split_heads(q, B, S, cfg.n_heads, hd)
    v = split_heads(v, B, S, cfg.n_kv_heads, hd)
    if cfg.qkv_bias:
        q = q + split_heads(p["bq"], cfg.n_heads, hd)
        k = k + split_heads(p["bk"], cfg.n_kv_heads, hd)
        v = v + split_heads(p["bv"], cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def gqa_attention(q, k, v, mask, cfg, ctx=None):
    """q: [B,Sq,H,hd]; k,v: [B,Sk,KV,hd]; mask: [B|1, Sq, Sk] bool or None.

    Scores use the grouped [B, KV, G, Sq, Sk] layout, so K/V are never
    repeated G-fold.  Under a mesh q is constrained at its H heads and K/V
    at their KV heads (``ModelCtx.attn_head_spec``), as in the JAX
    package."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    if ctx is not None and getattr(ctx, "mesh", None) is not None:
        q = ctx.constrain(q, ctx.attn_head_spec(B, Sq, H))
        kv_spec = ctx.attn_head_spec(B, k.shape[1], KV)
        k, v = ctx.constrain(k, kv_spec), ctx.constrain(v, kv_spec)
    qg = split_heads(q, B, Sq, KV, G, hd)  # head h -> (kv h//G, g h%G)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k.float()) * (hd ** -0.5)
    scores = softcap(scores, cfg.attn_softcap)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, Sq, H, hd).to(v.dtype)


def causal_mask(S: int, window: int = 0, device=None, *, Sk: int = 0,
                offset: int = 0):
    """[1, S, Sk] causal (optionally banded) mask of S queries over Sk keys
    (default S); ``offset`` is the absolute position of query 0."""
    qi = torch.arange(S, device=device)[:, None] + offset
    ki = torch.arange(Sk or S, device=device)[None, :]
    m = ki <= qi
    if window:
        m = m & (ki > qi - window)
    return m[None]


def blocked_gqa_attention(q, k, v, cfg, *, window: int, q_block: int,
                          kv_mask=None, ctx=None):
    """Query-block-chunked causal attention: scores are materialized per
    block [B, H, q_block, S] instead of [B, H, S, S]; one full block when
    ``q_block`` does not divide S or is not smaller than it.

    ``kv_mask``: [B, 1, S] bool key validity, ANDed into the causal mask."""
    B, S, H, hd = q.shape
    if not q_block or S % q_block or S <= q_block:
        mask = causal_mask(S, window, device=q.device)
        if kv_mask is not None:
            mask = mask & kv_mask
        return gqa_attention(q, k, v, mask, cfg, ctx)
    outs = []
    for off in range(0, S, q_block):
        mask = causal_mask(q_block, window, device=q.device, Sk=S,
                           offset=off)
        if kv_mask is not None:
            mask = mask & kv_mask
        outs.append(gqa_attention(q[:, off:off + q_block], k, v, mask, cfg,
                                  ctx))
    return torch.cat(outs, dim=1)


def online_gqa_attention(q, k, v, cfg, *, window: int = 0,
                         q_block: int = 512, kv_block: int = 512,
                         lengths=None, kv_mask=None):
    """Flash-style causal attention in plain torch: online softmax over key
    blocks, grouped query (no KV repeat), never an [S, S] score tensor (a
    [q_block, kv_block] tile per step), differentiated by autograd.

    q: [B,S,H,hd]; k,v: [B,S,KV,hd] -> [B,S,H,hd], the function of
    :func:`gqa_attention` under a causal (optionally banded) mask.  S need
    not be a block multiple: inputs are zero-padded to a multiple of
    lcm(q_block, kv_block), the padded keys masked and the padded query
    rows trimmed.  ``lengths`` ([B]) and/or ``kv_mask`` ([B, S] bool) mask
    right-padded keys.  p is masked explicitly (on a row masked so far,
    exp(s - m) would be 1, not 0) and l floored at 1e-30, as in the JAX
    package.  Key blocks wholly in a query block's future, or wholly
    before its window, are skipped: on them p is 0 and the carry's
    rescale is exp(0) = 1, so skipping them changes no bit."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    q_block = max(1, min(q_block, S))
    kv_block = max(1, min(kv_block, S))
    per = q_block * kv_block // math.gcd(q_block, kv_block)
    pad = (-S) % per
    dev = q.device
    kvv = None if kv_mask is None else kv_mask.to(torch.bool)
    if lengths is not None:
        L = torch.as_tensor(lengths, device=dev).reshape(-1).expand(B)
        lm = torch.arange(S, device=dev)[None, :] < L[:, None]
        kvv = lm if kvv is None else kvv & lm
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        if kvv is None:
            kvv = (torch.arange(S + pad, device=dev) < S)[None].expand(
                B, S + pad)
        else:
            kvv = F.pad(kvv, (0, pad))
    Sp = S + pad
    qg = split_heads(q, B, Sp, KV, G, hd).float()
    kf = k.float()
    ki_base = torch.arange(kv_block, device=dev)[None, :]
    qi_base = torch.arange(q_block, device=dev)[:, None]
    outs = []
    for q0 in range(0, Sp, q_block):
        qb = qg[:, q0:q0 + q_block]
        m = torch.full((B, KV, G, q_block), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, q_block), device=dev)
        acc = torch.zeros((B, KV, G, q_block, hd), device=dev)
        for k0 in range(0, Sp, kv_block):
            if k0 > q0 + q_block - 1:
                break                              # wholly in the future
            if window and k0 + kv_block - 1 <= q0 - window:
                continue                           # wholly before the band
            s = torch.einsum("bqkgd,bskd->bkgqs", qb,
                             kf[:, k0:k0 + kv_block]) * scale
            s = softcap(s, cfg.attn_softcap)
            kpos, qpos = k0 + ki_base, q0 + qi_base
            valid = kpos <= qpos
            if window:
                valid = valid & (kpos > qpos - window)
            valid = valid[None, None, None]
            if kvv is not None:
                valid = valid & kvv[:, None, None, None, k0:k0 + kv_block]
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            vb = v[:, k0:k0 + kv_block]
            # p rounded to v's dtype, then an f32 product, as JAX's
            # preferred_element_type=f32 einsum
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(vb.dtype).float(), vb.float())
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    # [B, KV, G, q_block, hd] per block -> [B, Sp, H, hd]
    out = torch.stack(outs, 1).permute(0, 1, 4, 2, 3, 5).reshape(B, Sp, H, hd)
    return out[:, :S].to(v.dtype)


# ---------------------------------------- forward-attention dispatch ----
ATTN_BACKENDS = ("auto", "kernel", "online", "dense")

# below this the [S, S] score tile is small and the dense route's single
# fused matmul serves; at and above it the blockwise routes avoid the
# O(S^2) materialization that dominates forward memory (repro's threshold)
ATTN_AUTO_MIN_S = 256

# the online route's key block (the JAX package's ``ShardCtx.kv_block``)
ONLINE_KV_BLOCK = 512


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
                         differentiable: bool = False,
                         mesh: bool = False) -> str:
    """Map a requested forward-attention backend to 'kernel' | 'online' |
    'dense'.

    Explicit backends are honoured.  "auto" resolves to "dense" below
    ``ATTN_AUTO_MIN_S``; at and above it to "kernel" where the kernels take
    the head layout, whether or not autograd records (``differentiable``:
    the kernel route differentiates through the recompute backward
    kernels, whose saved state is O(S*dh)), and to "online" where they do
    not (TINY's head_dim 16, or G past the backward's tile under
    autograd).  Both the forward and the backward kernels take head_dim
    64, 128 and 256, so Gemma-2 (head_dim 256) takes the kernel under
    autograd too.

    Between the two rules, where the measured ``kernels.autotune`` table
    has the exact (op, S, head_dim, G, platform) key, "auto" takes the
    route it measured fastest ("kernel" or "online"), at the point where
    the JAX package consults its table: after the mesh and the
    ``ATTN_AUTO_MIN_S`` rules.  The op is "grad" when autograd records
    (``differentiable``), else "fwd".  Untuned keys keep the port's own
    rule above; the CPU's platform key is never measured, so a table
    tuned on the card changes no route on the CPU.  The JAX package's
    untuned rule differs: off the TPU, or for head dims off its 128-lane
    tile (Llama-3.2-1B's 64), it takes its ``online`` route; the port's
    kernels take head_dim 64 and 128 alike, so it takes the kernel there,
    and ``online`` only for the layouts the kernels do not take.

    Under a mesh (``mesh``: the tensor-parallel layout, DTensor operands)
    "auto" resolves as the JAX package resolves it: "dense" below
    ``ATTN_AUTO_MIN_S``, else "online".  An explicit "kernel" is honoured
    there too, on each rank's local heads (:func:`forward_attention`)."""
    backend = backend or "auto"
    if backend not in ATTN_BACKENDS:
        raise ValueError(
            f"attn backend must be one of {ATTN_BACKENDS}, got {backend!r}")
    if backend != "auto":
        return backend
    if mesh:
        return "dense" if S < ATTN_AUTO_MIN_S else "online"
    if S < ATTN_AUTO_MIN_S:
        return "dense"
    from repro_torch.kernels import autotune
    supported = kernel_supports(cfg, differentiable)
    route = autotune.fastest_route(
        S, cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads,
        op="grad" if differentiable else "fwd")
    if route == "online" or (route == "kernel" and supported):
        return route  # a "kernel" entry never names a layout it lacks
    return "kernel" if supported else "online"


def forward_attention(q, k, v, cfg, ctx=None, *, window: int = 0,
                      kv_mask=None, lengths=None):
    """Unified forward-attention entry: q [B,S,H,hd]; k,v [B,S,KV,hd] ->
    [B,S,H,hd], causal (optionally banded to ``window``), on the route
    ``ctx.attn_backend`` resolves to.

    Right-padded batches (prefill) give key validity as per-row ``lengths``
    [B] and/or ``kv_mask`` [B, 1, S], a valid prefix per row: the kernel
    route passes the lengths (or the mask's row sums) to the kernel, the
    online and dense routes mask the keys.  ``ctx.attn_q_block`` tiles
    the online route's queries (default min(128, S)) and chunks the dense
    route's scores where it divides S and is smaller
    (:func:`blocked_gqa_attention`); the kernel route ignores it, as the
    JAX package's Pallas route does.  The online route's key block is
    ``ONLINE_KV_BLOCK``.

    DTensor operands (the tensor-parallel layout) run every route on each
    rank's local heads (:func:`local_heads_attention`) wherever the model
    axis divides the query heads, so the explicit ``kernel`` route runs
    the flash kernel there; other head counts take the dense or online
    route through DTensor's own ops."""
    B, S = q.shape[:2]
    q_block = getattr(ctx, "attn_q_block", 0)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    sharded = is_dtensor(q)
    be = resolve_attn_backend(getattr(ctx, "attn_backend", None), cfg, S=S,
                              differentiable=grad, mesh=sharded)
    if sharded and q.device_mesh.ndim == 1 and \
            q.shape[2] % q.device_mesh.size() == 0:
        return local_heads_attention(
            q, k, v, lambda ql, kl, vl: _attention_route(
                be, ql, kl, vl, cfg, ctx, window, kv_mask, lengths, q_block))
    if be == "kernel" and sharded:
        raise ValueError("the kernel route under a mesh runs on local "
                         "heads: it needs the model axis to divide the "
                         f"query heads ({q.shape[2]})")
    return _attention_route(be, q, k, v, cfg, ctx, window, kv_mask, lengths,
                            q_block)


def _attention_route(be, q, k, v, cfg, ctx, window, kv_mask, lengths,
                     q_block):
    """:func:`forward_attention` on the resolved route ``be``."""
    B, S = q.shape[:2]
    if be == "kernel":
        from repro_torch.kernels.ops import flash_attention
        L = lengths
        if L is None and kv_mask is not None:
            L = kv_mask.reshape(B, S).sum(-1).to(torch.int32)
        out = flash_attention(q, k, v, L, window=window,
                              softcap=cfg.attn_softcap)
        return out.to(v.dtype)
    if be == "online":
        # a q tile of 128 keeps every score tile smaller than [S, S] at any
        # S the auto rule routes here (>= ATTN_AUTO_MIN_S)
        return online_gqa_attention(
            q, k, v, cfg, window=window, q_block=q_block or min(128, S),
            kv_block=min(ONLINE_KV_BLOCK, S), lengths=lengths,
            kv_mask=None if kv_mask is None else kv_mask.reshape(B, S))
    if kv_mask is None and lengths is not None:
        L = torch.as_tensor(lengths, device=q.device).reshape(-1).expand(B)
        kv_mask = (torch.arange(S, device=q.device)[None, :]
                   < L[:, None])[:, None, :]
    return blocked_gqa_attention(
        q, k, v, cfg, window=window, q_block=q_block,
        kv_mask=None if kv_mask is None else kv_mask.reshape(B, 1, S),
        ctx=ctx)


def local_heads_attention(q, k, v, fn):
    """Attention on each rank's local heads: q [B,S,H,hd] and k, v
    [B,S,KV,hd] are DTensors on the 1-D model sub-mesh, and ``fn(q, k, v)``
    any route on plain tensors (the flash kernel, row 3, or a plain
    route).  Megatron shards q/k/v over heads, so no head crosses a rank:
    rank r holds query heads [r H/tp, (r+1) H/tp) and takes the KV heads
    they read (its own shard where tp divides KV; where it does not, K/V
    are gathered once and the rank slices its group's heads).  Returns the
    DTensor [B,S,H,hd] sharded over heads."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    tp, r = mesh.size(), mesh.get_local_rank()
    h_loc = H // tp
    if KV % tp == 0:
        kv_pl, kv_sl = [Shard(2)], None
    elif h_loc % G == 0 or G % h_loc == 0:
        kv_pl = [Replicate()]
        k0 = r * h_loc // G
        kv_sl = slice(k0, k0 + max(1, h_loc // G))
    else:
        raise ValueError(f"{H} query heads over {KV} KV heads do not split "
                         f"into {tp} local groups")
    ql = q.redistribute(mesh, [Shard(2)]).to_local()
    kl = k.redistribute(mesh, kv_pl).to_local()
    vl = v.redistribute(mesh, kv_pl).to_local()
    if kv_sl is not None:
        kl, vl = kl[:, :, kv_sl], vl[:, :, kv_sl]
    out = fn(ql, kl, vl).contiguous()
    return DTensor.from_local(out, mesh, [Shard(2)], run_check=False,
                              shape=(B, S, H, hd),
                              stride=(S * H * hd, H * hd, hd, 1))


def self_attention(x, p, cfg, positions, *, local: bool, ctx=None):
    """Full training/prefill self-attention. x: [B,S,D] -> [B,S,D].  With
    ``ctx.attn_q_block`` set it is also the JAX package's
    ``self_attention_chunked`` (see :func:`forward_attention`)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg)
    q, k = rope(q, k, positions, cfg)
    window = cfg.sliding_window if local else 0
    out = forward_attention(q, k, v, cfg, ctx, window=window)
    return merge_heads(out, B, S, -1) @ p["wo"]


def bidir_attention(x, p, cfg):
    """Encoder (non-causal) self-attention. x: [B,S,D] -> [B,S,D]."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(x, p, cfg)
    return merge_heads(gqa_attention(q, k, v, None, cfg), B, S, -1) @ p["wo"]


def cross_attention(x, enc_kv, p, cfg):
    """Decoder cross-attention. x: [B,S,D]; enc_kv: (k, v) each
    [B,Senc,KV,hd] (:func:`encode_kv`) -> [B,S,D]."""
    B, S, _ = x.shape
    q = split_heads(x @ p["wq"], B, S, cfg.n_heads, cfg.resolved_head_dim)
    k, v = enc_kv
    return merge_heads(gqa_attention(q, k, v, None, cfg), B, S, -1) @ p["wo"]


def encode_kv(enc_out, p, cfg):
    """Cross-attention K/V [B,Senc,KV,hd] from the encoder output: computed
    once per request at prefill and kept in the decode cache."""
    B, Se, _ = enc_out.shape
    shape = (B, Se, cfg.n_kv_heads, cfg.resolved_head_dim)
    return (split_heads(enc_out @ p["wk"], *shape),
            split_heads(enc_out @ p["wv"], *shape))


# -------------------------------------------------- decode-mode attention ----
def grouped_gqa_attention(q, k, v, valid, cfg, ctx=None):
    """Decode attention with the query grouped per KV head, K/V never
    repeated (``repro.models.layers.grouped_gqa_attention``).

    q: [B,Sq,H,hd]; k,v: [B,W,KV,hd]; valid: [B|1,Sq,W] bool or None.
    Scores [B,KV,G,Sq,W] in f32 (then the softcap and ``valid``), the
    softmax weights cast to v's dtype for the value product, which sums in
    f32, as the JAX package's ``preferred_element_type`` does; out
    [B,Sq,H,hd] in v's dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k.float()) * (hd ** -0.5)
    scores = softcap(scores, cfg.attn_softcap)
    if valid is not None:
        scores = torch.where(valid[:, None, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, hd).to(v.dtype)


DECODE_BACKENDS = ("auto", "kernel", "ref")


def decode_kernel_supports(cfg) -> bool:
    """Whether the flash-decode kernel takes this head layout."""
    G = cfg.n_heads // cfg.n_kv_heads
    return cfg.resolved_head_dim in DECODE_HEAD_DIMS and G <= DECODE_MAX_G


def resolve_decode_backend(backend, cfg, mesh: bool = False) -> str:
    """Map a requested decode-attention backend to 'kernel' | 'ref'.

    Explicit backends are honoured; "auto" takes the flash-decode kernel
    whenever it takes the head layout, else its plain version.  This
    is the port's own rule and naming: the JAX package says "pallas" for
    the kernel and also sends a sharded mesh, or on a compiled TPU a
    head_dim off the 128-lane tile, to "ref"; the port's kernel takes
    head_dim 64, 128 and 256, and under a mesh (``mesh``: DTensor
    operands, the tensor-parallel layout) "auto" takes "ref", as JAX's."""
    backend = backend or "auto"
    if backend not in DECODE_BACKENDS:
        raise ValueError(
            f"decode backend must be one of {DECODE_BACKENDS}, got "
            f"{backend!r}")
    if backend != "auto":
        return backend
    if mesh:
        return "ref"
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
    q, k = rope(q, k, pos[:, None], cfg)
    rolling = bool(local and cfg.sliding_window)
    slot = torch.remainder(pos, W) if rolling else torch.clamp(pos, max=W - 1)
    k_new, v_new = k[:, 0].to(cache_k.dtype), v[:, 0].to(cache_v.dtype)
    if is_dtensor(cache_k):
        # a sharded cache (over KV heads, or over W under seq_shard) takes
        # the new row as an elementwise select, which DTensor computes on
        # each rank's shard with no index arithmetic
        hit = torch.arange(W, device=x1.device)[None, :] == slot[:, None]
        if active is not None:
            hit = hit & active.reshape(B, 1)
        hit = hit[:, :, None, None]
        cache_k.copy_(torch.where(hit, k_new[:, None], cache_k))
        cache_v.copy_(torch.where(hit, v_new[:, None], cache_v))
    else:
        rows = torch.arange(B, device=x1.device)
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
    qg = split_heads(q[:, 0], B, KV, cfg.n_heads // KV, hd)  # a view
    backend = resolve_decode_backend(getattr(ctx, "decode_backend", None),
                                     cfg, mesh=is_dtensor(q))
    if backend == "kernel":
        out = flash_decode(qg, cache_k, cache_v, lengths,
                           softcap=cfg.attn_softcap)
    elif is_dtensor(qg):
        out = _decode_ref(qg, cache_k, cache_v, lengths, cfg)
    else:
        # the JAX package's ref route: the live prefix as a [B, 1, W] mask
        valid = torch.arange(W, device=x1.device)[None, None, :] < \
            lengths[:, None, None]
        out = grouped_gqa_attention(q, cache_k, cache_v, valid, cfg, ctx)
    out = out.to(cache_v.dtype)
    return merge_heads(out, B, 1, -1) @ p["wo"], cache_k, cache_v


def _decode_ref(qg, cache_k, cache_v, lengths, cfg):
    """:func:`grouped_gqa_attention` over the live prefix for q [B, KV, G,
    hd] and the cache [B, W, KV, hd] as DTensors (the tensor-parallel
    layout, the sequence-sharded cache): on each rank's local KV heads
    where both are sharded over them on the model sub-mesh (a grouped
    einsum would fold the sharded heads into its batch, which DTensor
    refuses), else on the DTensors."""
    B, KV, G, hd = qg.shape
    W = cache_k.shape[1]
    valid = torch.arange(W, device=lengths.device)[None, None, :] < \
        lengths[:, None, None]
    if qg.device_mesh.ndim == 1 \
            and qg.placements[0].is_shard(1) \
            and cache_k.placements[0].is_shard(2):
        from torch.distributed.tensor import DTensor
        q = qg.to_local()
        out = grouped_gqa_attention(q.reshape(B, 1, -1, hd),
                                    cache_k.to_local(), cache_v.to_local(),
                                    valid, cfg)
        return DTensor.from_local(out.reshape(q.shape).contiguous(),
                                  qg.device_mesh, qg.placements,
                                  run_check=False, shape=qg.shape,
                                  stride=(KV * G * hd, G * hd, hd, 1))
    out = grouped_gqa_attention(qg.reshape(B, 1, KV * G, hd), cache_k,
                                cache_v, valid, cfg)
    return out.reshape(B, KV, G, hd)


# ------------------------------------------------------------------ MLP ----
def mlp(x, p, cfg):
    """Gated MLP act(x W1) * (x W3) W2, act = silu or tanh-gelu; or, with
    ``act="gelu_plain"``, the non-gated gelu(x W1) W2 (tanh-gelu, as
    ``jax.nn.gelu``'s default), which has no W3."""
    if cfg.act == "gelu_plain":
        return F.gelu(x @ p["w1"], approximate="tanh") @ p["w2"]
    h = F.silu(x @ p["w1"]) if cfg.act == "silu" \
        else F.gelu(x @ p["w1"], approximate="tanh")
    return (h * (x @ p["w3"])) @ p["w2"]
