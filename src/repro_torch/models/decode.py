"""Serving-side model application: cache init, prefill, one-token decode
(``repro.models.decode``), for the attention-cache families.

Cache layout (leaves stacked over periods on axis 0, as in the JAX package):

* attn / local_attn: ``{'k','v': [n, B, W, KV, hd]}`` (W = min(S_max,
  window) for local layers)

``cache['pos']`` is a per-row [B] int32 vector: the number of tokens each
sequence has absorbed.  Rows are independent: continuous-batching slots
prefill and retire at different positions, and ``decode_step(active=...)``
leaves the cache and position of inactive rows as they were.

The Mamba, mLSTM, sLSTM and cross-attention caches of the JAX package, and
MoE layers at decode time, raise ``NotImplementedError`` until their
serving is ported.

Unlike the JAX package's pure functions, :func:`decode_step` updates the
cache it is given in place and returns it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.init import check_family
from repro_torch.models.transformer import (DEFAULT_CTX, ModelCtx, _ffn_fwd,
                                            embed_input, unembed)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_map


def _window(cfg: ModelConfig, mixer: str, S_max: int) -> int:
    if mixer == "local_attn" and cfg.sliding_window:
        return min(S_max, cfg.sliding_window)
    return S_max


def _check_family(cfg: ModelConfig) -> None:
    if cfg.encoder is not None or cfg.rope_style == "none" or any(
            m not in ("attn", "local_attn") or f != "dense"
            for m, f in cfg.layer_pattern):
        raise NotImplementedError(
            f"{cfg.name}: the port serves attention layers with dense FFNs "
            f"and RoPE only; the Mamba and MoE layers of the hybrid family "
            f"(mamba caches, mamba_decode, per-row MoE dispatch) come with "
            f"hybrid serving in a later slice, the mlstm, slstm and "
            f"cross-attention caches with their families")
    check_family(cfg)


# --------------------------------------------------------------- init ------
def init_cache(cfg: ModelConfig, B: int, S_max: int, dtype=torch.bfloat16,
               device=None):
    """Zero cache for ``B`` rows of capacity ``S_max`` on ``device`` (the
    CUDA card unless the caller says otherwise)."""
    _check_family(cfg)
    device = resolve_device(device)
    n, KV, hd = cfg.n_periods, cfg.n_kv_heads, cfg.resolved_head_dim
    stack = {}
    for i, (mixer, _) in enumerate(cfg.layer_pattern):
        W = _window(cfg, mixer, S_max)
        stack[f"p{i}"] = {
            "k": torch.zeros((n, B, W, KV, hd), dtype=dtype, device=device),
            "v": torch.zeros((n, B, W, KV, hd), dtype=dtype, device=device)}
    return {"stack": stack,
            "pos": torch.zeros((B,), dtype=torch.int32, device=device)}


# -------------------------------------------------------------- decode -----
def decode_step(params, token, cache, cfg: ModelConfig,
                ctx: ModelCtx = DEFAULT_CTX, active=None):
    """token: [B] int -> (logits [B, V] f32, cache), the cache updated in
    place.

    ``active``: optional [B] bool.  Inactive rows (drained or empty
    continuous-batching slots) keep their cache and position; their logits
    are not meaningful and callers ignore them."""
    _check_family(cfg)
    B = token.shape[0]
    x = embed_input(params, {"tokens": token[:, None]}, cfg)  # [B,1,D]
    cur = cache["pos"]
    act = None if active is None else torch.as_tensor(
        active, device=x.device).to(torch.bool).reshape(B)
    for period in range(cfg.n_periods):
        pp = tree_map(lambda a: a[period], params["stack"])
        for i, (mixer, _) in enumerate(cfg.layer_pattern):
            lp, cc = pp[f"p{i}"], cache["stack"][f"p{i}"]
            h = L.apply_norm(x, lp["norm"], cfg.norm, cfg.norm_eps)
            y, _, _ = L.decode_self_attention(
                h, lp, cfg, cc["k"][period], cc["v"][period], cur,
                local=mixer == "local_attn", ctx=ctx, active=act)
            if cfg.post_norms and "post_norm" in lp:
                y = L.apply_norm(y, lp["post_norm"], cfg.norm, cfg.norm_eps)
            x, _ = _ffn_fwd(x + y, lp, "dense", cfg)
    x = L.apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    logits = unembed(x, params, cfg)[:, 0]
    cache["pos"] = cur + (1 if act is None else act.to(torch.int32))
    return logits, cache


# ------------------------------------------------------------- prefill -----
def _fill_attn_cache(dst_k, dst_v, k, v, lengths=None):
    """Write a prompt's k, v [B, S, KV, hd] into zeroed cache rows
    dst_k, dst_v [B, W, KV, hd], in place.

    With S <= W the keys sit at their positions.  Otherwise the buffer is
    rolling: each row is aligned to *its own* position stream, slot j
    holding the key at absolute position p with p % W == j and p in
    [max(0, len - W), len), exactly where ``decode_self_attention`` reads
    and writes next (``lengths``: per-row valid lengths; None = S)."""
    B, S = k.shape[:2]
    W = dst_k.shape[1]
    if S <= W:
        dst_k[:, :S] = k
        dst_v[:, :S] = v
        return
    j = torch.arange(W, device=k.device)[None, :]
    if lengths is None:
        start = torch.full((B, 1), S - W, dtype=torch.long, device=k.device)
    else:
        start = torch.clamp(lengths.long()[:, None] - W, min=0)
    p = start + torch.remainder(j - start, W)
    p = torch.clamp(p, max=S - 1)  # rows with len < S: pad entries, masked
    idx = p[:, :, None, None].expand(B, W, *k.shape[2:])
    dst_k.copy_(torch.gather(k, 1, idx))
    dst_v.copy_(torch.gather(v, 1, idx))


def prefill(params, batch, cfg: ModelConfig, ctx: ModelCtx = DEFAULT_CTX,
            S_max: int = 0, lengths=None):
    """Process the prompt; returns (logits [B, V] at each row's last real
    token, cache of capacity ``S_max``).

    ``lengths``: per-row [B] valid token counts of a right-padded batch.
    Positions stay ``arange(S)``; pad keys are masked out of attention, and
    the logits and the cache position are taken at each row's last real
    token, so a padded batched prefill equals prefilling each row alone at
    its exact length.  ``None`` means every position is real."""
    _check_family(cfg)
    x = embed_input(params, batch, cfg)
    B, S = x.shape[:2]
    dev = x.device
    S_max = S_max or S
    positions = torch.arange(S, device=dev).expand(B, S)
    if lengths is None:
        lengths_total = torch.full((B,), S, dtype=torch.int32, device=dev)
        kv_mask = None
    else:
        lengths_total = torch.as_tensor(lengths, device=dev).to(
            torch.int32).reshape(-1).expand(B).contiguous()
        kv_mask = (torch.arange(S, device=dev)[None, :]
                   < lengths_total[:, None])[:, None, :]
    cache = init_cache(cfg, B, S_max, dtype=params["embed"].dtype,
                       device=dev)
    for period in range(cfg.n_periods):
        pp = tree_map(lambda a: a[period], params["stack"])
        for i, (mixer, _) in enumerate(cfg.layer_pattern):
            lp, cc = pp[f"p{i}"], cache["stack"][f"p{i}"]
            h = L.apply_norm(x, lp["norm"], cfg.norm, cfg.norm_eps)
            q, k, v = L._project_qkv(h, lp, cfg)
            q, k = L.rope(q, k, positions, cfg)
            local = mixer == "local_attn"
            y = L.forward_attention(
                q, k, v, cfg, ctx, window=cfg.sliding_window if local else 0,
                kv_mask=kv_mask,
                lengths=None if kv_mask is None else lengths_total)
            y = y.reshape(B, S, -1) @ lp["wo"]
            _fill_attn_cache(cc["k"][period], cc["v"][period], k, v,
                             None if kv_mask is None else lengths_total)
            if cfg.post_norms and "post_norm" in lp:
                y = L.apply_norm(y, lp["post_norm"], cfg.norm, cfg.norm_eps)
            x, _ = _ffn_fwd(x + y, lp, "dense", cfg)
    # the final norm is per position: take it at the last real tokens only
    last = x[torch.arange(B, device=dev), lengths_total.long() - 1][:, None]
    last = L.apply_norm(last, params["final_norm"], cfg.norm, cfg.norm_eps)
    logits = unembed(last, params, cfg)[:, 0]
    cache["pos"] = lengths_total
    return logits, cache
