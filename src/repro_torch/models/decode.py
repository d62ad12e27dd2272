"""Serving-side model application: cache init, prefill, one-token decode
(``repro.models.decode``), for every architecture family.

Cache layout (leaves stacked over periods on axis 0, as in the JAX package):

* attn / local_attn: ``{'k','v': [n, B, W, KV, hd]}`` (W = min(S_max,
  window) for local layers), in the cache dtype
* mamba:             ``{'conv': [n,B,K-1,E]`` in the cache dtype,
  ``'state': [n,B,E,N]`` f32``}``
* mlstm:             ``{'C': [n,B,H,dh,dh], 'n': [n,B,H,dh], 'm': [n,B,H]}``
  f32 (``m`` starts at -1e30)
* slstm:             ``{'c','n','h','m': [n,B,E]}`` f32
* cross-attention (Whisper's decoder layers, beside 'k' and 'v'):
  ``{'ck','cv': [n,B,Senc,KV,hd]}``, filled at prefill from the encoder

``cache['pos']`` is a per-row [B] int32 vector: the number of positions each
sequence has absorbed (Pixtral's patch prefix included).  Rows are
independent: continuous-batching slots prefill and retire at different
positions, and ``decode_step(active=...)`` leaves the cache and position of
inactive rows bit for bit as they were.  MoE layers dispatch per row at
prefill (``token_valid`` = the right-pad mask) and at every decode step, so
co-batched requests never contend for expert capacity.

Unlike the JAX package's pure functions, :func:`decode_step` updates the
cache it is given in place and returns it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.init import check_family
from repro_torch.models.transformer import (DEFAULT_CTX, ModelCtx, _ffn_fwd,
                                            _maybe_posenc, embed_input,
                                            embed_tokens, encoder_forward,
                                            unembed)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import is_dtensor, tree_map

# the recurrent cache leaves of each mixer, in the order its decode
# function takes and returns them
_STATE_KEYS = {"mamba": ("conv", "state"), "mlstm": ("C", "n", "m"),
               "slstm": ("c", "n", "h", "m")}


def _window(cfg: ModelConfig, mixer: str, S_max: int) -> int:
    if mixer == "local_attn" and cfg.sliding_window:
        return min(S_max, cfg.sliding_window)
    return S_max


# --------------------------------------------------------------- init ------
def _mixer_cache(cfg: ModelConfig, mixer: str, n: int, B: int, S_max: int,
                 dtype, make):
    """The cache leaves of one pattern position, each ``make(name, shape,
    dtype, fill)``."""
    def zeros(name, *shape, dt=torch.float32):
        return make(name, shape, dt, 0.0)

    if mixer in ("attn", "local_attn"):
        W, KV, hd = (_window(cfg, mixer, S_max), cfg.n_kv_heads,
                     cfg.resolved_head_dim)
        c = {"k": zeros("k", n, B, W, KV, hd, dt=dtype),
             "v": zeros("v", n, B, W, KV, hd, dt=dtype)}
        if cfg.encoder is not None:
            Se = cfg.encoder.n_frames
            c["ck"] = zeros("ck", n, B, Se, KV, hd, dt=dtype)
            c["cv"] = zeros("cv", n, B, Se, KV, hd, dt=dtype)
        return c
    if mixer == "mamba":
        E = cfg.ssm.expand * cfg.d_model
        return {"conv": zeros("conv", n, B, cfg.ssm.d_conv - 1, E, dt=dtype),
                "state": zeros("state", n, B, E, cfg.ssm.d_state)}
    if mixer == "mlstm":
        H = cfg.xlstm.n_heads
        dh = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model) // H
        return {"C": zeros("C", n, B, H, dh, dh), "n": zeros("n", n, B, H, dh),
                "m": make("m", (n, B, H), torch.float32, -1e30)}
    if mixer == "slstm":
        return {k: zeros(k, n, B, cfg.d_model) for k in "cnhm"}
    raise ValueError(f"no cache for mixer {mixer!r}")


def init_cache(cfg: ModelConfig, B: int, S_max: int, dtype=torch.bfloat16,
               device=None, ctx: ModelCtx = DEFAULT_CTX):
    """Zero cache for ``B`` rows of capacity ``S_max`` on ``device`` (the
    CUDA card unless the caller says otherwise).  Under ``ctx``'s mesh
    (the tensor-parallel layout) each leaf is a DTensor placed per the
    sharding rules' ``cache_specs``, each rank allocating its shard only:
    over the model sub-mesh, or the whole mesh under ``ctx.seq_shard``
    (B=1 rows are the same on every rank, and the sequence splits over
    the batch axes)."""
    check_family(cfg)
    device = resolve_device(device)
    if ctx.mesh is None:
        def make(name, shape, dt, fill):
            return torch.full(shape, fill, dtype=dt, device=device)
    else:
        make = _sharded_maker(ctx, device)
    n = cfg.n_periods
    stack = {f"p{i}": _mixer_cache(cfg, mixer, n, B, S_max, dtype, make)
             for i, (mixer, _) in enumerate(cfg.layer_pattern)}
    return {"stack": stack,
            "pos": torch.zeros((B,), dtype=torch.int32, device=device)}


def abstract_cache(cfg: ModelConfig, B: int, S_max: int,
                   dtype=torch.bfloat16):
    """The cache's leaves on the meta device: shapes and dtypes, no bytes
    (``repro.models.decode.abstract_cache``)."""
    return init_cache(cfg, B, S_max, dtype, device="meta")


def _sharded_maker(ctx: ModelCtx, device):
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding.fl import compute_placements, local_shape
    from repro_torch.sharding.rules import _cache_leaf_spec
    mc = ctx.mesh_cfg

    def make(name, shape, dt, fill):
        spec = _cache_leaf_spec(f"['{name}']", tuple(shape), mc,
                                ctx.seq_shard)
        mesh, pl = compute_placements(ctx.mesh, spec, ctx.seq_shard)
        local = torch.full(local_shape(shape, mesh, pl), fill, dtype=dt,
                           device=device)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))
    return make


def _contiguous_stride(shape):
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


# -------------------------------------------------------------- decode -----
def _write_rows(dst, new, act):
    """dst <- new in place; rows where ``act`` ([B] bool, None = all) is
    False keep dst's bits."""
    if act is not None:
        new = torch.where(act.reshape((-1,) + (1,) * (new.ndim - 1)), new,
                          dst)
    dst.copy_(new)


def _recurrent_decode(mixer, h, lp, cfg, states):
    """One token through a recurrent mixer: (y, *new states)."""
    if mixer == "mamba":
        return SSM.mamba_decode(h, lp, cfg.ssm, *states)
    if mixer == "mlstm":
        return XL.mlstm_decode(h, lp, cfg.xlstm, *states)
    return XL.slstm_decode(h, lp, cfg.xlstm, *states)


def decode_step(params, token, cache, cfg: ModelConfig,
                ctx: ModelCtx = DEFAULT_CTX, active=None):
    """token: [B] int -> (logits [B, V] f32, cache), the cache updated in
    place.

    ``active``: optional [B] bool.  Inactive rows (drained or empty
    continuous-batching slots) keep their cache, every recurrent state
    included, and their position bit for bit; their logits are not
    meaningful and callers ignore them.  Parameters and cache may be
    DTensors (the tensor-parallel layout, ``ModelCtx``; a cache from
    :func:`prefill` or :func:`init_cache` under it)."""
    check_family(cfg)
    with ctx.region(params):
        return _decode_step(params, token, cache, cfg, ctx, active)


def _decode_step(params, token, cache, cfg, ctx, active):
    B = token.shape[0]
    x = embed_tokens(params, token, cfg)[:, None]  # [B,1,D]
    cur = cache["pos"]
    x = _maybe_posenc(x, cfg, offset=cur)
    act = None if active is None else torch.as_tensor(
        active, device=x.device).to(torch.bool).reshape(B)
    # decode rows are independent requests: a MoE layer always dispatches
    # per row (its own capacity pool), or co-batched requests would contend
    # for expert capacity and batched decode would diverge from single
    valid = act if act is not None else torch.ones(
        (B,), dtype=torch.bool, device=x.device)
    for period in range(cfg.n_periods):
        pp = tree_map(lambda a: a[period], params["stack"])
        for i, (mixer, ffn) in enumerate(cfg.layer_pattern):
            lp, cc = pp[f"p{i}"], cache["stack"][f"p{i}"]
            h = L.apply_norm(x, lp["norm"], cfg.norm, cfg.norm_eps)
            if mixer in ("attn", "local_attn"):
                y, _, _ = L.decode_self_attention(
                    h, lp, cfg, cc["k"][period], cc["v"][period], cur,
                    local=mixer == "local_attn", ctx=ctx, active=act)
            else:
                keys = _STATE_KEYS[mixer]
                y, *new = _recurrent_decode(mixer, h, lp, cfg,
                                            [cc[k][period] for k in keys])
                for k, t in zip(keys, new):
                    _write_rows(cc[k][period], t, act)
            if cfg.post_norms and "post_norm" in lp:
                y = L.apply_norm(y, lp["post_norm"], cfg.norm, cfg.norm_eps)
            x = x + L.replicated(y)
            if "cross" in lp and "ck" in cc:
                h = L.apply_norm(x, lp["cross"]["norm"], cfg.norm,
                                 cfg.norm_eps)
                x = x + L.replicated(L.cross_attention(
                    h, (cc["ck"][period], cc["cv"][period]), lp["cross"],
                    cfg))
            x, _ = _ffn_fwd(x, lp, ffn, cfg, token_valid=valid, ctx=ctx)
    x = L.apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    logits = unembed(x, params, cfg)[:, 0]
    if is_dtensor(logits):
        logits = logits.full_tensor()
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
    if S <= W and is_dtensor(dst_k):
        # a sharded cache (its W split under seq_shard) takes the prompt
        # padded to W as one whole-buffer copy DTensor can place
        pad = (0, 0, 0, 0, 0, W - S)
        dst_k.copy_(torch.nn.functional.pad(k.to(dst_k.dtype), pad))
        dst_v.copy_(torch.nn.functional.pad(v.to(dst_v.dtype), pad))
        return
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

    ``lengths``: per-row [B] valid *token* counts of a right-padded batch.
    Positions stay ``arange(S)``; pad keys are masked out of attention, the
    recurrent mixers freeze their state past each row's length (the
    selective scan's dt is zeroed there, so its final state is the decode
    state), MoE layers dispatch per row over the real tokens only, and the
    logits and the cache position are taken at each row's last real token,
    so a padded batched prefill equals prefilling each row alone at its
    exact length.  A frontend prefix (Pixtral's patches) is always real and
    counts in the positions.  ``None`` means every position is real.

    Under ``ctx``'s mesh (the tensor-parallel layout, DTensor parameters)
    the cache comes back placed per the sharding rules' ``cache_specs``
    (:func:`init_cache`)."""
    check_family(cfg)
    with ctx.region(params):
        return _prefill(params, batch, cfg, ctx, S_max, lengths)


def _prefill(params, batch, cfg, ctx, S_max, lengths):
    x = _maybe_posenc(embed_input(params, batch, cfg), cfg)
    B, S = x.shape[:2]
    dev = x.device
    S_max = S_max or S
    positions = torch.arange(S, device=dev).expand(B, S)
    if lengths is None:
        lengths_total = torch.full((B,), S, dtype=torch.int32, device=dev)
        valid = kv_mask = None
    else:
        extra = S - batch["tokens"].shape[1]
        lengths_total = (torch.as_tensor(lengths, device=dev).to(
            torch.int32).reshape(-1).expand(B) + extra).contiguous()
        valid = torch.arange(S, device=dev)[None, :] < lengths_total[:, None]
        kv_mask = valid[:, None, :]
    enc_out = None
    if cfg.encoder is not None:
        enc_out = encoder_forward(params, batch["audio_embeds"].to(x.dtype),
                                  cfg)
    cache = init_cache(cfg, B, S_max, dtype=params["embed"].dtype,
                       device=dev, ctx=ctx)
    for period in range(cfg.n_periods):
        pp = tree_map(lambda a: a[period], params["stack"])
        for i, (mixer, ffn) in enumerate(cfg.layer_pattern):
            lp, cc = pp[f"p{i}"], cache["stack"][f"p{i}"]
            h = L.apply_norm(x, lp["norm"], cfg.norm, cfg.norm_eps)
            if mixer in ("attn", "local_attn"):
                q, k, v = L._project_qkv(h, lp, cfg)
                q, k = L.rope(q, k, positions, cfg)
                local = mixer == "local_attn"
                y = L.forward_attention(
                    q, k, v, cfg, ctx,
                    window=cfg.sliding_window if local else 0,
                    kv_mask=kv_mask,
                    lengths=None if valid is None else lengths_total)
                y = L.merge_heads(y, B, S, -1) @ lp["wo"]
                _fill_attn_cache(cc["k"][period], cc["v"][period], k, v,
                                 None if valid is None else lengths_total)
            else:
                if mixer == "mamba":
                    y, state = SSM.mamba_forward(
                        h, lp, cfg.ssm, chunk=ctx.mamba_chunk,
                        mode=ctx.mamba_mode, return_state=True, valid=valid)
                elif mixer == "mlstm":
                    y, state = XL.mlstm_forward(
                        h, lp, cfg.xlstm, return_state=True, valid=valid,
                        ctx=ctx)
                else:
                    y, state = XL.slstm_forward(h, lp, cfg.xlstm,
                                                return_state=True,
                                                valid=valid)
                for key, t in zip(_STATE_KEYS[mixer], state):
                    cc[key][period].copy_(t)
            if cfg.post_norms and "post_norm" in lp:
                y = L.apply_norm(y, lp["post_norm"], cfg.norm, cfg.norm_eps)
            x = x + L.replicated(y)
            if enc_out is not None and "cross" in lp:
                kv = L.encode_kv(enc_out, lp["cross"], cfg)
                cc["ck"][period].copy_(kv[0])
                cc["cv"][period].copy_(kv[1])
                h = L.apply_norm(x, lp["cross"]["norm"], cfg.norm,
                                 cfg.norm_eps)
                x = x + L.replicated(L.cross_attention(h, kv, lp["cross"],
                                                       cfg))
            # pad tokens stay out of MoE capacity dispatch, or they would
            # evict real tokens' expert assignments
            x, _ = _ffn_fwd(x, lp, ffn, cfg, token_valid=valid, ctx=ctx)
    # the final norm is per position: take it at the last real tokens only
    last = x[torch.arange(B, device=dev), lengths_total.long() - 1][:, None]
    last = L.apply_norm(last, params["final_norm"], cfg.norm, cfg.norm_eps)
    logits = unembed(last, params, cfg)[:, 0]
    if is_dtensor(logits):
        logits = logits.full_tensor()
    cache["pos"] = lengths_total
    return logits, cache

