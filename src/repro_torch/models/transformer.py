"""Model application of every architecture family: training forward and
the LM loss (``repro.models.transformer``).  The stacked layer periods run
in a Python loop (the JAX package scans them).  Whisper's encoder runs
first and each decoder layer cross-attends to it; Pixtral's patch
embeddings are prepended to the tokens and its logits cover the tokens
only."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.init import check_family
from repro_torch.utils.tree import tree_map


@dataclass(frozen=True)
class ModelCtx:
    """How model code routes its attention: the counterpart of repro's
    ``ShardCtx`` without the mesh fields.  A sharded round's ranks each
    compute unsharded on their own device (``sharding/fl.py``), so no
    route depends on a mesh (ROADMAP C20; the mesh fields come with the
    dry run, A item 8).

    ``attn_backend``: auto | kernel | online | dense
    (``layers.resolve_attn_backend``);
    ``attn_q_block``: 0 (whole-sequence attention), or the query block that
    tiles the online route and chunks the dense route's scores where it
    divides S and is smaller than S (``ShardCtx.attn_q_block``;
    ``layers.forward_attention``);
    ``decode_backend``: auto | kernel | ref, the one-token decode route
    (``layers.resolve_decode_backend``; ``ShardCtx.decode_backend``);
    ``mamba_mode``: auto | kernel | scan, the selective-scan route of the
    Mamba layers (``ssm.resolve_mamba_mode``; auto takes the kernel unless
    autograd records through the layer).  The scan route's chunk is
    ``mamba_forward``'s default of 64 positions (``ShardCtx.mamba_chunk``).
    """
    attn_backend: str = "auto"
    decode_backend: str = "auto"
    mamba_mode: str = "auto"
    attn_q_block: int = 0


DEFAULT_CTX = ModelCtx()


def _sinusoid(S: int, D: int, offset=0, device=None):
    """[..., S, D] f32 sinusoidal table; ``offset`` is a number or a per-row
    [B] tensor (continuous-batching decode, where every slot sits at its
    own absolute position)."""
    off = torch.as_tensor(offset, dtype=torch.float32, device=device)
    pos = torch.arange(S, dtype=torch.float32, device=device) + off[..., None]
    dim = torch.arange(0, D, 2, dtype=torch.float32, device=device)
    ang = pos[..., None] / torch.pow(10_000.0, dim / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[..., :D]


def _maybe_posenc(x, cfg: ModelConfig, offset=0):
    """Sinusoidal absolute positions for the RoPE-less encoder-decoder
    (Whisper); the other families take none."""
    if cfg.rope_style == "none" and (cfg.encoder is not None
                                     or cfg.frontend == "audio_stub"):
        pe = _sinusoid(x.shape[1], x.shape[2], offset, device=x.device)
        return x + pe.to(x.dtype)
    return x


def embed_tokens(params, tokens, cfg: ModelConfig):
    """Token embeddings [..., D], scaled by sqrt(d_model) where the config
    says so (Gemma)."""
    tok = params["embed"][tokens]
    if cfg.embed_scale:
        tok = tok * torch.tensor(cfg.d_model ** 0.5, dtype=tok.dtype,
                                 device=tok.device)
    return tok


def embed_input(params, batch, cfg: ModelConfig):
    """The input sequence [B, S_total, D]: the token embeddings, behind the
    patch embeddings (``batch["patch_embeds"]``) under ``vision_stub``."""
    tok = embed_tokens(params, batch["tokens"], cfg)
    if cfg.frontend == "vision_stub":
        return torch.cat([batch["patch_embeds"].to(tok.dtype), tok], dim=1)
    return tok


def unembed(x, params, cfg: ModelConfig):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.softcap((x @ head).float(), cfg.final_softcap)


def _mixer_fwd(x, lp, mixer, cfg, ctx, positions, enc_kv=None):
    h = L.apply_norm(x, lp["norm"], cfg.norm, cfg.norm_eps)
    if mixer == "mamba":
        y = SSM.mamba_forward(h, lp, cfg.ssm, mode=ctx.mamba_mode)
    elif mixer == "mlstm":
        y = XL.mlstm_forward(h, lp, cfg.xlstm)
    elif mixer == "slstm":
        y = XL.slstm_forward(h, lp, cfg.xlstm)
    else:
        y = L.self_attention(h, lp, cfg, positions,
                             local=mixer == "local_attn", ctx=ctx)
    if cfg.post_norms and "post_norm" in lp:
        y = L.apply_norm(y, lp["post_norm"], cfg.norm, cfg.norm_eps)
    x = x + y
    if enc_kv is not None and "cross" in lp:
        h = L.apply_norm(x, lp["cross"]["norm"], cfg.norm, cfg.norm_eps)
        x = x + L.cross_attention(h, enc_kv, lp["cross"], cfg)
    return x


def _ffn_fwd(x, lp, ffn, cfg, token_valid=None):
    """(x + FFN(x), the MoE layer's load-balance loss, or None for a dense
    FFN or none).  ``token_valid``: [B] or [B, S] bool, the serving mask
    that dispatches a MoE layer per row (``moe.moe_dense_ref``); training
    passes none."""
    if ffn == "none":
        return x, None
    h = L.apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps)
    aux = None
    if ffn == "moe":
        y, aux = MOE.moe_dense_ref(h, lp, cfg.moe, cfg.act, valid=token_valid)
    else:
        y = L.mlp(h, lp, cfg)
    if cfg.post_norms and "post_norm2" in lp:
        y = L.apply_norm(y, lp["post_norm2"], cfg.norm, cfg.norm_eps)
    return x + y, aux


def encoder_forward(params, audio_embeds, cfg: ModelConfig):
    """Whisper's encoder: frame embeddings [B, Senc, D] plus sinusoidal
    positions through bidirectional attention layers -> [B, Senc, D]."""
    enc = params["encoder"]
    x = audio_embeds + _sinusoid(audio_embeds.shape[1], cfg.d_model,
                                 device=audio_embeds.device).to(
                                     audio_embeds.dtype)
    for layer in range(cfg.encoder.n_layers):
        lp = tree_map(lambda a: a[layer], enc["stack"])["p0"]
        h = L.apply_norm(x, lp["norm"], cfg.norm, cfg.norm_eps)
        x = x + L.bidir_attention(h, lp, cfg)
        x, _ = _ffn_fwd(x, lp, "dense", cfg)
    return L.apply_norm(x, enc["final_norm"], cfg.norm, cfg.norm_eps)


def forward(params, batch, cfg: ModelConfig, ctx: ModelCtx = DEFAULT_CTX):
    """Training forward: returns (logits [B, S_tokens, V] f32, aux_loss),
    aux the sum of the MoE layers' load-balance losses."""
    check_family(cfg)
    x = _maybe_posenc(embed_input(params, batch, cfg), cfg)
    positions = torch.arange(x.shape[1], device=x.device).expand(
        x.shape[:2])
    enc_out = None
    if cfg.encoder is not None:
        enc_out = encoder_forward(params, batch["audio_embeds"].to(x.dtype),
                                  cfg)
    aux = torch.zeros((), device=x.device)
    for period in range(cfg.n_periods):
        pp = tree_map(lambda a: a[period], params["stack"])
        for i, (mixer, ffn) in enumerate(cfg.layer_pattern):
            lp = pp[f"p{i}"]
            kv = None
            if enc_out is not None and "cross" in lp:
                kv = L.encode_kv(enc_out, lp["cross"], cfg)
            x = _mixer_fwd(x, lp, mixer, cfg, ctx, positions, kv)
            x, a = _ffn_fwd(x, lp, ffn, cfg)
            if a is not None:
                aux = aux + a
    x = L.apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    logits = unembed(x, params, cfg)
    if cfg.frontend == "vision_stub":
        logits = logits[:, -batch["tokens"].shape[1]:]
    return logits, aux


def _logsumexp_last(x):
    """logsumexp over the last axis by the arithmetic of ``torch.logsumexp``
    (max, shifted exp, sum, log, add the max back), written out so that its
    [..., V] temporary is an op of its own that a recorder
    (``analysis/walk.py``) sees, and exponentiated in place, so there is
    one such temporary and not two.  The max is detached, as JAX's
    ``logsumexp`` stops its gradient."""
    m = x.detach().amax(-1, keepdim=True)
    return (x - m).exp_().sum(-1).log() + m[..., 0]


def lm_loss(params, batch, cfg: ModelConfig, ctx: ModelCtx = DEFAULT_CTX,
            aux_weight: float = 0.01, per_example: bool = False):
    """Next-token cross-entropy: the mean over examples of each example's
    mean over its positions, or with ``per_example`` the [B] per-example
    means (the per-client losses of ``core/fl_step``); the MoE aux term is
    added to each, as in the JAX package.  With ``batch["loss_mask"]``
    ([B, S]) an example's mean runs over the target positions its mask
    keeps (``mask[:, 1:]``), and an example that keeps none gets 0."""
    logits, aux = forward(params, batch, cfg, ctx)
    targets = batch["tokens"][:, 1:].long()
    lg = logits[:, :-1]
    nll = _logsumexp_last(lg) - torch.gather(
        lg, -1, targets[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask[:, 1:].float()
        per_ex = (nll * mask).sum(-1) / mask.sum(-1).clamp(min=1.0)
    else:
        per_ex = nll.mean(-1)
    if per_example:
        return per_ex + aux_weight * aux
    return per_ex.mean() + aux_weight * aux
