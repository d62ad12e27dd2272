"""Model application of the dense decoder family: training forward and the
LM loss (``repro.models.transformer``).  The stacked layer periods run in a
Python loop (the JAX package scans them)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.init import check_dense_family
from repro_torch.utils.tree import tree_map


@dataclass(frozen=True)
class ModelCtx:
    """How model code routes its attention: the counterpart of repro's
    ``ShardCtx`` without the mesh fields (the port runs on one device).

    ``attn_backend``: auto | kernel | dense (``layers.resolve_attn_backend``).
    """
    attn_backend: str = "auto"


DEFAULT_CTX = ModelCtx()


def embed_input(params, batch, cfg: ModelConfig):
    tok = params["embed"][batch["tokens"]]
    if cfg.embed_scale:
        tok = tok * torch.tensor(cfg.d_model ** 0.5, dtype=tok.dtype,
                                 device=tok.device)
    return tok


def unembed(x, params, cfg: ModelConfig):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.softcap((x @ head).float(), cfg.final_softcap)


def _mixer_fwd(x, lp, mixer, cfg, ctx, positions):
    h = L.rmsnorm(x, lp["norm"]["scale"], cfg.norm_eps)
    y = L.self_attention(h, lp, cfg, positions, local=mixer == "local_attn",
                         ctx=ctx)
    if cfg.post_norms and "post_norm" in lp:
        y = L.rmsnorm(y, lp["post_norm"]["scale"], cfg.norm_eps)
    return x + y


def _ffn_fwd(x, lp, cfg):
    h = L.rmsnorm(x, lp["norm2"]["scale"], cfg.norm_eps)
    y = L.mlp(h, lp, cfg)
    if cfg.post_norms and "post_norm2" in lp:
        y = L.rmsnorm(y, lp["post_norm2"]["scale"], cfg.norm_eps)
    return x + y


def forward(params, batch, cfg: ModelConfig, ctx: ModelCtx = DEFAULT_CTX):
    """Training forward: returns (logits [B, S, V] f32, aux_loss)."""
    check_dense_family(cfg)
    x = embed_input(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device).expand(
        x.shape[:2])
    for period in range(cfg.n_periods):
        pp = tree_map(lambda a: a[period], params["stack"])
        for i, (mixer, _) in enumerate(cfg.layer_pattern):
            x = _mixer_fwd(x, pp[f"p{i}"], mixer, cfg, ctx, positions)
            x = _ffn_fwd(x, pp[f"p{i}"], cfg)
    x = L.rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(x, params, cfg), torch.zeros((), device=x.device)


def lm_loss(params, batch, cfg: ModelConfig, ctx: ModelCtx = DEFAULT_CTX,
            aux_weight: float = 0.01):
    """Next-token cross-entropy, mean over positions and examples."""
    logits, aux = forward(params, batch, cfg, ctx)
    targets = batch["tokens"][:, 1:].long()
    lg = logits[:, :-1]
    nll = torch.logsumexp(lg, dim=-1) - torch.gather(
        lg, -1, targets[..., None])[..., 0]
    return nll.mean(-1).mean() + aux_weight * aux
