"""Parameter initialization for the dense decoder family
(``repro.models.init``).

Layer parameters are *stacked over periods*: for each position ``i`` in
``cfg.layer_pattern`` the subtree ``stack['p{i}']`` has a leading
``n_periods`` axis.  Draws come from a seeded ``torch.Generator`` on the
target device, in the JAX package's order; they are not JAX's numbers (tests
that compare the two packages convert JAX's parameters instead,
``convert.params_from_numpy``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig

_MIXERS = ("attn", "local_attn")


class _Init:
    """Leaf factory: seeded normals on ``device``, or empty tensors on the
    ``meta`` device (shapes only, for counting)."""

    def __init__(self, seed: int, device, dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = None
        if self.device.type != "meta":
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(int(seed))

    def dense(self, shape, std=0.02, n=None):
        shape = (n, *shape) if n else tuple(shape)
        if self.gen is None:
            return torch.empty(shape, dtype=self.dtype, device=self.device)
        w = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return (w * std).to(self.dtype)

    def full(self, shape, value: float):
        return torch.full(tuple(shape), value, dtype=self.dtype,
                          device=self.device)


def _norm_p(ini, d, n=None):
    return {"scale": ini.full((n, d) if n else (d,), 0.0)}  # RMSNorm 1+s


def _attn_params(ini, cfg: ModelConfig, n: int):
    D = cfg.d_model
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    out_std = 0.02 / math.sqrt(2 * cfg.n_layers)
    p = {
        "norm": _norm_p(ini, D, n),
        "wq": ini.dense((D, H * hd), n=n),
        "wk": ini.dense((D, KV * hd), n=n),
        "wv": ini.dense((D, KV * hd), n=n),
        "wo": ini.dense((H * hd, D), std=out_std, n=n),
    }
    if cfg.qkv_bias:
        p["bq"] = ini.full((n, H * hd), 0.0)
        p["bk"] = ini.full((n, KV * hd), 0.0)
        p["bv"] = ini.full((n, KV * hd), 0.0)
    if cfg.post_norms:
        p["post_norm"] = _norm_p(ini, D, n)
    return p


def _mlp_params(ini, cfg: ModelConfig, n: int):
    D, F = cfg.d_model, cfg.d_ff
    out_std = 0.02 / math.sqrt(2 * cfg.n_layers)
    p = {
        "norm2": _norm_p(ini, D, n),
        "w1": ini.dense((D, F), n=n),
        "w2": ini.dense((F, D), std=out_std, n=n),
        "w3": ini.dense((D, F), n=n),
    }
    if cfg.post_norms:
        p["post_norm2"] = _norm_p(ini, D, n)
    return p


def check_dense_family(cfg: ModelConfig) -> None:
    """The port so far covers decoder-only attention + gated dense-MLP
    stacks with RMSNorm and full RoPE (the paper's models); the other
    families and options of ``repro`` raise until they are ported."""
    bad = [(m, f) for m, f in cfg.layer_pattern
           if m not in _MIXERS or f != "dense"]
    if (bad or cfg.encoder is not None or cfg.frontend != "none"
            or cfg.norm != "rmsnorm" or cfg.rope_style != "full"
            or cfg.act not in ("silu", "gelu") or cfg.qk_norm
            or cfg.lora_rank):
        raise NotImplementedError(
            f"{cfg.name}: the port covers the dense decoder family with "
            f"RMSNorm, full RoPE and gated silu/gelu MLPs only")


def init_params(seed: int, cfg: ModelConfig, dtype=torch.float32,
                device="cpu"):
    """Initialize the full parameter dict for ``cfg`` on ``device``."""
    check_dense_family(cfg)
    ini = _Init(seed, device, dtype)
    params = {"embed": ini.dense((cfg.vocab, cfg.d_model))}
    stack = {}
    for i in range(len(cfg.layer_pattern)):
        lp = _attn_params(ini, cfg, cfg.n_periods)
        lp.update(_mlp_params(ini, cfg, cfg.n_periods))
        stack[f"p{i}"] = lp
    params["stack"] = stack
    params["final_norm"] = _norm_p(ini, cfg.d_model)
    if not cfg.tie_embeddings:
        params["lm_head"] = ini.dense((cfg.d_model, cfg.vocab))
    return params


def param_count(cfg: ModelConfig) -> int:
    from repro_torch.utils.tree import tree_leaves
    tree = init_params(0, cfg, device="meta")
    return int(sum(t.numel() for t in tree_leaves(tree)))
