"""Parameter initialization for every architecture family
(``repro.models.init``): attention, Mamba, mLSTM and sLSTM mixers; dense,
MoE or no FFNs; Whisper's encoder and its decoder's cross-attention.

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
from repro_torch.models.ssm import _dt_rank
from repro_torch.utils.device import resolve_device

_MIXERS = ("attn", "local_attn", "mamba", "mlstm", "slstm")
_FFNS = ("dense", "moe", "none")
_FRONTENDS = ("none", "audio_stub", "vision_stub")


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


def _norm_p(ini, cfg, d, n=None):
    """RMSNorm: scale 0 (it multiplies by 1 + scale); LayerNorm: scale 1
    and bias 0."""
    shape = (n, d) if n else (d,)
    if cfg.norm == "rmsnorm":
        return {"scale": ini.full(shape, 0.0)}
    return {"scale": ini.full(shape, 1.0), "bias": ini.full(shape, 0.0)}


def _attn_params(ini, cfg: ModelConfig, n: int, cross: bool = False):
    """Self-attention; ``cross``: the decoder's cross-attention, plain
    projections only (no bias, qk-norm, post-norm or LoRA)."""
    D = cfg.d_model
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    out_std = 0.02 / math.sqrt(2 * cfg.n_layers)
    p = {
        "norm": _norm_p(ini, cfg, D, n),
        "wq": ini.dense((D, H * hd), n=n),
        "wk": ini.dense((D, KV * hd), n=n),
        "wv": ini.dense((D, KV * hd), n=n),
        "wo": ini.dense((H * hd, D), std=out_std, n=n),
    }
    if cross:
        return p
    if cfg.qkv_bias:
        p["bq"] = ini.full((n, H * hd), 0.0)
        p["bk"] = ini.full((n, KV * hd), 0.0)
        p["bv"] = ini.full((n, KV * hd), 0.0)
    if cfg.qk_norm:
        p["q_norm"] = ini.full((n, hd), 0.0)
        p["k_norm"] = ini.full((n, hd), 0.0)
    if cfg.post_norms:
        p["post_norm"] = _norm_p(ini, cfg, D, n)
    if cfg.lora_rank:
        # drawn after wo, in the JAX package's order; the B factors are
        # zero, so a fresh adapter leaves the model's function unchanged
        r = cfg.lora_rank
        p["lora_qa"] = ini.dense((D, r), n=n)
        p["lora_qb"] = ini.full((n, r, H * hd), 0.0)
        p["lora_va"] = ini.dense((D, r), n=n)
        p["lora_vb"] = ini.full((n, r, KV * hd), 0.0)
    return p


def _mlp_params(ini, cfg: ModelConfig, n: int):
    D, F = cfg.d_model, cfg.d_ff
    out_std = 0.02 / math.sqrt(2 * cfg.n_layers)
    p = {
        "norm2": _norm_p(ini, cfg, D, n),
        "w1": ini.dense((D, F), n=n),
        "w2": ini.dense((F, D), std=out_std, n=n),
    }
    if cfg.act != "gelu_plain":  # the plain MLP is not gated
        p["w3"] = ini.dense((D, F), n=n)
    if cfg.post_norms:
        p["post_norm2"] = _norm_p(ini, cfg, D, n)
    return p


def _moe_params(ini, cfg: ModelConfig, n: int):
    m = cfg.moe
    D, F, E = cfg.d_model, m.d_ff_expert, m.n_experts
    out_std = 0.02 / math.sqrt(2 * cfg.n_layers)
    p = {
        "norm2": _norm_p(ini, cfg, D, n),
        "router": ini.dense((D, E), n=n),
        "w1": ini.dense((E, D, F), n=n),
        "w3": ini.dense((E, D, F), n=n),
        "w2": ini.dense((E, F, D), std=out_std, n=n),
    }
    if m.n_shared_experts:
        Fs = F * m.n_shared_experts
        p["sw1"] = ini.dense((D, Fs), n=n)
        p["sw3"] = ini.dense((D, Fs), n=n)
        p["sw2"] = ini.dense((Fs, D), std=out_std, n=n)
    return p


def _mamba_params(ini, cfg: ModelConfig, n: int):
    s = cfg.ssm
    D = cfg.d_model
    E = s.expand * D
    N = s.d_state
    r = _dt_rank(D, s)
    out_std = 0.02 / math.sqrt(2 * cfg.n_layers)
    dev = ini.device
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(E, N)
    dt_bias = torch.log(torch.expm1(torch.full((E,), 0.01, device=dev)))
    return {
        "norm": _norm_p(ini, cfg, D, n),
        "in_proj": ini.dense((D, 2 * E), n=n),
        "conv_w": ini.dense((s.d_conv, E), std=0.2, n=n),
        "conv_b": ini.full((n, E), 0.0),
        "x_proj": ini.dense((E, r + 2 * N), n=n),
        "dt_proj": ini.dense((r, E), std=r ** -0.5, n=n),
        "dt_bias": dt_bias.expand(n, E).to(ini.dtype).contiguous(),
        "A_log": torch.log(A).expand(n, E, N).to(ini.dtype).contiguous(),
        "D": ini.full((n, E), 1.0),
        "out_proj": ini.dense((E, D), std=out_std, n=n),
    }


def _mlstm_params(ini, cfg: ModelConfig, n: int):
    x = cfg.xlstm
    D = cfg.d_model
    E = int(x.proj_factor_mlstm * D)
    H = x.n_heads
    out_std = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "norm": _norm_p(ini, cfg, D, n),
        "up_proj": ini.dense((D, 2 * E), n=n),
        "wq": ini.dense((E, E), n=n),
        "wk": ini.dense((E, E), n=n),
        "wv": ini.dense((E, E), n=n),
        "w_i": ini.dense((E, H), std=0.01, n=n),
        "b_i": ini.full((n, H), 0.0),
        "w_f": ini.dense((E, H), std=0.01, n=n),
        "b_f": ini.full((n, H), 3.0),  # forget-gate bias: remember
        "gn_scale": ini.full((n, H, E // H), 1.0),
        "down_proj": ini.dense((E, D), std=out_std, n=n),
    }


def _slstm_params(ini, cfg: ModelConfig, n: int):
    x = cfg.xlstm
    D = E = cfg.d_model
    H = x.n_heads
    dh = E // H
    F = int(x.proj_factor_slstm * E)
    F -= F % 2
    out_std = 0.02 / math.sqrt(2 * cfg.n_layers)
    b = ini.full((n, 4 * E), 0.0)
    b[:, E:2 * E] = 3.0  # forget-gate bias; gates are (i, f, z, o)
    return {
        "norm": _norm_p(ini, cfg, D, n),
        "w_gates": ini.dense((D, 4 * E), n=n),
        "b_gates": b,
        "r_gates": ini.dense((H, dh, 4, dh), std=dh ** -0.5, n=n),
        "up_proj": ini.dense((E, 2 * F), n=n),
        "down_proj": ini.dense((F, D), std=out_std, n=n),
    }


_MIXER_PARAMS = {"attn": _attn_params, "local_attn": _attn_params,
                 "mamba": _mamba_params, "mlstm": _mlstm_params,
                 "slstm": _slstm_params}


def _stack_params(ini, cfg: ModelConfig, pattern, n: int,
                  with_cross: bool = False):
    stack = {}
    for i, (mixer, ffn) in enumerate(pattern):
        lp = _MIXER_PARAMS[mixer](ini, cfg, n)
        if with_cross and mixer in ("attn", "local_attn"):
            lp["cross"] = dict(_attn_params(ini, cfg, n, cross=True),
                               norm=_norm_p(ini, cfg, cfg.d_model, n))
        if ffn == "dense":
            lp.update(_mlp_params(ini, cfg, n))
        elif ffn == "moe":
            lp.update(_moe_params(ini, cfg, n))
        stack[f"p{i}"] = lp
    return stack


def check_family(cfg: ModelConfig) -> None:
    """Every family of ``repro``: attention, Mamba, mLSTM and sLSTM
    mixers with dense (gated, or plain gelu), MoE or no FFNs, RMSNorm or
    LayerNorm, full, partial or no RoPE, the audio encoder and the vision
    prefix.  What none of them has raises ``ValueError``, as the JAX
    package's init does."""
    bad = [(m, f) for m, f in cfg.layer_pattern
           if m not in _MIXERS or f not in _FFNS]
    if (bad or cfg.frontend not in _FRONTENDS
            or cfg.norm not in ("rmsnorm", "layernorm")
            or cfg.rope_style not in ("full", "partial", "none")
            or cfg.act not in ("silu", "gelu", "gelu_plain")):
        raise ValueError(f"{cfg.name}: no family has this layer pattern, "
                         f"frontend, norm, RoPE style or activation")


def init_params(seed: int, cfg: ModelConfig, dtype=torch.float32,
                device=None):
    """Initialize the full parameter dict for ``cfg`` on ``device`` (the
    CUDA card unless the caller says otherwise, ``utils.device``)."""
    check_family(cfg)
    ini = _Init(seed, resolve_device(device), dtype)
    params = {"embed": ini.dense((cfg.vocab, cfg.d_model)),
              "stack": _stack_params(ini, cfg, cfg.layer_pattern,
                                     cfg.n_periods,
                                     with_cross=cfg.encoder is not None),
              "final_norm": _norm_p(ini, cfg, cfg.d_model)}
    if not cfg.tie_embeddings:
        params["lm_head"] = ini.dense((cfg.d_model, cfg.vocab))
    if cfg.encoder is not None:
        params["encoder"] = {
            "stack": _stack_params(ini, cfg, (("attn", "dense"),),
                                   cfg.encoder.n_layers),
            "final_norm": _norm_p(ini, cfg, cfg.d_model)}
    return params


def abstract_params(cfg: ModelConfig, dtype=torch.bfloat16):
    """The parameter tree on the meta device: every leaf's shape, in
    ``dtype``, with no bytes (``repro.models.init.abstract_params``)."""
    return init_params(0, cfg, dtype=dtype, device="meta")


def param_count(cfg: ModelConfig) -> int:
    from repro_torch.utils.tree import tree_leaves
    tree = init_params(0, cfg, device="meta")
    return int(sum(t.numel() for t in tree_leaves(tree)))


def active_param_count(cfg: ModelConfig) -> int:
    """Active params per token (MoE: only top-k + shared experts count)."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    n_moe_layers = cfg.n_periods * sum(1 for _, f in cfg.layer_pattern
                                       if f == "moe")
    per_expert = 3 * cfg.d_model * m.d_ff_expert
    inactive = n_moe_layers * per_expert * (m.n_experts - m.top_k)
    return total - inactive
