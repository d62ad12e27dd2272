"""Parameter initialization for the dense decoder and hybrid (Mamba +
attention + MoE) families (``repro.models.init``).

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

_MIXERS = ("attn", "local_attn", "mamba")
_FFNS = ("dense", "moe")


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


def _attn_params(ini, cfg: ModelConfig, n: int):
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


def check_family(cfg: ModelConfig) -> None:
    """The port covers decoder-only stacks of attention and Mamba mixers
    with dense (gated, or plain gelu) or MoE FFNs, RMSNorm or LayerNorm,
    full, partial or no RoPE, qk-norm and LoRA adapters (the paper's
    models, the dense and MoE configs and the Jamba hybrid); the other
    families of ``repro`` (mLSTM/sLSTM mixers, encoders, frontends) raise
    until they are ported (ROADMAP A item 6)."""
    bad = [(m, f) for m, f in cfg.layer_pattern
           if m not in _MIXERS or f not in _FFNS]
    if (bad or cfg.encoder is not None or cfg.frontend != "none"
            or cfg.norm not in ("rmsnorm", "layernorm")
            or cfg.rope_style not in ("full", "partial", "none")
            or cfg.act not in ("silu", "gelu", "gelu_plain")):
        raise NotImplementedError(
            f"{cfg.name}: the port covers attention and Mamba mixers with "
            f"dense or MoE FFNs only; the mLSTM/sLSTM mixers, encoders and "
            f"frontends come with their families")


def init_params(seed: int, cfg: ModelConfig, dtype=torch.float32,
                device=None):
    """Initialize the full parameter dict for ``cfg`` on ``device`` (the
    CUDA card unless the caller says otherwise, ``utils.device``)."""
    check_family(cfg)
    ini = _Init(seed, resolve_device(device), dtype)
    params = {"embed": ini.dense((cfg.vocab, cfg.d_model))}
    stack = {}
    n = cfg.n_periods
    for i, (mixer, ffn) in enumerate(cfg.layer_pattern):
        lp = (_mamba_params(ini, cfg, n) if mixer == "mamba"
              else _attn_params(ini, cfg, n))
        lp.update(_moe_params(ini, cfg, n) if ffn == "moe"
                  else _mlp_params(ini, cfg, n))
        stack[f"p{i}"] = lp
    params["stack"] = stack
    params["final_norm"] = _norm_p(ini, cfg, cfg.d_model)
    if not cfg.tie_embeddings:
        params["lm_head"] = ini.dense((cfg.d_model, cfg.vocab))
    return params


def param_count(cfg: ModelConfig) -> int:
    from repro_torch.utils.tree import tree_leaves
    tree = init_params(0, cfg, device="meta")
    return int(sum(t.numel() for t in tree_leaves(tree)))
