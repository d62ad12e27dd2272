"""jamba-1.5-large-398b — Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887]
(a copy of ``repro.configs.jamba_1_5_large_398b``).

72L d_model=8192 64H (kv=8) d_ff=24576 vocab=65536, MoE 16e top-2 on every
other layer.  Period of 8 layers: 1 attention + 7 Mamba, MoE FFN alternating
with dense FFN.

``SLICE_CUT`` is the configuration that ``chip_smoke.py`` trains on one
80 GB card: full width, depth cut to 4 layers (the period's attention layer
and three Mamba layers) and no experts.  A whole period holds ~44 B
parameters (177 GB in f32), ~9 B (36 GB) without its experts; the ZO tree
route keeps about three copies of the parameters, so 4 layers
(4,901,724,160 parameters, 19.6 GB in f32) is the depth that fits.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

_PATTERN = (
    ("attn", "dense"),
    ("mamba", "moe"),
    ("mamba", "dense"),
    ("mamba", "moe"),
    ("mamba", "dense"),
    ("mamba", "moe"),
    ("mamba", "dense"),
    ("mamba", "moe"),
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    rope_style="none",  # jamba attention layers use no positional encoding
    norm_eps=1e-5,
    layer_pattern=_PATTERN,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, capacity_factor=2.0),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    source="arXiv:2403.19887",
)

SLICE_CUT = CONFIG.replace(
    n_layers=4,
    layer_pattern=(("attn", "dense"),) + (("mamba", "dense"),) * 3,
    moe=None)
