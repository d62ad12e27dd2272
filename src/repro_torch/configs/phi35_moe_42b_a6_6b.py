"""phi3.5-moe-42b-a6.6b — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct].
(a copy of ``repro.configs.phi35_moe_42b_a6_6b``).

32L d_model=4096 32H (kv=8) d_ff=6400 vocab=32064, MoE 16e top-2.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab=32064,
    norm="layernorm",
    norm_eps=1e-5,
    layer_pattern=(("attn", "moe"),),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400, capacity_factor=2.0),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
