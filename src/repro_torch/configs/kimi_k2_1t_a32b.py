"""kimi-k2-1t-a32b — trillion-param MoE [arXiv:2501.kimi2].
(a copy of ``repro.configs.kimi_k2_1t_a32b``).

61L d_model=7168 64H (kv=8) vocab=163840; MoE 384 experts top-8 with
d_ff_expert=2048 (spec's d_ff column), plus 1 shared expert.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab=163840,
    layer_pattern=(("attn", "moe"),),
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048,
                  capacity_factor=2.0, n_shared_experts=1),
    source="arXiv:2501.kimi2",
)
