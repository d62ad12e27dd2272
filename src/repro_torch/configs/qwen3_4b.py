"""qwen3-4b — qk_norm, GQA [hf:Qwen/Qwen3-8B family].
(a copy of ``repro.configs.qwen3_4b``).

36L d_model=2560 32H (kv=8) d_ff=9728 vocab=151936, head_dim=128.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    rope_theta=1_000_000.0,
    qk_norm=True,
    source="hf:Qwen/Qwen3-8B",
)
