"""chatglm3-6b — RoPE 2d (partial rotary), GQA [arXiv:2406.12793].
(a copy of ``repro.configs.chatglm3_6b``).

28L d_model=4096 32H (kv=2) d_ff=13696 vocab=65024.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    rope_style="partial",
    rope_partial_factor=0.5,
    qkv_bias=True,
    norm_eps=1e-5,
    source="arXiv:2406.12793",
)
