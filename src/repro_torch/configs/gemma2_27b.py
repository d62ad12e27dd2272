"""gemma2-27b — local+global alternating attention, logit softcap [arXiv:2408.00118].
(a copy of ``repro.configs.gemma2_27b``).

46L d_model=4608 32H (kv=16) d_ff=36864 vocab=256000; sliding window 4096 on
local layers, attn softcap 50, final logit softcap 30, sandwich norms.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    act="gelu",
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
    layer_pattern=(("local_attn", "dense"), ("attn", "dense")),
    source="arXiv:2408.00118",
)
