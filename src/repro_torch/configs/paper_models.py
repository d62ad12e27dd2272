"""The paper's own models (Gemma-2-2b, Qwen2-1.5B, Llama-3.2-1B) as configs.

The CPU tests use their ``reduced()`` variants; ``chip_smoke.py`` runs
Llama-3.2-1B at full width and depth on the card.
"""
from repro_torch.configs.base import ModelConfig

LLAMA32_1B = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    rope_theta=500_000.0,
    tie_embeddings=True,
    source="arXiv:2407.21783",
)

QWEN2_1_5B = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=True,
    source="arXiv:2407.10671",
)

GEMMA2_2B = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=18432,
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
