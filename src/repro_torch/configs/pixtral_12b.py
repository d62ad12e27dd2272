"""pixtral-12b — pixtral-ViT + mistral-nemo backbone [hf:mistralai/Pixtral-12B-2409]
(a copy of ``repro.configs.pixtral_12b``).

40L d_model=5120 32H (kv=8) d_ff=14336 vocab=131072.  The ViT vision encoder
+ projector are a stub: the model takes 256 precomputed patch embeddings per
example, prepended to the token embeddings (``models.model.concrete_inputs``;
zeros behind the serving engines).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1_000_000.0,
    frontend="vision_stub",
    n_patches=256,
    source="hf:mistralai/Pixtral-12B-2409",
)
