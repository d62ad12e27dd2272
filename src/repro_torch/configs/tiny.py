"""Tiny configs for CPU simulations / unit tests."""
from repro_torch.configs.base import ModelConfig

TINY = ModelConfig(
    name="tiny-dense",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    tie_embeddings=True,
    source="test",
)
