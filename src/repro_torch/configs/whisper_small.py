"""whisper-small — enc-dec, conv frontend (stub) [arXiv:2212.04356]
(a copy of ``repro.configs.whisper_small``).

12L (decoder; + 12L encoder) d_model=768 12H d_ff=3072 vocab=51865.
The mel-spectrogram + conv feature extractor is a stub: the model takes
precomputed 1500-frame embeddings of shape (B, 1500, 768)
(``models.model.concrete_inputs``; zeros behind the serving engines).
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    rope_style="none",  # absolute (sinusoidal) positions
    act="gelu_plain",
    norm="layernorm",
    norm_eps=1e-5,
    encoder=EncoderConfig(n_layers=12, n_frames=1500),
    frontend="audio_stub",
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
