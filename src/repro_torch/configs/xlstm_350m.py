"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517]
(a copy of ``repro.configs.xlstm_350m``).

24L d_model=1024 4H d_ff=0 vocab=50304.  7:1 mLSTM:sLSTM interleave; no
separate FFN (up-projections live inside the blocks), hence d_ff=0.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    rope_style="none",
    norm="layernorm",
    layer_pattern=tuple([("mlstm", "none")] * 7 + [("slstm", "none")]),
    xlstm=XLSTMConfig(n_heads=4, chunk_size=64),
    tie_embeddings=True,
    source="arXiv:2405.04517",
)
