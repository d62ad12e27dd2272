"""Config registry (``repro.configs``): the assigned architectures the port
runs, the paper's models, and the tiny test configs."""
from repro_torch.configs.base import (EncoderConfig, FLConfig, InputShape,
                                      MeshConfig, ModelConfig, MoEConfig,
                                      SSMConfig, TrainConfig, XLSTMConfig)
from repro_torch.configs.chatglm3_6b import CONFIG as CHATGLM3_6B
from repro_torch.configs.gemma2_27b import CONFIG as GEMMA2_27B
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as JAMBA_1_5_LARGE
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as KIMI_K2
from repro_torch.configs.paper_models import GEMMA2_2B, LLAMA32_1B, QWEN2_1_5B
from repro_torch.configs.phi35_moe_42b_a6_6b import CONFIG as PHI35_MOE
from repro_torch.configs.pixtral_12b import CONFIG as PIXTRAL_12B
from repro_torch.configs.qwen2_7b import CONFIG as QWEN2_7B
from repro_torch.configs.qwen3_4b import CONFIG as QWEN3_4B
from repro_torch.configs.shapes import SHAPES, get_shape
from repro_torch.configs.tiny import TINY, TINY_LORA
from repro_torch.configs.whisper_small import CONFIG as WHISPER_SMALL
from repro_torch.configs.xlstm_350m import CONFIG as XLSTM_350M

# the JAX package's ASSIGNED, in its order
ASSIGNED = {
    c.name: c
    for c in (XLSTM_350M, WHISPER_SMALL, QWEN3_4B, KIMI_K2, PHI35_MOE,
              QWEN2_7B, CHATGLM3_6B, JAMBA_1_5_LARGE, GEMMA2_27B, PIXTRAL_12B)
}

PAPER_MODELS = {c.name: c for c in (LLAMA32_1B, QWEN2_1_5B, GEMMA2_2B)}

REGISTRY = {"tiny": TINY, **ASSIGNED, **PAPER_MODELS}


def get_config(name: str) -> ModelConfig:
    """The config of ``name``; ``<name>-reduced`` gives its ``reduced()``."""
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_archs():
    return sorted(ASSIGNED)
