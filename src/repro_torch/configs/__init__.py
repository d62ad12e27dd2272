from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as JAMBA_1_5_LARGE
from repro_torch.configs.paper_models import GEMMA2_2B, LLAMA32_1B, QWEN2_1_5B
from repro_torch.configs.tiny import TINY

# the port's architectures by name (the JAX package's ``REGISTRY`` holds
# more; the port has the paper's models, the hybrid Jamba and the tiny test
# config)
REGISTRY = {"tiny": TINY,
            **{c.name: c for c in (LLAMA32_1B, QWEN2_1_5B, GEMMA2_2B,
                                   JAMBA_1_5_LARGE)}}


def get_config(name: str) -> ModelConfig:
    """The config of ``name``; ``<name>-reduced`` gives its ``reduced()``."""
    if name.endswith("-reduced"):
        return get_config(name[: -len("-reduced")]).reduced()
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
