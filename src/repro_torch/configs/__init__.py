from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.configs.paper_models import GEMMA2_2B, LLAMA32_1B, QWEN2_1_5B
from repro_torch.configs.tiny import TINY
