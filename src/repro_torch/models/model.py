"""Public model facade (``repro.models.model``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.init import init_params, param_count
from repro_torch.utils.device import resolve_device


class Model:
    """Thin stateless facade bundling config, device and apply functions.

    Runs on the CUDA card unless ``device`` says otherwise (``"cpu"`` for
    the tests); without a card and without ``device`` it raises.  Batches
    may hold numpy arrays; they are moved to the model's device."""

    def __init__(self, cfg: ModelConfig, ctx: T.ModelCtx = T.DEFAULT_CTX,
                 device=None):
        self.cfg = cfg
        self.ctx = ctx
        self.device = resolve_device(device)

    def init(self, seed: int = 0, dtype=torch.float32):
        return init_params(seed, self.cfg, dtype=dtype, device=self.device)

    def _batch(self, batch):
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def forward(self, params, batch):
        return T.forward(params, self._batch(batch), self.cfg, self.ctx)

    def loss(self, params, batch):
        return T.lm_loss(params, self._batch(batch), self.cfg, self.ctx)

    @property
    def n_params(self):
        return param_count(self.cfg)
