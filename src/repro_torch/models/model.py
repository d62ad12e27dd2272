"""Public model facade, per-shape input specs and random model inputs
(``repro.models.model``)."""
from __future__ import annotations

import torch

from typing import Dict

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import decode as D
from repro_torch.models import transformer as T
from repro_torch.models.init import (abstract_params, active_param_count,
                                     init_params, param_count)
from repro_torch.utils.device import resolve_device


class Model:
    """Thin stateless facade bundling config, device and apply functions.

    Runs on the CUDA card unless ``device`` says otherwise (``"cpu"`` for
    the tests); without a card and without ``device`` it raises.  Batches,
    tokens and lengths may be numpy arrays; they are moved to the model's
    device.  Parameters are never moved."""

    def __init__(self, cfg: ModelConfig, ctx: T.ModelCtx = T.DEFAULT_CTX,
                 device=None):
        self.cfg = cfg
        self.ctx = ctx
        self.device = resolve_device(device)

    def init(self, seed: int = 0, dtype=torch.float32):
        return init_params(seed, self.cfg, dtype=dtype, device=self.device)

    def _on(self, x):
        return None if x is None else torch.as_tensor(x, device=self.device)

    def _batch(self, batch):
        return {k: self._on(v) for k, v in batch.items()}

    def forward(self, params, batch):
        return T.forward(params, self._batch(batch), self.cfg, self.ctx)

    def loss(self, params, batch, per_example: bool = False):
        return T.lm_loss(params, self._batch(batch), self.cfg, self.ctx,
                         per_example=per_example)

    def prefill(self, params, batch, S_max: int = 0, lengths=None):
        return D.prefill(params, self._batch(batch), self.cfg, self.ctx,
                         S_max=S_max, lengths=self._on(lengths))

    def decode_step(self, params, token, cache, active=None):
        """One token per row; updates ``cache`` in place (see
        ``models/decode.decode_step``)."""
        return D.decode_step(params, self._on(token), cache, self.cfg,
                             self.ctx, active=self._on(active))

    def init_cache(self, B: int, S_max: int, dtype=torch.bfloat16):
        return D.init_cache(self.cfg, B, S_max, dtype, device=self.device,
                            ctx=self.ctx)

    def abstract_params(self, dtype=torch.bfloat16):
        """The parameters on the meta device (shapes and dtypes only)."""
        return abstract_params(self.cfg, dtype=dtype)

    def abstract_cache(self, B: int, S_max: int, dtype=torch.bfloat16):
        """The cache on the meta device (shapes and dtypes only)."""
        return D.abstract_cache(self.cfg, B, S_max, dtype)

    @property
    def n_params(self):
        return param_count(self.cfg)

    @property
    def n_active_params(self):
        return active_param_count(self.cfg)


def input_specs(cfg: ModelConfig, shape: InputShape,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins for every model input of ``shape``
    (``repro.models.model.input_specs``): train and prefill take tokens
    [B, S] int32 (and the frontend stub's embeddings in ``dtype``:
    Whisper's ``audio_embeds`` [B, n_frames, D], Pixtral's
    ``patch_embeds`` [B, n_patches, D]); decode takes token [B] int32 (the
    cache is built apart)."""
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind == "decode":
        return {"token": meta((B,), torch.int32)}
    specs = {"tokens": meta((B, S), torch.int32)}
    if cfg.frontend == "audio_stub":
        nf = cfg.encoder.n_frames if cfg.encoder else 1500
        specs["audio_embeds"] = meta((B, nf, cfg.d_model), dtype)
    elif cfg.frontend == "vision_stub":
        specs["patch_embeds"] = meta((B, cfg.n_patches, cfg.d_model), dtype)
    return specs


def concrete_inputs(cfg: ModelConfig, batch: int, seq_len: int, gen=None,
                    dtype=torch.float32, device=None):
    """Random training/prefill inputs (``repro.models.model
    .concrete_inputs``): tokens [batch, seq_len] uniform over the vocab,
    and the frontend stub's embeddings, standard normal in ``dtype``:
    Whisper's ``audio_embeds`` [batch, n_frames, D], Pixtral's
    ``patch_embeds`` [batch, n_patches, D].  Draws come from ``gen`` (a
    ``torch.Generator`` on ``device``; seed 0 when None), tokens first."""
    device = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, seq_len),
                                   generator=gen, device=device,
                                   dtype=torch.int32)}
    frames = {"audio_stub": ("audio_embeds",
                             cfg.encoder.n_frames if cfg.encoder else 1500),
              "vision_stub": ("patch_embeds", cfg.n_patches)}
    if cfg.frontend in frames:
        name, n = frames[cfg.frontend]
        out[name] = torch.randn((batch, n, cfg.d_model), generator=gen,
                                device=device).to(dtype)
    return out
