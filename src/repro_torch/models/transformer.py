"""Model application of every architecture family: training forward and
the LM loss (``repro.models.transformer``).  The stacked layer periods run
in a Python loop (the JAX package scans them).  Whisper's encoder runs
first and each decoder layer cross-attends to it; Pixtral's patch
embeddings are prepended to the tokens and its logits cover the tokens
only."""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Tuple

import torch

from repro_torch.configs.base import MeshConfig, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.init import check_family
from repro_torch.sharding.rules import Spec
from repro_torch.utils.tree import is_dtensor, tree_map


@dataclass(frozen=True)
class ModelCtx:
    """How model code routes and shards: the counterpart of repro's
    ``ShardCtx``.

    ``attn_backend``: auto | kernel | online | dense
    (``layers.resolve_attn_backend``);
    ``attn_q_block``: 0 (whole-sequence attention), or the query block that
    tiles the online route and chunks the dense route's scores where it
    divides S and is smaller than S (``ShardCtx.attn_q_block``;
    ``layers.forward_attention``);
    ``decode_backend``: auto | kernel | ref, the one-token decode route
    (``layers.resolve_decode_backend``; ``ShardCtx.decode_backend``);
    ``mamba_mode``: auto | kernel | scan | stub, the selective-scan route of
    the Mamba layers (``ssm.resolve_mamba_mode``; auto takes the kernel
    unless autograd records through the layer; stub is the dry run's
    traffic stand-in) and ``mamba_chunk`` the scan route's chunk;
    ``mlstm_block``: the mLSTM's query block (0: whole sequence).

    The mesh fields are the tensor-parallel layout (``rule="tp"``,
    ``sharding/fl.py``): ``mesh`` a ``DeviceMesh`` (None: unsharded),
    ``batch_axes`` the mesh axes the clients (the batch rows) split over,
    ``model_axis`` the Megatron axis, ``use_sharded_moe`` the
    expert-parallel MoE (``moe.moe_sharded``), ``seq_shard`` the B=1
    long-context decode layout.  Under a mesh the parameters are DTensors
    on the ``model_axis`` sub-mesh and each rank holds its own batch rows,
    so a spec's batch-axis entries hold by construction and
    :meth:`constrain` redistributes over the model axis only.  JAX's
    ``scan_unroll`` and ``unroll_chunks`` have no counterpart: the eager
    port counts every op (ROADMAP C22)."""
    attn_backend: str = "auto"
    decode_backend: str = "auto"
    mamba_mode: str = "auto"
    attn_q_block: int = 0
    mesh: Any = None
    batch_axes: Tuple[str, ...] = ()
    model_axis: str = "model"
    use_sharded_moe: bool = False
    seq_shard: bool = False
    mlstm_block: int = 0
    mamba_chunk: int = 64

    def _axis_size(self, name: str) -> int:
        return int(self.mesh.shape[list(self.mesh.mesh_dim_names).index(
            name)])

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        return math.prod(self._axis_size(a) for a in self.batch_axes)

    @property
    def mesh_cfg(self):
        """The mesh's :class:`MeshConfig` (axis sizes by name)."""
        names = list(self.mesh.mesh_dim_names)
        return MeshConfig(
            data=self._axis_size("data"), model=self._axis_size("model"),
            pods=self._axis_size("pod") if "pod" in names else 1)

    @property
    def model_mesh(self):
        """The 1-D ``model_axis`` sub-mesh the DTensors live on."""
        return None if self.mesh is None else self.mesh[self.model_axis]

    def constrain(self, x, spec):
        """``x`` redistributed to ``spec`` over the model axis (the
        counterpart of ``with_sharding_constraint``); ``x`` itself when
        unsharded, not a DTensor, or on the whole mesh (the B=1
        ``seq_shard`` decode, where DTensor places each op itself)."""
        if self.mesh is None or spec is None or not is_dtensor(x) \
                or x.device_mesh.ndim != 1:
            return x
        from torch.distributed.tensor import Replicate, Shard
        want = [Replicate()]
        for d, entry in enumerate(spec):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            if self.model_axis in axes:
                want = [Shard(d)]
        if list(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)

    def attn_head_spec(self, B: int, S: int, H: int):
        """Spec for [B, S, H, hd] attention tensors (None: no
        constraint), as ``ShardCtx.attn_head_spec``."""
        if self.mesh is None:
            return None
        tp_free = self.model_axis not in self.batch_axes
        tp = self._axis_size(self.model_axis) if tp_free else 1
        dp = self.dp_size
        h = self.model_axis if (tp_free and H % tp == 0) else None
        if self.seq_shard:
            s = self.batch_axes if (S > 1 and S % dp == 0) else None
            return Spec(None, s, h, None)
        b = self.batch_axes if B % dp == 0 else None
        s = None
        if tp_free and h is None and S > 1 and S % tp == 0:
            s = self.model_axis
        return Spec(b, s, h, None)

    def act_spec(self, B: int):
        """Spec for [B, S, D] activations (None: no constraint)."""
        if self.mesh is None:
            return None
        if self.seq_shard or B % max(self.dp_size, 1):
            return Spec(None, self.batch_axes, None)
        return Spec(self.batch_axes, None, None)

    def region(self, params):
        """The context the model runs in: DTensor's implicit replication
        of plain tensors (positions, masks, batch rows) when ``params``
        are DTensors, else nothing."""
        if is_dtensor(params["embed"]):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            return implicit_replication()
        return contextlib.nullcontext()


DEFAULT_CTX = ModelCtx()


def _sinusoid(S: int, D: int, offset=0, device=None):
    """[..., S, D] f32 sinusoidal table; ``offset`` is a number or a per-row
    [B] tensor (continuous-batching decode, where every slot sits at its
    own absolute position)."""
    # a host number is filled on the device (a host-to-device copy would
    # sync the stream, and cannot be captured in a CUDA graph)
    off = (offset.to(device=device, dtype=torch.float32)
           if isinstance(offset, torch.Tensor) else
           torch.full((), float(offset), dtype=torch.float32, device=device))
    pos = torch.arange(S, dtype=torch.float32, device=device) + off[..., None]
    dim = torch.arange(0, D, 2, dtype=torch.float32, device=device)
    ang = pos[..., None] / torch.pow(10_000.0, dim / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[..., :D]


def _maybe_posenc(x, cfg: ModelConfig, offset=0):
    """Sinusoidal absolute positions for the RoPE-less encoder-decoder
    (Whisper); the other families take none."""
    if cfg.rope_style == "none" and (cfg.encoder is not None
                                     or cfg.frontend == "audio_stub"):
        pe = _sinusoid(x.shape[1], x.shape[2], offset, device=x.device)
        return x + pe.to(x.dtype)
    return x


def embed_tokens(params, tokens, cfg: ModelConfig):
    """Token embeddings [..., D], scaled by sqrt(d_model) where the config
    says so (Gemma)."""
    tok = params["embed"][tokens]
    if cfg.embed_scale:
        tok = tok * torch.full((), cfg.d_model ** 0.5, dtype=tok.dtype,
                               device=tok.device)
    return tok


def embed_input(params, batch, cfg: ModelConfig):
    """The input sequence [B, S_total, D]: the token embeddings, behind the
    patch embeddings (``batch["patch_embeds"]``) under ``vision_stub``."""
    tok = embed_tokens(params, batch["tokens"], cfg)
    if cfg.frontend == "vision_stub":
        return torch.cat([batch["patch_embeds"].to(tok.dtype), tok], dim=1)
    return tok


def unembed(x, params, cfg: ModelConfig):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.softcap((x @ head).float(), cfg.final_softcap)


def _mixer_fwd(x, lp, mixer, cfg, ctx, positions, enc_kv=None):
    h = L.apply_norm(x, lp["norm"], cfg.norm, cfg.norm_eps)
    if mixer == "mamba":
        y = SSM.mamba_forward(h, lp, cfg.ssm, chunk=ctx.mamba_chunk,
                              mode=ctx.mamba_mode)
    elif mixer == "mlstm":
        y = XL.mlstm_forward(h, lp, cfg.xlstm, ctx=ctx)
    elif mixer == "slstm":
        y = XL.slstm_forward(h, lp, cfg.xlstm)
    else:
        y = L.self_attention(h, lp, cfg, positions,
                             local=mixer == "local_attn", ctx=ctx)
    if cfg.post_norms and "post_norm" in lp:
        y = L.apply_norm(y, lp["post_norm"], cfg.norm, cfg.norm_eps)
    x = x + L.replicated(y)
    if enc_kv is not None and "cross" in lp:
        h = L.apply_norm(x, lp["cross"]["norm"], cfg.norm, cfg.norm_eps)
        x = x + L.replicated(L.cross_attention(h, enc_kv, lp["cross"], cfg))
    return x


def _ffn_fwd(x, lp, ffn, cfg, token_valid=None, ctx=DEFAULT_CTX):
    """(x + FFN(x), the MoE layer's load-balance loss, or None for a dense
    FFN or none).  ``token_valid``: [B] or [B, S] bool, the serving mask
    that dispatches a MoE layer per row (``moe.moe_dense_ref``); training
    passes none.  ``ctx.use_sharded_moe`` routes a MoE layer through
    ``moe.moe_sharded`` (``moe.moe_ffn``)."""
    if ffn == "none":
        return x, None
    h = L.apply_norm(x, lp["norm2"], cfg.norm, cfg.norm_eps)
    aux = None
    if ffn == "moe":
        y, aux = MOE.moe_ffn(h, lp, cfg.moe, cfg.act, ctx, valid=token_valid)
    else:
        y = L.mlp(h, lp, cfg)
    if cfg.post_norms and "post_norm2" in lp:
        y = L.apply_norm(y, lp["post_norm2"], cfg.norm, cfg.norm_eps)
    return x + L.replicated(y), aux


def encoder_forward(params, audio_embeds, cfg: ModelConfig):
    """Whisper's encoder: frame embeddings [B, Senc, D] plus sinusoidal
    positions through bidirectional attention layers -> [B, Senc, D]."""
    enc = params["encoder"]
    x = audio_embeds + _sinusoid(audio_embeds.shape[1], cfg.d_model,
                                 device=audio_embeds.device).to(
                                     audio_embeds.dtype)
    for layer in range(cfg.encoder.n_layers):
        lp = tree_map(lambda a: a[layer], enc["stack"])["p0"]
        h = L.apply_norm(x, lp["norm"], cfg.norm, cfg.norm_eps)
        x = x + L.bidir_attention(h, lp, cfg)
        x, _ = _ffn_fwd(x, lp, "dense", cfg)
    return L.apply_norm(x, enc["final_norm"], cfg.norm, cfg.norm_eps)


def forward(params, batch, cfg: ModelConfig, ctx: ModelCtx = DEFAULT_CTX):
    """Training forward: returns (logits [B, S_tokens, V] f32, aux_loss),
    aux the sum of the MoE layers' load-balance losses.  Parameters may be
    DTensors (the tensor-parallel layout, :class:`ModelCtx`): the forward
    then runs on them as it does on tensors, and its activations are
    constrained to ``ctx.act_spec`` after each period, as in the JAX
    package."""
    check_family(cfg)
    with ctx.region(params):
        return _forward(params, batch, cfg, ctx)


def _forward(params, batch, cfg, ctx):
    x = _maybe_posenc(embed_input(params, batch, cfg), cfg)
    spec = ctx.act_spec(x.shape[0])
    x = ctx.constrain(x, spec)
    positions = torch.arange(x.shape[1], device=x.device).expand(
        x.shape[:2])
    enc_out = None
    if cfg.encoder is not None:
        enc_out = encoder_forward(params, batch["audio_embeds"].to(x.dtype),
                                  cfg)
    aux = torch.zeros((), device=x.device)
    for period in range(cfg.n_periods):
        pp = tree_map(lambda a: a[period], params["stack"])
        for i, (mixer, ffn) in enumerate(cfg.layer_pattern):
            lp = pp[f"p{i}"]
            kv = None
            if enc_out is not None and "cross" in lp:
                kv = L.encode_kv(enc_out, lp["cross"], cfg)
            x = _mixer_fwd(x, lp, mixer, cfg, ctx, positions, kv)
            x, a = _ffn_fwd(x, lp, ffn, cfg, ctx=ctx)
            if a is not None:
                aux = aux + a
        x = ctx.constrain(x, spec)
    x = L.apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    logits = unembed(x, params, cfg)
    if cfg.frontend == "vision_stub":
        logits = logits[:, -batch["tokens"].shape[1]:]
    return logits, aux


def _logsumexp_last(x):
    """logsumexp over the last axis by the arithmetic of ``torch.logsumexp``
    (max, shifted exp, sum, log, add the max back), written out so that its
    [..., V] temporary is an op of its own that a recorder
    (``analysis/walk.py``) sees, and exponentiated in place, so there is
    one such temporary and not two.  The max is detached, as JAX's
    ``logsumexp`` stops its gradient."""
    m = x.detach().amax(-1, keepdim=True)
    return (x - m).exp_().sum(-1).log() + m[..., 0]


def lm_loss(params, batch, cfg: ModelConfig, ctx: ModelCtx = DEFAULT_CTX,
            aux_weight: float = 0.01, per_example: bool = False):
    """Next-token cross-entropy: the mean over examples of each example's
    mean over its positions, or with ``per_example`` the [B] per-example
    means (the per-client losses of ``core/fl_step``); the MoE aux term is
    added to each, as in the JAX package.  With ``batch["loss_mask"]``
    ([B, S]) an example's mean runs over the target positions its mask
    keeps (``mask[:, 1:]``), and an example that keeps none gets 0."""
    logits, aux = forward(params, batch, cfg, ctx)
    with ctx.region(params):
        return _loss(logits, aux, batch, aux_weight, per_example)


def _vocab_iota(lg, device):
    """arange(V) laid out as ``lg``'s last dim is: each rank's vocab
    range where the logits are sharded over the vocab, so the one-hot
    compare stays the local shard's size."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    V = lg.shape[-1]
    mesh = lg.device_mesh
    pl = [Shard(0) if p.is_shard(lg.ndim - 1) else Replicate()
          for p in lg.placements]
    lo, hi = 0, V
    for i, p in enumerate(pl):
        if p.is_shard():
            n = (hi - lo) // mesh.size(i)
            lo += mesh.get_local_rank(i) * n
            hi = lo + n
    return DTensor.from_local(torch.arange(lo, hi, device=device), mesh, pl,
                              run_check=False, shape=(V,), stride=(1,))


def _loss(logits, aux, batch, aux_weight, per_example):
    targets = batch["tokens"][:, 1:].long()
    lg = logits[:, :-1]
    if is_dtensor(lg):
        # vocab-sharded logits: the target's logit as a one-hot select
        # (one nonzero term, so the sum is exact), as the JAX package
        # writes it; a gather along a sharded dim has no local form
        iota = _vocab_iota(lg, targets.device)
        tgt = torch.where(iota == targets[..., None], lg, 0.0).sum(-1)
    else:
        tgt = torch.gather(lg, -1, targets[..., None])[..., 0]
    nll = _logsumexp_last(lg) - tgt
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask[:, 1:].float()
        per_ex = (nll * mask).sum(-1) / mask.sum(-1).clamp(min=1.0)
    else:
        per_ex = nll.mean(-1)
    if is_dtensor(per_ex):
        per_ex = per_ex.full_tensor()
        aux = aux.full_tensor() if is_dtensor(aux) else aux
    if per_example:
        return per_ex + aux_weight * aux
    return per_ex.mean() + aux_weight * aux
