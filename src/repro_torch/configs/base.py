"""Config dataclasses of the PyTorch port: a copy of
``repro.configs.base`` (the port imports nothing of the JAX package), less
the first-order config it does not use and the TPU hardware table (the
card's peaks are ``launch/roofline.HW``).

Every architecture is expressed as a :class:`ModelConfig`; each family also
provides a ``reduced()`` variant (<=2 layers, d_model<=256, <=4 experts) that
the CPU tests instantiate.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 2.0
    router_aux_weight: float = 0.01
    n_shared_experts: int = 0  # shared (always-on) experts, kimi-style


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM hyper-params."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model/16)


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block hyper-params (mLSTM chunkwise + sLSTM recurrent)."""
    n_heads: int = 4
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 4.0 / 3.0
    chunk_size: int = 64
    conv_dim: int = 4


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (whisper) archs. Input comes from a stub
    frontend producing precomputed frame embeddings."""
    n_layers: int = 12
    n_frames: int = 1500


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention flavour
    rope_style: str = "full"  # full | partial | none
    rope_theta: float = 10_000.0
    rope_partial_factor: float = 0.5  # for rope_style == partial (chatglm "2d")
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_softcap: float = 0.0  # 0 -> disabled
    final_softcap: float = 0.0
    sliding_window: int = 0  # 0 -> disabled; used by 'local' layers
    post_norms: bool = False  # gemma2 sandwich norms
    # layer mixing: a repeating pattern of (mixer, ffn) pairs; the full stack is
    # n_layers == len(pattern) * n_periods and is scanned over periods.
    # mixer in {attn, local_attn, mamba, mlstm, slstm}; ffn in {dense, moe, none}
    layer_pattern: Tuple[Tuple[str, str], ...] = (("attn", "dense"),)
    act: str = "silu"  # silu (gated) | gelu (non-gated)
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scaling
    # sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encoder: Optional[EncoderConfig] = None
    # modality frontend stub: none | audio_stub | vision_stub
    frontend: str = "none"
    n_patches: int = 256  # vision stub patch count
    # LoRA adapters (for the LoRA-FedZO baseline); 0 disables
    lora_rank: int = 0
    lora_alpha: float = 16.0
    # citation for the config
    source: str = ""
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_periods(self) -> int:
        assert self.n_layers % self.period == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"period={self.period}")
        return self.n_layers // self.period

    @property
    def supports_long_context(self) -> bool:
        """True if the arch has a sub-quadratic (windowed / recurrent) path for
        every layer's mixer — gate for the long_500k shape."""
        ok = {"mamba", "mlstm", "slstm", "local_attn"}
        full_attn = [m for m, _ in self.layer_pattern if m not in ok]
        # gemma2: half the layers are full ("global") attention but the arch
        # ships a windowed variant; we allow archs whose pattern contains at
        # least one windowed/recurrent mixer type.
        has_subquadratic = len(full_attn) < len(self.layer_pattern)
        return has_subquadratic and self.frontend == "none" and self.encoder is None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family: <=2 periods, d_model<=256,
        <=4 experts, tiny vocab."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        head_dim = min(self.resolved_head_dim, 64)
        kw = dict(
            name=self.name + "-reduced",
            n_layers=self.period * min(self.n_periods, 2),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 256),
            )
        if self.encoder is not None:
            kw["encoder"] = dataclasses.replace(
                self.encoder, n_layers=min(self.encoder.n_layers, 2), n_frames=16)
        if self.xlstm is not None:
            kw["xlstm"] = dataclasses.replace(
                self.xlstm, n_heads=min(self.xlstm.n_heads, 2), chunk_size=16)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=8)
        if self.frontend == "vision_stub":
            kw["n_patches"] = 8
        return self.replace(**kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def reduced(self, seq_len: int = 32, global_batch: int = 4) -> "InputShape":
        return InputShape(self.name + "-reduced", seq_len, global_batch, self.kind)


@dataclass(frozen=True)
class MeshConfig:
    data: int = 16
    model: int = 16
    pods: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model * self.pods

    @property
    def shape(self):
        if self.pods > 1:
            return (self.pods, self.data, self.model)
        return (self.data, self.model)

    @property
    def axis_names(self):
        if self.pods > 1:
            return ("pod", "data", "model")
        return ("data", "model")

    @property
    def batch_axes(self):
        return ("pod", "data") if self.pods > 1 else ("data",)


@dataclass(frozen=True)
class FLConfig:
    """Federated-learning hyper-params (paper §2.1 / Alg. 1-3)."""
    n_clients: int = 8
    rounds: int = 20
    local_steps: int = 1  # T
    lr: float = 1e-3
    eps: float = 1e-3  # ZO perturbation magnitude
    density: float = 1e-3  # u
    mask_kind: str = "sensitivity"  # sensitivity | magnitude | random | dense | lora
    seed: int = 0
    batch_size: int = 16
    # ZO hot-path execution route (core/dispatch.py): "auto" uses the fused
    # flat kernels when the layout supports it, else the pytree route.
    zo_backend: str = "auto"  # auto | kernel | ref
    # beyond-paper: K-direction ZO estimator per local step (core/zo.py);
    # clients then upload T*K scalars per round
    n_dirs: int = 1
    # MEERKAT-VP (Alg. 1) knobs — defaults follow Appendix C.1 Table 4
    vp_calibration_steps: int = 100
    vp_init_steps: int = 20
    vp_later_steps: int = 20
    vp_sigma: float = 1.0  # convergence threshold on |GradIP|
    vp_rho_later: float = 5.0  # initial-to-later ratio threshold
    vp_rho_quie: float = 0.5  # quiescent step ratio threshold
    # beyond-paper: interpret vp_sigma as a fraction of the client's
    # initial-phase |GradIP| (scale-free across model sizes / densities)
    vp_sigma_relative: bool = False
    # beyond-paper: FedAvgM-style server momentum on the aggregated sparse
    # update (0 = paper-faithful plain averaging)
    server_momentum: float = 0.0
    # fleet-scale rounds (DESIGN.md §12)
    # per-round participation fraction: < 1 enables the seeded
    # ClientSampler (cohort size max(1, round(frac * K)))
    sample_frac: float = 1.0
    # weight cohort draws by client dataset size (uniform otherwise)
    sample_weighted: bool = False
    # uplink codec for the ZO scalars (core/quantize.py):
    # none | int8 | int4 [-nearest for deterministic rounding]
    quantize: str = "none"
