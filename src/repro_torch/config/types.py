"""Typed configuration (the port's copy of ``repro/config/types.py``).

Every architecture is an :class:`ArchConfig` and every input shape a
:class:`ShapeConfig`; a training run is a :class:`RunConfig` of an arch,
a shape and the distribution, training, CARAT, data and checkpoint
configs. Validation happens in ``__post_init__`` so a bad config fails
at construction. All configs are frozen dataclasses.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Optional, Tuple


class Family(str, enum.Enum):
    DENSE = "dense"
    SSM = "ssm"
    HYBRID = "hybrid"
    VLM = "vlm"
    MOE = "moe"
    AUDIO = "audio"


class AttentionKind(str, enum.Enum):
    FULL = "full"            # global causal attention
    SLIDING = "sliding"      # sliding-window attention (SWA)
    LOCAL = "local"          # local attention block in hybrid archs
    MLA = "mla"              # multi-head latent attention (DeepSeek)
    NONE = "none"            # attention-free (pure SSM)
    BIDIR = "bidir"          # encoder-only, bidirectional (HuBERT)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared_experts: int = 0
    d_ff_expert: int = 0          # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001

    def __post_init__(self):
        if self.top_k > self.n_experts:
            raise ValueError("top_k cannot exceed n_experts")
        if self.d_ff_expert <= 0:
            raise ValueError("d_ff_expert must be positive for MoE")


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims (arXiv:2412.19437)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD parameters (arXiv:2405.21060)."""
    state_dim: int = 128          # N
    head_dim: int = 64            # P
    expand: int = 2               # E: inner dim = expand * d_model
    conv_width: int = 4
    chunk_size: int = 256         # SSD block-decomposition chunk length

    def n_heads(self, d_model: int) -> int:
        return (self.expand * d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU block parameters (arXiv:2402.19427)."""
    lru_width: int = 2560
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")
    attn_window: int = 2048


@dataclass(frozen=True)
class ArchConfig:
    """One architecture, with the numbers of its published config."""
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    attention: AttentionKind = AttentionKind.FULL
    head_dim: Optional[int] = None          # default d_model // n_heads
    sliding_window: int = 0                 # for AttentionKind.SLIDING
    use_bias: bool = False
    tie_embeddings: bool = True
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    activation: str = "silu"                # silu | gelu
    rope_theta: float = 10_000.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    mtp_depth: int = 0                      # DeepSeek multi-token-prediction
    # Modality frontend stubs: precomputed embeddings are fed in.
    frontend: Optional[str] = None          # None | "patch" | "frame"
    frontend_tokens: int = 0                # e.g. SigLIP patch count
    decoder: bool = True                    # False => encoder-only (HuBERT)
    source: str = ""                        # provenance tag

    def __post_init__(self):
        if self.attention != AttentionKind.NONE:
            if self.n_heads <= 0 or self.n_heads % max(self.n_kv_heads, 1):
                raise ValueError(
                    f"{self.name}: n_heads={self.n_heads} must be a positive "
                    f"multiple of n_kv_heads={self.n_kv_heads}"
                )
        if self.attention == AttentionKind.SLIDING and self.sliding_window <= 0:
            raise ValueError(f"{self.name}: sliding attention needs a window")
        if self.family == Family.MOE and self.moe is None:
            raise ValueError(f"{self.name}: MoE family needs MoEConfig")
        if self.family == Family.SSM and self.ssm is None:
            raise ValueError(f"{self.name}: SSM family needs SSMConfig")

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        if self.mla is not None:
            return self.mla.qk_head_dim
        return self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """True iff the arch can run the 500k long-context decode shape."""
        return self.attention in (AttentionKind.SLIDING, AttentionKind.NONE) or (
            self.family == Family.HYBRID
        )

    def param_count(self) -> int:
        """Analytic parameter count."""
        from repro_torch.models.counting import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.counting import count_active_params
        return count_active_params(self)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode" | "long_decode"

    @property
    def is_serve(self) -> bool:
        return self.kind in ("decode", "long_decode")


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="long_decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; known: {[s.name for s in SHAPES]}")


@dataclass(frozen=True)
class ParallelConfig:
    """Distribution knobs for the (pod, data, model) mesh. The port's
    single-device trainer reads ``remat``, ``microbatches`` and
    ``opt_state_dtype``; the mesh knobs wait for its ``parallel/``
    slice."""
    fsdp: bool = True                   # shard params/opt-state over "data" too
    remat: str = "full"                 # none | dots | full
    scan_layers: bool = True            # lax.scan over layers (bounded HLO)
    microbatches: int = 1               # gradient accumulation factor
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"    # bf16 for the XXL archs
    seq_shard_attn: bool = False        # shard long-context KV over "model"
    grad_compression: str = "none"      # none | int8
    reduce_scatter_grads: bool = False  # RS+AG instead of all-reduce (beyond-paper)
    overlap_io: bool = True             # async input pipeline + ckpt


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 200
    learning_rate: float = 3e-4
    warmup_steps: int = 20
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    log_every: int = 10
    ckpt_every: int = 50


@dataclass(frozen=True)
class CaratConfig:
    """CARAT hyper-parameters (paper §III, §IV defaults)."""
    enable: bool = True
    probe_interval_s: float = 0.5        # paper: 0.5 s probing interval
    history_k: int = 1                   # paper §III-C: k=1 best
    improve_eps: float = 0.15            # "better" threshold ε = 15%
    prob_tau: float = 0.8                # candidate filter threshold τ
    alpha: float = 0.5                   # ReadScore weight
    beta: float = 0.5                    # WriteScore weight
    tuner: str = "conditional_score"     # greedy | epsilon_greedy | conditional_score
    epsilon: float = 0.1                 # for the ε-greedy baseline
    model: str = "gbdt"                  # svm | fcnn | rnn | tcn | gbdt
    inactive_threshold_s: float = 1.0    # I/O-inactive boundary (>1 s, §III-A)
    # phase re-probing (replayed/dynamic workloads): when the app-level I/O
    # signature shifts (op-mix flip or >reprobe_req_ratio request-size
    # change), reset RPC params to the space default — the trained model's
    # confident region — and re-tune from there (IOPathTune/DIAL-style
    # change response; static workloads never trigger it)
    reprobe_on_change: bool = True
    reprobe_req_ratio: float = 2.0       # request-size shift that counts
    reprobe_cooldown_s: float = 2.0      # min time between resets


@dataclass(frozen=True)
class DataConfig:
    sample_bytes: int = 4096 * 4         # tokenized sample footprint on PFS
    files_per_shard: int = 64
    prefetch_depth: int = 2
    shuffle: bool = True


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str = "/ckpt"
    async_write: bool = True
    keep: int = 3
    verify_manifest: bool = True


@dataclass(frozen=True)
class RunConfig:
    """Top-level run description = arch x shape x distribution x IO."""
    arch: ArchConfig
    shape: ShapeConfig
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    carat: CaratConfig = field(default_factory=CaratConfig)
    data: DataConfig = field(default_factory=DataConfig)
    ckpt: CheckpointConfig = field(default_factory=CheckpointConfig)

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
