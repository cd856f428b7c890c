"""mamba2-370m — [ssm] SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from repro_torch.config.arch_registry import register_arch
from repro_torch.config.types import ArchConfig, AttentionKind, Family, SSMConfig

ARCH = register_arch(ArchConfig(
    name="mamba2-370m",
    family=Family.SSM,
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                      # attention-free, no separate FFN block
    vocab_size=50280,
    attention=AttentionKind.NONE,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256),
    tie_embeddings=True,
    norm="rmsnorm",
    activation="silu",
    source="arXiv:2405.21060; unverified",
))
