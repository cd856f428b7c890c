"""internlm2-20b — [dense] GQA [arXiv:2403.17297; hf]."""
from repro_torch.config.arch_registry import register_arch
from repro_torch.config.types import ArchConfig, AttentionKind, Family

ARCH = register_arch(ArchConfig(
    name="internlm2-20b",
    family=Family.DENSE,
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    attention=AttentionKind.FULL,
    tie_embeddings=False,
    norm="rmsnorm",
    activation="silu",
    rope_theta=1_000_000.0,
    source="arXiv:2403.17297; hf",
))
