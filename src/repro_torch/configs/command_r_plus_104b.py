"""command-r-plus-104b — [dense] GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from repro_torch.config.arch_registry import register_arch
from repro_torch.config.types import ArchConfig, AttentionKind, Family

ARCH = register_arch(ArchConfig(
    name="command-r-plus-104b",
    family=Family.DENSE,
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    attention=AttentionKind.FULL,
    use_bias=False,
    tie_embeddings=True,        # Cohere ties input/output embeddings
    norm="layernorm",           # Cohere uses (bias-free) LayerNorm
    activation="silu",
    rope_theta=75_000_000.0,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
))
