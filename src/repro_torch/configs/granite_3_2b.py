"""granite-3-2b — [dense] GQA [hf:ibm-granite/granite-3.0-2b-base; hf]."""
from repro_torch.config.arch_registry import register_arch
from repro_torch.config.types import ArchConfig, AttentionKind, Family

ARCH = register_arch(ArchConfig(
    name="granite-3-2b",
    family=Family.DENSE,
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    attention=AttentionKind.FULL,
    tie_embeddings=True,
    norm="rmsnorm",
    activation="silu",
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
))
