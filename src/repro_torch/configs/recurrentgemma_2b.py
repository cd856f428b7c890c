"""recurrentgemma-2b — [hybrid] RG-LRU + local attn, 1:2 [arXiv:2402.19427; hf]."""
from repro_torch.config.arch_registry import register_arch
from repro_torch.config.types import ArchConfig, AttentionKind, Family, RGLRUConfig

ARCH = register_arch(ArchConfig(
    name="recurrentgemma-2b",
    family=Family.HYBRID,
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,               # MQA in the local-attention blocks
    d_ff=7680,
    vocab_size=256000,
    attention=AttentionKind.LOCAL,
    head_dim=256,               # gemma head dim
    rglru=RGLRUConfig(
        lru_width=2560,
        conv_width=4,
        block_pattern=("recurrent", "recurrent", "attention"),  # 1:2 attn:rec
        attn_window=2048,
    ),
    tie_embeddings=True,
    norm="rmsnorm",
    activation="gelu",
    source="arXiv:2402.19427; hf",
))
