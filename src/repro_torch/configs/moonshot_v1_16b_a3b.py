"""moonshot-v1-16b-a3b — [moe] kimi/moonlight, 64e top-6 [hf:moonshotai/Moonlight-16B-A3B; hf]."""
from repro_torch.config.arch_registry import register_arch
from repro_torch.config.types import ArchConfig, AttentionKind, Family, MoEConfig

ARCH = register_arch(ArchConfig(
    name="moonshot-v1-16b-a3b",
    family=Family.MOE,
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,              # brief: GQA kv=16 (i.e. MHA)
    d_ff=1408,                  # per-expert FFN hidden dim
    vocab_size=163840,
    attention=AttentionKind.FULL,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        n_shared_experts=0,
        d_ff_expert=1408,
    ),
    tie_embeddings=False,
    norm="rmsnorm",
    activation="silu",
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
))
