"""deepseek-v3-671b — [moe] MLA, 1 shared + 256 routed top-8, MTP [arXiv:2412.19437; hf]."""
from repro_torch.config.arch_registry import register_arch
from repro_torch.config.types import ArchConfig, AttentionKind, Family, MLAConfig, MoEConfig

ARCH = register_arch(ArchConfig(
    name="deepseek-v3-671b",
    family=Family.MOE,
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,             # MLA: all heads share the latent KV
    d_ff=2048,                  # per-expert FFN hidden dim (brief)
    vocab_size=129280,
    attention=AttentionKind.MLA,
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        n_shared_experts=1,
        d_ff_expert=2048,
    ),
    mtp_depth=1,                # multi-token prediction, 1 extra depth
    tie_embeddings=False,
    norm="rmsnorm",
    activation="silu",
    source="arXiv:2412.19437; hf",
))
