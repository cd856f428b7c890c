"""paligemma-3b — [vlm] SigLIP + gemma [arXiv:2407.07726; hf].

The transformer backbone only: the SigLIP vision tower is a stub, and
precomputed patch embeddings (256 tokens for 224px/14 patches) are fed
in and prepended to the text sequence.
"""
from repro_torch.config.arch_registry import register_arch
from repro_torch.config.types import ArchConfig, AttentionKind, Family

ARCH = register_arch(ArchConfig(
    name="paligemma-3b",
    family=Family.VLM,
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,               # gemma-2b MQA
    d_ff=16384,
    vocab_size=257216,
    attention=AttentionKind.FULL,
    head_dim=256,
    frontend="patch",
    frontend_tokens=256,        # 224/14 = 16x16 SigLIP patches
    tie_embeddings=True,
    norm="rmsnorm",
    activation="gelu",
    source="arXiv:2407.07726; hf",
))
