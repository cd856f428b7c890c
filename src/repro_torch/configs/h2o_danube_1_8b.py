"""h2o-danube-1.8b — [dense] llama+mistral mix, SWA [arXiv:2401.16818; hf]."""
from repro_torch.config.arch_registry import register_arch
from repro_torch.config.types import ArchConfig, AttentionKind, Family

ARCH = register_arch(ArchConfig(
    name="h2o-danube-1.8b",
    family=Family.DENSE,
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    attention=AttentionKind.SLIDING,
    sliding_window=4096,        # mistral-style SWA (danube paper §2)
    tie_embeddings=False,
    norm="rmsnorm",
    activation="silu",
    source="arXiv:2401.16818; hf",
))
