"""hubert-xlarge — [audio] encoder-only, same arch as w2v2 [arXiv:2106.07447; unverified].

The backbone only: the CNN feature extractor is a stub, and precomputed
frame embeddings are fed in. Encoder-only: bidirectional attention, no
decode shapes.
"""
from repro_torch.config.arch_registry import register_arch
from repro_torch.config.types import ArchConfig, AttentionKind, Family

ARCH = register_arch(ArchConfig(
    name="hubert-xlarge",
    family=Family.AUDIO,
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,             # k-means target codebook
    attention=AttentionKind.BIDIR,
    use_bias=True,              # w2v2-style transformer uses biases
    frontend="frame",
    frontend_tokens=0,          # frames arrive precomputed, length = seq_len
    decoder=False,
    tie_embeddings=False,
    norm="layernorm",
    activation="gelu",
    source="arXiv:2106.07447; unverified",
))
