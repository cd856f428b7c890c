"""Architecture registry + reduced-config factory for smoke tests (the
port's copy of ``repro/config/arch_registry.py``)."""
from __future__ import annotations

import dataclasses

from repro_torch.config.types import (
    ArchConfig,
    AttentionKind,
    Family,
    MLAConfig,
    MoEConfig,
    RGLRUConfig,
    SSMConfig,
)
from repro_torch.utils.registry import Registry

ARCHS: Registry[ArchConfig] = Registry("arch")


def register_arch(cfg: ArchConfig) -> ArchConfig:
    ARCHS.register(cfg.name, cfg)
    return cfg


def get_arch(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (side-effect: registers archs)
    return ARCHS.get(name)


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return list(ARCHS.keys())


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests.

    Keeps the structural features (GQA ratio, MoE routing, MLA, SSD, RG-LRU
    pattern, frontends) while shrinking width/depth/vocab so one forward
    runs in well under a second on the CPU.
    """
    kw: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
    )
    if cfg.attention == AttentionKind.NONE:
        kw.update(n_heads=0, n_kv_heads=0)
    else:
        ratio = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
        n_heads = 4
        kw.update(n_heads=n_heads, n_kv_heads=max(n_heads // min(ratio, 4), 1),
                  head_dim=16)
    if cfg.sliding_window:
        kw.update(sliding_window=8)
    if cfg.moe is not None:
        kw.update(moe=MoEConfig(
            n_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            n_shared_experts=min(cfg.moe.n_shared_experts, 1),
            d_ff_expert=32,
            capacity_factor=4.0,   # drop-free at smoke scale so decode and
            #                        forward are comparable in tests
        ))
    if cfg.mla is not None:
        kw.update(mla=MLAConfig(
            q_lora_rank=32, kv_lora_rank=16,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        ), head_dim=None)
    if cfg.ssm is not None:
        kw.update(ssm=SSMConfig(state_dim=16, head_dim=16, expand=2,
                                conv_width=4, chunk_size=8))
    if cfg.rglru is not None:
        kw.update(rglru=RGLRUConfig(lru_width=64, conv_width=4,
                                    block_pattern=cfg.rglru.block_pattern,
                                    attn_window=8))
    if cfg.mtp_depth:
        kw.update(mtp_depth=1)
    if cfg.frontend:
        kw.update(frontend=cfg.frontend,
                  frontend_tokens=min(cfg.frontend_tokens, 16))
    return dataclasses.replace(cfg, **kw)


__all__ = [
    "ARCHS", "register_arch", "get_arch", "list_archs", "reduced_config",
    "ArchConfig", "AttentionKind", "Family", "MLAConfig", "MoEConfig",
    "RGLRUConfig", "SSMConfig",
]
