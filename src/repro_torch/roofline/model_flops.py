"""Analytic MODEL_FLOPS per (arch x shape) — the 'useful work' numerator.

train:    6 * N * D            (fwd 2ND + bwd 4ND), N = active params
          + attention term 12 * L * H * hd * S^2 * B * 0.5 (causal)
prefill:  2 * N * D + attention term 4 * ... * 0.5
decode:   2 * N * B (one token each) + 4 * L * H * hd * S_kv * B
          (score + value contractions against the cache)

MoE archs use N_active; SSM/recurrent archs replace the attention term
with their linear-state work (folded into N for SSD/RG-LRU since state
updates are matmul-shaped and already counted via params x tokens).
"""
from __future__ import annotations

from repro_torch.config.types import ArchConfig, AttentionKind, ShapeConfig


def _attn_term(cfg: ArchConfig, seq: int, batch: int,
               factor: float) -> float:
    if cfg.attention == AttentionKind.NONE:
        return 0.0
    hd = cfg.resolved_head_dim
    if cfg.attention == AttentionKind.MLA:
        hd = cfg.mla.qk_head_dim
    n_attn_layers = cfg.n_layers
    if cfg.family.value == "hybrid":
        pat = cfg.rglru.block_pattern
        n_attn_layers = sum(1 for i in range(cfg.n_layers)
                            if pat[i % len(pat)] == "attention")
        seq_eff = min(seq, cfg.rglru.attn_window)
        return factor * n_attn_layers * cfg.n_heads * hd * seq * seq_eff \
            * batch
    if cfg.attention == AttentionKind.SLIDING:
        seq_eff = min(seq, cfg.sliding_window)
        return factor * n_attn_layers * cfg.n_heads * hd * seq * seq_eff \
            * batch
    causal = 0.5 if cfg.attention != AttentionKind.BIDIR else 1.0
    return factor * n_attn_layers * cfg.n_heads * hd * seq * seq * batch \
        * causal


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    n_active = cfg.active_param_count()
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = b * s
        return 6.0 * n_active * tokens + _attn_term(cfg, s, b, 12.0)
    if shape.kind == "prefill":
        tokens = b * s
        return 2.0 * n_active * tokens + _attn_term(cfg, s, b, 4.0)
    # decode: one token per sequence against an S-long cache
    per_tok = 2.0 * n_active * b
    if cfg.attention == AttentionKind.NONE:
        return per_tok                 # SSM: O(1) state update, no KV read
    hd = cfg.resolved_head_dim
    if cfg.attention == AttentionKind.MLA:
        kv_read = 4.0 * cfg.n_layers * cfg.n_heads * b * s \
            * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim)
    elif cfg.attention == AttentionKind.NONE:
        kv_read = 0.0
    else:
        s_eff = min(s, cfg.sliding_window) if cfg.sliding_window else s
        if cfg.family.value == "hybrid":
            s_eff = min(s, cfg.rglru.attn_window)
        kv_read = 4.0 * cfg.n_layers * cfg.n_heads * hd * b * s_eff
    return per_tok + kv_read
