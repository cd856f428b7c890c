"""Analytic parameter counts (the port's copy of
``repro/models/counting.py``)."""
from __future__ import annotations

from repro_torch.config.types import ArchConfig, AttentionKind, Family


def _attn_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    if cfg.attention == AttentionKind.MLA:
        m = cfg.mla
        n = 0
        n += d * m.q_lora_rank + m.q_lora_rank                   # wq_a + norm
        n += m.q_lora_rank * cfg.n_heads * m.qk_head_dim          # wq_b
        n += d * (m.kv_lora_rank + m.qk_rope_head_dim)            # wkv_a
        n += m.kv_lora_rank                                       # kv norm
        n += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim
                                             + m.v_head_dim)      # wkv_b
        n += cfg.n_heads * m.v_head_dim * d                       # wo
        return n
    n = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
        + cfg.n_heads * hd * d
    if cfg.use_bias:
        n += cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd + d
    return n


def _mlp_params(cfg: ArchConfig, d_ff: int) -> int:
    d = cfg.d_model
    if cfg.family == Family.AUDIO:
        n = 2 * d * d_ff
        if cfg.use_bias:
            n += d_ff + d
        return n
    return 3 * d * d_ff


def _moe_params(cfg: ArchConfig, active_only: bool) -> int:
    m = cfg.moe
    d = cfg.d_model
    per_expert = 3 * d * m.d_ff_expert
    n_routed = m.top_k if active_only else m.n_experts
    return (d * m.n_experts                     # router
            + n_routed * per_expert
            + m.n_shared_experts * per_expert)


def _ssm_params(cfg: ArchConfig) -> int:
    s = cfg.ssm
    d = cfg.d_model
    inner = s.expand * d
    heads = s.n_heads(d)
    n = s.state_dim
    conv_dim = inner + 2 * n
    total = d * (2 * inner + 2 * n + heads)      # in_proj
    total += s.conv_width * conv_dim + conv_dim  # conv
    total += 3 * heads                           # A_log, D, dt_bias
    total += inner                               # norm
    total += inner * d                           # out_proj
    return total


def _rglru_params(cfg: ArchConfig) -> int:
    d = cfg.d_model
    w = cfg.rglru.lru_width
    cw = cfg.rglru.conv_width
    return (2 * d * w            # in_y, in_gate
            + cw * w + w         # conv
            + 2 * (w * w + w)    # wa, wx + biases
            + w                  # lambda
            + w * d)             # out


def _norm_params(cfg: ArchConfig) -> int:
    # layernorm-with-bias archs (HuBERT) carry a bias vector per norm
    return cfg.d_model * (2 if (cfg.norm == "layernorm" and cfg.use_bias)
                          else 1)


def _layer_params(cfg: ArchConfig, idx: int, active_only: bool) -> int:
    from repro_torch.models.lm import _block_kind
    kind = _block_kind(cfg, idx)
    if kind == "ssm":
        return _norm_params(cfg) + _ssm_params(cfg)
    if kind == "rec":
        return (2 * _norm_params(cfg) + _rglru_params(cfg)
                + _mlp_params(cfg, cfg.d_ff))
    n = 2 * _norm_params(cfg) + _attn_params(cfg)
    if cfg.moe is not None:
        n += _moe_params(cfg, active_only)
    else:
        n += _mlp_params(cfg, cfg.d_ff)
    return n


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    n = cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        n += cfg.d_model * cfg.vocab_size
    if cfg.frontend is not None:
        n += cfg.d_model * cfg.d_model
    n += _norm_params(cfg)                         # final norm
    for i in range(cfg.n_layers):
        n += _layer_params(cfg, i, active_only)
    if cfg.mtp_depth > 0:
        n += 2 * cfg.d_model * cfg.d_model + 3 * cfg.d_model \
            + _layer_params(cfg, 0, active_only)
    return n


def count_active_params(cfg: ArchConfig) -> int:
    return count_params(cfg, active_only=True)
