"""Attention blocks: GQA with full, sliding-window, local or bidirectional
masks, and MLA (the twin of ``repro/models/attention.py``).

The full pass (forward, prefill) goes through the flash-attention op and
decode through the decode-attention op against a KV cache; on CUDA
tensors both are the port's hand-written kernels. Sliding-window archs
keep a ring-buffer cache of ``min(cache_len, window)`` positions: keys
are stored already rotated at their absolute positions, so the order of
the buffer does not matter. ``window_override`` sets the window of one
block whatever ``cfg.attention`` says: the hybrid family's local-attention
blocks pass ``cfg.rglru.attn_window`` (``AttentionKind.LOCAL`` alone means
no window, as in the reference).

MLA (DeepSeek-V3): low-rank Q/KV projections with decoupled RoPE keys.
The full pass expands the latent KV and runs the flash-attention op with
V zero-padded to the query/key head dim; decode uses the *absorbed*
form against the compressed (kv_lora + rope) cache, in float32 torch
ops as the reference's einsums (no kernel). The activation-sharding
calls (``parallel/constraints.constrain``) stand where the reference's
do.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.types import ArchConfig, AttentionKind
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, norm_apply, norm_spec
from repro_torch.models.param import ParamSpec
from repro_torch.parallel.constraints import (constrain,
                                              constrain_attention,
                                              constrain_heads)
from repro_torch.parallel.local import cache_write_

# the fused projections' logical axes (B, S, H*D)
_FUSED_Q = ("act_batch", None, "act_model")
_FUSED_KV = ("act_batch", None, "act_kv_heads")
# the split heads' (B, H, S, D)
_HEADS = ("act_batch", "act_model", None, None)


class CacheSpec(NamedTuple):
    """Shape and dtype of one cache tensor (the port's ShapeDtypeStruct)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


# ------------------------------------------------------------------ GQA spec
def attn_spec(cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    if cfg.attention == AttentionKind.MLA:
        m = cfg.mla
        return {
            "wq_a": ParamSpec((d, m.q_lora_rank), ("embed", None)),
            "q_norm": norm_spec(cfg, m.q_lora_rank),
            "wq_b": ParamSpec((m.q_lora_rank, cfg.n_heads * m.qk_head_dim),
                              (None, "heads")),
            "wkv_a": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                               ("embed", None)),
            "kv_norm": norm_spec(cfg, m.kv_lora_rank),
            "wkv_b": ParamSpec(
                (m.kv_lora_rank,
                 cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim)),
                (None, "heads")),
            "wo": ParamSpec((cfg.n_heads * m.v_head_dim, d),
                            ("heads", "embed")),
        }
    spec = {
        "wq": ParamSpec((d, cfg.n_heads * hd), ("embed", "heads")),
        "wk": ParamSpec((d, cfg.n_kv_heads * hd), ("embed", "kv_heads")),
        "wv": ParamSpec((d, cfg.n_kv_heads * hd), ("embed", "kv_heads")),
        "wo": ParamSpec((cfg.n_heads * hd, d), ("heads", "embed")),
    }
    if cfg.use_bias:
        spec["bq"] = ParamSpec((cfg.n_heads * hd,), ("heads",), init="zeros")
        spec["bk"] = ParamSpec((cfg.n_kv_heads * hd,), ("kv_heads",),
                               init="zeros")
        spec["bv"] = ParamSpec((cfg.n_kv_heads * hd,), ("kv_heads",),
                               init="zeros")
        spec["bo"] = ParamSpec((d,), ("embed",), init="zeros")
    return spec


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, H*D) -> (B, H, S, D), a transposed view."""
    b, s, hd = x.shape
    return x.reshape(b, s, n_heads, hd // n_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _project(params: Mapping, x: torch.Tensor, w: str,
             bias: str) -> torch.Tensor:
    y = x @ params[w]
    return y + params[bias] if bias in params else y


def _window(cfg: ArchConfig, window_override: Optional[int] = None) -> int:
    if window_override is not None:
        return window_override
    return cfg.sliding_window if cfg.attention == AttentionKind.SLIDING else 0


def _qkv(params: Mapping, cfg: ArchConfig, x: torch.Tensor):
    """The GQA projections, split into heads (B, H, S, D). On a mesh each
    fused projection first takes a layout its heads can split from (the
    reference leaves that to XLA); without rules those are no-ops."""
    q = constrain_heads(_project(params, x, "wq", "bq"), cfg.n_heads,
                        _FUSED_Q)
    k = constrain_heads(_project(params, x, "wk", "bk"), cfg.n_kv_heads,
                        _FUSED_KV)
    v = constrain_heads(_project(params, x, "wv", "bv"), cfg.n_kv_heads,
                        _FUSED_KV)
    return (_split_heads(q, cfg.n_heads), _split_heads(k, cfg.n_kv_heads),
            _split_heads(v, cfg.n_kv_heads))


# ------------------------------------------------------------ GQA full pass
def attn_apply(
    params: Mapping,
    cfg: ArchConfig,
    x: torch.Tensor,                      # (B, S, E)
    positions: Optional[torch.Tensor] = None,
    window_override: Optional[int] = None,
) -> torch.Tensor:
    if cfg.attention == AttentionKind.MLA:
        return _mla_apply(params, cfg, x, positions)
    s = x.shape[1]
    q, k, v = _qkv(params, cfg, x)
    # q heads shard over "model" (kv heads often < model size: see
    # constrain_attention). seq stays local here even under
    # sequence-parallel residual streams (attention needs the full
    # sequence per head).
    q = constrain(q, _HEADS)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    if cfg.attention != AttentionKind.BIDIR:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q, k, v = constrain_attention(q, k, v, _HEADS)
    causal = cfg.attention != AttentionKind.BIDIR
    out = flash_attention(q, k, v, causal=causal,
                          window=_window(cfg, window_override))
    out = constrain(out, _HEADS)
    # the fused layout the heads split from, for the gradient on its way
    # back through the merge
    merged = constrain_heads(_merge_heads(out), cfg.n_heads, _FUSED_Q)
    return _project(params, merged, "wo", "bo")


# ------------------------------------------------------------- GQA decode
def attn_cache_spec(cfg: ArchConfig, batch: int, cache_len: int,
                    window_override: Optional[int] = None,
                    dtype: torch.dtype = torch.bfloat16) -> Dict:
    """KV cache specs for one layer: a ring buffer of
    ``min(cache_len, window)`` positions under a sliding window; MLA's
    compressed (latent, rope key) cache."""
    if cfg.attention == AttentionKind.MLA:
        m = cfg.mla
        return {
            "ckv": CacheSpec((batch, cache_len, m.kv_lora_rank), dtype),
            "krope": CacheSpec((batch, cache_len, m.qk_rope_head_dim),
                               dtype),
            "length": CacheSpec((batch,), torch.int32),
        }
    hd = cfg.resolved_head_dim
    window = _window(cfg, window_override)
    eff = min(cache_len, window) if window > 0 else cache_len
    return {
        "k": CacheSpec((batch, cfg.n_kv_heads, eff, hd), dtype),
        "v": CacheSpec((batch, cfg.n_kv_heads, eff, hd), dtype),
        "length": CacheSpec((batch,), torch.int32),
    }


def alloc_cache(specs: List[Dict], device: torch.device) -> List[Dict]:
    """Zero tensors for per-layer cache specs."""
    return [{name: torch.zeros(s.shape, dtype=s.dtype, device=device)
             for name, s in layer.items()} for layer in specs]


def attn_decode(
    params: Mapping,
    cfg: ArchConfig,
    x: torch.Tensor,                      # (B, 1, E)
    cache: Dict,
    pos: torch.Tensor,                    # (B,) absolute positions
    window_override: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict]:
    """One decode step of one layer. The new key and value are written in
    place into the ring-buffer slot ``length % cache_len`` of ``cache``'s
    tensors (the caller owns the cache); the returned cache shares them
    and carries ``length + 1``. The ring buffer's size is the window, set
    by :func:`attn_cache_spec`'s ``window_override``: this function's
    ``window_override`` is kept for the reference's signature only and
    is not read."""
    if cfg.attention == AttentionKind.MLA:
        return _mla_decode(params, cfg, x, cache, pos)
    b = x.shape[0]
    q, k, v = _qkv(params, cfg, x)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)    # (B, H, 1, hd)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    # on a mesh the query takes the cache's layout (its kv heads or its
    # head dim split), so that no device gathers the cache
    q = constrain(q, ("act_batch", "act_kv_heads", None, "act_head_dim"))

    cache_k, cache_v = cache["k"], cache["v"]
    cache_len = cache_k.shape[2]
    slot = (cache["length"] % cache_len).long()   # ring-buffer slot
    # in place, each device its own shard on a mesh
    bidx = torch.arange(b, device=x.device)
    cache_write_(cache_k, k[:, :, 0].to(cache_k.dtype), slot, bidx, seq_dim=2)
    cache_write_(cache_v, v[:, :, 0].to(cache_v.dtype), slot, bidx, seq_dim=2)
    new_len = cache["length"] + 1
    valid = torch.clamp(new_len, max=cache_len)

    out = decode_attention(q[:, :, 0], cache_k, cache_v, lengths=valid)
    y = _project(params, out.reshape(b, 1, -1), "wo", "bo")
    return y, {"k": cache_k, "v": cache_v, "length": new_len}


# ----------------------------------------------------------------- MLA paths
def _mla_project(params: Mapping, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    m = cfg.mla
    b, s, _ = x.shape
    q = norm_apply(params["q_norm"], cfg, x @ params["wq_a"]) @ params["wq_b"]
    q = q.reshape(b, s, cfg.n_heads, m.qk_head_dim).transpose(1, 2)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                        cfg.rope_theta)

    kv_a = x @ params["wkv_a"]                            # (B,S,lora+rope)
    ckv = norm_apply(params["kv_norm"], cfg, kv_a[..., :m.kv_lora_rank])
    k_rope = apply_rope(kv_a[..., m.kv_lora_rank:], positions,
                        cfg.rope_theta)
    return q_nope, q_rope, ckv, k_rope


def mla_operands(params: Mapping, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """The flash-attention operands of MLA's full pass: q and k (B, H, S,
    qk_head_dim), contiguous, and v zero-padded from v_head_dim to
    qk_head_dim, so the kernel sees one head dim."""
    m = cfg.mla
    b, s, _ = x.shape
    q_nope, q_rope, ckv, k_rope = _mla_project(params, cfg, x, positions)
    kv = (ckv @ params["wkv_b"]).reshape(
        b, s, cfg.n_heads, m.qk_nope_head_dim + m.v_head_dim).transpose(1, 2)
    k_nope = kv[..., :m.qk_nope_head_dim]
    v = kv[..., m.qk_nope_head_dim:]
    # decoupled-rope key shared across heads
    k_rope_h = k_rope[:, None].expand(b, cfg.n_heads, s,
                                      m.qk_rope_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_h], dim=-1)
    v_p = F.pad(v, (0, m.qk_head_dim - m.v_head_dim))
    return q, k, v_p


def _mla_apply(params: Mapping, cfg: ArchConfig, x: torch.Tensor,
               positions: Optional[torch.Tensor]) -> torch.Tensor:
    """Train/prefill: expand the latent KV and run standard attention."""
    m = cfg.mla
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    q, k, v_p = mla_operands(params, cfg, x, positions)
    out = flash_attention(q, k, v_p, causal=True,
                          scale=float(m.qk_head_dim) ** -0.5)
    return _merge_heads(out[..., :m.v_head_dim]) @ params["wo"]


def _mla_decode(params: Mapping, cfg: ArchConfig, x: torch.Tensor,
                cache: Dict, pos: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Absorbed decode against the compressed (ckv, k_rope) cache, in
    float32; the new latent and rope key are written in place into slot
    ``length % cache_len`` of ``cache``'s tensors."""
    m = cfg.mla
    b = x.shape[0]
    q_nope, q_rope, ckv_new, krope_new = _mla_project(
        params, cfg, x, pos[:, None])
    # absorb W_kv_b's key half into the query: q_lat = q_nope @ W_uk^T
    wkv_b = params["wkv_b"].reshape(
        m.kv_lora_rank, cfg.n_heads, m.qk_nope_head_dim + m.v_head_dim)
    w_uk = wkv_b[..., :m.qk_nope_head_dim]          # (lora, H, nope)
    w_uv = wkv_b[..., m.qk_nope_head_dim:]          # (lora, H, v)
    q_lat = torch.einsum("bhqd,lhd->bhql", q_nope, w_uk)   # (B,H,1,lora)

    ckv, krope = cache["ckv"], cache["krope"]
    cache_len = ckv.shape[1]
    slot = (cache["length"] % cache_len).long()
    bidx = torch.arange(b, device=x.device)
    cache_write_(ckv, ckv_new[:, 0].to(ckv.dtype), slot, bidx, seq_dim=1)
    cache_write_(krope, krope_new[:, 0].to(krope.dtype), slot, bidx,
                 seq_dim=1)
    new_len = cache["length"] + 1
    valid = torch.clamp(new_len, max=cache_len)

    scale = float(m.qk_head_dim) ** -0.5
    ckv32 = ckv.to(torch.float32)
    logits = (torch.einsum("bhql,bsl->bhqs", q_lat.to(torch.float32), ckv32)
              + torch.einsum("bhqd,bsd->bhqs", q_rope.to(torch.float32),
                             krope.to(torch.float32))) * scale
    mask = (torch.arange(cache_len, device=x.device)[None, None, None, :]
            < valid[:, None, None, None])
    logits = torch.where(mask, logits, torch.tensor(-1e30, device=x.device))
    probs = torch.softmax(logits, dim=-1)
    lat = torch.einsum("bhqs,bsl->bhql", probs, ckv32)      # (B,H,1,lora)
    out = torch.einsum("bhql,lhd->bhqd", lat, w_uv.to(torch.float32))
    y = _merge_heads(out.to(x.dtype)) @ params["wo"]
    return y, {"ckv": ckv, "krope": krope, "length": new_len}
