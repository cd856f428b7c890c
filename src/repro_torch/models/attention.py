"""Attention blocks: GQA with full, sliding-window or bidirectional masks
(the twin of ``repro/models/attention.py``, lines 32-182).

The full pass (forward, prefill) goes through the flash-attention op and
decode through the decode-attention op against a KV cache; on CUDA
tensors both are the port's hand-written kernels. Sliding-window archs
keep a ring-buffer cache of ``min(cache_len, window)`` positions: keys
are stored already rotated at their absolute positions, so the order of
the buffer does not matter.

MLA (the reference's lines 185-262) is not ported yet and raises. The
reference's activation-sharding calls are no-ops without rules and are
dropped until the port's ``parallel/`` slice.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.config.types import ArchConfig, AttentionKind
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope
from repro_torch.models.param import ParamSpec

_MLA_TODO = ("MLA attention is not ported yet (ROADMAP Queue 1: the rest "
             "of the LM stack)")


class CacheSpec(NamedTuple):
    """Shape and dtype of one cache tensor (the port's ShapeDtypeStruct)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


# ------------------------------------------------------------------ GQA spec
def attn_spec(cfg: ArchConfig) -> Dict:
    if cfg.attention == AttentionKind.MLA:
        raise NotImplementedError(_MLA_TODO)
    d = cfg.d_model
    hd = cfg.resolved_head_dim
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


def _window(cfg: ArchConfig) -> int:
    return cfg.sliding_window if cfg.attention == AttentionKind.SLIDING else 0


# ------------------------------------------------------------ GQA full pass
def attn_apply(
    params: Mapping,
    cfg: ArchConfig,
    x: torch.Tensor,                      # (B, S, E)
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if cfg.attention == AttentionKind.MLA:
        raise NotImplementedError(_MLA_TODO)
    s = x.shape[1]
    q = _split_heads(_project(params, x, "wq", "bq"), cfg.n_heads)
    k = _split_heads(_project(params, x, "wk", "bk"), cfg.n_kv_heads)
    v = _split_heads(_project(params, x, "wv", "bv"), cfg.n_kv_heads)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    if cfg.attention != AttentionKind.BIDIR:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    causal = cfg.attention != AttentionKind.BIDIR
    out = flash_attention(q, k, v, causal=causal,
                          window=_window(cfg))
    return _project(params, _merge_heads(out), "wo", "bo")


# ------------------------------------------------------------- GQA decode
def attn_cache_spec(cfg: ArchConfig, batch: int, cache_len: int,
                    dtype: torch.dtype = torch.bfloat16) -> Dict:
    """KV cache specs for one layer: a ring buffer of
    ``min(cache_len, window)`` positions under a sliding window."""
    if cfg.attention == AttentionKind.MLA:
        raise NotImplementedError(_MLA_TODO)
    hd = cfg.resolved_head_dim
    window = _window(cfg)
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
) -> Tuple[torch.Tensor, Dict]:
    """One decode step of one layer. The new key and value are written in
    place into the ring-buffer slot ``length % cache_len`` of ``cache``'s
    tensors (the caller owns the cache); the returned cache shares them
    and carries ``length + 1``."""
    if cfg.attention == AttentionKind.MLA:
        raise NotImplementedError(_MLA_TODO)
    b = x.shape[0]
    q = _split_heads(_project(params, x, "wq", "bq"), cfg.n_heads)
    k = _split_heads(_project(params, x, "wk", "bk"), cfg.n_kv_heads)
    v = _split_heads(_project(params, x, "wv", "bv"), cfg.n_kv_heads)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)    # (B, H, 1, hd)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)

    cache_k, cache_v = cache["k"], cache["v"]
    cache_len = cache_k.shape[2]
    slot = (cache["length"] % cache_len).long()   # ring-buffer slot
    bidx = torch.arange(b, device=x.device)
    cache_k[bidx, :, slot] = k[:, :, 0].to(cache_k.dtype)
    cache_v[bidx, :, slot] = v[:, :, 0].to(cache_v.dtype)
    new_len = cache["length"] + 1
    valid = torch.clamp(new_len, max=cache_len)

    out = decode_attention(q[:, :, 0], cache_k, cache_v, lengths=valid)
    y = _project(params, out.reshape(b, 1, -1), "wo", "bo")
    return y, {"k": cache_k, "v": cache_v, "length": new_len}
