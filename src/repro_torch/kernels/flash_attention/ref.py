"""Plain torch version of flash attention: exact softmax attention with
the kernel's mask menu (the twin of ``repro/kernels/flash_attention/ref.py``).

It serves the tests, ``chip_smoke.py``'s comparisons, and the wrapper
for tensors on the CPU; it materializes the (Sq, Sk) logits.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_mask(q_len: int, k_len: int, causal: bool = True,
                   window: int = 0, q_offset: int = 0,
                   device=None) -> torch.Tensor:
    """(q_len, k_len) boolean mask. ``window`` > 0 adds a sliding window
    (key within ``window`` positions behind the query). ``q_offset``
    places the query block at absolute position q_offset. Query and key
    positions both count from 0 (top-left alignment)."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(k_len, device=device)[None, :]
    mask = torch.ones((q_len, k_len), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window > 0:
        mask &= kj > qi - window
    return mask


def default_scale(d: int, dtype: torch.dtype) -> float:
    """The reference's ``1 / sqrt(d).astype(dtype)``: in bfloat16 it
    rounds sqrt(d) and the quotient to bfloat16. The CUDA kernel, like
    the Pallas one, uses the exact ``d ** -0.5``; the two agree where
    sqrt(d) is a power of two (d = 16, 64, 256)."""
    root = torch.tensor(float(d), dtype=torch.float32).sqrt().to(dtype)
    return float((1.0 / root).item())


def flash_attention_ref(
    q: torch.Tensor,            # (B, Hq, Sq, D)
    k: torch.Tensor,            # (B, Hkv, Sk, D)
    v: torch.Tensor,            # (B, Hkv, Sk, D)
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """``q_offset`` places the query rows at absolute positions from it
    on (a slice of a longer sequence's rows); keys count from 0."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = scale if scale is not None else default_scale(d, q.dtype)
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * scale
    mask = attention_mask(sq, k.shape[2], causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    logits = torch.where(mask[None, None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vx)
    return out.to(q.dtype)
