"""Plain torch version of decode attention: one token per sequence
against a KV cache (the twin of ``repro/kernels/decode_attention/ref.py``).

Queries are grouped per kv-head and contracted against the cache as it
is, without repeating K/V. It serves the tests, ``chip_smoke.py``'s
comparisons, and the wrapper for tensors on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(
    q: torch.Tensor,                 # (B, Hq, D), one new token each
    k: torch.Tensor,                 # (B, Hkv, S, D) KV cache
    v: torch.Tensor,                 # (B, Hkv, S, D)
    lengths: Optional[torch.Tensor] = None,   # (B,) valid cache lengths
    scale: Optional[float] = None,
) -> torch.Tensor:                   # (B, Hq, D)
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = scale if scale is not None else float(d) ** -0.5
    qg = q.reshape(b, hkv, group, d).float()
    logits = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) * scale
    if lengths is not None:
        pos = torch.arange(s, device=q.device)[None, None, None, :]
        logits = torch.where(pos < lengths.to(q.device)[:, None, None, None],
                             logits, torch.tensor(NEG_INF, device=q.device))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bksd->bkgd", probs, v.float())
    return out.reshape(b, hq, d).to(q.dtype)
