"""Mamba-2 SSD layer (state-space duality, arXiv:2405.21060); the twin of
``repro/models/ssm.py``.

Train/prefill use the chunked block decomposition (paper Listing 1): the
sequence is split into chunks; within-chunk terms are attention-shaped
matrix products, across-chunk terms a short loop over chunk states
(O(S * Q) work with O(S/Q) sequential steps). Decode is the O(1)
recurrent update on the (H, P, N) state.

Layout: x (B, S, H, P) heads, B/C shared across heads (ngroups=1),
per-head scalar decay A (negative), discrete step dt via softplus.

The reference runs this in jnp/XLA, outside any Pallas kernel, so torch
ops are a whole port of it. Where torch would compute the same function
another way, the port spells out the reference's:

* the causal depthwise conv is the reference's sum of shifted products,
  in the model's dtype and in its order (not ``F.conv1d``, which cuDNN
  runs in TF32 by default and sums in another order);
* softplus is ``logaddexp(x, 0)``, as ``jax.nn.softplus`` (``F.softplus``
  returns ``x`` above a threshold);
* the intra-chunk term is float32 products in a fixed order: ``C Bᵀ`` per
  chunk, times the decay matrix ``L``, then times ``x`` (the reference's
  four-operand einsum, whose contraction path is left to the compiler).

Decode writes the new state and conv history into the cache's tensors in
place (``copy_``), as attention's KV cache is written: every cache
tensor keeps its address from step to step.
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.types import ArchConfig
from repro_torch.models.attention import CacheSpec
from repro_torch.models.param import ParamSpec
from repro_torch.parallel.constraints import constrain
from repro_torch.parallel.local import grouped

F32 = torch.float32


def ssm_spec(cfg: ArchConfig) -> Dict:
    s = cfg.ssm
    d = cfg.d_model
    inner = s.expand * d
    heads = s.n_heads(d)
    n = s.state_dim
    conv_dim = inner + 2 * n            # conv over [x, B, C]
    return {
        # in_proj emits [z (inner), x (inner), B (n), C (n), dt (heads)]
        "in_proj": ParamSpec((d, 2 * inner + 2 * n + heads),
                             ("embed", "inner")),
        "conv_w": ParamSpec((s.conv_width, conv_dim), (None, "inner")),
        "conv_b": ParamSpec((conv_dim,), ("inner",), init="zeros"),
        "A_log": ParamSpec((heads,), (None,), dtype=F32, init="ones"),
        "D": ParamSpec((heads,), (None,), dtype=F32, init="ones"),
        "dt_bias": ParamSpec((heads,), (None,), dtype=F32, init="zeros"),
        "norm_scale": ParamSpec((inner,), ("inner",), init="ones"),
        "out_proj": ParamSpec((inner, d), ("inner", "embed")),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` in ``x``'s dtype."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of x (B, S, C) with w (W, C): the reference's
    ``sum(pad[:, i:i + s] * w[i] for i in range(W))``, in x's dtype."""
    s = x.shape[1]
    pad = F.pad(x, (0, 0, w.shape[0] - 1, 0))
    return sum(pad[:, i:i + s, :] * w[i] for i in range(w.shape[0]))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L) lower-triangular segment sums:
    out[i, j] = sum_{j < k <= i} a[k], -inf above the diagonal."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(l, device=a.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, torch.tensor(-torch.inf, dtype=a.dtype,
                                                device=a.device))


def ssd_chunked(xdt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD block decomposition.

    xdt: (b, s, h, p) inputs pre-multiplied by dt; a: (b, s, h) log-decay
    per step; B, C: (b, s, n). Returns y: (b, s, h, p) and the final
    state (b, h, p, n), both float32.
    """
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    xc = xdt.reshape(b, nc, chunk, h, p).to(F32)
    xh = xc.permute(0, 3, 1, 2, 4)                          # (b,h,nc,l,p)
    Bc = B.reshape(b, nc, chunk, n).to(F32)
    Cc = C.reshape(b, nc, chunk, n).to(F32)
    ac = a.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)     # (b,h,nc,l)
    a_cum = torch.cumsum(ac, dim=-1)

    # (1) intra-chunk (diagonal blocks): (C Bᵀ) * L, then @ x
    L = torch.exp(_segsum(ac))                              # (b,h,nc,l,l)
    cb = Cc @ Bc.transpose(-1, -2)                          # (b,nc,l,s)
    y_diag = (cb[:, None] * L) @ xh                         # (b,h,nc,l,p)

    # (2) chunk states: (x * decay)ᵀ @ B
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)       # (b,h,nc,l)
    states = ((xh * decay_states[..., None]).transpose(-1, -2)
              @ Bc[:, None])                                # (b,h,nc,p,n)

    # (3) inter-chunk recurrence, each chunk's state BEFORE the chunk
    chunk_decay = torch.exp(a_cum[..., -1])                 # (b,h,nc)
    prev = torch.zeros((b, h, p, n), dtype=F32, device=xdt.device)
    before = []
    for c in range(nc):
        before.append(prev)
        prev = prev * chunk_decay[:, :, c, None, None] + states[:, :, c]
    prev_states = torch.stack(before, dim=2)                # (b,h,nc,p,n)

    # (4) state -> output within each chunk
    state_decay = torch.exp(a_cum)                          # (b,h,nc,l)
    y_off = ((Cc[:, None] @ prev_states.transpose(-1, -2))
             * state_decay[..., None])                      # (b,h,nc,l,p)
    y = (y_diag + y_off).permute(0, 2, 3, 1, 4).reshape(b, s, h, p)
    return y, prev


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """mamba2's gated RMSNorm before out_proj."""
    y = y * F.silu(z)
    yf = y.to(F32)
    var = (yf * yf).mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + 1e-6) * scale.to(F32)).to(dtype)


# the (B, S, channels) activations split on their channels over "model"
_FUSED = ("act_batch", None, "act_model")


def ssm_apply(params: Mapping, cfg: ArchConfig,
              x: torch.Tensor) -> torch.Tensor:
    """Train/prefill. x: (B, S, d)."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    inner = s_cfg.expand * d
    heads = s_cfg.n_heads(d)
    n = s_cfg.state_dim
    p = s_cfg.head_dim

    # on a mesh: the fused projection's gradient keeps its split (the
    # slices below gather it), and the mixer runs on each device's heads
    proj = constrain(x @ params["in_proj"], _FUSED)
    z = constrain(proj[..., :inner], _FUSED)
    xbc = proj[..., inner:inner + inner + 2 * n]
    dt = constrain(proj[..., -heads:], _FUSED)

    # causal depthwise conv over [x, B, C]
    conv = causal_conv(xbc, params["conv_w"].to(xbc.dtype))
    conv = F.silu(conv + params["conv_b"].to(conv.dtype))

    xs = constrain(conv[..., :inner].reshape(b, s, heads, p),
                   ("act_batch", None, "act_model", None))
    Bm = conv[..., inner:inner + n]
    Cm = conv[..., inner + n:]

    dt = softplus(dt.to(F32) + params["dt_bias"])           # (b,s,h)
    a = -torch.exp(params["A_log"]) * dt                    # log decay
    xdt = xs.to(F32) * dt[..., None]

    chunk = min(s_cfg.chunk_size, s)
    if s % chunk:
        chunk = 1
    # each batch row and head on its own: on a mesh, each device's
    y, _ = grouped(functools.partial(ssd_chunked, chunk=chunk), 2,
                   xdt, a, Bm, Cm, heads=(2, 2, None, None, 2, 1))
    y = y + params["D"][None, None, :, None] * xs.to(F32)
    y = y.reshape(b, s, inner).to(x.dtype)
    y = _gated_norm(y, z, params["norm_scale"], x.dtype)
    return y @ params["out_proj"]


def ssm_cache_spec(cfg: ArchConfig, batch: int,
                   dtype: torch.dtype = torch.float32) -> Dict:
    """One layer's decode state: the float32 (B, H, P, N) SSM state and
    the last ``conv_width - 1`` conv inputs; no sequence axis."""
    s = cfg.ssm
    d = cfg.d_model
    inner = s.expand * d
    heads = s.n_heads(d)
    conv_dim = inner + 2 * s.state_dim
    return {
        "state": CacheSpec((batch, heads, s.head_dim, s.state_dim), F32),
        "conv": CacheSpec((batch, s.conv_width - 1, conv_dim), dtype),
    }


def ssm_decode(params: Mapping, cfg: ArchConfig, x: torch.Tensor,
               cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """O(1) recurrent step. x: (B, 1, d). The new state and conv history
    are written into ``cache``'s tensors in place; the returned cache
    holds the same tensors."""
    s_cfg = cfg.ssm
    b, _, d = x.shape
    inner = s_cfg.expand * d
    heads = s_cfg.n_heads(d)
    n = s_cfg.state_dim
    p = s_cfg.head_dim

    proj = (x @ params["in_proj"])[:, 0]                    # (b, proj)
    z = proj[..., :inner]
    xbc = proj[..., inner:inner + inner + 2 * n]
    dt = proj[..., -heads:]

    w = params["conv_w"].to(xbc.dtype)
    hist = torch.cat([cache["conv"],
                      xbc[:, None, :].to(cache["conv"].dtype)], dim=1)
    conv = (hist.to(F32) * w.to(F32)).sum(dim=1)            # (b, dim)
    conv = F.silu(conv + params["conv_b"].to(F32))

    xs = conv[..., :inner].reshape(b, heads, p)
    Bm = conv[..., inner:inner + n]
    Cm = conv[..., inner + n:]

    dtv = softplus(dt.to(F32) + params["dt_bias"])          # (b,h)
    decay = torch.exp(-torch.exp(params["A_log"]) * dtv)    # (b,h)
    xdt = xs * dtv[..., None]                               # (b,h,p)
    new_state = (cache["state"] * decay[..., None, None]
                 + xdt[..., None] * Bm.to(F32)[:, None, None, :])
    y = (new_state @ Cm.to(F32)[:, None, :, None])[..., 0]  # (b,h,p)
    y = y + params["D"][None, :, None] * xs
    y = y.reshape(b, inner).to(x.dtype)
    y = (_gated_norm(y, z, params["norm_scale"], x.dtype)
         @ params["out_proj"])[:, None, :]
    cache["state"].copy_(new_state)
    cache["conv"].copy_(hist[:, 1:])
    return y, {"state": cache["state"], "conv": cache["conv"]}
