"""RecurrentGemma RG-LRU recurrent block (Griffin, arXiv:2402.19427); the
twin of ``repro/models/rglru.py``.

Block = two branches: (linear -> causal conv1d -> RG-LRU) * (linear -> GeLU)
-> merge -> linear out. The RG-LRU gate:

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Train/prefill evaluate the linear recurrence with :func:`associative_scan`,
a copy of the recursion of ``jax.lax.associative_scan`` (log-depth, and
the reference's order of combines); decode is the O(1) update, written
into the cache's tensors in place. The reference runs this in jnp/XLA,
outside any Pallas kernel, so torch ops are a whole port of it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.types import ArchConfig
from repro_torch.models.attention import CacheSpec
from repro_torch.models.param import ParamSpec
from repro_torch.models.ssm import causal_conv, softplus
from repro_torch.parallel.constraints import constrain
from repro_torch.parallel.local import grouped

F32 = torch.float32
_C = 8.0


def rglru_spec(cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    w = cfg.rglru.lru_width
    cw = cfg.rglru.conv_width
    return {
        "in_y": ParamSpec((d, w), ("embed", "inner")),
        "in_gate": ParamSpec((d, w), ("embed", "inner")),
        "conv_w": ParamSpec((cw, w), (None, "inner")),
        "conv_b": ParamSpec((w,), ("inner",), init="zeros"),
        "wa": ParamSpec((w, w), (None, "inner")),
        "ba": ParamSpec((w,), ("inner",), init="zeros"),
        "wx": ParamSpec((w, w), (None, "inner")),
        "bx": ParamSpec((w,), ("inner",), init="zeros"),
        "lam": ParamSpec((w,), ("inner",), dtype=F32, init="ones"),
        "out": ParamSpec((w, d), ("inner", "embed")),
    }


def _gates(params: Mapping, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, sqrt(1 - a²) · i · x), both float32."""
    xf = x.to(F32)
    r = torch.sigmoid(xf @ params["wa"].to(F32) + params["ba"].to(F32))
    i = torch.sigmoid(xf @ params["wx"].to(F32) + params["bx"].to(F32))
    log_a = -_C * softplus(params["lam"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, gated


def _conv(params: Mapping, x: torch.Tensor) -> torch.Tensor:
    out = causal_conv(x, params["conv_w"].to(x.dtype))
    return out + params["conv_b"].to(x.dtype)


def _slice(x: torch.Tensor, axis: int, start: int, stop=None,
           step: int = 1) -> torch.Tensor:
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(start, stop, step)
    return x[tuple(idx)]


def _interleave(even: torch.Tensor, odd: torch.Tensor,
                axis: int) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along ``axis``."""
    shape = list(even.shape)
    shape[axis] = even.shape[axis] + odd.shape[axis]
    out = even.new_empty(shape)
    _slice(out, axis, 0, None, 2).copy_(even)
    _slice(out, axis, 1, None, 2).copy_(odd)
    return out


def associative_scan(fn: Callable[[Sequence[torch.Tensor],
                                   Sequence[torch.Tensor]],
                                  Sequence[torch.Tensor]],
                     elems: Sequence[torch.Tensor],
                     axis: int = 0) -> List[torch.Tensor]:
    """Inclusive scan of the tuple ``elems`` under the associative ``fn``
    along ``axis``, by the recursion of ``jax.lax.associative_scan``
    (``jax/_src/lax/control_flow/loops.py``): combine adjacent pairs,
    scan the result recursively (the odd outputs), combine those with the
    even inputs (the even outputs), put the first element back, and
    interleave. About 2 log2(S) levels of elementwise ops."""
    def _scan(elems: List[torch.Tensor]) -> List[torch.Tensor]:
        n = elems[0].shape[axis]
        if n < 2:
            return elems
        reduced = list(fn([_slice(e, axis, 0, -1, 2) for e in elems],
                          [_slice(e, axis, 1, None, 2) for e in elems]))
        odd = _scan(reduced)
        if n % 2 == 0:
            even = fn([_slice(e, axis, 0, -1) for e in odd],
                      [_slice(e, axis, 2, None, 2) for e in elems])
        else:
            even = fn(odd, [_slice(e, axis, 2, None, 2) for e in elems])
        even = [torch.cat([_slice(e, axis, 0, 1), r], dim=axis)
                for e, r in zip(elems, even)]
        return [_interleave(e, o, axis) for e, o in zip(even, odd)]

    return _scan(list(elems))


def _combine(c1, c2):
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def _scan(a: torch.Tensor, gated: torch.Tensor) -> List[torch.Tensor]:
    """The recurrence ``h_t = a_t * h_{t-1} + gated_t`` along the
    sequence, as an associative scan of (a, gated) pairs."""
    return associative_scan(_combine, (a, gated), axis=1)


def rglru_apply(params: Mapping, cfg: ArchConfig,
                x: torch.Tensor) -> torch.Tensor:
    """Train/prefill. x: (B, S, d)."""
    # on a mesh: the width split over "model", the sequence whole for the
    # scan, which then runs on each device's rows and channels
    y = constrain(_conv(params, x @ params["in_y"]),
                  ("act_batch", None, "act_model"))
    a, gated = _gates(params, y)                       # (b,s,w) each
    _, h = grouped(_scan, 2, a, gated, heads=(2, 2, 2, 2))
    gate = F.gelu(x @ params["in_gate"], approximate="tanh")
    return (h.to(x.dtype) * gate) @ params["out"]


def rglru_cache_spec(cfg: ArchConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16) -> Dict:
    """One layer's decode state: the float32 hidden state and the last
    ``conv_width - 1`` conv inputs; no sequence axis."""
    w = cfg.rglru.lru_width
    cw = cfg.rglru.conv_width
    return {
        "h": CacheSpec((batch, w), F32),
        "conv": CacheSpec((batch, cw - 1, w), dtype),
    }


def rglru_decode(params: Mapping, cfg: ArchConfig, x: torch.Tensor,
                 cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """O(1) step. x: (B, 1, d). The new hidden state and conv history are
    written into ``cache``'s tensors in place; the returned cache holds
    the same tensors."""
    y = (x @ params["in_y"])[:, 0]                     # (b, w)
    w = params["conv_w"].to(y.dtype)
    hist = torch.cat([cache["conv"],
                      y[:, None, :].to(cache["conv"].dtype)], dim=1)
    conv = (hist.to(F32) * w.to(F32)).sum(dim=1) + params["conv_b"].to(F32)
    a, gated = _gates(params, conv)                    # (b, w)
    h = a * cache["h"] + gated
    gate = F.gelu((x @ params["in_gate"])[:, 0], approximate="tanh")
    out = ((h.to(x.dtype) * gate) @ params["out"])[:, None, :]
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:])
    return out, {"h": cache["h"], "conv": cache["conv"]}
