"""Shared building blocks: norms, MLPs, embeddings, rotary embeddings
(the twin of ``repro/models/layers.py``).

Plain functions on tensors and on dicts of parameters (an
``nn.ParameterDict`` or a plain dict). The matrix products are
``torch.matmul``: the reference leaves them to XLA, outside any Pallas
kernel. The activation-sharding calls (``parallel/constraints.constrain``)
stand where the reference's do: no-ops without rules, a DTensor's
redistribution with them.
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.config.types import ArchConfig, Family
from repro_torch.models.param import ParamSpec
from repro_torch.parallel.constraints import constrain

F32 = torch.float32


# --------------------------------------------------------------------- norms
def norm_spec(cfg: ArchConfig, dim: Optional[int] = None) -> Dict:
    d = dim or cfg.d_model
    spec = {"scale": ParamSpec((d,), ("embed",), init="ones")}
    if cfg.norm == "layernorm" and cfg.use_bias:
        spec["bias"] = ParamSpec((d,), ("embed",), init="zeros")
    return spec


def norm_apply(params: Mapping, cfg: ArchConfig,
               x: torch.Tensor) -> torch.Tensor:
    """RMS or layer norm, computed in float32 and cast back to ``x``'s
    dtype."""
    xf = x.to(F32)
    if cfg.norm == "rmsnorm":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6)
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
    y = y * params["scale"].to(F32)
    if "bias" in params:
        y = y + params["bias"].to(F32)
    return y.to(x.dtype)


# ----------------------------------------------------------------------- MLP
def mlp_spec(cfg: ArchConfig, d_ff: Optional[int] = None) -> Dict:
    """Gated (SwiGLU/GeGLU) for silu/gelu llama-family; plain for HuBERT
    (with biases where ``cfg.use_bias``)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.family == Family.AUDIO:
        spec = {
            "wi": ParamSpec((d, f), ("embed", "ffn")),
            "wo": ParamSpec((f, d), ("ffn", "embed")),
        }
        if cfg.use_bias:
            spec["bi"] = ParamSpec((f,), ("ffn",), init="zeros")
            spec["bo"] = ParamSpec((d,), ("embed",), init="zeros")
        return spec
    return {
        "wg": ParamSpec((d, f), ("embed", "ffn")),
        "wi": ParamSpec((d, f), ("embed", "ffn")),
        "wo": ParamSpec((f, d), ("ffn", "embed")),
    }


def _act(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if cfg.activation == "silu" else F.gelu(
        x, approximate="tanh")


def mlp_apply(params: Mapping, cfg: ArchConfig,
              x: torch.Tensor) -> torch.Tensor:
    if "wg" in params:
        g = _act(cfg, x @ params["wg"])
        h = g * (x @ params["wi"])
        h = constrain(h, ("act_batch", None, "act_model"))
        return h @ params["wo"]
    h = x @ params["wi"]
    if "bi" in params:
        h = h + params["bi"]
    h = _act(cfg, h)
    h = constrain(h, ("act_batch", None, "act_model"))
    y = h @ params["wo"]
    if "bo" in params:
        y = y + params["bo"]
    return y


# ----------------------------------------------------------------- embedding
def embed_spec(cfg: ArchConfig) -> Dict:
    spec = {"tokens": ParamSpec((cfg.vocab_size, cfg.d_model),
                                ("vocab", "embed"), init_scale=1.0)}
    if not cfg.tie_embeddings:
        spec["head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                 ("embed", "vocab"))
    if cfg.frontend is not None:
        # modality stub: precomputed frame/patch embeddings -> d_model
        spec["frontend_proj"] = ParamSpec((cfg.d_model, cfg.d_model),
                                          ("embed", None))
    return spec


def embed_tokens(params: Mapping, tokens: torch.Tensor) -> torch.Tensor:
    """Activations follow the parameter dtype (bf16 at scale, f32 in
    tests)."""
    return params["tokens"][tokens]


def embed_frontend(params: Mapping, feats: torch.Tensor) -> torch.Tensor:
    """Project precomputed modality embeddings (audio frames, image
    patches) into the LM stream, in the parameters' dtype."""
    proj = params["frontend_proj"]
    return feats.to(proj.dtype) @ proj


def lm_logits(params: Mapping, x: torch.Tensor) -> torch.Tensor:
    if "head" in params:
        return x @ params["head"]
    return x @ params["tokens"].to(x.dtype).T


# ---------------------------------------------------------------------- RoPE
def rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    """The (dim/2,) rotary frequencies ``1 / theta ** (2i / dim)`` in
    ``F32``, kept on ``device`` (once per dim, theta, type and device).
    The exponents are rounded to float32 as the reference rounds them;
    the power and the reciprocal are taken in float64 on the host and
    rounded once, which is what XLA's constant folding gives the
    reference's compiled model bit for bit. A float32 ``pow`` (the
    reference run op by op, torch's on the host or the card's) is an
    ulp off for some ``i``, and an angle at position p then moves by p
    such ulps: 0.03 rad at position 524,287."""
    return _rope_freqs(dim, float(theta), F32, torch.device(device))


@functools.lru_cache(maxsize=None)
def _rope_freqs(dim: int, theta: float, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        exps = (torch.arange(0, dim, 2, dtype=dtype) / dim).double()
        return (1.0 / (theta ** exps)).to(dtype).to(device)


def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> torch.Tensor:
    """(..., dim/2) rotary angles for absolute positions."""
    return positions.to(F32)[..., None] * rope_freqs(dim, theta,
                                                     positions.device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotary embedding. x: (B, H, S, D) or (B, S, D);
    positions: (B, S) or (S,)."""
    d = x.shape[-1]
    ang = rope_angles(positions, d, theta)           # (..., S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() == 4 and cos.dim() == 3:              # add head axis
        cos, sin = cos[:, None], sin[:, None]
    elif x.dim() == 4 and cos.dim() == 2:
        cos, sin = cos[None, None], sin[None, None]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
