"""Meta-device stand-ins for every model input (the dry run's; the twin
of ``repro/launch/input_specs.py``).

Zero allocation, shardable. ``decode_*`` / ``long_*`` shapes produce
(tokens, cache, positions) for the decode step; train/prefill produce the
batch dict for the train / prefill step. Dtypes are the reference's:
bfloat16 frames and patches, int32 tokens, labels and positions (the
port's models take int32 or int64 tokens and index with ``.long()``),
the cache in ``cache_dtype`` with int32 lengths.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.config.types import ArchConfig, Family, ShapeConfig
from repro_torch.models.attention import alloc_cache
from repro_torch.models.lm import LanguageModel

META = torch.device("meta")


def _sds(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def skip_reason(cfg: ArchConfig, shape: ShapeConfig) -> str | None:
    """Why a cell is skipped, or None if runnable."""
    if not cfg.decoder and shape.kind in ("decode", "long_decode"):
        return "encoder-only: no decode step"
    if shape.kind == "long_decode" and not cfg.sub_quadratic:
        return "pure full attention: long_500k requires sub-quadratic"
    return None


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig,
                      with_labels: bool = True) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == Family.AUDIO:
        out = {"frames": _sds((b, s, cfg.d_model), torch.bfloat16)}
        if with_labels:
            out["labels"] = _sds((b, s), torch.int32)
        return out
    if cfg.family == Family.VLM:
        t = s - cfg.frontend_tokens
        out = {"tokens": _sds((b, t), torch.int32),
               "patches": _sds((b, cfg.frontend_tokens, cfg.d_model),
                               torch.bfloat16)}
        if with_labels:
            out["labels"] = _sds((b, t), torch.int32)
        return out
    out = {"tokens": _sds((b, s), torch.int32)}
    if with_labels:
        out["labels"] = _sds((b, s), torch.int32)
    return out


def decode_specs(model: LanguageModel, shape: ShapeConfig,
                 cache_dtype: torch.dtype = torch.bfloat16
                 ) -> Tuple[Any, Any, Any]:
    b = shape.global_batch
    tokens = _sds((b,), torch.int32)
    cache = alloc_cache(model.cache_spec(b, shape.seq_len, dtype=cache_dtype),
                        META)
    pos = _sds((b,), torch.int32)
    return tokens, cache, pos


def input_specs(model: LanguageModel, shape: ShapeConfig) -> Dict[str, Any]:
    """All stand-ins for one (arch x shape) cell, keyed by role."""
    cfg = model.cfg
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape, with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": train_batch_specs(cfg, shape, with_labels=False)}
    tokens, cache, pos = decode_specs(model, shape)
    return {"tokens": tokens, "cache": cache, "pos": pos}
