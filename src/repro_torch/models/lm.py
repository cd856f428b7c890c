"""The language model of the port's serving path (the twin of
``repro/models/lm.py``) for the dense GQA family.

:class:`LanguageModel` is an ``nn.Module``: embedding, one
:class:`Block` module per layer in an ``nn.ModuleList`` (the reference
stacks the layers' params and runs ``lax.scan``), final norm and the
(tied) LM head. Weights keep the reference's ``(in, out)`` layout and
are applied as ``x @ w``. The model serves: its parameters are made
without gradients, and the loss, remat and the other families (MoE, SSM,
hybrid, VLM, audio, MTP) wait for later slices and raise at construction.

Entry points:
  forward(batch)                     -> (logits (B, S, V), aux)
  prefill(batch, cache_len)          -> last-token logits (B, V)
  decode_step(tokens, cache, pos)    -> (logits (B, V), cache)
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Tuple

import torch
from torch import nn

from repro_torch.config.types import ArchConfig, AttentionKind, Family
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec, init_tensor


# ------------------------------------------------------------- block layout
def _block_kind(cfg: ArchConfig, idx: int) -> str:
    if cfg.family == Family.SSM:
        return "ssm"
    if cfg.family == Family.HYBRID:
        pat = cfg.rglru.block_pattern
        kind = pat[idx % len(pat)]
        return "rec" if kind == "recurrent" else "attn_local"
    return "attn"


def _block_spec(cfg: ArchConfig) -> Dict:
    return {"ln1": L.norm_spec(cfg), "attn": attn.attn_spec(cfg),
            "ln2": L.norm_spec(cfg), "mlp": L.mlp_spec(cfg)}


def _params(spec: Dict[str, ParamSpec], device: torch.device,
            dtype: torch.dtype) -> nn.ParameterDict:
    """Uninitialized parameters, without gradients, for a dict of specs."""
    return nn.ParameterDict({
        name: nn.Parameter(torch.empty(s.shape, dtype=dtype, device=device),
                           requires_grad=False)
        for name, s in spec.items()})


def _supported(cfg: ArchConfig) -> None:
    if cfg.family != Family.DENSE:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family.value} family is not ported yet "
            f"(ROADMAP Queue 1: the rest of the LM stack)")
    if cfg.attention not in (AttentionKind.FULL, AttentionKind.SLIDING,
                             AttentionKind.BIDIR):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.attention.value} attention is not ported yet "
            f"(ROADMAP Queue 1: the rest of the LM stack)")
    if cfg.mtp_depth or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: MTP heads and modality frontends are not ported "
            f"yet (ROADMAP Queue 1: the rest of the LM stack)")


class Block(nn.Module):
    """One pre-norm decoder layer: attention, then the gated MLP."""

    def __init__(self, cfg: ArchConfig, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        spec = _block_spec(cfg)
        self.ln1 = _params(spec["ln1"], device, dtype)
        self.attn = _params(spec["attn"], device, dtype)
        self.ln2 = _params(spec["ln2"], device, dtype)
        self.mlp = _params(spec["mlp"], device, dtype)

    def param_tree(self) -> Dict[str, nn.ParameterDict]:
        return {"ln1": self.ln1, "attn": self.attn, "ln2": self.ln2,
                "mlp": self.mlp}

    def forward(self, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = x + attn.attn_apply(self.attn, cfg, L.norm_apply(self.ln1, cfg, x),
                                positions=positions)
        return x + L.mlp_apply(self.mlp, cfg, L.norm_apply(self.ln2, cfg, x))

    def decode(self, x: torch.Tensor, cache: Dict,
               pos: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        y, new = attn.attn_decode(self.attn, cfg,
                                  L.norm_apply(self.ln1, cfg, x), cache, pos)
        x = x + y
        return x + L.mlp_apply(self.mlp, cfg,
                               L.norm_apply(self.ln2, cfg, x)), new


def _pairs(specs, params) -> Iterator[Tuple[ParamSpec, nn.Parameter]]:
    """(spec, parameter) pairs of two trees of one layout, in the spec
    tree's order."""
    if isinstance(specs, dict):
        for k, s in specs.items():
            yield from _pairs(s, params[k])
    elif isinstance(specs, list):
        for s, p in zip(specs, params, strict=True):
            yield from _pairs(s, p)
    else:
        yield specs, params


# --------------------------------------------------------------------- model
class LanguageModel(nn.Module):
    def __init__(self, cfg: ArchConfig, device: DeviceLike = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        _supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.kinds = tuple(_block_kind(cfg, i) for i in range(cfg.n_layers))
        self.embedding = _params(L.embed_spec(cfg), self.device, dtype)
        self.final_norm = _params(L.norm_spec(cfg), self.device, dtype)
        self.layers = nn.ModuleList(Block(cfg, self.device, dtype)
                                    for _ in range(cfg.n_layers))

    # ----------------------------------------------------------------- specs
    def param_specs(self) -> Dict:
        """The reference's spec tree with per-layer dicts (its
        ``scan_layers=False`` layout)."""
        cfg = self.cfg
        return {"embed": L.embed_spec(cfg), "final_norm": L.norm_spec(cfg),
                "layers": [_block_spec(cfg) for _ in self.kinds]}

    def param_tree(self) -> Dict[str, Any]:
        """The module's parameters in the layout of :meth:`param_specs`."""
        return {"embed": self.embedding, "final_norm": self.final_norm,
                "layers": [blk.param_tree() for blk in self.layers]}

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LanguageModel":
        """Random weights by the reference's init rules, drawn from
        ``generator`` one parameter at a time, in spec-tree order."""
        for spec, p in _pairs(self.param_specs(), self.param_tree()):
            p.copy_(init_tensor(spec, generator, self.dtype, self.device))
        return self

    # --------------------------------------------------------------- forward
    def embed(self, batch: Mapping) -> torch.Tensor:
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        return L.embed_tokens(self.embedding, tokens.long())

    def forward(self, batch: Mapping) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence pass -> (logits (B, S, V), aux loss 0)."""
        x = self.embed(batch)
        positions = torch.arange(x.shape[1], device=self.device)
        for blk in self.layers:
            x = blk(x, positions)
        x = L.norm_apply(self.final_norm, self.cfg, x)
        logits = L.lm_logits(self.embedding, x)
        return logits, torch.zeros((), dtype=torch.float32,
                                   device=self.device)

    # --------------------------------------------------------------- serving
    def cache_spec(self, batch: int, cache_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> List[Dict]:
        return [attn.attn_cache_spec(self.cfg, batch, cache_len, dtype=dtype)
                for _ in self.kinds]

    def init_cache(self, batch: int, cache_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> List[Dict]:
        return attn.alloc_cache(self.cache_spec(batch, cache_len, dtype),
                                self.device)

    def decode_step(self, tokens, cache: List[Dict],
                    pos) -> Tuple[torch.Tensor, List[Dict]]:
        """tokens: (B,) int; pos: (B,) int32 absolute positions.
        -> (logits (B, V), cache); the KV tensors are updated in place."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        pos = torch.as_tensor(pos, device=self.device)
        x = L.embed_tokens(self.embedding, tokens[:, None])
        new_cache = []
        for blk, c in zip(self.layers, cache):
            x, nc = blk.decode(x, c, pos)
            new_cache.append(nc)
        x = L.norm_apply(self.final_norm, self.cfg, x)
        return L.lm_logits(self.embedding, x)[:, 0], new_cache

    def prefill(self, batch: Mapping, cache_len: int) -> torch.Tensor:
        """Last-token logits of the full prompt, by ``forward`` (as the
        reference's ``prefill``; it fills no cache)."""
        logits, _ = self.forward(batch)
        return logits[:, -1]


def build_model(cfg: ArchConfig, device: DeviceLike = None,
                dtype: torch.dtype = torch.bfloat16) -> LanguageModel:
    return LanguageModel(cfg, device=device, dtype=dtype)
