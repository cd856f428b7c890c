"""The language model of the port (the twin of ``repro/models/lm.py``)
for all six families: dense GQA, MoE (MLA attention and the MTP head
included), SSM (mamba2's SSD), the RG-LRU hybrid (recurrentgemma's 1:2
pattern of recurrent and local-attention blocks), the VLM (precomputed
image patches prepended to the text) and the audio encoder (precomputed
frames, bidirectional, no decode).

:class:`LanguageModel` is an ``nn.Module``: embedding (with the modality
frontend's projection), one :class:`Block` module per layer in an
``nn.ModuleList`` (the reference stacks a homogeneous stack's params and
runs ``lax.scan``, and loops over the hybrid's list), final norm, the
(tied) LM head and, where ``cfg.mtp_depth`` is set, the DeepSeek MTP
head (:class:`MTPHead`). Weights keep the reference's ``(in, out)``
layout and are applied as ``x @ w``; nested param dicts (an MoE block's
shared experts, MLA's norms) are nested ``nn.ParameterDict``s.
Parameters are made without gradients, which serving wants; the trainer
(``repro_torch.train.step``) turns them on with
``model.requires_grad_(True)``.

Entry points:
  forward(batch, remat)              -> (logits (B, S, V), aux)
  loss(batch, remat)                 -> cross-entropy + aux (+ 0.3 MTP)
  prefill(batch, cache_len)          -> last-token logits (B, V)
  decode_step(tokens, cache, pos)    -> (logits (B, V), cache)

``batch`` holds ``tokens`` (and ``patches`` for the VLM) or ``frames``
(audio). Decode embeds tokens alone, as the reference's: the VLM's
serving is text-only. Every cache tensor (KV ring buffers, SSM and
RG-LRU states, conv histories) is updated in place and keeps its
address from step to step.

``remat`` is the reference's rematerialization policy, applied per
block of every kind: ``"none"`` keeps every activation; ``"full"``
keeps only each block's input and recomputes the rest in backward
(``torch.utils.checkpoint``, non-reentrant); ``"dots"`` keeps the
outputs of the matrix products (the expert FFN's einsums among them,
and the attention op, whose plain version is matrix products) and
recomputes the rest, as
``jax.checkpoint_policies.checkpoint_dots`` does. Recomputation
repeats the same operations, so no number changes with the policy.
"""
from __future__ import annotations

import functools
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Tuple)

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config.types import ArchConfig, Family
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.param import ParamSpec, abstract, init_tensor
from repro_torch.parallel.constraints import constrain
from repro_torch.parallel.local import label_log_probs


# ------------------------------------------------------------- block layout
def _block_kind(cfg: ArchConfig, idx: int) -> str:
    if cfg.family == Family.SSM:
        return "ssm"
    if cfg.family == Family.HYBRID:
        pat = cfg.rglru.block_pattern
        kind = pat[idx % len(pat)]
        return "rec" if kind == "recurrent" else "attn_local"
    return "attn"


def _block_spec(cfg: ArchConfig, kind: str) -> Dict:
    if kind == "ssm":
        return {"ln1": L.norm_spec(cfg), "ssm": ssm_mod.ssm_spec(cfg)}
    if kind == "rec":
        return {"ln1": L.norm_spec(cfg), "rec": rglru_mod.rglru_spec(cfg),
                "ln2": L.norm_spec(cfg), "mlp": L.mlp_spec(cfg)}
    spec = {"ln1": L.norm_spec(cfg), "attn": attn.attn_spec(cfg),
            "ln2": L.norm_spec(cfg)}
    if cfg.moe is not None:
        spec["moe"] = moe_mod.moe_spec(cfg)
    else:
        spec["mlp"] = L.mlp_spec(cfg)
    return spec


def param_dtype(spec: ParamSpec, dtype: torch.dtype) -> torch.dtype:
    """The dtype a parameter of ``spec`` takes in a model of ``dtype``:
    the wider of the two. A bfloat16 model keeps the float32 specs (the
    router, the SSM's ``A_log``/``D``/``dt_bias``, the RG-LRU's ``lam``)
    in float32, as the reference's ``init(key)`` keeps each spec's own
    dtype; a float32 or float64 model holds every parameter in its
    dtype, as ``init(key, dtype=float32)`` casts them all."""
    return torch.promote_types(spec.dtype, dtype)


def _params(spec: Dict, device: torch.device,
            dtype: torch.dtype) -> nn.ParameterDict:
    """Uninitialized parameters, without gradients, for a dict of specs
    (a nested dict becomes a nested ``ParameterDict``), each in
    :func:`param_dtype`."""
    return nn.ParameterDict({
        name: (_params(s, device, dtype) if isinstance(s, dict) else
               nn.Parameter(torch.empty(s.shape,
                                        dtype=param_dtype(s, dtype),
                                        device=device),
                            requires_grad=False))
        for name, s in spec.items()})


def _window(cfg: ArchConfig, kind: str) -> Optional[int]:
    """The window an attention block of ``kind`` overrides ``cfg``'s
    with: the hybrid's ``attn_window`` for its local-attention blocks,
    else None. Its forward and its cache's ring buffer both take it
    from here; decode follows the buffer's size."""
    return cfg.rglru.attn_window if kind == "attn_local" else None


def _stream(y: torch.Tensor) -> torch.Tensor:
    """A sub-block's output as the residual stream is laid out. On a mesh
    its row-parallel output projection leaves partial sums over the
    model axis; reducing them here (Megatron's all-reduce, or its
    reduce-scatter where the stream is sequence-sharded) keeps the next
    norm and projection sharded, where DTensor would otherwise carry the
    partial sums on and run them whole on every device of the axis.
    Without rules it is a no-op."""
    return constrain(y, ("act_batch", "act_seq", None))


def _whole_sequence(h: torch.Tensor) -> torch.Tensor:
    """A sub-block's (or the head's) input with its whole sequence on
    each device. Where the residual stream is sequence-sharded
    (Megatron's sequence parallelism) this is its all-gather before the
    projections, which then see a plain batch-split layout (DTensor
    plans products over a sequence split on top of the batch split by a
    search that takes minutes on the 2x16x16 mesh). Without rules it is
    a no-op."""
    return constrain(h, ("act_batch", None, None))


class Block(nn.Module):
    """One pre-norm layer of one kind (``_block_kind``): ``"attn"``
    (attention, then the MLP or the mixture of experts), ``"attn_local"``
    (the same with the hybrid's window), ``"ssm"`` (the SSD mixer alone)
    or ``"rec"`` (the RG-LRU block, then the MLP)."""

    def __init__(self, cfg: ArchConfig, device: torch.device,
                 dtype: torch.dtype, kind: str = "attn"):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        spec = _block_spec(cfg, kind)
        self.names = tuple(spec)
        for name, s in spec.items():
            setattr(self, name, _params(s, device, dtype))

    def param_tree(self) -> Dict[str, nn.ParameterDict]:
        return {name: getattr(self, name) for name in self.names}

    def _ffn(self, h: torch.Tensor
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> (y, the router's aux loss, or None for an MLP)."""
        if "moe" in self.names:
            return moe_mod.moe_apply(self.moe, self.cfg, h)
        return L.mlp_apply(self.mlp, self.cfg, h), None

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> (x, the MoE router's aux loss, or None)."""
        cfg = self.cfg
        h = _whole_sequence(L.norm_apply(self.ln1, cfg, x))
        if self.kind == "ssm":
            return x + _stream(ssm_mod.ssm_apply(self.ssm, cfg, h)), None
        if self.kind == "rec":
            x = x + _stream(rglru_mod.rglru_apply(self.rec, cfg, h))
        else:
            x = x + _stream(attn.attn_apply(
                self.attn, cfg, h, positions=positions,
                window_override=_window(cfg, self.kind)))
        y, aux = self._ffn(_whole_sequence(L.norm_apply(self.ln2, cfg, x)))
        return x + _stream(y), aux

    def decode(self, x: torch.Tensor, cache: Dict,
               pos: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        cfg = self.cfg
        h = L.norm_apply(self.ln1, cfg, x)
        if self.kind == "ssm":
            y, new = ssm_mod.ssm_decode(self.ssm, cfg, h, cache)
            return x + y, new
        if self.kind == "rec":
            y, new = rglru_mod.rglru_decode(self.rec, cfg, h, cache)
        else:
            y, new = attn.attn_decode(self.attn, cfg, h, cache, pos)
        x = x + y
        z, _ = self._ffn(L.norm_apply(self.ln2, cfg, x))
        return x + z, new


def _mtp_spec(cfg: ArchConfig) -> Dict:
    return {"proj": ParamSpec((2 * cfg.d_model, cfg.d_model),
                              ("embed", None)),
            "norm_h": L.norm_spec(cfg), "norm_e": L.norm_spec(cfg),
            "block": _block_spec(cfg, "attn"),
            "final_norm": L.norm_spec(cfg)}


class MTPHead(nn.Module):
    """DeepSeek's multi-token-prediction depth: a projection of the
    normed hidden stream and next-token embeddings, one block, a final
    norm; it shares the embedding and the LM head."""

    def __init__(self, cfg: ArchConfig, device: torch.device,
                 dtype: torch.dtype):
        super().__init__()
        spec = _mtp_spec(cfg)
        self.proj = nn.Parameter(
            torch.empty(spec["proj"].shape, dtype=dtype, device=device),
            requires_grad=False)
        self.norm_h = _params(spec["norm_h"], device, dtype)
        self.norm_e = _params(spec["norm_e"], device, dtype)
        self.block = Block(cfg, device, dtype)
        self.final_norm = _params(spec["final_norm"], device, dtype)

    def param_tree(self) -> Dict[str, Any]:
        return {"proj": self.proj, "norm_h": self.norm_h,
                "norm_e": self.norm_e, "block": self.block.param_tree(),
                "final_norm": self.final_norm}


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
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.kinds = tuple(_block_kind(cfg, i) for i in range(cfg.n_layers))
        self.embedding = _params(L.embed_spec(cfg), self.device, dtype)
        self.final_norm = _params(L.norm_spec(cfg), self.device, dtype)
        self.layers = nn.ModuleList(Block(cfg, self.device, dtype, kind)
                                    for kind in self.kinds)
        self.mtp = (MTPHead(cfg, self.device, dtype) if cfg.mtp_depth > 0
                    else None)

    # ----------------------------------------------------------------- specs
    def param_specs(self) -> Dict:
        """The reference's spec tree with per-layer dicts (its
        ``scan_layers=False`` layout); ``mtp`` after ``layers``."""
        cfg = self.cfg
        spec = {"embed": L.embed_spec(cfg), "final_norm": L.norm_spec(cfg),
                "layers": [_block_spec(cfg, k) for k in self.kinds]}
        if self.mtp is not None:
            spec["mtp"] = _mtp_spec(cfg)
        return spec

    def param_tree(self) -> Dict[str, Any]:
        """The module's parameters in the layout of :meth:`param_specs`."""
        tree = {"embed": self.embedding, "final_norm": self.final_norm,
                "layers": [blk.param_tree() for blk in self.layers]}
        if self.mtp is not None:
            tree["mtp"] = self.mtp.param_tree()
        return tree

    def abstract_params(self) -> Dict:
        """Meta-device stand-ins of :meth:`param_specs` in each spec's
        dtype (the dry run's; nothing is allocated)."""
        return abstract(self.param_specs())

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "LanguageModel":
        """Random weights by the reference's init rules, drawn from
        ``generator`` one parameter at a time, in spec-tree order, each
        in its parameter's dtype."""
        for spec, p in _pairs(self.param_specs(), self.param_tree()):
            p.copy_(init_tensor(spec, generator, p.dtype, self.device))
        return self

    # --------------------------------------------------------------- forward
    def embed(self, batch: Mapping) -> torch.Tensor:
        """The input stream: projected ``frames`` (audio), or token
        embeddings with the projected ``patches`` before them (VLM)."""
        if self.cfg.family == Family.AUDIO:
            frames = torch.as_tensor(batch["frames"], device=self.device)
            return L.embed_frontend(self.embedding, frames)
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x = L.embed_tokens(self.embedding, tokens.long())
        if self.cfg.family == Family.VLM:
            patches = L.embed_frontend(self.embedding, torch.as_tensor(
                batch["patches"], device=self.device))
            x = torch.cat([patches.to(x.dtype), x], dim=1)
        return x

    def forward(self, batch: Mapping,
                remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence pass -> (logits (B, S, V), the blocks' summed aux
        loss; 0 for the dense family)."""
        x = self.embed(batch)
        x = constrain(x, ("act_batch", "act_seq", None))
        positions = torch.arange(x.shape[1], device=self.device)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for blk in self.layers:
            x, a = _maybe_remat(blk, remat)(x, positions)
            # the reference's scan body and its unrolled loop each hold
            # the carry here: one call for the port's one loop
            x = constrain(x, ("act_batch", "act_seq", None))
            if a is not None:
                aux = aux + a
        x = _whole_sequence(L.norm_apply(self.final_norm, self.cfg, x))
        logits = L.lm_logits(self.embedding, x)
        logits = constrain(logits, ("act_batch", None, "act_model"))
        return logits, aux

    # ------------------------------------------------------------------ loss
    def loss(self, batch: Mapping, remat: str = "none") -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch["labels"]`` plus the
        aux loss, plus 0.3 times the MTP loss where there is an MTP
        head."""
        logits, aux = self.forward(batch, remat=remat)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        if self.cfg.family == Family.VLM:
            # the image prefix carries no next-token loss
            logits = logits[:, -labels.shape[1]:]
        total = _xent(logits, labels) + aux
        if self.cfg.mtp_depth > 0:
            total = total + 0.3 * self._mtp_loss(batch, logits)
        return total

    def _mtp_loss(self, batch: Mapping,
                  main_logits: torch.Tensor) -> torch.Tensor:
        """DeepSeek multi-token prediction: one extra depth, shared head.
        The normed token embeddings (the reference's proxy of the hidden
        stream) and the next token's embeddings go through one block to
        predict the token after next."""
        cfg = self.cfg
        mtp = self.mtp.param_tree()
        emb = self.embed(batch)
        h = L.norm_apply(mtp["norm_h"], cfg, emb)
        e_next = L.norm_apply(mtp["norm_e"], cfg, torch.roll(emb, -1, dims=1))
        x = torch.cat([h, e_next], dim=-1) @ mtp["proj"]
        x, _ = self.mtp.block(x, torch.arange(x.shape[1],
                                              device=self.device))
        x = L.norm_apply(mtp["final_norm"], cfg, x)
        logits = L.lm_logits(self.embedding, x)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        labels2 = torch.roll(labels, -1, dims=1)
        return _xent(logits[:, :-2], labels2[:, :-2])

    # --------------------------------------------------------------- serving
    def cache_spec(self, batch: int, cache_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> List[Dict]:
        """Per-layer cache specs by block kind: KV ring buffers (the
        local-attention blocks' of ``min(cache_len, attn_window)``
        positions), the SSM's and RG-LRU's constant-size states."""
        cfg = self.cfg
        per_layer = []
        for kind in self.kinds:
            if kind == "ssm":
                per_layer.append(ssm_mod.ssm_cache_spec(cfg, batch,
                                                        dtype=dtype))
            elif kind == "rec":
                per_layer.append(rglru_mod.rglru_cache_spec(cfg, batch,
                                                            dtype=dtype))
            else:
                per_layer.append(attn.attn_cache_spec(
                    cfg, batch, cache_len, dtype=dtype,
                    window_override=_window(cfg, kind)))
        return per_layer

    def init_cache(self, batch: int, cache_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> List[Dict]:
        return attn.alloc_cache(self.cache_spec(batch, cache_len, dtype),
                                self.device)

    def decode_step(self, tokens, cache: List[Dict],
                    pos) -> Tuple[torch.Tensor, List[Dict]]:
        """tokens: (B,) int; pos: (B,) int32 absolute positions.
        -> (logits (B, V), cache); the cache's tensors are updated in
        place."""
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


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    # on a mesh the logits stay split over the vocab, as the reference's
    # log_softmax keeps them (XLA partitions its reductions)
    return -label_log_probs(logits.to(torch.float32), labels).mean()


# what "dots" keeps: the aten ops a ``@`` or an einsum lowers to, and the
# attention op (registered when ``models.attention`` imports its kernel)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default,
                   torch.ops.repro_torch.flash_attention.default})


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn: Callable, remat: str) -> Callable:
    if remat == "none":
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"remat must be 'none', 'dots' or 'full', got "
                     f"{remat!r}")


def build_model(cfg: ArchConfig, device: DeviceLike = None,
                dtype: torch.dtype = torch.bfloat16) -> LanguageModel:
    return LanguageModel(cfg, device=device, dtype=dtype)
