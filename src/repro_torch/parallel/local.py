"""Shard-local bodies of the model's steps that DTensor cannot shard op
by op, or only at great cost: the decode step's in-place cache write,
the MoE router's token fractions, the MoE's grouped dispatch and
combine, the SSM's chunked scan, and the cross entropy's pick of each
label's log-probability from a vocab split over the model axis.

Each function runs a single-device body (the cache write's own indexed
assignment; for the others the body it is given) unchanged on plain
tensors. On DTensors it runs the same body on each
device's shards (``torch.distributed.tensor.experimental.local_map``):
the inputs first take the layout the body needs, and the outputs come
back with the layout the body's result has on the mesh.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map
from torch.utils._pytree import tree_leaves


def cache_write_(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor,
                 bidx: torch.Tensor, seq_dim: int) -> None:
    """Write ``new`` (``cache``'s shape without its sequence dim
    ``seq_dim``: 2 for a (B, Hkv, S, D) KV cache, 1 for MLA's (B, S,
    dim)) in place into position ``slot[b]`` of each batch row ``b``
    (``bidx``: ``arange(B)``): one indexed write into the cache's own
    storage, no copy of it.

    On a DTensor cache every device writes its own shard in place, where
    the cache lies, indexing its own rows (``bidx`` is not read): split
    on the batch, ``new`` and ``slot`` split with it; split on any
    other dim but the sequence (kv heads, head dim, latent dim), ``new``
    split on the same dim and ``slot`` whole; split on the sequence (the
    batch-1 long-context cache), ``new`` and ``slot`` whole, and a device
    writes only rows whose slot falls in its range of positions
    (elsewhere it writes back what it holds)."""
    if not isinstance(cache, DTensor):
        _write_rows(cache, new, slot, bidx, seq_dim)
        return
    mesh = cache.device_mesh
    new_pl, slot_pl = [], []
    seq_axes = []
    for axis, p in enumerate(cache.placements):
        if not isinstance(p, Shard) or p.dim == seq_dim:
            new_pl.append(Replicate())
            slot_pl.append(Replicate())
            if isinstance(p, Shard):
                seq_axes.append(axis)
        elif p.dim == 0:
            new_pl.append(Shard(0))
            slot_pl.append(Shard(0))
        else:
            new_pl.append(Shard(p.dim - (p.dim > seq_dim)))
            slot_pl.append(Replicate())
    # this device's first position along a sequence split over the
    # mesh axes ``seq_axes`` (the first outermost)
    coord = mesh.get_coordinate()
    index = 0
    for axis in seq_axes:
        index = index * mesh.size(axis) + coord[axis]

    def body(cache, new, slot):
        rows = torch.arange(cache.shape[0], device=cache.device)
        if seq_axes:
            n = cache.shape[seq_dim]
            local = slot - index * n
            inside = (local >= 0) & (local < n)
            slot = torch.where(inside, local, torch.zeros_like(local))
            held = (cache[rows, :, slot] if seq_dim == 2
                    else cache[rows, slot])
            keep = inside.reshape((-1,) + (1,) * (new.dim() - 1))
            new = torch.where(keep, new, held)
        _write_rows(cache, new, slot, rows, seq_dim)

    local_map(body, out_placements=None,
              in_placements=(cache.placements, tuple(new_pl), tuple(slot_pl)),
              device_mesh=mesh, redistribute_inputs=True)(cache, new, slot)


def _write_rows(cache, new, slot, bidx, seq_dim: int) -> None:
    if seq_dim == 2:
        cache[bidx, :, slot] = new
    else:
        cache[bidx, slot] = new


def label_log_probs(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """``log_softmax(logits)[..., label]`` of each row: float32 logits
    (..., V) and integer labels (...). On plain tensors it is
    ``torch.log_softmax`` and ``take_along_dim``.

    On a DTensor whose vocab (last dim) is split over mesh axes, the
    vocab is never gathered: the log-sum-exp is each row's maximum
    (reduced over the split) plus the log of the shards' summed
    ``exp(x - max)`` (a partial sum), and each device picks the labels
    that fall in its part of the vocab, 0 for the others, a partial sum
    over the split (each label counted once). DTensor reduces the
    partial sums, (...)-shaped, where they are read."""
    if not isinstance(logits, DTensor):
        lp = torch.log_softmax(logits, dim=-1)
        return torch.take_along_dim(lp, labels.long()[..., None],
                                    dim=-1)[..., 0]
    last = logits.ndim - 1
    mesh, placements = logits.device_mesh, logits.placements
    # the rows' reductions over the split, each redistributed at once to
    # the rows' layout (the split axes replicated): DTensor would
    # otherwise pick a layout that splits the rows over those axes too,
    # and move the logits' shards (all-to-all) to meet it in backward
    rows = tuple(Replicate() if p == Shard(last) else p for p in placements)
    m = logits.detach().amax(dim=-1, keepdim=True).redistribute(mesh, rows)
    total = torch.exp(logits - m).sum(dim=-1, keepdim=True)
    lse = (m + torch.log(total.redistribute(mesh, rows)))[..., 0]
    shape = logits.shape

    def pick(x, lab):
        _, offset = compute_local_shape_and_global_offset(shape, mesh,
                                                          placements)
        local = lab.long() - offset[-1]
        held = (local >= 0) & (local < x.shape[-1])
        got = torch.take_along_dim(
            x, local.clamp(0, x.shape[-1] - 1)[..., None], dim=-1)[..., 0]
        return torch.where(held, got, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))

    out = tuple(Partial() if p == Shard(last) else p for p in placements)
    picked = local_map(pick, out_placements=(out,),
                       in_placements=(placements, rows),
                       device_mesh=mesh,
                       redistribute_inputs=True)(logits, labels)
    return picked.redistribute(mesh, rows) - lse


def token_fraction(count: Callable, top_i: torch.Tensor) -> torch.Tensor:
    """``count(top_i)``: the router's float32 (E,) fractions of the
    token-expert assignments ``top_i`` (B, S, k) that went to each
    expert, normalised by the global count of assignments. On a plain
    tensor it is just that call.

    On a DTensor ``top_i``, split on its batch over some mesh axes, each
    device counts its own rows and the fractions are a partial sum over
    those axes (``Partial()``): DTensor reduces them where they are read,
    the all-reduce XLA puts there."""
    if not isinstance(top_i, DTensor):
        return count(top_i)
    placements = tuple(p if p == Shard(0) else Replicate()
                       for p in top_i.placements)
    out = tuple(Partial() if p == Shard(0) else Replicate()
                for p in placements)
    return local_map(count, out_placements=(out,),
                     in_placements=(placements,),
                     device_mesh=top_i.device_mesh,
                     redistribute_inputs=True)(top_i)


def grouped(fn: Callable, n_outputs: int, *tensors, heads=None):
    """``fn(*tensors)`` for a function that treats each group (the batch
    row along every tensor's dim 0) on its own, as the MoE's dispatch
    and combine do: ``tensors`` are tensors or trees of them, and ``fn``
    returns ``n_outputs`` tensors (a tree of them). On plain tensors it
    is just that call.

    On DTensors each device runs ``fn`` on the groups it holds: on the
    mesh axes that split the first tensor's dim 0, every tensor and
    every output is split on dim 0, and on the others each is whole (a
    tensor split elsewhere is gathered first: the expert outputs, split
    on the experts, before the combine). For a function that also treats
    each head on its own (the SSM's scan), ``heads`` gives each input
    leaf's heads dim, then each output's (None where it has none): the
    mesh axes that split the first tensor's heads dim then split every
    tensor's heads dim too."""
    if not isinstance(tensors[0], DTensor):
        return fn(*tensors)
    n_in = len(tree_leaves(tensors))
    heads = heads or (None,) * (n_in + n_outputs)
    first = heads[0]

    def layout(dim):
        return tuple(
            Shard(0) if p == Shard(0)
            else Shard(dim) if None not in (dim, first) and p == Shard(first)
            else Replicate() for p in tensors[0].placements)

    return local_map(fn, out_placements=tuple(map(layout, heads[n_in:])),
                     in_placements=tuple(map(layout, heads[:n_in])),
                     device_mesh=tensors[0].device_mesh,
                     redistribute_inputs=True)(*tensors)
