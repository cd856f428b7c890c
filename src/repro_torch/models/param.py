"""Parameter specs: one source of truth for shape, init and logical axes
(the port's copy of ``repro/models/param.py``).

Every model module builds a nested dict of :class:`ParamSpec` leaves
(lists hold per-layer dicts). From it:

* ``materialize(specs, generator, ...)`` -> real tensors with the
  reference's init rules;
* ``abstract(specs)`` -> meta-device tensors of each spec's shape and
  dtype (the dry run's stand-ins: nothing is allocated);
* ``logical_to_pspec(specs, rules)`` -> a tree of partition specs
  (:class:`repro_torch.parallel.sharding.P`): the distribution layer
  maps logical axes to mesh axes;
* ``count_tree_params(specs)`` -> the number of parameters.

Logical axis vocabulary (``parallel/sharding.py`` maps it to the mesh):
  "vocab", "embed", "heads", "kv_heads", "ffn", "experts", "inner",
  "state", "layers", plus None for replicated dims.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]         # logical axis per dim
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                    # normal | zeros | ones
    init_scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def spec_tree_map(fn: Callable[[ParamSpec], Any], tree):
    """``fn`` over every spec of a tree of dicts and lists."""
    if is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: spec_tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(spec_tree_map(fn, v) for v in tree)
    raise TypeError(f"not a spec tree: {type(tree)}")


def init_tensor(s: ParamSpec, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None,
                device: DeviceLike = None) -> torch.Tensor:
    """One parameter by the reference's rules: zeros, ones, or a standard
    normal times ``init_scale / sqrt(fan_in)`` (``fan_in`` is the first
    dim of a matrix, the size of a vector), drawn in float32 on
    ``generator``'s device and cast to ``dtype``."""
    dev = resolve_device(device)
    dt = dtype or s.dtype
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dt, device=dev)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dt, device=dev)
    fan_in = s.shape[0] if len(s.shape) >= 2 else max(s.shape[-1], 1)
    scale = s.init_scale / math.sqrt(max(fan_in, 1))
    w = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    # scaled in place: one float32 staging copy of the largest expert
    # stack (15 GB at deepseek-v3's width) is all the draw holds
    return w.mul_(scale).to(device=dev, dtype=dt)


def materialize(tree, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None,
                device: DeviceLike = None):
    """Real tensors for every spec, drawn in tree order from
    ``generator``."""
    dev = resolve_device(device)
    return spec_tree_map(
        lambda s: init_tensor(s, generator, dtype, dev), tree)


def abstract(tree):
    """Meta-device tensors of each spec's shape and dtype: zero
    allocation, the dry run's stand-ins."""
    return spec_tree_map(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), tree)


def logical_to_pspec(tree, rules: Dict[str, Any]):
    """Map each leaf's logical axes to a partition spec via ``rules``.

    rules: logical axis name -> mesh axis (str), tuple of mesh axes, or
    None. Unknown logical names map to None (replicated).
    """
    # the parallel package imports this module: import it here, as the
    # reference imports jax's PartitionSpec
    from repro_torch.parallel.sharding import P

    def one(s: ParamSpec):
        return P(*[rules.get(a) if a is not None else None for a in s.axes])

    return spec_tree_map(one, tree)


def count_tree_params(tree) -> int:
    n = [0]

    def add(s: ParamSpec):
        n[0] += math.prod(s.shape)
        return s

    spec_tree_map(add, tree)
    return n[0]
