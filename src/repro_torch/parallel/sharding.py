"""Logical-axis -> mesh-axis rules (the MaxText pattern; the twin of
``repro/parallel/sharding.py``).

Mesh axes: ("pod", "data", "model") multi-pod or ("data", "model") single.

Parameter rules (TP = "model", FSDP = additionally shard the embed dim of
every weight over "data"; "pod" stays pure data-parallel so cross-pod
traffic is gradient-reduction only — the slow inter-pod links never carry
layer activations):

  vocab    -> model      (embedding/logits TP)
  heads / kv_heads / ffn / inner -> model   (megatron-style TP; the fused
                          head*dim projections keep divisibility even when
                          kv_heads < mesh model size)
  experts  -> model      (expert parallelism)
  embed    -> data iff fsdp (ZeRO-3-style param sharding)
  layers   -> None       (the reference's scan axis; the port's layers
                          are unstacked and have none)

Activation rules:
  batch -> ("pod", "data");  decode caches shard the *sequence* dim over
  "model" (and over "data" too for long_500k's batch=1), so serving scales
  past the kv-head count.

The rules are pure functions of a spec tree and of what they read of a
mesh: its ``axis_names`` and each axis's size, ``shape[name]``
(:class:`MeshAxes` reads both off a ``DeviceMesh``; any object with the
two serves). A partition spec is a :class:`P`, a tuple with one entry
per dim. :func:`make_shardings` and :func:`sanitized_shardings` turn
specs into DTensor placements on a ``DeviceMesh``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

from repro_torch.config.types import ArchConfig, Family, ParallelConfig, ShapeConfig
from repro_torch.models.param import logical_to_pspec
from repro_torch.utils.tree import tree_map

# typing only: the models import parallel.constraints
LanguageModel = Any
DeviceMesh = Any


class P(tuple):
    """A partition spec (the twin of ``jax.sharding.PartitionSpec``): one
    entry per dim of an array, each a mesh-axis name, a tuple of names
    (the dim split over several axes, the first outermost) or None
    (replicated). It is a tuple, and equals the tuple of its entries.
    As JAX's, it reads a tuple of one name as the name and an empty tuple
    as None."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_canonical(p) for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _canonical(part):
    if isinstance(part, tuple) and len(part) <= 1:
        return part[0] if part else None
    return part


class MeshAxes:
    """What the rules read of a ``DeviceMesh``: ``axis_names`` (its
    ``mesh_dim_names``) and ``shape``, each axis's size by name."""

    def __init__(self, device_mesh: DeviceMesh):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              device_mesh.shape))

    @property
    def size(self) -> int:
        return _axis_size(self, self.axis_names)


@dataclass(frozen=True)
class Sharding:
    """A spec placed on a mesh (the twin of ``NamedSharding``): the
    DTensor placements, one per mesh dim."""
    mesh: DeviceMesh
    spec: P
    placements: tuple


def param_rules(parallel: ParallelConfig) -> Dict[str, Any]:
    return {
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "ffn": "model",
        "inner": "model",
        "experts": "model",
        "embed": "data" if parallel.fsdp else None,
        "layers": None,
    }


def param_pspecs(model: LanguageModel, parallel: ParallelConfig):
    return logical_to_pspec(model.param_specs(), param_rules(parallel))


def batch_pspec(cfg: ArchConfig, shape: ShapeConfig, mesh) -> Dict:
    """Partition spec per batch field."""
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    if shape.global_batch % _axis_size(mesh, batch_axes) != 0:
        batch_axes = ()          # long_500k batch=1: replicate batch
    b = batch_axes if batch_axes else None
    out: Dict[str, Any] = {}
    if cfg.family == Family.AUDIO:
        out["frames"] = P(b, None, None)
        out["labels"] = P(b, None)
        return out
    out["tokens"] = P(b, None)
    out["labels"] = P(b, None)
    if cfg.family == Family.VLM:
        out["patches"] = P(b, None, None)
    return out


def cache_pspec(model: LanguageModel, shape: ShapeConfig, mesh):
    """Sharding for the decode cache tree.

    KV caches (B, Hkv, S, D): batch shards over ("pod","data"); the
    "model" axis shards kv-heads when they divide it, else the head_dim
    (contraction -> one small psum per layer), else the cache sequence.
    Keeping S *unsharded* whenever possible makes the per-token ring-
    buffer update local. For batch=1 long-context decode the sequence
    dim takes ("data","model") so the whole mesh still participates.
    Recurrent states (no S dim) shard their head/width dims over "model".
    The port's caches are per layer (no stacked layer dim), so the
    reference's ``lead`` is always ``()``: its ``scan_layers=False``
    layout.
    """
    cfg = model.cfg
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    model_size = mesh.shape.get("model", 1)
    long_ctx = shape.global_batch % _axis_size(mesh, batch_axes) != 0
    if long_ctx:
        batch_axes = ()
    b = batch_axes if batch_axes else None
    hd = cfg.resolved_head_dim if cfg.n_heads else 0

    def kv_spec():
        if long_ctx:
            seq = tuple(a for a in ("data", "model") if a in mesh.axis_names)
            return P(b, None, seq, None)
        if cfg.n_kv_heads % model_size == 0:
            return P(b, "model", None, None)
        if hd % model_size == 0:
            return P(b, None, None, "model")
        return P(b, None, "model", None)

    def spec_for(leaf_shape, name):
        if name in ("k", "v"):            # (B, Hkv, S, D)
            return kv_spec()
        if name in ("ckv", "krope"):      # (B, S, dim) — latent dim TP
            if long_ctx:
                seq = tuple(a for a in ("data", "model")
                            if a in mesh.axis_names)
                return P(b, seq, None)
            return P(b, None, "model")
        if name == "length":
            return P(b)
        if name == "state":               # (B, H, P, N)
            return P(b, "model", None, None)
        if name == "conv":                # (B, cw-1, dim)
            return P(b, None, "model")
        if name == "h":                   # (B, width)
            return P(b, "model")
        return P(*([None] * len(leaf_shape)))

    spec = model.cache_spec(shape.global_batch, shape.seq_len)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: (spec_for(v.shape, k)
                        if hasattr(v, "shape") else walk(v))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(t) for t in tree]
        raise TypeError(type(tree))

    return walk(spec)


def placements(spec: P, device_mesh: DeviceMesh) -> tuple:
    """DTensor placements of ``spec`` on ``device_mesh``: ``Shard(d)`` on
    each mesh dim that splits dim ``d``, ``Replicate()`` on the rest.
    Where a tuple of axes splits one dim they must come in the mesh's
    order, the first outermost, as DTensor orders them."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes {axes} of dim {dim} are not "
                             f"in the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]!r} splits "
                                 f"two dims")
            out[i] = Shard(dim)
    return tuple(out)


def make_shardings(mesh: DeviceMesh, pspec_tree):
    return map_specs(lambda p: Sharding(mesh, p, placements(p, mesh)),
                     pspec_tree)


def sanitize_pspec(pspec: P, shape_tuple, mesh) -> P:
    """Drop mesh axes that do not divide the corresponding dim."""
    parts = list(pspec) + [None] * (len(shape_tuple) - len(pspec))
    out = []
    for dim, part in zip(shape_tuple, parts):
        if part is None:
            out.append(None)
            continue
        axes = part if isinstance(part, tuple) else (part,)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        out.append(part if dim % size == 0 else None)
    return P(*out)


def sanitized_sharding(pspec: P, shape_tuple, mesh: DeviceMesh) -> Sharding:
    """The sharding of one array of ``shape_tuple``, divisibility-
    sanitized."""
    spec = sanitize_pspec(pspec, tuple(shape_tuple), MeshAxes(mesh))
    return Sharding(mesh, spec, placements(spec, mesh))


def sanitized_shardings(tree_specs, tree_pspecs, mesh: DeviceMesh):
    """Shardings for a tree of tensors (or of anything with a ``shape``),
    divisibility-sanitized."""
    return map_specs(lambda p, s: sanitized_sharding(p, s.shape, mesh),
                     tree_pspecs, tree_specs)


def map_specs(fn: Callable, pspec_tree, *rest):
    """``fn(spec, *leaves)`` over the :class:`P` leaves of a tree of dicts
    and lists, with the leaves of ``rest`` (trees of the same layout)
    beside each."""
    return tree_map(fn, pspec_tree, *rest, is_leaf=lambda x: isinstance(x, P))


_REGISTERED = []


def register_op_shardings() -> None:
    """Tell DTensor how the port's attention ops shard: the forward
    (``torch.ops.repro_torch.flash_attention``: q, k, v -> out) and its
    backward (``torch.ops.repro_torch.flash_attention_backward``: grad,
    q, k, v -> dq, dk, dv) take, on each mesh dim, one of three ways
    for all their tensors at once: replicated, split on the batch dim,
    or split on the heads dim (each device attends its own heads).

    The heads way is offered only where every mesh axis divides both
    head counts, so that a shard's query heads are the groups of its kv
    heads (query head ``i`` reads kv head ``i // (Hq / Hkv)`` locally as
    globally). Where the model axis divides the query heads but not the
    kv heads (8 kv heads or 1 over a 16-way axis), the model code first
    repeats each kv head up to the axis's size
    (``parallel.constraints.constrain_attention``): kv head ``j`` of the
    repeated ``Hkv * r`` is kv head ``j // r``, the groups stay aligned,
    and the attention shards its query heads instead of running whole on
    every device of the axis. Where the axis does not divide the query
    heads either, the same code splits the batch over it (the batch way
    on both mesh dims). Once per process."""
    if _REGISTERED:
        return
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    import repro_torch.kernels.flash_attention.kernel  # noqa: F401  the ops

    def ways(q, k):
        out = [Replicate(), Shard(0)]
        if all(q.shape[1] % n == 0 and k.shape[1] % n == 0
               for n in q.mesh.shape):
            out.append(Shard(1))
        return out

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _attention(q, k, v, causal, window, scale):
        return [([p], [p, p, p, None, None, None]) for p in ways(q, k)]

    @register_sharding(
        torch.ops.repro_torch.flash_attention_backward.default)
    def _attention_backward(grad, q, k, v, causal, window, scale):
        return [([p, p, p], [p, p, p, p, None, None, None])
                for p in ways(q, k)]

    _REGISTERED.extend((_attention, _attention_backward))


def _axis_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return max(n, 1)
