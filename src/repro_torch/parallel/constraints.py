"""Activation sharding constraints (MaxText-style; the twin of
``repro/parallel/constraints.py``).

Model code annotates activations with *logical* axes; the launcher
installs concrete rules (mesh-dependent) before it runs a step. Without
rules (the tests, one card) the constraints are no-ops.

With rules, :func:`constrain` redistributes a DTensor to the rules'
placements on its own mesh (the port's ``with_sharding_constraint``). A
plain tensor passes through: one card holds it whole.

Logical activation axes:
  act_batch  -> ("pod", "data")   (or () for batch-1 long decode)
  act_model  -> "model"           (heads / ffn / vocab activations)
  act_seq    -> None              (or "model"/"data" for seq-sharded modes)
"""
from __future__ import annotations

from typing import Dict, Optional

_RULES: Optional[Dict[str, object]] = None


def set_activation_rules(rules: Optional[Dict[str, object]]) -> None:
    global _RULES
    _RULES = rules


def get_activation_rules():
    return _RULES


def constrain(x, axes):
    """axes: tuple of logical names (or None) per dim of x. A mesh axis
    that does not divide its dim is dropped (DTensor cannot split or
    merge an unevenly sharded dim; XLA pads it)."""
    return _constrain(x, axes, tuple(x.shape))


def constrain_heads(x, n_heads: int, axes):
    """``constrain`` for a fused head projection (B, S, H*D) about to be
    split into its ``n_heads`` heads: its last dim keeps its rule only
    where the rule's mesh axes divide ``n_heads`` (DTensor cannot split
    8 kv heads sharded over a 16-way "model" axis; the reference leaves
    that layout to XLA, "replicated worst-case")."""
    return _constrain(x, axes, tuple(x.shape[:-1]) + (n_heads,))


def _constrain(x, axes, sizes):
    if _RULES is None:
        return x
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.sharding import (MeshAxes, P, placements,
                                               sanitize_pspec)
    if not isinstance(x, DTensor):
        return x
    spec = P(*[(_RULES.get(a) if a is not None else None) for a in axes])
    mesh = x.device_mesh
    spec = sanitize_pspec(spec, sizes, MeshAxes(mesh))
    # contiguous: a redistributed shard is laid out densely whatever the
    # global strides say, and DTensor would take a later reshape for a
    # view of it
    return x.redistribute(mesh, placements(spec, mesh)).contiguous()


def default_rules(mesh, batch_divisible: bool = True) -> Dict[str, object]:
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return {
        "act_batch": batch_axes if batch_divisible and batch_axes else None,
        "act_model": "model",
        "act_seq": None,
        # decode-path rules, set per-arch by the launcher to MATCH the KV
        # cache layout (kv-heads sharded when divisible, else head_dim):
        # a mismatched query would gather the whole cache.
        "act_kv_heads": None,
        "act_head_dim": None,
    }
