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

import math
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
    if _RULES is None:
        return x
    return _constrain(x, axes, tuple(x.shape))


def constrain_heads(x, n_heads: int, axes):
    """``constrain`` for a fused head projection (B, S, H*D) about to be
    split into its ``n_heads`` heads: its last dim keeps its rule only
    where the rule's mesh axes divide ``n_heads`` (DTensor cannot split
    8 kv heads sharded over a 16-way "model" axis; the reference leaves
    that layout to XLA, "replicated worst-case")."""
    if _RULES is None:
        return x
    return _constrain(x, axes, tuple(x.shape[:-1]) + (n_heads,))


def constrain_attention(q, k, v, axes):
    """The layout of an attention's q (B, Hq, S, D) and k, v (B, Hkv, S,
    D) on a mesh, ``axes`` their logical axes (batch, heads, ...).

    Where the heads rule's mesh axes divide the query heads, the heads
    split over them (each device attends its own heads, as
    ``parallel.sharding.register_op_shardings`` allows): where they
    divide the query heads but not the kv heads, each kv head is first
    repeated ``r`` times, the least ``r`` for which they divide ``Hkv *
    r`` and ``Hkv * r`` divides ``Hq``. Repeated head ``j`` is head ``j //
    r``, so each query group still reads its own kv head. Where they do
    not divide the query heads (8 or 10 over 16), the batch splits over
    them besides its own axes, if it divides; only else does every
    device of those axes attend all heads. Without rules or on plain
    tensors, q, k and v pass through unrepeated."""
    if _RULES is None:
        return q, k, v
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.sharding import MeshAxes, P, _axis_size
    if not isinstance(q, DTensor):
        return q, k, v
    mesh = MeshAxes(q.device_mesh)
    heads = _axes(axes[1])
    n = _axis_size(mesh, heads)
    both = _axes(axes[0]) + heads
    if q.shape[1] % n != 0 and q.shape[0] % _axis_size(mesh, both) == 0:
        spec = P(both, None, None, None)
        return tuple(_place(x, spec, tuple(x.shape)) for x in (q, k, v))
    b, hkv, s, d = k.shape
    r = math.lcm(hkv, n) // hkv
    if q.shape[1] % n == 0 and r > 1 and q.shape[1] % (hkv * r) == 0:
        k, v = (x[:, :, None].expand(b, hkv, r, s, d).reshape(
            b, hkv * r, s, d) for x in (k, v))
    return tuple(_constrain(x, axes, tuple(x.shape)) for x in (q, k, v))


def _axes(name) -> tuple:
    """The mesh axes of a logical axis's rule, as a tuple."""
    part = _RULES.get(name) if name is not None else None
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def _constrain(x, axes, sizes):
    if _RULES is None:
        return x
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.sharding import P
    if not isinstance(x, DTensor):
        return x
    return _place(x, P(*[(_RULES.get(a) if a is not None else None)
                         for a in axes]), sizes)


def _place(x, spec, sizes):
    """The DTensor ``x`` redistributed to the partition spec ``spec``,
    its mesh axes that do not divide ``sizes`` dropped."""
    from torch.distributed.tensor import DTensor

    from repro_torch.parallel.sharding import (MeshAxes, placements,
                                               sanitize_pspec)
    mesh = x.device_mesh
    spec = sanitize_pspec(spec, sizes, MeshAxes(mesh))
    # contiguous: a redistributed shard is laid out densely whatever the
    # global strides say, and DTensor would take a later reshape for a
    # view of it
    y = x.redistribute(mesh, placements(spec, mesh)).contiguous()
    local = y.to_local()
    if local._base is not None and local._base.numel() > local.numel():
        # a shard cut from a gathered whole (DTensor's all-to-all on a
        # CPU mesh) would keep the whole alive
        local = local.clone()
    # the gradient takes the same layout on its way back (the transpose
    # of JAX's sharding constraint is the constraint): DTensor would
    # otherwise carry a gradient's partial sums on through the backward
    # and run the products they meet whole on every device of the axis
    return DTensor.from_local(local, mesh, y.placements, run_check=False,
                              shape=y.shape, stride=y.stride())


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
