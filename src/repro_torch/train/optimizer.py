"""AdamW from scratch (the twin of ``repro/train/optimizer.py``).

Operates on trees of tensors (dicts and lists, see
:mod:`repro_torch.utils.tree`). Optimizer-state dtype is a knob: fp32
moments by default, bf16 moments for the XXL archs where device memory is
the binding constraint.

The reference returns new arrays; the port updates the parameters and
the moments **in place** under ``torch.no_grad()`` (a second copy of a
2.5 B-parameter state would not fit beside the first on one card) and
returns them. The arithmetic is the reference's, operation for
operation, in float32: ``p - lr * ((m/c1) / (sqrt(v/c2) + eps) + wd*p)``
with ``c = 1 - b ** count``; ``torch.optim.AdamW`` rounds differently.
The global norm sums the leaves in JAX's flatten order (sorted dict
keys), so the clip scale is the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

F32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: torch.dtype = F32


def adamw_init(params, cfg: AdamWConfig) -> Dict:
    """Zero moments beside every parameter (on its device, in
    ``state_dtype``) and a step count of 0."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def adamw_update(params, grads, state: Dict, lr, cfg: AdamWConfig,
                 grad_clip: float = 0.0) -> Tuple[object, Dict]:
    """One AdamW step: ``params`` and ``state``'s moments are updated in
    place; returns ``(params, {"m", "v", "count" + 1})``. ``lr`` is a
    number or a 0-d tensor; nothing here reads a value on the host."""
    p_leaves = tree_leaves(params)
    g_leaves = tree_leaves(grads)
    m_leaves = tree_leaves(state["m"])
    v_leaves = tree_leaves(state["v"])
    if not (len(p_leaves) == len(g_leaves) == len(m_leaves)
            == len(v_leaves)):
        raise ValueError("params, grads and the moments must have one "
                         "layout")
    count = state["count"] + 1
    scale = None
    if grad_clip > 0:
        gnorm = global_norm(g_leaves)
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(b1, count.to(F32))
    c2 = 1.0 - torch.pow(b2, count.to(F32))
    for p, g, m, v in zip(p_leaves, g_leaves, m_leaves, v_leaves):
        g = g.to(F32) * scale if scale is not None else g.to(F32)
        m2 = m.to(F32)                   # m itself when it is float32
        m2.mul_(b1).add_(g * (1 - b1))   # b1*m + (1-b1)*g
        t = g * (1 - b2)
        t.mul_(g)
        v2 = v.to(F32)
        v2.mul_(b2).add_(t)              # b2*v + (1-b2)*g*g
        step = m2 / c1
        t = v2 / c2
        t.sqrt_().add_(cfg.eps)
        step.div_(t)                     # (m/c1) / (sqrt(v/c2) + eps)
        p2 = p.to(F32)
        step.add_(p2 * cfg.weight_decay)
        step.mul_(lr)
        p2.sub_(step)                    # p - lr*(step + wd*p)
        for dst, src in ((p, p2), (m, m2), (v, v2)):
            if src is not dst:
                dst.copy_(src)
    return params, {"m": state["m"], "v": state["v"], "count": count}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed in JAX's flatten
    order, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(F32)))
                          for leaf in tree_leaves(tree)))
