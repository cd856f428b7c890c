"""Mixture-of-experts block (moonshot 64e/top-6, deepseek 256e/top-8), the
twin of ``repro/models/moe.py``.

Sort-based dispatch with no (T, E, C) one-hot: within each group (one
batch row) the token-expert assignments are sorted by expert (a stable
sort, as ``jnp.argsort``), packed into a static-capacity (E, C, d)
buffer, run through the batched expert FFN and combined with the router
weights. Assignments past an expert's capacity are dropped
(capacity_factor 1.25). The reference ``vmap``s the dispatch over groups;
here every step carries the group dim.

The expert FFN is ``torch.einsum`` over the (G, E, C, d) buffer: the
reference leaves it to XLA's einsums, outside any Pallas kernel.

The combine adds each token's k contributions in the reference's order
(ascending sorted position, i.e. ascending expert), one at a time in the
output's dtype, with no atomics: a bf16 prefill gives the same bits on
every run.

Shared experts (DeepSeek) are dense MLPs added to every token. The
router's load-balancing aux loss is returned for the train loss.
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, NamedTuple, Tuple

import torch

from repro_torch.config.types import ArchConfig
from repro_torch.models.layers import _act
from repro_torch.models.param import ParamSpec
from repro_torch.parallel.constraints import constrain
from repro_torch.parallel.local import grouped, token_fraction

F32 = torch.float32


def moe_spec(cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    m = cfg.moe
    f = m.d_ff_expert
    spec = {
        "router": ParamSpec((d, m.n_experts), ("embed", None), dtype=F32),
        "wg": ParamSpec((m.n_experts, d, f), ("experts", "embed", None)),
        "wi": ParamSpec((m.n_experts, d, f), ("experts", "embed", None)),
        "wo": ParamSpec((m.n_experts, f, d), ("experts", None, "embed")),
    }
    for i in range(m.n_shared_experts):
        spec[f"shared{i}"] = {
            "wg": ParamSpec((d, f), ("embed", "ffn")),
            "wi": ParamSpec((d, f), ("embed", "ffn")),
            "wo": ParamSpec((f, d), ("ffn", "embed")),
        }
    return spec


def _capacity(n_tokens: int, cfg: ArchConfig) -> int:
    m = cfg.moe
    cap = int(n_tokens * m.top_k / m.n_experts * m.capacity_factor)
    return max(_round_up(cap, 8), 8)


def _round_up(v: int, mult: int) -> int:
    return ((v + mult - 1) // mult) * mult


class Dispatch(NamedTuple):
    """The integer state of one layer's dispatch, per group (G, t*k): the
    buffer slot of each sorted assignment (``e * cap`` when dropped), its
    token, whether it fits, and the sort's permutation of the flat
    (token, choice) assignments."""
    slots: torch.Tensor
    tok_of: torch.Tensor
    keep: torch.Tensor
    order: torch.Tensor


def dispatch(x: torch.Tensor, top_i: torch.Tensor, cap: int,
             e: int) -> Tuple[torch.Tensor, Dispatch]:
    """Sort-based dispatch of every group at once. x: (G, t, d); top_i:
    (G, t, k). -> the (G, E, cap, d) buffer and the dispatch state."""
    g, t, d = x.shape
    k = top_i.shape[-1]
    flat_e = top_i.reshape(g, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((g, e), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, sorted_e, torch.ones_like(sorted_e))
    starts = torch.cumsum(counts, dim=1) - counts            # exclusive
    ranks = (torch.arange(t * k, device=x.device)[None]
             - torch.gather(starts, 1, sorted_e))
    keep = ranks < cap
    slots = torch.where(keep, sorted_e * cap + ranks,
                        torch.full_like(ranks, e * cap))
    tok_of = torch.div(order, k, rounding_mode="floor")
    gathered = torch.gather(x, 1, tok_of[..., None].expand(g, t * k, d))
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=x.dtype, device=x.device))
    # one extra row per group takes the dropped assignments (all zeros)
    rows = e * cap + 1
    buf = torch.zeros((g * rows, d), dtype=x.dtype, device=x.device)
    flat_slots = (slots + rows * torch.arange(g, device=x.device)[:, None])
    buf.index_copy_(0, flat_slots.reshape(-1), gathered.reshape(-1, d))
    buf = buf.reshape(g, rows, d)[:, :-1].reshape(g, e, cap, d)
    return buf, Dispatch(slots, tok_of, keep, order)


def combine(out: torch.Tensor, top_p: torch.Tensor,
            state: Dispatch) -> torch.Tensor:
    """(G, E, cap, d) expert outputs -> (G, t, d): each token's k
    contributions, weighted by its router probabilities (cast to the
    output's dtype, zero where dropped), summed in ascending sorted
    position in ``out.dtype``, as the reference's ``.at[tok_of].add``."""
    g, e, cap, d = out.shape
    t, k = top_p.shape[1], top_p.shape[2]
    flat_out = torch.cat([out.reshape(g, e * cap, d),
                          out.new_zeros((g, 1, d))], dim=1)
    w = torch.gather(top_p.reshape(g, t * k), 1, state.order)
    w = torch.where(state.keep, w, torch.zeros((), dtype=w.dtype,
                                               device=w.device))
    # sorted position of each (token, choice): the inverse permutation;
    # a token's k positions, ascending, are the reference's add order
    inv = torch.argsort(state.order, dim=-1).reshape(g, t, k)
    pos = torch.sort(inv, dim=-1).values.reshape(g, t * k)
    slots = torch.gather(state.slots, 1, pos)
    w = torch.gather(w, 1, pos).to(out.dtype)
    table = (torch.gather(flat_out, 1, slots[..., None].expand(g, t * k, d))
             * w[..., None]).reshape(g, t, k, d)
    y = torch.zeros((g, t, d), dtype=out.dtype, device=out.device)
    for j in range(k):
        y = y + table[:, :, j]
    return y


def route(params: Mapping, cfg: ArchConfig, x: torch.Tensor):
    """Router: float32 softmax probabilities (B, S, E) and the top-k
    renormalized weights and experts (B, S, k). The router is read in
    float32 whatever its stored dtype, as JAX promotes ``x.astype(f32) @
    router``."""
    logits = x.to(F32) @ params["router"].to(F32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.moe.top_k, dim=-1)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return probs, top_p, top_i


def _token_frac(top_i: torch.Tensor, e: int, total: int) -> torch.Tensor:
    """(E,) float32: each expert's share of the ``total`` token-expert
    assignments, counted from those in ``top_i``."""
    token_frac = torch.zeros((e,), dtype=F32, device=top_i.device)
    token_frac.scatter_add_(0, top_i.reshape(-1), torch.full(
        (top_i.numel(),), 1.0 / total, dtype=F32, device=top_i.device))
    return token_frac


def moe_apply(params: Mapping, cfg: ArchConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss). Grouped (per-batch-row) dispatch."""
    m = cfg.moe
    b, s, d = x.shape
    k = m.top_k
    e = m.n_experts

    probs, top_p, top_i = route(params, cfg, x)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e (global)
    token_frac = token_fraction(
        functools.partial(_token_frac, e=e, total=b * s * k), top_i)
    prob_frac = probs.mean(dim=(0, 1))
    aux = e * torch.sum(token_frac * prob_frac) * m.router_aux_loss

    # ---- grouped dispatch: one group per batch row -------------------------
    buf, state = grouped(functools.partial(dispatch, cap=_capacity(s, cfg),
                                           e=e), 5, x, top_i)
    # groups (batch rows) shard over data; experts shard over model: on a
    # mesh this boundary is the MoE all-to-all
    buf = constrain(buf, ("act_batch", "act_model", None, None))

    # ---- expert FFN ---------------------------------------------------------
    g = _act(cfg, torch.einsum("gecd,edf->gecf", buf, params["wg"]))
    h = g * torch.einsum("gecd,edf->gecf", buf, params["wi"])
    # on a mesh: one dense layout for the shards and the whole alike (the
    # einsum's output order on each device can differ from the one
    # DTensor records for the whole, and the next einsum views it)
    h = constrain(h, ("act_batch", "act_model", None, None))
    out = torch.einsum("gecf,efd->gecd", h, params["wo"])
    out = constrain(out, ("act_batch", "act_model", None, None))

    # ---- combine ------------------------------------------------------------
    y = grouped(combine, 1, out, top_p, state)
    y = constrain(y, ("act_batch", "act_seq", None))

    # ---- shared experts -----------------------------------------------------
    for i in range(m.n_shared_experts):
        p = params[f"shared{i}"]
        gsh = _act(cfg, x @ p["wg"])
        y = y + (gsh * (x @ p["wi"])) @ p["wo"]

    return y, aux
