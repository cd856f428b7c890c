"""Cache parameter tuner (paper §III-E, Algorithm 2) — rule-based heuristic.

Allocates the node's cache budget across its I/O clients at I/O-phase
boundaries:

1. idle clients get the minimum discrete cache value;
2. if the budget covers every active client at max, everyone active gets max;
3. otherwise each active client gets the max of three demand estimates —
   (a) peak observed cache utilization, (b) peak in-flight RPC volume,
   (c) its share of write RPCs applied to the remaining budget —
   snapped UP to the discrete grid (bounded overprovisioning is accepted,
   as the paper argues cache usage naturally drains).

Two implementations share those semantics:

* :func:`cache_allocation` — the scalar per-node reference (one Python
  loop over one node's demands);
* :func:`cache_allocation_many` — the fleet path: one vectorized NumPy
  pass over a padded ``(nodes, slots)`` demand tensor
  (:class:`CacheDemandBatch`), decision-identical to running the scalar
  function once per node. The reference's
  ``benchmarks/bench_cache_fleet.py`` gates the identity on full
  simulation traces.

Factor (3) is normalized exactly once, *here*: callers pass each client's
raw write-RPC volume (any non-negative scale) and both implementations
divide by the node's active-client total. :func:`trade_node_budgets`
optionally rebalances budgets across nodes before allocation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.policy import CaratSpaces

MB = 1024.0 * 1024.0


@dataclass
class CacheDemand:
    """Per-client factors collected over the last I/O-active stage."""
    client_id: int
    active: bool
    peak_cache_bytes: float      # factor (1): bursts absorbed by the cache
    peak_inflight_bytes: float   # factor (2): RPC bursts accommodated
    write_rpc_share: float       # factor (3): relative write-RPC weight;
    #                              any non-negative scale (raw volume is
    #                              fine) — normalized inside the allocator

    # wire round-trip contract (repro_torch.core.runtime.transport.wire):
    # the stage-2 demand form a bus payload may carry across processes
    def to_wire(self) -> tuple:
        return (int(self.client_id), bool(self.active),
                float(self.peak_cache_bytes),
                float(self.peak_inflight_bytes),
                float(self.write_rpc_share))

    @classmethod
    def from_wire(cls, data: tuple) -> "CacheDemand":
        return cls(*data)


def cache_allocation(
    demands: List[CacheDemand],
    spaces: CaratSpaces,
    node_budget_mb: float,
) -> Dict[int, int]:
    """Algorithm 2. Returns client_id -> dirty_cache_mb."""
    out: Dict[int, int] = {}
    active = [d for d in demands if d.active]
    idle = [d for d in demands if not d.active]
    for d in idle:                                   # line 2
        out[d.client_id] = spaces.cache_min
    # Idle minimums can exceed a tight node budget; a negative remainder
    # would flow into the factor-(3) demands below, so clamp at zero.
    remaining = max(node_budget_mb - spaces.cache_min * len(idle), 0.0)

    if not active:
        return out

    if remaining <= 0.0:
        # budget exhausted by idle minimums: active clients degrade to the
        # grid floor instead of receiving nonsense negative demands
        for d in active:
            out[d.client_id] = spaces.cache_min
        return out

    if spaces.cache_max * len(active) <= remaining:  # line 5
        for d in active:
            out[d.client_id] = spaces.cache_max
        return out

    total_write_share = sum(max(d.write_rpc_share, 0.0) for d in active) or 1.0
    for d in active:                                 # line 7
        f1 = d.peak_cache_bytes / MB
        f2 = d.peak_inflight_bytes / MB
        f3 = (d.write_rpc_share / total_write_share) * remaining
        want = max(f1, f2, f3)
        out[d.client_id] = spaces.snap_cache_up(want)
    return out


# ---------------------------------------------------------------------------
# Batched multi-node path (fleet stage-2 engine)
# ---------------------------------------------------------------------------
@dataclass
class CacheDemandBatch:
    """Padded ``(nodes, slots)`` demand tensor for :func:`cache_allocation_many`.

    ``valid`` masks padding slots (nodes own different client counts);
    ``client_ids`` is -1 on padding. Build via :meth:`pack`.
    """
    client_ids: np.ndarray          # (N, S) int64, -1 on padding
    active: np.ndarray              # (N, S) bool
    peak_cache_bytes: np.ndarray    # (N, S) float64
    peak_inflight_bytes: np.ndarray  # (N, S) float64
    write_rpc_share: np.ndarray     # (N, S) float64, raw relative weight
    valid: np.ndarray               # (N, S) bool
    node_budgets_mb: np.ndarray     # (N,) float64

    @classmethod
    def pack(
        cls,
        node_demands: Sequence[Sequence[CacheDemand]],
        node_budgets_mb: Sequence[float],
    ) -> "CacheDemandBatch":
        """Pad per-node demand lists into one tensor (slot order = list order,
        which is the scalar path's iteration order)."""
        return cls.from_rows(
            [([d.client_id for d in dem], [d.active for d in dem],
              [d.peak_cache_bytes for d in dem],
              [d.peak_inflight_bytes for d in dem],
              [d.write_rpc_share for d in dem]) for dem in node_demands],
            node_budgets_mb)

    @classmethod
    def from_rows(
        cls,
        node_rows: Sequence[tuple],
        node_budgets_mb: Sequence[float],
    ) -> "CacheDemandBatch":
        """Pack from per-node field rows ``(client_ids, active,
        peak_cache_bytes, peak_inflight_bytes, write_rpc_share)`` — the
        fleet's fast path (``NodeCacheArbiter.collect_rows``), which skips
        building :class:`CacheDemand` objects entirely."""
        n = len(node_rows)
        if n != len(node_budgets_mb):
            raise ValueError(f"{n} demand rows but "
                             f"{len(node_budgets_mb)} node budgets")
        s = max((len(r[0]) for r in node_rows), default=0) or 1

        def pad(k, fill, dtype):
            return np.array([list(r[k]) + [fill] * (s - len(r[k]))
                             for r in node_rows], dtype=dtype)

        return cls(
            client_ids=pad(0, -1, np.int64),
            active=pad(1, False, bool),
            peak_cache_bytes=pad(2, 0.0, np.float64),
            peak_inflight_bytes=pad(3, 0.0, np.float64),
            write_rpc_share=pad(4, 0.0, np.float64),
            valid=np.array([[True] * len(r[0]) + [False] * (s - len(r[0]))
                            for r in node_rows], dtype=bool),
            node_budgets_mb=np.asarray(node_budgets_mb, dtype=np.float64))

    def unpack(self, alloc: np.ndarray) -> List[Dict[int, int]]:
        """Per-node client_id -> dirty_cache_mb dicts from an allocation
        tensor (padding slots dropped)."""
        out: List[Dict[int, int]] = []
        for ids, ok, row in zip(self.client_ids.tolist(), self.valid.tolist(),
                                alloc.tolist()):
            out.append({c: v for c, v, keep in zip(ids, row, ok) if keep})
        return out


def cache_allocation_many(
    batch: CacheDemandBatch,
    spaces: CaratSpaces,
    node_budgets_mb: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Algorithm 2 over every node at once.

    Returns a ``(nodes, slots)`` int64 tensor of dirty-cache grid values
    (0 on padding slots), decision-identical per node to
    :func:`cache_allocation` on that node's demand list: each branch is a
    masked array op whose float arithmetic replays the scalar path's
    operation order (the factor-(3) total accumulates slot-by-slot, not
    via ``np.sum``, because pairwise summation reorders floats).

    ``node_budgets_mb`` overrides ``batch.node_budgets_mb`` (e.g. the
    output of :func:`trade_node_budgets`).
    """
    budgets = (batch.node_budgets_mb if node_budgets_mb is None
               else np.asarray(node_budgets_mb, dtype=np.float64))
    n, s = batch.valid.shape
    if budgets.shape != (n,):
        raise ValueError(f"expected {n} node budgets, got {budgets.shape}")
    active = batch.valid & batch.active
    idle = batch.valid & ~batch.active
    n_active = active.sum(axis=1)
    n_idle = idle.sum(axis=1)

    out = np.zeros((n, s), dtype=np.int64)
    out[idle] = spaces.cache_min                                   # line 2
    remaining = np.maximum(budgets - spaces.cache_min * n_idle, 0.0)

    has_active = n_active > 0
    exhausted = has_active & (remaining <= 0.0)
    all_fit = (has_active & ~exhausted
               & (spaces.cache_max * n_active <= remaining))       # line 5
    constrained = has_active & ~exhausted & ~all_fit

    out[exhausted[:, None] & active] = spaces.cache_min
    out[all_fit[:, None] & active] = spaces.cache_max

    if constrained.any():
        w_clipped = np.where(active, np.maximum(batch.write_rpc_share, 0.0),
                             0.0)
        # slot-ordered accumulation == the scalar path's sequential sum
        total = np.zeros(n, dtype=np.float64)
        for j in range(s):
            total += w_clipped[:, j]
        total = np.where(total == 0.0, 1.0, total)
        f1 = batch.peak_cache_bytes / MB
        f2 = batch.peak_inflight_bytes / MB
        f3 = (batch.write_rpc_share / total[:, None]) * remaining[:, None]
        want = np.maximum(np.maximum(f1, f2), f3)                  # line 7
        grid = np.asarray(spaces.dirty_cache_mb, dtype=np.float64)
        snap = np.minimum(np.searchsorted(grid, want, side="left"),
                          len(grid) - 1)
        snapped = np.asarray(spaces.dirty_cache_mb,
                             dtype=np.int64)[snap]
        sel = constrained[:, None] & active
        out[sel] = snapped[sel]
    return out


def trade_node_budgets(
    batch: CacheDemandBatch,
    spaces: CaratSpaces,
) -> np.ndarray:
    """Opt-in cross-node budget trading (fleet stage-2 extension).

    Nodes whose active clients all fit at ``cache_max`` after paying idle
    minimums lend their unused remainder; oversubscribed nodes borrow from
    the pooled surplus pro-rata by shortfall (capped at the shortfall, so
    a large pool never inflates anyone past all-fit). Returns the
    effective per-node budgets; their sum never exceeds the original sum
    (lenders give up exactly what borrowers receive), and every lender
    still covers its own all-fit commitment.
    """
    active = batch.valid & batch.active
    idle = batch.valid & ~batch.active
    n_active = active.sum(axis=1)
    budgets = batch.node_budgets_mb.astype(np.float64, copy=True)
    committed = (spaces.cache_min * idle.sum(axis=1)
                 + spaces.cache_max * n_active).astype(np.float64)
    shortfall = committed - budgets
    surplus = np.maximum(-shortfall, 0.0)
    # extra budget only helps nodes that have active clients to feed
    deficit = np.where(n_active > 0, np.maximum(shortfall, 0.0), 0.0)
    pool = float(surplus.sum())
    want = float(deficit.sum())
    if pool <= 0.0 or want <= 0.0:
        return budgets
    granted = deficit * min(1.0, pool / want)
    lent = surplus * (float(granted.sum()) / pool)
    return budgets + granted - lent
