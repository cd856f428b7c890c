"""Bounded, discrete configuration spaces (paper §III-F).

CARAT restricts actuation to discrete grids for both RPC and cache
parameters — this is a stability mechanism, not a simplification: bounded
spaces prevent unbounded drift and make behaviour repeatable.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass(frozen=True)
class CaratSpaces:
    rpc_window_pages: Tuple[int, ...]
    rpcs_in_flight: Tuple[int, ...]
    dirty_cache_mb: Tuple[int, ...]
    default_rpc_window: int = 1024
    default_in_flight: int = 8
    default_dirty_mb: int = 2048

    def __post_init__(self):
        for name, grid in (("rpc_window_pages", self.rpc_window_pages),
                           ("rpcs_in_flight", self.rpcs_in_flight),
                           ("dirty_cache_mb", self.dirty_cache_mb)):
            if not grid:
                raise ValueError(f"{name} grid must be non-empty")
            if list(grid) != sorted(set(grid)):
                raise ValueError(f"{name} grid must be sorted and unique, "
                                 f"got {tuple(grid)}")

    # --- RPC candidate space -------------------------------------------------
    def rpc_candidates(self) -> List[Tuple[int, int]]:
        """All (window_pages, in_flight) combinations = the theta space."""
        return [(w, f) for w in self.rpc_window_pages
                for f in self.rpcs_in_flight]

    def theta_features(self) -> np.ndarray:
        """(n_candidates, 2) log2-scaled parameter features."""
        cands = self.rpc_candidates()
        return np.array([[math.log2(w), math.log2(f)] for w, f in cands],
                        dtype=np.float32)

    def normalized(self) -> np.ndarray:
        """MinMax-normalized theta values over the space (Alg 1 line 2)."""
        t = self.theta_features()
        lo, hi = t.min(axis=0), t.max(axis=0)
        return (t - lo) / np.maximum(hi - lo, 1e-9)

    # --- cache grid helpers (Alg 2) -------------------------------------------
    def snap_cache_up(self, mb: float) -> int:
        """Nearest equal-or-higher discrete cache value (Alg 2 line 7)."""
        for v in self.dirty_cache_mb:
            if v >= mb:
                return v
        return self.dirty_cache_mb[-1]

    @property
    def cache_min(self) -> int:
        return self.dirty_cache_mb[0]

    @property
    def cache_max(self) -> int:
        return self.dirty_cache_mb[-1]


def default_spaces() -> CaratSpaces:
    from repro_torch.configs.carat_defaults import SPACES
    return SPACES
