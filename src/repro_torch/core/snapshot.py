"""Snapshot builder: the paper's "system stats processor" (Fig 4, step 1-2).

Samples a client's cumulative counters at each probe interval, differences
them, computes the Table II metrics for both op directions, tracks
short-term deltas, and maintains the k-deep history ring the ML model
consumes. Overheads are measured per call for the Table VIII benchmark.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, Optional

import numpy as np

from repro_torch.core.metrics import Metrics, compute_metrics, normalize_features
from repro_torch.telemetry import perf_s
from repro_torch.storage.stats import ClientStats, diff_op


@dataclass
class Snapshot:
    t: float
    read: Metrics
    write: Metrics
    read_active: bool
    write_active: bool
    # raw counter deltas we need downstream
    read_app_bytes: float
    write_app_bytes: float
    dirty_peak_bytes: float
    inflight_peak: float
    window_pages: int
    in_flight: int
    dirty_cache_mb: int
    # app-level request deltas: the config-independent workload signature
    # (request size = app_bytes / app_requests) the phase-change detector
    # uses — RPC-level metrics would be confounded by the tunables
    read_app_requests: float = 0.0
    write_app_requests: float = 0.0

    @property
    def active(self) -> bool:
        return self.read_active or self.write_active

    @property
    def dominant_op(self) -> str:
        """Paper §III-D: pick model by dominant observed Data Transfer Volume."""
        return "read" if self.read.data_volume >= self.write.data_volume else "write"

    def op_metrics(self, op: str) -> Metrics:
        return self.read if op == "read" else self.write

    def perf(self, op: Optional[str] = None) -> float:
        """The performance signal s_t: application throughput (bytes/interval)."""
        if op == "read":
            return self.read_app_bytes
        if op == "write":
            return self.write_app_bytes
        return self.read_app_bytes + self.write_app_bytes


class SnapshotBuilder:
    """Per-client sampler with k-deep history (paper: k=1 is best)."""

    def __init__(self, interval_s: float = 0.5, history_k: int = 1):
        self.interval_s = interval_s
        self.history_k = history_k
        self._prev: Optional[ClientStats] = None
        self.history: Deque[Snapshot] = deque(maxlen=history_k + 1)
        # Table VIII accounting
        self.snapshot_time_total = 0.0
        self.snapshot_count = 0

    def sample(self, stats: ClientStats, t: float) -> Optional[Snapshot]:
        """Returns None for the very first sample (no diff possible yet)."""
        t0 = perf_s()
        cur = stats.snapshot()
        snap: Optional[Snapshot] = None
        if self._prev is not None:
            rd = compute_metrics(cur, self._prev, "read", self.interval_s)
            wr = compute_metrics(cur, self._prev, "write", self.interval_s)
            d_rd = diff_op(cur.read, self._prev.read)
            d_wr = diff_op(cur.write, self._prev.write)
            snap = Snapshot(
                t=t,
                read=rd, write=wr,
                read_active=d_rd["app_requests"] > 0,
                write_active=d_wr["app_requests"] > 0,
                read_app_bytes=d_rd["app_bytes"],
                write_app_bytes=d_wr["app_bytes"],
                read_app_requests=d_rd["app_requests"],
                write_app_requests=d_wr["app_requests"],
                dirty_peak_bytes=cur.dirty_peak_bytes,
                inflight_peak=cur.inflight_peak,
                window_pages=cur.rpc_window_pages,
                in_flight=cur.rpcs_in_flight,
                dirty_cache_mb=cur.dirty_cache_mb,
            )
            self.history.append(snap)
        self._prev = cur
        self.snapshot_time_total += perf_s() - t0
        self.snapshot_count += 1
        return snap

    # ---------------------------------------------------------------- features
    def feature_vector(self, op: str) -> Optional[np.ndarray]:
        """H_t for the chosen op-direction model: metrics at t and t-1,
        their short-term deltas (the paper's "Metrics on Changes"), and the
        currently-applied config (log2-scaled). Returns None until the
        history is deep enough."""
        if len(self.history) < 2:
            return None
        cur, prev = self.history[-1], self.history[-2]
        m_cur = cur.op_metrics(op).vector()
        m_prev = prev.op_metrics(op).vector()
        raw = np.concatenate([m_cur, m_prev]).astype(np.float32)
        feats = normalize_features(raw)
        deltas = feats[:6] - feats[6:12]
        cfg = np.array([np.log2(max(cur.window_pages, 1)),
                        np.log2(max(cur.in_flight, 1))], dtype=np.float32)
        return np.concatenate([feats, deltas, cfg])

    @property
    def mean_snapshot_time_s(self) -> float:
        return self.snapshot_time_total / max(self.snapshot_count, 1)


FEATURE_DIM = 20  # 6 metrics x 2 timesteps + 6 deltas + 2 config features
THETA_DIM = 2     # candidate (log2 window, log2 in-flight)
