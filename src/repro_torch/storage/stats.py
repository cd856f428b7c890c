"""Client-local cumulative counters — the modeled `llite`/`osc` procfs.

CARAT (paper §III-B) samples *cumulative* kernel counters and differences
them per probe interval. We preserve that contract: the PFS model only ever
increments these counters; the CARAT stats processor owns the sampling and
differencing. Gauges (dirty level, current config) are instantaneous.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass
class OpCounters:
    """Cumulative counters for one operation direction (read or write)."""
    app_bytes: float = 0.0        # application-visible completed bytes
    app_requests: float = 0.0
    rpc_count: float = 0.0        # RPCs dispatched
    rpc_pages: float = 0.0        # pages carried by those RPCs
    rpc_bytes: float = 0.0        # bytes carried by those RPCs
    lat_sum_s: float = 0.0        # sum of per-RPC completion latencies
    inflight_time: float = 0.0    # integral of in-flight RPCs over time
    channel_time: float = 0.0     # integral of active OSC channels over time
    absorbed_bytes: float = 0.0   # write bytes absorbed in-place in cache
    blocked_s: float = 0.0        # time streams spent blocked on cache
    active_s: float = 0.0         # time the op direction was I/O-active


@dataclass
class ClientStats:
    """Full counter set for one I/O client (one per compute node)."""
    read: OpCounters = field(default_factory=OpCounters)
    write: OpCounters = field(default_factory=OpCounters)
    # gauges ------------------------------------------------------------------
    dirty_bytes: float = 0.0
    dirty_peak_bytes: float = 0.0
    inflight_peak: float = 0.0
    # current tunables (mirrors `lctl get_param`) -------------------------------
    rpc_window_pages: int = 0
    rpcs_in_flight: int = 0
    dirty_cache_mb: int = 0

    def op(self, name: str) -> OpCounters:
        if name == "read":
            return self.read
        if name == "write":
            return self.write
        raise KeyError(name)

    def snapshot(self) -> "ClientStats":
        """Deep copy, as a procfs read would capture.

        Built explicitly (all fields are plain floats/ints):
        ``copy.deepcopy`` walks the object graph reflectively and
        dominated the probe path when every client snapshots every
        interval at fleet scale.
        """
        return ClientStats(
            read=OpCounters(**vars(self.read)),
            write=OpCounters(**vars(self.write)),
            dirty_bytes=self.dirty_bytes,
            dirty_peak_bytes=self.dirty_peak_bytes,
            inflight_peak=self.inflight_peak,
            rpc_window_pages=self.rpc_window_pages,
            rpcs_in_flight=self.rpcs_in_flight,
            dirty_cache_mb=self.dirty_cache_mb,
        )


def diff_op(cur: OpCounters, prev: OpCounters) -> Dict[str, float]:
    """Per-interval deltas of cumulative counters (CARAT's differencing)."""
    return {
        "app_bytes": cur.app_bytes - prev.app_bytes,
        "app_requests": cur.app_requests - prev.app_requests,
        "rpc_count": cur.rpc_count - prev.rpc_count,
        "rpc_pages": cur.rpc_pages - prev.rpc_pages,
        "rpc_bytes": cur.rpc_bytes - prev.rpc_bytes,
        "lat_sum_s": cur.lat_sum_s - prev.lat_sum_s,
        "inflight_time": cur.inflight_time - prev.inflight_time,
        "channel_time": cur.channel_time - prev.channel_time,
        "absorbed_bytes": cur.absorbed_bytes - prev.absorbed_bytes,
        "blocked_s": cur.blocked_s - prev.blocked_s,
        "active_s": cur.active_s - prev.active_s,
    }
