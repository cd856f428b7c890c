"""The paper's Table II client-local metrics.

Each metric is computed per interval, separately for reads and writes,
from differenced cumulative counters plus instantaneous gauges — exactly
what a privileged client-side daemon can sample from `osc`/`llite` procfs.
The "Estimated Cache Update" metric uses the paper's *estimator* (bytes the
application wrote minus RPC drain minus cache growth) rather than the
model's internal ground truth, preserving the observability contract.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.storage.params import PAGE_SIZE
from repro_torch.storage.stats import ClientStats, diff_op


@dataclass(frozen=True)
class Metrics:
    """One op-direction's Table II metric vector for one interval."""
    rpc_page_util: float        # avg pages/RPC  / max_pages_per_rpc
    rpc_channel_util: float     # avg in-flight  / max_rpcs_in_flight
    unit_page_latency: float    # avg per-page RPC latency (seconds)
    data_volume: float          # bytes moved via RPCs this interval
    dirty_cache_util: float     # dirty bytes / max_dirty_mb
    est_cache_update: float     # estimated in-place-updated bytes

    def vector(self) -> np.ndarray:
        return np.array([
            self.rpc_page_util,
            self.rpc_channel_util,
            self.unit_page_latency,
            self.data_volume,
            self.dirty_cache_util,
            self.est_cache_update,
        ], dtype=np.float32)


FEATURE_NAMES = (
    "rpc_page_util", "rpc_channel_util", "unit_page_latency",
    "data_volume", "dirty_cache_util", "est_cache_update",
)


def compute_metrics(
    cur: ClientStats,
    prev: ClientStats,
    op: str,
    interval_s: float,
) -> Metrics:
    d = diff_op(cur.op(op), prev.op(op))
    window = max(cur.rpc_window_pages, 1)
    inflight_cap = max(cur.rpcs_in_flight, 1)
    cache_bytes = max(cur.dirty_cache_mb, 1) * 1024.0 * 1024.0

    rpcs = d["rpc_count"]
    pages = d["rpc_pages"]
    page_util = (pages / rpcs / window) if rpcs > 0 else 0.0
    # Lustre tunables and osc stats are per-OSC; averaging over the active
    # channels (rather than summing) is what lets a model trained on
    # single-stream/single-OSC patterns transfer to multi-stream runs.
    n_chan = max(d["channel_time"] / interval_s, 1.0)
    chan_util = d["inflight_time"] / interval_s / inflight_cap / n_chan
    # lat_sum integrates per-RPC completion latency over RPCs; dividing by
    # pages carried normalizes out batch size and concurrency (§III-B).
    unit_lat = (d["lat_sum_s"] / pages) if pages > 0 else 0.0
    volume = d["rpc_bytes"] / n_chan
    dirty_util = cur.dirty_bytes / cache_bytes if op == "write" else 0.0
    if op == "write":
        # paper estimator: app writes not accounted for by drain or growth
        cache_delta = cur.dirty_bytes - prev.dirty_bytes
        est_update = max(0.0, d["app_bytes"] - d["rpc_bytes"] - cache_delta)
    else:
        est_update = 0.0
    return Metrics(
        rpc_page_util=float(np.clip(page_util, 0.0, 1.5)),
        rpc_channel_util=float(np.clip(chan_util, 0.0, 1.5)),
        unit_page_latency=float(unit_lat),
        data_volume=float(volume),
        dirty_cache_util=float(np.clip(dirty_util, 0.0, 1.2)),
        est_cache_update=float(est_update),
    )


def normalize_features(vec: np.ndarray) -> np.ndarray:
    """Scale raw metrics into stable learning features (§III-B (iii)).

    Utilizations are already ratios; latency is log-scaled around the
    microsecond-to-millisecond band; volumes are log-bytes.
    """
    out = vec.astype(np.float32).copy()
    # layout per op: [page_util, chan_util, unit_lat, volume, dirty, est_upd]
    for base in range(0, out.shape[-1], 6):
        out[..., base + 2] = np.log10(np.maximum(out[..., base + 2], 1e-7)) + 7.0
        out[..., base + 3] = np.log10(np.maximum(out[..., base + 3], 1.0)) / 10.0
        out[..., base + 5] = np.log10(np.maximum(out[..., base + 5], 1.0)) / 10.0
    return out
