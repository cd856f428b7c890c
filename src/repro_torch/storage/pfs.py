"""The server side: OSTs with shared service queues.

Resolves the coupling between all clients each interval:

* per-OST utilization from every channel's offered RPC rate and size
  (fixed per-RPC cost + per-byte cost — many small RPCs burn server CPU);
* proportional capacity scaling when an OST is oversubscribed;
* queue-delay feedback (M/M/1-shaped, capped, EMA-smoothed) that clients
  observe one interval later — the paper's "global system state reflected
  in local metrics" (§I);
* an overload knee: past ``ost_overload_knee`` concurrent RPCs the fixed
  cost inflates, modeling server thrash under bursty high-concurrency
  traffic (§II-A b). This is what makes *trimming* in-flight concurrency
  under contention a winning move, as CARAT does in §IV-H.

OST state is held as dense ``(n_osts,)`` arrays (``PFSCluster.wait_s``
and friends); ``PFSCluster.osts`` is a per-OST view surface over them.
:meth:`PFSCluster.resolve_batch` is fully vectorized — one segment
reduction per accumulated quantity over stably-sorted OST ids, with the
per-OST *sequential* float association preserved exactly (see
:class:`_SegmentFold`), so the ``soa`` backend stays bit-identical to
the scalar oracle with no per-OST Python loop on the hot path.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.storage.client import ChannelDemand
from repro_torch.storage.params import PAGE_SIZE, PFSParams
from repro_torch.utils.rng import RngStream

# (cluster array field, OSTState attribute) — one (n_osts,) array each
OST_FIELDS = ("wait_s", "utilization", "inflight", "served_bytes",
              "served_rpcs")


class OSTState:
    """Read/write view of one OST's row in the cluster state arrays."""

    __slots__ = ("_c", "_i")

    def __init__(self, cluster: "PFSCluster", i: int):
        self._c = cluster
        self._i = i


for _f in OST_FIELDS:
    def _get(self, _f=_f):
        return float(getattr(self._c, _f)[self._i])

    def _set(self, v, _f=_f):
        getattr(self._c, _f)[self._i] = v

    setattr(OSTState, _f, property(_get, _set))
del _f


class ClusterFeedback:
    """Per-OST resolve outputs. The dense arrays are primary — resolve
    fills them directly — and the id-keyed dict views (what the scalar
    ``IOClient.commit`` consumes) derive lazily from them, so the hot
    array-backend path never materializes a dict per interval."""

    __slots__ = ("scale_arr", "waits_arr", "_scale", "_waits")

    def __init__(self, scale_arr: np.ndarray, waits_arr: np.ndarray):
        self.scale_arr = scale_arr
        self.waits_arr = waits_arr
        self._scale: Dict[int, float] | None = None
        self._waits: Dict[int, float] | None = None

    @property
    def scale(self) -> Dict[int, float]:
        if self._scale is None:
            self._scale = {i: float(v) for i, v in enumerate(self.scale_arr)}
        return self._scale

    @property
    def waits(self) -> Dict[int, float]:
        if self._waits is None:
            self._waits = {i: float(v) for i, v in enumerate(self.waits_arr)}
        return self._waits

    def as_arrays(self, n_osts: int):
        """(scale, waits) as dense arrays (kept for interface compat —
        they are now always populated at construction)."""
        return self.scale_arr, self.waits_arr


class _SegmentFold:
    """Exact per-OST *sequential* sums over stably-sorted demand columns.

    The scalar resolver accumulates each OST's demands with a
    left-to-right ``+=`` loop; ``np.sum``/``np.add.reduceat`` reassociate
    floats (pairwise summation), so they cannot reproduce it bitwise.
    Instead each column is scattered into a dense ``(n_osts, kmax)``
    row-per-OST layout (demands left-aligned in arrival order) and
    reduced with one ``np.cumsum`` along the row axis — cumsum is a
    sequential scan, so the value at each segment's last filled slot is
    the exact left-fold sum. A sum starting from 0.0 is exact
    (``0.0 + x == x`` for finite ``x``), and trailing zero padding sits
    after the read-out slot, so padding never perturbs identity.
    """

    def __init__(self, ost_s: np.ndarray, counts: np.ndarray):
        self.n_osts = counts.shape[0]
        self.counts = counts
        d = ost_s.shape[0]
        self.kmax = int(counts.max()) if d else 0
        if d:
            lo = np.concatenate([[0], np.cumsum(counts[:-1])])
            self.row = ost_s
            self.col = np.arange(d, dtype=np.int64) - lo[ost_s]
        self.rows = np.arange(self.n_osts)
        self.last = np.maximum(counts - 1, 0)

    def sums(self, *cols: np.ndarray) -> List[np.ndarray]:
        if self.kmax == 0:
            return [np.zeros(self.n_osts) for _ in cols]
        m = np.zeros((len(cols), self.n_osts, self.kmax))
        for ci, c in enumerate(cols):
            m[ci, self.row, self.col] = c
        # empty segments read slot 0, which stays 0.0 — no masking needed
        res = np.cumsum(m, axis=2)[:, self.rows, self.last]
        return list(res)


class PFSCluster:
    def __init__(self, params: PFSParams, rng: RngStream | None = None):
        self.p = params
        self.rng = rng or RngStream(0, "pfs")
        n = params.n_osts
        self.wait_s = np.zeros(n)        # smoothed queue delay clients observe
        self.utilization = np.zeros(n)   # offered / capacity last interval
        self.inflight = np.zeros(n)      # concurrent RPCs offered last interval
        self.served_bytes = np.zeros(n)  # cumulative
        self.served_rpcs = np.zeros(n)   # cumulative
        self._views: List[OSTState] | None = None

    @property
    def osts(self) -> List[OSTState]:
        """Per-OST view surface over the dense state arrays."""
        if self._views is None:
            self._views = [OSTState(self, i) for i in range(self.p.n_osts)]
        return self._views

    def _noise_for(self, nonempty: np.ndarray) -> np.ndarray:
        """One lognormal draw per non-empty OST in ascending id order.

        A batched ``Generator`` draw of size k consumes the bit stream
        exactly like k sequential scalar draws, so array and scalar
        resolvers stay on the same RNG trajectory.
        """
        noise = np.ones(self.p.n_osts)
        k = int(np.count_nonzero(nonempty))
        if k:
            noise[nonempty] = self.rng.gen.lognormal(
                0.0, self.p.noise_sigma, size=k)
        return noise

    def resolve(self, demands: List[ChannelDemand], dt: float) -> ClusterFeedback:
        p = self.p
        scale_arr = np.ones(p.n_osts)
        # group demands per OST
        by_ost: Dict[int, List[ChannelDemand]] = {}
        for d in demands:
            by_ost.setdefault(d.ost, []).append(d)

        for ost_id in range(p.n_osts):
            ds = by_ost.get(ost_id, [])
            if not ds:
                # idle: queue drains, wait decays
                self.wait_s[ost_id] *= 0.25
                self.utilization[ost_id] = 0.0
                self.inflight[ost_id] = 0.0
                continue

            noise = float(self.rng.gen.lognormal(0.0, p.noise_sigma))

            # overload knee: concurrency past the knee inflates fixed cost
            inflight_offered = sum(d.window for d in ds)
            over = max(0.0, inflight_offered / p.ost_overload_knee - 1.0)
            fixed_eff = p.ost_fixed_cpu_s * (1.0 + p.ost_overload_gamma * over)

            # SSD bandwidth needs queue depth: QD1 delivers a fraction of
            # the device ceiling, deep pipelines approach it
            qd = max(inflight_offered, 1.0)
            disk_bw = (p.ost_disk_bw * qd / (qd + p.ssd_qd_half)) / noise

            # utilization: sum over channels of rate x service time
            util = 0.0
            byte_rate = 0.0
            for d in ds:
                svc = fixed_eff + d.rpc_pages * PAGE_SIZE / disk_bw
                util += d.rpc_rate * svc
                byte_rate += d.byte_rate
            # network ceiling into the OSS counts too
            util = max(util, byte_rate / p.ost_ingress_bw)

            if util <= 0.95:
                scale = 1.0
            else:
                scale = 0.95 / util   # proportional share under overload

            # queue delay feedback (served load rho after scaling)
            rho = min(util * scale, 0.95)
            svc_avg = (sum(fixed_eff + d.rpc_pages * PAGE_SIZE / disk_bw
                           for d in ds) / len(ds))
            wait_now = min(p.queue_wait_cap_s, svc_avg * rho / max(1 - rho, 0.05))
            if util > 1.0:   # saturated: queue rides the cap
                wait_now = p.queue_wait_cap_s
            a = p.queue_smoothing
            self.wait_s[ost_id] = a * self.wait_s[ost_id] + (1 - a) * wait_now
            self.utilization[ost_id] = util
            self.inflight[ost_id] = inflight_offered
            self.served_bytes[ost_id] += byte_rate * scale * dt
            self.served_rpcs[ost_id] += sum(d.rpc_rate for d in ds) * scale * dt

            scale_arr[ost_id] = scale
        return ClusterFeedback(scale_arr, self.wait_s.copy())

    def resolve_batch(self, batch, dt: float) -> ClusterFeedback:
        """Array-path ``resolve`` over a :class:`~repro_torch.storage.soa.DemandBatch`.

        Bit-identical to :meth:`resolve` fed the same demands in the same
        order, with no per-OST Python loop: demands are stably partitioned
        by OST (scalar grouping preserves arrival order within an OST),
        every order-sensitive accumulation is a :class:`_SegmentFold`
        sequential segment sum, the idle-wait decay is one masked array
        op, and the lognormal noise is one batched draw covering the
        non-empty OSTs in ascending id order — exactly the scalar RNG
        consumption pattern.
        """
        p = self.p
        n_osts = p.n_osts
        order = np.argsort(batch.ost, kind="stable")
        ost_s = batch.ost[order]
        rate_s = batch.rpc_rate[order]
        pages_s = batch.rpc_pages[order]
        win_s = batch.window[order]
        # ChannelDemand.byte_rate association: (rate * pages) * PAGE_SIZE
        byte_s = (rate_s * pages_s) * PAGE_SIZE
        counts = np.bincount(ost_s, minlength=n_osts)
        nonempty = counts > 0
        noise = self._noise_for(nonempty)

        seg = _SegmentFold(ost_s, counts)
        (inflight_offered,) = seg.sums(win_s)
        over = np.maximum(0.0, inflight_offered / p.ost_overload_knee - 1.0)
        fixed_eff = p.ost_fixed_cpu_s * (1.0 + p.ost_overload_gamma * over)

        qd = np.maximum(inflight_offered, 1.0)
        disk_bw = (p.ost_disk_bw * qd / (qd + p.ssd_qd_half)) / noise

        svc = fixed_eff[ost_s] + pages_s * PAGE_SIZE / disk_bw[ost_s]
        util, byte_rate, svc_sum, rate_sum = seg.sums(
            rate_s * svc, byte_s, svc, rate_s)
        util = np.maximum(util, byte_rate / p.ost_ingress_bw)
        # the util=0 lanes (empty OSTs) only feed the discarded where-branch
        with np.errstate(divide="ignore"):
            scale = np.where(util <= 0.95, 1.0, 0.95 / util)

        rho = np.minimum(util * scale, 0.95)
        svc_avg = svc_sum / np.maximum(counts, 1)
        wait_now = np.minimum(p.queue_wait_cap_s,
                              svc_avg * rho / np.maximum(1.0 - rho, 0.05))
        wait_now = np.where(util > 1.0, p.queue_wait_cap_s, wait_now)
        a = p.queue_smoothing
        self.wait_s = np.where(nonempty,
                               a * self.wait_s + (1 - a) * wait_now,
                               self.wait_s * 0.25)
        self.utilization = np.where(nonempty, util, 0.0)
        self.inflight = np.where(nonempty, inflight_offered, 0.0)
        # empty OSTs contribute exact +0.0 terms (byte/rate sums are 0)
        self.served_bytes = self.served_bytes + (byte_rate * scale) * dt
        self.served_rpcs = self.served_rpcs + (rate_sum * scale) * dt

        return ClusterFeedback(np.where(nonempty, scale, 1.0),
                               self.wait_s.copy())
