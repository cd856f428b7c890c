"""Struct-of-arrays simulation core: the fleet-scale twin of ``IOClient``.

``Simulation(backend="scalar")`` holds one Python ``IOClient`` per client
and loops over them each probe interval, which caps fleets at a few
hundred clients on interpreter overhead alone. This module re-hosts the
*identical* interval-fluid model as dense per-client NumPy arrays
(:class:`SoACore`): one vectorized :meth:`SoACore.plan` computes every
client's write/read plan at once, demands flatten into a
:class:`DemandBatch` that :meth:`~repro_torch.storage.pfs.PFSCluster.resolve_batch`
resolves with per-OST segment sums, and one :meth:`SoACore.commit`
applies feedback and bumps all cumulative counters in whole-array
operations.

The scalar path stays as the identity oracle. The contract is
**bit-identity**, not approximation, which constrains the vectorization:

* every float expression keeps the scalar code's association (the
  comments in :meth:`SoACore.plan` / :meth:`SoACore.commit` cite the
  matching ``IOClient`` lines);
* order-sensitive accumulations never use pairwise summation —
  per-client channel sums run as a column loop over the dense
  ``(clients, channels)`` layout (exactly the scalar per-demand ``+=``
  order), and per-OST sums in ``resolve_batch`` use ``np.cumsum`` on
  stably-sorted segments (``np.sum``/``np.add.reduceat`` reassociate;
  ``cumsum`` is sequential);
* demands carry a canonical *ordinal* (client position x op x channel)
  so sharded planning can reassemble the exact single-process demand
  order before the one globally-coupled resolve.

Masked lanes (a client with no write plan this interval) contribute
exact ``+0.0`` terms, which IEEE-754 addition leaves bit-invariant on
the non-negative counters, so masking never perturbs identity.

The float-order contract is lint-enforced in the reference package
(``caratlint`` rule CL003 on ``repro/storage/soa.py``); this copy keeps
the same expressions line for line, so it stays bit-identical to it.

The arrays are NumPy: this module is the host oracle that the
``soa-torch`` device fleet (:mod:`repro_torch.storage.device`) is held
against, and the host side of that fleet's lazy ownership protocol
(:meth:`SoACore.ensure_host` / :meth:`SoACore.host_mutated`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.storage.client import ClientConfig
from repro_torch.storage.params import PAGE_SIZE, PFSParams
from repro_torch.storage.stats import ClientStats, OpCounters
from repro_torch.storage.workloads import WorkloadSpec

OP_READ, OP_WRITE, OP_MIXED = 0, 1, 2
ACC_SEQ, ACC_RANDOM, ACC_STRIDED = 0, 1, 2
_OP_CODE = {"read": OP_READ, "write": OP_WRITE, "mixed": OP_MIXED}
_ACC_CODE = {"seq": ACC_SEQ, "random": ACC_RANDOM, "strided": ACC_STRIDED}

# field order matches repro_torch.storage.stats.OpCounters
OP_FIELDS = ("app_bytes", "app_requests", "rpc_count", "rpc_pages",
             "rpc_bytes", "lat_sum_s", "inflight_time", "channel_time",
             "absorbed_bytes", "blocked_s", "active_s")

_PAGE = float(PAGE_SIZE)


class OpArrays:
    """One op direction's cumulative counters as ``(n,)`` float64 arrays."""

    __slots__ = OP_FIELDS

    def __init__(self, n: int):
        for f in OP_FIELDS:
            setattr(self, f, np.zeros(n))

    def materialize(self, i: int) -> OpCounters:
        return OpCounters(**{f: float(getattr(self, f)[i])
                             for f in OP_FIELDS})


@dataclass
class DemandBatch:
    """Flattened channel demands (the array twin of ``ChannelDemand``).

    ``ordinal`` is the demand's position in the canonical single-process
    demand order (client position, write-before-read, channel index) —
    sharded planning merges per-shard batches by it so the float-order-
    sensitive per-OST accumulation sees the exact scalar order.
    """
    ost: np.ndarray         # (d,) int64
    rpc_rate: np.ndarray    # (d,) float64, offered RPCs/s
    rpc_pages: np.ndarray   # (d,) float64, average pages per RPC
    window: np.ndarray      # (d,) float64, in-flight slots
    ordinal: np.ndarray     # (d,) int64, canonical demand position

    @property
    def n(self) -> int:
        return int(self.ost.shape[0])

    @staticmethod
    def empty() -> "DemandBatch":
        z = np.zeros(0)
        return DemandBatch(ost=np.zeros(0, np.int64), rpc_rate=z,
                           rpc_pages=z, window=z,
                           ordinal=np.zeros(0, np.int64))

    @staticmethod
    def concat(batches: Sequence["DemandBatch"]) -> "DemandBatch":
        """Order-preserving concatenation (the async echo path: own
        demands first, then other shards' echoes, like the scalar
        ``demands + echo`` list)."""
        bs = list(batches)
        if not bs:
            return DemandBatch.empty()
        return DemandBatch(
            ost=np.concatenate([b.ost for b in bs]),
            rpc_rate=np.concatenate([b.rpc_rate for b in bs]),
            rpc_pages=np.concatenate([b.rpc_pages for b in bs]),
            window=np.concatenate([b.window for b in bs]),
            ordinal=np.concatenate([b.ordinal for b in bs]))

    @staticmethod
    def merge(batches: Sequence["DemandBatch"]) -> "DemandBatch":
        """Concatenate and restore canonical order by ordinal — the
        sharded sync barrier's reassembly into single-process order."""
        cat = DemandBatch.concat(batches)
        order = np.argsort(cat.ordinal, kind="stable")
        return DemandBatch(ost=cat.ost[order], rpc_rate=cat.rpc_rate[order],
                           rpc_pages=cat.rpc_pages[order],
                           window=cat.window[order],
                           ordinal=cat.ordinal[order])


@dataclass
class PlanBatch:
    """All clients' plans for one interval (the array twin of ``Plan``).

    Per-client arrays are ``(m,)`` over the planned subset ``idx`` (global
    client positions); per-channel arrays are ``(m, kmax)`` over the dense
    channel layout with ``ch_valid`` masking real channels.
    """
    idx: np.ndarray             # (m,) int64 global client positions
    t: float
    dt: float
    active: np.ndarray          # (m,) bool — Plan.active
    has_write: np.ndarray       # (m,) bool — plan.write is not None
    has_read: np.ndarray        # (m,) bool — read demands exist
    ch_ost: np.ndarray          # (m, kmax) int64
    ch_valid: np.ndarray        # (m, kmax) bool
    # write-op terms (garbage where ~has_write; always masked before use)
    w_pages: np.ndarray         # (m,) p_eff
    w_rate: np.ndarray          # (m, kmax) offered RPCs/s
    w_window: np.ndarray        # (m, kmax)
    admitted: np.ndarray        # (m,)
    absorbed: np.ndarray        # (m,)
    new_dirty_rate: np.ndarray  # (m,)
    lam_bytes: np.ndarray       # (m,)
    # read-op terms (garbage where ~has_read)
    r_pages: np.ndarray         # (m,)
    r_rate: np.ndarray          # (m, kmax)
    r_window: np.ndarray        # (m, kmax)

    def demand_batch(self) -> DemandBatch:
        """Flatten to canonical demand order: ascending client position,
        write channels before read channels (``Plan.all_demands``),
        channels in placement order."""
        m, k = self.ch_ost.shape
        if m == 0:
            return DemandBatch.empty()
        wv = self.has_write[:, None] & self.ch_valid
        rv = self.has_read[:, None] & self.ch_valid
        valid = np.concatenate([wv, rv], axis=1).ravel()
        ost2 = np.concatenate([self.ch_ost, self.ch_ost], axis=1)
        rate2 = np.concatenate([self.w_rate, self.r_rate], axis=1)
        pages2 = np.concatenate(
            [np.broadcast_to(self.w_pages[:, None], (m, k)),
             np.broadcast_to(self.r_pages[:, None], (m, k))], axis=1)
        win2 = np.concatenate([self.w_window, self.r_window], axis=1)
        base = self.idx.astype(np.int64) * (2 * k)
        ordn = base[:, None] + np.arange(2 * k, dtype=np.int64)[None, :]
        return DemandBatch(
            ost=ost2.ravel()[valid].astype(np.int64),
            rpc_rate=rate2.ravel()[valid],
            rpc_pages=pages2.ravel()[valid],
            window=win2.ravel()[valid],
            ordinal=ordn.ravel()[valid])


class _Static:
    """Plain namespace for the precomputed plan constants
    (:meth:`SoACore._ensure_static`)."""


class SoACore:
    """Dense per-client state + vectorized plan/commit over any subset.

    Arrays are indexed by *client position* (the ``Simulation.clients``
    list position, not the client id) — the canonical order every
    float-sensitive accumulation is defined over.
    """

    def __init__(
        self,
        params: PFSParams,
        workloads: Sequence[WorkloadSpec],
        configs: Sequence[ClientConfig],
        client_ids: Sequence[int],
        stripe_offsets: Sequence[int],
    ):
        n = len(workloads)
        if not (len(configs) == len(client_ids) == len(stripe_offsets) == n):
            raise ValueError("workloads/configs/client_ids/stripe_offsets "
                             "must be position-aligned")
        self.p = params
        self.n = n
        self.xp = np
        self.client_ids = np.asarray(list(client_ids), dtype=np.int64)
        self.stripe_offset = np.asarray(list(stripe_offsets), dtype=np.int64)

        # --- tunables (the Table I surface; mirrors ClientConfig) ----------
        for cfg in configs:
            cfg.validate()
        self.cfg_window = np.asarray([c.rpc_window_pages for c in configs],
                                     dtype=np.int64)
        self.cfg_inflight = np.asarray([c.rpcs_in_flight for c in configs],
                                       dtype=np.int64)
        self.cfg_cache_mb = np.asarray([c.dirty_cache_mb for c in configs],
                                       dtype=np.int64)

        # --- carried state -------------------------------------------------
        self.dirty_bytes = np.zeros(n)
        self.last_drain = np.zeros(n)
        # per-(client, OST) observed queue delay; a full row so async
        # shards can carry replica feedback without dict churn
        self.waits = np.zeros((n, params.n_osts))

        # --- cumulative counters + gauges ----------------------------------
        self.read = OpArrays(n)
        self.write = OpArrays(n)
        self.dirty_peak_bytes = np.zeros(n)
        self.inflight_peak = np.zeros(n)

        # --- workload descriptors ------------------------------------------
        # the live spec objects are kept for the `is`-based switch check
        # (SchedulePolicy) and the view surface; the arrays are what the
        # vectorized math reads
        self.specs: List[WorkloadSpec] = [None] * n  # type: ignore
        self.wl_op = np.zeros(n, dtype=np.int8)
        self.wl_access = np.zeros(n, dtype=np.int8)
        self.wl_req = np.zeros(n)
        self.wl_streams = np.zeros(n, dtype=np.int64)
        self.wl_file = np.zeros(n)
        self.wl_inplace = np.zeros(n)
        self.wl_read_frac = np.zeros(n)
        self.wl_think = np.zeros(n)
        self.wl_duty = np.zeros(n)
        self.wl_period = np.zeros(n)
        self.wl_stride = np.zeros(n)
        # identity token for "this plan/commit covers the whole fleet":
        # Simulation passes this exact array for full steps, unlocking the
        # gather/scatter-free fast path
        self.idx_all = np.arange(n, dtype=np.int64)
        self._layout_ok = False
        self._static_ok = False
        # device residency (storage.device.DeviceFleet attaches here):
        # while a device fleet is stepping, the device arrays are the
        # source of truth and the host arrays above go stale until
        # ensure_host() pulls them back. _static_version lets the device
        # re-upload plan constants only when a setter actually dirtied
        # them; _wl_version tracks workload mutations (they change the
        # OST-activity pattern the device step predicts for RNG draws).
        self._device = None
        self._static_version = 0
        self._wl_version = 0
        for i, wl in enumerate(workloads):
            self.set_workload(i, wl)

    # ---------------------------------------------------- device residency
    def ensure_host(self) -> None:
        """Pull carried state/counters off the device if they are stale.

        Cheap no-op (one attribute check) without an attached device
        fleet — every host-side read path calls this.
        """
        d = self._device
        if d is not None and d.host_stale:
            d.sync_host()

    def host_mutated(self) -> None:
        """Mark device-held state stale after a host-side state write
        (the device fleet re-uploads before its next fused step)."""
        d = self._device
        if d is not None:
            d.device_stale = True

    # -------------------------------------------------------------- setters
    def set_workload(self, i: int, spec: WorkloadSpec) -> None:
        self.specs[i] = spec
        self.wl_op[i] = _OP_CODE[spec.op]
        self.wl_access[i] = _ACC_CODE[spec.access]
        self.wl_req[i] = float(spec.req_bytes)
        if self.wl_streams[i] != spec.n_streams:
            self.wl_streams[i] = spec.n_streams
            self._layout_ok = False
        self.wl_file[i] = float(spec.file_bytes)
        self.wl_inplace[i] = spec.inplace_frac
        self.wl_read_frac[i] = spec.read_frac
        self.wl_think[i] = spec.think_s
        self.wl_duty[i] = spec.duty_cycle
        self.wl_period[i] = spec.period_s
        self.wl_stride[i] = float(spec.stride_bytes)
        self._static_ok = False
        self._wl_version += 1

    def set_rpc_config(self, i: int, window_pages: int,
                       in_flight: int) -> None:
        if int(window_pages) < 1 or int(in_flight) < 1:
            raise ValueError("RPC tunables must be >= 1")
        self.cfg_window[i] = int(window_pages)
        self.cfg_inflight[i] = int(in_flight)
        self._static_ok = False

    def set_cache_limit(self, i: int, dirty_mb: int) -> None:
        if int(dirty_mb) < 1:
            raise ValueError("dirty_cache_mb must be >= 1")
        self.cfg_cache_mb[i] = int(dirty_mb)
        self._static_ok = False

    # ------------------------------------------------------- channel layout
    def _ensure_layout(self) -> None:
        """Dense (n, kmax) channel layout from the striping rule.

        Channel j of client i lands on OST ``(stripe_offset_i + j) %
        n_osts`` and hosts ``(n_streams_i - j - 1) // n_osts + 1``
        streams — exactly ``IOClient.stream_osts`` in placement
        (insertion) order. Rebuilt lazily when any stream count changes.
        """
        if self._layout_ok:
            return
        n_osts = self.p.n_osts
        k = np.minimum(self.wl_streams, n_osts)        # channels per client
        kmax = max(int(k.max()) if self.n else 1, 1)
        j = np.arange(kmax, dtype=np.int64)[None, :]
        valid = j < k[:, None]
        ost = (self.stripe_offset[:, None] + j) % n_osts
        streams = (self.wl_streams[:, None] - j - 1) // n_osts + 1
        # published as one tuple so async shard threads planning against
        # a concurrently-rebuilt layout still read a consistent snapshot
        self._layout = (np.where(valid, ost, 0).astype(np.int64),
                        valid,
                        np.where(valid, streams, 0).astype(np.int64),
                        # n_ch mirrors scalar `max(len(placement), 1)`
                        np.maximum(k, 1).astype(np.int64))
        self._layout_ok = True
        self._static_ok = False

    def _ensure_static(self) -> None:
        """Plan terms that depend only on (workload, config, layout,
        params) — precomputed once and reused every interval until a
        setter dirties them. Association of every expression matches the
        scalar source exactly (these are the same intermediates
        ``_plan_write``/``_plan_read`` compute per call)."""
        self._ensure_layout()
        if self._static_ok:
            return
        p = self.p
        ch_ost, ch_valid, ch_streams, n_ch = self._layout
        s = _Static()
        s.ch_ost, s.ch_valid = ch_ost, ch_valid
        W = self.cfg_window.astype(np.float64)
        F = self.cfg_inflight.astype(np.float64)
        s.W, s.F = W, F
        s.C = (self.cfg_cache_mb.astype(np.float64) * 1024.0) * 1024.0
        R = self.wl_req
        s.R = R
        s.req_g = np.maximum(R, 1.0)
        s.inplace = self.wl_inplace
        s.think = self.wl_think
        s.is_read = self.wl_op == OP_READ
        s.is_mixed = self.wl_op == OP_MIXED
        s.is_seq = self.wl_access == ACC_SEQ
        s.is_strided = self.wl_access == ACC_STRIDED
        s.is_rand = self.wl_access == ACC_RANDOM
        s.duty_pos = self.wl_duty > 0.0
        s.duty_full = self.wl_duty >= 1.0
        s.period_g = np.where(self.wl_period > 0.0, self.wl_period, 1.0)
        s.dxp = self.wl_duty * self.wl_period

        streams = self.wl_streams.astype(np.float64)
        req_pages = np.maximum(1.0, np.ceil(R / PAGE_SIZE))
        per_req_s = (p.syscall_s + R / p.mem_bw) + self.wl_think
        stride_g = np.where(self.wl_stride > 0.0, self.wl_stride, 1.0)
        n_ch_f = n_ch.astype(np.float64)
        ch_streams_f = ch_streams.astype(np.float64)
        r_share = np.where(s.is_mixed, self.wl_read_frac, 1.0)
        w_share = np.where(s.is_mixed, 1.0 - self.wl_read_frac, 1.0)
        s.n_ch_f = n_ch_f
        s.nic_per_ch = p.nic_bw / n_ch_f

        # ---- write-plan constants -----------------------------------------
        # (w_share ignores the drain-only share=0.0 case: that share only
        # feeds lam, and the drain-only lam is masked to 0 anyway)
        s.lam_rate_w = np.maximum(streams * w_share, 1e-6) / per_req_s
        s.hot_bytes = np.maximum(R, self.wl_file * 0.10)
        s.run = np.minimum(req_pages, W)
        s.p_eff_strided = np.minimum(
            W, np.maximum(s.run, W * np.minimum(R / stride_g, 1.0)))
        s.n_extents = np.maximum(self.wl_file / (W * _PAGE), 1.0)
        s.form_scan = (W * _PAGE) / p.extent_scan_bw

        # ---- read-plan constants ------------------------------------------
        p_eff_sl = np.where(s.is_seq, W, np.minimum(req_pages, W))
        ra_frac = np.where(s.is_seq, 1.0, np.minimum(R / stride_g, 1.0))
        rb_sl = p_eff_sl * PAGE_SIZE
        s.rb_sl = rb_sl
        s.depth = np.minimum(
            F[:, None],
            (np.maximum(1.0, (p.readahead_bytes * ra_frac) / rb_sl)[:, None]
             * ch_streams_f) * r_share[:, None])
        s.lam_r_per_ch = ((np.maximum(streams * r_share, 1e-6) / per_req_s)
                          * R) / n_ch_f
        p_eff_rd = np.minimum(req_pages, W)
        s.rb_rd = p_eff_rd * PAGE_SIZE
        rpr = np.ceil(req_pages / W)
        s.misfire = p.ra_misfire_frac * ((W * _PAGE) / p.ost_disk_bw)
        s.waves = np.ceil(rpr / np.maximum(np.minimum(F, rpr), 1.0))
        s_here = ch_streams_f * r_share[:, None]
        s.s_here = s_here
        s.win_rd = np.minimum(F[:, None], rpr[:, None] * s_here)
        s.r_pages = np.where(s.is_rand, p_eff_rd, p_eff_sl)
        self._static = s
        self._static_ok = True
        self._static_version += 1

    def stream_osts(self, i: int, n_osts: int) -> Dict[int, int]:
        """Scalar-compatible placement map for one client (view surface)."""
        placement: Dict[int, int] = {}
        for s in range(int(self.wl_streams[i])):
            ost = int((self.stripe_offset[i] + s) % n_osts)
            placement[ost] = placement.get(ost, 0) + 1
        return placement

    # -------------------------------------------------------------- planning
    def plan(self, idx: np.ndarray, t: float, dt: float) -> PlanBatch:
        """Vectorized ``IOClient.plan`` over clients at positions ``idx``.

        Every expression mirrors ``client.py`` line-for-line in float
        association; masked lanes compute garbage that is never read.
        Passing ``self.idx_all`` (by identity) skips all per-subset
        gathers — the whole-fleet fast path.
        """
        self.ensure_host()
        self._ensure_static()
        s = self._static
        xp = self.xp
        p = self.p
        idx = np.asarray(idx, dtype=np.int64)
        full = idx is self.idx_all

        def G(a):
            return a if full else a[idx]

        ch_ost = G(s.ch_ost)
        ch_valid = G(s.ch_valid)
        dirty_np = G(self.dirty_bytes)

        # WorkloadSpec.active(t): idle (duty<=0) never; duty>=1 always;
        # else (t % period) < duty * period
        act = G(s.duty_pos) & (G(s.duty_full)
                               | (np.mod(t, G(s.period_g)) < G(s.dxp)))

        is_read = G(s.is_read)
        is_mixed = G(s.is_mixed)
        planned = act | (dirty_np > 0.0)
        has_write = planned & (~is_read | (dirty_np > 0.0))
        drain_only = planned & is_read & (dirty_np > 0.0)
        has_read = planned & act & (is_read | is_mixed)
        # the `active` argument to _plan_write governs the app offer; the
        # drain-only path passes active=False regardless of wl.active(t)
        w_stream_active = act & ~is_read

        # ---- xp conversions (no-ops for numpy) -----------------------------
        A = xp.asarray
        dirty = A(dirty_np)
        Wf = A(G(s.W))
        Ff = A(G(s.F))
        R = A(G(s.R))
        last_drain = A(G(self.last_drain))
        n_ch_f = A(G(s.n_ch_f))
        nic_per_ch = A(G(s.nic_per_ch))
        wait_ch = A(np.take_along_axis(G(self.waits), ch_ost, axis=1))

        # ================= write plan (_plan_write) =========================
        lam_req = xp.where(A(w_stream_active), A(G(s.lam_rate_w)), 0.0)
        lam_bytes_w = lam_req * R

        absorb_frac = A(G(s.inplace)) * xp.minimum(1.0,
                                                   dirty / A(G(s.hot_bytes)))

        # random-access extent fill (the only dynamic p_eff branch)
        lam_pages = xp.maximum(last_drain, lam_bytes_w * 0.25) / PAGE_SIZE
        density = (lam_pages * p.extent_timeout_s) / A(G(s.n_extents))
        p_eff_random = xp.minimum(Wf, xp.maximum(A(G(s.run)), density))
        seq_like = A(drain_only) | A(G(s.is_seq))
        p_eff = xp.where(seq_like, Wf,
                         xp.where(A(G(s.is_strided)), A(G(s.p_eff_strided)),
                                  p_eff_random))
        fill_frac = p_eff / Wf

        # new_dirty_est = max(last_drain, lam_bytes * (1 - absorb) * 0.25)
        new_dirty_est = xp.maximum(last_drain,
                                   (lam_bytes_w * (1.0 - absorb_frac)) * 0.25)
        # shared sub-expression of open_extents and timeout_occ:
        # new_dirty_est * extent_timeout_s * (1.0 - fill_frac)
        parked = (new_dirty_est * p.extent_timeout_s) * (1.0 - fill_frac)
        open_extents = parked / xp.maximum(p_eff * PAGE_SIZE, 1.0)
        frag_commit = ((open_extents * Wf) * _PAGE) * p.frag_overhead
        C = A(G(s.C))
        c_eff = xp.maximum(C - frag_commit, 0.1 * C)
        timeout_occ = xp.minimum(parked, 0.8 * c_eff)
        headroom = xp.maximum((c_eff - dirty) - timeout_occ, 0.0)

        admit_cap = ((last_drain + headroom / dt)
                     / xp.maximum(1.0 - absorb_frac, 1e-3))
        admit_floor = (0.05 * c_eff) / dt
        admitted = xp.minimum(lam_bytes_w, xp.maximum(admit_cap, admit_floor))
        absorbed = admitted * absorb_frac
        new_dirty_rate = admitted - absorbed

        rpc_bytes_w = p_eff * PAGE_SIZE
        form_cost = (1.0 - fill_frac) * A(G(s.form_scan)) + 30e-6
        form_bytes_cap = rpc_bytes_w / form_cost

        total_backlog = dirty / dt + new_dirty_rate
        per_ch_backlog = total_backlog / n_ch_f

        rb_w = rpc_bytes_w[:, None]
        # t_rpc = net_rtt + wait + fixed_cpu + rb/disk_bw + rb/nic_bw
        t_rpc_w = (((p.net_rtt_s + wait_ch) + p.ost_fixed_cpu_s)
                   + rb_w / p.ost_disk_bw) + rb_w / p.nic_bw
        window_cap = (Ff[:, None] * rb_w) / t_rpc_w
        # offer = min(per_ch_backlog, window_cap, nic_cap, form_cap/n_ch)
        offer = xp.minimum(
            xp.minimum(xp.minimum(per_ch_backlog[:, None], window_cap),
                       nic_per_ch[:, None]),
            (form_bytes_cap / n_ch_f)[:, None])
        w_rate = offer / rb_w
        w_window = xp.minimum(Ff[:, None], (offer * t_rpc_w) / rb_w + 0.01)

        # ================= read plan (_plan_read) ===========================
        # --- seq/strided: readahead pipeline --------------------------------
        rb_sl = A(G(s.rb_sl))[:, None]
        t_rpc_sl = (((p.net_rtt_s + wait_ch) + p.ost_fixed_cpu_s)
                    + rb_sl / p.ost_disk_bw) + rb_sl / p.nic_bw
        depth = A(G(s.depth))
        cap_sl = xp.minimum(
            xp.minimum((depth * rb_sl) / t_rpc_sl, nic_per_ch[:, None]),
            A(G(s.lam_r_per_ch))[:, None])
        rate_sl = cap_sl / rb_sl
        win_sl = xp.minimum(depth, (cap_sl * t_rpc_sl) / rb_sl + 0.01)

        # --- random: latency-bound requests ---------------------------------
        rb_rd = A(G(s.rb_rd))[:, None]
        t_rpc_rd = (((p.net_rtt_s + wait_ch) + p.ost_fixed_cpu_s)
                    + rb_rd / p.ost_disk_bw) + rb_rd / p.nic_bw
        # t_req = t_rpc*waves + misfire + syscall + think
        t_req = ((t_rpc_rd * A(G(s.waves))[:, None]
                  + A(G(s.misfire))[:, None])
                 + p.syscall_s) + A(G(s.think))[:, None]
        cap_rd = xp.minimum((A(G(s.s_here)) * R[:, None]) / t_req,
                            nic_per_ch[:, None])
        rate_rd = cap_rd / rb_rd

        is_rand2 = A(G(s.is_rand))[:, None]
        r_rate = xp.where(is_rand2, rate_rd, rate_sl)
        r_window = xp.where(is_rand2, A(G(s.win_rd)), win_sl)

        asnp = np.asarray
        return PlanBatch(
            idx=idx, t=t, dt=dt, active=act,
            has_write=has_write, has_read=has_read,
            ch_ost=ch_ost, ch_valid=ch_valid,
            w_pages=asnp(p_eff), w_rate=asnp(w_rate), w_window=asnp(w_window),
            admitted=asnp(admitted), absorbed=asnp(absorbed),
            new_dirty_rate=asnp(new_dirty_rate), lam_bytes=asnp(lam_bytes_w),
            r_pages=G(s.r_pages), r_rate=asnp(r_rate),
            r_window=asnp(r_window))

    # ------------------------------------------------------------ committing
    def commit(self, pb: PlanBatch, scale_arr: np.ndarray,
               waits_arr: np.ndarray, dt: float) -> None:
        """Vectorized ``IOClient.commit`` for the clients in ``pb``.

        Mirrors the scalar order exactly: waits update first (the commit
        t_rpc uses the *new* waits while the plan used the old), then
        the write commit, then the read commit, then the gauges.
        """
        self.ensure_host()
        self.host_mutated()
        self._ensure_static()
        s = self._static
        xp = self.xp
        p = self.p
        idx = pb.idx
        full = idx is self.idx_all
        ch_ost = pb.ch_ost
        kmax = ch_ost.shape[1]
        scale_arr = np.asarray(scale_arr)
        waits_arr = np.asarray(waits_arr)

        # carry observed queue delays into next interval's planning
        if full:
            self.waits[:, :] = waits_arr[None, :]
        else:
            self.waits[idx, :] = waits_arr[None, :]

        def G(a):
            return a if full else a[idx]

        A = xp.asarray
        scale_ch = A(scale_arr[ch_ost])
        wait_ch = A(waits_arr[ch_ost])
        valid = pb.ch_valid
        valid_x = A(valid)
        hw_np = pb.has_write
        hr_np = pb.has_read
        dirty_np = self.dirty_bytes.copy() if full else self.dirty_bytes[idx]
        dirty = A(dirty_np)
        req_g = A(G(s.req_g))
        cache = A(G(s.C))
        zero = xp.zeros(idx.shape[0])

        def channel_sums(rate_np, pages_1d):
            """Sequential per-client channel sums (scalar demand order):
            masked lanes contribute exact +0.0 terms."""
            rb = pages_1d * PAGE_SIZE
            rb2 = rb[:, None]
            t_rpc = (((p.net_rtt_s + wait_ch) + p.ost_fixed_cpu_s)
                     + rb2 / p.ost_disk_bw) + rb2 / p.nic_bw
            ach = xp.where(valid_x, A(rate_np) * scale_ch, 0.0)
            trm = xp.where(valid_x, t_rpc, 0.0)
            byte_sum = zero
            inflight = zero
            lat_sum = zero
            rpcs = zero
            pages_sum = zero
            for j in range(kmax):
                a = ach[:, j]
                tr = trm[:, j]
                byte_sum = byte_sum + a * rb
                inflight = inflight + a * tr
                lat_sum = lat_sum + (a * dt) * tr
                rpcs = rpcs + a * dt
                pages_sum = pages_sum + (a * dt) * pages_1d
            # channel_time counts live channels: integer, order-free
            # caratlint: disable=CL003 (bool-mask count, not a float fold)
            n_live = (valid & (rate_np > 0.0)).sum(axis=1).astype(np.float64)
            return byte_sum, inflight, lat_sum, rpcs, pages_sum, n_live

        asnp = np.asarray

        def bump(arr: np.ndarray, mask_np, values) -> None:
            contrib = np.where(mask_np, asnp(values), 0.0)
            if full:
                arr += contrib
            else:
                arr[idx] += contrib          # idx positions are unique

        def store(arr: np.ndarray, values) -> None:
            if full:
                arr[:] = values
            else:
                arr[idx] = values

        # ================= write commit (_commit_write) =====================
        w_pages = A(pb.w_pages)
        (drained, inflight_w, lat_w, rpcs_w, _,
         live_w) = channel_sums(pb.w_rate, w_pages)
        drained = xp.minimum(drained, dirty / dt + A(pb.new_dirty_rate))

        admitted = A(pb.admitted)
        absorbed = A(pb.absorbed)
        delta = ((admitted - absorbed) - drained) * dt
        new_dirty = dirty + delta
        over = new_dirty > cache
        overflow = new_dirty - cache
        af2 = absorbed / xp.maximum(admitted, 1e-9)
        shrink = xp.minimum(overflow / xp.maximum(1.0 - af2, 1e-3),
                            admitted * dt)
        adm2 = xp.maximum(admitted - shrink / dt, 0.0)
        abs2 = adm2 * af2
        nd2 = xp.minimum(dirty + ((adm2 - abs2) - drained) * dt, cache)
        blk2 = xp.minimum(dt, overflow / xp.maximum(A(pb.lam_bytes), 1.0))
        admitted = xp.where(over, adm2, admitted)
        absorbed = xp.where(over, abs2, absorbed)
        new_dirty = xp.where(over, nd2, new_dirty)
        blocked = xp.where(over, blk2, 0.0)
        new_dirty = xp.maximum(new_dirty, 0.0)

        store(self.dirty_bytes, np.where(hw_np, asnp(new_dirty), dirty_np))
        store(self.last_drain,
              np.where(hw_np, asnp(drained),
                       self.last_drain if full else self.last_drain[idx]))

        st = self.write
        bump(st.app_bytes, hw_np, admitted * dt)
        bump(st.app_requests, hw_np, (admitted * dt) / req_g)
        bump(st.rpc_count, hw_np, rpcs_w)
        bump(st.rpc_pages, hw_np, (drained * dt) / PAGE_SIZE)
        bump(st.rpc_bytes, hw_np, drained * dt)
        bump(st.lat_sum_s, hw_np, lat_w)
        bump(st.inflight_time, hw_np, inflight_w * dt)
        bump(st.channel_time, hw_np, live_w * dt)
        bump(st.absorbed_bytes, hw_np, absorbed * dt)
        bump(st.blocked_s, hw_np, blocked)
        bump(st.active_s, hw_np & pb.active, dt)
        ip = self.inflight_peak if full else self.inflight_peak[idx]
        store(self.inflight_peak,
              np.where(hw_np, np.maximum(ip, asnp(inflight_w)), ip))

        # ================= read commit (_commit_read) =======================
        r_pages = A(pb.r_pages)
        (delivered, inflight_r, lat_r, rpcs_r, pages_r,
         live_r) = channel_sums(pb.r_rate, r_pages)
        st = self.read
        bump(st.app_bytes, hr_np, delivered * dt)
        bump(st.app_requests, hr_np, (delivered * dt) / req_g)
        bump(st.rpc_count, hr_np, rpcs_r)
        bump(st.rpc_pages, hr_np, pages_r)
        bump(st.rpc_bytes, hr_np, delivered * dt)
        bump(st.lat_sum_s, hr_np, lat_r)
        bump(st.inflight_time, hr_np, inflight_r * dt)
        bump(st.channel_time, hr_np, live_r * dt)
        # has_read requires the active phase, so active_s needs no extra
        # plan.active conjunct (hr_np implies pb.active)
        bump(st.active_s, hr_np, dt)
        ip = self.inflight_peak if full else self.inflight_peak[idx]
        store(self.inflight_peak,
              np.where(hr_np, np.maximum(ip, asnp(inflight_r)), ip))

        # ---- gauges (every committed client, like the scalar epilogue) -----
        dp = self.dirty_peak_bytes if full else self.dirty_peak_bytes[idx]
        db = self.dirty_bytes if full else self.dirty_bytes[idx]
        store(self.dirty_peak_bytes, np.maximum(dp, db))

    # ------------------------------------------------------------- snapshots
    def materialize_stats(self, i: int) -> ClientStats:
        """A plain ``ClientStats`` deep-copy of client ``i``'s counters."""
        self.ensure_host()
        return ClientStats(
            read=self.read.materialize(i),
            write=self.write.materialize(i),
            dirty_bytes=float(self.dirty_bytes[i]),
            dirty_peak_bytes=float(self.dirty_peak_bytes[i]),
            inflight_peak=float(self.inflight_peak[i]),
            rpc_window_pages=int(self.cfg_window[i]),
            rpcs_in_flight=int(self.cfg_inflight[i]),
            dirty_cache_mb=int(self.cfg_cache_mb[i]))


# ---------------------------------------------------------------- views ----
class _SoAOpView:
    """Live read-only view of one client's OpCounters row."""

    __slots__ = ("_core", "_ops", "_i")

    def __init__(self, core: SoACore, ops: OpArrays, i: int):
        self._core = core
        self._ops = ops
        self._i = i


def _op_get(self, _f):
    # counters may live on-device mid-run; pull them back lazily
    self._core.ensure_host()
    return float(getattr(self._ops, _f)[self._i])


for _f in OP_FIELDS:
    setattr(_SoAOpView, _f,
            property(lambda self, _f=_f: _op_get(self, _f)))
del _f


class _SoAStatsView:
    """The ``client.stats`` surface over core arrays.

    ``snapshot()`` materializes a plain :class:`ClientStats`, so
    ``SnapshotBuilder.sample`` and every policy observe path work
    unchanged against either backend.
    """

    __slots__ = ("_core", "_i", "read", "write")

    def __init__(self, core: SoACore, i: int):
        self._core = core
        self._i = i
        self.read = _SoAOpView(core, core.read, i)
        self.write = _SoAOpView(core, core.write, i)

    @property
    def dirty_bytes(self) -> float:
        self._core.ensure_host()
        return float(self._core.dirty_bytes[self._i])

    @property
    def dirty_peak_bytes(self) -> float:
        self._core.ensure_host()
        return float(self._core.dirty_peak_bytes[self._i])

    @property
    def inflight_peak(self) -> float:
        self._core.ensure_host()
        return float(self._core.inflight_peak[self._i])

    @property
    def rpc_window_pages(self) -> int:
        return int(self._core.cfg_window[self._i])

    @property
    def rpcs_in_flight(self) -> int:
        return int(self._core.cfg_inflight[self._i])

    @property
    def dirty_cache_mb(self) -> int:
        return int(self._core.cfg_cache_mb[self._i])

    def op(self, name: str):
        if name == "read":
            return self.read
        if name == "write":
            return self.write
        raise KeyError(name)

    def snapshot(self) -> ClientStats:
        return self._core.materialize_stats(self._i)


class _SoAConfigView:
    """The ``client.config`` surface (ClientConfig-compatible) over arrays."""

    __slots__ = ("_core", "_i")

    def __init__(self, core: SoACore, i: int):
        self._core = core
        self._i = i

    @property
    def rpc_window_pages(self) -> int:
        return int(self._core.cfg_window[self._i])

    @rpc_window_pages.setter
    def rpc_window_pages(self, v: int) -> None:
        self._core.cfg_window[self._i] = int(v)
        self._core._static_ok = False

    @property
    def rpcs_in_flight(self) -> int:
        return int(self._core.cfg_inflight[self._i])

    @rpcs_in_flight.setter
    def rpcs_in_flight(self, v: int) -> None:
        self._core.cfg_inflight[self._i] = int(v)
        self._core._static_ok = False

    @property
    def dirty_cache_mb(self) -> int:
        return int(self._core.cfg_cache_mb[self._i])

    @dirty_cache_mb.setter
    def dirty_cache_mb(self, v: int) -> None:
        self._core.cfg_cache_mb[self._i] = int(v)
        self._core._static_ok = False

    def validate(self) -> None:
        ClientConfig(rpc_window_pages=self.rpc_window_pages,
                     rpcs_in_flight=self.rpcs_in_flight,
                     dirty_cache_mb=self.dirty_cache_mb).validate()


class SoAClientView:
    """Per-client facade with the ``IOClient`` surface over core arrays.

    Policies, controllers, and benchmarks keep addressing clients one at
    a time (``.stats``/``.config``/``set_rpc_config``/...); the heavy
    per-interval math never touches these views.
    """

    __slots__ = ("core", "index", "client_id", "stats", "config")

    def __init__(self, core: SoACore, index: int):
        self.core = core
        self.index = index
        self.client_id = int(core.client_ids[index])
        self.stats = _SoAStatsView(core, index)
        self.config = _SoAConfigView(core, index)

    @property
    def p(self) -> PFSParams:
        return self.core.p

    @property
    def workload(self) -> WorkloadSpec:
        return self.core.specs[self.index]

    def set_workload(self, workload: WorkloadSpec) -> None:
        self.core.set_workload(self.index, workload)

    def set_rpc_config(self, window_pages: int, in_flight: int) -> None:
        self.core.set_rpc_config(self.index, window_pages, in_flight)

    def set_cache_limit(self, dirty_mb: int) -> None:
        self.core.set_cache_limit(self.index, dirty_mb)

    @property
    def stripe_offset(self) -> int:
        return int(self.core.stripe_offset[self.index])

    @property
    def dirty_bytes(self) -> float:
        self.core.ensure_host()
        return float(self.core.dirty_bytes[self.index])

    @property
    def last_drain(self) -> float:
        self.core.ensure_host()
        return float(self.core.last_drain[self.index])

    @property
    def last_wait(self) -> Dict[int, float]:
        self.core.ensure_host()
        row = self.core.waits[self.index]
        return {ost: float(w) for ost, w in enumerate(row)}

    @property
    def cache_bytes(self) -> float:
        return self.config.dirty_cache_mb * 1024.0 * 1024.0

    def stream_osts(self, n_osts: int) -> Dict[int, int]:
        return self.core.stream_osts(self.index, n_osts)

    def __repr__(self) -> str:
        return (f"SoAClientView(client_id={self.client_id}, "
                f"index={self.index})")
