"""The Lustre I/O-client model (one per compute node).

Implements the paper's §II-A mechanics as an interval-fluid model:

* write path: request admission into the dirty-page cache (bounded by
  ``max_dirty_mb``), in-place-update absorption, RPC-extent formation with
  fill / timeout / cache-pressure dispatch, grant fragmentation from open
  partial extents, and writeback draining through a bounded in-flight window
  (``max_rpcs_in_flight``) of RPCs of at most ``max_pages_per_rpc`` pages;
* read path: readahead-pipelined sequential reads vs latency-bound random
  reads, both through the same bounded window.

Each probe interval the client (1) *plans* — computes offered RPC load per
OST channel from carried state (dirty level, last achieved drain, last
observed queue delay), then (2) *commits* — applies the cluster's capacity
scaling and congestion feedback, integrates cache state, and increments the
cumulative counters that CARAT samples.

The model is deliberately causal-with-lag: demand at interval t uses state
observed at t-1, exactly like a real client reacting to grants and RPC
completions. That keeps every interval O(1) and the whole stack deterministic.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.storage.params import PAGE_SIZE, PFSParams
from repro_torch.storage.stats import ClientStats
from repro_torch.storage.workloads import WorkloadSpec
from repro_torch.utils.rng import RngStream


@dataclass
class ClientConfig:
    """The paper's Table I tunable surface."""
    rpc_window_pages: int = 1024     # osc.*.max_pages_per_rpc
    rpcs_in_flight: int = 8          # osc.*.max_rpcs_in_flight
    dirty_cache_mb: int = 2048       # osc.*.max_dirty_mb

    def validate(self) -> None:
        if self.rpc_window_pages < 1 or self.rpcs_in_flight < 1:
            raise ValueError("RPC tunables must be >= 1")
        if self.dirty_cache_mb < 1:
            raise ValueError("dirty_cache_mb must be >= 1")


@dataclass
class ChannelDemand:
    """Offered load on one (client, OST) channel for one op direction."""
    client_id: int
    ost: int
    op: str                 # "read" | "write"
    rpc_rate: float         # offered RPCs/s
    rpc_pages: float        # average pages per RPC
    window: float           # in-flight slots this channel may occupy

    @property
    def byte_rate(self) -> float:
        return self.rpc_rate * self.rpc_pages * PAGE_SIZE


@dataclass
class _OpPlan:
    demands: List[ChannelDemand] = field(default_factory=list)
    terms: Dict[str, float] = field(default_factory=dict)


@dataclass
class Plan:
    t: float
    dt: float
    active: bool
    write: Optional[_OpPlan] = None
    read: Optional[_OpPlan] = None

    def all_demands(self) -> List[ChannelDemand]:
        out: List[ChannelDemand] = []
        for p in (self.write, self.read):
            if p is not None:
                out.extend(p.demands)
        return out


class IOClient:
    """One tunable Lustre I/O client; holds carried state + counters."""

    def __init__(
        self,
        client_id: int,
        params: PFSParams,
        workload: WorkloadSpec,
        config: Optional[ClientConfig] = None,
        rng: Optional[RngStream] = None,
        stripe_offset: int = 0,
    ):
        self.client_id = client_id
        self.p = params
        self.workload = workload
        self.config = config or ClientConfig()
        self.config.validate()
        self.rng = rng or RngStream(0, f"client{client_id}")
        # stream -> OST placement (default striping: one OST per file,
        # files round-robin over OSTs starting at this client's offset)
        self.stripe_offset = stripe_offset
        # ---- carried state -------------------------------------------------
        self.dirty_bytes = 0.0
        self.last_drain = 0.0            # bytes/s achieved last interval
        self.last_wait: Dict[int, float] = {}   # per-OST observed queue delay
        self.stats = ClientStats(
            rpc_window_pages=self.config.rpc_window_pages,
            rpcs_in_flight=self.config.rpcs_in_flight,
            dirty_cache_mb=self.config.dirty_cache_mb,
        )

    # ------------------------------------------------------------------ API --
    def set_workload(self, workload: WorkloadSpec) -> None:
        self.workload = workload

    def set_rpc_config(self, window_pages: int, in_flight: int) -> None:
        """RPC params take effect immediately (paper §II-B)."""
        self.config.rpc_window_pages = int(window_pages)
        self.config.rpcs_in_flight = int(in_flight)
        self.config.validate()
        self.stats.rpc_window_pages = self.config.rpc_window_pages
        self.stats.rpcs_in_flight = self.config.rpcs_in_flight

    def set_cache_limit(self, dirty_mb: int) -> None:
        """Cache param propagates slowly — existing dirty pages are kept."""
        self.config.dirty_cache_mb = int(dirty_mb)
        self.config.validate()
        self.stats.dirty_cache_mb = self.config.dirty_cache_mb

    @property
    def cache_bytes(self) -> float:
        return self.config.dirty_cache_mb * 1024.0 * 1024.0

    def stream_osts(self, n_osts: int) -> Dict[int, int]:
        """Map OST id -> number of this client's streams on it."""
        placement: Dict[int, int] = {}
        for i in range(self.workload.n_streams):
            ost = (self.stripe_offset + i) % n_osts
            placement[ost] = placement.get(ost, 0) + 1
        return placement

    # ------------------------------------------------------------- planning --
    def plan(self, t: float, dt: float, n_osts: int) -> Plan:
        wl = self.workload
        active = wl.active(t)
        plan = Plan(t=t, dt=dt, active=active)
        if not active and self.dirty_bytes <= 0:
            return plan
        placement = self.stream_osts(n_osts)
        if wl.op == "write":
            plan.write = self._plan_write(t, dt, placement, 1.0, active)
        elif wl.op == "read":
            plan.read = self._plan_read(t, dt, placement, 1.0, active)
            if self.dirty_bytes > 0:
                # dirty pages carried from an earlier write phase (replayed
                # workload switch / trace gap): writeback keeps draining
                # them even though the foreground op offers no writes
                plan.write = self._plan_write(t, dt, placement, 0.0, False,
                                              drain_only=True)
        else:  # mixed: split stream capacity by read_frac
            plan.read = self._plan_read(t, dt, placement, wl.read_frac, active)
            plan.write = self._plan_write(t, dt, placement, 1.0 - wl.read_frac,
                                          active)
        return plan

    # The write path ----------------------------------------------------------
    def _plan_write(self, t, dt, placement, share, active,
                    drain_only=False) -> _OpPlan:
        p, wl, cfg = self.p, self.workload, self.config
        W = cfg.rpc_window_pages
        F = cfg.rpcs_in_flight
        C = self.cache_bytes
        R = wl.req_bytes
        req_pages = max(1, math.ceil(R / PAGE_SIZE))
        n_streams = max(wl.n_streams * share, 1e-6)

        # (1) application offer: closed-loop streams issuing as fast as the
        # syscall + page-copy path allows while the burst phase is active.
        per_req_s = p.syscall_s + R / p.mem_bw + wl.think_s
        lam_req = (n_streams / per_req_s) if active else 0.0
        lam_bytes = lam_req * R

        # (2) in-place absorption: a write lands on a still-dirty page with
        # probability ~ dirty coverage of the hot region (Fig 6(d) mechanism).
        hot_bytes = max(R, wl.file_bytes * 0.10)
        absorb_frac = wl.inplace_frac * min(1.0, self.dirty_bytes / hot_bytes)

        # (3) extent formation quality -> average pages per RPC.
        run = min(req_pages, W)   # contiguous pages one request contributes
        if drain_only or wl.access == "seq":
            # drain-only: the parked extents are timeout-matured leftovers
            # of a finished write phase — they dispatch as formed, with no
            # formation cost tied to the current (read) workload's pattern
            p_eff = float(W)
        elif wl.access == "strided":
            # strided (MPI-IO style): block starts repeat every
            # stride_bytes, so a W-page extent deterministically fills to
            # W * (req/stride) pages laid out as runs of req_pages — the
            # dirty contiguity is min(stride run, window), structural
            # rather than arrival-limited like random.
            fill_pages = float(W) * min(R / wl.stride_bytes, 1.0)
            p_eff = min(float(W), max(float(run), fill_pages))
        else:
            # random: expected fill of an extent within one timeout
            # window, from uniform page arrivals over the file's extents.
            lam_pages = max(self.last_drain, lam_bytes * 0.25) / PAGE_SIZE
            n_extents = max(wl.file_bytes / (W * PAGE_SIZE), 1.0)
            density = lam_pages * p.extent_timeout_s / n_extents
            p_eff = min(float(W), max(float(run), density))
        fill_frac = p_eff / W     # 1.0 => extents mature by filling, no wait

        # (4) grant fragmentation from open partial extents (§II-A a): each
        # partially-filled extent pins grant space for the *full* window.
        new_dirty_est = max(self.last_drain, lam_bytes * (1 - absorb_frac) * 0.25)
        open_extents = (new_dirty_est * p.extent_timeout_s * (1.0 - fill_frac)
                        / max(p_eff * PAGE_SIZE, 1.0))
        frag_commit = open_extents * W * PAGE_SIZE * p.frag_overhead
        c_eff = max(C - frag_commit, 0.1 * C)

        # pages parked waiting for extent timeout also occupy the cache
        timeout_occ = min(new_dirty_est * p.extent_timeout_s * (1.0 - fill_frac),
                          0.8 * c_eff)
        headroom = max(c_eff - self.dirty_bytes - timeout_occ, 0.0)

        # (5) admission: drain + absorption + remaining headroom this
        # interval. Under full cache pressure, cache-waiters still trickle
        # pages in as writeback frees them — floor keeps the loop live.
        drain_prev = self.last_drain
        admit_cap = (drain_prev + headroom / dt) / max(1.0 - absorb_frac, 1e-3)
        admit_floor = 0.05 * c_eff / dt
        admitted = min(lam_bytes, max(admit_cap, admit_floor))
        absorbed = admitted * absorb_frac
        new_dirty_rate = admitted - absorbed

        # (6) RPC formation cap: the writeback thread walks each *partial*
        # extent's full window before dispatch (grant bookkeeping), so large
        # windows + underfilled extents throttle formation (§II-A a).
        rpc_bytes = p_eff * PAGE_SIZE
        form_cost = (1.0 - fill_frac) * (W * PAGE_SIZE / p.extent_scan_bw) + 30e-6
        form_bytes_cap = rpc_bytes / form_cost      # bytes/s, client-wide

        # (7) writeback drain demand through the bounded window, per channel.
        demands: List[ChannelDemand] = []
        n_ch = max(len(placement), 1)
        total_backlog_rate = self.dirty_bytes / dt + new_dirty_rate
        per_ch_backlog = total_backlog_rate / n_ch
        for ost, _streams in placement.items():
            wait = self.last_wait.get(ost, 0.0)
            t_rpc = (p.net_rtt_s + wait + p.ost_fixed_cpu_s
                     + rpc_bytes / p.ost_disk_bw + rpc_bytes / p.nic_bw)
            window_cap = F * rpc_bytes / t_rpc          # Little's law
            nic_cap = p.nic_bw / n_ch
            offer = min(per_ch_backlog, window_cap, nic_cap,
                        form_bytes_cap / n_ch)
            window_used = min(float(F), offer * t_rpc / rpc_bytes + 0.01)
            demands.append(ChannelDemand(
                client_id=self.client_id, ost=ost, op="write",
                rpc_rate=offer / rpc_bytes, rpc_pages=p_eff,
                window=window_used,
            ))
        terms = dict(
            admitted=admitted, absorbed=absorbed, new_dirty_rate=new_dirty_rate,
            p_eff=p_eff, fill_frac=fill_frac, frag_commit=frag_commit,
            headroom=headroom, lam_bytes=lam_bytes, rpc_bytes=rpc_bytes,
        )
        return _OpPlan(demands=demands, terms=terms)

    # The read path -------------------------------------------------------------
    def _plan_read(self, t, dt, placement, share, active) -> _OpPlan:
        p, wl, cfg = self.p, self.workload, self.config
        if not active:
            return _OpPlan(demands=[], terms=dict(
                achieved_cap=0.0, p_eff=1.0, rpc_bytes=PAGE_SIZE, t_rpc=1e-3,
                lam_bytes=0.0))
        W = cfg.rpc_window_pages
        F = cfg.rpcs_in_flight
        R = wl.req_bytes
        req_pages = max(1, math.ceil(R / PAGE_SIZE))
        n_streams = max(wl.n_streams * share, 1e-6)

        per_req_s = p.syscall_s + R / p.mem_bw + wl.think_s
        lam_bytes = n_streams / per_req_s * R      # app ceiling

        demands: List[ChannelDemand] = []
        n_ch = max(len(placement), 1)
        terms: Dict[str, float] = {}
        if wl.access in ("seq", "strided"):
            # readahead keeps a byte-sized window of max-size RPCs in flight:
            # outstanding RPCs = RA_bytes / rpc_bytes — smaller RPC windows
            # pipeline deeper (up to max_rpcs_in_flight), which is the
            # mechanism behind the paper's (64, 256) seq-read optimum.
            # Strided reads are stride-detected (llite's stride readahead):
            # they pipeline like seq, but each RPC carries only one
            # contiguous run (min(stride run, window)) and the readahead
            # window spans the gaps, so only the req/stride useful fraction
            # of it pipelines.
            if wl.access == "seq":
                p_eff = float(W)
                ra_frac = 1.0
            else:
                p_eff = float(min(req_pages, W))
                ra_frac = min(R / wl.stride_bytes, 1.0)
            rpc_bytes = p_eff * PAGE_SIZE
            cap_total = 0.0
            for ost, streams_here in placement.items():
                wait = self.last_wait.get(ost, 0.0)
                t_rpc = (p.net_rtt_s + wait + p.ost_fixed_cpu_s
                         + rpc_bytes / p.ost_disk_bw + rpc_bytes / p.nic_bw)
                depth = min(float(F),
                            max(1.0, p.readahead_bytes * ra_frac / rpc_bytes)
                            * streams_here * share)
                cap = min(depth * rpc_bytes / t_rpc, p.nic_bw / n_ch,
                          lam_bytes / n_ch)
                cap_total += cap
                demands.append(ChannelDemand(
                    client_id=self.client_id, ost=ost, op="read",
                    rpc_rate=cap / rpc_bytes, rpc_pages=p_eff,
                    window=min(depth, cap * t_rpc / rpc_bytes + 0.01),
                ))
            terms = dict(achieved_cap=cap_total, p_eff=p_eff,
                         rpc_bytes=rpc_bytes, t_rpc=t_rpc, lam_bytes=lam_bytes)
        else:
            # random reads: one request => ceil(req_pages/W) RPCs of
            # min(req_pages, W) pages, issued in parallel up to the window;
            # no readahead pipeline, so each stream is latency-bound on its
            # own request. A large RPC window also risks readahead misfires
            # that drag a full-window transfer in front of the demand read —
            # why the paper says small random I/O prefers smaller windows.
            p_eff = float(min(req_pages, W))
            rpc_bytes = p_eff * PAGE_SIZE
            rpcs_per_req = math.ceil(req_pages / W)
            misfire_s = p.ra_misfire_frac * (W * PAGE_SIZE / p.ost_disk_bw)
            cap_total = 0.0
            for ost, streams_here in placement.items():
                wait = self.last_wait.get(ost, 0.0)
                t_rpc = (p.net_rtt_s + wait + p.ost_fixed_cpu_s
                         + rpc_bytes / p.ost_disk_bw + rpc_bytes / p.nic_bw)
                s_here = streams_here * share
                waves = math.ceil(rpcs_per_req / max(min(F, rpcs_per_req), 1))
                t_req = t_rpc * waves + misfire_s + p.syscall_s + wl.think_s
                cap = min(s_here * R / t_req, p.nic_bw / n_ch)
                cap_total += cap
                demands.append(ChannelDemand(
                    client_id=self.client_id, ost=ost, op="read",
                    rpc_rate=cap / rpc_bytes, rpc_pages=p_eff,
                    window=min(float(F), float(rpcs_per_req) * s_here),
                ))
            terms = dict(achieved_cap=cap_total, p_eff=p_eff,
                         rpc_bytes=rpc_bytes, t_rpc=t_rpc, lam_bytes=lam_bytes)
        return _OpPlan(demands=demands, terms=terms)

    # ------------------------------------------------------------- committing --
    def commit(
        self,
        plan: Plan,
        scale: Dict[int, float],
        waits: Dict[int, float],
        dt: float,
    ) -> None:
        """Apply cluster feedback, integrate cache state, bump counters."""
        st = self.stats
        # carry observed queue delays into next interval's planning
        for ost, w in waits.items():
            self.last_wait[ost] = w

        if plan.write is not None:
            self._commit_write(plan, plan.write, scale, dt)
        if plan.read is not None:
            self._commit_read(plan, plan.read, scale, dt)

        st.dirty_bytes = self.dirty_bytes
        st.dirty_peak_bytes = max(st.dirty_peak_bytes, self.dirty_bytes)

    def _commit_write(self, plan: Plan, op: _OpPlan, scale, dt) -> None:
        p = self.p
        st = self.stats.write
        terms = op.terms
        drained = 0.0
        inflight = 0.0
        lat_sum = 0.0
        rpcs = 0.0
        for d in op.demands:
            s = scale.get(d.ost, 1.0)
            achieved = d.rpc_rate * s
            wait = self.last_wait.get(d.ost, 0.0)
            rpc_b = d.rpc_pages * PAGE_SIZE
            t_rpc = (p.net_rtt_s + wait + p.ost_fixed_cpu_s
                     + rpc_b / p.ost_disk_bw + rpc_b / p.nic_bw)
            drained += achieved * rpc_b
            inflight += achieved * t_rpc
            lat_sum += achieved * dt * t_rpc
            rpcs += achieved * dt
        drained = min(drained, self.dirty_bytes / dt + terms["new_dirty_rate"])

        admitted = terms["admitted"]
        absorbed = terms["absorbed"]
        # If drain fell short of the plan (server squeeze), re-limit
        # admission so cache can never go negative or exceed its limit.
        delta = (admitted - absorbed - drained) * dt
        new_dirty = self.dirty_bytes + delta
        cap = self.cache_bytes
        blocked_s = 0.0
        if new_dirty > cap:
            # cache-limit throttling (§II-A c): writers block; shrink the
            # admitted bytes just enough that dirty lands exactly at the cap.
            overflow_bytes = new_dirty - cap
            absorb_frac = absorbed / max(admitted, 1e-9)
            shrink_bytes = min(overflow_bytes / max(1.0 - absorb_frac, 1e-3),
                               admitted * dt)
            admitted = max(admitted - shrink_bytes / dt, 0.0)
            absorbed = admitted * absorb_frac
            new_dirty = min(self.dirty_bytes
                            + (admitted - absorbed - drained) * dt, cap)
            blocked_s = min(dt, overflow_bytes / max(terms["lam_bytes"], 1.0))
        self.dirty_bytes = max(new_dirty, 0.0)
        self.last_drain = drained

        st.app_bytes += admitted * dt
        st.app_requests += admitted * dt / max(self.workload.req_bytes, 1)
        st.rpc_count += rpcs
        st.rpc_pages += drained * dt / PAGE_SIZE
        st.rpc_bytes += drained * dt
        st.lat_sum_s += lat_sum
        st.inflight_time += inflight * dt
        st.channel_time += sum(1 for d in op.demands if d.rpc_rate > 0) * dt
        st.absorbed_bytes += absorbed * dt
        st.blocked_s += blocked_s
        if plan.active:
            st.active_s += dt
        self.stats.inflight_peak = max(self.stats.inflight_peak, inflight)

    def _commit_read(self, plan: Plan, op: _OpPlan, scale, dt) -> None:
        p = self.p
        st = self.stats.read
        delivered = 0.0
        inflight = 0.0
        lat_sum = 0.0
        rpcs = 0.0
        pages = 0.0
        for d in op.demands:
            s = scale.get(d.ost, 1.0)
            achieved = d.rpc_rate * s
            wait = self.last_wait.get(d.ost, 0.0)
            rpc_b = d.rpc_pages * PAGE_SIZE
            t_rpc = (p.net_rtt_s + wait + p.ost_fixed_cpu_s
                     + rpc_b / p.ost_disk_bw + rpc_b / p.nic_bw)
            delivered += achieved * rpc_b
            inflight += achieved * t_rpc
            lat_sum += achieved * dt * t_rpc
            rpcs += achieved * dt
            pages += achieved * dt * d.rpc_pages
        st.app_bytes += delivered * dt
        st.app_requests += delivered * dt / max(self.workload.req_bytes, 1)
        st.rpc_count += rpcs
        st.rpc_pages += pages
        st.rpc_bytes += delivered * dt
        st.lat_sum_s += lat_sum
        st.inflight_time += inflight * dt
        st.channel_time += sum(1 for d in op.demands if d.rpc_rate > 0) * dt
        if plan.active:
            st.active_s += dt
        self.stats.inflight_peak = max(self.stats.inflight_peak, inflight)
