"""Device-resident fleet stepping for the ``soa-torch`` backend.

:class:`DeviceFleet` keeps every per-client state and counter array and
the per-OST cluster state as float64 torch tensors on the device across
intervals, and advances the whole fleet one interval per Python call:
duty activity, plan terms, the per-OST demand reduction, the resolve and
the commit, with no transfer of fleet state to the host. It is the torch
rewrite of the reference's ``repro/storage/device.py::DeviceFleet``,
whose fused jit has no counterpart here: PyTorch runs eagerly.

* The per-OST resolve runs on sufficient statistics of the per-channel
  demand lanes (``Σwindow, Σrate, Σrate·pages, Σpages, count``), reduced
  over OST ids by one dense float64 one-hot product. A CUDA
  ``index_add_`` in float64 would use atomics, whose order — and so
  whose result — changes from run to run; the product has a fixed order.
  This *reassociates* float sums against the host ``soa`` backend's
  sequential fold, which is the tolerance contract: ``rtol=1e-9``
  against host ``soa`` (as the reference's ``soa-jax`` is held).
* The OST service noise comes from the cluster's NumPy RNG stream, so
  host and device stay on the *same* RNG trajectory (one lognormal per
  active OST in ascending id order). Each step therefore counts each
  OST's demand lanes on the device first, pulls the (n_osts,) activity
  mask, and the host draws the interval's noise from it and uploads
  ``(n_osts,)`` values: the one small synchronisation per interval.
* The plan-term statics ride as device tensors, re-uploaded only when a
  workload or config setter dirtied them; the one-hot OST matrix is
  rebuilt only when the channel layout changes.
* The fleet's rows may split into blocks on several devices (the sync
  sharded runtime's :class:`ShardedDeviceFleet`, one block per device):
  each block's plan emits the (5, n_osts) demand partials, the partials
  merge by addition **on the primary device**, in block order, before
  the one globally-coupled resolve, and the (scale, waits) feedback
  commits block-locally. Across blocks the merge reassociates, so it is
  held to the one-block fleet at ``rtol=1e-9``, never to ``==``.

Ownership: whichever fleet last stepped owns the truth. Host-side reads
go through :meth:`SoACore.ensure_host` (lazy pull); host-side state
writes mark the device copy stale and the next device step re-uploads.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.storage.params import PAGE_SIZE, PFSParams
from repro_torch.storage.pfs import PFSCluster
from repro_torch.storage.soa import OP_FIELDS, SoACore

_PAGE = float(PAGE_SIZE)
_F64 = torch.float64

# _Static fields shipped to the device (everything plan/commit reads)
STATIC_FIELDS = (
    "ch_ost", "ch_valid", "W", "F", "C", "R", "req_g", "inplace", "think",
    "is_read", "is_mixed", "is_seq", "is_strided", "is_rand",
    "duty_pos", "duty_full", "period_g", "dxp",
    "lam_rate_w", "hot_bytes", "run", "p_eff_strided", "n_extents",
    "form_scan", "rb_sl", "depth", "lam_r_per_ch", "rb_rd", "misfire",
    "waves", "s_here", "win_rd", "r_pages", "n_ch_f", "nic_per_ch",
)

OST_STATE_FIELDS = ("ost_wait", "ost_util", "ost_inflight",
                    "ost_served_bytes", "ost_served_rpcs")

# the (n,) per-client state arrays, in the order they are packed for one
# host<->device copy
_CLIENT_ROWS = (("dirty",), ("last_drain",),
                *(("read", f) for f in OP_FIELDS),
                *(("write", f) for f in OP_FIELDS),
                ("dirty_peak",), ("inflight_peak",))


def _onehot_T(n_osts: int, ch_ost: np.ndarray) -> np.ndarray:
    """(n_osts, n*kmax) f64 one-hot of the raveled channel->OST map."""
    ids = np.asarray(ch_ost).ravel()
    return (np.arange(n_osts)[:, None] == ids[None, :]).astype(np.float64)


def _minimum(a, b):
    """Elementwise min where either side may be a Python float."""
    if not isinstance(a, torch.Tensor):
        return torch.clamp(b, max=a)
    if not isinstance(b, torch.Tensor):
        return torch.clamp(a, max=b)
    return torch.minimum(a, b)


def _maximum(a, b):
    """Elementwise max where either side may be a Python float."""
    if not isinstance(a, torch.Tensor):
        return torch.clamp(b, min=a)
    if not isinstance(b, torch.Tensor):
        return torch.clamp(a, min=b)
    return torch.maximum(a, b)


# ---------------------------------------------------------------------------
# building blocks (functions of tensor dicts)
# ---------------------------------------------------------------------------
def _duty_act(s: Dict, t: float) -> torch.Tensor:
    """(n,) bool duty-cycle activity at time ``t`` (``WorkloadSpec.active``:
    floor-mod, as NumPy's ``np.mod``)."""
    period = s["period_g"]
    phase = torch.remainder(period.new_full((), t), period)
    return s["duty_pos"] & (s["duty_full"] | (phase < s["dxp"]))


def _plan_terms(p: PFSParams, s: Dict, dirty, last_drain, ost_wait, act,
                dt: float) -> Dict:
    """The twin of ``SoACore.plan`` (same expressions, on tensors).

    ``ost_wait`` is the (n_osts,) smoothed queue delay — under full-fleet
    stepping every client's waits row equals it, so the per-client
    ``waits`` matrix collapses to one vector on the device.
    """
    is_read = s["is_read"]
    planned = act | (dirty > 0.0)
    has_write = planned & (~is_read | (dirty > 0.0))
    drain_only = planned & is_read & (dirty > 0.0)
    has_read = planned & act & (is_read | s["is_mixed"])
    w_stream_active = act & ~is_read

    Wf, Ff, R = s["W"], s["F"], s["R"]
    n_ch_f, nic_per_ch = s["n_ch_f"], s["nic_per_ch"]
    wait_ch = ost_wait[s["ch_ost"]]                      # (n, kmax)

    # ---- write plan ----
    lam_req = torch.where(w_stream_active, s["lam_rate_w"], 0.0)
    lam_bytes_w = lam_req * R
    absorb_frac = s["inplace"] * _minimum(1.0, dirty / s["hot_bytes"])
    lam_pages = _maximum(last_drain, lam_bytes_w * 0.25) / PAGE_SIZE
    density = (lam_pages * p.extent_timeout_s) / s["n_extents"]
    p_eff_random = _minimum(Wf, _maximum(s["run"], density))
    seq_like = drain_only | s["is_seq"]
    p_eff = torch.where(seq_like, Wf,
                        torch.where(s["is_strided"], s["p_eff_strided"],
                                    p_eff_random))
    fill_frac = p_eff / Wf
    new_dirty_est = _maximum(last_drain,
                             (lam_bytes_w * (1.0 - absorb_frac)) * 0.25)
    parked = (new_dirty_est * p.extent_timeout_s) * (1.0 - fill_frac)
    open_extents = parked / _maximum(p_eff * PAGE_SIZE, 1.0)
    frag_commit = ((open_extents * Wf) * _PAGE) * p.frag_overhead
    C = s["C"]
    c_eff = _maximum(C - frag_commit, 0.1 * C)
    timeout_occ = _minimum(parked, 0.8 * c_eff)
    headroom = _maximum((c_eff - dirty) - timeout_occ, 0.0)
    admit_cap = ((last_drain + headroom / dt)
                 / _maximum(1.0 - absorb_frac, 1e-3))
    admit_floor = (0.05 * c_eff) / dt
    admitted = _minimum(lam_bytes_w, _maximum(admit_cap, admit_floor))
    absorbed = admitted * absorb_frac
    new_dirty_rate = admitted - absorbed
    rpc_bytes_w = p_eff * PAGE_SIZE
    form_cost = (1.0 - fill_frac) * s["form_scan"] + 30e-6
    form_bytes_cap = rpc_bytes_w / form_cost
    per_ch_backlog = (dirty / dt + new_dirty_rate) / n_ch_f
    rb_w = rpc_bytes_w[:, None]
    t_rpc_w = (((p.net_rtt_s + wait_ch) + p.ost_fixed_cpu_s)
               + rb_w / p.ost_disk_bw) + rb_w / p.nic_bw
    window_cap = (Ff[:, None] * rb_w) / t_rpc_w
    offer = _minimum(
        _minimum(_minimum(per_ch_backlog[:, None], window_cap),
                 nic_per_ch[:, None]),
        (form_bytes_cap / n_ch_f)[:, None])
    w_rate = offer / rb_w
    w_window = _minimum(Ff[:, None], (offer * t_rpc_w) / rb_w + 0.01)

    # ---- read plan ----
    rb_sl = s["rb_sl"][:, None]
    t_rpc_sl = (((p.net_rtt_s + wait_ch) + p.ost_fixed_cpu_s)
                + rb_sl / p.ost_disk_bw) + rb_sl / p.nic_bw
    depth = s["depth"]
    cap_sl = _minimum(
        _minimum((depth * rb_sl) / t_rpc_sl, nic_per_ch[:, None]),
        s["lam_r_per_ch"][:, None])
    rate_sl = cap_sl / rb_sl
    win_sl = _minimum(depth, (cap_sl * t_rpc_sl) / rb_sl + 0.01)
    rb_rd = s["rb_rd"][:, None]
    t_rpc_rd = (((p.net_rtt_s + wait_ch) + p.ost_fixed_cpu_s)
                + rb_rd / p.ost_disk_bw) + rb_rd / p.nic_bw
    t_req = ((t_rpc_rd * s["waves"][:, None] + s["misfire"][:, None])
             + p.syscall_s) + s["think"][:, None]
    cap_rd = _minimum((s["s_here"] * R[:, None]) / t_req,
                      nic_per_ch[:, None])
    rate_rd = cap_rd / rb_rd
    is_rand2 = s["is_rand"][:, None]
    return {
        "act": act, "has_write": has_write, "has_read": has_read,
        "p_eff": p_eff, "w_rate": w_rate, "w_window": w_window,
        "admitted": admitted, "absorbed": absorbed,
        "new_dirty_rate": new_dirty_rate, "lam_bytes_w": lam_bytes_w,
        "r_rate": torch.where(is_rand2, rate_rd, rate_sl),
        "r_window": torch.where(is_rand2, s["win_rd"], win_sl),
    }


def _segment_reduce(onehot_T: torch.Tensor,
                    lanes: torch.Tensor) -> torch.Tensor:
    """Per-OST sums of k lane vectors: (k, L) lanes -> (k, n_osts), one
    float64 product against the (n_osts, L) one-hot matrix."""
    return torch.matmul(lanes, onehot_T.T)


def _demand_partials(s: Dict, terms: Dict) -> torch.Tensor:
    """(5, n_osts) per-OST sufficient statistics of the offered demands:
    [Σwindow, Σrate, Σrate·pages, Σpages, count]."""
    ch_valid = s["ch_valid"]
    wv = terms["has_write"][:, None] & ch_valid
    rv = terms["has_read"][:, None] & ch_valid
    wp = terms["p_eff"][:, None]
    rp = s["r_pages"][:, None]

    def lanes(w_x, r_x):
        # write and read lanes land on the same ids and sum linearly, so
        # they merge elementwise *before* the per-OST reduction
        return (torch.where(wv, w_x, 0.0) + torch.where(rv, r_x, 0.0)).ravel()

    count = (wv.to(_F64) + rv.to(_F64)).ravel()
    return _segment_reduce(s["onehot_T"], torch.stack([
        lanes(terms["w_window"], terms["r_window"]),
        lanes(terms["w_rate"], terms["r_rate"]),
        lanes(terms["w_rate"] * wp, terms["r_rate"] * rp),
        lanes(wp, rp),
        count,
    ]))


def _resolve(p: PFSParams, ost: Dict, partials: torch.Tensor, noise,
             dt: float):
    """The twin of ``PFSCluster.resolve_batch`` over the per-OST
    sufficient statistics (algebraically equal to the per-demand fold;
    reassociated — the device tolerance contract)."""
    sum_win, sum_rate, sum_rp, sum_pages, cnt = partials
    nonempty = cnt > 0.0
    over = torch.clamp(sum_win / p.ost_overload_knee - 1.0, min=0.0)
    fixed_eff = p.ost_fixed_cpu_s * (1.0 + p.ost_overload_gamma * over)
    qd = torch.clamp(sum_win, min=1.0)
    disk_bw = (p.ost_disk_bw * qd / (qd + p.ssd_qd_half)) / noise
    byte_rate = sum_rp * _PAGE
    util = fixed_eff * sum_rate + (_PAGE / disk_bw) * sum_rp
    util = torch.maximum(util, byte_rate / p.ost_ingress_bw)
    # empty lanes divide by 1.0, not 0 — keeps infs/NaNs out
    safe_util = torch.where(nonempty, util, 1.0)
    scale = torch.where(util <= 0.95, 1.0, 0.95 / safe_util)
    rho = torch.clamp(util * scale, max=0.95)
    svc_avg = fixed_eff + (_PAGE / disk_bw) * (sum_pages
                                               / torch.clamp(cnt, min=1.0))
    wait_now = torch.clamp(svc_avg * rho / torch.clamp(1.0 - rho, min=0.05),
                           max=p.queue_wait_cap_s)
    wait_now = torch.where(util > 1.0, p.queue_wait_cap_s, wait_now)
    a = p.queue_smoothing
    new_wait = torch.where(nonempty,
                           a * ost["ost_wait"] + (1 - a) * wait_now,
                           ost["ost_wait"] * 0.25)
    scale_out = torch.where(nonempty, scale, 1.0)
    ost_out = {
        "ost_wait": new_wait,
        "ost_util": torch.where(nonempty, util, 0.0),
        "ost_inflight": torch.where(nonempty, sum_win, 0.0),
        "ost_served_bytes": (ost["ost_served_bytes"]
                             + (byte_rate * scale_out) * dt),
        "ost_served_rpcs": (ost["ost_served_rpcs"]
                            + (sum_rate * scale_out) * dt),
    }
    return ost_out, scale_out, new_wait


def _commit(p: PFSParams, s: Dict, state: Dict, terms: Dict,
            scale_out, new_wait, dt: float) -> Dict:
    """The twin of ``SoACore.commit`` for the client-side state. Channel
    sums reduce with ``.sum(dim=1)`` (reassociated — device tolerance
    path; the host backend keeps its sequential column loop). Returns the
    new client state dict."""
    ch_ost, ch_valid = s["ch_ost"], s["ch_valid"]
    dirty = state["dirty"]
    scale_ch = scale_out[ch_ost]
    wait_ch = new_wait[ch_ost]

    def channel_sums(rate, pages_1d):
        rb = pages_1d * PAGE_SIZE
        rb2 = rb[:, None]
        t_rpc = (((p.net_rtt_s + wait_ch) + p.ost_fixed_cpu_s)
                 + rb2 / p.ost_disk_bw) + rb2 / p.nic_bw
        ach = torch.where(ch_valid, rate * scale_ch, 0.0)
        trm = torch.where(ch_valid, t_rpc, 0.0)
        byte_sum = (ach * rb2).sum(dim=1)
        inflight = (ach * trm).sum(dim=1)
        lat_sum = ((ach * dt) * trm).sum(dim=1)
        rpcs = (ach * dt).sum(dim=1)
        pages_sum = ((ach * dt) * rb2 / PAGE_SIZE).sum(dim=1)
        n_live = (ch_valid & (rate > 0.0)).sum(dim=1).to(_F64)
        return byte_sum, inflight, lat_sum, rpcs, pages_sum, n_live

    def bump(cur, mask, val):
        return cur + torch.where(mask, val, 0.0)

    hw, hr, act = terms["has_write"], terms["has_read"], terms["act"]

    # ---- write commit ----
    (drained, inflight_w, lat_w, rpcs_w, _,
     live_w) = channel_sums(terms["w_rate"], terms["p_eff"])
    drained = torch.minimum(drained, dirty / dt + terms["new_dirty_rate"])
    admitted, absorbed = terms["admitted"], terms["absorbed"]
    C = s["C"]
    new_dirty = dirty + ((admitted - absorbed) - drained) * dt
    over = new_dirty > C
    overflow = new_dirty - C
    af2 = absorbed / torch.clamp(admitted, min=1e-9)
    shrink = torch.minimum(overflow / torch.clamp(1.0 - af2, min=1e-3),
                           admitted * dt)
    adm2 = torch.clamp(admitted - shrink / dt, min=0.0)
    abs2 = adm2 * af2
    nd2 = torch.minimum(dirty + ((adm2 - abs2) - drained) * dt, C)
    blk2 = torch.clamp(overflow / torch.clamp(terms["lam_bytes_w"], min=1.0),
                       max=dt)
    admitted = torch.where(over, adm2, admitted)
    absorbed = torch.where(over, abs2, absorbed)
    new_dirty = torch.clamp(torch.where(over, nd2, new_dirty), min=0.0)
    blocked = torch.where(over, blk2, 0.0)

    dirty_out = torch.where(hw, new_dirty, dirty)
    wr = state["write"]
    write_out = {
        "app_bytes": bump(wr["app_bytes"], hw, admitted * dt),
        "app_requests": bump(wr["app_requests"], hw,
                             (admitted * dt) / s["req_g"]),
        "rpc_count": bump(wr["rpc_count"], hw, rpcs_w),
        "rpc_pages": bump(wr["rpc_pages"], hw, (drained * dt) / PAGE_SIZE),
        "rpc_bytes": bump(wr["rpc_bytes"], hw, drained * dt),
        "lat_sum_s": bump(wr["lat_sum_s"], hw, lat_w),
        "inflight_time": bump(wr["inflight_time"], hw, inflight_w * dt),
        "channel_time": bump(wr["channel_time"], hw, live_w * dt),
        "absorbed_bytes": bump(wr["absorbed_bytes"], hw, absorbed * dt),
        "blocked_s": bump(wr["blocked_s"], hw, blocked),
        "active_s": bump(wr["active_s"], hw & act, dt),
    }
    ip = state["inflight_peak"]
    ip = torch.where(hw, torch.maximum(ip, inflight_w), ip)

    # ---- read commit ----
    (delivered, inflight_r, lat_r, rpcs_r, pages_r,
     live_r) = channel_sums(terms["r_rate"], s["r_pages"])
    rd = state["read"]
    read_out = {
        "app_bytes": bump(rd["app_bytes"], hr, delivered * dt),
        "app_requests": bump(rd["app_requests"], hr,
                             (delivered * dt) / s["req_g"]),
        "rpc_count": bump(rd["rpc_count"], hr, rpcs_r),
        "rpc_pages": bump(rd["rpc_pages"], hr, pages_r),
        "rpc_bytes": bump(rd["rpc_bytes"], hr, delivered * dt),
        "lat_sum_s": bump(rd["lat_sum_s"], hr, lat_r),
        "inflight_time": bump(rd["inflight_time"], hr, inflight_r * dt),
        "channel_time": bump(rd["channel_time"], hr, live_r * dt),
        "absorbed_bytes": rd["absorbed_bytes"],
        "blocked_s": rd["blocked_s"],
        "active_s": bump(rd["active_s"], hr, dt),
    }
    ip = torch.where(hr, torch.maximum(ip, inflight_r), ip)

    return {
        "dirty": dirty_out,
        "last_drain": torch.where(hw, drained, state["last_drain"]),
        "read": read_out,
        "write": write_out,
        "dirty_peak": torch.maximum(state["dirty_peak"], dirty_out),
        "inflight_peak": ip,
    }


def _activity_lanes(s: Dict, dirty, act) -> torch.Tensor:
    """(n,) bool: which clients offer demands given ``dirty`` state and
    the duty activity ``act`` for the interval — the exact condition
    under which ``PlanBatch.demand_batch`` emits a lane (and therefore
    under which the host resolver draws OST noise)."""
    planned = act | (dirty > 0.0)
    has_write = planned & (~s["is_read"] | (dirty > 0.0))
    has_read = planned & act & (s["is_read"] | s["is_mixed"])
    return has_write | has_read


def _activity_counts(s: Dict, dirty, act) -> torch.Tensor:
    """(n_osts,) f64 count of the demand lanes each OST receives."""
    lanes = (_activity_lanes(s, dirty, act)[:, None] & s["ch_valid"]).ravel()
    return _segment_reduce(s["onehot_T"], lanes.to(_F64)[None, :])[0]


def _indexed(device) -> torch.device:
    """``device`` with its index: ``torch.device("cuda")`` names whichever
    card is current and compares unequal to ``torch.device("cuda", 0)``,
    so device identity is only decided on indexed devices."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _host_rows(core: SoACore,
               cluster: PFSCluster) -> Tuple[List[np.ndarray],
                                             List[np.ndarray]]:
    """The host arrays of ``_CLIENT_ROWS`` then ``OST_STATE_FIELDS``
    (fetched anew: the cluster's resolve rebinds its arrays)."""
    named = {"dirty": core.dirty_bytes, "last_drain": core.last_drain,
             "dirty_peak": core.dirty_peak_bytes,
             "inflight_peak": core.inflight_peak}
    rows = [named[k[0]] if len(k) == 1
            else getattr(getattr(core, k[0]), k[1])
            for k in _CLIENT_ROWS]
    return rows, [cluster.wait_s, cluster.utilization, cluster.inflight,
                  cluster.served_bytes, cluster.served_rpcs]


def _client_state(packed: torch.Tensor) -> Dict:
    """Unpack the stacked ``_CLIENT_ROWS`` into the client state dict."""
    state: Dict = {"read": {}, "write": {}}
    for k, row in zip(_CLIENT_ROWS, packed):
        if len(k) == 1:
            state[k[0]] = row
        else:
            state[k[0]][k[1]] = row
    return state


def _pack_client_state(state: Dict) -> np.ndarray:
    """The client state dict as one host array, rows in ``_CLIENT_ROWS``
    order (one device-to-host copy)."""
    return torch.stack([state[k[0]] if len(k) == 1 else state[k[0]][k[1]]
                        for k in _CLIENT_ROWS]).cpu().numpy()


def _take_ownership(fleet) -> None:
    """Make ``fleet`` its core's device owner, syncing any previous
    owner's state through the host arrays first."""
    core = fleet.core
    old = core._device
    if old is fleet:
        return
    if old is not None:
        if old.host_stale:
            old.sync_host()
        old.device_stale = True
    core._device = fleet
    fleet.device_stale = True


# ---------------------------------------------------------------------------
# the device fleet
# ---------------------------------------------------------------------------
class DeviceFleet:
    """Device-resident fleet stepping for ``Simulation(backend="soa-torch")``
    and the sync sharded runtime.

    The core's client rows split into *blocks*: block ``b`` holds the
    ascending rows ``blocks[b]`` on ``devices[b]``; by default one block
    holds the whole fleet on ``device``. Each block's plan emits the
    (5, n_osts) demand partials and its per-OST demand-lane counts; both
    merge by addition on ``device`` (the primary) in block order, the one
    resolve runs there against the per-OST state, and the broadcast
    (scale, waits) feedback commits block-locally. One :meth:`step` call
    advances the whole fleet an interval; the only per-step host traffic
    is the OST activity mask out and the noise drawn from it in
    (``n_osts`` values each way).

    With one block nothing merges. With more, the merge reassociates the
    sums across blocks, held to the one-block fleet at ``rtol=1e-9``.
    """

    def __init__(self, core: SoACore, cluster: PFSCluster, device,
                 blocks: Optional[Sequence[np.ndarray]] = None,
                 devices: Optional[Sequence] = None):
        self.core = core
        self.cluster = cluster
        self.device = _indexed(device)
        self.blocks = ([np.arange(core.n)] if blocks is None
                       else [np.asarray(b, dtype=np.int64) for b in blocks])
        self.devices = ([self.device] * len(self.blocks) if devices is None
                        else [_indexed(d) for d in devices])
        if len(self.devices) != len(self.blocks):
            raise ValueError(f"{len(self.blocks)} blocks but "
                             f"{len(self.devices)} devices")
        # a block of every row indexes by slice: views, not copies
        self._index = [slice(None) if len(b) == core.n else b
                       for b in self.blocks]
        self.host_stale = False      # host arrays lag the device state
        self.device_stale = True     # device copy lags the host arrays
        self._states: List[Dict] = []
        self._ost_state: Optional[Dict] = None
        self._statics: List[Dict] = []
        self._static_seen = -1
        self._layout_seen = None
        self._onehots: List[torch.Tensor] = []

    def _on(self, x: torch.Tensor, dev: torch.device) -> torch.Tensor:
        return x if dev == self.device else x.to(dev)

    # ------------------------------------------------------- host <-> device
    def _push(self) -> None:
        """Upload host state to the devices (host stays valid until the
        next step marks it stale)."""
        rows, ost = _host_rows(self.core, self.cluster)
        packed = np.stack(rows)
        self._states = [_client_state(torch.as_tensor(packed[:, ix],
                                                      device=dev))
                        for ix, dev in zip(self._index, self.devices)]
        self._ost_state = dict(zip(
            OST_STATE_FIELDS,
            torch.as_tensor(np.stack(ost), device=self.device)))
        self.device_stale = False

    def _refresh_statics(self) -> None:
        core = self.core
        core._ensure_static()
        if self._static_seen == core._static_version:
            return
        st = core._static
        if self._layout_seen is not core._layout:
            # the channel->OST map changes only with the layout, not with
            # the config/workload values every actuation re-uploads
            ch_ost = np.asarray(st.ch_ost)
            self._onehots = [
                torch.as_tensor(_onehot_T(core.p.n_osts, ch_ost[ix]),
                                device=dev)
                for ix, dev in zip(self._index, self.devices)]
            self._layout_seen = core._layout
        self._statics = []
        for ix, dev, onehot in zip(self._index, self.devices,
                                   self._onehots):
            d = {f: torch.as_tensor(np.asarray(getattr(st, f))[ix],
                                    device=dev)
                 for f in STATIC_FIELDS}
            d["onehot_T"] = onehot
            self._statics.append(d)
        self._static_seen = core._static_version

    def sync_host(self) -> None:
        """Pull every block's state and the OST state back into the
        core/cluster host arrays. The device copies stay authoritative
        (reads don't invalidate)."""
        host_rows, host_ost = _host_rows(self.core, self.cluster)
        for ix, state in zip(self._index, self._states):
            for dst, row in zip(host_rows, _pack_client_state(state)):
                dst[ix] = row
        ost = torch.stack([self._ost_state[f]
                           for f in OST_STATE_FIELDS]).cpu().numpy()
        for dst, row in zip(host_ost, ost):
            dst[:] = row
        # full-fleet contract: every client's waits row is the OST vector
        self.core.waits[:, :] = ost[0][None, :]
        self.host_stale = False

    def host_totals(self, totals: Sequence[torch.Tensor]) -> np.ndarray:
        """:meth:`step`'s per-block totals as one (n,) host array."""
        out = np.empty(self.core.n)
        for ix, tot in zip(self._index, totals):
            out[ix] = tot.cpu().numpy()
        return out

    # ----------------------------------------------------------------- step
    def step(self, t: float, dt: float) -> List[torch.Tensor]:
        """Advance the fleet one interval on its devices; returns each
        block's per-client cumulative read+write app_bytes as a tensor on
        its device, in block order (callers pull them only if they need
        the throughput series: :meth:`host_totals`)."""
        p = self.core.p
        _take_ownership(self)
        if self.device_stale or self._ost_state is None:
            self._push()
        self._refresh_statics()

        wait_vec = self._ost_state["ost_wait"]
        terms, merged, counts = [], None, None
        for state, s, dev in zip(self._states, self._statics, self.devices):
            act = _duty_act(s, t)
            term = _plan_terms(p, s, state["dirty"], state["last_drain"],
                               self._on(wait_vec, dev), act, dt)
            terms.append(term)
            # block order, one blocking copy each: a deterministic sum
            part = _demand_partials(s, term).to(self.device)
            cnt = _activity_counts(s, state["dirty"], act).to(self.device)
            merged = part if merged is None else merged + part
            counts = cnt if counts is None else counts + cnt
        # the host draws this interval's noise for the OSTs with demand
        noise = torch.as_tensor(
            self.cluster._noise_for((counts > 0.0).cpu().numpy()),
            device=self.device)
        ost_out, scale_out, new_wait = _resolve(p, self._ost_state, merged,
                                                noise, dt)
        self._ost_state = ost_out

        totals, new_states = [], []
        for term, state, s, dev in zip(terms, self._states, self._statics,
                                       self.devices):
            out = _commit(p, s, state, term, self._on(scale_out, dev),
                          self._on(new_wait, dev), dt)
            new_states.append(out)
            totals.append(out["read"]["app_bytes"]
                          + out["write"]["app_bytes"])
        self._states = new_states
        self.host_stale = True
        return totals


# ---------------------------------------------------------------------------
# shard -> device placement (sync sharded runtime)
# ---------------------------------------------------------------------------
def shard_devices(primary, n_shards: int) -> List[torch.device]:
    """Where the sharded runtime puts its shards: on ``cuda`` shard ``i``
    goes on visible card ``i % count``; on any other device type every
    shard shares ``primary``."""
    primary = _indexed(primary)
    if primary.type != "cuda":
        return [primary] * n_shards
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n_shards)]


class ShardedDeviceFleet(DeviceFleet):
    """The sharded runtime's shards placed on devices.

    Shard ``i``'s client rows (``shard_idx[i]`` of the core) go on
    ``devices[i]``. The shards that share a device form one block of
    :class:`DeviceFleet`, so each device plans and commits its shards'
    rows in one pass, and one demand partial per device merges on
    ``primary``. On a one-card machine every shard shares the card: one
    block, the single-device fleet's own sums and results bit for bit,
    and the cross-device copies (``.to(primary)`` and back) are never
    taken.
    """

    def __init__(self, core: SoACore, cluster: PFSCluster,
                 shard_idx: Sequence[np.ndarray], devices: Sequence,
                 primary):
        if len(devices) != len(shard_idx):
            raise ValueError(f"{len(shard_idx)} shards but "
                             f"{len(devices)} devices")
        self.shard_devices = [_indexed(d) for d in devices]
        rows: Dict[torch.device, List[np.ndarray]] = {}
        for ix, dev in zip(shard_idx, self.shard_devices):
            rows.setdefault(dev, []).append(np.asarray(ix, dtype=np.int64))
        super().__init__(core, cluster, primary,
                         blocks=[np.sort(np.concatenate(r))
                                 for r in rows.values()],
                         devices=list(rows))
