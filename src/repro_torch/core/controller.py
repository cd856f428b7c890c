"""The CARAT per-client controller — two-stage tuning (paper §III-A, Fig 5).

Stage 1 (every probe interval while I/O-active): sample counters, build the
snapshot, pick the read- or write-focused model by dominant transfer volume,
run the tuner (Algorithm 1), actuate RPC params immediately.

Stage 2 (at the I/O-inactive -> active boundary, after > 1 s of silence):
the node-scope cache arbiter collects each client's active-stage factors and
re-allocates cache limits (Algorithm 2). Cache params propagate slowly, so
they are only touched at boundaries where the previous setting's influence
has faded.

The controller is *decentralized*: it sees only its own client's counters.
Cross-client coordination exists only within a node (the paper's stats
collector, Fig 4 step 5), never across the cluster.

Within the pluggable policy layer (``repro_torch.core.policies``) this
class is the per-client *state shell* that
:class:`~repro_torch.core.policies.carat.CaratPolicy` hosts: ``observe()`` is the shared sampling/stage-machine path both the
scalar loop and the batched fleet engine run (bit-identical by
construction), ``actuate()`` applies a stage-1 decision produced either
locally (``__call__``) or by the policy's batched ``decide_many``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.config import CaratConfig
from repro_torch.core.cache_tuner import CacheDemand, cache_allocation
from repro_torch.core.policy import CaratSpaces
from repro_torch.core.rpc_tuner import _TunerBase, make_tuner
from repro_torch.telemetry import perf_s
from repro_torch.telemetry import active as _telemetry
from repro_torch.core.snapshot import Snapshot, SnapshotBuilder
from repro_torch.storage.client import IOClient
from repro_torch.storage.params import PAGE_SIZE
from repro_torch.utils.rng import RngStream


@dataclass
class _AppSignature:
    """Config-independent workload fingerprint from one active snapshot."""
    read_share: float                   # app read bytes / total app bytes
    req_read: Optional[float] = None    # mean app request size (bytes)
    req_write: Optional[float] = None

    @classmethod
    def of(cls, snap: Snapshot) -> "_AppSignature":
        total = snap.read_app_bytes + snap.write_app_bytes
        share = snap.read_app_bytes / total if total > 0 else 0.0
        rr = (snap.read_app_bytes / snap.read_app_requests
              if snap.read_app_requests > 0.5 else None)
        rw = (snap.write_app_bytes / snap.write_app_requests
              if snap.write_app_requests > 0.5 else None)
        return cls(read_share=share, req_read=rr, req_write=rw)

    def changed_from(self, prev: "_AppSignature", req_ratio: float) -> bool:
        # strong op-mix flip (read-dominant <-> write-dominant)
        if ((prev.read_share >= 0.7 and self.read_share <= 0.3)
                or (prev.read_share <= 0.3 and self.read_share >= 0.7)):
            return True
        for a, b in ((prev.req_read, self.req_read),
                     (prev.req_write, self.req_write)):
            if a is not None and b is not None:
                lo, hi = sorted((a, b))
                if hi > lo * req_ratio:
                    return True
        return False


@dataclass
class _StageFactors:
    """Factors accumulated over one I/O-active stage (for Algorithm 2)."""
    peak_cache_bytes: float = 0.0
    peak_inflight_bytes: float = 0.0
    write_rpcs: float = 0.0
    total_rpcs: float = 0.0
    saw_activity: bool = False

    def update(self, snap: Snapshot) -> None:
        self.saw_activity = self.saw_activity or snap.active
        cache_bytes = snap.dirty_cache_mb * 1024.0 * 1024.0
        self.peak_cache_bytes = max(self.peak_cache_bytes,
                                    snap.write.dirty_cache_util * cache_bytes)
        vol = snap.read.data_volume + snap.write.data_volume
        inflight_bytes = snap.inflight_peak * snap.window_pages * float(PAGE_SIZE)
        self.peak_inflight_bytes = max(self.peak_inflight_bytes, inflight_bytes)
        # RPC mix for factor (3)
        self.write_rpcs += snap.write.data_volume
        self.total_rpcs += vol


class NodeCacheArbiter:
    """Stage-2 stats collector + cache tuner for all clients on one node.

    The arbitration is a collect -> allocate -> apply pipeline (mirroring
    the stage-1 observe/actuate split): :meth:`collect` extracts each
    member's stage factors as :class:`CacheDemand` rows, the allocation
    runs Algorithm 2 (scalar :func:`cache_allocation` here, or
    :func:`~repro_torch.core.cache_tuner.cache_allocation_many` when a fleet
    batches many nodes into one call), and :meth:`apply` actuates the
    limits and resets boundary members' factors.

    ``deferred=True`` queues boundary events instead of retuning inline:
    a fleet controller drains every pending node's boundary once per step
    into a single batched allocation — so a node retunes at most once per
    step even when several members cross together. Inline (default) mode
    keeps the paper's per-client semantics: every crossing retunes
    immediately.
    """

    def __init__(self, spaces: CaratSpaces, node_budget_mb: Optional[float] = None,
                 deferred: bool = False):
        self.spaces = spaces
        self.node_budget_mb = node_budget_mb
        self.members: List["CaratController"] = []
        self.deferred = deferred
        self.pending = False
        self._crossed: List["CaratController"] = []

    def register(self, ctrl: "CaratController") -> None:
        self.members.append(ctrl)

    def budget(self) -> float:
        if self.node_budget_mb is not None:
            return self.node_budget_mb
        return self.spaces.cache_max * max(len(self.members), 1) * 0.75

    # --- collect / apply pipeline --------------------------------------------
    def collect(self) -> List[CacheDemand]:
        """Demand extraction: one row per member, in registration order.

        Passes each member's raw write-RPC volume as the factor-(3)
        weight — the allocator owns the (single) normalization.
        """
        return [CacheDemand(
            client_id=m.client_id,
            active=m.stage_factors.saw_activity,
            peak_cache_bytes=m.stage_factors.peak_cache_bytes,
            peak_inflight_bytes=m.stage_factors.peak_inflight_bytes,
            write_rpc_share=m.stage_factors.write_rpcs,
        ) for m in self.members]

    def collect_rows(self) -> tuple:
        """:meth:`collect` as five parallel field rows (member order) for
        ``CacheDemandBatch.from_rows`` — the fleet drain's fast path, which
        skips the per-member :class:`CacheDemand` objects."""
        ms = self.members
        return ([m.client_id for m in ms],
                [m.stage_factors.saw_activity for m in ms],
                [m.stage_factors.peak_cache_bytes for m in ms],
                [m.stage_factors.peak_inflight_bytes for m in ms],
                [m.stage_factors.write_rpcs for m in ms])

    def apply(self, alloc: Dict[int, int]) -> None:
        """Actuate an allocation and close out boundary members' stages."""
        for m in self.members:
            if m.client is not None and m.client_id in alloc:
                m.client.set_cache_limit(alloc[m.client_id])
            # Only clients at an inactive->active boundary have finished the
            # stage their factors describe; clients still mid-active-stage
            # keep accumulating toward their own next boundary. (Deferred
            # crossings have already cleared their flag, hence _crossed.)
            if m.was_inactive_long or m in self._crossed:
                m.stage_factors = _StageFactors()
        self._crossed.clear()
        self.pending = False

    def apply_slots(self, values: Sequence[int]) -> None:
        """:meth:`apply` from a positional allocation row (slot order =
        member order, as produced by :meth:`collect_rows` + the batched
        allocator); padding beyond the member count is ignored."""
        for m, v in zip(self.members, values):
            if m.client is not None:
                m.client.set_cache_limit(v)
            if m.was_inactive_long or m in self._crossed:
                m.stage_factors = _StageFactors()
        self._crossed.clear()
        self.pending = False

    @property
    def crossings(self) -> int:
        """Members queued at a boundary since the last (deferred) apply."""
        return len(self._crossed)

    def mark_boundary(self, member: "CaratController") -> None:
        """A member hit its inactive->active boundary: retune now (inline
        mode) or queue for the fleet's end-of-step drain (deferred)."""
        if self.deferred:
            self.pending = True
            self._crossed.append(member)
        else:
            self.retune()

    def retune(self) -> Dict[int, int]:
        """Scalar compatibility path: collect -> Algorithm 2 -> apply."""
        alloc = cache_allocation(self.collect(), self.spaces, self.budget())
        self.apply(alloc)
        return alloc


class CaratController:
    """One CARAT instance, attached to one I/O client."""

    def __init__(
        self,
        client_id: int,
        spaces: CaratSpaces,
        models: Dict[str, object],          # op -> predict_proba callable
        cfg: Optional[CaratConfig] = None,
        rng: Optional[RngStream] = None,
        arbiter: Optional[NodeCacheArbiter] = None,
    ):
        self.client_id = client_id
        self.cfg = cfg or CaratConfig()
        self.spaces = spaces
        self.builder = SnapshotBuilder(interval_s=self.cfg.probe_interval_s,
                                       history_k=self.cfg.history_k)
        probs = {op: (m.predict_proba if hasattr(m, "predict_proba") else m)
                 for op, m in models.items()}
        self.tuner: _TunerBase = make_tuner(
            self.cfg.tuner, spaces, probs, tau=self.cfg.prob_tau,
            alpha=self.cfg.alpha, beta=self.cfg.beta,
            epsilon=self.cfg.epsilon,
            rng=rng or RngStream(client_id, "carat"))
        self.arbiter = arbiter
        if arbiter is not None:
            arbiter.register(self)
        # stage machine
        self.inactive_s = 0.0
        self.was_inactive_long = False
        self.stage_factors = _StageFactors()
        # phase-change re-probing state (replayed/dynamic workloads)
        self._last_sig: Optional[_AppSignature] = None
        self._last_reprobe_t = -float("inf")
        self._reprobe_pending = False
        self._bootstrap_pending = False
        self.client: Optional[IOClient] = None
        # Table VIII accounting
        self.apply_time_total = 0.0
        self.apply_count = 0
        self.decisions: List[tuple] = []

    # --- Simulation controller interface ---------------------------------------
    def observe(self, client: IOClient, t: float,
                dt: float) -> Optional[tuple]:
        """Snapshot + stage bookkeeping, *without* deciding.

        Runs everything up to (and including) the stage-2 boundary check,
        and returns ``(op, feats)`` when a stage-1 RPC decision is due —
        the hook a fleet controller uses to gather one batch across many
        clients. Returns None when no decision is needed this probe.
        """
        self.client = client
        snap = self.builder.sample(client.stats, t)
        if snap is None:
            return None
        self.stage_factors.update(snap)

        if not snap.active:
            # I/O-inactive: no RPC transfers, so RPC tuning is disabled
            self.inactive_s += dt
            if self.inactive_s >= self.cfg.inactive_threshold_s:
                self.was_inactive_long = True
            return None

        # I/O resumed after a long-enough inactive stage: stage-2 boundary
        if self.was_inactive_long and self.arbiter is not None:
            self.arbiter.mark_boundary(self)
        self.was_inactive_long = False
        self.inactive_s = 0.0

        # phase-change re-probe: the tuner's model is only confident near
        # the default config (it was trained on random excursions from
        # it), so a workload shift observed at a tuned config would leave
        # it silent below tau forever. Detect the shift from the
        # config-independent app signature and reset RPC params to the
        # space default — the next probes re-tune from the model's
        # confident region (IOPathTune/DIAL-style change response).
        if self.cfg.reprobe_on_change:
            sig = _AppSignature.of(snap)
            prev_sig, self._last_sig = self._last_sig, sig
            if (prev_sig is not None
                    and sig.changed_from(prev_sig,
                                         self.cfg.reprobe_req_ratio)):
                # deferred, not dropped: a change detected mid-cooldown
                # still re-probes once the cooldown expires
                self._reprobe_pending = True
            if (self._reprobe_pending and t - self._last_reprobe_t
                    >= self.cfg.reprobe_cooldown_s):
                self._reprobe_pending = False
                self._last_reprobe_t = t
                self._bootstrap_pending = True
                default = (self.spaces.default_rpc_window,
                           self.spaces.default_in_flight)
                if (client.config.rpc_window_pages,
                        client.config.rpcs_in_flight) != default:
                    client.set_rpc_config(*default)
                    self.decisions.append((t, "reprobe") + default)
                    rec = _telemetry()
                    if rec.enabled:
                        rec.count("carat.reprobe")
                    return None
                # already at default: fall through — this probe's features
                # were measured at default, so bootstrap right away

        # stage-1 RPC tuning, every probe interval
        op = snap.dominant_op
        feats = self.builder.feature_vector(op)
        if feats is None:
            return None
        if self._bootstrap_pending:
            # first probe after a re-probe reset: the model ranks regimes
            # well but calibrates conservatively away from its training
            # distribution, so the tau gate alone can leave a fresh phase
            # untuned. Take one tau-free greedy pick (scalar inference in
            # both the per-client and fleet paths, so decisions stay
            # bit-identical); every later probe is tau-gated as usual.
            self._bootstrap_pending = False
            probs = self.tuner._probs(op, feats)
            w, f = self.spaces.rpc_candidates()[int(np.argmax(probs))]
            self.client.set_rpc_config(w, f)
            self.decisions.append((t, "bootstrap", w, f))
            rec = _telemetry()
            if rec.enabled:
                rec.count("carat.bootstrap")
            return None
        rec = _telemetry()
        if rec.enabled:
            rec.count("carat.probe")
        return op, feats

    def actuate(self, op: str, proposal: Optional[tuple], t: float,
                tune_time_s: float = 0.0) -> None:
        """Apply a stage-1 decision produced for this controller's client.

        ``tune_time_s`` is the (share of) tuner time spent producing the
        proposal, folded into the Table VIII end-to-end accounting.
        """
        t0 = perf_s()
        if proposal is not None:
            self.client.set_rpc_config(*proposal)
            self.decisions.append((t, op) + tuple(proposal))
        self.apply_time_total += tune_time_s + perf_s() - t0
        self.apply_count += 1

    def __call__(self, client: IOClient, t: float, dt: float) -> None:
        pending = self.observe(client, t, dt)
        if pending is None:
            return
        op, feats = pending
        t0 = perf_s()
        proposal = self.tuner.propose(op, feats)
        self.actuate(op, proposal, t, perf_s() - t0)

    # --- Table VIII ----------------------------------------------------------
    def overheads(self) -> Dict[str, float]:
        return {
            "snapshot_ms": self.builder.mean_snapshot_time_s * 1e3,
            "inference_ms": self.tuner.mean_inference_s * 1e3,
            "end_to_end_ms": (self.builder.mean_snapshot_time_s
                              + self.apply_time_total
                              / max(self.apply_count, 1)) * 1e3,
        }
