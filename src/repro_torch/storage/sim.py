"""Simulation driver: clients + cluster + pluggable tuning policies.

Advances the modeled deployment in probe-interval steps. Tuners attach
through one entry point, :meth:`Simulation.attach_policy`: anything with
the :class:`repro_torch.core.policies.base.TuningPolicy` lifecycle
(``bind`` once, then ``step(clients, t, dt)`` each interval). ``phase="workload"``
policies run *before* planning (trace replay swapping what clients do);
``phase="tune"`` policies (the default) run after counters update,
mirroring the probe -> snapshot -> tune loop of Fig 4. The driver
itself never inspects global state on behalf of a policy — what a
policy observes is its own contract (CARAT/DIAL read only their own
client's counters; a Magpie-style centralized actor reads them all).

The interval itself decomposes into shard-steppable phases —
:meth:`Simulation.plan_phase` (per-client, independent),
:meth:`Simulation.resolve_phase` (the one globally-coupled point: every
demand meets the shared OST queues), and :meth:`Simulation.commit_phase`
(per-client, independent). :meth:`step` composes them over the whole
client list; ``repro.core.runtime.ShardedRuntime`` runs the same
phases per node-group shard in the reference package (the sharded
runtime is not ported yet).

Backends: ``"soa-torch"`` (the default) keeps the fleet state on a torch
device across intervals (:class:`repro_torch.storage.device.DeviceFleet`,
on ``cuda`` unless ``device="cpu"`` is passed); ``"soa"`` is the host
NumPy struct-of-arrays core it is held against; ``"scalar"`` is one
Python ``IOClient`` per client, the identity oracle of ``"soa"``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.storage.client import ClientConfig, IOClient
from repro_torch.storage.params import PFSParams
from repro_torch.storage.pfs import ClusterFeedback, PFSCluster
from repro_torch.storage.soa import DemandBatch, PlanBatch, SoAClientView, SoACore
from repro_torch.storage.workloads import WorkloadSpec
from repro_torch.telemetry import active as _telemetry
from repro_torch.utils.rng import RngStream

# fleet/policy callback: (clients, t, dt) -> None; invoked once per step with
# every client, so a fleet engine can batch its per-client tuning into one
# vectorized call (repro_torch.core.policies.carat.CaratPolicy). Each
# member controller still only reads its own client's counters — the
# batching is compute shape, not extra observability.
FleetHook = Callable[[Sequence[IOClient], float, float], None]

# schedule duck type: anything with ``spec_at(t) -> WorkloadSpec`` (the
# canonical implementation is repro.storage.replay.WorkloadSchedule, not
# ported yet; kept structural so sim never imports a replay layer).
ScheduleLike = object

# policy duck type: ``step(clients, t, dt)`` / ``__call__`` plus optional
# ``bind(sim, client_ids)`` and ``phase`` — structural for the same reason
# (the canonical ABC lives in repro_torch.core.policies.base).
PolicyLike = object


class SchedulePolicy:
    """``phase="workload"`` policy driving clients from phase schedules.

    Consulted at the top of every step, so workload switches land
    exactly on interval boundaries with carried state (dirty cache,
    last_wait) deliberately preserved.
    """

    name = "schedule"
    phase = "workload"

    def __init__(self, schedules: Mapping[int, "ScheduleLike"]):
        self.schedules: Dict[int, "ScheduleLike"] = {
            int(cid): sched for cid, sched in schedules.items()}
        # per-clients-list fast-path state: schedules expose their switch
        # times (WorkloadSchedule.boundaries), so between boundaries the
        # per-step work is one vectorized "anything due?" check instead of
        # len(schedules) spec_at() calls — the difference between replay
        # being free and replay re-introducing an O(n) interpreter loop
        # at 100k clients. Schedules without a ``boundaries`` attribute
        # fall back to being consulted every step (old semantics).
        self._fast: Dict[object, dict] = {}

    def bind(self, sim, client_ids: Optional[Sequence[int]] = None) -> None:
        if client_ids is not None:
            extra = set(self.schedules) - {int(i) for i in client_ids}
            if extra:
                raise ValueError(f"schedules cover client(s) {sorted(extra)} "
                                 f"outside client_ids {sorted(client_ids)}")
        for cid in self.schedules:
            sim.client_by_id(cid)           # fail fast on unknown ids

    def _switch(self, client: IOClient, sched: "ScheduleLike",
                t: float) -> None:
        # set_workload swaps only the demand descriptor, so carried state
        # (dirty cache, last_wait, last_drain) survives the switch
        spec = sched.spec_at(t)
        if spec is not client.workload:
            client.set_workload(spec)

    def _state_for(self, key: object, clients: Sequence[IOClient],
                   pairs: List[tuple]) -> dict:
        st = {"clients": clients, "pairs": pairs,
              "bounds": [getattr(sched, "boundaries", None)
                         for _, sched in pairs],
              # -inf: every client is due on the first step it is seen
              "next": np.full(len(pairs), -np.inf),
              "ptr": [0] * len(pairs)}
        self._fast[key] = st
        return st

    def _step_due(self, st: dict, t: float) -> None:
        nxt = st["next"]
        if not (nxt <= t).any():
            return
        pairs, bounds, ptrs = st["pairs"], st["bounds"], st["ptr"]
        for i in np.nonzero(nxt <= t)[0]:
            client, sched = pairs[i]
            self._switch(client, sched, t)
            b = bounds[i]
            if b is None:
                continue        # no boundary info: stays due every step
            ptr = ptrs[i]
            while ptr < len(b) and b[ptr] <= t:
                ptr += 1
            ptrs[i] = ptr
            nxt[i] = b[ptr] if ptr < len(b) else np.inf

    def step(self, clients: Sequence[IOClient], t: float, dt: float) -> None:
        key = ("step", id(clients))
        st = self._fast.get(key)
        if st is None or st["clients"] is not clients:
            from repro_torch.core.policies.base import resolve_bound_clients
            targets = resolve_bound_clients(f"policy {self.name!r}",
                                            list(self.schedules), clients)
            st = self._state_for(key, clients,
                                 list(zip(targets, self.schedules.values())))
        self._step_due(st, t)

    __call__ = step


@dataclass
class SimResult:
    duration_s: float
    interval_s: float
    # per-client per-interval application throughput (bytes/s), read+write
    client_throughput: List[List[float]] = field(default_factory=list)
    # per-client totals
    app_read_bytes: List[float] = field(default_factory=list)
    app_write_bytes: List[float] = field(default_factory=list)

    @property
    def aggregate_throughput(self) -> float:
        total = sum(self.app_read_bytes) + sum(self.app_write_bytes)
        return total / self.duration_s

    def client_mean_throughput(self, i: int) -> float:
        return (self.app_read_bytes[i] + self.app_write_bytes[i]) / self.duration_s


class Simulation:
    def __init__(
        self,
        workloads: Sequence[WorkloadSpec],
        params: Optional[PFSParams] = None,
        configs: Optional[Sequence[ClientConfig]] = None,
        seed: int = 0,
        interval_s: float = 0.5,
        stripe_offsets: Optional[Sequence[int]] = None,
        topology: Optional[Sequence[object]] = None,
        client_ids: Optional[Sequence[int]] = None,
        backend: str = "soa-torch",
        device: DeviceLike = None,
    ):
        if backend not in ("scalar", "soa", "soa-torch"):
            raise ValueError(f"backend must be 'scalar', 'soa' or "
                             f"'soa-torch', got {backend!r}")
        if topology is not None:
            topology = list(topology)
            if len(topology) != len(workloads):
                raise ValueError(
                    f"topology maps {len(topology)} clients but the "
                    f"simulation has {len(workloads)} workloads")
        # client -> node map (position-aligned with `clients`); consumed by
        # CaratPolicy.bind to wire one stage-2 cache arbiter per node and
        # by ShardedRuntime to partition clients into node-group shards.
        # None = no multi-node structure declared.
        self.topology = topology
        self.p = params or PFSParams()
        self.interval_s = interval_s
        self.rng = RngStream(seed, "sim")
        self.cluster = PFSCluster(self.p, self.rng.fork("cluster"))
        # client ids default to dense positions, but replayed traces (and
        # real deployments) carry arbitrary ids — everything downstream
        # resolves clients by id, never by list position.
        if client_ids is None:
            ids = list(range(len(workloads)))
        else:
            ids = [int(i) for i in client_ids]
            if len(ids) != len(workloads):
                raise ValueError(f"client_ids names {len(ids)} clients but "
                                 f"the simulation has {len(workloads)} "
                                 f"workloads")
            if len(set(ids)) != len(ids):
                raise ValueError(f"client_ids must be unique, got {ids}")
        self.backend = backend
        own_cfgs = [ClientConfig(**vars(configs[i])) if configs is not None
                    else ClientConfig() for i in range(len(workloads))]
        offsets = [stripe_offsets[i] if stripe_offsets is not None
                   else (i * 3) % self.p.n_osts
                   for i in range(len(workloads))]
        if backend == "scalar":
            self.core: Optional[SoACore] = None
            self.clients: List[IOClient] = [
                IOClient(client_id=cid, params=self.p, workload=wl, config=cfg,
                         rng=self.rng.fork(f"client{cid}"),
                         stripe_offset=offset)
                for cid, wl, cfg, offset in zip(ids, workloads, own_cfgs,
                                                offsets)]
        else:
            # one dense array core; clients are thin per-row views with the
            # IOClient surface, so policies and controllers are unchanged.
            # (per-client rng forks are skipped: IOClient never draws from
            # its stream, and RngStream.fork is hash-derived — it consumes
            # nothing from the parent, so the cluster stream is unaffected)
            self.core = SoACore(self.p, list(workloads), own_cfgs, ids,
                                offsets)
            self.clients = [SoAClientView(self.core, i)
                            for i in range(len(ids))]
        # soa-torch: fleet state lives on the device across intervals,
        # stepped by one call per interval (storage.device). Host-side
        # phase methods stay available — SoACore's ensure_host/host_mutated
        # hooks keep the two sides coherent.
        self.device_fleet = None
        if backend == "soa-torch":
            from repro_torch.storage.device import DeviceFleet
            self.device_fleet = DeviceFleet(self.core, self.cluster,
                                            device=resolve_device(device))
        self._by_id: Dict[int, IOClient] = {c.client_id: c
                                            for c in self.clients}
        self._idx_all = (self.core.idx_all if self.core is not None
                         else np.arange(len(self.clients), dtype=np.int64))
        self._idx_cache: Dict[int, tuple] = {}
        # everything that drives clients is a policy on one of two step
        # phases, invoked in attach order within its phase
        self._workload_policies: List[PolicyLike] = []
        self._tune_policies: List[PolicyLike] = []
        self.t = 0.0

    def client_by_id(self, client_id: int) -> IOClient:
        try:
            return self._by_id[client_id]
        except KeyError:
            raise KeyError(f"no client with id {client_id} (got "
                           f"{sorted(c.client_id for c in self.clients)})"
                           ) from None

    def attach_policy(self, policy: "PolicyLike",
                      client_ids: Optional[Sequence[int]] = None
                      ) -> "PolicyLike":
        """The unified tuner attach point: bind ``policy`` to this
        simulation and invoke it once per step.

        ``policy`` is anything with the
        :class:`repro_torch.core.policies.base.TuningPolicy` lifecycle — at minimum
        ``step(clients, t, dt)`` (or being callable with that
        signature); ``bind(sim, client_ids)`` is called here if present,
        and ``phase`` selects when the policy runs: ``"tune"``
        (default) after counters update, ``"workload"`` before
        planning. ``client_ids`` restricts the policy to a subset of
        clients (None = all). Returns the policy for chaining.
        """
        phase = getattr(policy, "phase", "tune")
        if phase not in ("workload", "tune"):
            # validate before bind(): a rejected policy must not have
            # already mutated the simulation's clients
            raise ValueError(f"policy phase must be 'workload' or 'tune', "
                             f"got {phase!r}")
        bind = getattr(policy, "bind", None)
        if bind is not None:
            bind(self, client_ids)
        if phase == "workload":
            self._workload_policies.append(policy)
        else:
            self._tune_policies.append(policy)
        return policy

    def detach_policy(self, policy: "PolicyLike") -> None:
        """Remove a previously attached policy (no-op bindings are not
        undone; the policy simply stops being invoked)."""
        for bucket in (self._workload_policies, self._tune_policies):
            if policy in bucket:
                bucket.remove(policy)
                return
        raise ValueError(f"policy {policy!r} is not attached")

    def policies(self, phase: Optional[str] = None) -> List["PolicyLike"]:
        """Attached policies, in invocation order (optionally one phase)."""
        if phase == "workload":
            return list(self._workload_policies)
        if phase == "tune":
            return list(self._tune_policies)
        if phase is None:
            return list(self._workload_policies) + list(self._tune_policies)
        raise ValueError(f"phase must be 'workload', 'tune' or None, "
                         f"got {phase!r}")

    def node_clients(self) -> Dict[object, List[int]]:
        """Node id -> client ids, from the declared topology. With no
        topology declared, each client is its own node (matching
        ``CaratPolicy``'s private-arbiter default)."""
        topo = self.topology if self.topology is not None \
            else list(range(len(self.clients)))
        out: Dict[object, List[int]] = {}
        for c, node in zip(self.clients, topo):
            out.setdefault(node, []).append(c.client_id)
        return out

    # --- shard-steppable interval phases --------------------------------------
    def _indices_of(self, clients: Sequence[IOClient]) -> np.ndarray:
        """Core array positions for a client subset (identity-cached, so
        sharded runtimes that re-pass the same list pay the gather once)."""
        if clients is self.clients:
            return self._idx_all
        key = id(clients)
        hit = self._idx_cache.get(key)
        if hit is not None and hit[0] is clients:
            return hit[1]
        idx = np.fromiter((c.index for c in clients), dtype=np.int64,
                          count=len(clients))
        self._idx_cache[key] = (clients, idx)
        return idx

    def plan_phase(self, clients: Sequence[IOClient], t: float,
                   dt: float) -> object:
        """Per-client planning (independent: any client subset, any order).

        Scalar backend: a list of per-client ``Plan`` objects. SoA
        backend: one :class:`PlanBatch` covering the subset.
        """
        with _telemetry().span("plan", cat="sim"):
            if self.core is not None:
                return self.core.plan(self._indices_of(clients), t, dt)
            return [c.plan(t, dt, self.p.n_osts) for c in clients]

    def resolve_phase(self, plans: object, dt: float) -> ClusterFeedback:
        """The globally-coupled phase: all offered demands meet the shared
        OST queues at once. Demand order must be canonical (client list
        order) — per-OST accumulation is float-order-sensitive. Accepts
        one ``PlanBatch``, a sequence of ``PlanBatch`` shards (merged
        back into canonical order by demand ordinal), or the scalar list
        of ``Plan`` objects."""
        with _telemetry().span("resolve", cat="sim"):
            if isinstance(plans, PlanBatch):
                return self.cluster.resolve_batch(plans.demand_batch(), dt)
            plans = list(plans)
            if plans and isinstance(plans[0], PlanBatch):
                batch = DemandBatch.merge([pb.demand_batch()
                                           for pb in plans])
                return self.cluster.resolve_batch(batch, dt)
            demands = [d for pl in plans for d in pl.all_demands()]
            return self.cluster.resolve(demands, dt)

    def commit_phase(self, clients: Sequence[IOClient],
                     plans: object, fb: ClusterFeedback,
                     dt: float) -> None:
        """Per-client commit of resolved feedback (independent)."""
        with _telemetry().span("commit", cat="sim"):
            if isinstance(plans, PlanBatch):
                scale_arr, waits_arr = fb.as_arrays(self.p.n_osts)
                self.core.commit(plans, scale_arr, waits_arr, dt)
                return
            for client, plan in zip(clients, plans):
                client.commit(plan, fb.scale, fb.waits, dt)

    def step(self) -> None:
        dt = self.interval_s
        # workload-phase policies first: replayed schedules switch what the
        # clients do *before* this interval is planned
        for policy in self._workload_policies:
            policy(self.clients, self.t, dt)
        if self.device_fleet is not None:
            # device step: plan+resolve+commit in one call, state stays
            # on the device; host arrays sync lazily on first read
            self._last_totals = self.device_fleet.step(self.t, dt)
        else:
            plans = self.plan_phase(self.clients, self.t, dt)
            fb = self.resolve_phase(plans, dt)
            self.commit_phase(self.clients, plans, fb, dt)
        self.t += dt
        # tune-phase policies run after counters update (probe -> tune,
        # Fig 4), in attach order
        for policy in self._tune_policies:
            policy(self.clients, self.t, dt)

    def run(self, duration_s: float) -> SimResult:
        n_steps = int(round(duration_s / self.interval_s))
        if self.device_fleet is not None:
            # device-resident run: each device step returns the (n,)
            # cumulative app-bytes totals as a device tensor; the series
            # materializes host-side once at the end, so no per-step
            # fleet-state transfer happens (policies that read per-client
            # stats still trigger their own lazy syncs)
            core = self.core
            core.ensure_host()
            start_read = core.read.app_bytes.copy()
            start_write = core.write.app_bytes.copy()
            prev = start_read + start_write
            raw: List[object] = []
            for _ in range(n_steps):
                self.step()
                if self.device_fleet is self.core._device:
                    raw.append(self._last_totals)
                else:
                    # a host-path phase took ownership mid-run; read the
                    # host counters instead
                    core.ensure_host()
                    raw.append(core.read.app_bytes + core.write.app_bytes)
            cols = []
            for tot in raw:
                if isinstance(tot, torch.Tensor):
                    tot = tot.cpu().numpy()
                cols.append((tot - prev) / self.interval_s)
                prev = tot
            series = (np.stack(cols, axis=1) if cols
                      else np.zeros((core.n, 0)))
            core.ensure_host()
            return SimResult(
                duration_s=n_steps * self.interval_s,
                interval_s=self.interval_s,
                client_throughput=series.tolist(),
                app_read_bytes=(core.read.app_bytes - start_read).tolist(),
                app_write_bytes=(core.write.app_bytes - start_write).tolist(),
            )
        if self.core is not None:
            # whole-array throughput series: one (n,) column per step off
            # the SoA cumulative counters — run() adds no per-client loop
            core = self.core
            start_read = core.read.app_bytes.copy()
            start_write = core.write.app_bytes.copy()
            prev = start_read + start_write
            cols: List[np.ndarray] = []
            for _ in range(n_steps):
                self.step()
                total = core.read.app_bytes + core.write.app_bytes
                cols.append((total - prev) / self.interval_s)
                prev = total
            series = (np.stack(cols, axis=1) if cols
                      else np.zeros((core.n, 0)))
            return SimResult(
                duration_s=n_steps * self.interval_s,
                interval_s=self.interval_s,
                client_throughput=series.tolist(),
                app_read_bytes=(core.read.app_bytes - start_read).tolist(),
                app_write_bytes=(core.write.app_bytes - start_write).tolist(),
            )
        prev_totals = [(c.stats.read.app_bytes + c.stats.write.app_bytes)
                       for c in self.clients]
        start_read = [c.stats.read.app_bytes for c in self.clients]
        start_write = [c.stats.write.app_bytes for c in self.clients]
        series: List[List[float]] = [[] for _ in self.clients]
        for _ in range(n_steps):
            self.step()
            for i, c in enumerate(self.clients):
                total = c.stats.read.app_bytes + c.stats.write.app_bytes
                series[i].append((total - prev_totals[i]) / self.interval_s)
                prev_totals[i] = total
        return SimResult(
            duration_s=n_steps * self.interval_s,
            interval_s=self.interval_s,
            client_throughput=series,
            app_read_bytes=[c.stats.read.app_bytes - s
                            for c, s in zip(self.clients, start_read)],
            app_write_bytes=[c.stats.write.app_bytes - s
                             for c, s in zip(self.clients, start_write)],
        )

