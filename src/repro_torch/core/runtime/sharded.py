"""Sharded fleet runtime: node-group shards around an observation/decision bus.

:class:`ShardedRuntime` executes a built
:class:`~repro_torch.storage.sim.Simulation`
— its clients, cluster parameters, and attached policies — as a fleet of
*shards*. Clients partition into shards along the deployment's node
groups (:meth:`Simulation.node_clients`; node arbiters are shard-local
state, so a node never splits). Each shard advances its own
plan -> resolve -> commit loop over its clients; tuning policies never
touch ``sim.clients`` whole but gather observations and scatter
decisions over a :class:`~repro_torch.core.runtime.bus.TuningBus` (see
the ``TuningPolicy`` bus protocol in ``repro_torch.core.policies.base``).

Two execution modes:

``mode="sync"``
    A deterministic round-robin scheduler on one thread, with a barrier
    per probe interval: all shards plan, the offered demands are
    reassembled in canonical client order and resolved against the one
    shared cluster, all shards commit, and each tune policy runs one
    complete bus round (observe -> gather -> decide -> scatter ->
    actuate, then the stage-2 request/reply round). This is
    **decision-identical to the single-process** ``Simulation.run`` —
    same plans, same float order in the shared OST queues, same
    ``decide_many`` batches — on the host backends (``"scalar"``,
    ``"soa"``); ``tests/test_torch_runtime.py`` holds it to that and to
    the reference package's runtime.

``mode="async"``
    One thread per shard plus a coordinator: shards free-run their own
    probe cadence and never wait for each other. Cross-shard coupling
    becomes bounded-staleness gathers over the bus, tuned by
    ``max_staleness_intervals``:

    * contention: each shard resolves its own demands *plus* the other
      shards' last published demand echoes (dropped once staler than
      the bound) against a per-shard cluster replica;
    * tuning: the coordinator decides over whatever fresh observations
      have arrived — a straggler shard's stale observations are dropped,
      never waited for, so the fleet's probe cadence is set by the
      healthy shards (the ``straggler_delay_s`` injection tests this);
    * stage-2: demand requests are answered whenever they arrive
      (request/reply traffic is never dropped — an unanswered arbiter
      would stall), and budget trading runs over each gathered batch,
      conserving the summed budgets of exactly the nodes in that batch.

    Async mode is *not* decision-identical: that is the point of the
    knob. ``max_staleness_intervals=0`` still tolerates same-interval
    skew; larger values trade coupling freshness for cadence isolation.

Where the fleet steps:

* A ``backend="soa-torch"`` simulation keeps its fleet on a torch device,
  and the port's host ``SoACore`` is NumPy only — the host phases would
  step the whole fleet on the CPU. So sync mode over a ``"soa-torch"``
  sim always steps through
  :class:`~repro_torch.storage.device.ShardedDeviceFleet`, and async
  mode, whose shards free-run host-side, raises and names
  ``backend="soa"`` as the host path to ask for.
* The shards' devices come from the sim's own fleet device: on ``cuda``,
  shard ``i`` goes on visible card ``i % count`` and the primary (where
  the partials merge and the one resolve runs) is the sim's card; on
  ``cpu`` every shard is on the CPU. Shards that share a device step as
  one block, so on a one-card machine the sharded fleet computes what
  the sim's own fleet does, bit for bit, and the cross-card copy of the
  partial merge is not exercised there.
* Across cards the merge reassociates the partial sums: that fleet is
  held to the single-device one at ``rtol=1e-9``, not to decision
  identity.

Payloads are id-keyed and object-free on the bus — CARAT's tuner RNG
crosses as serialized stream state inside the observation/decision
messages — so the same protocol runs unchanged over the cross-process
and cross-host transports in ``repro_torch.core.runtime.transport``
(:class:`MultiprocessBus` pipes, :class:`SocketBus` TCP frames, and the
spawn/join :class:`ProcessRuntime` worker lifecycle).
"""
from __future__ import annotations

import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.runtime.bus import COORDINATOR, InProcessBus, TuningBus
from repro_torch.storage.pfs import PFSCluster
from repro_torch.storage.sim import SimResult, Simulation
from repro_torch.storage.soa import DemandBatch
from repro_torch.telemetry import active as _telemetry
from repro_torch.telemetry import perf_s


@dataclass
class Shard:
    """One node group's slice of the deployment."""
    sid: int
    nodes: List[object]
    clients: List[object]                  # IOClients, in sim.clients order
    cluster: Optional[PFSCluster] = None   # async-mode replica
    idx: Optional[np.ndarray] = None       # SoA core rows (soa backend)
    interval: int = 0                      # local intervals completed
    t: float = 0.0
    step_walls: List[float] = field(default_factory=list)
    # per-policy stage-2 request keys awaiting a reply (async mode)
    inflight: Dict[int, set] = field(default_factory=dict)
    series: List[List[float]] = field(default_factory=list)

    @property
    def client_ids(self) -> List[int]:
        return [c.client_id for c in self.clients]


class ShardedRuntime:
    """Drive an assembled Simulation as a sharded fleet (module docstring).

    ``n_shards`` merges node groups round-robin into that many shards
    (default: one shard per node group); ``shard_map`` assigns nodes to
    shard ids explicitly. ``straggler_delay_s`` injects a per-interval
    wall-clock delay into chosen shards — the benchmark's slow-node
    fault injection. ``bus`` defaults to a fresh :class:`InProcessBus`.
    """

    def __init__(
        self,
        sim: Simulation,
        mode: str = "sync",
        max_staleness_intervals: int = 2,
        n_shards: Optional[int] = None,
        shard_map: Optional[Mapping[object, int]] = None,
        straggler_delay_s: Optional[Mapping[int, float]] = None,
        bus: Optional[TuningBus] = None,
    ):
        if mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async', got {mode!r}")
        on_device = sim.backend == "soa-torch"
        if on_device and mode != "sync":
            raise ValueError(
                "async mode free-runs its shards on the host; a "
                "backend='soa-torch' fleet steps only on its device. "
                "Build the simulation with backend='soa' for the host "
                "path")
        if on_device and straggler_delay_s:
            raise ValueError("straggler injection targets the host step "
                             "loop; a backend='soa-torch' fleet steps on "
                             "its device")
        if max_staleness_intervals < 0:
            raise ValueError("max_staleness_intervals must be >= 0")
        if n_shards is not None and shard_map is not None:
            raise ValueError("pass n_shards or shard_map, not both")
        self.sim = sim
        self.mode = mode
        self.max_staleness = int(max_staleness_intervals)
        self.bus = bus if bus is not None else InProcessBus()
        self.straggler_delay_s = dict(straggler_delay_s or {})

        # --- partition node groups into shards --------------------------------
        groups = sim.node_clients()                # node -> [client ids]
        nodes = list(groups)
        if shard_map is not None:
            missing = [n for n in nodes if n not in shard_map]
            if missing:
                raise ValueError(f"shard_map has no shard for node(s) "
                                 f"{missing}")
            assign = {n: int(shard_map[n]) for n in nodes}
        else:
            k = len(nodes) if n_shards is None else int(n_shards)
            if k < 1:
                raise ValueError("n_shards must be >= 1")
            k = min(k, len(nodes))
            assign = {n: i % k for i, n in enumerate(nodes)}
        by_sid: Dict[int, List[object]] = {}
        for n in nodes:
            by_sid.setdefault(assign[n], []).append(n)
        by_id = {c.client_id: c for c in sim.clients}
        self.shards: List[Shard] = []
        for sid in sorted(by_sid):
            cids = {cid for n in by_sid[sid] for cid in groups[n]}
            # shard clients keep sim.clients order (canonical reassembly)
            clients = [c for c in sim.clients if c.client_id in cids]
            self.shards.append(Shard(
                sid=sid, nodes=by_sid[sid], clients=clients,
                idx=(np.fromiter((c.index for c in clients), dtype=np.int64,
                                 count=len(clients))
                     if sim.core is not None else None)))
        self._shard_of = {c.client_id: s.sid
                          for s in self.shards for c in s.clients}
        # shard -> device placement: shards sharing a device step as one
        # block; demand partials merge on the primary device before the
        # one shared resolve (storage.device module docstring)
        self.device_fleet = None
        if on_device:
            from repro_torch.storage.device import (ShardedDeviceFleet,
                                                    shard_devices)
            primary = sim.device_fleet.device
            self.device_fleet = ShardedDeviceFleet(
                sim.core, sim.cluster, [s.idx for s in self.shards],
                shard_devices(primary, len(self.shards)), primary)
        bad = [sid for sid in self.straggler_delay_s
               if sid not in {s.sid for s in self.shards}]
        if bad:
            raise ValueError(f"straggler_delay_s names unknown shard(s) "
                             f"{bad} (have {[s.sid for s in self.shards]})")

        # --- classify attached policies ---------------------------------------
        # (kind, phase_list_index_order preserved)
        self._workload = [(self._classify(p), p)
                          for p in sim.policies("workload")]
        self._tune = [(self._classify(p), p) for p in sim.policies("tune")]
        if mode == "async":
            for kind, p in self._workload + self._tune:
                if kind == "hook":
                    raise ValueError(
                        f"async mode needs bus-capable policies; {p!r} is a "
                        f"plain (clients, t, dt) hook with no 'gather' "
                        f"declaration — wrap it in a TuningPolicy")
            for kind, p in self._workload:
                if kind != "local":
                    # the async shard loop runs workload policies
                    # shard-locally with no bus round; a fleet-gather
                    # workload policy would silently decide from one
                    # shard's view
                    raise ValueError(
                        f"async mode supports only gather='none' workload "
                        f"policies; {p!r} declares gather='fleet'")
        for _, p in self._tune:
            check = getattr(p, "validate_shards", None)
            if check is not None:
                check(self._shard_of)

    @staticmethod
    def _classify(policy) -> str:
        gather = getattr(policy, "gather", None)
        if gather == "fleet":
            return "fleet"
        if gather == "none" and hasattr(policy, "step_shard"):
            return "local"
        if gather is None:
            return "hook"
        raise ValueError(f"policy {policy!r} declares gather={gather!r}; "
                         f"expected 'none' or 'fleet'")

    # ------------------------------------------------------------- results
    def _start_accounting(self):
        core = self.sim.core
        if core is not None:
            # whole-array accounting off the SoA cumulative counters —
            # no per-client Python loop at fleet scale
            core.ensure_host()
            self._start_read = core.read.app_bytes.copy()
            self._start_write = core.write.app_bytes.copy()
            total = core.read.app_bytes + core.write.app_bytes
            for shard in self.shards:
                shard.series = []            # list of (len(shard),) columns
                shard._prev = total[shard.idx]
            return
        clients = self.sim.clients
        self._start_read = [c.stats.read.app_bytes for c in clients]
        self._start_write = [c.stats.write.app_bytes for c in clients]
        for shard in self.shards:
            shard.series = [[] for _ in shard.clients]
            shard._prev = [c.stats.read.app_bytes + c.stats.write.app_bytes
                           for c in shard.clients]

    def _record_interval(self, shard: Shard) -> None:
        dt = self.sim.interval_s
        core = self.sim.core
        if self.device_fleet is not None and \
                core is not None and core._device is self.device_fleet:
            # device mode: series from the device step's totals (pulled
            # once per interval)
            total = self._device_totals[shard.idx]
            shard.series.append((total - shard._prev) / dt)
            shard._prev = total
        elif core is not None:
            total = (core.read.app_bytes + core.write.app_bytes)[shard.idx]
            shard.series.append((total - shard._prev) / dt)
            shard._prev = total
        else:
            for i, c in enumerate(shard.clients):
                total = c.stats.read.app_bytes + c.stats.write.app_bytes
                shard.series[i].append((total - shard._prev[i]) / dt)
                shard._prev[i] = total
        shard.step_walls.append(perf_s())
        rec = _telemetry()
        if rec.enabled:
            rec.set_interval(shard.interval)

    def _result(self, n_steps: int) -> SimResult:
        sim = self.sim
        core = sim.core
        if core is not None:
            core.ensure_host()
            full = np.zeros((core.n, n_steps))
            for shard in self.shards:
                if shard.series:
                    full[shard.idx, :] = np.stack(shard.series, axis=1)
            return SimResult(
                duration_s=n_steps * sim.interval_s,
                interval_s=sim.interval_s,
                client_throughput=full.tolist(),
                app_read_bytes=(core.read.app_bytes
                                - self._start_read).tolist(),
                app_write_bytes=(core.write.app_bytes
                                 - self._start_write).tolist(),
            )
        series_of = {}
        for shard in self.shards:
            for c, s in zip(shard.clients, shard.series):
                series_of[c.client_id] = s
        return SimResult(
            duration_s=n_steps * sim.interval_s,
            interval_s=sim.interval_s,
            client_throughput=[series_of[c.client_id] for c in sim.clients],
            app_read_bytes=[c.stats.read.app_bytes - s
                            for c, s in zip(sim.clients, self._start_read)],
            app_write_bytes=[c.stats.write.app_bytes - s
                             for c, s in zip(sim.clients,
                                             self._start_write)],
        )

    def probe_cadence(self) -> Dict[int, float]:
        """Median wall-clock seconds between completed probe intervals,
        per shard (the straggler-tolerance metric)."""
        out = {}
        for shard in self.shards:
            gaps = [b - a for a, b in zip(shard.step_walls,
                                          shard.step_walls[1:])]
            out[shard.sid] = statistics.median(gaps) if gaps else 0.0
        return out

    # ------------------------------------------------------------------ run
    def run(self, duration_s: float) -> SimResult:
        n_steps = int(round(duration_s / self.sim.interval_s))
        self._start_accounting()
        if self.mode == "sync":
            for _ in range(n_steps):
                self._sync_step()
        else:
            self._run_async(n_steps)
        return self._result(n_steps)

    # ------------------------------------------------------------ sync mode
    def _sync_step(self) -> None:
        """One barrier interval, bit-identical to ``Simulation.step``."""
        sim = self.sim
        dt = sim.interval_s
        t = sim.t
        rec = _telemetry()
        with rec.span("sync_barrier", cat="runtime"):
            self._sync_step_body(sim, t, dt)

    def _sync_step_body(self, sim, t: float, dt: float) -> None:
        for kind, policy in self._workload:
            if kind == "local":
                for shard in self.shards:
                    policy.step_shard(shard.clients, t, dt)
            else:                       # hooks (and fleet oddities): barrier
                policy(sim.clients, t, dt)
        if self.device_fleet is not None:
            # shard -> device: a plan per device, partials merged on the
            # primary device, one resolve, device-local commits.
            # Throughput accounting comes off the returned totals, so no
            # per-interval fleet-state pull happens.
            fleet = self.device_fleet
            self._device_totals = fleet.host_totals(fleet.step(t, dt))
        elif sim.core is not None:
            # SoA: one PlanBatch per shard; resolve_phase merges the
            # shards' demands back into canonical client order by demand
            # ordinal, so the shared OST queues see the exact
            # single-process float order
            batches = []
            for shard in self.shards:
                delay = self.straggler_delay_s.get(shard.sid)
                if delay:
                    time.sleep(delay)
                batches.append(sim.plan_phase(shard.clients, t, dt))
            fb = sim.resolve_phase(batches, dt)
            for shard, pb in zip(self.shards, batches):
                sim.commit_phase(shard.clients, pb, fb, dt)
        else:
            plans: Dict[int, object] = {}
            for shard in self.shards:
                delay = self.straggler_delay_s.get(shard.sid)
                if delay:
                    time.sleep(delay)
                for c, pl in zip(shard.clients,
                                 sim.plan_phase(shard.clients, t, dt)):
                    plans[c.client_id] = pl
            # barrier: canonical client order into the one shared cluster —
            # per-OST accumulation is float-order-sensitive
            fb = sim.resolve_phase([plans[c.client_id]
                                    for c in sim.clients], dt)
            for shard in self.shards:
                sim.commit_phase(shard.clients,
                                 [plans[c.client_id]
                                  for c in shard.clients],
                                 fb, dt)
        sim.t += dt
        t = sim.t
        for shard in self.shards:
            shard.interval += 1
            shard.t = sim.t
        now = self.shards[0].interval
        with _telemetry().span("tune_round", cat="runtime"):
            for pid, (kind, policy) in enumerate(self._tune):
                if kind == "local":
                    for shard in self.shards:
                        policy.step_shard(shard.clients, t, dt)
                elif kind == "fleet":
                    self._fleet_round(pid, policy, now, t, dt,
                                      shards=self.shards, barrier=True)
                else:
                    policy(sim.clients, t, dt)
        for shard in self.shards:
            self._record_interval(shard)

    # ----------------------------------------------------------- bus rounds
    def _publish_shard_traffic(self, pid: int, policy, shard: Shard,
                               t: float, dt: float) -> None:
        """Shard side of a fleet policy's interval: observations out,
        pending stage-2 requests out (deduplicated while in flight)."""
        for cid, obs in policy.shard_observe(shard.clients, t, dt):
            self.bus.publish(f"obs/{pid}", shard.sid, shard.interval,
                             (cid, obs))
        inflight = shard.inflight.setdefault(pid, set())
        for key, req in policy.shard_collect(shard.clients, t):
            if key in inflight:
                continue
            inflight.add(key)
            self.bus.publish(f"s2req/{pid}", shard.sid, shard.interval,
                             (key, req))

    def _coordinate_policy(self, pid: int, policy, now: int,
                           t: float) -> bool:
        """Coordinator side: gather fresh observations -> decisions, and
        answer stage-2 requests. Returns True if any traffic moved."""
        moved = False
        msgs = self.bus.consume(f"obs/{pid}", now=now,
                                max_staleness=self.max_staleness)
        if msgs:
            moved = True
            for cid, dec in policy.bus_decide([m.payload for m in msgs], t):
                self.bus.publish(f"dec/{pid}/{self._shard_of[cid]}",
                                 COORDINATOR, now, (cid, dec))
        # request/reply traffic is never staleness-dropped: an unanswered
        # arbiter would stay pending (and inflight) forever
        reqs = self.bus.consume(f"s2req/{pid}")
        if reqs:
            moved = True
            route = {m.payload[0]: m.shard for m in reqs}
            with _telemetry().span("policy.stage2", cat="policy"):
                replies = policy.bus_resolve([m.payload for m in reqs], t)
            for key, rep in replies:
                self.bus.publish(f"s2rep/{pid}/{route[key]}", COORDINATOR,
                                 now, (key, rep))
        return moved

    def _drain_shard_inbox(self, pid: int, policy, shard: Shard,
                           t: float) -> None:
        msgs = self.bus.consume(f"dec/{pid}/{shard.sid}")
        if msgs:
            policy.shard_actuate(shard.clients,
                                 [m.payload for m in msgs], t)
        reps = self.bus.consume(f"s2rep/{pid}/{shard.sid}")
        if reps:
            payloads = [m.payload for m in reps]
            policy.shard_apply(payloads, t)
            inflight = shard.inflight.setdefault(pid, set())
            inflight.difference_update(k for k, _ in payloads)

    def _fleet_round(self, pid: int, policy, now: int, t: float, dt: float,
                     shards: Sequence[Shard], barrier: bool) -> None:
        """One complete bus round (sync mode): every shard publishes, the
        coordinator decides over the full gather, every shard applies —
        all within the barrier, so decisions land this interval exactly
        like the single-process ``step``."""
        for shard in shards:
            self._publish_shard_traffic(pid, policy, shard, t, dt)
        self._coordinate_policy(pid, policy, now, t)
        for shard in shards:
            self._drain_shard_inbox(pid, policy, shard, t)

    # ----------------------------------------------------------- async mode
    def _shard_loop(self, shard: Shard, n_steps: int,
                    errors: List[BaseException]) -> None:
        sim = self.sim
        dt = sim.interval_s
        delay = self.straggler_delay_s.get(shard.sid, 0.0)
        # async: contention against a per-shard cluster replica fed by the
        # other shards' (bounded-stale) demand echoes
        shard.cluster = PFSCluster(sim.p,
                                   sim.rng.fork(f"shard{shard.sid}"))
        try:
            for _ in range(n_steps):
                with _telemetry().span(f"shard{shard.sid}.interval",
                                       cat="runtime"):
                    self._shard_interval(shard, sim, dt, delay)
        except BaseException as e:          # surface on the caller thread
            errors.append(e)

    def _shard_interval(self, shard: Shard, sim, dt: float,
                        delay: float) -> None:
        t = shard.t
        for pid, (kind, policy) in enumerate(self._tune):
            if kind == "fleet":
                self._drain_shard_inbox(pid, policy, shard, t)
        for kind, policy in self._workload:
            policy.step_shard(shard.clients, t, dt)
        plans = sim.plan_phase(shard.clients, t, dt)
        if sim.core is not None:
            own = plans.demand_batch()
            self.bus.publish("demand", shard.sid, shard.interval,
                             own, retain=True)
            echoes = self.bus.latest(
                "demand", now=shard.interval,
                max_staleness=self.max_staleness,
                exclude_shard=shard.sid)
            echo = [m.payload for m in
                    sorted(echoes, key=lambda m: str(m.shard))]
            # concat (not merge): own demands first, echoes after,
            # matching the scalar `demands + echo` arrival order
            fb = shard.cluster.resolve_batch(
                DemandBatch.concat([own] + echo), dt)
        else:
            demands = [d for pl in plans for d in pl.all_demands()]
            self.bus.publish("demand", shard.sid, shard.interval,
                             demands, retain=True)
            echoes = self.bus.latest(
                "demand", now=shard.interval,
                max_staleness=self.max_staleness,
                exclude_shard=shard.sid)
            echo = [d for m in
                    sorted(echoes, key=lambda m: str(m.shard))
                    for d in m.payload]
            fb = shard.cluster.resolve(demands + echo, dt)
        sim.commit_phase(shard.clients, plans, fb, dt)
        shard.t += dt
        shard.interval += 1
        t = shard.t
        if delay:
            time.sleep(delay)       # injected slow node
        for pid, (kind, policy) in enumerate(self._tune):
            if kind == "local":
                policy.step_shard(shard.clients, t, dt)
            else:
                self._publish_shard_traffic(pid, policy, shard,
                                            t, dt)
        self._record_interval(shard)

    def _run_async(self, n_steps: int) -> None:
        errors: List[BaseException] = []
        threads = [threading.Thread(target=self._shard_loop,
                                    args=(shard, n_steps, errors),
                                    name=f"shard-{shard.sid}", daemon=True)
                   for shard in self.shards]
        for th in threads:
            th.start()
        dt = self.sim.interval_s
        # coordinator: never waits on any one shard — decides over
        # whatever fresh traffic has arrived at the fleet's leading edge
        while any(th.is_alive() for th in threads):
            now = max(s.interval for s in self.shards)
            moved = False
            for pid, (kind, policy) in enumerate(self._tune):
                if kind == "fleet":
                    moved |= self._coordinate_policy(pid, policy, now,
                                                     now * dt)
            if not moved:
                self.bus.wait(0.002)
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        # final pass: answer anything published by the last intervals so
        # no request is left dangling (replies may go unapplied — the run
        # is over, matching a real shutdown)
        now = max(s.interval for s in self.shards)
        for pid, (kind, policy) in enumerate(self._tune):
            if kind == "fleet":
                self._coordinate_policy(pid, policy, now, now * dt)
