"""Cross-process fleet execution: spawn/join shard workers around a bus.

:class:`ProcessRuntime` drives a built scalar-backend
:class:`~repro_torch.storage.sim.Simulation` as a fleet of **worker
processes** — one per shard — coordinated by the parent over a
:class:`~repro_torch.core.runtime.bus.TuningBus` transport (``"pipe"`` =
:class:`~repro_torch.core.runtime.transport.process_bus.MultiprocessBus`,
``"socket"`` = :class:`~repro_torch.core.runtime.transport.socket_bus.
SocketBusHost` + per-worker :class:`SocketBus` clients). Workers are
spawned (never forked) from one pickle of the assembled simulation, so
every process starts from byte-identical state; all cross-process
traffic rides the bus and passes the ``transport.wire`` purity gate.

``mode="sync"`` — decision-identical to one process
    Workers advance the plan half of each interval and publish their
    per-client offered demands on ``plan``; the parent reassembles them
    in canonical ``sim.clients`` order and resolves against **its own**
    cluster (the one float-order- and RNG-sensitive phase stays in one
    process), returning feedback on ``fb/{sid}``. Tune rounds then run
    the split ``TuningPolicy`` bus protocol with a barrier per policy:
    each worker publishes observations/requests plus a ``sync/{pid}``
    marker, the parent decides once over the full gather, answers, and
    releases the workers with ``done/{pid}/{sid}`` markers.
    ``tests/test_torch_transport.py`` holds this bit-identical to the
    single-process ``Simulation.run`` of the port and of the reference
    package.

``mode="async"`` — free-running cadence
    Workers run the in-process async shard loop verbatim (per-shard
    cluster replicas, retained demand echoes, bounded-staleness
    gathers) against their bus endpoint, heartbeating a retained ``hb``
    topic; the parent coordinates continuously at the fleet's leading
    edge, exactly like the threaded coordinator. The healthy-shard
    cadence-under-straggler gate carries over.

Fault tolerance and elasticity (sync mode):

* every ``snapshot_every`` intervals each worker publishes a retained
  ``snap/{sid}`` blob — its clients, per-client policy state
  (:meth:`~repro_torch.core.policies.base.TuningPolicy.shard_state`), series
  accounting, and stage-2 in-flight keys, pickled as **one graph** so
  controller↔client identity survives;
* a worker that dies without a report (:class:`KillShard` injection,
  OOM) is respawned from its latest snapshot and **replays** forward.
  The parent re-serves cached resolve feedback and cached tune-round
  messages for already-coordinated intervals, drops the replayed
  duplicate observations (staleness bound 0 at the sync barrier plus
  per-client dedup), and the replay is deterministic — so the rejoined
  shard lands exactly where the fleet is, with nothing double-applied
  and nothing lost;
* :class:`Repartition` re-meshes the fleet mid-run: the parent signals
  a cooperative yield through the previous interval's feedback barrier,
  workers report and exit at the interval boundary, reports merge into
  the parent's simulation (clients + policy state + stitched series),
  and a fresh partition of worker processes resumes from the merged
  state.

Where the GBDT kernels run: the policy's ``device`` decides, in every
process. The parent's ``bus_decide`` scores each gathered probe batch
(``gbdt_grid_logits``); a worker's shells take each bootstrap pick after
a re-probe inside ``shard_observe`` (``gbdt_logits``), as the
reference's workers do in NumPy. So a worker of a ``device="cuda"``
policy opens its own CUDA context and launches that kernel there.
Launch counters are per process: each worker's report carries its own
kernel launch counts, which the parent sums into ``worker_launches``
(with telemetry on, its ``carat.bootstrap`` counter shows the same
picks, one per call). A worker that cannot set up or launch on its
device reports its traceback and ``run()`` raises: nothing falls back
to the CPU. The scorers pickle as their host model and the name
of their device and repack on load (``kernels/gbdt_infer/ops.py``), so
no pickle of the sim or of a shard blob carries a torch storage.
Workers are spawned, never forked: a fork after the parent's CUDA
context exists is undefined.

A runtime instance is single-use: ``run()`` owns the worker lifecycle
and closes the hub on exit. Caches grow O(intervals) per run — bounded
by ``run(duration_s)``, which is sized in minutes, not days.
"""
from __future__ import annotations

import multiprocessing as mp
import pickle
import sys
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

from repro_torch.core.runtime.bus import COORDINATOR, TuningBus
from repro_torch.core.runtime.sharded import Shard, ShardedRuntime
from repro_torch.core.runtime.telemetry.clock import estimate_offset, perf_s
from repro_torch.core.runtime.telemetry.collect import FleetCollector
from repro_torch.core.runtime.telemetry.recorder import (
    Recorder, active as _active_rec, disable as _disable_rec,
    enable as _enable_rec)
from repro_torch.core.runtime.transport.process_bus import MultiprocessBus
from repro_torch.core.runtime.transport.socket_bus import (SocketBus,
                                                           SocketBusHost)
from repro_torch.storage.pfs import ClusterFeedback
from repro_torch.storage.sim import SimResult, Simulation

__all__ = ["ProcessRuntime", "KillShard", "Repartition"]


# --------------------------------------------------------------- events
@dataclass(frozen=True)
class KillShard:
    """Failure injection: SIGKILL shard ``sid``'s worker once it has
    completed ``at_interval`` intervals, then respawn it from its latest
    retained snapshot (or the segment base) and let it replay back to
    the fleet."""
    at_interval: int
    sid: int


@dataclass(frozen=True)
class Repartition:
    """Elasticity: once every shard has completed ``at_interval``
    intervals, merge the fleet into the parent and respawn it as
    ``n_shards`` fresh worker processes (client churn re-partitions the
    node groups round-robin). Needs ``at_interval >= 1`` — the yield is
    signalled through the previous interval's feedback barrier."""
    at_interval: int
    n_shards: int


# --------------------------------------------------------- worker side
class _Yield(Exception):
    """Cooperative exit: the parent asked this worker to report and
    leave (repartition)."""


@dataclass
class _WorkerSpec:
    """Everything a spawned worker needs besides the sim pickle."""
    sid: int
    mode: str
    n_steps: int
    start_interval: int
    n_shards: Optional[int]
    shard_map: Optional[dict]
    max_staleness: int
    straggler_delay_s: float
    snapshot_every: int
    timeout_s: float
    hb_every_s: float
    telemetry: bool = False
    telemetry_capacity: int = 8192


def _policy_slots(rt: ShardedRuntime) -> List[tuple]:
    return ([("workload", i, p) for i, (_, p) in enumerate(rt._workload)]
            + [("tune", i, p) for i, (_, p) in enumerate(rt._tune)])


def _kernel_launches() -> Dict[str, int]:
    """This process's kernel launches so far: the ``launches`` counters
    of the port's kernel modules it has imported (a module it never
    imported launched nothing)."""
    out: Dict[str, int] = {}
    for name, mod in list(sys.modules.items()):
        if (name.startswith("repro_torch.kernels.")
                and name.endswith(".kernel")):
            out.update(getattr(mod, "launches", {}))
    return out


def _shard_blob(rt: ShardedRuntime, shard: Shard) -> bytes:
    """One shard's complete portable state — snapshot and final report
    share this format. A single ``pickle.dumps`` over clients *and*
    policy state preserves the controller.client identity edges."""
    cids = shard.client_ids
    policies = {}
    for phase, i, p in _policy_slots(rt):
        fn = getattr(p, "shard_state", None)
        policies[(phase, i)] = fn(cids) if fn is not None else None
    return pickle.dumps({
        "sid": shard.sid,
        "interval": shard.interval,
        "t": shard.t,
        "sim_t": rt.sim.t,
        "clients": list(shard.clients),
        "policies": policies,
        "series": [list(s) for s in shard.series],
        "prev": list(shard._prev),
        "step_walls": list(shard.step_walls),
        "inflight": {pid: set(s) for pid, s in shard.inflight.items()},
        "launches": _kernel_launches(),
        "error": None,
    })


def _merge_blob(rt: ShardedRuntime, data: dict,
                shard: Optional[Shard] = None) -> None:
    """Install a shard blob into this process's sim + policies. With
    ``shard`` (worker restore) also rewinds the shard's loop state; the
    parent's report merge passes ``shard=None`` and keeps its own
    clock/series accounting."""
    sim = rt.sim
    pos = {c.client_id: i for i, c in enumerate(sim.clients)}
    for c in data["clients"]:
        sim.clients[pos[c.client_id]] = c
        sim._by_id[c.client_id] = c
    for phase, i, p in _policy_slots(rt):
        state = data["policies"].get((phase, i))
        fn = getattr(p, "merge_shard_state", None)
        if fn is not None and state is not None:
            fn(state)
    if shard is not None:
        cids = {c.client_id for c in data["clients"]}
        shard.clients = [c for c in sim.clients if c.client_id in cids]
        shard.interval = int(data["interval"])
        shard.t = float(data["t"])
        sim.t = float(data["sim_t"])
        shard.series = [list(s) for s in data["series"]]
        shard._prev = list(data["prev"])
        shard.step_walls = list(data["step_walls"])
        shard.inflight = {pid: set(s)
                          for pid, s in data["inflight"].items()}


def _check_ctl(bus: TuningBus, shard: Shard) -> None:
    for m in bus.consume(f"ctl/{shard.sid}"):
        if m.payload == "yield":
            raise _Yield


def _await_msg(bus: TuningBus, topic: str, want_interval: int,
               timeout_s: float, what: str):
    """Block until a message for exactly ``want_interval`` arrives on
    ``topic``. Replay re-serves can race ahead of a slow consumer, so
    non-matching (older) messages are discarded, never an error."""
    deadline = time.monotonic() + timeout_s
    while True:
        hit = None
        for m in bus.consume(topic):
            if m.interval == want_interval:
                hit = m
        if hit is not None:
            return hit
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"worker timed out after {timeout_s:.0f}s waiting for "
                f"{what} (interval {want_interval}) on {topic!r}")
        bus.wait(0.005)


def _clock_handshake(bus: TuningBus, rec: Recorder, sid: int,
                     timeout_s: float) -> None:
    """Estimate this worker's clock offset against the coordinator.

    NTP-style over the bus: each ping publishes a ``clk`` marker and
    waits for the parent's ``clkr/{sid}`` reply carrying its
    ``perf_s()`` reading; :func:`estimate_offset` keeps the
    minimum-RTT sample. The offset rides on every drained batch so the
    exporters can place this worker's spans on the coordinator
    timeline."""
    seq = [0]

    def ping():
        k, seq[0] = seq[0], seq[0] + 1
        t_send = rec.clock.now()
        bus.publish("clk", sid, k, None)
        m = _await_msg(bus, f"clkr/{sid}", k, timeout_s, "clock reply")
        t_recv = rec.clock.now()
        return t_send, t_recv, float(m.payload)

    rec.clock.offset_s = estimate_offset(ping, samples=3)


def _drain_dedup(bus: TuningBus, rt: ShardedRuntime, pid: int, policy,
                 shard: Shard, t: float) -> None:
    """The worker-side inbox drain, deduplicated by client id / request
    key: after a crash-replay the store can hold both the original and
    the re-served copy of a decision — applying both would double-append
    decision logs. Replay is deterministic, so keep-latest is exact."""
    msgs = bus.consume(f"dec/{pid}/{shard.sid}")
    if msgs:
        seen: Dict[object, tuple] = {}
        for m in msgs:
            seen[m.payload[0]] = m.payload
        policy.shard_actuate(shard.clients, list(seen.values()), t)
    reps = bus.consume(f"s2rep/{pid}/{shard.sid}")
    if reps:
        seen = {}
        for m in reps:
            seen[m.payload[0]] = m.payload
        payloads = list(seen.values())
        policy.shard_apply(payloads, t)
        inflight = shard.inflight.setdefault(pid, set())
        inflight.difference_update(k for k, _ in payloads)


def _worker_sync_loop(bus: TuningBus, rt: ShardedRuntime, shard: Shard,
                      spec: _WorkerSpec) -> None:
    """The worker half of the sync barrier protocol (module docstring).
    Mirrors ``ShardedRuntime._sync_step`` exactly, with the resolve
    phase swapped for a plan-publish / feedback round trip."""
    sim = rt.sim
    dt = sim.interval_s
    while shard.interval < spec.n_steps:
        _check_ctl(bus, shard)
        k = shard.interval
        t = sim.t
        for _kind, policy in rt._workload:
            policy.step_shard(shard.clients, t, dt)
        if spec.straggler_delay_s:
            time.sleep(spec.straggler_delay_s)   # injected slow node
        plans = sim.plan_phase(shard.clients, t, dt)
        bus.publish("plan", shard.sid, k,
                    [(c.client_id, pl.all_demands())
                     for c, pl in zip(shard.clients, plans)])
        m = _await_msg(bus, f"fb/{shard.sid}", k, spec.timeout_s,
                       "resolve feedback")
        scale, waits = m.payload
        sim.commit_phase(shard.clients, plans,
                         ClusterFeedback(scale, waits), dt)
        sim.t += dt
        shard.interval += 1
        shard.t = sim.t
        t = sim.t
        now = shard.interval
        for pid, (kind, policy) in enumerate(rt._tune):
            if kind == "local":
                policy.step_shard(shard.clients, t, dt)
            else:
                rt._publish_shard_traffic(pid, policy, shard, t, dt)
                bus.publish(f"sync/{pid}", shard.sid, now, None)
                _await_msg(bus, f"done/{pid}/{shard.sid}", now,
                           spec.timeout_s, f"tune round (policy {pid})")
                _drain_dedup(bus, rt, pid, policy, shard, t)
        rt._record_interval(shard)
        bus.beat(now)
        rec = _active_rec()
        if rec.enabled:
            bus.publish("telem", shard.sid, now, rec.drain())
        if spec.snapshot_every and now % spec.snapshot_every == 0:
            bus.publish(f"snap/{shard.sid}", shard.sid, now,
                        _shard_blob(rt, shard), retain=True)


def _worker_async_loop(bus: TuningBus, rt: ShardedRuntime, shard: Shard,
                       spec: _WorkerSpec) -> None:
    """Async mode: the in-process shard loop verbatim, plus a heartbeat
    thread publishing the retained ``hb`` marker the parent coordinates
    against."""
    stop = threading.Event()

    def _hb() -> None:
        while not stop.is_set():
            try:
                bus.publish("hb", shard.sid, shard.interval, None,
                            retain=True)
                bus.beat(shard.interval)
                rec = _active_rec()
                if rec.enabled:
                    # free-running shards drain on the heartbeat cadence
                    # (the sync loop drains per interval instead)
                    bus.publish("telem", shard.sid, shard.interval,
                                rec.drain())
            except Exception:
                return                       # hub gone; main loop will see
            stop.wait(spec.hb_every_s)

    th = threading.Thread(target=_hb, name=f"hb-{shard.sid}", daemon=True)
    th.start()
    errors: List[BaseException] = []
    try:
        rt._shard_loop(shard, spec.n_steps - shard.interval, errors)
    finally:
        stop.set()
        th.join(timeout=2.0)
    if errors:
        raise errors[0]
    # final beat so the parent's leading edge reaches n_steps
    bus.publish("hb", shard.sid, shard.interval, None, retain=True)


def _worker_main(endpoint: TuningBus, spec: _WorkerSpec, sim_bytes: bytes,
                 snap_bytes: Optional[bytes]) -> None:
    """Spawn target: rebuild the simulation from the parent's pickle,
    optionally restore a snapshot blob, run this shard's loop, publish a
    report blob (or a traceback on failure)."""
    try:
        if spec.telemetry:
            rec = _enable_rec(source=f"w{spec.sid}",
                              capacity=spec.telemetry_capacity)
            _clock_handshake(endpoint, rec, spec.sid, spec.timeout_s)
        sim = pickle.loads(sim_bytes)
        rt = ShardedRuntime(
            sim, mode=spec.mode,
            max_staleness_intervals=spec.max_staleness,
            n_shards=spec.n_shards, shard_map=spec.shard_map,
            straggler_delay_s=({spec.sid: spec.straggler_delay_s}
                               if spec.mode == "async"
                               and spec.straggler_delay_s else None),
            bus=endpoint)
        shard = next(s for s in rt.shards if s.sid == spec.sid)
        rt._start_accounting()
        shard.interval = spec.start_interval
        if spec.mode == "sync":
            shard.t = sim.t
        if snap_bytes is not None:
            _merge_blob(rt, pickle.loads(snap_bytes), shard)
        try:
            if spec.mode == "sync":
                _worker_sync_loop(endpoint, rt, shard, spec)
            else:
                _worker_async_loop(endpoint, rt, shard, spec)
        except _Yield:
            pass                             # report current state below
        rec = _active_rec()
        if rec.enabled:
            # final drain *before* the report: pipe/socket ordering means
            # once the parent has the report, this batch is already in
            # the store — one post-report sweep collects it
            endpoint.publish("telem", shard.sid, shard.interval,
                             rec.drain())
        endpoint.publish("report", shard.sid, shard.interval,
                         _shard_blob(rt, shard))
    except BaseException:
        try:
            endpoint.publish("report", spec.sid, 0, pickle.dumps(
                {"sid": spec.sid, "error": traceback.format_exc()}))
        except BaseException:
            pass                             # hub gone too; parent will see
    finally:
        try:
            endpoint.close()
        except BaseException:
            pass


# --------------------------------------------------------- parent side
class ProcessRuntime:
    """Drive a scalar-backend Simulation as a fleet of worker processes
    (module docstring). Single-use: construct, ``run()``, read results.

    ``transport`` — ``"pipe"`` (multiprocessing pipes; default) or
    ``"socket"`` (loopback TCP; ``host_address=(host, port)`` overrides
    the bind, ``port=0`` = ephemeral).
    ``events`` — :class:`KillShard` / :class:`Repartition` instances,
    fired once the fleet completes ``at_interval`` intervals (sync mode
    only). ``snapshot_every=0`` disables snapshots (a killed shard then
    replays from the segment base). Straggler injection does not survive
    a :class:`Repartition` — shard ids are re-meshed.
    """

    def __init__(
        self,
        sim: Simulation,
        mode: str = "sync",
        transport: str = "pipe",
        max_staleness_intervals: int = 2,
        n_shards: Optional[int] = None,
        shard_map: Optional[Mapping[object, int]] = None,
        straggler_delay_s: Optional[Mapping[int, float]] = None,
        events: Sequence[object] = (),
        snapshot_every: int = 1,
        auto_restore: bool = True,
        max_respawns: int = 3,
        barrier_timeout_s: float = 120.0,
        host_address: Optional[Tuple[str, int]] = None,
        telemetry: bool = False,
        telemetry_capacity: int = 8192,
        flight_dir: Optional[str] = None,
        flight_intervals: int = 8,
    ):
        if sim.core is not None:
            raise ValueError(
                f"ProcessRuntime drives the scalar backend only, got "
                f"backend={sim.backend!r}: build the simulation with "
                f"backend='scalar' (the 'soa' and 'soa-torch' fleets run "
                f"in-process under ShardedRuntime)")
        if mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async', got {mode!r}")
        if transport not in ("pipe", "socket"):
            raise ValueError(f"transport must be 'pipe' or 'socket', "
                             f"got {transport!r}")
        self.sim = sim
        self.mode = mode
        self.transport = transport
        self.max_staleness = int(max_staleness_intervals)
        self.straggler_delay_s = dict(straggler_delay_s or {})
        self.snapshot_every = int(snapshot_every)
        self.auto_restore = bool(auto_restore)
        self.max_respawns = int(max_respawns)
        self.barrier_timeout_s = float(barrier_timeout_s)
        # telemetry: workers record into per-process rings and drain over
        # the bus; the collector aggregates, exports traces, and feeds
        # the flight recorder (flight_dir enables postmortem dumps)
        self._telemetry_capacity = int(telemetry_capacity)
        self.telemetry: Optional[FleetCollector] = (
            FleetCollector(flight_dir=flight_dir,
                           flight_intervals=flight_intervals)
            if (telemetry or flight_dir) else None)
        self._parent_rec_installed = False
        self._n_shards_arg = n_shards
        self._shard_map_arg = (dict(shard_map) if shard_map is not None
                               else None)
        self.ctx = mp.get_context("spawn")
        if transport == "pipe":
            self.hub: TuningBus = MultiprocessBus(ctx=self.ctx)
        else:
            host, port = host_address or ("127.0.0.1", 0)
            self.hub = SocketBusHost(host=host, port=port)
        self.bus = self.hub
        # the parent's own runtime: partition bookkeeping + the
        # coordinator halves of the bus protocol (it never steps shards)
        self.rt = ShardedRuntime(
            sim, mode="sync", max_staleness_intervals=self.max_staleness,
            n_shards=n_shards, shard_map=self._shard_map_arg,
            straggler_delay_s=straggler_delay_s, bus=self.hub)
        for kind, p in self.rt._workload:
            if kind != "local":
                raise ValueError(
                    f"process mode runs every policy behind the bus; "
                    f"workload policy {p!r} must declare gather='none' "
                    f"with step_shard")
        for kind, p in self.rt._tune:
            if kind == "hook":
                raise ValueError(
                    f"process mode needs bus-capable tune policies; {p!r} "
                    f"is a plain (clients, t, dt) hook — wrap it in a "
                    f"TuningPolicy")
        self._fleet_pids = [pid for pid, (k, _) in enumerate(self.rt._tune)
                            if k == "fleet"]
        for ev in events:
            if mode != "sync":
                raise ValueError(
                    "failure/elasticity events need mode='sync' (async "
                    "workers free-run; there is no barrier to replay to)")
            if isinstance(ev, KillShard):
                if ev.at_interval < 0:
                    raise ValueError(f"KillShard.at_interval must be >= 0, "
                                     f"got {ev.at_interval}")
            elif isinstance(ev, Repartition):
                if ev.at_interval < 1:
                    raise ValueError(
                        "Repartition needs at_interval >= 1 (the yield is "
                        "signalled through the previous interval's barrier)")
                if ev.n_shards < 1:
                    raise ValueError("Repartition.n_shards must be >= 1")
            else:
                raise TypeError(f"unknown event {ev!r}; expected KillShard "
                                f"or Repartition")
        # KillShard sids are validated at fire time: a Repartition earlier
        # in the schedule legitimately re-meshes the id space
        self.events = sorted(events, key=lambda e: e.at_interval)

    # ---------------------------------------------------------- lifecycle
    def run(self, duration_s: float) -> SimResult:
        sim = self.sim
        n_steps = int(round(duration_s / sim.interval_s))
        for ev in self.events:
            if ev.at_interval >= n_steps:
                raise ValueError(f"{ev} fires at or after the run's last "
                                 f"interval ({n_steps})")
        self._n_steps = n_steps
        self._start_read = [c.stats.read.app_bytes for c in sim.clients]
        self._start_write = [c.stats.write.app_bytes for c in sim.clients]
        self._series: Dict[int, List[float]] = {c.client_id: []
                                                for c in sim.clients}
        self._walls: Dict[int, List[float]] = {}
        self._reports: Dict[int, dict] = {}
        self._respawns: Dict[int, int] = {}
        # each worker start: (shard id, interval of the snapshot it
        # restored, or None); and the kernel launches of every worker
        # that reported, summed by kernel
        self.spawns: List[Tuple[int, Optional[int]]] = []
        self.worker_launches: Dict[str, int] = {}
        self._procs: Dict[int, mp.process.BaseProcess] = {}
        self._segment_base = 0
        self._fb_cache: Dict[int, tuple] = {}
        self._round_cache: Dict[tuple, List[tuple]] = {}
        self._plan_inbox: Dict[int, Dict[int, list]] = {}
        self._sync_seen: Dict[tuple, Set[int]] = {}
        if self.transport == "pipe":
            self.hub.start()
        if self.telemetry is not None and not _active_rec().enabled:
            # coordinator-side spans (resolve, coordinate rounds) join
            # the fleet trace; restored in _shutdown
            _enable_rec(source="coord", capacity=self._telemetry_capacity)
            self._parent_rec_installed = True
        self._sim_bytes = pickle.dumps(sim)
        try:
            for s in self.rt.shards:
                self._spawn(s.sid, 0)
            if self.mode == "sync":
                self._run_sync(n_steps)
            else:
                self._run_async(n_steps)
            self._await_reports()
            # workers drain before reporting, so one sweep after the
            # report barrier collects every final batch
            self._serve_telemetry()
            if self.telemetry is not None and _active_rec().enabled:
                self.telemetry.add(_active_rec().drain())
            for sid in sorted(self._reports):
                self._merge_report(self._reports.pop(sid))
        finally:
            self._shutdown()
        return self._result(n_steps)

    def _spawn(self, sid: int, start_interval: int,
               snap_bytes: Optional[bytes] = None,
               snap_interval: Optional[int] = None) -> None:
        if self.transport == "pipe":
            ep = self.hub.endpoint(sid)
        else:
            ep = SocketBus(self.hub.address, peer=sid,
                           authkey=self.hub.authkey)
        spec = _WorkerSpec(
            sid=sid, mode=self.mode, n_steps=self._n_steps,
            start_interval=start_interval,
            n_shards=self._n_shards_arg, shard_map=self._shard_map_arg,
            max_staleness=self.max_staleness,
            straggler_delay_s=self.straggler_delay_s.get(sid, 0.0),
            snapshot_every=self.snapshot_every,
            timeout_s=self.barrier_timeout_s, hb_every_s=0.2,
            telemetry=self.telemetry is not None,
            telemetry_capacity=self._telemetry_capacity)
        p = self.ctx.Process(target=_worker_main,
                             args=(ep, spec, self._sim_bytes, snap_bytes),
                             name=f"shard-{sid}", daemon=True)
        p.start()
        if self.transport == "pipe":
            ep._conn.close()                 # the child owns this end now
        self._procs[sid] = p
        self.spawns.append((sid, snap_interval))

    def _respawn(self, sid: int) -> None:
        snap, at = None, None
        for m in self.bus.latest(f"snap/{sid}"):
            # a blob from at or before the segment base describes the
            # previous mesh (repartition re-keys the shard id space);
            # installing it would resurrect an old client partition
            if m.payload is not None and m.interval > self._segment_base:
                snap, at = m.payload, m.interval
        self._spawn(sid, self._segment_base, snap_bytes=snap,
                    snap_interval=at)

    def _shutdown(self) -> None:
        for p in self._procs.values():
            if p.is_alive():
                p.kill()
        for p in self._procs.values():
            p.join(timeout=5.0)
        self.hub.close()
        if self._parent_rec_installed:
            _disable_rec()
            self._parent_rec_installed = False

    def _serve_telemetry(self) -> None:
        """Serve clock-handshake pings and collect drained batches —
        called from every parent wait loop. No-op with telemetry off
        (workers then never publish on these topics)."""
        if self.telemetry is None:
            return
        bus = self.bus
        for m in bus.consume("clk"):
            bus.publish(f"clkr/{m.shard}", COORDINATOR, m.interval,
                        perf_s())
        for m in bus.consume("telem"):
            self.telemetry.add(m.payload)

    # ---------------------------------------------------------- sync mode
    def _run_sync(self, n_steps: int) -> None:
        sim = self.sim
        dt = sim.interval_s
        bus = self.bus
        events = list(self.events)
        k = 0
        while k < n_steps:
            while events and events[0].at_interval == k:
                ev = events.pop(0)
                if isinstance(ev, KillShard):
                    self._fire_kill(ev)
                else:
                    self._fire_repartition(ev, k)
            plans = self._gather_plans(k)
            demands = []
            for c in sim.clients:
                demands.extend(plans[self.rt._shard_of[c.client_id]]
                               .get(c.client_id, ()))
            # the one globally-coupled phase stays in the parent: same
            # float order, same cluster RNG trajectory as one process
            with _active_rec().span("resolve", cat="sim"):
                fb = sim.cluster.resolve(demands, dt)
            self._fb_cache[k] = (fb.scale_arr, fb.waits_arr)
            yield_next = any(isinstance(e, Repartition)
                             and e.at_interval == k + 1 for e in events)
            for sid in sorted(self._procs):
                if yield_next:
                    # ordered before fb: a worker cannot start interval
                    # k+1 without consuming fb k, so the yield is seen
                    # at the k+1 loop top — never mid-interval
                    bus.publish(f"ctl/{sid}", COORDINATOR, k, "yield")
                bus.publish(f"fb/{sid}", COORDINATOR, k, self._fb_cache[k])
            sim.t += dt
            now = k + 1
            for pid in self._fleet_pids:
                _kind, policy = self.rt._tune[pid]
                self._await_sync(pid, now)
                self._coordinate_round(pid, policy, now, sim.t)
            rec = _active_rec()
            if rec.enabled:
                rec.set_interval(now)        # coord counter timeline
            k += 1

    def _gather_plans(self, k: int) -> Dict[int, dict]:
        deadline = time.monotonic() + self.barrier_timeout_s
        while True:
            self._pump()
            have = self._plan_inbox.get(k, {})
            if set(self._procs) <= set(have):
                self._plan_inbox.pop(k, None)
                return {sid: dict(payload) for sid, payload in have.items()}
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"timed out gathering plans for interval {k}: have "
                    f"{sorted(have)}, want {sorted(self._procs)}")
            self.bus.wait(0.005)

    def _await_sync(self, pid: int, now: int) -> None:
        deadline = time.monotonic() + self.barrier_timeout_s
        while True:
            self._pump()
            if set(self._procs) <= self._sync_seen.get((pid, now), set()):
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"timed out at the tune barrier (policy {pid}, "
                    f"interval {now}): have "
                    f"{sorted(self._sync_seen.get((pid, now), set()))}, "
                    f"want {sorted(self._procs)}")
            self.bus.wait(0.005)

    def _coordinate_round(self, pid: int, policy, now: int,
                          t: float) -> None:
        """The parent half of one sync tune round, with every outbound
        message cached so a crash-replaying worker can be re-served the
        exact round it missed."""
        bus = self.bus
        recs = self._round_cache.setdefault((pid, now), [])
        # staleness bound 0: an observation replayed from an interval the
        # fleet already coordinated is dropped here (its decision lives
        # in the round cache); same-interval duplicates — worker died
        # after observing but before the round closed — dedup by client,
        # which is exact because the replay is deterministic
        fresh: Dict[int, tuple] = {}
        for m in bus.consume(f"obs/{pid}", now=now, max_staleness=0):
            fresh[m.payload[0]] = m.payload
        if fresh:
            for cid, dec in policy.bus_decide(list(fresh.values()), t):
                topic = f"dec/{pid}/{self.rt._shard_of[cid]}"
                bus.publish(topic, COORDINATOR, now, (cid, dec))
                recs.append((topic, now, (cid, dec)))
        reqs: Dict[object, tuple] = {}
        for m in bus.consume(f"s2req/{pid}"):
            if m.interval == now:            # replayed requests are cached
                reqs[m.payload[0]] = (m.shard, m.payload)
        if reqs:
            route = {key: sid for key, (sid, _) in reqs.items()}
            with _active_rec().span("policy.stage2", cat="policy"):
                replies = policy.bus_resolve([p for _, p in reqs.values()],
                                             t)
            for key, rep in replies:
                topic = f"s2rep/{pid}/{route[key]}"
                bus.publish(topic, COORDINATOR, now, (key, rep))
                recs.append((topic, now, (key, rep)))
        for sid in sorted(self._procs):
            topic = f"done/{pid}/{sid}"
            bus.publish(topic, COORDINATOR, now, None)
            recs.append((topic, now, None))

    def _pump(self) -> None:
        """Parent inbox sweep, run inside every wait loop: collect
        reports, index plans and sync markers, re-serve cached rounds to
        replaying workers, respawn the dead."""
        bus = self.bus
        self._serve_telemetry()
        for m in bus.consume("report"):
            data = pickle.loads(m.payload)
            if data.get("error"):
                raise RuntimeError(f"shard {m.shard} worker failed:\n"
                                   f"{data['error']}")
            self._reports[m.shard] = data
        for m in bus.consume("plan"):
            self._plan_inbox.setdefault(m.interval, {})[m.shard] = m.payload
            if m.interval in self._fb_cache:  # a replaying worker
                bus.publish(f"fb/{m.shard}", COORDINATOR, m.interval,
                            self._fb_cache[m.interval])
        for pid in self._fleet_pids:
            for m in bus.consume(f"sync/{pid}"):
                key = (pid, m.interval)
                self._sync_seen.setdefault(key, set()).add(m.shard)
                cached = self._round_cache.get(key)
                if cached is not None:       # a replaying worker
                    suffix = f"/{m.shard}"
                    for topic, interval, payload in cached:
                        if topic.endswith(suffix):
                            bus.publish(topic, COORDINATOR, interval,
                                        payload)
        self._check_liveness()

    def _check_liveness(self) -> None:
        for sid, p in list(self._procs.items()):
            if p.is_alive() or sid in self._reports:
                continue
            if self.telemetry is not None:
                # postmortem window for the unexpected death, from the
                # batches this worker drained before dying
                self._serve_telemetry()
                self.telemetry.dump_flight(f"w{sid}", "worker-death")
            n = self._respawns.get(sid, 0) + 1
            if not self.auto_restore or n > self.max_respawns:
                raise RuntimeError(
                    f"shard {sid} worker exited without a report "
                    f"(respawns={n - 1}); auto_restore="
                    f"{self.auto_restore}")
            self._respawns[sid] = n
            p.join(timeout=1.0)
            self._respawn(sid)

    # ------------------------------------------------------------- events
    def _fire_kill(self, ev: KillShard) -> None:
        p = self._procs.get(ev.sid)
        if p is None:
            raise ValueError(f"KillShard names unknown shard {ev.sid} "
                             f"(have {sorted(self._procs)})")
        p.kill()
        p.join(timeout=10.0)
        if self.telemetry is not None:
            self._serve_telemetry()
            self.telemetry.dump_flight(f"w{ev.sid}", "KillShard")
        self._respawns[ev.sid] = 0           # injected, not a crash loop
        self._respawn(ev.sid)

    def _fire_repartition(self, ev: Repartition, k: int) -> None:
        # workers saw the ctl yield bundled with interval k-1's feedback
        # and exit at the k boundary with a report
        self._await_reports()
        old = sorted(self._procs)
        for sid in old:
            self._procs[sid].join(timeout=10.0)
        for sid in old:
            self._merge_report(self._reports.pop(sid))
        self._procs.clear()
        self._respawns.clear()
        self._plan_inbox.clear()
        self._sync_seen.clear()
        self._fb_cache.clear()
        self._round_cache.clear()
        for sid in old:
            self.bus.consume(f"ctl/{sid}")   # drain unconsumed yields:
            #                                  new workers may reuse sids
            # old-partition snapshots are poison for a new-mesh respawn:
            # retained slots are keyed per producing shard, so the None
            # must be published AS that shard to overwrite its blob (a
            # coordinator-keyed None would sit beside the stale slot and
            # _respawn would still find the old-mesh snapshot)
            self.bus.publish(f"snap/{sid}", sid, k, None, retain=True)
        self._n_shards_arg = ev.n_shards
        self._shard_map_arg = None
        self.straggler_delay_s = {}          # old sids are meaningless now
        self.rt = ShardedRuntime(
            self.sim, mode="sync",
            max_staleness_intervals=self.max_staleness,
            n_shards=ev.n_shards, bus=self.bus)
        self._fleet_pids = [pid for pid, (kk, _) in enumerate(self.rt._tune)
                            if kk == "fleet"]
        self._segment_base = k
        self._sim_bytes = pickle.dumps(self.sim)
        for s in self.rt.shards:
            self._spawn(s.sid, k)

    # --------------------------------------------------------- async mode
    def _run_async(self, n_steps: int) -> None:
        dt = self.sim.interval_s
        bus = self.bus
        last_progress = time.monotonic()
        while True:
            self._serve_telemetry()
            for m in bus.consume("report"):
                data = pickle.loads(m.payload)
                if data.get("error"):
                    raise RuntimeError(f"shard {m.shard} worker failed:\n"
                                       f"{data['error']}")
                self._reports[m.shard] = data
            if set(self._procs) <= set(self._reports):
                break
            for sid, p in list(self._procs.items()):
                if not p.is_alive() and sid not in self._reports:
                    raise RuntimeError(f"async shard {sid} worker died "
                                       f"without a report")
            now = max((m.interval for m in bus.latest("hb")), default=0)
            moved = False
            for pid in self._fleet_pids:
                _kind, policy = self.rt._tune[pid]
                moved |= self.rt._coordinate_policy(pid, policy, now,
                                                    now * dt)
            if moved:
                last_progress = time.monotonic()
            else:
                if time.monotonic() - last_progress > self.barrier_timeout_s:
                    raise TimeoutError(
                        f"async fleet made no progress for "
                        f"{self.barrier_timeout_s:.0f}s (reports: "
                        f"{sorted(self._reports)})")
                bus.wait(0.002)
        # final pass so no request published by the last intervals is
        # left dangling (mirrors the threaded coordinator's shutdown)
        now = max((m.interval for m in bus.latest("hb")), default=0)
        for pid in self._fleet_pids:
            _kind, policy = self.rt._tune[pid]
            self.rt._coordinate_policy(pid, policy, now, now * dt)

    # ---------------------------------------------------- merge / results
    def _await_reports(self) -> None:
        deadline = time.monotonic() + self.barrier_timeout_s
        while not set(self._procs) <= set(self._reports):
            if self.mode == "sync":
                self._pump()
            else:
                self._serve_telemetry()
                for m in self.bus.consume("report"):
                    data = pickle.loads(m.payload)
                    if data.get("error"):
                        raise RuntimeError(
                            f"shard {m.shard} worker failed:\n"
                            f"{data['error']}")
                    self._reports[m.shard] = data
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"timed out waiting for worker reports: have "
                    f"{sorted(self._reports)}, want {sorted(self._procs)}")
            self.bus.wait(0.005)

    def _merge_report(self, data: dict) -> None:
        _merge_blob(self.rt, data)
        for cid, row in zip((c.client_id for c in data["clients"]),
                            data["series"]):
            self._series[cid].extend(row)
        self._walls.setdefault(int(data["sid"]), []).extend(
            data["step_walls"])
        for name, n in data["launches"].items():
            self.worker_launches[name] = self.worker_launches.get(name, 0) + n

    def _result(self, n_steps: int) -> SimResult:
        sim = self.sim
        return SimResult(
            duration_s=n_steps * sim.interval_s,
            interval_s=sim.interval_s,
            client_throughput=[self._series[c.client_id]
                               for c in sim.clients],
            app_read_bytes=[c.stats.read.app_bytes - s
                            for c, s in zip(sim.clients, self._start_read)],
            app_write_bytes=[c.stats.write.app_bytes - s
                             for c, s in zip(sim.clients,
                                             self._start_write)],
        )

    def probe_cadence(self) -> Dict[int, float]:
        """Median wall-clock gap between completed probe intervals per
        shard, from the workers' reported step walls (the async
        straggler-tolerance metric)."""
        import statistics
        out = {}
        for sid, walls in self._walls.items():
            gaps = [b - a for a, b in zip(walls, walls[1:])]
            out[sid] = statistics.median(gaps) if gaps else 0.0
        return out

    def stats(self) -> Dict[str, int]:
        return self.bus.stats()
