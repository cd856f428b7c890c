"""The port's cross-process transports, twinned with
``tests/test_transport.py``: bus conformance over every transport
(identical delivery AND identical accounting counters), RNG-as-state
identity between process-mode and in-process runs, snapshot/restore
under failure injection, mid-run repartitioning, and the socket
transport's reconnect/backoff contract.

Every process-mode identity case holds three runs equal with ``==``: the
port's ``ProcessRuntime`` (spawned workers over pipes or the socket),
the port's single-process ``Simulation.run`` and the reference's
``Simulation.run`` on the same fleet. Policies score on ``device="cpu"``
(the GBDT kernels' plain versions); the synthetic models are the
reference test's, and one case per transport runs the committed GBDT
pair with a guard that checks each spawned worker imported neither
``jax`` nor the reference package. The end of the file holds the
scorers' pickled form: no torch storage, equal outputs after loading.
"""
import io
import pickle
import socket
import threading
import time
import types
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import repro.storage as ref_storage
import repro_torch.storage as port_storage
from repro.config.types import CaratConfig as RefCaratConfig
from repro.core import CaratPolicy as RefCaratPolicy
from repro.core import default_spaces as ref_default_spaces
from repro.core.ml.gbdt import ObliviousGBDT as RefGBDT
from repro_torch.config import CaratConfig
from repro_torch.configs.carat_defaults import SPACES as PROD_SPACES
from repro_torch.core.ml.gbdt import ObliviousGBDT, default_models
from repro_torch.core.policies import CaratPolicy
from repro_torch.core.policy import default_spaces
from repro_torch.core.runtime import InProcessBus
from repro_torch.core.runtime.transport import (BusDisconnected, KillShard,
                                                MultiprocessBus,
                                                ProcessRuntime, Repartition,
                                                SocketBus, SocketBusHost,
                                                WireError)
from repro_torch.core.runtime.transport import socket_bus as socket_bus_mod
from repro_torch.kernels.gbdt_infer.ops import GBDTScorer, GridGBDTScorer
from repro_torch.storage import Simulation, get_workload
from torch_fleet_helpers import (Flip, LaunchCounter, ReferenceGuard,
                                 synthetic_models)

SPACES = default_spaces()
REF_SPACES = ref_default_spaces()
BURSTY = ("dlio_bert", "dlio_bert", "dlio_megatron", "s_wr_sq_1m")


def _models():
    return synthetic_models()


def _fleet_sim(n_nodes=2, cpn=2, seed=11, storage=port_storage):
    n = n_nodes * cpn
    wls = [storage.get_workload(BURSTY[i % len(BURSTY)]) for i in range(n)]
    return storage.Simulation(wls, seed=seed, backend="scalar",
                              topology=[i // cpn for i in range(n)])


def _signature(sim, policy, res):
    return ([c.config.dirty_cache_mb for c in sim.clients],
            [(c.config.rpc_window_pages, c.config.rpcs_in_flight)
             for c in sim.clients],
            getattr(policy, "decisions", None),
            res.app_read_bytes, res.app_write_bytes, res.client_throughput)


# ============================================= S1: transport conformance
KINDS = ["inprocess", "pipe", "socket"]


@contextmanager
def _bus(kind):
    """A worker-side bus handle for each transport, torn down after."""
    if kind == "inprocess":
        yield InProcessBus()
    elif kind == "pipe":
        hub = MultiprocessBus().start()
        ep = hub.endpoint("w0")
        try:
            yield ep
        finally:
            ep.close()
            hub.close()
    else:
        host = SocketBusHost()
        cli = SocketBus(host.address, peer="w0", authkey=host.authkey)
        try:
            yield cli
        finally:
            cli.close()
            host.close()


def _drive(bus):
    """One fixed publish/consume/latest/wait script; returns everything
    observable — deliveries and the full accounting counters — so the
    conformance test can compare transports counter-for-counter."""
    log = []
    # queued topic with a staleness bound: one fresh, one over-stale,
    # one delivered at staleness 1
    bus.publish("obs/0", 0, 5, ("o", 5, [1.5, 2.0]))
    bus.publish("obs/0", 1, 1, ("late", 1, None))
    bus.publish("obs/0", 1, 4, {"cid": 7, "f": 0.25})
    got = bus.consume("obs/0", now=5, max_staleness=2)
    log.append([(m.shard, m.interval, m.payload) for m in got])
    # unbounded consume drains; a second consume sees nothing
    bus.publish("dec/0", "coordinator", 5, [(0, (3, 4))])
    log.append([(m.shard, m.interval, m.payload)
                for m in bus.consume("dec/0")])
    log.append(bus.consume("dec/0"))
    # retained latest: one slot per shard, exclude + staleness filtered,
    # never visible to consume
    for (s, i, p) in [(0, 4, "a"), (0, 6, "b"), (1, 6, "c"), (2, 1, "old")]:
        bus.publish("demand", s, i, p, retain=True)
    lat = bus.latest("demand", now=6, max_staleness=3, exclude_shard=1)
    log.append(sorted((m.shard, m.interval, m.payload) for m in lat))
    log.append(bus.consume("demand"))
    bus.wait(0.02)                       # exercised, timing not asserted
    log.append(bus.stats())
    return log


def test_conformance_identical_across_all_transports():
    """Every transport delivers the same messages AND reports the same
    BusAccounting counters for the same traffic (S1)."""
    logs = {}
    for kind in KINDS:
        with _bus(kind) as bus:
            logs[kind] = _drive(bus)
    assert logs["pipe"] == logs["inprocess"]
    assert logs["socket"] == logs["inprocess"]
    # and the reference itself is what the accounting contract promises
    assert logs["inprocess"][-1] == {
        "published": 8, "consumed": 4,
        "dropped_stale": 1, "max_staleness_seen": 1}
    assert logs["inprocess"][0] == [(0, 5, ("o", 5, [1.5, 2.0])),
                                    (1, 4, {"cid": 7, "f": 0.25})]
    assert logs["inprocess"][3] == [(0, 6, "b")]


@pytest.mark.parametrize("kind", KINDS)
def test_numpy_payload_value_and_dtype_exact(kind):
    a = (np.arange(6, dtype=np.float32) / 3.0).reshape(2, 3)
    with _bus(kind) as bus:
        bus.publish("t", 0, 0, ("feat", a))
        [m] = bus.consume("t")
        tag, b = m.payload
        assert tag == "feat"
        assert b.dtype == a.dtype and np.array_equal(b, a)


@pytest.mark.parametrize("kind", ["pipe", "socket"])
def test_transports_reject_live_payloads_at_publish(kind):
    """Purity is enforced in the publishing process — a torch tensor is
    as live as a lock — and a rejected publish does not wedge the bus."""
    with _bus(kind) as bus:
        with pytest.raises(WireError):
            bus.publish("t", 0, 0, threading.Lock())
        with pytest.raises(WireError):
            bus.publish("t", 0, 0, (1, torch.ones(2)))
        bus.publish("t", 0, 0, "still serving")
        assert [m.payload for m in bus.consume("t")] == ["still serving"]


def test_hub_parent_publish_round_trips_wire():
    # the coordinator must not be the one path that can leak a live
    # object onto the bus
    with MultiprocessBus() as hub:
        with pytest.raises(WireError):
            hub.publish("t", "coordinator", 0, threading.Lock())
        host = SocketBusHost()
        try:
            with pytest.raises(WireError):
                host.publish("t", "coordinator", 0, threading.Lock())
        finally:
            host.close()


def test_pipe_wait_wakes_on_parent_publish():
    """A parked cross-process wait is answered when traffic arrives,
    not only at its deadline."""
    with MultiprocessBus() as hub:
        ep = hub.endpoint("w0")
        try:
            threading.Timer(0.15, lambda: hub.publish(
                "tick", "coordinator", 0, None)).start()
            t0 = time.monotonic()
            ep.wait(10.0)
            assert time.monotonic() - t0 < 5.0
        finally:
            ep.close()


@pytest.mark.parametrize("kind", ["pipe", "socket"])
def test_heartbeats_reach_the_hub(kind):
    if kind == "pipe":
        with MultiprocessBus() as hub:
            ep = hub.endpoint("w0")
            try:
                ep.beat(7)
                assert hub.heartbeats.interval("w0") == 7
                assert "w0" in hub.heartbeats.peers()
            finally:
                ep.close()
    else:
        host = SocketBusHost()
        cli = SocketBus(host.address, peer="w0", authkey=host.authkey)
        try:
            cli.beat(7)
            assert host.heartbeats.interval("w0") == 7
        finally:
            cli.close()
            host.close()


# ================================== socket reconnect/backoff contract
def test_socket_client_reconnects_after_severed_connection():
    host = SocketBusHost()
    cli = SocketBus(host.address, peer="w0", authkey=host.authkey,
                    max_retries=6, backoff_s=0.01, backoff_cap_s=0.05)
    try:
        cli.publish("t", 0, 0, "before")
        for conn in list(host._conns):       # sever server-side
            conn.shutdown(socket.SHUT_RDWR)
        cli.stats()                          # forces detect + reconnect
        assert cli.reconnects >= 1
        cli.publish("t", 0, 1, "after")
        assert [m.payload for m in cli.consume("t")] == ["before", "after"]
    finally:
        cli.close()
        host.close()


def test_socket_disconnect_after_bounded_retries():
    host = SocketBusHost()
    addr = host.address
    host.close()
    cli = SocketBus(addr, peer="w0", authkey=b"k", max_retries=2,
                    backoff_s=0.01, backoff_cap_s=0.02,
                    connect_timeout_s=1.0)
    t0 = time.monotonic()
    with pytest.raises(BusDisconnected, match="unreachable after 2"):
        cli.publish("t", 0, 0, "x")
    assert time.monotonic() - t0 < 10.0      # backoff stayed bounded


# ------------------------------------ socket authentication contract
def test_socket_requires_authkey_and_rejects_wrong_key():
    """The handshake gates the frame codec: a client with the wrong
    shared secret never gets served (and exhausts its retries), while
    an authenticated client keeps working on the same host."""
    with pytest.raises(ValueError, match="authkey"):
        SocketBus(("127.0.0.1", 1), peer="w0")
    host = SocketBusHost()
    good = SocketBus(host.address, peer="good", authkey=host.authkey)
    bad = SocketBus(host.address, peer="evil", authkey=b"not-the-key",
                    max_retries=2, backoff_s=0.01, backoff_cap_s=0.02)
    try:
        good.publish("t", 0, 0, "x")
        with pytest.raises(BusDisconnected):
            bad.consume("t")
        assert [m.payload for m in good.consume("t")] == ["x"]
    finally:
        good.close()
        bad.close()
        host.close()


def test_socket_unauthenticated_frames_never_reach_the_store():
    """A raw peer that skips the handshake and throws a framed request
    at the port is disconnected before anything is deserialized — the
    store sees no traffic."""
    import struct
    host = SocketBusHost()
    raw = socket.create_connection(host.address, timeout=5.0)
    try:
        raw.settimeout(5.0)
        raw.recv(32)                         # the challenge we can't answer
        frame = pickle.dumps(("req", "evil", "e", 0,
                              ("pub", "t", 0, 0, None, False)))
        raw.sendall(struct.pack(">I", len(frame)) + frame)
        # host reads 32 bytes of that as a bogus digest and hangs up
        deadline = time.monotonic() + 5.0
        closed = False
        while time.monotonic() < deadline:
            try:
                if raw.recv(1024) == b"":
                    closed = True
                    break
            except (ConnectionError, OSError):
                closed = True
                break
        assert closed, "host kept the unauthenticated connection open"
        assert host.stats()["published"] == 0
    finally:
        raw.close()
        host.close()


def test_socket_retry_replays_lost_response_exactly_once():
    """Destructive ops survive a lost response frame: the host serves a
    'con' (draining the queue), the response frame is dropped, and the
    client's tagged retry is answered from the host's reply cache — the
    drained messages arrive instead of vanishing, and duplicate 'pub'
    resends cannot skew the published counter."""
    host = SocketBusHost()
    cli = SocketBus(host.address, peer="w0", authkey=host.authkey,
                    backoff_s=0.01, backoff_cap_s=0.05)
    orig = socket_bus_mod._send_frame
    dropped = []

    def flaky(sock, obj):
        # sever the first host->client consume response after it was
        # served and cached (host conn threads are named socketbus-conn)
        if (not dropped
                and threading.current_thread().name == "socketbus-conn"
                and isinstance(obj, tuple) and obj and obj[0] == "ok"
                and isinstance(obj[1], list) and obj[1]):
            dropped.append(obj)
            raise ConnectionError("injected: response frame lost")
        orig(sock, obj)

    try:
        cli.publish("t", 0, 0, "a")
        cli.publish("t", 0, 1, "b")
        socket_bus_mod._send_frame = flaky
        msgs = cli.consume("t")
        assert dropped, "injection never fired — vacuous"
        assert [m.payload for m in msgs] == ["a", "b"]
        assert cli.reconnects >= 1
        stats = host.stats()
        assert stats["published"] == 2       # no double-publish either
        assert stats["consumed"] == 2        # the drain ran exactly once
    finally:
        socket_bus_mod._send_frame = orig
        cli.close()
        host.close()


# ============================ S2 + tentpole: process-mode identity gates
def _carat_build(seed=11, cfg=None, budgets=None, trading=False,
                 log_stage2=False, models=_models):
    """``build(ref=False) -> (sim, policy)``: the same fleet and policy in
    the port (scoring on the CPU) or, with ``ref``, in the reference."""
    def build(ref=False):
        if ref:
            sim = _fleet_sim(seed=seed, storage=ref_storage)
            ref_cfg = None if cfg is None else RefCaratConfig(**vars(cfg))
            ref_models = {op: (RefGBDT(m.feat, m.thr, m.leaf, m.base,
                                       m.n_features)
                               if isinstance(m, ObliviousGBDT) else m)
                          for op, m in models().items()}
            pol = sim.attach_policy(RefCaratPolicy(
                REF_SPACES, ref_models, cfg=ref_cfg, backend="numpy",
                node_budgets_mb=budgets, budget_trading=trading,
                log_stage2=log_stage2))
            return sim, pol
        sim = _fleet_sim(seed=seed)
        pol = sim.attach_policy(CaratPolicy(
            SPACES, models(), cfg=cfg, device="cpu",
            node_budgets_mb=budgets, budget_trading=trading,
            log_stage2=log_stage2))
        return sim, pol
    return build


def _paired(build, duration, guard=None, **prt_kw):
    """The port's single-process run (a) and ``ProcessRuntime`` run (b),
    held to each other and to the reference's single-process run with
    ``==``. ``guard`` (a :class:`ReferenceGuard`) rides along in (b)."""
    sim_a, pol_a = build()
    res_a = sim_a.run(duration)
    sim_r, pol_r = build(ref=True)
    res_r = sim_r.run(duration)
    sim_b, pol_b = build()
    if guard is not None:
        sim_b.attach_policy(guard)
    prt = ProcessRuntime(sim_b, **prt_kw)
    res_b = prt.run(duration)
    sig_a = _signature(sim_a, pol_a, res_a)
    assert _signature(sim_r, pol_r, res_r) == sig_a
    return (sig_a, _signature(sim_b, pol_b, res_b), pol_a, pol_b, prt)


def test_process_sync_identity_pipe_with_trading():
    """Worker processes over pipes == single-process Simulation,
    including the bus-routed stage-2 drain and cross-node trading."""
    budgets = {0: 0.3 * SPACES.cache_max * 2, 1: 2.0 * SPACES.cache_max * 2}
    sig_a, sig_b, pol_a, pol_b, _ = _paired(
        _carat_build(budgets=budgets, trading=True), 12.0)
    assert pol_b.boundary_count > 0          # stage-2 rode the bus
    assert sig_a == sig_b
    assert pol_a.boundary_count == pol_b.boundary_count


def test_process_sync_identity_socket():
    sig_a, sig_b, _, _, prt = _paired(
        _carat_build(seed=7), 10.0, transport="socket")
    assert sig_a == sig_b
    assert prt.stats()["published"] > 0


FLIP = {"s_rd_rn_8k": "s_wr_rn_8k", "s_wr_rn_8k": "s_rd_rn_8k",
        "s_rd_sq_1m": "s_wr_sq_1m", "s_wr_sq_1m": "s_rd_sq_1m"}


def _flip_build(n=8, node_size=4, seed=5, flip_at=2.5):
    """``build(ref=False)``: clients of the four steady workloads in
    nodes of ``node_size``, each flipping its op direction at
    ``flip_at`` (so every controller re-probes and takes a bootstrap
    pick), under CARAT with the committed production GBDT pair."""
    def build(ref=False):
        storage = ref_storage if ref else port_storage
        names = [list(FLIP)[i % 4] for i in range(n)]
        sim = storage.Simulation(
            [storage.get_workload(nm) for nm in names], seed=seed,
            backend="scalar", topology=[i // node_size for i in range(n)])
        sim.attach_policy(storage.SchedulePolicy({
            c.client_id: Flip(storage.get_workload(nm),
                              storage.get_workload(FLIP[nm]), flip_at)
            for c, nm in zip(sim.clients, names)}))
        m_read, m_write = default_models()
        if ref:
            models = {op: RefGBDT(m.feat, m.thr, m.leaf, m.base,
                                  m.n_features)
                      for op, m in (("read", m_read), ("write", m_write))}
            pol = RefCaratPolicy(REF_SPACES, models, backend="numpy")
        else:
            pol = CaratPolicy(SPACES, {"read": m_read, "write": m_write},
                              device="cpu")
        return sim, sim.attach_policy(pol)
    return build


@pytest.mark.parametrize("transport", ["pipe", "socket"])
def test_process_identity_committed_gbdt_pair(transport):
    """The production GBDT pair on the path (the kernels' plain versions
    in every process: the parent's probe batches through
    ``gbdt_grid_logits``, each worker's bootstrap picks through
    ``gbdt_logits``): the process fleet equals both single-process runs,
    and no spawned worker imported ``jax`` or the reference."""
    guard = ReferenceGuard()
    sig_a, sig_b, pol_a, _, _ = _paired(_flip_build(), 6.0, guard=guard,
                                        transport=transport)
    assert sig_a == sig_b
    picks = sum(d[1] == "bootstrap" for log in pol_a.decisions for d in log)
    assert picks > 0, "no bootstrap pick — gbdt_logits never ran"
    assert guard.steps > 0, "the guard never ran in a worker — vacuous"
    assert guard.leaked == set()


def test_process_rng_streams_identical_to_in_process():
    """S2: workers rebuild per-client RngStreams from serialized state
    and never reseed — the process-mode run consumes exactly the RNG
    sequence the in-process run does (epsilon-greedy forces draws)."""
    cfg = CaratConfig(tuner="epsilon_greedy")
    build = _carat_build(cfg=cfg)
    sim_a, pol_a = build()
    sim_a.run(12.0)
    states_a = {c.client_id: c.tuner.rng.state()
                for c in pol_a.controllers}

    sim_b, pol_b = build()
    init_b = {c.client_id: c.tuner.rng.state() for c in pol_b.controllers}
    ProcessRuntime(sim_b).run(12.0)
    states_b = {c.client_id: c.tuner.rng.state()
                for c in pol_b.controllers}

    assert states_b != init_b, "no RNG consumed — vacuous"
    assert states_a == states_b


def test_kill_shard_restores_from_snapshot_identical():
    """Failure injection: SIGKILL one worker mid-run; restore from its
    retained snapshot and replay must keep the run decision-identical —
    no lost client state, conserved cache-budget accounting."""
    budgets = {0: 0.3 * SPACES.cache_max * 2, 1: 2.0 * SPACES.cache_max * 2}
    build = _carat_build(budgets=budgets, trading=True, log_stage2=True)
    sig_a, sig_b, _, pol_b, prt = _paired(
        build, 12.0, events=[KillShard(at_interval=8, sid=1)],
        snapshot_every=2)
    assert sig_a == sig_b
    # one respawn of shard 1, from a snapshot of interval 6 or 8
    assert prt.spawns[:-1] == [(s.sid, None) for s in prt.rt.shards]
    assert prt.spawns[-1][0] == 1 and prt.spawns[-1][1] in (6, 8)
    # every stage-2 round (pre- and post-restore) conserved the budget
    assert pol_b.stage2_events, "no stage-2 rounds fired — vacuous"
    for _, raw, effective, _ in pol_b.stage2_events:
        assert float(effective.sum()) <= float(raw.sum()) * (1 + 1e-12) + 1e-6


def test_repartition_mid_run_identical():
    """Elasticity: merge the fleet into the parent mid-run and respawn
    it under a different shard count — client churn across workers must
    not perturb decisions."""
    sig_a, sig_b, _, _, _ = _paired(
        _carat_build(seed=5), 12.0,
        events=[Repartition(at_interval=6, n_shards=1)])
    assert sig_a == sig_b


def test_kill_after_repartition_never_restores_old_mesh_snapshot():
    """A KillShard firing after a Repartition but before the new mesh's
    first snapshot must respawn from the segment base, not a retained
    old-partition blob (same sid, different client set): the poison is
    keyed under the producing shard's slot and _respawn rejects blobs
    from at or before the segment base. Old-mesh snapshots exist at
    intervals 2/4/6; the kill at 7 lands in the unsnapshotted window of
    the re-meshed shard 0."""
    sig_a, sig_b, _, _, prt = _paired(
        _carat_build(seed=5), 14.0,
        events=[Repartition(at_interval=6, n_shards=1),
                KillShard(at_interval=7, sid=0)],
        snapshot_every=2)
    assert sig_a == sig_b
    assert prt.spawns[-2:] == [(0, None), (0, None)]


def test_kill_after_repartition_with_new_mesh_snapshot_identical():
    """Once the re-meshed worker has published its own snapshot, a later
    kill restores from that (new-mesh) blob and stays identical."""
    sig_a, sig_b, _, _, prt = _paired(
        _carat_build(seed=5), 14.0,
        events=[Repartition(at_interval=6, n_shards=1),
                KillShard(at_interval=11, sid=0)],
        snapshot_every=2)
    assert sig_a == sig_b
    assert prt.spawns[-2] == (0, None)
    assert prt.spawns[-1][0] == 0 and prt.spawns[-1][1] in (8, 10)


def test_worker_launches_come_back_in_the_reports():
    """Each worker's own kernel launch counters travel back in its
    report and the parent sums them into ``worker_launches``; the
    parent's counters take none of them. A :class:`LaunchCounter` adds
    one ``gbdt_logits`` launch per shard step, as a launch on the card
    would (on the CPU no wrapper counts)."""
    from repro_torch.kernels.gbdt_infer import kernel
    before = dict(kernel.launches)
    sig_a, sig_b, _, _, prt = _paired(_carat_build(seed=5), 6.0,
                                      guard=LaunchCounter())
    assert sig_a == sig_b
    assert prt.worker_launches == {"gbdt_logits": 12 * len(prt.rt.shards),
                                   "gbdt_grid_logits": 0}
    assert kernel.launches == before
    assert prt.spawns == [(s.sid, None) for s in prt.rt.shards]


def test_process_async_smoke_bounded_staleness():
    sim = _fleet_sim(seed=3)
    sim.attach_policy(CaratPolicy(SPACES, _models(), device="cpu"))
    prt = ProcessRuntime(sim, mode="async", max_staleness_intervals=2)
    res = prt.run(8.0)
    assert prt.stats()["max_staleness_seen"] <= 2
    assert res.client_throughput                 # merged a real result
    assert prt.probe_cadence()                   # per-shard cadence known


# ------------------------------------------------- construction validation
def _plain_sim():
    sim = _fleet_sim()
    sim.attach_policy(CaratPolicy(SPACES, _models(), device="cpu"))
    return sim


def test_process_runtime_validation():
    with pytest.raises(ValueError, match="mode"):
        ProcessRuntime(_plain_sim(), mode="warp")
    with pytest.raises(ValueError, match="transport"):
        ProcessRuntime(_plain_sim(), transport="carrier-pigeon")
    sim = _fleet_sim()
    sim.attach_policy(lambda clients, t, dt: None)
    with pytest.raises(ValueError, match="bus-capable"):
        ProcessRuntime(sim)
    with pytest.raises(ValueError, match="sync"):
        ProcessRuntime(_plain_sim(), mode="async",
                       events=[KillShard(at_interval=2, sid=0)])
    with pytest.raises(ValueError, match="at_interval"):
        ProcessRuntime(_plain_sim(),
                       events=[KillShard(at_interval=-1, sid=0)])
    with pytest.raises(ValueError, match="at_interval >= 1"):
        ProcessRuntime(_plain_sim(),
                       events=[Repartition(at_interval=0, n_shards=2)])
    with pytest.raises(ValueError, match="n_shards"):
        ProcessRuntime(_plain_sim(),
                       events=[Repartition(at_interval=2, n_shards=0)])
    with pytest.raises(TypeError, match="unknown event"):
        ProcessRuntime(_plain_sim(), events=["soon"])
    # events must fire inside the run
    prt = ProcessRuntime(_plain_sim(),
                         events=[KillShard(at_interval=50, sid=0)])
    with pytest.raises(ValueError, match="last interval"):
        prt.run(10.0)


@pytest.mark.parametrize("backend", ["soa", "soa-torch"])
def test_process_runtime_drives_the_scalar_backend_only(backend):
    """The fleet backends run in-process; the process runtime says which
    backend to build instead of running them some other way."""
    n = 4
    sim = Simulation([get_workload(BURSTY[i % 4]) for i in range(n)],
                     seed=3, backend=backend, device="cpu",
                     topology=[i // 2 for i in range(n)])
    sim.attach_policy(CaratPolicy(SPACES, _models(), device="cpu"))
    with pytest.raises(ValueError, match="backend='scalar'"):
        ProcessRuntime(sim)


def test_worker_that_cannot_reach_its_device_fails_the_run():
    """No worker falls back to the CPU: a policy whose per-client scorer
    names ``cuda`` loads in each worker onto ``cuda``, which a machine
    without CUDA refuses, so the worker reports its traceback and
    ``run()`` raises."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the worker would reach it")
    m_read, m_write = default_models()
    sim = _fleet_sim(seed=5)
    pol = sim.attach_policy(CaratPolicy(
        SPACES, {"read": m_read, "write": m_write}, device="cpu"))
    scorer = pol.tuner.models["read"].__self__
    assert isinstance(scorer, GBDTScorer)
    # the scorer now pickles as (model, "cuda"), as a card's scorer does
    scorer.packed = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="worker failed(.|\n)*CUDA"):
        ProcessRuntime(sim, barrier_timeout_s=60.0).run(4.0)


# ------------------------------------------- scorers pickle by their model
class _StoragePickler(pickle.Pickler):
    """Pickles normally and notes every torch tensor or storage it
    meets (``persistent_id`` is asked about every object)."""

    def __init__(self, f):
        super().__init__(f, protocol=pickle.HIGHEST_PROTOCOL)
        self.torch_objects = []

    def persistent_id(self, obj):
        if isinstance(obj, (torch.Tensor, torch.UntypedStorage,
                            torch.TypedStorage)):
            self.torch_objects.append(type(obj).__name__)
        return None


def _dump(obj):
    buf = io.BytesIO()
    p = _StoragePickler(buf)
    p.dump(obj)
    return buf.getvalue(), p.torch_objects


def test_pickled_scorers_and_sim_hold_no_torch_storage():
    """A pickled ``GBDTScorer`` / ``GridGBDTScorer`` — and a whole
    simulation with a ``CaratPolicy`` — carries no torch storage; it loads
    to scorers with equal outputs, and one pickle keeps one scorer shared
    by the fleet tuner and every controller shell."""
    _, hits = _dump({"x": torch.zeros(2)})
    assert hits, "the storage hook sees nothing — vacuous"
    m_read, m_write = default_models()
    theta = PROD_SPACES.theta_features()
    scorer = GBDTScorer(m_read, device="cpu")
    grid = GridGBDTScorer(m_write, theta, device="cpu")
    blob, hits = _dump((scorer, grid, scorer.predict_proba))
    assert hits == []
    s2, g2, fn2 = pickle.loads(blob)
    assert fn2.__self__ is s2
    rng = np.random.default_rng(0)
    X = rng.random((63, m_read.n_features)).astype(np.float32)
    H = rng.random((17, grid.n_h)).astype(np.float32)
    assert np.array_equal(s2.predict_proba(X), scorer.predict_proba(X))
    assert np.array_equal(g2(H), grid(H))

    sim = _fleet_sim(seed=5)
    pol = sim.attach_policy(CaratPolicy(
        SPACES, {"read": m_read, "write": m_write}, device="cpu"))
    blob, hits = _dump(sim)
    assert hits == []
    sim2 = pickle.loads(blob)
    (pol2,) = sim2.policies("tune")
    for op in ("read", "write"):
        shared = pol2.tuner.models[op].__self__
        assert all(c.tuner.models[op].__self__ is shared
                   for c in pol2.controllers)
        assert np.array_equal(
            pol2.tuner.grid_models[op](H[:, :pol.tuner.grid_models[op].n_h]),
            pol.tuner.grid_models[op](H[:, :pol.tuner.grid_models[op].n_h]))
