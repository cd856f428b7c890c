"""The port's sharded fleet runtime, twinned with ``tests/test_runtime.py``.

Every sync identity case runs on the host backends (``"scalar"`` and
``"soa"``) and holds three runs equal with ``==``: the port's
single-process ``Simulation.run``, the port's sync ``ShardedRuntime``, and
the reference's sync ``ShardedRuntime`` on the same fleet — decisions,
cache limits, the throughput series and the bytes. The async property
tests, the rejection tests and the diagnostics tests are the reference's,
run against the port (async runs are not deterministic, so they are held
to their invariants, not to the reference).
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.storage as ref_storage
import repro_torch.storage as port_storage
from repro.config.types import CaratConfig as RefCaratConfig
from repro.core import CaratPolicy as RefCaratPolicy
from repro.core import default_spaces as ref_default_spaces
from repro.core import make_policy as ref_make_policy
from repro.core.runtime import ShardedRuntime as RefShardedRuntime
from repro_torch.config import CaratConfig
from repro_torch.core.controller import CaratController, NodeCacheArbiter
from repro_torch.core.policies import (CaratPolicy, PerClientPolicy,
                                       make_policy)
from repro_torch.core.policies.base import TuningPolicy
from repro_torch.core.policy import default_spaces
from repro_torch.core.runtime import InProcessBus, ShardedRuntime
from repro_torch.storage import (SchedulePolicy, Simulation, bundled_traces,
                                 get_workload, schedule_from_names)

SPACES = default_spaces()
BURSTY = ("dlio_bert", "dlio_bert", "dlio_megatron", "s_wr_sq_1m")
HOST_BACKENDS = ("scalar", "soa")


def _synthetic_model(salt: float):
    """Deterministic, batch-invariant pseudo-probabilities in [0, 1]."""

    def model(X):
        z = np.sin(X.astype(np.float64).sum(axis=1) * 12.9898 + salt)
        return (z + 1.0) / 2.0

    return model


def _models():
    return {"read": _synthetic_model(0.0), "write": _synthetic_model(1.7)}


class _Pkg:
    """One package's names, so a builder can make the same fleet in
    either."""

    def __init__(self, storage, carat, cfg, make, spaces, scorer_kw):
        self.storage, self.carat, self.cfg = storage, carat, cfg
        self.make, self.spaces, self.scorer_kw = make, spaces, scorer_kw


PORT = _Pkg(port_storage, CaratPolicy, CaratConfig, make_policy, SPACES,
            {"device": "cpu"})
REF = _Pkg(ref_storage, RefCaratPolicy, RefCaratConfig, ref_make_policy,
           ref_default_spaces(), {"backend": "numpy"})


def _fleet_sim(pkg=PORT, backend="scalar", n_nodes=2, cpn=2, seed=11):
    n = n_nodes * cpn
    wls = [pkg.storage.get_workload(BURSTY[i % len(BURSTY)])
           for i in range(n)]
    return pkg.storage.Simulation(wls, seed=seed, backend=backend,
                                  topology=[i // cpn for i in range(n)])


def _signature(sim, policy, res):
    return ([c.config.dirty_cache_mb for c in sim.clients],
            [(c.config.rpc_window_pages, c.config.rpcs_in_flight)
             for c in sim.clients],
            getattr(policy, "decisions", None),
            res.app_read_bytes, res.app_write_bytes, res.client_throughput)


def _three_way(build, duration, **runtime_kw):
    """``build(pkg) -> (sim, policy)``. The port's single-process run, its
    sync-sharded run and the reference's sync-sharded run must agree
    with ``==``; returns the port's runtime and both port policies."""
    sim_a, pol_a = build(PORT)
    res_a = sim_a.run(duration)
    sim_b, pol_b = build(PORT)
    rt = ShardedRuntime(sim_b, mode="sync", **runtime_kw)
    res_b = rt.run(duration)
    sim_c, pol_c = build(REF)
    res_c = RefShardedRuntime(sim_c, mode="sync", **runtime_kw).run(duration)
    sig = _signature(sim_b, pol_b, res_b)
    assert _signature(sim_a, pol_a, res_a) == sig
    assert _signature(sim_c, pol_c, res_c) == sig
    return rt, pol_a, pol_b


# ------------------------------------------------- sync decision identity
@pytest.mark.parametrize("backend", HOST_BACKENDS)
def test_sync_identity_multi_node_carat_with_trading(backend):
    """Barrier mode over node-group shards == single-process Simulation,
    including the bus-routed stage-2 drain and cross-shard trading."""
    def build(pkg):
        budgets = {0: 0.3 * pkg.spaces.cache_max * 2,
                   1: 2.0 * pkg.spaces.cache_max * 2}
        sim = _fleet_sim(pkg, backend)
        pol = sim.attach_policy(pkg.carat(
            pkg.spaces, _models(), node_budgets_mb=budgets,
            budget_trading=True, **pkg.scorer_kw))
        return sim, pol

    rt, pol_a, pol_b = _three_way(build, 14.0)
    assert len(rt.shards) == 2
    assert pol_b.boundary_count > 0          # stage-2 rode the bus
    assert pol_a.boundary_count == pol_b.boundary_count


@pytest.mark.parametrize("backend", HOST_BACKENDS)
def test_sync_identity_carries_the_tuner_streams(backend):
    """An epsilon-greedy tuner draws from each client's stream: the
    streams cross the bus as serialized state and come back advanced, so
    the sharded draws are the single-process ones."""
    def build(pkg):
        sim = _fleet_sim(pkg, backend, n_nodes=3, seed=7)
        pol = sim.attach_policy(pkg.carat(
            pkg.spaces, _models(), pkg.cfg(tuner="epsilon_greedy"),
            **pkg.scorer_kw))
        return sim, pol

    _, _, pol = _three_way(build, 14.0, n_shards=3)
    assert pol.decision_count > 0


@pytest.mark.parametrize("backend", HOST_BACKENDS)
@pytest.mark.parametrize("trace", sorted(bundled_traces()))
def test_sync_identity_replay_corpus(trace, backend):
    """Every bundled trace: sync-sharded replay (schedules on the
    workload phase, CARAT on the bus) == single-process replay."""
    def build(pkg):
        schedules = pkg.storage.compile_trace(
            pkg.storage.load_bundled_trace(trace))
        sim = pkg.storage.simulation_from_schedules(schedules, seed=3,
                                                    backend=backend)
        pol = sim.attach_policy(pkg.carat(pkg.spaces, _models(),
                                          **pkg.scorer_kw))
        return sim, pol

    schedules = port_storage.compile_trace(
        port_storage.load_bundled_trace(trace))
    duration = min(max(s.duration for s in schedules.values()), 30.0)
    _three_way(build, duration, n_shards=2)


def _policy_kwargs(name, pkg):
    return {"static": {},
            "dial": {"spaces": pkg.spaces, "seed": 2},
            "magpie": {"spaces": pkg.spaces, "seed": 2, "dwell": 2}}[name]


@pytest.mark.parametrize("backend", HOST_BACKENDS)
@pytest.mark.parametrize("name", ["static", "dial", "magpie"])
def test_sync_identity_other_policies(name, backend):
    """The bus path is policy-agnostic: pure-local policies (static,
    dial) and the full-gather stress case (magpie) are sync-identical."""
    def build(pkg):
        sim = _fleet_sim(pkg, backend, seed=13)
        return sim, sim.attach_policy(pkg.make(name,
                                               **_policy_kwargs(name, pkg)))

    _, _, pol = _three_way(build, 12.0)
    if name != "static":
        assert any(pol.decisions)       # the learner moved


# ------------------------------------------------- async property tests
@settings(max_examples=4, deadline=None)
@given(staleness=st.integers(0, 3), seed=st.integers(0, 100))
def test_async_respects_max_staleness(staleness, seed):
    """The bus never *delivers* an observation staler than the knob, and
    a lagging straggler's over-stale traffic is dropped, not waited for."""
    sim = _fleet_sim(seed=seed)
    sim.attach_policy(CaratPolicy(SPACES, _models(), device="cpu"))
    rt = ShardedRuntime(sim, mode="async", max_staleness_intervals=staleness,
                        straggler_delay_s={0: 0.004})
    rt.run(8.0)
    stats = rt.bus.stats()
    assert stats["max_staleness_seen"] <= staleness
    # every shard still completed every interval (nobody blocked)
    n_steps = int(round(8.0 / sim.interval_s))
    assert all(s.interval == n_steps for s in rt.shards)


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 100), starve=st.floats(0.1, 0.5))
def test_async_cross_shard_trading_conserves_budget(seed, starve):
    """Every coordinator trading round over a gathered (cross-shard)
    node batch conserves the summed budgets of exactly those nodes."""
    cpn = 2
    budgets = {0: float(SPACES.cache_max * cpn * starve),
               1: float(SPACES.cache_max * cpn * 1.5),
               2: float(SPACES.cache_max * cpn * starve)}
    sim = _fleet_sim(n_nodes=3, cpn=cpn, seed=seed)
    pol = sim.attach_policy(CaratPolicy(
        SPACES, _models(), device="cpu", node_budgets_mb=budgets,
        budget_trading=True, log_stage2=True))
    rt = ShardedRuntime(sim, mode="async", max_staleness_intervals=2,
                        straggler_delay_s={1: 0.002})
    rt.run(14.0)
    assert pol.stage2_events, "no stage-2 rounds fired — vacuous"
    for _, raw, effective, _ in pol.stage2_events:
        assert float(effective.sum()) <= float(raw.sum()) * (1 + 1e-12) + 1e-6


def test_async_on_host_soa_core():
    """Async mode over the host ``soa`` core (demand echoes as
    ``DemandBatch``es): every shard completes every interval within the
    staleness bound, and the coordinator decides."""
    sim = _fleet_sim(backend="soa", n_nodes=3, seed=5)
    pol = sim.attach_policy(CaratPolicy(SPACES, _models(), device="cpu"))
    rt = ShardedRuntime(sim, mode="async", max_staleness_intervals=1)
    res = rt.run(8.0)
    assert rt.bus.stats()["max_staleness_seen"] <= 1
    assert all(s.interval == 16 for s in rt.shards)
    assert pol.decision_count > 0
    assert np.isfinite(res.client_throughput).all()


def test_async_rejects_plain_hooks():
    sim = _fleet_sim()
    sim.attach_policy(lambda clients, t, dt: None)
    with pytest.raises(ValueError, match="bus-capable"):
        ShardedRuntime(sim, mode="async")


def test_runtime_rejects_arbiter_spanning_shards():
    """A stage-2 arbiter shared across two nodes' clients cannot be
    sharded along the node topology."""
    sim = _fleet_sim(n_nodes=2, cpn=1)
    arb = NodeCacheArbiter(SPACES, deferred=True)
    shells = [CaratController(c.client_id, SPACES, _models(), arbiter=arb)
              for c in sim.clients]
    sim.attach_policy(CaratPolicy(models=_models(), controllers=shells,
                                  device="cpu"))
    with pytest.raises(ValueError, match="spans shards"):
        ShardedRuntime(sim, mode="sync")


def test_runtime_partition_validation():
    sim = _fleet_sim()
    with pytest.raises(ValueError):
        ShardedRuntime(sim, mode="warp")
    with pytest.raises(ValueError):
        ShardedRuntime(sim, n_shards=0)
    with pytest.raises(ValueError):
        ShardedRuntime(sim, shard_map={0: 0})            # node 1 missing
    with pytest.raises(ValueError):
        ShardedRuntime(sim, straggler_delay_s={9: 0.1})  # unknown shard
    rt = ShardedRuntime(sim, shard_map={0: 5, 1: 5})     # merge into one
    assert len(rt.shards) == 1
    assert sorted(rt.shards[0].client_ids) == [0, 1, 2, 3]


def test_carat_shard_state_round_trip():
    """``shard_state`` hands out a shard's controller shells and
    ``merge_shard_state`` installs them by client id: a run that swaps
    every shard's shells back in mid-run is identical to one that does
    not, and a shell for an unknown client is refused."""
    def build():
        sim = _fleet_sim(backend="soa")
        return sim, sim.attach_policy(CaratPolicy(SPACES, _models(),
                                                  device="cpu"))

    sim_a, pol_a = build()
    rt_a = ShardedRuntime(sim_a, mode="sync")
    res_a = [rt_a.run(5.0), rt_a.run(5.0)]
    sim_b, pol_b = build()
    rt_b = ShardedRuntime(sim_b, mode="sync")
    res_b = [rt_b.run(5.0)]
    states = [pol_b.shard_state(s.client_ids) for s in rt_b.shards]
    assert [[c.client_id for c in st] for st in states] == \
        [s.client_ids for s in rt_b.shards]
    for st in states:
        pol_b.merge_shard_state(st)
    res_b.append(rt_b.run(5.0))
    assert pol_a.decisions == pol_b.decisions
    for a, b in zip(res_a, res_b):
        assert a.client_throughput == b.client_throughput
    stranger = CaratController(99, SPACES, _models(),
                               arbiter=NodeCacheArbiter(SPACES))
    with pytest.raises(KeyError, match="unknown client 99"):
        pol_b.merge_shard_state([stranger])


# --------------------------------------- loud missing-client diagnostics
MISSING_RE = r"bound to client\(s\) \[3\] with no matching client this step"


def _one_client_sim():
    return Simulation([get_workload("s_rd_rn_8k")], seed=0, backend="scalar")


def test_missing_client_diagnostics_share_one_shape():
    """Every resolution path fails loudly with the same message shape:
    base my_clients, PerClientPolicy, SchedulePolicy, CaratPolicy."""
    sim = _one_client_sim()

    base = TuningPolicy()
    base.client_ids = [3]
    with pytest.raises(KeyError, match=MISSING_RE):
        base.my_clients(sim.clients)

    percl = PerClientPolicy({3: lambda c, t, dt: None})
    with pytest.raises(KeyError, match=MISSING_RE):
        percl.step(sim.clients, 0.5, 0.5)

    sched = SchedulePolicy(
        {3: schedule_from_names(["s_rd_rn_8k"], phase_s=4.0)})
    with pytest.raises(KeyError, match=MISSING_RE):
        sched.step(sim.clients, 0.0, 0.5)

    carat = CaratPolicy(
        models=_models(),
        controllers=[CaratController(3, SPACES, _models(),
                                     arbiter=NodeCacheArbiter(SPACES))],
        device="cpu")
    with pytest.raises(KeyError, match=MISSING_RE):
        carat.step(sim.clients, 0.5, 0.5)


def test_present_clients_is_the_explicit_subset_path():
    """Shard views use present_clients, which (deliberately) tolerates
    absent bound ids — in contrast to the loud my_clients."""
    sim = Simulation([get_workload("s_rd_rn_8k"),
                      get_workload("s_wr_sq_1m")], seed=0, backend="scalar")
    pol = TuningPolicy()
    pol.bind(sim)
    subset = sim.clients[:1]
    assert [c.client_id for c in pol.present_clients(subset)] == [0]
    with pytest.raises(KeyError):
        pol.my_clients(subset)


# ----------------------------------------------------- bus unit behaviour
def test_bus_staleness_accounting():
    bus = InProcessBus()
    bus.publish("obs", shard=0, interval=5, payload="fresh")
    bus.publish("obs", shard=1, interval=1, payload="stale")
    got = bus.consume("obs", now=5, max_staleness=2)
    assert [m.payload for m in got] == ["fresh"]
    stats = bus.stats()
    assert stats["dropped_stale"] == 1
    assert stats["max_staleness_seen"] == 0
    # retained latest: one slot per shard (no queue history to grow),
    # staleness-filtered the same way
    bus.publish("demand", shard=0, interval=4, payload="a", retain=True)
    bus.publish("demand", shard=0, interval=6, payload="b", retain=True)
    bus.publish("demand", shard=1, interval=6, payload="c", retain=True)
    assert bus.consume("demand") == []       # retained != queued
    latest = bus.latest("demand", now=6, max_staleness=3, exclude_shard=1)
    assert [m.payload for m in latest] == ["b"]
    assert bus.stats()["max_staleness_seen"] == 0
    # re-polling a stale retained message must not inflate dropped_stale
    # (it would measure poll frequency, not messages)
    before = bus.stats()["dropped_stale"]
    for _ in range(3):
        assert bus.latest("demand", now=20, max_staleness=1) == []
    assert bus.stats()["dropped_stale"] == before
