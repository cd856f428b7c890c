"""The port's multi-node stage-2 engine, twinned with
``tests/test_cache_fleet.py``: batched Algorithm 2 must equal the scalar
per-node path, budget trading must conserve the fleet budget, and the
fleet drain must reproduce per-client arbitration traces (on
``"scalar"``, the policies scoring on the CPU)."""
import functools

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.config import CaratConfig
from repro_torch.core import (CaratController, CaratPolicy, NodeCacheArbiter,
                              PerClientPolicy, default_spaces,
                              wire_controllers)
from repro_torch.core.cache_tuner import (CacheDemand, CacheDemandBatch,
                                          cache_allocation,
                                          cache_allocation_many,
                                          trade_node_budgets)
from repro_torch.core.ml.gbdt import default_models
from repro_torch.storage import Simulation, get_workload

# the reference's tests run on its default backend, ``"scalar"``; the
# port's default is the device fleet (``"soa-torch"`` on ``cuda``)
Simulation = functools.partial(Simulation, backend="scalar")


@pytest.fixture(scope="module")
def tiny_models():
    """The port's production GBDT pair: the committed seed-0 assets."""
    m_r, m_w = default_models()
    return {"read": m_r, "write": m_w}

SPACES = default_spaces()

# budgets spanning exhausted (0), tight, and all-fit (huge) regimes
BUDGETS = st.one_of(st.just(0.0), st.floats(0.0, 256.0),
                    st.floats(0.0, 8192.0),
                    st.floats(0.0, 50.0 * SPACES.cache_max))
DEMAND_ROW = st.tuples(st.booleans(), st.floats(0, 4e9), st.floats(0, 4e9),
                       st.floats(0, 1e7))
NODE = st.tuples(BUDGETS, st.lists(DEMAND_ROW, min_size=0, max_size=6))


def _build_nodes(nodes):
    """(budget, rows) tuples -> per-node CacheDemand lists with globally
    unique client ids, plus the budget array."""
    demands, budgets, cid = [], [], 0
    for budget, rows in nodes:
        dem = []
        for a, pc, pi, w in rows:
            dem.append(CacheDemand(cid, a, pc, pi, w))
            cid += 1
        demands.append(dem)
        budgets.append(budget)
    return demands, budgets


# ------------------------------------------------- vectorized == scalar
@settings(max_examples=60, deadline=None)
@given(nodes=st.lists(NODE, min_size=1, max_size=5))
def test_allocation_many_matches_scalar_per_node(nodes):
    """cache_allocation_many over a padded fleet tensor is decision-
    identical to running scalar cache_allocation once per node."""
    demands, budgets = _build_nodes(nodes)
    expected = [cache_allocation(d, SPACES, b)
                for d, b in zip(demands, budgets)]
    batch = CacheDemandBatch.pack(demands, budgets)
    got = batch.unpack(cache_allocation_many(batch, SPACES))
    assert got == expected


def test_allocation_many_exhausted_and_all_fit_edges():
    """The three Algorithm 2 branches, side by side in one batch."""
    demands = [
        # node 0: budget exhausted by idle minimums -> active gets the floor
        [CacheDemand(0, False, 0, 0, 0), CacheDemand(1, False, 0, 0, 0),
         CacheDemand(2, True, 4e9, 4e9, 5.0)],
        # node 1: everything fits at max
        [CacheDemand(3, True, 1e6, 0, 1.0), CacheDemand(4, True, 0, 0, 0.0)],
        # node 2: constrained -> three-factor max, snapped up
        [CacheDemand(5, True, 300 * 2**20, 0, 0.0),
         CacheDemand(6, True, 0, 700 * 2**20, 0.0)],
        # node 3: idle only
        [CacheDemand(7, False, 0, 0, 0.0)],
    ]
    budgets = [SPACES.cache_min * 2, 10.0 * SPACES.cache_max, 1024.0, 64.0]
    batch = CacheDemandBatch.pack(demands, budgets)
    got = batch.unpack(cache_allocation_many(batch, SPACES))
    assert got == [cache_allocation(d, SPACES, b)
                   for d, b in zip(demands, budgets)]
    assert got[0] == {0: SPACES.cache_min, 1: SPACES.cache_min,
                      2: SPACES.cache_min}
    assert got[1] == {3: SPACES.cache_max, 4: SPACES.cache_max}
    assert got[2] == {5: SPACES.snap_cache_up(300),
                      6: SPACES.snap_cache_up(700)}
    assert got[3] == {7: SPACES.cache_min}


def test_pack_handles_empty_nodes_and_padding():
    demands = [[], [CacheDemand(7, True, 1.0, 2.0, 3.0)]]
    batch = CacheDemandBatch.pack(demands, [100.0, 100.0])
    assert batch.valid.tolist() == [[False], [True]]
    assert batch.client_ids.tolist() == [[-1], [7]]
    alloc = cache_allocation_many(batch, SPACES)
    assert batch.unpack(alloc) == [{}, cache_allocation(demands[1], SPACES,
                                                        100.0)]
    assert alloc[0, 0] == 0          # padding slot untouched


def test_pack_rejects_mismatched_budgets():
    with pytest.raises(ValueError):
        CacheDemandBatch.pack([[]], [1.0, 2.0])


# ------------------------------------------------------- budget trading
@settings(max_examples=40, deadline=None)
@given(nodes=st.lists(NODE, min_size=1, max_size=6))
def test_budget_trading_conserves_fleet_budget(nodes):
    """Traded budgets never exceed the summed node budgets; lenders still
    cover their own all-fit commitment; borrowers never exceed theirs."""
    demands, budgets = _build_nodes(nodes)
    batch = CacheDemandBatch.pack(demands, budgets)
    effective = trade_node_budgets(batch, SPACES)
    total = float(np.sum(batch.node_budgets_mb))
    assert float(effective.sum()) <= total * (1 + 1e-12) + 1e-6
    active = batch.valid & batch.active
    idle = batch.valid & ~batch.active
    committed = (SPACES.cache_min * idle.sum(axis=1)
                 + SPACES.cache_max * active.sum(axis=1))
    for i in range(len(demands)):
        if effective[i] < batch.node_budgets_mb[i]:      # lender
            assert effective[i] >= committed[i] - 1e-6
        if effective[i] > batch.node_budgets_mb[i]:      # borrower
            assert effective[i] <= committed[i] + 1e-6


def test_budget_trading_moves_surplus_to_oversubscribed():
    demands = [
        [CacheDemand(0, True, 0, 0, 1.0)],                       # all-fit
        [CacheDemand(1, True, 4e9, 0, 1.0),                      # oversub
         CacheDemand(2, True, 4e9, 0, 1.0)],
    ]
    budgets = [4.0 * SPACES.cache_max, 0.5 * SPACES.cache_max]
    batch = CacheDemandBatch.pack(demands, budgets)
    effective = trade_node_budgets(batch, SPACES)
    assert effective[0] < budgets[0]
    assert effective[1] > budgets[1]
    # the pool covers the full shortfall here -> borrower reaches all-fit
    assert effective[1] == pytest.approx(2.0 * SPACES.cache_max)
    assert float(effective.sum()) == pytest.approx(sum(budgets))


def test_budget_trading_noop_without_surplus_or_deficit():
    demands = [[CacheDemand(0, True, 0, 0, 1.0)],
               [CacheDemand(1, True, 0, 0, 1.0)]]
    budgets = [float(SPACES.cache_max), float(SPACES.cache_max)]
    batch = CacheDemandBatch.pack(demands, budgets)
    assert trade_node_budgets(batch, SPACES).tolist() == budgets


# ----------------------------------------------- arbiter collect / apply
def test_arbiter_collect_passes_raw_write_volumes(tiny_models):
    arb = NodeCacheArbiter(SPACES)
    a = CaratController(0, SPACES, tiny_models, arbiter=arb)
    b = CaratController(1, SPACES, tiny_models, arbiter=arb)
    a.stage_factors.write_rpcs = 3.0e6
    b.stage_factors.write_rpcs = 1.0e6
    dem = arb.collect()
    assert [d.write_rpc_share for d in dem] == [3.0e6, 1.0e6]
    assert [d.client_id for d in dem] == [0, 1]


def test_deferred_arbiter_queues_and_apply_resets(tiny_models):
    arb = NodeCacheArbiter(SPACES, deferred=True)
    ctrl = CaratController(0, SPACES, tiny_models, arbiter=arb)
    ctrl.stage_factors.peak_cache_bytes = 99.0
    arb.mark_boundary(ctrl)
    assert arb.pending
    assert ctrl.stage_factors.peak_cache_bytes == 99.0   # not retuned yet
    arb.apply(cache_allocation(arb.collect(), SPACES, arb.budget()))
    assert not arb.pending
    assert ctrl.stage_factors.peak_cache_bytes == 0.0


# --------------------------------------------------- fleet-level checks
BURSTY = ("dlio_bert", "s_wr_sq_1m", "dlio_megatron", "s_rd_rn_8k")


def _sim(names, seed=5, **kw):
    return Simulation([get_workload(n) for n in names], seed=seed, **kw)


def test_fleet_deferred_drain_matches_per_client_trace(tiny_models):
    """Private per-client arbiters: the fleet's end-of-step stage-2 drain
    is trace-identical to inline per-client retunes (same demands, same
    allocations, applied before the next step's planning)."""
    cfg = CaratConfig()
    sim_a = _sim(BURSTY)
    percl = [CaratController(i, SPACES, tiny_models, cfg,
                             arbiter=NodeCacheArbiter(SPACES))
             for i in range(len(BURSTY))]
    sim_a.attach_policy(PerClientPolicy({c.client_id: c for c in percl}))
    res_a = sim_a.run(14.0)

    sim_b = _sim(BURSTY)
    fleet = sim_b.attach_policy(CaratPolicy(SPACES, tiny_models, cfg=cfg,
                                            device="cpu"))
    res_b = sim_b.run(14.0)

    assert fleet.node_retune_count > 0           # boundaries actually fired
    assert [c.decisions for c in percl] == fleet.decisions
    assert [c.config.dirty_cache_mb for c in sim_a.clients] == \
           [c.config.dirty_cache_mb for c in sim_b.clients]
    assert res_a.app_read_bytes == res_b.app_read_bytes
    assert res_a.app_write_bytes == res_b.app_write_bytes


def test_fleet_stage2_scalar_equals_batched_multi_node(tiny_models):
    """On a 2-node topology with tight budgets, the batched drain and the
    scalar per-node drain produce identical traces."""
    topology = [0, 0, 1, 1]
    budget = {0: 1.5 * SPACES.cache_max, 1: 1.5 * SPACES.cache_max}
    results = {}
    for mode in ("scalar", "batched"):
        sim = _sim(BURSTY, topology=topology)
        fleet = sim.attach_policy(CaratPolicy(SPACES, tiny_models,
                                              node_budgets_mb=budget,
                                              stage2=mode, device="cpu"))
        res = sim.run(14.0)
        results[mode] = ([c.config.dirty_cache_mb for c in sim.clients],
                         fleet.decisions, res.app_read_bytes,
                         res.app_write_bytes, fleet.node_retune_count)
    assert results["scalar"] == results["batched"]
    assert results["batched"][4] > 0


def test_fleet_budget_trading_runs_and_stays_on_grid(tiny_models):
    sim = _sim(BURSTY, topology=[0, 0, 1, 1])
    fleet = sim.attach_policy(CaratPolicy(
        SPACES, tiny_models, node_budgets_mb=float(SPACES.cache_max),
        budget_trading=True, device="cpu"))
    sim.run(14.0)
    assert fleet.node_retune_count > 0
    for c in sim.clients:
        assert c.config.dirty_cache_mb in SPACES.dirty_cache_mb


def test_fleet_resolves_clients_by_id(tiny_models):
    """A reordered client list must not make controllers tune the wrong
    client (the old positional clients[ctrl.client_id] lookup)."""
    sim = _sim(("s_rd_rn_8k", "s_wr_sq_1m"))
    ctrls = [CaratController(i, SPACES, tiny_models,
                             arbiter=NodeCacheArbiter(SPACES))
             for i in range(2)]
    fleet = CaratPolicy(models=tiny_models, controllers=ctrls,
                        device="cpu")
    sim.step()                       # advance counters once
    fleet(list(reversed(sim.clients)), sim.t, sim.interval_s)
    for ctrl in ctrls:
        assert ctrl.client is not None
        assert ctrl.client.client_id == ctrl.client_id


def test_fleet_missing_client_id_raises(tiny_models):
    sim = _sim(("s_rd_rn_8k",))
    ctrl = CaratController(3, SPACES, tiny_models,
                           arbiter=NodeCacheArbiter(SPACES))
    fleet = CaratPolicy(models=tiny_models, controllers=[ctrl],
                        device="cpu")
    with pytest.raises(KeyError, match="no matching client this step"):
        fleet(sim.clients, 0.5, 0.5)


# ----------------------------------------------------- topology plumbing
def test_simulation_topology_validation_and_node_clients():
    with pytest.raises(ValueError):
        _sim(("s_rd_rn_8k",), topology=[0, 1])
    sim = _sim(BURSTY, topology=[0, 0, 1, 1])
    assert sim.node_clients() == {0: [0, 1], 1: [2, 3]}
    assert _sim(("s_rd_rn_8k",)).node_clients() == {0: [0]}


def test_carat_policy_wiring_validation(tiny_models):
    sim = _sim(("s_rd_rn_8k", "s_wr_sq_1m"))
    with pytest.raises(ValueError):
        sim.attach_policy(CaratPolicy(SPACES, tiny_models, topology=[0],
                                      device="cpu"))
    with pytest.raises(ValueError):
        wire_controllers(sim, SPACES, tiny_models, topology=[0, 1],
                         shared_node_arbiter=True)
    with pytest.raises(ValueError):
        sim.attach_policy(CaratPolicy(SPACES, tiny_models, topology=[0, 1],
                                      node_budgets_mb={0: 512.0},
                                      device="cpu"))
    with pytest.raises(ValueError):
        CaratPolicy(models=tiny_models,
                    controllers=[CaratController(0, SPACES, tiny_models)],
                    stage2="bogus", device="cpu")


def test_carat_policy_uses_sim_topology(tiny_models):
    sim = _sim(BURSTY, topology=[0, 1, 0, 1])
    fleet = sim.attach_policy(CaratPolicy(SPACES, tiny_models,
                                          device="cpu"))
    arbs = {id(c.arbiter) for c in fleet.controllers}
    assert len(arbs) == 2
    assert fleet.controllers[0].arbiter is fleet.controllers[2].arbiter
    assert fleet.controllers[1].arbiter is fleet.controllers[3].arbiter
    assert all(c.arbiter.deferred for c in fleet.controllers)
