"""The port's fleet tuning engine, twinned with ``tests/test_fleet.py``:
batched decisions must equal the per-client path (on ``"scalar"``, the
scorers on the CPU). The reference's ``test_grid_scorer_jnp_backend_close``
has no twin: the port's grid scorer has no jnp backend."""
import functools
import sys

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.config import CaratConfig
from repro_torch.core import (CaratController, CaratPolicy, NodeCacheArbiter,
                              PerClientPolicy, build_fleet_tuner,
                              default_spaces, make_tuner)
from repro_torch.core.controller import _StageFactors
from repro_torch.core.ml.gbdt import default_models
from repro_torch.kernels.gbdt_infer.ops import GridGBDTScorer
from repro_torch.storage import Simulation, get_workload
from repro_torch.utils.rng import RngStream

# the reference's tests run on its default backend, ``"scalar"``; the
# port's default is the device fleet (``"soa-torch"`` on ``cuda``)
Simulation = functools.partial(Simulation, backend="scalar")


@pytest.fixture(scope="module")
def tiny_models():
    """The port's production GBDT pair: the committed seed-0 assets."""
    m_r, m_w = default_models()
    return {"read": m_r, "write": m_w}

SPACES = default_spaces()
THETA = SPACES.theta_features()
NC = len(SPACES.rpc_candidates())
KINDS = ("greedy", "epsilon_greedy", "conditional_score")


@pytest.fixture(scope="module", autouse=True)
def _jax_x64_off_after():
    """The reference's ``soa-jax`` backend turns JAX's float64 mode on for
    its whole process, and its tests leave it on. A test worker runs other
    files after this one, and the reference's nets (``tests/test_ml.py``)
    need JAX's default, so put it back when this module ends."""
    yield
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.config.update("jax_enable_x64", False)


def _synthetic_model(salt: float):
    """Deterministic, batch-invariant pseudo-probabilities in [0, 1]."""

    def model(X):
        z = np.sin(X.astype(np.float64).sum(axis=1) * 12.9898 + salt)
        return (z + 1.0) / 2.0

    return model


# --------------------------------------------------- tuner-level property
@settings(max_examples=25, deadline=None)
@given(kind=st.sampled_from(KINDS), seed=st.integers(0, 10_000),
       n=st.integers(1, 9))
def test_propose_many_matches_scalar_synthetic(kind, seed, n):
    """propose_many == per-client propose for every strategy, any op mix,
    random feature vectors (generic cross-product fallback path)."""
    rng = np.random.default_rng(seed)
    models = {"read": _synthetic_model(0.0), "write": _synthetic_model(1.7)}
    ops = [("read", "write")[int(rng.integers(2))] for _ in range(n)]
    feats = rng.normal(size=(n, 20)).astype(np.float32)
    scalar = [make_tuner(kind, SPACES, models, rng=RngStream(i, "cl"))
              for i in range(n)]
    fleet = make_tuner(kind, SPACES, models, rng=RngStream(10**6, "fleet"))
    expected = [scalar[i].propose(ops[i], feats[i]) for i in range(n)]
    got = fleet.propose_many(ops, feats,
                             rngs=[RngStream(i, "cl") for i in range(n)])
    assert got == expected


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 1000), n=st.integers(1, 8),
       op=st.sampled_from(["read", "write"]))
def test_grid_scorer_bit_identical(tiny_models, seed, n, op):
    """GridGBDTScorer (numpy backend) reproduces the scalar cross-product
    probabilities bit-for-bit — the contract the fleet engine relies on."""
    model = tiny_models[op]
    scorer = GridGBDTScorer(model, THETA, device="cpu")
    H = np.random.default_rng(seed).normal(size=(n, 20)).astype(np.float32)
    probs = scorer(H)
    assert probs.shape == (n, NC)
    for i in range(n):
        X = np.concatenate([np.broadcast_to(H[i], (NC, 20)), THETA],
                           axis=1).astype(np.float32)
        assert np.array_equal(probs[i], model.predict_proba(X))


@settings(max_examples=15, deadline=None)
@given(kind=st.sampled_from(KINDS), seed=st.integers(0, 1000),
       n=st.integers(1, 6))
def test_propose_many_matches_scalar_gbdt(tiny_models, kind, seed, n):
    """Same property through the real GBDT pair + grid fast path."""
    rng = np.random.default_rng(seed)
    models = {op: m.predict_proba for op, m in tiny_models.items()}
    grid = {op: GridGBDTScorer(m, THETA, device="cpu")
            for op, m in tiny_models.items()}
    ops = [("read", "write")[int(rng.integers(2))] for _ in range(n)]
    feats = (rng.normal(size=(n, 20)) * 0.5).astype(np.float32)
    scalar = [make_tuner(kind, SPACES, models, rng=RngStream(i, "cl"))
              for i in range(n)]
    fleet = make_tuner(kind, SPACES, models, rng=RngStream(10**6, "fl"),
                       grid_models=grid)
    expected = [scalar[i].propose(ops[i], feats[i]) for i in range(n)]
    got = fleet.propose_many(ops, feats,
                             rngs=[RngStream(i, "cl") for i in range(n)])
    assert got == expected


# ------------------------------------------------ controller-level traces
@pytest.mark.parametrize("kind", KINDS)
def test_fleet_controller_matches_per_client_trace(tiny_models, kind):
    """Full simulation: fleet decisions, cache limits, and the resulting
    I/O trace are identical to attaching the controllers individually."""
    names = ("s_rd_rn_8k", "s_wr_sq_1m", "s_rd_sq_1m", "s_wr_rn_8k")
    cfg = CaratConfig(tuner=kind)

    def build(sim, fleet):
        ctrls = [CaratController(i, SPACES, tiny_models, cfg,
                                 arbiter=NodeCacheArbiter(SPACES))
                 for i in range(len(names))]
        if fleet:
            sim.attach_policy(CaratPolicy(models=tiny_models,
                                          controllers=ctrls,
                                          device="cpu"))
        else:
            sim.attach_policy(PerClientPolicy(
                {c.client_id: c for c in ctrls}))
        return ctrls

    sim_a = Simulation([get_workload(n) for n in names], seed=5)
    a = build(sim_a, fleet=False)
    res_a = sim_a.run(12.0)
    sim_b = Simulation([get_workload(n) for n in names], seed=5)
    b = build(sim_b, fleet=True)
    res_b = sim_b.run(12.0)

    assert [c.decisions for c in a] == [c.decisions for c in b]
    assert [c.config.dirty_cache_mb for c in sim_a.clients] == \
           [c.config.dirty_cache_mb for c in sim_b.clients]
    assert res_a.app_read_bytes == res_b.app_read_bytes
    assert res_a.app_write_bytes == res_b.app_write_bytes


def test_carat_policy_shared_node_topology(tiny_models):
    sim = Simulation([get_workload("s_rd_rn_8k"),
                      get_workload("s_wr_sq_1m")], seed=1)
    fleet = sim.attach_policy(CaratPolicy(SPACES, tiny_models,
                                          device="cpu",
                                          topology=[0, 0]))
    assert fleet.controllers[0].arbiter is fleet.controllers[1].arbiter
    sim.run(10.0)
    assert fleet.decision_count > 0
    assert fleet.mean_decision_s > 0.0
    assert len(fleet.decisions) == 2


def test_build_fleet_tuner_uses_grid_for_gbdt(tiny_models):
    tuner = build_fleet_tuner(CaratConfig(), SPACES, tiny_models,
                              device="cpu")
    assert set(tuner.grid_models) == {"read", "write"}


# ------------------------------------------------------- stage-2 bugfixes
def test_retune_preserves_mid_active_stage_factors(tiny_models):
    """Members that did not cross the inactive->active boundary keep their
    accumulated factors (regression test for the reset-everyone bug)."""
    arb = NodeCacheArbiter(SPACES)
    mid = CaratController(0, SPACES, tiny_models, arbiter=arb)
    crossing = CaratController(1, SPACES, tiny_models, arbiter=arb)
    mid.stage_factors.peak_cache_bytes = 123.0
    mid.was_inactive_long = False            # still mid-active-stage
    crossing.stage_factors.peak_cache_bytes = 456.0
    crossing.was_inactive_long = True        # at the boundary
    arb.retune()
    assert mid.stage_factors.peak_cache_bytes == 123.0
    assert crossing.stage_factors.peak_cache_bytes == 0.0
    assert isinstance(crossing.stage_factors, _StageFactors)
