"""The port's CARAT loop against the reference's, decision for decision.

The scenario is ``tests/test_fleet.py``'s controller trace (4 clients,
seed 5, 12 s, each tuner kind, the production GBDT pair carried across):
the port's ``CaratPolicy`` on its host ``soa`` core must make exactly the
reference ``CaratPolicy(backend="numpy")``'s decisions on the reference's
``soa`` core, leave identical dirty-cache limits and move identical
application bytes. On the ``soa-torch`` fleet (here on the CPU) the
fleet state is only ``rtol=1e-9``-close, and the decisions must still be
the same; a mismatch names the client, the interval and both feature
rows. A second scenario flips every client's op direction mid-run, so
each controller re-probes and takes a bootstrap pick through the
per-client scorer, over self-wired policies with shared node arbiters.
"""
import numpy as np
import pytest

import repro.storage as ref_storage
import repro_torch.storage as port_storage
from repro.config.types import CaratConfig as RefCaratConfig
from repro.core import CaratController as RefController
from repro.core import CaratPolicy as RefPolicy
from repro.core import NodeCacheArbiter as RefArbiter
from repro.core import default_spaces as ref_default_spaces
from repro_torch.config import CaratConfig
from repro_torch.core.controller import CaratController, NodeCacheArbiter
from repro_torch.core.ml.gbdt import gbdt_from_reference
from repro_torch.core.policies.carat import CaratPolicy
from repro_torch.core.policy import default_spaces

NAMES = ("s_rd_rn_8k", "s_wr_sq_1m", "s_rd_sq_1m", "s_wr_rn_8k")
KINDS = ("greedy", "epsilon_greedy", "conditional_score")
FLIP = {"s_rd_rn_8k": "s_wr_rn_8k", "s_wr_rn_8k": "s_rd_rn_8k",
        "s_rd_sq_1m": "s_wr_sq_1m", "s_wr_sq_1m": "s_rd_sq_1m"}


@pytest.fixture(scope="module")
def port_models(tiny_models):
    return {op: gbdt_from_reference(m.feat, m.thr, m.leaf, m.base,
                                    m.n_features)
            for op, m in tiny_models.items()}


class _FeatureLog:
    """Wraps a tuner's ``propose_many`` to keep (t, client_id, op, feats)
    per decision, so a mismatch can name what each side saw."""

    def __init__(self, policy, clock):
        self.rows = {}
        tuner = policy.tuner
        inner = tuner.propose_many
        ids = {id(c.tuner.rng): c.client_id for c in policy.controllers}

        def propose_many(ops, feats, rngs=None):
            for op, f, r in zip(ops, feats, rngs):
                self.rows[(clock(), ids[id(r)])] = (op, np.array(f))
            return inner(ops, feats, rngs=rngs)

        tuner.propose_many = propose_many


def _first_difference(a, b, log_a, log_b):
    for cid, (da, db) in enumerate(zip(a, b)):
        for ea, eb in zip(da + [None] * len(db), db + [None] * len(da)):
            if ea != eb:
                t = (ea or eb)[0]
                return (f"client {cid} at t={t}: {ea} vs {eb}; feature rows "
                        f"{log_a.rows.get((t, cid))} vs "
                        f"{log_b.rows.get((t, cid))}")
    return "decision lists differ in length"


def _ref_run(tiny_models, kind, backend):
    spaces = ref_default_spaces()
    cfg = RefCaratConfig(tuner=kind)
    sim = ref_storage.Simulation([ref_storage.get_workload(n)
                                  for n in NAMES], seed=5, backend=backend)
    ctrls = [RefController(i, spaces, tiny_models, cfg,
                           arbiter=RefArbiter(spaces))
             for i in range(len(NAMES))]
    policy = sim.attach_policy(RefPolicy(models=tiny_models,
                                         controllers=ctrls,
                                         backend="numpy"))
    log = _FeatureLog(policy, lambda: sim.t)
    return sim, ctrls, sim.run(12.0), log


def _port_run(port_models, kind, backend):
    spaces = default_spaces()
    cfg = CaratConfig(tuner=kind)
    sim = port_storage.Simulation([port_storage.get_workload(n)
                                   for n in NAMES], seed=5, backend=backend,
                                  device="cpu")
    ctrls = [CaratController(i, spaces, port_models, cfg,
                             arbiter=NodeCacheArbiter(spaces))
             for i in range(len(NAMES))]
    policy = sim.attach_policy(CaratPolicy(models=port_models,
                                           controllers=ctrls,
                                           device="cpu"))
    log = _FeatureLog(policy, lambda: sim.t)
    return sim, ctrls, sim.run(12.0), log


@pytest.mark.parametrize("kind", KINDS)
def test_host_soa_policy_matches_reference(tiny_models, port_models, kind):
    sa, ca, ra, la = _ref_run(tiny_models, kind, "soa")
    sb, cb, rb, lb = _port_run(port_models, kind, "soa")
    da, db = [c.decisions for c in ca], [c.decisions for c in cb]
    assert da == db, _first_difference(da, db, la, lb)
    assert any(da)
    assert [c.config.dirty_cache_mb for c in sa.clients] == \
           [c.config.dirty_cache_mb for c in sb.clients]
    assert ra.app_read_bytes == rb.app_read_bytes
    assert ra.app_write_bytes == rb.app_write_bytes


@pytest.mark.parametrize("kind", KINDS)
def test_device_fleet_policy_makes_the_same_decisions(tiny_models,
                                                      port_models, kind):
    sa, ca, ra, la = _ref_run(tiny_models, kind, "soa")
    sb, cb, rb, lb = _port_run(port_models, kind, "soa-torch")
    da, db = [c.decisions for c in ca], [c.decisions for c in cb]
    assert da == db, _first_difference(da, db, la, lb)
    assert [c.config.dirty_cache_mb for c in sa.clients] == \
           [c.config.dirty_cache_mb for c in sb.clients]
    np.testing.assert_allclose(rb.app_read_bytes, ra.app_read_bytes,
                               rtol=1e-9)
    np.testing.assert_allclose(rb.app_write_bytes, ra.app_write_bytes,
                               rtol=1e-9)


class _Flip:
    """Schedule: ``before`` until ``at`` seconds, then ``after``."""

    def __init__(self, before, after, at):
        self.before, self.after, self.boundaries = before, after, (at,)

    def spec_at(self, t):
        return self.before if t < self.boundaries[0] else self.after


def _flip_run(pkg, policy, n=16, node=4, seed=3):
    names = [NAMES[i % len(NAMES)] for i in range(n)]
    kw = {"device": "cpu"} if pkg is port_storage else {}
    sim = pkg.Simulation([pkg.get_workload(nm) for nm in names], seed=seed,
                         backend=("soa-torch" if pkg is port_storage
                                  else "soa"),
                         topology=[i // node for i in range(n)], **kw)
    sim.attach_policy(pkg.SchedulePolicy({
        c.client_id: _Flip(pkg.get_workload(nm), pkg.get_workload(FLIP[nm]),
                           4.0)
        for c, nm in zip(sim.clients, names)}))
    sim.attach_policy(policy)
    res = sim.run(10.0)
    return sim, res


def test_phase_flip_bootstraps_match_reference(tiny_models, port_models):
    """Self-wired policies over shared node arbiters, through a mid-run op
    flip: the re-probe and bootstrap picks (the per-client scorer path)
    and the stage-1 decisions match the reference's."""
    pa = RefPolicy(ref_default_spaces(), tiny_models, RefCaratConfig(),
                   backend="numpy")
    pb = CaratPolicy(default_spaces(), port_models, CaratConfig(),
                     device="cpu")
    sa, ra = _flip_run(ref_storage, pa)
    sb, rb = _flip_run(port_storage, pb)
    da, db = pa.decisions, pb.decisions
    assert da == db
    kinds = {d[1] for ds in db for d in ds}
    assert "bootstrap" in kinds
    assert pb.controllers[0].arbiter is pb.controllers[3].arbiter
    assert [c.config.dirty_cache_mb for c in sa.clients] == \
           [c.config.dirty_cache_mb for c in sb.clients]
    np.testing.assert_allclose(rb.app_write_bytes, ra.app_write_bytes,
                               rtol=1e-9)
