"""The port's pluggable TuningPolicy API, twinned with
``tests/test_policies.py``: registry, lifecycle and path identity, run
against the port on the ``"scalar"`` backend the reference's tests use.
On top of them, Static, DIAL and Magpie make exactly the reference's
decisions (``==``) on the same fleet and seeds, on ``"scalar"`` and
``"soa"``.
"""
import numpy as np
import pytest

import repro.storage as ref_storage
import repro_torch.storage as port_storage
from repro.core import default_spaces as ref_default_spaces
from repro.core import make_policy as ref_make_policy
from repro_torch.config import CaratConfig
from repro_torch.core.controller import CaratController, NodeCacheArbiter
from repro_torch.core.policies import (POLICIES, CaratPolicy, DialPolicy,
                                       MagpieDrlPolicy, PerClientPolicy,
                                       StaticPolicy, make_policy,
                                       policy_from_config)
from repro_torch.core.policies.magpie import default_actions
from repro_torch.core.policy import CaratSpaces, default_spaces
from repro_torch.storage import (ClientConfig, SchedulePolicy, Simulation,
                                 get_workload, schedule_from_names)

SPACES = default_spaces()
WLS = ["s_rd_rn_8k", "s_wr_sq_1m", "s_rd_sq_1m", "s_wr_rn_8k"]


def _synthetic_model(salt: float):
    """Deterministic, batch-invariant pseudo-probabilities in [0, 1]."""

    def model(X):
        z = np.sin(X.astype(np.float64).sum(axis=1) * 12.9898 + salt)
        return (z + 1.0) / 2.0

    return model


def _models():
    return {"read": _synthetic_model(0.0), "write": _synthetic_model(1.7)}


def _sim(n=4, seed=11, backend="scalar", **kw):
    return Simulation([get_workload(WLS[i % len(WLS)]) for i in range(n)],
                      seed=seed, backend=backend, **kw)


# ------------------------------------------------------------------ registry
def test_registry_has_all_four_policies():
    assert set(POLICIES.keys()) >= {"carat", "static", "dial", "magpie"}
    assert POLICIES.get("carat") is CaratPolicy
    assert POLICIES.get("static") is StaticPolicy
    assert POLICIES.get("dial") is DialPolicy
    assert POLICIES.get("magpie") is MagpieDrlPolicy


def test_registry_miss_lists_known_policies():
    with pytest.raises(KeyError) as ei:
        make_policy("no_such_tuner")
    msg = str(ei.value)
    assert "no_such_tuner" in msg
    for name in ("carat", "static", "dial", "magpie"):
        assert name in msg


def test_policy_from_config_needs_policy_key():
    with pytest.raises(ValueError) as ei:
        policy_from_config({"spaces": SPACES})
    assert "carat" in str(ei.value)


@pytest.mark.parametrize("build", [
    lambda: make_policy("static", config=ClientConfig(64, 32, 128),
                        label="best"),
    lambda: make_policy("carat", spaces=SPACES, models=_models(),
                        cfg=CaratConfig(prob_tau=0.65), device="cpu",
                        stage2="scalar"),
    lambda: make_policy("dial", spaces=SPACES, dwell=5, epsilon=0.3, seed=9),
    lambda: make_policy("magpie", spaces=SPACES, dwell=2, epsilon=0.05,
                        seed=4),
])
def test_config_roundtrip(build):
    """config() -> policy_from_config reconstructs an equivalent policy."""
    p1 = build()
    p2 = policy_from_config(p1.config())
    assert type(p2) is type(p1)
    assert p2.config() == p1.config()


def test_config_roundtrip_equivalent_decisions():
    """Round-tripped policies are behaviourally equivalent, not just
    structurally: same decisions on the same simulation."""
    for build in (lambda: make_policy("dial", spaces=SPACES, seed=3),
                  lambda: make_policy("magpie", spaces=SPACES, seed=3),
                  lambda: make_policy("carat", spaces=SPACES,
                                      models=_models(), device="cpu")):
        p1, p2 = build(), None
        p2 = policy_from_config(p1.config())
        sim1, sim2 = _sim(), _sim()
        sim1.attach_policy(p1)
        sim2.attach_policy(p2)
        r1, r2 = sim1.run(8.0), sim2.run(8.0)
        assert r1.app_read_bytes == r2.app_read_bytes
        assert r1.app_write_bytes == r2.app_write_bytes
        assert [list(d) for d in p1.decisions] \
            == [list(d) for d in p2.decisions]


# ------------------------------------------------------ path identity
def test_all_attach_paths_identical():
    """The scalar per-client loop (PerClientPolicy), the prebuilt-shell
    fleet engine, and the self-wiring registry policy produce
    bit-identical decisions and bytes."""
    models = _models()
    cfg = CaratConfig()

    sim_a = _sim()                       # scalar: per-client callbacks
    percl = [CaratController(c.client_id, SPACES, models, cfg,
                             arbiter=NodeCacheArbiter(SPACES))
             for c in sim_a.clients]
    sim_a.attach_policy(PerClientPolicy({c.client_id: c for c in percl}))
    res_a = sim_a.run(10.0)

    sim_b = _sim()                       # prebuilt shells, batched engine
    shells = [CaratController(c.client_id, SPACES, models, cfg,
                              arbiter=NodeCacheArbiter(SPACES, deferred=True))
              for c in sim_b.clients]
    fleet = CaratPolicy(models=models, controllers=shells, device="cpu",
                        cfg=cfg)
    sim_b.attach_policy(fleet)
    res_b = sim_b.run(10.0)

    sim_c = _sim()                       # registry self-wiring
    policy = sim_c.attach_policy(make_policy(
        "carat", spaces=SPACES, models=models, cfg=cfg, device="cpu"))
    res_c = sim_c.run(10.0)

    assert [c.decisions for c in percl] == fleet.decisions \
        == policy.decisions
    assert res_a.app_read_bytes == res_b.app_read_bytes \
        == res_c.app_read_bytes
    assert res_a.app_write_bytes == res_b.app_write_bytes \
        == res_c.app_write_bytes
    assert [c.config.dirty_cache_mb for c in sim_a.clients] \
        == [c.config.dirty_cache_mb for c in sim_b.clients] \
        == [c.config.dirty_cache_mb for c in sim_c.clients]


def test_schedule_policy_switches_on_boundaries():
    """SchedulePolicy-driven workload switching lands exactly on
    interval boundaries."""
    sched = schedule_from_names(["s_rd_rn_8k", "s_wr_sq_1m"], phase_s=4.0)
    sim = Simulation([sched.spec_at(0.0)], seed=5, backend="scalar")
    sim.attach_policy(SchedulePolicy({0: sched}))
    names = []
    for _ in range(int(8.0 / sim.interval_s)):
        sim.step()
        names.append(sim.clients[0].workload.name)
    assert names[0] == "s_rd_rn_8k"
    assert names[-1] == "s_wr_sq_1m"
    assert len(set(names)) == 2


# ------------------------------------------------------------- lifecycle
def test_attach_policy_rejects_bad_phase():
    class Weird:
        phase = "sideways"

        def __call__(self, clients, t, dt):
            pass

    with pytest.raises(ValueError):
        _sim().attach_policy(Weird())


def test_attach_policy_client_subset():
    sim = _sim(n=3)
    policy = sim.attach_policy(make_policy("static",
                                           config=ClientConfig(16, 2, 64)),
                               client_ids=[1])
    assert policy.client_ids == [1]
    cfgs = [(c.config.rpc_window_pages, c.config.rpcs_in_flight,
             c.config.dirty_cache_mb) for c in sim.clients]
    assert cfgs[1] == (16, 2, 64)
    assert cfgs[0] == cfgs[2] == (1024, 8, 2048)


def test_attach_policy_unknown_client_id():
    with pytest.raises(KeyError):
        _sim(n=2).attach_policy(make_policy("static"), client_ids=[99])


def test_static_policy_applies_at_bind():
    sim = _sim(n=2)
    sim.attach_policy(make_policy("static", config=ClientConfig(32, 4, 256)))
    for c in sim.clients:
        assert (c.config.rpc_window_pages, c.config.rpcs_in_flight,
                c.config.dirty_cache_mb) == (32, 4, 256)
        # stats mirror must track the applied config
        assert c.stats.rpc_window_pages == 32
    sim.run(3.0)
    for c in sim.clients:       # never adapted
        assert (c.config.rpc_window_pages, c.config.rpcs_in_flight) == (32, 4)


def test_dial_policy_deterministic_and_on_grid():
    cands = set(SPACES.rpc_candidates())
    runs = []
    for _ in range(2):
        sim = _sim(seed=13)
        policy = sim.attach_policy(make_policy("dial", spaces=SPACES,
                                               seed=2))
        sim.run(15.0)
        runs.append([list(d) for d in policy.decisions])
        for per_client in policy.decisions:
            for (_, tag, w, f) in per_client:
                assert tag == "dial"
                assert (w, f) in cands
    assert runs[0] == runs[1]
    assert any(runs[0])         # the learner actually moved


def test_magpie_policy_fleet_wide_action():
    sim = _sim(n=4, seed=13)
    policy = sim.attach_policy(make_policy("magpie", spaces=SPACES, seed=2,
                                           dwell=2))
    sim.run(15.0)
    assert policy.decisions     # the actor acted
    acts = set(default_actions(SPACES))
    for (_, tag, w, f) in policy.decisions:
        assert tag == "magpie"
        assert (w, f) in acts
    # last action is fleet-wide: every client carries it
    _, _, w, f = policy.decisions[-1]
    for c in sim.clients:
        assert (c.config.rpc_window_pages, c.config.rpcs_in_flight) == (w, f)


def test_carat_policy_client_subset_has_no_phantom_arbiter_members():
    """Binding to a subset must not leave excluded clients registered as
    stage-2 arbiter members (they would inflate the member-scaled budget
    and emit stale all-zero demand rows at every drain)."""
    sim = _sim(n=4, topology=[0, 0, 0, 0])
    policy = sim.attach_policy(
        make_policy("carat", spaces=SPACES, models=_models(),
                    device="cpu"),
        client_ids=[0])
    assert [c.client_id for c in policy.controllers] == [0]
    arb = policy.controllers[0].arbiter
    assert len(arb.members) == 1
    assert arb.budget() == SPACES.cache_max * 0.75   # scaled by 1 member


def test_dial_policy_tolerates_off_grid_default():
    spaces = CaratSpaces((16, 32), (2, 4), (64,))    # default 1024/8 off-grid
    policy = make_policy("dial", spaces=spaces)
    assert policy._cands[policy._default_arm] == (16, 2)


def test_dial_policy_survives_degenerate_grid():
    """A 1x1 RPC grid has no neighbours: the learner must idle, not
    crash in the exploration draw."""
    spaces = CaratSpaces((16,), (8,), (64,))
    sim = Simulation([get_workload("s_rd_rn_8k")], seed=3, backend="scalar")
    policy = sim.attach_policy(make_policy("dial", spaces=spaces, dwell=1))
    sim.run(10.0)
    assert policy.decisions == [[]]     # nowhere to move, never moved


def test_carat_policy_rejects_subset_over_prebuilt_controllers():
    """A client_ids restriction cannot be applied to prebuilt shells —
    they are already wired to their arbiters."""
    models = _models()
    sim = _sim(n=2)
    shells = [CaratController(c.client_id, SPACES, models,
                              arbiter=NodeCacheArbiter(SPACES, deferred=True))
              for c in sim.clients]
    policy = CaratPolicy(models=models, controllers=shells, device="cpu")
    with pytest.raises(ValueError, match="prebuilt controllers"):
        sim.attach_policy(policy, client_ids=[0])
    # the exact prebuilt set is fine
    _sim(n=2).attach_policy(
        CaratPolicy(models=models, device="cpu", controllers=[
            CaratController(c.client_id, SPACES, models,
                            arbiter=NodeCacheArbiter(SPACES, deferred=True))
            for c in _sim(n=2).clients]),
        client_ids=[0, 1])


def test_detach_policy():
    """attach_policy/detach_policy: a detached hook stops being invoked;
    detaching an unknown policy fails loudly."""
    sim = _sim(n=2)
    calls = []
    hook = sim.attach_policy(lambda clients, t, dt: calls.append(t))
    sim.step()
    assert len(calls) == 1
    sim.detach_policy(hook)
    sim.step()
    assert len(calls) == 1      # detached
    with pytest.raises(ValueError):
        sim.detach_policy(hook)


def test_carat_policy_binds_topology_from_sim():
    sim = _sim(n=4, topology=[0, 0, 1, 1])
    policy = sim.attach_policy(make_policy("carat", spaces=SPACES,
                                           models=_models(),
                                           device="cpu"))
    arbs = {id(c.arbiter) for c in policy.controllers}
    assert len(arbs) == 2       # one deferred arbiter per node


# ------------------------------------------------------- spaces messages
def test_spaces_error_names_offending_grid():
    with pytest.raises(ValueError, match=r"rpcs_in_flight.*\(8, 4\)"):
        CaratSpaces((16,), (8, 4), (64,))
    with pytest.raises(ValueError, match="dirty_cache_mb grid must be "
                                         "non-empty"):
        CaratSpaces((16,), (8,), ())
    with pytest.raises(ValueError, match=r"rpc_window_pages.*\(16, 16\)"):
        CaratSpaces((16, 16), (8,), (64,))


# ------------------------------------------- the rivals against the reference
RIVALS = {
    "static": lambda spaces, cfg: {"config": cfg(64, 32, 128),
                                   "label": "best"},
    "dial": lambda spaces, cfg: {"spaces": spaces, "dwell": 2, "seed": 5},
    "magpie": lambda spaces, cfg: {"spaces": spaces, "dwell": 2,
                                   "epsilon": 0.3, "seed": 5},
}


@pytest.mark.parametrize("backend", ["scalar", "soa"])
@pytest.mark.parametrize("name", sorted(RIVALS))
def test_rival_decisions_equal_the_reference(name, backend):
    """Static, DIAL and Magpie on the same 8-client fleet and seeds as the
    reference: the same decisions, configs and bytes (``==``)."""
    def run(storage, make, spaces):
        sim = storage.Simulation(
            [storage.get_workload(WLS[i % len(WLS)]) for i in range(8)],
            seed=21, backend=backend)
        pol = sim.attach_policy(make(name, **RIVALS[name](
            spaces, storage.ClientConfig)))
        res = sim.run(15.0)
        return (getattr(pol, "decisions", None),
                [(c.config.rpc_window_pages, c.config.rpcs_in_flight,
                  c.config.dirty_cache_mb) for c in sim.clients],
                res.app_read_bytes, res.app_write_bytes,
                res.client_throughput)

    ours = run(port_storage, make_policy, SPACES)
    theirs = run(ref_storage, ref_make_policy, ref_default_spaces())
    assert ours == theirs
    if name != "static":
        assert any(ours[0])             # the learner moved
