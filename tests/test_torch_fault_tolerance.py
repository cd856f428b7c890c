"""The port's fault-tolerance bookkeeping, twinned with the
fault-tolerance half of ``tests/test_ckpt_runtime.py`` (its checkpoint
half waits for the port's training slice). The end of the file drives
the port's and the reference's monitor, straggler detector and
heartbeat tracker through the same seeded sequences and holds every
plan, flag and liveness set equal."""
import numpy as np
import pytest

import repro.runtime.fault_tolerance as ref_ft
from repro_torch.runtime.fault_tolerance import (ClusterMonitor,
                                                 HeartbeatTracker,
                                                 StragglerDetector,
                                                 _largest_pow2_leq)


# ------------------------------------------------------------ fault tolerance
def test_monitor_declares_death_and_plans_shrink():
    # 8 hosts, TP groups of 2 => data axis of 4
    groups = {h: h // 2 for h in range(8)}
    mon = ClusterMonitor(8, groups, data_size=4, miss_limit=2)
    alive = set(range(8)) - {5}
    assert mon.tick(alive) is None         # first miss: not dead yet
    plan = mon.tick(alive)                 # second miss: dead
    assert plan is not None
    assert 5 in plan.dead_hosts
    # group 2 lost => 3 replicas survive => shrink to pow2 = 2
    assert plan.new_data_size == 2


def test_monitor_heartbeat_resets():
    mon = ClusterMonitor(4, {h: h for h in range(4)}, data_size=4,
                         miss_limit=2)
    assert mon.tick({0, 1, 2}) is None
    assert mon.tick({0, 1, 2, 3}) is None   # host 3 came back
    assert mon.tick({0, 1, 2}) is None      # needs 2 consecutive again
    assert not mon.dead


def test_pow2():
    assert _largest_pow2_leq(1) == 1
    assert _largest_pow2_leq(7) == 4
    assert _largest_pow2_leq(16) == 16


def test_straggler_io_goes_to_carat_not_eviction():
    det = StragglerDetector(4, threshold=1.5, patience=2)
    for _ in range(5):
        det.observe([1.0, 1.0, 1.0, 2.5], io_waits=[0, 0, 0, 1.4])
    assert 3 in det.io_stragglers()
    assert 3 not in det.to_evict()


def test_straggler_compute_eviction():
    det = StragglerDetector(4, threshold=1.5, patience=2)
    for _ in range(5):
        det.observe([1.0, 1.0, 1.0, 2.5], io_waits=[0, 0, 0, 0.0])
    assert 3 in det.to_evict()


# ------------------------------------------------- the port == the reference
@pytest.mark.parametrize("seed", range(4))
def test_monitor_plans_equal_the_references(seed):
    rng = np.random.default_rng(seed)
    n_hosts, tp = 16, 2
    groups = {h: h // tp for h in range(n_hosts)}
    port = ClusterMonitor(n_hosts, groups, data_size=n_hosts // tp,
                          miss_limit=3)
    ref = ref_ft.ClusterMonitor(n_hosts, groups, data_size=n_hosts // tp,
                                miss_limit=3)
    plans = 0
    for _ in range(40):
        alive = {h for h in range(n_hosts) if rng.random() > 0.3}
        for h in rng.choice(n_hosts, 2):
            port.heartbeat(int(h))
            ref.heartbeat(int(h))
        a, b = port.tick(alive), ref.tick(alive)
        assert (a is None) == (b is None)
        if a is not None:
            plans += 1
            assert (a.dead_hosts, a.old_data_size, a.new_data_size,
                    a.restart_step, a.shrink_factor) == \
                (b.dead_hosts, b.old_data_size, b.new_data_size,
                 b.restart_step, b.shrink_factor)
        assert port.missed == ref.missed and port.dead == ref.dead
    assert plans > 0


@pytest.mark.parametrize("seed", range(4))
def test_straggler_flags_equal_the_references(seed):
    rng = np.random.default_rng(seed)
    n = 8
    port = StragglerDetector(n, threshold=1.4, patience=3)
    ref = ref_ft.StragglerDetector(n, threshold=1.4, patience=3)
    slow = rng.choice(n, 2, replace=False)
    for _ in range(30):
        times = 1.0 + 0.1 * rng.random(n)
        times[slow] *= 1.5 + rng.random(2)
        waits = list(rng.random(n) * (times - 1.0))
        port.observe(list(times), io_waits=waits)
        ref.observe(list(times), io_waits=waits)
        assert port.step_time == ref.step_time
        assert port.strikes == ref.strikes
        assert port.io_stragglers() == ref.io_stragglers()
        assert port.to_evict() == ref.to_evict()
    assert port.io_stragglers() | port.to_evict()


def test_heartbeat_tracker_equals_the_references():
    t = [0.0]
    port = HeartbeatTracker(timeout_s=1.0, clock=lambda: t[0])
    ref = ref_ft.HeartbeatTracker(timeout_s=1.0, clock=lambda: t[0])
    script = [("beat", "w0", 1), ("beat", "w1", None), ("tick", 0.6, None),
              ("beat", "w0", 2), ("tick", 0.6, None), ("forget", "w1", None),
              ("beat", "w2", 5), ("tick", 1.2, None)]
    for op, a, b in script:
        for tr in (port, ref):
            if op == "beat":
                tr.beat(a, b)
            elif op == "forget":
                tr.forget(a)
        if op == "tick":
            t[0] += a
        assert port.peers() == ref.peers()
        assert port.alive() == ref.alive() and port.dead() == ref.dead()
        assert [port.interval(p) for p in ("w0", "w1", "w2")] == \
            [ref.interval(p) for p in ("w0", "w1", "w2")]
    assert port.dead() == {"w0", "w2"} - port.alive()
