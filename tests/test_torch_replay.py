"""The port's trace replay, twinned with ``tests/test_replay.py``.

The twins run the reference's replay tests against the port (each
replayed simulation on the backend it names: the reference's tests rely
on its ``"scalar"`` default, the port's builders default to
``"soa-torch"`` on ``cuda``). On top of them, the port's parser,
renderer, segmenter and ``synthesize_trace`` are held equal to the
reference's, field for field, on the bundled corpus and on synthesized
traces.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.storage as ref_storage
import repro.storage.replay as ref_replay
from repro_torch.config import CaratConfig
from repro_torch.core.controller import CaratController, NodeCacheArbiter
from repro_torch.core.ml.gbdt import default_models
from repro_torch.core.policies import PerClientPolicy
from repro_torch.core.policy import default_spaces
from repro_torch.storage import (PAGE_SIZE, Simulation, bundled_traces,
                                 compile_trace, get_workload, idle_workload,
                                 load_bundled_trace, parse_trace,
                                 render_trace, schedule_from_names,
                                 simulation_from_schedules,
                                 simulation_from_trace, synthesize_trace)
from repro_torch.storage.replay import (IDLE, SchedulePhase, TraceRecord,
                                        WorkloadSchedule, segment_phases)
from repro_torch.storage.stats import ClientStats

# the replayed-simulation twins run on every backend of the port
BACKENDS = ("scalar", "soa", "soa-torch")


def _replay(schedules, backend, **kw):
    if backend == "soa-torch":
        kw["device"] = "cpu"
    return simulation_from_schedules(schedules, backend=backend, **kw)


def _fields(obj):
    """A dataclass graph as plain tuples: the port's and the reference's
    classes differ, their field values must not."""
    if isinstance(obj, dict):
        return {k: _fields(v) for k, v in obj.items()}
    return dataclasses.astuple(obj)


def _records(trace):
    return (trace.name, {cid: tuple(_fields(r) for r in recs)
                         for cid, recs in trace.records.items()})


# ------------------------------------------------------------- parsing --
def test_bundled_traces_parse_deterministically():
    assert len(bundled_traces()) >= 3
    for name in bundled_traces():
        t1, t2 = load_bundled_trace(name), load_bundled_trace(name)
        assert t1 == t2
        assert compile_trace(t1) == compile_trace(t2)
        # canonical render round-trips
        assert parse_trace(render_trace(t1), name=name) == t1


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 1000))
def test_synthetic_roundtrip(seed):
    t = synthesize_trace(seed, n_clients=2, duration_s=30.0)
    assert t.n_records > 0
    rt = parse_trace(render_trace(t), name=t.name)
    assert rt == t
    assert compile_trace(rt) == compile_trace(t)


def test_parse_rejects_bad_input():
    header = ("client,t_start,t_end,op,access,req_bytes,stride_bytes,"
              "streams,read_frac,duty_cycle,period_s,file_bytes,"
              "inplace_frac")
    with pytest.raises(ValueError):
        parse_trace("")                                   # empty
    with pytest.raises(ValueError):
        parse_trace("a,b\n1,2")                           # bad header
    with pytest.raises(ValueError):                        # overlap
        parse_trace(f"{header}\n"
                    f"0,0,10,read,seq,8192,0,1,0,1,1,1024,0\n"
                    f"0,5,15,read,seq,8192,0,1,0,1,1,1024,0\n")
    with pytest.raises(ValueError):                        # stride < req
        parse_trace(f"{header}\n"
                    f"0,0,10,write,strided,8192,4096,1,0,1,1,1024,0\n")


# ------------------------------------------- the port against the reference
def test_bundled_corpus_equals_the_reference():
    """The bundled corpus is the reference's, file for file, and parses,
    renders and compiles to the reference's records and schedules."""
    assert bundled_traces() == ref_replay.bundled_traces()
    for name in bundled_traces():
        ours, theirs = load_bundled_trace(name), \
            ref_replay.load_bundled_trace(name)
        assert _records(ours) == _records(theirs)
        assert render_trace(ours) == ref_replay.render_trace(theirs)
        assert _fields(compile_trace(ours)) == \
            _fields(ref_replay.compile_trace(theirs))


@pytest.mark.parametrize("seed", [0, 7, 123, 999])
@pytest.mark.parametrize("n_clients,duration_s", [(2, 30.0), (16, 20.0)])
def test_synthesized_traces_equal_the_reference(seed, n_clients,
                                                duration_s):
    """``synthesize_trace`` draws from the same seeded streams as the
    reference, and its traces render, re-parse and compile alike."""
    ours = synthesize_trace(seed, n_clients=n_clients,
                            duration_s=duration_s)
    theirs = ref_replay.synthesize_trace(seed, n_clients=n_clients,
                                         duration_s=duration_s)
    assert _records(ours) == _records(theirs)
    text = render_trace(ours)
    assert text == ref_replay.render_trace(theirs)
    assert _records(parse_trace(text, name="x")) == \
        _records(ref_replay.parse_trace(text, name="x"))
    assert _fields(compile_trace(ours)) == \
        _fields(ref_replay.compile_trace(theirs))


@pytest.mark.parametrize("backend", ["scalar", "soa"])
def test_replayed_run_equals_the_reference(backend):
    """A synthesized trace replayed on a host backend moves exactly the
    reference's bytes, interval for interval."""
    trace = synthesize_trace(11, n_clients=6, duration_s=20.0)
    ours, _ = simulation_from_trace(trace, seed=2, backend=backend)
    theirs, _ = ref_storage.simulation_from_trace(
        ref_replay.synthesize_trace(11, n_clients=6, duration_s=20.0),
        seed=2, backend=backend)
    ra, rb = ours.run(20.0), theirs.run(20.0)
    assert ra.client_throughput == rb.client_throughput
    assert ra.app_read_bytes == rb.app_read_bytes
    assert ra.app_write_bytes == rb.app_write_bytes
    assert [c.workload.name for c in ours.clients] == \
        [c.workload.name for c in theirs.clients]


# ----------------------------------------------------------- segmenter --
def _rec(t0, t1, **kw):
    base = dict(client=0, t_start=t0, t_end=t1, op="read", access="random",
                req_bytes=8192, file_bytes=1 << 30)
    base.update(kw)
    return TraceRecord(**base)


def test_segmenter_merges_similar_adjacent_records():
    sched = segment_phases([_rec(0, 5), _rec(5, 10, req_bytes=9216)], 0)
    assert len(sched.phases) == 1
    ph = sched.phases[0]
    assert (ph.start_s, ph.end_s) == (0.0, 10.0)
    # duration-weighted request size
    assert ph.spec.req_bytes == int(round((8192 + 9216) / 2))


def test_segmenter_splits_dissimilar_and_inserts_idle():
    sched = segment_phases(
        [_rec(0, 5), _rec(5, 10, op="write", access="seq"),
         _rec(13, 20, op="write", access="seq")], 0)
    kinds = [(p.spec.idle, p.spec.op, p.spec.access) for p in sched.phases]
    assert kinds == [(False, "read", "random"), (False, "write", "seq"),
                     (True, "read", "seq"), (False, "write", "seq")]
    idle = sched.phases[2]
    assert (idle.start_s, idle.end_s) == (10.0, 13.0)


def test_segmenter_absorbs_subthreshold_gaps():
    sched = segment_phases([_rec(0, 5), _rec(5.4, 10, op="write")], 0,
                           gap_s=1.0)
    assert len(sched.phases) == 2
    # small gap absorbed by extending the earlier phase
    assert sched.phases[0].end_s == pytest.approx(5.4)


def test_schedule_spec_at_and_boundaries():
    sched = schedule_from_names(["s_rd_rn_8k", "s_wr_sq_1m"], phase_s=5.0,
                                gap_s=2.0)
    assert sched.spec_at(0.0).name == "s_rd_rn_8k"
    assert sched.spec_at(4.99).name == "s_rd_rn_8k"
    assert sched.spec_at(5.0).idle            # gap phase
    assert sched.spec_at(7.0).name == "s_wr_sq_1m"
    assert sched.spec_at(99.0) is IDLE        # past the end
    assert sched.duration == pytest.approx(12.0)
    # every workload change: phase starts, gap edges, trailing idle edge
    assert sched.boundaries == (0.0, 5.0, 7.0, 12.0)
    with pytest.raises(ValueError):           # overlapping phases rejected
        WorkloadSchedule(0, (
            SchedulePhase(0.0, 5.0, get_workload("s_rd_rn_8k")),
            SchedulePhase(4.0, 8.0, get_workload("s_wr_sq_1m"))))


# --------------------------------------------------------- replayed sim --
@pytest.mark.parametrize("backend", BACKENDS)
def test_sim_switches_workloads_at_phase_boundaries(backend):
    sched = schedule_from_names(["s_rd_rn_8k", "s_wr_sq_1m"], phase_s=4.0)
    sim = _replay({0: sched}, backend, seed=0)
    client = sim.clients[0]
    seen = []
    while sim.t < 8.0:
        sim.step()
        seen.append(client.workload.name)
    assert "s_rd_rn_8k" in seen and "s_wr_sq_1m" in seen
    # switch happened exactly at the 4 s boundary (steps are 0.5 s)
    assert seen[7] == "s_rd_rn_8k" and seen[8] == "s_wr_sq_1m"


@pytest.mark.parametrize("backend", BACKENDS)
def test_counters_monotone_across_switches(backend):
    trace = synthesize_trace(7, n_clients=2, duration_s=25.0)
    kw = {"device": "cpu"} if backend == "soa-torch" else {}
    sim, _ = simulation_from_trace(trace, seed=1, backend=backend, **kw)
    counters = ("app_bytes", "rpc_count", "rpc_bytes", "lat_sum_s",
                "active_s")
    prev = {c.client_id: ClientStats() for c in sim.clients}
    for _ in range(50):
        sim.step()
        for c in sim.clients:
            for op in ("read", "write"):
                for f in counters:
                    cur = getattr(getattr(c.stats, op), f)
                    assert cur >= getattr(getattr(prev[c.client_id], op),
                                          f) - 1e-9
            prev[c.client_id] = c.stats.snapshot()


@pytest.mark.parametrize("backend", BACKENDS)
def test_dirty_cache_carries_across_switch(backend):
    """Carried state is deliberately preserved: a write phase's dirty pages
    survive the boundary into the next phase and drain there."""
    sched = schedule_from_names(["s_wr_sq_1m", "s_rd_rn_8k"], phase_s=5.0)
    sim = _replay({0: sched}, backend, seed=0)
    client = sim.clients[0]
    while sim.t < 5.0:
        sim.step()
    dirty_at_switch = client.dirty_bytes
    assert dirty_at_switch > 0            # the write phase left dirty pages
    sim.step()
    assert client.workload.name == "s_rd_rn_8k"
    # not wiped by the switch: only writeback (bounded per step) shrinks it
    assert client.dirty_bytes > 0.25 * dirty_at_switch
    while sim.t < 10.0:
        sim.step()
    assert client.dirty_bytes < dirty_at_switch   # ...and it drains


def test_replayed_gap_fires_stage2_boundary():
    """A trace gap longer than inactive_threshold_s arms the stage-2
    boundary, which fires at the inactive->active edge."""
    m_read, m_write = default_models()
    sched = schedule_from_names(["s_rd_rn_8k", "s_wr_sq_1m"], phase_s=5.0,
                                gap_s=2.0)   # gap > inactive_threshold_s=1
    sim = _replay({0: sched}, "scalar", seed=0)
    spaces = default_spaces()
    arb = NodeCacheArbiter(spaces, deferred=True)
    ctrl = CaratController(0, spaces, {"read": m_read, "write": m_write},
                           CaratConfig(), arbiter=arb)
    sim.attach_policy(PerClientPolicy({0: ctrl}))
    while sim.t < 5.0:
        sim.step()
    assert not arb.pending                # still mid-first-phase
    while sim.t < 9.0:
        sim.step()
    assert arb.pending and arb.crossings >= 1


# ------------------------------------------------ satellite regressions --
class _Recorder:
    def __init__(self):
        self.seen = []

    def __call__(self, client, t, dt):
        self.seen.append(client.client_id)


def test_controllers_resolve_by_client_id_not_position():
    """Regression: Simulation.step used self.clients[cid] — positional —
    so non-dense/reordered client id sets tuned the wrong client."""
    wls = [get_workload("s_rd_rn_8k"), get_workload("s_wr_sq_1m")]
    sim = Simulation(wls, seed=0, client_ids=[7, 3], backend="scalar")
    rec = _Recorder()
    sim.attach_policy(PerClientPolicy({3: rec}))
    sim.step()
    assert rec.seen == [3]
    # reordering the client list after attach must not change resolution
    sim.clients.reverse()
    sim.step()
    assert rec.seen == [3, 3]
    with pytest.raises(KeyError):
        # unknown id fails fast at bind
        sim.attach_policy(PerClientPolicy({0: rec}))


def test_client_ids_validation():
    wls = [get_workload("s_rd_rn_8k")] * 2
    with pytest.raises(ValueError):
        Simulation(wls, client_ids=[1], backend="scalar")     # wrong length
    with pytest.raises(ValueError):
        Simulation(wls, client_ids=[1, 1], backend="scalar")  # duplicates


def test_stage_factors_use_page_size():
    """Regression: _StageFactors.update hardcoded 4096.0 instead of the
    shared PAGE_SIZE constant."""
    import repro_torch.core.controller as cmod
    from repro_torch.core.controller import _StageFactors
    from repro_torch.core.metrics import Metrics
    from repro_torch.core.snapshot import Snapshot
    assert cmod.PAGE_SIZE == PAGE_SIZE
    m = Metrics(0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    snap = Snapshot(t=1.0, read=m, write=m, read_active=True,
                    write_active=False, read_app_bytes=1.0,
                    write_app_bytes=0.0, dirty_peak_bytes=0.0,
                    inflight_peak=3.0, window_pages=256, in_flight=8,
                    dirty_cache_mb=512)
    f = _StageFactors()
    f.update(snap)
    assert f.peak_inflight_bytes == pytest.approx(3.0 * 256 * PAGE_SIZE)


def test_idle_workload_never_active():
    idle = idle_workload()
    assert idle.idle
    for t in np.linspace(0.0, 10.0, 23):
        assert not idle.active(float(t))
