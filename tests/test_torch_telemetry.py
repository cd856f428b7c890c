"""The port's telemetry subsystem, twinned with ``tests/test_telemetry.py``.

Three layers:

* **unit** — recorder ring/metrics semantics, clock-offset estimation,
  Chrome/Perfetto export, flight-recorder windows, fleet collection;
* **conformance (S3)** — with telemetry enabled, the recorder's bus
  counters/histograms must agree with ``BusAccounting.stats()``
  counter-for-counter across all three transports, through reconnect
  storms and heartbeat storms alike (the telemetry mirror shares the
  ``_deliver`` choke point, so disagreement means a second code path
  crept in);
* **integration** — a spawned fleet with telemetry on stays
  bit-identical to the single-process oracle (the port's and the
  reference's), cross-worker batches carry estimated clock offsets, and
  a ``KillShard`` leaves behind a readable flight dump plus a
  Perfetto-loadable trace.

The end of the file checks what the chip run relies on to see a
worker's kernel launches: every bootstrap pick is one ``gbdt_logits``
call and one ``carat.bootstrap`` counter, in one process and summed
over a process fleet's workers.
"""
import json
import socket as socket_mod

import pytest

from test_torch_transport import (KINDS, _bus, _carat_build, _flip_build,
                                  _paired, _signature)

from repro_torch.core.runtime import InProcessBus
from repro_torch.core.runtime.telemetry.clock import Clock, estimate_offset
from repro_torch.core.runtime.telemetry.collect import FleetCollector
from repro_torch.core.runtime.telemetry.events import (
    CounterEvent, EventBatch, SpanEvent,
)
from repro_torch.core.runtime.telemetry.export import trace_events, write_trace
from repro_torch.core.runtime.telemetry.flight import FlightRecorder, read_dump
from repro_torch.core.runtime.telemetry.recorder import (
    NullRecorder, Recorder, active, disable, enable, enabled, install,
    metrics_delta,
)
from repro_torch.core.runtime.transport import (KillShard, SocketBus,
                                                SocketBusHost)
from repro_torch.runtime.fault_tolerance import HeartbeatTracker


@pytest.fixture(autouse=True)
def _restore_recorder():
    """Every test leaves the process-global recorder as it found it."""
    prev = active()
    yield
    install(prev)


# ===================================================== recorder semantics
def test_disabled_by_default_and_noop():
    disable()
    rec = active()
    assert isinstance(rec, NullRecorder) and not rec.enabled
    # the no-op span is one shared, reusable object — no allocation on
    # the disabled hot path
    assert rec.span("plan") is rec.span("resolve", cat="sim")
    with rec.span("plan"):
        rec.count("x")
        rec.gauge("g", 1.0)
        rec.hist("h", 2.0)
    batch = rec.drain()
    assert batch.n_events == 0 and batch.source == ""


def test_enabled_scope_restores_previous():
    disable()
    with enabled(source="t") as rec:
        assert active() is rec and rec.enabled
    assert not active().enabled


def test_spans_record_name_cat_duration_interval():
    rec = Recorder(source="t", capacity=16)
    rec.set_interval(3)
    with rec.span("plan", cat="sim"):
        with rec.span("inner"):
            pass
    batch = rec.drain()
    names = [s.name for s in batch.spans]
    assert names == ["inner", "plan"]       # exit order: innermost first
    for s in batch.spans:
        assert s.dur >= 0.0 and s.interval == 3
    assert batch.spans[1].cat == "sim"
    # nesting: inner sits inside plan's window
    inner, plan = batch.spans
    assert plan.t0 <= inner.t0
    assert inner.t0 + inner.dur <= plan.t0 + plan.dur + 1e-9


def test_counters_flush_once_per_interval_sorted():
    rec = Recorder(source="t", capacity=32)
    rec.count("b.z")
    rec.count("a.y", 2.0)
    rec.count("b.z", 3.0)
    rec.gauge("m.g", 7.5)
    rec.set_interval(1)                     # flush dirty set
    rec.set_interval(2)                     # nothing dirty: no new events
    batch = rec.drain()
    assert [c.name for c in batch.counters] == ["a.y", "b.z", "m.g"]
    by_name = {c.name: c for c in batch.counters}
    assert by_name["b.z"].value == 4.0 and by_name["b.z"].kind == "count"
    assert by_name["m.g"].value == 7.5 and by_name["m.g"].kind == "gauge"
    # flushed samples are stamped with the interval they accumulated in
    assert all(c.interval == -1 for c in batch.counters)


def test_ring_wraps_keeping_newest_and_counts_drops():
    rec = Recorder(source="t", capacity=4)
    for i in range(10):
        with rec.span(f"s{i}"):
            pass
    batch = rec.drain()
    assert [s.name for s in batch.spans] == ["s6", "s7", "s8", "s9"]
    assert batch.dropped == 6
    # metrics survive the lossy timeline: totals stay exact
    rec2 = Recorder(source="t", capacity=2)
    for _ in range(100):
        rec2.count("n")
    assert rec2.snapshot()["counters"]["n"] == 100.0


def test_drain_clears_ring_but_keeps_metrics():
    rec = Recorder(source="t", capacity=8)
    with rec.span("a"):
        pass
    rec.count("c", 5.0)
    first = rec.drain()
    assert len(first.spans) == 1
    assert first.metrics["counters"]["c"] == 5.0
    second = rec.drain()
    assert second.n_events == 0 and second.dropped == 0
    assert second.metrics["counters"]["c"] == 5.0     # totals persist


def test_metrics_delta_between_snapshots():
    prev = {"counters": {"a": 10.0}, "gauges": {"g": 1.0},
            "hists": {"h": {0.0: 4, 1.0: 1}}}
    cur = {"counters": {"a": 13.0, "b": 2.0}, "gauges": {"g": 9.0},
           "hists": {"h": {0.0: 6, 1.0: 1}, "k": {2.0: 3}}}
    d = metrics_delta(cur, prev)
    assert d["counters"] == {"a": 3.0, "b": 2.0}
    assert d["gauges"] == {"g": 9.0}                  # gauges: last value
    assert d["hists"] == {"h": {0.0: 2}, "k": {2.0: 3}}


def test_recorder_rejects_degenerate_capacity():
    with pytest.raises(ValueError, match="capacity"):
        Recorder(source="t", capacity=0)


# ===================================================== clock-skew handling
def test_estimate_offset_minimum_rtt_filter():
    # three synthetic round trips; the middle one has the lowest RTT and
    # a known true offset of +5.0 s
    trips = iter([(0.0, 1.0, 10.0),      # rtt 1.0, offset 9.5 (noisy)
                  (2.0, 2.2, 7.1),       # rtt 0.2, offset 5.0  <- wins
                  (4.0, 5.0, 14.0)])     # rtt 1.0, offset 9.5 (noisy)
    assert estimate_offset(lambda: next(trips), samples=3) == \
        pytest.approx(5.0)


def test_clock_normalized_applies_offset():
    t = [100.0]
    clk = Clock(offset_s=2.5, base=lambda: t[0])
    assert clk.now() == 100.0                 # raw: recording path
    assert clk.normalized() == 102.5          # shifted: reference timeline


def test_events_carry_raw_time_batch_carries_offset():
    t = [50.0]
    rec = Recorder(source="w9", capacity=8,
                   clock=Clock(offset_s=3.0, base=lambda: t[0]))
    with rec.span("step"):
        t[0] = 50.5
    batch = rec.drain()
    (s,) = batch.spans
    assert s.t0 == 50.0 and s.dur == pytest.approx(0.5)
    assert batch.clock_offset_s == 3.0
    # the exporter is the one place the shift happens
    evs = [e for e in trace_events([batch]) if e["ph"] == "X"]
    assert evs[0]["ts"] == pytest.approx((50.0 + 3.0) * 1e6)


# ============================================================ exporters
def _batch(source, offset=0.0, spans=(), counters=()):
    return EventBatch(source=source, clock_offset_s=offset,
                      spans=tuple(spans), counters=tuple(counters))


def test_trace_export_shape_and_determinism(tmp_path):
    batches = [
        _batch("w1", 0.25,
               spans=[SpanEvent("plan", "sim", 1.0, 0.1, 0)],
               counters=[CounterEvent("bus.published", 1.2, 4.0, 0,
                                      "count")]),
        _batch("coord",
               spans=[SpanEvent("resolve", "sim", 1.05, 0.2, 0)]),
    ]
    evs = trace_events(batches)
    meta = [e for e in evs if e["ph"] == "M"]
    assert [m["args"]["name"] for m in meta] == ["coord", "w1"]  # sorted
    xs = [e for e in evs if e["ph"] == "X"]
    cs = [e for e in evs if e["ph"] == "C"]
    assert len(xs) == 2 and len(cs) == 1
    # same-source events share a pid; different sources differ
    (w1_pid,) = {e["pid"] for e in xs if e["name"] == "plan"}
    (co_pid,) = {e["pid"] for e in xs if e["name"] == "resolve"}
    assert w1_pid != co_pid
    assert cs[0]["ts"] == pytest.approx((1.2 + 0.25) * 1e6)

    path = write_trace(str(tmp_path / "trace.json"), batches)
    with open(path) as f:
        doc = json.load(f)
    assert doc["traceEvents"] == evs       # loadable, content identical


# ====================================================== flight recorder
def test_flight_window_trims_to_last_intervals(tmp_path):
    fr = FlightRecorder(str(tmp_path), last_intervals=2)
    spans = [SpanEvent(f"s{k}", "sim", float(k), 0.1, k)
             for k in range(5)]
    startup = SpanEvent("handshake", "runtime", -1.0, 0.1, -1)
    fr.observe(_batch("w0", spans=[startup] + spans))
    path = fr.dump("w0", "test")
    dump = read_dump(path)
    kept = {s["name"] for s in dump["spans"]}
    # last 2 intervals (3, 4) plus pre-interval startup events
    assert kept == {"handshake", "s3", "s4"}
    assert dump["reason"] == "test" and dump["source"] == "w0"


def test_flight_dump_unseen_source_and_dump_all(tmp_path):
    fr = FlightRecorder(str(tmp_path))
    assert fr.dump("ghost", "x") is None
    fr.observe(_batch("w0", spans=[SpanEvent("a", "", 0.0, 0.1, 0)]))
    fr.observe(_batch("w1", spans=[SpanEvent("b", "", 0.0, 0.1, 0)]))
    paths = fr.dump_all("shutdown")
    assert len(paths) == 2
    assert all(read_dump(p)["reason"] == "shutdown" for p in paths)


def test_flight_dump_normalizes_timestamps(tmp_path):
    fr = FlightRecorder(str(tmp_path))
    fr.observe(_batch("w0", offset=2.0,
                      spans=[SpanEvent("a", "", 1.0, 0.1, 0)]))
    dump = read_dump(fr.dump("w0", "skew"))
    assert dump["spans"][0]["t0"] == pytest.approx(3.0)
    assert dump["clock_offset_s"] == 2.0


def test_read_dump_validates_shape(tmp_path):
    bad = tmp_path / "flight-x.json"
    bad.write_text(json.dumps({"source": "x"}), encoding="utf-8")
    with pytest.raises(ValueError, match="missing"):
        read_dump(str(bad))


# ====================================================== fleet collector
def test_collector_aggregation_and_flight(tmp_path):
    col = FleetCollector(flight_dir=str(tmp_path))
    col.add(EventBatch(source="w0", clock_offset_s=0.1,
                       spans=(SpanEvent("a", "", 0.0, 0.1, 0),),
                       metrics={"counters": {"n": 1.0}}, dropped=2))
    col.add(EventBatch(source="w0", clock_offset_s=0.1,
                       metrics={"counters": {"n": 5.0}}, dropped=1))
    col.add(EventBatch(source="coord", clock_offset_s=0.0))
    assert col.sources() == ["coord", "w0"]
    assert col.metrics()["w0"]["counters"]["n"] == 5.0   # last batch wins
    assert col.clock_offsets() == {"w0": 0.1, "coord": 0.0}
    assert col.dropped() == 3
    assert col.dump_flight("w0", "test") is not None
    assert col.dump_flight("nope", "test") is None
    assert len(col.flight_paths) == 1


# ================================ S3: bus-accounting conformance mirror
@pytest.mark.parametrize("kind", KINDS)
def test_bus_telemetry_agrees_with_accounting(kind):
    """Same traffic script as the transport-conformance suite: the
    recorder's bus counters and its staleness-at-delivery histogram
    must match ``stats()`` exactly, on every transport. Both sides of
    the mirror live in ``BusAccounting._deliver``/``publish``, so this
    gate fails the moment a transport grows a second delivery path."""
    with enabled(source="conf") as rec, _bus(kind) as bus:
        bus.publish("obs/0", 0, 5, "fresh")
        bus.publish("obs/0", 1, 1, "late")        # staleness 4: dropped
        bus.publish("obs/0", 1, 4, "ok")          # staleness 1: delivered
        got = bus.consume("obs/0", now=5, max_staleness=2)
        assert [m.payload for m in got] == ["fresh", "ok"]
        bus.publish("dec/0", "coordinator", 5, "d")
        bus.consume("dec/0")                      # unbounded consume
        for (s, i) in [(0, 4), (1, 6), (2, 1)]:
            bus.publish("demand", s, i, "x", retain=True)
        bus.latest("demand", now=6, max_staleness=3)

        stats = bus.stats()
        snap = rec.snapshot()
        c = snap["counters"]
        assert c["bus.published"] == stats["published"] == 7
        assert c["bus.consumed"] == stats["consumed"]
        assert c.get("bus.dropped_stale", 0) == stats["dropped_stale"] == 1
        hist = snap["hists"]["bus.staleness_at_delivery"]
        # worst delivered staleness: histogram max == accounting max
        assert max(hist) == stats["max_staleness_seen"]
        # every bounded delivery left exactly one histogram entry:
        # 2 consumed + 2 retained reads (shard 2's was over-stale)
        assert sum(hist.values()) == 4
        if kind != "inprocess":
            # the RPC latency histogram saw every client round trip
            assert sum(snap["hists"]["bus.rpc_ms"].values()) > 0


def test_socket_reconnect_storm_counts_match():
    """S3: sever the server side repeatedly; the telemetry counter must
    track the transport's own ``reconnects`` attribute through the
    storm."""
    with enabled(source="storm") as rec:
        host = SocketBusHost()
        cli = SocketBus(host.address, peer="w0", authkey=host.authkey,
                        max_retries=8, backoff_s=0.01, backoff_cap_s=0.05)
        try:
            for k in range(3):
                cli.publish("t", 0, k, "x")
                for conn in list(host._conns):   # sever server-side
                    try:
                        conn.shutdown(socket_mod.SHUT_RDWR)
                    except OSError:
                        pass
                cli.stats()                      # detect + reconnect
            assert cli.reconnects >= 3
            assert rec.snapshot()["counters"]["bus.reconnects"] == \
                cli.reconnects
        finally:
            cli.close()
            host.close()


def test_heartbeat_gap_histogram_under_injected_clock():
    """S3: beats on a fake clock land in 10 ms-bucketed gap histogram
    entries the coordinator can read straggler signatures from."""
    t = [0.0]
    tracker = HeartbeatTracker(timeout_s=5.0, clock=lambda: t[0])
    with enabled(source="hb") as rec:
        for gap in [0.10, 0.10, 0.104, 0.50]:
            tracker.beat("w0", interval=1)
            t[0] += gap
        tracker.beat("w0", interval=2)
        snap = rec.snapshot()
        assert snap["counters"]["bus.heartbeats"] == 5
        # 0.10 and 0.104 share the 0.1 bucket (rounded to 10 ms)
        assert snap["hists"]["bus.heartbeat_gap_s"] == {0.1: 3, 0.5: 1}


# ============================== integration: fleet telemetry end to end
def test_sync_identity_preserved_with_telemetry_on():
    """The overhead contract's identity half: a telemetry-enabled
    process fleet is bit-identical to the telemetry-off single-process
    oracle — recording reads clocks and writes its own buffers, never
    touching RNG or float order."""
    sig_a, sig_b, _, _, prt = _paired(
        _carat_build(seed=7), 10.0, telemetry=True)
    assert sig_a == sig_b
    col = prt.telemetry
    assert col is not None
    assert "coord" in col.sources()
    assert {"w0", "w1"} <= set(col.sources())
    assert col.metrics()["coord"]["counters"]["bus.published"] > 0


def test_kill_shard_produces_flight_dump_and_trace(tmp_path):
    """Acceptance gate: a fleet run with a KillShard injection and
    telemetry on must (a) stay identical to the oracle, (b) leave a
    readable flight dump for the killed worker, and (c) export a
    Perfetto-loadable trace whose cross-worker spans carry estimated
    clock offsets."""
    build = _carat_build(budgets={0: 1e4, 1: 1e4}, trading=True)
    sig_a, sig_b, _, _, prt = _paired(
        build, 12.0, events=[KillShard(at_interval=8, sid=1)],
        snapshot_every=2, telemetry=True, flight_dir=str(tmp_path))
    assert sig_a == sig_b
    col = prt.telemetry

    # (b) the kill left a postmortem for w1
    kills = [p for p in col.flight_paths if "KillShard" in p]
    assert kills, f"no KillShard flight dump in {col.flight_paths}"
    dump = read_dump(kills[0])
    assert dump["source"] == "w1"
    assert dump["spans"], "flight window empty — worker recorded nothing"

    # (c) trace exports, loads, and spans all the fleet's processes
    path = col.write_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    phases = {e["ph"] for e in doc["traceEvents"]}
    assert {"M", "X", "C"} <= phases
    span_names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"plan", "resolve", "commit", "policy.observe",
            "policy.decide", "policy.actuate"} <= span_names
    # worker offsets were estimated at handshake (coordinator's is 0);
    # same-host skew is tiny but the estimate must exist per worker
    offsets = col.clock_offsets()
    assert set(offsets) >= {"coord", "w0", "w1"}
    assert offsets["coord"] == 0.0


def test_telemetry_off_fleet_records_nothing():
    disable()
    sig_a, sig_b, _, _, prt = _paired(_carat_build(seed=9), 8.0)
    assert sig_a == sig_b
    assert prt.telemetry is None
    assert not active().enabled          # nothing auto-enabled


# ============ a worker's kernel launches, as the parent sees them
def _bootstraps(policy):
    return sum(d[1] == "bootstrap" for log in policy.decisions for d in log)


def test_each_bootstrap_pick_is_one_gbdt_logits_call(monkeypatch):
    """In one process, over the committed GBDT pair: the plain version of
    ``gbdt_logits`` runs once per bootstrap pick and at no other time,
    and the recorder's ``carat.bootstrap`` counter moves with it. On the
    card that call is one kernel launch, so a worker's launches are its
    ``carat.bootstrap`` count."""
    from repro_torch.kernels.gbdt_infer import kernel
    calls = []
    plain = kernel.gbdt_logits_ref

    def counted(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(kernel, "gbdt_logits_ref", counted)
    sim, policy = _flip_build()()
    with enabled(source="one") as rec:
        sim.run(6.0)
        counter = rec.snapshot()["counters"]["carat.bootstrap"]
    picks = _bootstraps(policy)
    assert picks > 0
    assert len(calls) == counter == picks
    assert set(calls) == {(63, 22)}          # one candidate grid per pick


def test_worker_bootstrap_counters_sum_to_the_single_process_picks():
    """A telemetry-on process fleet over the same scenario: the workers'
    ``carat.bootstrap`` counters, read from the collector, add up to the
    single-process run's bootstrap picks, and the parent took none."""
    sig_a, sig_b, pol_a, _, prt = _paired(_flip_build(), 6.0,
                                          telemetry=True)
    assert sig_a == sig_b
    metrics = prt.telemetry.metrics()
    workers = sorted(src for src in metrics if src.startswith("w"))
    assert workers == ["w0", "w1"]
    total = sum(metrics[w]["counters"].get("carat.bootstrap", 0.0)
                for w in workers)
    assert total == _bootstraps(pol_a) > 0
    assert "carat.bootstrap" not in metrics["coord"]["counters"]
