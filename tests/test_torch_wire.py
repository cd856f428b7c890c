"""The port's wire round-trip contract, twinned with ``tests/test_wire.py``:
every payload type that may cross a process/host bus boundary
round-trips value- and type-exactly, and anything alive — a torch tensor
included — raises :class:`WireError` at the publishing side. The end of
the file holds the port's encoding to the reference's, node for node,
for the same inputs.

Property tests run under real hypothesis or the bundled fallback shim
(tests/conftest.py), so strategies stick to the shim-supported set.
"""
import pickle
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core.cache_tuner as ref_cache_tuner
import repro.core.runtime.bus as ref_bus
import repro.core.runtime.telemetry.events as ref_events
import repro.core.runtime.transport.wire as ref_wire
import repro.storage.client as ref_client
import repro.storage.soa as ref_soa
from repro_torch.core.cache_tuner import CacheDemand
from repro_torch.core.runtime.bus import BusMessage
from repro_torch.core.runtime.telemetry.clock import Clock
from repro_torch.core.runtime.telemetry.events import (CounterEvent,
                                                       EventBatch, SpanEvent)
from repro_torch.core.runtime.telemetry.recorder import Recorder
from repro_torch.core.runtime.transport import (WireError, assert_wire_safe,
                                                from_wire, to_wire)
from repro_torch.storage.client import ChannelDemand
from repro_torch.storage.soa import DemandBatch
from repro_torch.utils.rng import RngStream


def _rt(payload):
    return from_wire(to_wire(payload))


# ------------------------------------------------------- plain-value trees
ATOM = st.one_of(
    st.just(None),
    st.booleans(),
    st.integers(min_value=-2**40, max_value=2**40),
    st.floats(min_value=-1e12, max_value=1e12),
    st.sampled_from(["", "x", "obs/3", "dirty_cache_mb", "π"]),
    st.sampled_from([b"", b"\x00\xff", b"opaque blob"]),
)
KEY = st.sampled_from(["seed", "name", "gen", "k1", "k2"])
TREE = st.one_of(
    ATOM,
    st.lists(ATOM, max_size=4),
    st.tuples(ATOM, ATOM, st.lists(ATOM, max_size=3)),
    st.lists(st.tuples(KEY, ATOM), max_size=3).map(dict),
    st.lists(st.tuples(ATOM, st.lists(ATOM, max_size=3)), max_size=3),
)


@settings(max_examples=60, deadline=None)
@given(TREE)
def test_tree_round_trip_equality(tree):
    back = _rt(tree)
    assert back == tree
    assert type(back) is type(tree)


def test_containers_keep_exact_types():
    # tuples stay tuples, lists stay lists — the obs/decision protocol
    # pattern-matches on them
    assert _rt((1, [2.0, "x"], {"k": (None, True)})) == \
        (1, [2.0, "x"], {"k": (None, True)})
    assert type(_rt((1, 2))) is tuple
    assert type(_rt([1, 2])) is list
    assert type(_rt({"a": 1})) is dict


def test_opaque_bytes_blobs_are_first_class():
    # policy snapshots / worker reports travel as pre-pickled blobs the
    # transport must not need to understand
    blob = pickle.dumps({"sid": 1, "interval": 7})
    assert _rt(blob) == blob
    assert _rt((1, blob))[1] == blob


# --------------------------------------------------------------- numpy
@settings(max_examples=30, deadline=None)
@given(st.lists(st.floats(min_value=-1e6, max_value=1e6),
                min_size=1, max_size=8),
       st.sampled_from(["<f8", "<f4", "<i8", "<i4", "|b1"]))
def test_ndarray_round_trip_value_and_dtype_exact(vals, dtype):
    a = np.asarray(vals).astype(np.dtype(dtype))
    b = _rt(a)
    assert isinstance(b, np.ndarray)
    assert b.dtype == a.dtype
    assert b.shape == a.shape
    assert np.array_equal(b, a)


def test_ndarray_noncontiguous_and_multidim():
    a = np.arange(24, dtype=np.float64).reshape(4, 6)[::2, ::3]
    b = _rt(a)
    assert np.array_equal(b, a) and b.dtype == a.dtype
    # the decoded array is an owned, writable copy (no frombuffer view
    # leaking read-only wire bytes into simulation state)
    b[0, 0] = -1.0


def test_numpy_scalar_round_trip():
    for s in (np.float32(1.5), np.int64(-7), np.bool_(True)):
        b = _rt(s)
        assert b == s and b.dtype == s.dtype


def test_object_dtype_ndarray_rejected():
    with pytest.raises(WireError, match="object-dtype"):
        to_wire(np.array([{}, None], dtype=object))


# ----------------------------------------------------- payload dataclasses
@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=0, max_value=99),
       st.integers(min_value=0, max_value=7),
       st.booleans(),
       st.floats(min_value=0.0, max_value=1e9),
       st.floats(min_value=0.0, max_value=256.0),
       st.floats(min_value=0.0, max_value=64.0))
def test_channel_demand_round_trip(cid, ost, is_read, rate, pages, window):
    d = ChannelDemand(cid, ost, "read" if is_read else "write",
                      rate, pages, window)
    back = _rt(d)
    assert type(back) is ChannelDemand
    assert back == d
    # the class's own contract, without the wire around it
    assert ChannelDemand.from_wire(d.to_wire()) == d


@settings(max_examples=20, deadline=None)
@given(st.integers(min_value=0, max_value=99), st.booleans(),
       st.floats(min_value=0.0, max_value=1e9),
       st.floats(min_value=0.0, max_value=1e9),
       st.floats(min_value=0.0, max_value=1e6))
def test_cache_demand_round_trip(cid, active, peak_c, peak_i, share):
    d = CacheDemand(cid, active, peak_c, peak_i, share)
    back = _rt(d)
    assert type(back) is CacheDemand
    assert back == d
    assert CacheDemand.from_wire(d.to_wire()) == d


def test_demand_batch_round_trip():
    d = DemandBatch(ost=np.array([0, 1, 1], dtype=np.int64),
                    rpc_rate=np.array([5.0, 2.5, 0.0]),
                    rpc_pages=np.array([64.0, 8.0, 1.0]),
                    window=np.array([4.0, 4.0, 1.0]),
                    ordinal=np.array([0, 2, 5], dtype=np.int64))
    back = _rt(d)
    assert type(back) is DemandBatch
    for f in ("ost", "rpc_rate", "rpc_pages", "window", "ordinal"):
        a, b = getattr(d, f), getattr(back, f)
        assert b.dtype == a.dtype and np.array_equal(b, a)


def test_bus_message_round_trip_nested():
    m = BusMessage("obs/0", 3, 7, (42, ("read", [1.0, 2.0], None)))
    back = _rt(m)
    assert type(back) is BusMessage
    assert back == m
    # demand echoes nest payload dataclasses inside the message
    m2 = BusMessage("demand", "coordinator", 0,
                    [ChannelDemand(1, 0, "write", 3.0, 16.0, 4.0)])
    assert _rt(m2) == m2


# --------------------------------------------------- RNG state, not objects
@settings(max_examples=10, deadline=None)
@given(st.integers(min_value=0, max_value=2**31),
       st.sampled_from(["root", "tuner/7", "client/3/tuner"]))
def test_rng_state_round_trips_and_resumes_bit_exact(seed, name):
    rng = RngStream(seed, name)
    rng.gen.random(5)                       # advance off the origin
    state = rng.state()
    twin_direct = RngStream.from_state(state)
    twin_wire = RngStream.from_state(_rt(state))
    assert twin_wire.seed == rng.seed and twin_wire.name == rng.name
    assert twin_wire.gen.random(6).tolist() == \
        twin_direct.gen.random(6).tolist()


def test_live_rng_stream_rejected():
    with pytest.raises(WireError, match="not wire-safe"):
        to_wire(RngStream(0))


# ----------------------------------------------------- live-object policing
class _NotAPayload:
    pass


class _SneakyStr(str):
    pass


@pytest.mark.parametrize("bad", [
    threading.Lock(),
    threading.Event(),
    lambda: None,
    object(),
    {1, 2},                     # set: unregistered container
    _NotAPayload(),
    torch.zeros(3),             # torch never crosses: the tuners give NumPy
    torch.tensor(1.5),
], ids=["lock", "event", "lambda", "object", "set", "custom-class",
        "torch-tensor", "torch-scalar"])
def test_live_objects_rejected(bad):
    with pytest.raises(WireError):
        to_wire(bad)
    # nesting does not launder the leak
    with pytest.raises(WireError):
        to_wire((1, {"k": [bad]}))


def test_atom_subclass_rejected():
    # a str/int subclass may smuggle extra state; the wire refuses to
    # silently flatten it
    with pytest.raises(WireError, match="subclasses a wire atom"):
        to_wire(_SneakyStr("looks innocent"))


def test_unknown_wire_tag_rejected():
    with pytest.raises(WireError, match="unknown wire tag"):
        from_wire(("zz", ()))


def test_assert_wire_safe():
    assert_wire_safe((1, "ok", [2.0], {"k": b"blob"}))
    with pytest.raises(WireError):
        assert_wire_safe({"inner": threading.Lock()})


# ------------------------------------------------ telemetry event batches
NAME = st.sampled_from(["plan", "resolve", "policy.decide", "bus.rpc_ms"])
SEC = st.floats(min_value=0.0, max_value=1e6)
IVAL = st.integers(min_value=-1, max_value=2**20)


def _span_events():
    return st.tuples(
        NAME, st.sampled_from(["sim", "policy", "bus", ""]),
        SEC, st.floats(min_value=0.0, max_value=10.0), IVAL,
    ).map(lambda t: SpanEvent(*t))


def _counter_events():
    return st.tuples(
        NAME, SEC, st.floats(min_value=-1e9, max_value=1e9), IVAL,
        st.sampled_from(["count", "gauge"]),
    ).map(lambda t: CounterEvent(*t))


@settings(max_examples=30, deadline=None)
@given(_span_events())
def test_span_event_round_trip(ev):
    back = _rt(ev)
    assert back == ev and type(back) is SpanEvent


@settings(max_examples=30, deadline=None)
@given(_counter_events())
def test_counter_event_round_trip(ev):
    back = _rt(ev)
    assert back == ev and type(back) is CounterEvent


@settings(max_examples=20, deadline=None)
@given(st.lists(_span_events(), max_size=4).map(tuple),
       st.lists(_counter_events(), max_size=4).map(tuple),
       st.floats(min_value=-1.0, max_value=1.0),
       st.integers(min_value=0, max_value=1000))
def test_event_batch_round_trip(spans, counters, offset, dropped):
    batch = EventBatch(
        source="w3", clock_offset_s=offset, spans=spans,
        counters=counters, dropped=dropped,
        metrics={"counters": {"bus.published": 12.0},
                 "gauges": {"queue_depth": 3.0},
                 "hists": {"bus.staleness_at_delivery": {0.0: 9, 1.0: 2}}})
    back = _rt(batch)
    assert back == batch and type(back) is EventBatch
    assert type(back.spans) is tuple and type(back.counters) is tuple
    for orig, rt in zip(batch.spans, back.spans):
        assert type(rt) is SpanEvent and rt == orig


def test_drained_recorder_batch_round_trips():
    # the real producer path: record through a Recorder, drain, wire it
    rec = Recorder(source="w0", capacity=64)
    with rec.span("plan", cat="sim"):
        pass
    rec.count("bus.published", 3)
    rec.hist("bus.rpc_ms", 0.2)
    rec.set_interval(1)                 # flushes the dirty counter
    batch = rec.drain()
    assert _rt(batch) == batch


def test_live_recorder_and_clock_rejected():
    # only drained data travels: the live objects are deliberately
    # unregistered — a recorder in a payload would drag its lock along
    with pytest.raises(WireError):
        to_wire(Recorder(source="w0", capacity=8))
    with pytest.raises(WireError):
        to_wire(Clock())
    with pytest.raises(WireError):
        to_wire(("telem", {"rec": Recorder(source="x", capacity=8)}))


# ------------------------------------- the port's encoding == the reference's
def _payload_pairs():
    """The same payload built from each package's classes: (port, ref)."""
    rates = np.array([5.0, 2.5, 0.0])
    pairs = [
        (ChannelDemand(3, 1, "read", 12.5, 64.0, 4.0),
         ref_client.ChannelDemand(3, 1, "read", 12.5, 64.0, 4.0)),
        (CacheDemand(7, True, 1.5e6, 2.0e5, 0.25),
         ref_cache_tuner.CacheDemand(7, True, 1.5e6, 2.0e5, 0.25)),
        (SpanEvent("plan", "sim", 1.25, 0.5, 3),
         ref_events.SpanEvent("plan", "sim", 1.25, 0.5, 3)),
        (CounterEvent("bus.published", 2.0, 9.0, 4, "count"),
         ref_events.CounterEvent("bus.published", 2.0, 9.0, 4, "count")),
    ]
    batch = {f: np.array(v) for f, v in (("ost", [0, 1, 1]),
                                         ("rpc_pages", [64.0, 8.0, 1.0]),
                                         ("window", [4.0, 4.0, 1.0]),
                                         ("ordinal", [0, 2, 5]))}
    pairs.append((DemandBatch(rpc_rate=rates, **batch),
                  ref_soa.DemandBatch(rpc_rate=rates, **batch)))
    pairs.append((EventBatch("w1", 0.125, (pairs[2][0],), (pairs[3][0],),
                             {"counters": {"n": 2.0}}, 3),
                  ref_events.EventBatch("w1", 0.125, (pairs[2][1],),
                                        (pairs[3][1],),
                                        {"counters": {"n": 2.0}}, 3)))
    # the sync protocol's messages: an observation, a decision, a demand
    # echo nesting a payload dataclass
    feats = np.linspace(0.0, 1.0, 22).astype(np.float32)
    rng = RngStream(5, "tuner/3").state()
    obs = (3, ("read", feats, rng))
    dec = (3, ("write", (np.int64(64), np.int64(8)), 0.75, rng))
    for payload in (obs, dec):
        pairs.append((BusMessage("obs/0", 1, 7, payload),
                      ref_bus.BusMessage("obs/0", 1, 7, payload)))
    pairs.append((BusMessage("demand", "coordinator", 2, [pairs[0][0]]),
                  ref_bus.BusMessage("demand", "coordinator", 2,
                                     [pairs[0][1]])))
    return pairs


@pytest.mark.parametrize("i", range(len(_payload_pairs())))
def test_port_encoding_equals_the_references(i):
    port, ref = _payload_pairs()[i]
    node = to_wire(port)
    assert node == ref_wire.to_wire(ref)
    assert repr(node) == repr(ref_wire.to_wire(ref))
    # and each package decodes the other's tree to its own class, which
    # encodes back to the same tree
    back = from_wire(ref_wire.to_wire(ref))
    assert type(back) is type(port) and to_wire(back) == node
    ref_back = ref_wire.from_wire(node)
    assert type(ref_back) is type(ref) and ref_wire.to_wire(ref_back) == node
