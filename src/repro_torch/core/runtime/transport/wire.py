"""The bus wire format: ``to_wire``/``from_wire`` round-trip contract.

Every payload crossing a process or host boundary goes through this
module — it is the one place that decides what may travel. The encoding
is a tagged tree of plain Python values (safe to pickle *or* msgpack):

* atoms pass through: ``None``/``bool``/``int``/``float``/``str`` and
  ``bytes`` (opaque pre-pickled blobs — policy snapshots, worker
  reports — are first-class on purpose: the transport must not need to
  understand them);
* containers become tagged tuples: ``("tu", items)``, ``("li", items)``,
  ``("di", pairs)`` — user tuples are always wrapped, so a tag can never
  collide with user data;
* numpy crosses as raw buffers: ``("nd", dtype, shape, bytes)`` for
  arrays, ``("n0", dtype, bytes)`` for scalars — value- and dtype-exact,
  which the bit-identity gates require;
* registered payload dataclasses (:class:`~repro_torch.storage.client.
  ChannelDemand`, :class:`~repro_torch.core.cache_tuner.CacheDemand`,
  ``DemandBatch``, :class:`~repro_torch.core.runtime.bus.BusMessage`) carry
  their own ``to_wire``/``from_wire`` contract or a structural encoder
  here;
* **everything else raises** :class:`WireError`. That is the point:
  threads, locks, sockets, controller shells, clients, live RNG
  generators and torch tensors must never leak onto the bus (serialized
  RNG *state* — a plain dict from
  :meth:`repro_torch.utils.rng.RngStream.state` — travels fine). The
  tuners return NumPy, so a torch value in a payload is a fault where
  the payload is made, not a type the wire should learn. This module
  enforces the contract at runtime on every cross-process publish.

``assert_wire_safe(payload)`` is the cheap test/debug hook: encode and
discard.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np

__all__ = ["WireError", "to_wire", "from_wire", "assert_wire_safe"]


class WireError(TypeError):
    """A payload referenced something that must not cross the bus."""


_ATOMS = (bool, int, float, str, bytes)

# tag -> decoder; encoders dispatch on type below
_DECODERS: Dict[str, Callable[[tuple], Any]] = {}


def _decoder(tag: str):
    def reg(fn):
        _DECODERS[tag] = fn
        return fn
    return reg


# --------------------------------------------------------------- registry
# Payload classes with a to_wire/from_wire contract of their own, plus
# structural encoders for the array-shaped ones. Imported lazily: wire
# sits under core.runtime and must not create import cycles with
# storage at module load.
def _registry() -> Dict[type, Tuple[str, Callable]]:
    from repro_torch.core.cache_tuner import CacheDemand
    from repro_torch.core.runtime.bus import BusMessage
    from repro_torch.core.runtime.telemetry.events import (
        CounterEvent, EventBatch, SpanEvent)
    from repro_torch.storage.client import ChannelDemand
    from repro_torch.storage.soa import DemandBatch
    return {
        ChannelDemand: ("cd", lambda o: o.to_wire()),
        CacheDemand: ("c2", lambda o: o.to_wire()),
        DemandBatch: ("db", lambda o: tuple(
            _encode(getattr(o, f))
            for f in ("ost", "rpc_rate", "rpc_pages", "window", "ordinal"))),
        BusMessage: ("bm", lambda o: (o.topic, _encode(o.shard),
                                      int(o.interval), _encode(o.payload))),
        # telemetry events: drained ring-buffer data only. The live
        # Recorder/Clock objects are deliberately unregistered — they
        # hold locks and callables and must raise WireError.
        SpanEvent: ("ts", lambda o: (o.name, o.cat, float(o.t0),
                                     float(o.dur), int(o.interval))),
        CounterEvent: ("tk", lambda o: (o.name, float(o.t), float(o.value),
                                        int(o.interval), o.kind)),
        EventBatch: ("tb", lambda o: (
            o.source, float(o.clock_offset_s),
            tuple(_encode(s) for s in o.spans),
            tuple(_encode(c) for c in o.counters),
            _encode(o.metrics), int(o.dropped))),
    }


_REG_CACHE: Dict[type, Tuple[str, Callable]] = {}


def _reg() -> Dict[type, Tuple[str, Callable]]:
    if not _REG_CACHE:
        _REG_CACHE.update(_registry())
    return _REG_CACHE


@_decoder("cd")
def _dec_channel_demand(data):
    from repro_torch.storage.client import ChannelDemand
    return ChannelDemand.from_wire(data)


@_decoder("c2")
def _dec_cache_demand(data):
    from repro_torch.core.cache_tuner import CacheDemand
    return CacheDemand.from_wire(data)


@_decoder("db")
def _dec_demand_batch(data):
    from repro_torch.storage.soa import DemandBatch
    ost, rate, pages, window, ordinal = (_decode(x) for x in data)
    return DemandBatch(ost=ost, rpc_rate=rate, rpc_pages=pages,
                       window=window, ordinal=ordinal)


@_decoder("bm")
def _dec_bus_message(data):
    from repro_torch.core.runtime.bus import BusMessage
    topic, shard, interval, payload = data
    return BusMessage(topic, _decode(shard), int(interval),
                      _decode(payload))


@_decoder("ts")
def _dec_span_event(data):
    from repro_torch.core.runtime.telemetry.events import SpanEvent
    name, cat, t0, dur, interval = data
    return SpanEvent(name=name, cat=cat, t0=float(t0), dur=float(dur),
                     interval=int(interval))


@_decoder("tk")
def _dec_counter_event(data):
    from repro_torch.core.runtime.telemetry.events import CounterEvent
    name, t, value, interval, kind = data
    return CounterEvent(name=name, t=float(t), value=float(value),
                        interval=int(interval), kind=kind)


@_decoder("tb")
def _dec_event_batch(data):
    from repro_torch.core.runtime.telemetry.events import EventBatch
    source, offset, spans, counters, metrics, dropped = data
    return EventBatch(source=source, clock_offset_s=float(offset),
                      spans=tuple(_decode(s) for s in spans),
                      counters=tuple(_decode(c) for c in counters),
                      metrics=_decode(metrics), dropped=int(dropped))


# --------------------------------------------------------------- encoding
def _encode(obj: Any) -> Any:
    if obj is None:
        return None
    # bool before int (bool is an int subclass); exact types only — a
    # subclass smuggling extra state must not silently flatten
    t = type(obj)
    if t in (bool, int, float, str, bytes):
        return obj
    if t is tuple:
        return ("tu", tuple(_encode(x) for x in obj))
    if t is list:
        return ("li", tuple(_encode(x) for x in obj))
    if t is dict:
        return ("di", tuple((_encode(k), _encode(v))
                            for k, v in obj.items()))
    if isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise WireError("object-dtype ndarray cannot cross the bus")
        a = np.ascontiguousarray(obj)
        return ("nd", a.dtype.str, tuple(a.shape), a.tobytes())
    if isinstance(obj, np.generic):
        return ("n0", obj.dtype.str, obj.tobytes())
    reg = _reg().get(t)
    if reg is not None:
        tag, enc = reg
        return (tag, enc(obj))
    if isinstance(obj, _ATOMS):            # e.g. a str/int subclass
        raise WireError(
            f"{t.__module__}.{t.__name__} subclasses a wire atom but may "
            f"carry extra state; convert to the plain type before publish")
    raise WireError(
        f"payload of type {t.__module__}.{t.__name__} is not wire-safe: "
        f"only plain atoms, containers, numpy buffers, and registered "
        f"payload dataclasses cross the bus (no live objects — serialize "
        f"state instead; see transport.wire)")


def _decode(node: Any) -> Any:
    if node is None or type(node) in (bool, int, float, str, bytes):
        return node
    tag = node[0]
    if tag == "tu":
        return tuple(_decode(x) for x in node[1])
    if tag == "li":
        return [_decode(x) for x in node[1]]
    if tag == "di":
        return {_decode(k): _decode(v) for k, v in node[1]}
    if tag == "nd":
        _, dtype, shape, buf = node
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
    if tag == "n0":
        _, dtype, buf = node
        return np.frombuffer(buf, dtype=np.dtype(dtype))[0]
    dec = _DECODERS.get(tag)
    if dec is None:
        raise WireError(f"unknown wire tag {tag!r}")
    return dec(node[1])


def to_wire(payload: Any) -> Any:
    """Encode a bus payload as a tagged plain-value tree (or raise
    :class:`WireError` if anything in it must not cross the bus)."""
    return _encode(payload)


def from_wire(node: Any) -> Any:
    """Invert :func:`to_wire`."""
    return _decode(node)


def assert_wire_safe(payload: Any) -> None:
    """Raise :class:`WireError` if ``payload`` could not cross a
    process/host bus transport. Encodes and discards."""
    _encode(payload)
