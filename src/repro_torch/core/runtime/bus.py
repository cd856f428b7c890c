"""The observation/decision bus between simulation shards and policies.

A :class:`TuningBus` is the only channel a sharded deployment's tuning
traffic crosses shard boundaries on. Everything is a
:class:`BusMessage` — an immutable ``(topic, shard, interval, payload)``
record — published by shards (observations, stage-2 demand requests,
demand echoes) or by the coordinator (decisions, stage-2 replies):

* ``publish`` appends to a topic queue; ``retain=True`` instead keeps
  the message as the producer's *latest* on that topic, replacing its
  previous one (the demand-echo pattern: consumers want the freshest
  view per shard, not the history — retained messages are read via
  ``latest``, never ``consume``, so they cannot accumulate).
* ``consume`` drains a topic. With a staleness bound, messages whose
  ``interval`` lags the consumer's ``now`` by more than
  ``max_staleness`` intervals are dropped (and counted) instead of
  delivered — the bounded-staleness gather that lets an async fleet
  ignore a straggler's late traffic rather than wait for it.
* ``latest`` reads the retained per-shard messages under the same
  staleness bound, without consuming.

The bus records the worst staleness it ever *delivered*
(``max_staleness_seen``) and every message it dropped as too stale
(``dropped_stale``); the async property tests gate on these.

:class:`InProcessBus` is the deterministic in-process transport —
a lock + per-topic deques, with a condition variable so a coordinator
thread can sleep until traffic arrives. It is safe for the sync
round-robin scheduler (single thread, zero contention) and the async
threaded scheduler alike. The cross-process transports
(``repro_torch.core.runtime.transport``: :class:`MultiprocessBus` over
pipes, :class:`SocketBus` over length-prefixed frames) implement the
same four methods against a hub-side ``InProcessBus`` store, sharing
this module's :class:`BusAccounting` semantics; payloads are
``(client_id, data)``-shaped and wire-pure (``transport.wire``) — no
live client objects, locks, or controller shells cross the bus.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from repro_torch.telemetry import active as _telemetry

#: shard id the coordinator publishes under
COORDINATOR = "coordinator"


@dataclass(frozen=True)
class BusMessage:
    topic: str
    shard: object          # producing shard id (or COORDINATOR)
    interval: int          # producer's local interval index at publish
    payload: Any


class TuningBus:
    """Transport interface (see module docstring). Implementations must
    make ``publish``/``consume``/``latest``/``wait`` thread-safe."""

    def publish(self, topic: str, shard: object, interval: int,
                payload: Any, retain: bool = False) -> None:
        raise NotImplementedError

    def consume(self, topic: str, now: Optional[int] = None,
                max_staleness: Optional[int] = None) -> List[BusMessage]:
        raise NotImplementedError

    def latest(self, topic: str, now: Optional[int] = None,
               max_staleness: Optional[int] = None,
               exclude_shard: object = None) -> List[BusMessage]:
        raise NotImplementedError

    def wait(self, timeout: float) -> None:
        """Block until new traffic is published (or ``timeout`` s pass)."""
        raise NotImplementedError


class BusAccounting:
    """Staleness/drop accounting shared by every transport.

    One implementation of the observability contract: ``published`` /
    ``consumed`` counters, ``dropped_stale`` (messages a bounded
    consume refused as too old), and ``max_staleness_seen`` (the worst
    staleness ever *delivered*). :class:`InProcessBus` mixes it in
    directly; the cross-process transports keep an ``InProcessBus``
    store on the hub side and forward its :meth:`stats`, so a fleet
    reads identical accounting whatever transport carries it
    (``tests/test_torch_transport.py`` asserts this counter for
    counter).
    """

    def _init_accounting(self) -> None:
        self.published = 0
        self.consumed = 0
        self.dropped_stale = 0
        self.max_staleness_seen = 0     # worst staleness ever *delivered*

    def _deliver(self, msgs: List[BusMessage], now: Optional[int],
                 max_staleness: Optional[int],
                 count_drops: bool = True) -> List[BusMessage]:
        """Apply the staleness bound to a candidate delivery, updating
        the counters. ``count_drops=False`` is the retained-latest path:
        a retained message is re-read every poll, so counting each stale
        re-read would measure poll frequency, not messages.

        This is also the single choke point where staleness-at-delivery
        is *observed*, so the telemetry mirror
        (``bus.staleness_at_delivery`` histogram, ``bus.consumed`` /
        ``bus.dropped_stale`` counters) agrees with the counters here
        by construction."""
        rec = _telemetry()
        if now is None:
            self.consumed += len(msgs)
            if rec.enabled and msgs:
                rec.count("bus.consumed", len(msgs))
            return msgs
        out: List[BusMessage] = []
        for m in msgs:
            staleness = max(0, int(now) - m.interval)
            if max_staleness is not None and staleness > max_staleness:
                if count_drops:
                    self.dropped_stale += 1
                    if rec.enabled:
                        rec.count("bus.dropped_stale")
                continue
            self.max_staleness_seen = max(self.max_staleness_seen, staleness)
            if rec.enabled:
                rec.hist("bus.staleness_at_delivery", staleness)
            out.append(m)
        self.consumed += len(out)
        if rec.enabled and out:
            rec.count("bus.consumed", len(out))
        return out

    def stats(self) -> Dict[str, int]:
        return {"published": self.published, "consumed": self.consumed,
                "dropped_stale": self.dropped_stale,
                "max_staleness_seen": self.max_staleness_seen}


class InProcessBus(BusAccounting, TuningBus):
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._traffic = threading.Condition(self._lock)
        self._queues: Dict[str, deque] = {}
        self._retained: Dict[str, Dict[object, BusMessage]] = {}
        # observability: the async gates read these
        self._init_accounting()

    def publish(self, topic: str, shard: object, interval: int,
                payload: Any, retain: bool = False) -> None:
        msg = BusMessage(topic, shard, int(interval), payload)
        with self._traffic:
            if retain:
                # latest-per-shard slot only: a retained topic is polled
                # via latest(), so queueing history would just grow
                # unboundedly over a long run
                self._retained.setdefault(topic, {})[shard] = msg
            else:
                self._queues.setdefault(topic, deque()).append(msg)
            self.published += 1
            rec = _telemetry()
            if rec.enabled:
                rec.count("bus.published")
            self._traffic.notify_all()

    def consume(self, topic: str, now: Optional[int] = None,
                max_staleness: Optional[int] = None) -> List[BusMessage]:
        with self._lock:
            q = self._queues.get(topic)
            msgs = list(q) if q else []
            if q:
                q.clear()
            return self._deliver(msgs, now, max_staleness)

    def latest(self, topic: str, now: Optional[int] = None,
               max_staleness: Optional[int] = None,
               exclude_shard: object = None) -> List[BusMessage]:
        with self._lock:
            retained = self._retained.get(topic, {})
            msgs = [m for s, m in retained.items() if s != exclude_shard]
            # a retained message is re-read every poll: counting each
            # stale re-read as a drop would measure poll frequency, not
            # messages — dropped_stale counts consume()d messages only
            return self._deliver(msgs, now, max_staleness,
                                 count_drops=False)

    def wait(self, timeout: float) -> None:
        with self._traffic:
            self._traffic.wait(timeout)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return super().stats()
