"""Per-process telemetry recorder: preallocated ring + metrics, no-op off.

One :class:`Recorder` per process (installed with :func:`install` /
:func:`enable`; :func:`active` returns the current one). Recording never
touches RNG state or float evaluation order — it only reads the clock
and writes into its own preallocated ring — so telemetry-enabled sync
runs stay bit-identical to telemetry-off
(``tests/test_torch_telemetry.py``).

Cost model, because instrumentation sits on real hot paths:

* **disabled** (the default): ``active()`` returns the shared
  :class:`NullRecorder`; ``span()`` hands back one reusable no-op
  context manager and counters return immediately. Hot loops guard
  per-message work with ``if rec.enabled:``.
* **spans** push one event into the ring at exit (two clock reads, one
  slot write under the lock — the ring is shared with broker/heartbeat
  threads).
* **counters/gauges/hists** are dict accumulations only; dirty counters
  are flushed into the ring as :class:`CounterEvent` samples once per
  interval (``set_interval``), not per increment, so a 100k-client
  fleet doesn't emit 100k timeline events per probe.

The ring holds the *last* ``capacity`` events (old slots overwritten,
``dropped`` counted) — exactly the bounded postmortem window the flight
recorder wants; totals in :meth:`snapshot` stay exact regardless.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Union

from repro_torch.core.runtime.telemetry.clock import Clock
from repro_torch.core.runtime.telemetry.events import (
    CounterEvent, EventBatch, SpanEvent,
)


class _Span:
    """Reusable-shape span context manager; one allocation per span."""

    __slots__ = ("_rec", "_name", "_cat", "_t0")

    def __init__(self, rec: "Recorder", name: str, cat: str):
        self._rec = rec
        self._name = name
        self._cat = cat
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = self._rec.clock.now()
        return self

    def __exit__(self, *exc) -> None:
        rec = self._rec
        t1 = rec.clock.now()
        rec._push(SpanEvent(name=self._name, cat=self._cat, t0=self._t0,
                            dur=t1 - self._t0, interval=rec.interval))


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """Disabled path: every operation is a constant-time no-op."""

    enabled = False
    source = ""
    interval = -1

    def span(self, name: str, cat: str = "") -> _NullSpan:
        return _NULL_SPAN

    def count(self, name: str, value: float = 1.0) -> None:
        pass

    def gauge(self, name: str, value: float) -> None:
        pass

    def hist(self, name: str, value: float) -> None:
        pass

    def set_interval(self, k: int) -> None:
        pass

    def drain(self) -> EventBatch:
        return EventBatch(source="", clock_offset_s=0.0)

    def snapshot(self) -> Dict:
        return {"counters": {}, "gauges": {}, "hists": {}}


class Recorder:
    """Enabled path: ring buffer + metric accumulators behind one lock."""

    enabled = True

    def __init__(self, source: str = "main", capacity: int = 8192,
                 clock: Optional[Clock] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.source = source
        self.capacity = int(capacity)
        self.clock = clock or Clock()
        self.interval = -1
        self._lock = threading.Lock()
        self._ring = [None] * self.capacity      # preallocated slots
        self._head = 0                           # next write index
        self._n = 0                              # live events in ring
        self._dropped = 0                        # overwrites since drain
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Dict[float, int]] = {}
        self._dirty: set = set()                 # counter/gauge names

    # ------------------------------------------------------------ recording
    def span(self, name: str, cat: str = "") -> _Span:
        return _Span(self, name, cat)

    def _push(self, ev) -> None:
        with self._lock:
            if self._ring[self._head] is not None:
                self._dropped += 1
            else:
                self._n += 1
            self._ring[self._head] = ev
            self._head = (self._head + 1) % self.capacity

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value
            self._dirty.add(name)

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)
            self._dirty.add(name)

    def hist(self, name: str, value: float) -> None:
        with self._lock:
            bucket = self._hists.setdefault(name, {})
            bucket[value] = bucket.get(value, 0) + 1

    def set_interval(self, k: int) -> None:
        """Enter interval ``k``: flush dirty counters/gauges as samples."""
        t = self.clock.now()
        with self._lock:
            for name in sorted(self._dirty):
                if name in self._counters:
                    ev = CounterEvent(name=name, t=t,
                                      value=self._counters[name],
                                      interval=self.interval, kind="count")
                else:
                    ev = CounterEvent(name=name, t=t,
                                      value=self._gauges[name],
                                      interval=self.interval, kind="gauge")
                self._push_locked(ev)
            self._dirty.clear()
            self.interval = int(k)

    def _push_locked(self, ev) -> None:
        if self._ring[self._head] is not None:
            self._dropped += 1
        else:
            self._n += 1
        self._ring[self._head] = ev
        self._head = (self._head + 1) % self.capacity

    # ------------------------------------------------------------- reading
    def _events_locked(self) -> list:
        # oldest -> newest: ring slots from head forward, skipping holes
        out = []
        for i in range(self.capacity):
            ev = self._ring[(self._head + i) % self.capacity]
            if ev is not None:
                out.append(ev)
        return out

    def drain(self) -> EventBatch:
        """Pop all ring events into a wire-ready batch; metrics persist."""
        with self._lock:
            events = self._events_locked()
            self._ring = [None] * self.capacity
            self._head = 0
            self._n = 0
            dropped, self._dropped = self._dropped, 0
            snap = self._snapshot_locked()
        return EventBatch(
            source=self.source,
            clock_offset_s=self.clock.offset_s,
            spans=tuple(e for e in events if isinstance(e, SpanEvent)),
            counters=tuple(e for e in events
                           if isinstance(e, CounterEvent)),
            metrics=snap,
            dropped=dropped,
        )

    def _snapshot_locked(self) -> Dict:
        return {
            "counters": dict(self._counters),
            "gauges": dict(self._gauges),
            "hists": {k: dict(v) for k, v in self._hists.items()},
        }

    def snapshot(self) -> Dict:
        """Point-in-time copy of all metric accumulators."""
        with self._lock:
            return self._snapshot_locked()


def metrics_delta(cur: Dict, prev: Dict) -> Dict:
    """What happened *between* two snapshots: counters and hist buckets
    subtract, gauges take the current value."""
    counters = {k: v - prev.get("counters", {}).get(k, 0.0)
                for k, v in cur.get("counters", {}).items()}
    hists = {}
    for name, buckets in cur.get("hists", {}).items():
        old = prev.get("hists", {}).get(name, {})
        d = {b: n - old.get(b, 0) for b, n in buckets.items()
             if n - old.get(b, 0)}
        if d:
            hists[name] = d
    return {"counters": {k: v for k, v in counters.items() if v},
            "gauges": dict(cur.get("gauges", {})),
            "hists": hists}


# --------------------------------------------------------- active recorder
_NULL = NullRecorder()
_ACTIVE: Union[Recorder, NullRecorder] = _NULL


def active() -> Union[Recorder, NullRecorder]:
    """The process's current recorder (the shared no-op when disabled)."""
    return _ACTIVE


def install(rec: Union[Recorder, NullRecorder, None]):
    """Swap the active recorder; returns the previous one."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = rec if rec is not None else _NULL
    return prev


def enable(source: str = "main", capacity: int = 8192,
           clock: Optional[Clock] = None) -> Recorder:
    """Install (and return) a fresh enabled recorder for this process."""
    rec = Recorder(source=source, capacity=capacity, clock=clock)
    install(rec)
    return rec


def disable() -> None:
    install(_NULL)


@contextmanager
def enabled(source: str = "main", capacity: int = 8192,
            clock: Optional[Clock] = None) -> Iterator[Recorder]:
    """Scoped enablement: installs a fresh recorder, restores on exit."""
    rec = Recorder(source=source, capacity=capacity, clock=clock)
    prev = install(rec)
    try:
        yield rec
    finally:
        install(prev)
