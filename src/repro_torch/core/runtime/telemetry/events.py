"""Typed telemetry events — plain frozen dataclasses, wire-codec friendly.

Every field is an atom (str/int/float) or a tuple/dict of atoms, so a
batch crosses the ``transport.wire`` purity gate unchanged: workers
drain their ring buffers to the coordinator as :class:`EventBatch`
payloads on the TuningBus. The codecs live in ``transport/wire.py``
(tags ``ts``/``tk``/``tb``); live recorder/clock objects are *not*
registered and raise ``WireError`` — only drained data travels.

Timestamps are raw local monotonic seconds (``Clock.now()``); the batch
carries the producing process's ``clock_offset_s`` so the coordinator
shifts them onto its own timeline at merge (skew normalization).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple


@dataclass(frozen=True)
class SpanEvent:
    """One completed timed region (``Recorder.span`` context manager)."""
    name: str
    cat: str           # coarse lane: "sim", "policy", "runtime", "bus"
    t0: float          # local monotonic start, seconds
    dur: float         # seconds
    interval: int      # simulation interval ordinal, -1 outside intervals


@dataclass(frozen=True)
class CounterEvent:
    """A counter/gauge sample flushed at an interval boundary."""
    name: str
    t: float           # local monotonic seconds
    value: float
    interval: int
    kind: str          # "count" (running total) | "gauge" (last value)


@dataclass(frozen=True)
class EventBatch:
    """One drain of a per-process ring buffer, ready for the wire.

    ``metrics`` is the full snapshot (``Recorder.snapshot()``) at drain
    time — totals survive ring overwrites, so the coordinator's merged
    metrics stay exact even when the span timeline is lossy
    (``dropped`` counts the overwritten events since the last drain).
    """
    source: str
    clock_offset_s: float
    spans: Tuple[SpanEvent, ...] = ()
    counters: Tuple[CounterEvent, ...] = ()
    metrics: Dict = field(default_factory=dict)
    dropped: int = 0

    @property
    def n_events(self) -> int:
        return len(self.spans) + len(self.counters)
