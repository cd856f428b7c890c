"""Flight recorder: last-N-intervals postmortem window per source.

The coordinator feeds every drained :class:`EventBatch` through
:meth:`FlightRecorder.observe`; per source it keeps only events from
the trailing ``last_intervals`` simulation intervals (interval ``-1``
events — startup, handshake — are kept while they are still among the
newest). On worker death or an injected ``KillShard``,
:meth:`dump` persists that window plus the latest metrics snapshot as a
JSON artifact, so every fault-injection gate produces something a human
can open: what the worker was doing, and when, right before it died.

Dumps are plain JSON (no pickle — a postmortem must be readable even if
the code that wrote it is the thing that crashed); :func:`read_dump`
loads one back as a dict.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict
from typing import Dict, List, Optional

from repro_torch.core.runtime.telemetry.clock import wall_s
from repro_torch.core.runtime.telemetry.events import (
    CounterEvent, EventBatch, SpanEvent,
)


class FlightRecorder:
    """Bounded per-source event windows + dump-to-JSON on demand."""

    def __init__(self, directory: str, last_intervals: int = 8):
        self.directory = directory
        self.last_intervals = int(last_intervals)
        self._events: Dict[str, List] = {}        # source -> events
        self._metrics: Dict[str, Dict] = {}       # source -> last snapshot
        self._offsets: Dict[str, float] = {}
        self._seq = 0

    # ------------------------------------------------------------ ingest
    def observe(self, batch: EventBatch) -> None:
        evs = self._events.setdefault(batch.source, [])
        evs.extend(batch.spans)
        evs.extend(batch.counters)
        if batch.metrics:
            self._metrics[batch.source] = batch.metrics
        self._offsets[batch.source] = batch.clock_offset_s
        horizon = max((e.interval for e in evs), default=-1)
        if horizon >= 0:
            floor = horizon - self.last_intervals + 1
            self._events[batch.source] = [
                e for e in evs if e.interval >= floor or e.interval < 0]

    # -------------------------------------------------------------- dump
    def dump(self, source: str, reason: str) -> Optional[str]:
        """Write the postmortem window for ``source``; None if unseen."""
        if source not in self._events:
            return None
        os.makedirs(self.directory, exist_ok=True)
        self._seq += 1
        path = os.path.join(
            self.directory,
            f"flight-{source}-{reason}-{self._seq:03d}.json")
        evs = self._events[source]
        shift = self._offsets.get(source, 0.0)
        payload = {
            "source": source,
            "reason": reason,
            "wall_time_s": wall_s(),
            "clock_offset_s": shift,
            "last_intervals": self.last_intervals,
            "spans": [dict(asdict(e), t0=e.t0 + shift)
                      for e in evs if isinstance(e, SpanEvent)],
            "counters": [dict(asdict(e), t=e.t + shift)
                         for e in evs if isinstance(e, CounterEvent)],
            "metrics": self._metrics.get(source, {}),
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1)
        return path

    def dump_all(self, reason: str) -> List[str]:
        return [p for s in sorted(self._events)
                for p in [self.dump(s, reason)] if p]


def read_dump(path: str) -> dict:
    """Load a flight dump back (validates it is well-formed JSON)."""
    with open(path, "r", encoding="utf-8") as f:
        payload = json.load(f)
    for key in ("source", "reason", "spans", "counters", "metrics"):
        if key not in payload:
            raise ValueError(f"flight dump {path} missing {key!r}")
    return payload
