"""Coordinator-side aggregation of drained worker event batches.

``ProcessRuntime(telemetry=...)`` owns one :class:`FleetCollector`:
every ``telem`` message a worker drains over the bus lands in
:meth:`add`, which (a) accumulates the batch for whole-run trace
export, (b) feeds the flight recorder's bounded postmortem window, and
(c) keeps the latest per-source metrics snapshot. Batches arrive
wire-decoded but *unnormalized* — each carries its producer's
``clock_offset_s``; normalization happens in the exporters so raw
timestamps are preserved end to end.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.runtime.telemetry.events import EventBatch
from repro_torch.core.runtime.telemetry.export import trace_events, write_trace
from repro_torch.core.runtime.telemetry.flight import FlightRecorder


class FleetCollector:
    """Accumulates batches; exports traces; dumps postmortems."""

    def __init__(self, flight_dir: Optional[str] = None,
                 flight_intervals: int = 8):
        self.batches: List[EventBatch] = []
        self.flight = (FlightRecorder(flight_dir, flight_intervals)
                       if flight_dir else None)
        self.flight_paths: List[str] = []

    # ------------------------------------------------------------ ingest
    def add(self, batch: EventBatch) -> None:
        self.batches.append(batch)
        if self.flight is not None:
            self.flight.observe(batch)

    # ------------------------------------------------------------ export
    def trace_events(self) -> List[dict]:
        return trace_events(self.batches)

    def write_trace(self, path: str) -> str:
        return write_trace(path, self.batches)

    def metrics(self) -> Dict[str, Dict]:
        """Latest metrics snapshot per source (last batch wins)."""
        out: Dict[str, Dict] = {}
        for b in self.batches:
            if b.metrics:
                out[b.source] = b.metrics
        return out

    def sources(self) -> List[str]:
        return sorted({b.source for b in self.batches})

    def clock_offsets(self) -> Dict[str, float]:
        """Last-reported clock offset per source (skew diagnostics)."""
        return {b.source: b.clock_offset_s for b in self.batches}

    def dropped(self) -> int:
        """Total ring overwrites across all drains (timeline loss)."""
        return sum(b.dropped for b in self.batches)

    # ------------------------------------------------------- postmortems
    def dump_flight(self, source: str, reason: str) -> Optional[str]:
        if self.flight is None:
            return None
        path = self.flight.dump(source, reason)
        if path:
            self.flight_paths.append(path)
        return path
