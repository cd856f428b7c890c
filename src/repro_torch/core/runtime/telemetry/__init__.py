"""Fleet-wide tracing, metrics, and a crash flight recorder.

The observability layer for the distributed runtime:

* :mod:`clock` — the monotonic :class:`Clock` abstraction and the
  raw-time access point;
* :mod:`events` — typed span/counter dataclasses, wire-codec
  registered so batches cross process/host boundaries;
* :mod:`recorder` — the per-process preallocated ring buffer with
  ``span()`` context managers, counters/gauges/hists, and a strict
  no-op disabled path (``active()`` / ``enable()`` / ``enabled()``);
* :mod:`export` — Chrome/Perfetto ``trace_event`` JSON with per-worker
  clock-skew normalization;
* :mod:`flight` — the last-N-intervals postmortem dump on worker death
  or ``KillShard``;
* :mod:`collect` — the coordinator-side batch aggregator
  (:class:`FleetCollector`) that ``ProcessRuntime`` drains workers into.

Recording never touches RNG state or float order: telemetry-enabled
sync runs are bit-identical to telemetry-off
(``tests/test_torch_telemetry.py`` holds a fleet with telemetry on to
the single-process run with it off). With nothing installed,
:func:`active` returns the shared no-op recorder.
"""
from repro_torch.core.runtime.telemetry.clock import (
    Clock, estimate_offset, perf_s, wall_s,
)
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

__all__ = [
    "Clock", "estimate_offset", "perf_s", "wall_s",
    "FleetCollector",
    "CounterEvent", "EventBatch", "SpanEvent",
    "trace_events", "write_trace",
    "FlightRecorder", "read_dump",
    "NullRecorder", "Recorder", "active", "disable", "enable", "enabled",
    "install", "metrics_delta",
]
