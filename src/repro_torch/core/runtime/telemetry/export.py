"""Exporters: Chrome/Perfetto ``trace_event`` JSON from event batches.

Output follows the Trace Event Format (the JSON flavour Perfetto and
``chrome://tracing`` both load): complete spans are ``ph:"X"`` with
microsecond ``ts``/``dur``, counters are ``ph:"C"``, and each batch
source becomes a named process row via ``process_name`` metadata
events. Timestamps are skew-normalized here — every event's local
monotonic time is shifted by its batch's ``clock_offset_s`` so spans
from different workers (or hosts) land on one coordinator timeline.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List

from repro_torch.core.runtime.telemetry.events import EventBatch


def _pid_map(batches: Iterable[EventBatch]) -> Dict[str, int]:
    """Stable source -> integer pid assignment (sorted for determinism)."""
    sources = sorted({b.source for b in batches})
    return {src: i + 1 for i, src in enumerate(sources)}


def trace_events(batches: Iterable[EventBatch]) -> List[dict]:
    """Flatten batches into a ``traceEvents`` list, offsets applied."""
    batches = list(batches)
    pids = _pid_map(batches)
    out: List[dict] = []
    for src in sorted(pids):
        out.append({"ph": "M", "name": "process_name", "pid": pids[src],
                    "tid": 0, "args": {"name": src or "main"}})
    for b in batches:
        pid = pids[b.source]
        shift = b.clock_offset_s
        for s in b.spans:
            out.append({
                "ph": "X", "name": s.name, "cat": s.cat or "default",
                "pid": pid, "tid": 0,
                "ts": (s.t0 + shift) * 1e6,
                "dur": s.dur * 1e6,
                "args": {"interval": s.interval},
            })
        for c in b.counters:
            out.append({
                "ph": "C", "name": c.name, "pid": pid, "tid": 0,
                "ts": (c.t + shift) * 1e6,
                "args": {c.kind: c.value, "interval": c.interval},
            })
    return out


def write_trace(path: str, batches: Iterable[EventBatch]) -> str:
    """Write a Perfetto-loadable trace JSON; returns ``path``."""
    payload = {"traceEvents": trace_events(batches),
               "displayTimeUnit": "ms"}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    return path
