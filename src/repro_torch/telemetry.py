"""The two telemetry names the core imports: :func:`perf_s` and :func:`active`.

The full telemetry subsystem (rings, exporters, flight recorder) is not
ported yet, so :func:`active` always returns the disabled recorder,
whose every operation is a constant-time no-op.
"""
from __future__ import annotations

import time


def perf_s() -> float:
    """Monotonic seconds (``time.perf_counter``) — process-local origin."""
    return time.perf_counter()


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """Disabled recorder: spans and counters do nothing."""

    enabled = False

    def span(self, name: str, cat: str = "") -> _NullSpan:
        return _NULL_SPAN

    def count(self, name: str, value: float = 1.0) -> None:
        pass


_NULL = NullRecorder()


def active() -> NullRecorder:
    return _NULL
