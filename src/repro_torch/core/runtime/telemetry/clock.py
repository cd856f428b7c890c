"""Monotonic clock abstraction — the one sanctioned home for raw time.

The port's modules read time through this module: timing that feeds
Table VIII overhead accounting calls :func:`perf_s`, telemetry events
are stamped by a :class:`Clock`, and export/flight code that needs a
wall-clock label calls :func:`wall_s`.

Why centralize: cross-host traces only line up if every timestamp is
(a) monotonic within its process and (b) carried with a per-process
offset estimated against the coordinator's clock. A :class:`Clock`
holds that offset; :func:`estimate_offset` computes it NTP-style from
bus round trips at worker handshake (see ``transport.fleet``).
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple


def perf_s() -> float:
    """Monotonic seconds (``time.perf_counter``) — process-local origin."""
    return time.perf_counter()


def wall_s() -> float:
    """Wall-clock seconds since the epoch — labels only, never ordering."""
    return time.time()


class Clock:
    """Monotonic clock with an additive offset toward a reference process.

    ``now()`` returns local monotonic seconds; the recorder stamps raw
    local values and the *batch* carries ``offset_s`` so the coordinator
    normalizes at merge time (``local + offset = coordinator time``).
    The two-sided split keeps recording branch-free and lets the offset
    be estimated (or re-estimated) after events were already recorded.
    """

    __slots__ = ("offset_s", "_base")

    def __init__(self, offset_s: float = 0.0,
                 base: Optional[Callable[[], float]] = None):
        self.offset_s = float(offset_s)
        self._base = base or time.perf_counter

    def now(self) -> float:
        """Raw local monotonic seconds (no offset applied)."""
        return self._base()

    def normalized(self) -> float:
        """Local time shifted into the reference process's timeline."""
        return self._base() + self.offset_s


def estimate_offset(ping: Callable[[], Tuple[float, float, float]],
                    samples: int = 3) -> float:
    """NTP-style offset from round trips to a reference process.

    ``ping()`` performs one round trip and returns
    ``(t_send, t_recv, peer_t)``: local monotonic send/receive times and
    the peer's clock reading taken mid-flight. The offset estimate from
    one trip is ``peer_t - (t_send + t_recv) / 2``; the sample with the
    smallest round-trip time wins (least queueing noise), matching the
    classic minimum-RTT filter.
    """
    best_rtt = float("inf")
    best = 0.0
    for _ in range(max(1, samples)):
        t_send, t_recv, peer_t = ping()
        rtt = t_recv - t_send
        if rtt < best_rtt:
            best_rtt = rtt
            best = peer_t - (t_send + t_recv) / 2.0
    return best
