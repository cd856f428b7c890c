"""Fault tolerance + elasticity for 1000+ node runs.

Cooperating pieces (``HeartbeatTracker`` is shared with the bus
transports in ``repro_torch.core.runtime.transport``, which use it to detect
dead shard workers and socket peers):

* ``ClusterMonitor`` — heartbeat bookkeeping with failure injection. A
  host that misses ``miss_limit`` consecutive heartbeats is declared dead;
  the monitor emits an :class:`ElasticPlan`.
* ``ElasticPlan`` — the re-mesh decision: shrink the "data" axis to the
  largest power-of-two that the surviving hosts cover, keep "model" intact
  (TP groups must stay whole — a dead host kills its whole model group, so
  the plan drops that group's data-parallel replica, not random chips),
  then restart from the latest checkpoint. The plan is pure
  bookkeeping over host ids and group ids; the port's checkpointing and
  mesh come with its training slice.
* ``StragglerDetector`` — per-host step-time EWMA; hosts slower than
  ``threshold`` x median are flagged. I/O stragglers are first handed to
  CARAT (the paper's mechanism — retune that host's PFS client); hosts
  that stay slow get scheduled for eviction at the next checkpoint
  boundary (treated like a failure, but non-urgent).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

import numpy as np

from repro_torch.core.runtime.telemetry.recorder import active as _telemetry
from repro_torch.utils.logging import get_logger

log = get_logger("runtime.ft")


class HeartbeatTracker:
    """Wall-clock heartbeat bookkeeping for transport peers.

    The bus-transport twin of :class:`ClusterMonitor`: where the monitor
    counts *missed monitoring intervals* for mesh hosts, this tracks the
    last wall-clock beat (and last reported probe interval) per named
    peer — shard workers, socket clients — so a coordinator can tell a
    straggling peer from a dead one without a global tick. Peers are
    registered implicitly by their first :meth:`beat`.
    """

    def __init__(self, timeout_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = float(timeout_s)
        self._clock = clock
        self._last: Dict[object, float] = {}
        self._interval: Dict[object, int] = {}

    def beat(self, peer: object, interval: Optional[int] = None) -> None:
        now = self._clock()
        rec = _telemetry()
        if rec.enabled:
            rec.count("bus.heartbeats")
            prev = self._last.get(peer)
            if prev is not None:
                # bucket to 10 ms so the gap histogram stays small under
                # heartbeat storms
                rec.hist("bus.heartbeat_gap_s", round(now - prev, 2))
        self._last[peer] = now
        if interval is not None:
            self._interval[peer] = int(interval)

    def forget(self, peer: object) -> None:
        """Drop a peer that left on purpose (clean shutdown, re-mesh)."""
        self._last.pop(peer, None)
        self._interval.pop(peer, None)

    def peers(self) -> Set[object]:
        return set(self._last)

    def interval(self, peer: object) -> int:
        """Last probe interval the peer reported (0 before any report)."""
        return self._interval.get(peer, 0)

    def alive(self) -> Set[object]:
        cutoff = self._clock() - self.timeout_s
        return {p for p, t in self._last.items() if t >= cutoff}

    def dead(self) -> Set[object]:
        return self.peers() - self.alive()


@dataclass
class ElasticPlan:
    """A concrete re-mesh decision after failures."""
    dead_hosts: Set[int]
    old_data_size: int
    new_data_size: int
    restart_step: Optional[int]

    @property
    def shrink_factor(self) -> float:
        return self.new_data_size / self.old_data_size


class ClusterMonitor:
    def __init__(self, n_hosts: int, model_group: Dict[int, int],
                 data_size: int, miss_limit: int = 3):
        """model_group: host -> TP group id (a dead host kills its group)."""
        self.n_hosts = n_hosts
        self.model_group = model_group
        self.data_size = data_size
        self.miss_limit = miss_limit
        self.missed: Dict[int, int] = {h: 0 for h in range(n_hosts)}
        self.dead: Set[int] = set()

    def heartbeat(self, host: int) -> None:
        if host not in self.dead:
            self.missed[host] = 0

    def tick(self, alive: Set[int]) -> Optional[ElasticPlan]:
        """One monitoring interval; hosts not in `alive` missed a beat."""
        newly_dead = set()
        for h in range(self.n_hosts):
            if h in self.dead:
                continue
            if h in alive:
                self.missed[h] = 0
            else:
                self.missed[h] += 1
                if self.missed[h] >= self.miss_limit:
                    newly_dead.add(h)
        if not newly_dead:
            return None
        self.dead |= newly_dead
        # a dead host invalidates its whole TP group => lose one (or more)
        # data-parallel replicas
        dead_groups = {self.model_group[h] for h in self.dead}
        surviving_replicas = self.data_size - len(dead_groups)
        new_data = _largest_pow2_leq(max(surviving_replicas, 1))
        plan = ElasticPlan(
            dead_hosts=set(self.dead),
            old_data_size=self.data_size,
            new_data_size=new_data,
            restart_step=None,
        )
        log.warning("hosts %s dead -> shrink data axis %d -> %d",
                    sorted(newly_dead), self.data_size, new_data)
        return plan


def _largest_pow2_leq(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


class StragglerDetector:
    def __init__(self, n_hosts: int, threshold: float = 1.5,
                 ewma: float = 0.7, patience: int = 4):
        self.n_hosts = n_hosts
        self.threshold = threshold
        self.ewma = ewma
        self.patience = patience
        self.step_time: List[float] = [0.0] * n_hosts
        self.strikes: Dict[int, int] = {h: 0 for h in range(n_hosts)}
        self.flagged_io: Set[int] = set()
        self.evict: Set[int] = set()

    def observe(self, host_times: List[float],
                io_waits: Optional[List[float]] = None) -> None:
        for h, t in enumerate(host_times):
            self.step_time[h] = (self.ewma * self.step_time[h]
                                 + (1 - self.ewma) * t
                                 if self.step_time[h] else t)
        med = float(np.median([t for t in self.step_time if t > 0]) or 0.0)
        for h in range(self.n_hosts):
            slow = med > 0 and self.step_time[h] > self.threshold * med
            if not slow:
                self.strikes[h] = 0
                self.flagged_io.discard(h)
                continue
            io_bound = (io_waits is not None
                        and io_waits[h] > 0.5 * (self.step_time[h] - med))
            if io_bound:
                # hand to CARAT first — the paper's lever for I/O stragglers
                self.flagged_io.add(h)
            self.strikes[h] += 1
            if self.strikes[h] >= self.patience and not io_bound:
                self.evict.add(h)

    def io_stragglers(self) -> Set[int]:
        return set(self.flagged_io)

    def to_evict(self) -> Set[int]:
        return set(self.evict)
