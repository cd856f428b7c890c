"""Magpie-style centralized DRL tuner (arXiv:2207.09298).

Magpie tunes distributed-file-system parameters with a single
reinforcement-learning agent that observes *global* system state and
emits one fleet-wide action (every client gets the same configuration)
— the architectural opposite of CARAT's decentralized per-client
controllers, which is exactly why it matters as a baseline.

This reproduction keeps that shape on the simulator: the policy reads
every bound client's counters (centralized observability is the point),
aggregates them into a fleet reward (total application bytes per
decision epoch), and runs an epsilon-greedy tabular value learner over a
bounded fleet-wide action grid. Actions dwell for several probe
intervals — Magpie's agent steps are much coarser than CARAT's 0.5 s
probes because a fleet-wide reconfiguration needs time to show up in
the reward. Unvisited actions are optimistic, so the action set is
swept once before exploitation; exploration decays with epoch count and
draws from one :class:`RngStream` (deterministic runs).

Deliberate gap vs the paper (tracked in ROADMAP): Magpie trains a deep
actor over continuous state with offline replay; this stand-in is a
tabular bandit over a curated action subset — enough to measure the
centralized-fleet-action *architecture* head-to-head, not the DRL
training pipeline itself.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.policies.base import TuningPolicy
from repro_torch.core.policy import CaratSpaces
from repro_torch.storage.client import IOClient
from repro_torch.utils.rng import RngStream


def default_actions(spaces: CaratSpaces) -> List[Tuple[int, int]]:
    """A bounded fleet-wide action grid: subsampled windows x depths.

    Tabular learners need a small action set; this keeps the extremes
    plus every other window and every third in-flight depth (~16 actions
    on the paper's spaces instead of the full 63-cell grid).
    """
    ws = sorted(set(spaces.rpc_window_pages[::2]
                    + (spaces.rpc_window_pages[-1],)))
    fs = sorted(set(spaces.rpcs_in_flight[::3]
                    + (spaces.rpcs_in_flight[-1],)))
    acts = [(w, f) for w in ws for f in fs]
    default = (spaces.default_rpc_window, spaces.default_in_flight)
    if default not in acts:
        acts.append(default)
    return acts


class MagpieDrlPolicy(TuningPolicy):
    name = "magpie"
    # the full-gather stress case for sharded execution: the reward is a
    # fleet-wide sum, so every shard publishes its clients' counters and
    # the coordinator ticks the epoch machine over the gathered view
    gather = "fleet"

    def __init__(
        self,
        spaces: CaratSpaces,
        actions: Optional[Sequence[Tuple[int, int]]] = None,
        dwell: int = 4,
        epsilon: float = 0.15,
        ema_lambda: float = 0.5,
        seed: int = 0,
    ):
        super().__init__()
        if dwell < 1:
            raise ValueError("dwell must be >= 1 interval")
        self.spaces = spaces
        self.actions = list(actions) if actions is not None \
            else default_actions(spaces)
        self.dwell = dwell
        self.epsilon = epsilon
        self.ema_lambda = ema_lambda
        self.seed = seed
        self.rng = RngStream(seed, "magpie")
        default = (spaces.default_rpc_window, spaces.default_in_flight)
        self._action = (self.actions.index(default)
                        if default in self.actions else 0)
        self._q: Dict[int, float] = {}
        self._epochs = 0
        self._intervals = 0
        self._epoch_bytes = 0.0
        self._prev_total: Optional[float] = None
        # latest observed cumulative bytes per client (bus path): stale
        # shards keep contributing their last published counter, the
        # bounded-staleness view of the fleet reward
        self._latest_bytes: Dict[int, float] = {}
        self._last_bus_tick_t: Optional[float] = None
        self.decisions: List[tuple] = []

    # --------------------------------------------------------- lifecycle
    def _total_bytes(self, clients: Sequence[IOClient]) -> float:
        return sum(c.stats.read.app_bytes + c.stats.write.app_bytes
                   for c in clients)

    def decide(self, obs: float) -> Optional[Tuple[int, int]]:
        """One epoch reward -> the next fleet-wide action (None = keep)."""
        prev = self._q.get(self._action)
        self._q[self._action] = (obs if prev is None else
                                 (1.0 - self.ema_lambda) * prev
                                 + self.ema_lambda * obs)
        self._epochs += 1
        eps = self.epsilon / (1.0 + 0.1 * self._epochs)
        if float(self.rng.uniform()) < eps:
            nxt = int(self.rng.integers(0, len(self.actions)))
        else:
            # optimistic init: every action is tried once before the
            # learned values are exploited
            best = max(self._q.values())
            nxt, score = 0, -float("inf")
            for a in range(len(self.actions)):
                s = self._q.get(a, best + 1.0)
                if s > score:
                    score, nxt = s, a
        if nxt == self._action:
            return None
        self._action = nxt
        return self.actions[nxt]

    def _tick(self, total: float, t: float) -> Optional[Tuple[int, int]]:
        """One fleet-total sample -> the fleet-wide action, if the epoch
        closed and the actor moved (shared by the single-process step and
        the coordinator's ``bus_decide``)."""
        if self._prev_total is None:        # first probe: no delta yet
            self._prev_total = total
            return None
        self._epoch_bytes += total - self._prev_total
        self._prev_total = total
        self._intervals += 1
        if self._intervals < self.dwell:
            return None
        reward = self._epoch_bytes
        self._intervals = 0
        self._epoch_bytes = 0.0
        action = self.decide(reward)
        if action is not None:
            self.decisions.append((t, "magpie") + action)
        return action

    def step(self, clients: Sequence[IOClient], t: float, dt: float) -> None:
        mine = self.my_clients(clients)
        action = self._tick(self._total_bytes(mine), t)
        if action is not None:
            for client in mine:
                client.set_rpc_config(*action)

    # --------------------------------------------------- sharded/bus path
    def observe(self, client: IOClient, t: float, dt: float) -> float:
        """Shard-side sample: one client's cumulative application bytes
        (centralized observability lives at the coordinator, which sums
        the gathered counters)."""
        return client.stats.read.app_bytes + client.stats.write.app_bytes

    def bus_decide(self, obs: Sequence[Tuple[int, float]],
                   t: float) -> List[Tuple[int, Tuple[int, int]]]:
        if not obs:
            return []                       # no new counters: no epoch tick
        for cid, total in obs:
            self._latest_bytes[cid] = total
        # dwell counts fleet probe intervals, not coordinator gathers: an
        # async coordinator may gather several partial batches within one
        # fleet interval (same t) — only the first advances the epoch
        if self._last_bus_tick_t is not None and t <= self._last_bus_tick_t:
            return []
        self._last_bus_tick_t = t
        # sum in bound-id order: the same float accumulation order as the
        # single-process step, so sync-sharded decisions stay identical
        ids = self.client_ids or sorted(self._latest_bytes)
        action = self._tick(sum(self._latest_bytes.get(cid, 0.0)
                                for cid in ids), t)
        if action is None:
            return []
        return [(cid, action) for cid in ids]

    def actuate(self, client: IOClient, decision: Optional[Tuple[int, int]],
                t: float) -> None:
        if decision is not None:
            client.set_rpc_config(*decision)

    # --------------------------------------------------------- config
    def config(self) -> Dict[str, Any]:
        return {"policy": self.name, "spaces": self.spaces,
                "actions": list(self.actions), "dwell": self.dwell,
                "epsilon": self.epsilon, "ema_lambda": self.ema_lambda,
                "seed": self.seed}
