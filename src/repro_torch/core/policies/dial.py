"""DIAL-style decentralized learned tuner (arXiv:2602.22392).

DIAL tunes each parallel-file-system client *independently*, from
metrics that client can observe locally — no cluster-wide state, no
cross-client coordination. This baseline reproduces that shape on the
simulator: every bound client runs its own online learner over the
discrete RPC candidate grid, rewarded by its own application throughput
(the same locally-observable signal CARAT's snapshot pipeline samples).

The per-client learner is a neighborhood bandit, the common core of
trial-and-error client tuners: dwell on the current ``(window_pages,
in_flight)`` cell for a few probes, track an exponential moving average
of per-interval application bytes per visited cell, then move to the
best-known adjacent cell (unvisited neighbours are optimistic, so the
local neighbourhood is systematically explored before exploiting) with
an epsilon chance of a random neighbour. A dominant-op flip resets the
learned values and returns to the space default — the phase response of
the DIAL family. Exploration draws come from a per-client
:class:`RngStream`, so runs are deterministic and clients never share
state.

What this baseline deliberately lacks vs CARAT: no pretrained model
(it learns each workload from scratch online), no tau-gated stability
filter, and no stage-2 cache arbitration (``dirty_cache_mb`` is left at
the client's configured value).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.policies.base import TuningPolicy
from repro_torch.core.policy import CaratSpaces
from repro_torch.core.snapshot import SnapshotBuilder
from repro_torch.storage.client import IOClient
from repro_torch.utils.rng import RngStream


@dataclass
class _DialClientState:
    builder: SnapshotBuilder
    rng: RngStream
    arm: int                                     # current candidate index
    ema: Dict[int, float] = field(default_factory=dict)
    steps_in_arm: int = 0
    moves: int = 0
    last_op: Optional[str] = None
    decisions: List[tuple] = field(default_factory=list)


class DialPolicy(TuningPolicy):
    name = "dial"

    def __init__(
        self,
        spaces: CaratSpaces,
        dwell: int = 3,
        epsilon: float = 0.2,
        ema_lambda: float = 0.5,
        probe_interval_s: float = 0.5,
        seed: int = 0,
    ):
        super().__init__()
        if dwell < 1:
            raise ValueError("dwell must be >= 1 probe")
        self.spaces = spaces
        self.dwell = dwell
        self.epsilon = epsilon
        self.ema_lambda = ema_lambda
        self.probe_interval_s = probe_interval_s
        self.seed = seed
        self._cands = spaces.rpc_candidates()
        self._n_f = len(spaces.rpcs_in_flight)
        default = (spaces.default_rpc_window, spaces.default_in_flight)
        # a space may declare a default off its own grid (CaratSpaces only
        # validates sortedness) — start from the first cell then
        self._default_arm = (self._cands.index(default)
                             if default in self._cands else 0)
        self._state: Dict[int, _DialClientState] = {}

    # --------------------------------------------------------- lifecycle
    def bind(self, sim, client_ids: Optional[Sequence[int]] = None) -> None:
        super().bind(sim, client_ids)
        for cid in self.client_ids:
            self._state[cid] = _DialClientState(
                builder=SnapshotBuilder(interval_s=self.probe_interval_s),
                rng=RngStream(self.seed + cid, "dial"),
                arm=self._default_arm)

    def _neighbors(self, arm: int) -> List[int]:
        """Adjacent grid cells: one step along each parameter axis."""
        wi, fi = divmod(arm, self._n_f)
        out = []
        if wi > 0:
            out.append(arm - self._n_f)
        if wi < len(self.spaces.rpc_window_pages) - 1:
            out.append(arm + self._n_f)
        if fi > 0:
            out.append(arm - 1)
        if fi < self._n_f - 1:
            out.append(arm + 1)
        return out

    def observe(self, client: IOClient, t: float,
                dt: float) -> Optional[tuple]:
        state = self._state[client.client_id]
        snap = state.builder.sample(client.stats, t)
        if snap is None or not snap.active:
            return None
        op = snap.dominant_op
        if state.last_op is not None and op != state.last_op:
            # dominant-op flip: the learned values describe the old
            # regime — forget them and restart from the space default
            state.last_op = op
            state.ema.clear()
            state.steps_in_arm = 0
            if state.arm != self._default_arm:
                state.arm = self._default_arm
                return ("reset", state)
            return None
        state.last_op = op
        reward = snap.perf()
        prev = state.ema.get(state.arm)
        state.ema[state.arm] = (reward if prev is None else
                                (1.0 - self.ema_lambda) * prev
                                + self.ema_lambda * reward)
        state.steps_in_arm += 1
        if state.steps_in_arm < self.dwell:
            return None
        return ("move", state)

    def decide(self, obs: tuple) -> Optional[Tuple[int, int]]:
        kind, state = obs
        if kind == "reset":
            return self._cands[self._default_arm]
        state.steps_in_arm = 0
        hood = self._neighbors(state.arm)
        if not hood:                # degenerate 1x1 grid: nowhere to move
            return None
        eps = self.epsilon / (1.0 + 0.1 * state.moves)
        if float(state.rng.uniform()) < eps:
            choice = hood[int(state.rng.integers(0, len(hood)))]
        else:
            # optimistic hill-climb: unvisited neighbours outrank every
            # visited cell, so the local neighbourhood is swept before
            # the best-known cell is exploited
            best = max(state.ema.values())
            choice = state.arm
            score = state.ema[state.arm]
            for a in hood:
                s = state.ema.get(a, best + 1.0)
                if s > score:
                    score, choice = s, a
        if choice == state.arm:
            return None
        state.arm = choice
        state.moves += 1
        return self._cands[choice]

    def actuate(self, client: IOClient, decision: Optional[Tuple[int, int]],
                t: float) -> None:
        if decision is None:
            return
        client.set_rpc_config(*decision)
        self._state[client.client_id].decisions.append((t, "dial") + decision)

    # --------------------------------------------------------- inspection
    @property
    def decisions(self) -> List[List[tuple]]:
        return [self._state[cid].decisions for cid in (self.client_ids or [])]

    def config(self) -> Dict[str, Any]:
        return {"policy": self.name, "spaces": self.spaces,
                "dwell": self.dwell, "epsilon": self.epsilon,
                "ema_lambda": self.ema_lambda,
                "probe_interval_s": self.probe_interval_s, "seed": self.seed}
