"""The pluggable tuning-policy protocol.

A :class:`TuningPolicy` is *any* client-side tuner that can drive the
simulator's clients: CARAT itself, a static configuration, a DIAL-style
decentralized learned tuner, a Magpie-style centralized DRL actor, or
anything else registered in the reference's ``POLICIES`` registry. One
policy instance serves a whole deployment (one client or many) through a
uniform lifecycle, invoked once per probe interval by
``Simulation.attach_policy``:

``observe(client, t, dt) -> obs | None``
    Per-client sampling: read *that client's* counters, update any
    per-client state, and return an observation when a decision is due
    this probe (None otherwise). Decentralized policies must only read
    ``client``'s own counters here — the batching below is compute
    shape, not extra observability.

``decide(obs) / decide_many(obs_batch) -> decisions``
    Turn observations into decisions. ``decide_many`` is the fleet-scale
    entry point: one call covers every client with a pending observation
    this step, so vectorizing policies (CARAT's batched GBDT scoring)
    amortize inference across the fleet. The default implementation
    loops ``decide``.

``actuate(client, decision, t)``
    Apply one client's decision (``set_rpc_config`` / ``set_cache_limit``).
    Called for *every* pending observation, including ``decision=None``
    ("retain current config"), so policies can account applies uniformly.

``finish_step(t)``
    End-of-step hook after all actuations — where CARAT drains pending
    stage-2 cache boundaries, and centralized policies commit fleet-wide
    actions.

:meth:`step` composes the lifecycle and is what a single-process
simulation invokes; policies whose observation is inherently global
(Magpie's centralized actor) or that need bespoke member ordering
(CARAT's fleet engine) override it, keeping the same observe -> decide
-> actuate shape.

The reference package also defines a sharded split of this lifecycle
(``repro.core.policies.base``: ``step_shard``, ``shard_observe``,
``bus_decide`` and the rest) for its sharded runtime; that runtime is
not ported yet, and neither is the split.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.telemetry import active as _telemetry
from repro_torch.storage.client import IOClient


def resolve_bound_clients(who: str, client_ids: Sequence[int],
                          clients: Sequence[IOClient]) -> List[IOClient]:
    """Resolve bound ids against this step's client list, loudly.

    Every attach path shares this diagnostic shape: a bound id with no
    matching client is a wiring bug (stale binding, wrong subset passed
    to a shard) and must never be silently skipped.
    """
    by_id = {c.client_id: c for c in clients}
    missing = [cid for cid in client_ids if cid not in by_id]
    if missing:
        raise KeyError(f"{who} is bound to client(s) {missing} with no "
                       f"matching client this step (got ids "
                       f"{sorted(by_id)})")
    return [by_id[cid] for cid in client_ids]


class TuningPolicy:
    """Base class / protocol for pluggable client-side tuners.

    Subclasses set ``name`` (the registry key) and implement the
    lifecycle hooks. ``phase`` declares when the simulation runs the
    policy: ``"tune"`` (default) after counters update — the probe ->
    snapshot -> tune loop of the paper's Fig 4 — or ``"workload"``
    before planning, for drivers that swap what the clients *do*
    (trace replay) rather than how they are configured.
    """

    name: str = "abstract"
    phase: str = "tune"

    def __init__(self) -> None:
        self.sim = None
        self.client_ids: Optional[List[int]] = None

    # ------------------------------------------------------------ lifecycle
    def bind(self, sim, client_ids: Optional[Sequence[int]] = None) -> None:
        """Wire the policy to a simulation (``Simulation.attach_policy``).

        ``client_ids`` restricts the policy to a subset of clients
        (None = every client). Policies that build per-client state
        (controller shells, bandit arms) do it here.
        """
        self.sim = sim
        if client_ids is not None:
            ids = [int(i) for i in client_ids]
            for cid in ids:
                sim.client_by_id(cid)       # fail fast on unknown ids
            self.client_ids = ids
        else:
            self.client_ids = [c.client_id for c in sim.clients]

    def my_clients(self, clients: Sequence[IOClient]) -> List[IOClient]:
        """The bound subset of ``clients``, in bound-id order.

        Raises (shared diagnostic shape) if any bound id is absent from
        ``clients`` — a whole-deployment step must present every bound
        """
        if self.client_ids is None:
            return list(clients)
        return resolve_bound_clients(f"policy {self.name!r}",
                                     self.client_ids, clients)

    def observe(self, client: IOClient, t: float, dt: float) -> Optional[Any]:
        """Sample one client; return an observation when a decision is due."""
        return None

    def decide(self, obs: Any) -> Any:
        """One observation -> one decision (None = retain current config)."""
        raise NotImplementedError

    def decide_many(self, obs_batch: Sequence[Any]) -> List[Any]:
        """Batched decisions; override to vectorize across the fleet."""
        return [self.decide(obs) for obs in obs_batch]

    def actuate(self, client: IOClient, decision: Any, t: float) -> None:
        """Apply one client's decision."""

    def finish_step(self, t: float) -> None:
        """End-of-step hook (stage-2 drains, fleet-wide commits)."""

    # ------------------------------------------------------------ driver
    def step(self, clients: Sequence[IOClient], t: float, dt: float) -> None:
        """One probe interval: observe every bound client, decide the
        pending batch in one ``decide_many`` call, actuate, finish."""
        rec = _telemetry()
        pending: List[Tuple[IOClient, Any]] = []
        with rec.span("policy.observe", cat="policy"):
            for client in self.my_clients(clients):
                obs = self.observe(client, t, dt)
                if obs is not None:
                    pending.append((client, obs))
        if pending:
            with rec.span("policy.decide", cat="policy"):
                decisions = self.decide_many([obs for _, obs in pending])
            with rec.span("policy.actuate", cat="policy"):
                for (client, _), decision in zip(pending, decisions):
                    self.actuate(client, decision, t)
        self.finish_step(t)

    # a policy is also a plain fleet hook: (clients, t, dt) -> None
    def __call__(self, clients: Sequence[IOClient], t: float,
                 dt: float) -> None:
        self.step(clients, t, dt)

    # ------------------------------------------------------------ config
    def config(self) -> Dict[str, Any]:
        """Constructor kwargs + ``"policy": name``."""
        return {"policy": self.name}

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"
