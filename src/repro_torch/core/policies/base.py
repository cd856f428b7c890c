"""The pluggable tuning-policy protocol.

A :class:`TuningPolicy` is *any* client-side tuner that can drive the
simulator's clients: CARAT itself, a static configuration, a DIAL-style
decentralized learned tuner, a Magpie-style centralized DRL actor, or
anything else registered in :data:`repro_torch.core.policies.POLICIES`.
One policy instance serves a whole deployment (one client or many)
through a uniform lifecycle, invoked once per probe interval by
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

Sharded execution (the observation/decision bus)
------------------------------------------------

Under :class:`repro_torch.core.runtime.sharded.ShardedRuntime` the
deployment's clients are partitioned into node-group shards and a policy
never sees ``sim.clients`` whole. The ``gather`` class attribute
declares what the policy needs:

* ``gather = "none"`` — every decision depends only on the observed
  client's own state (static configs, DIAL-style local learners, plain
  per-client callbacks). The runtime calls :meth:`step_shard` on each
  shard's client subset independently; no messages cross shards.
* ``gather = "fleet"`` — decisions need cross-client state (CARAT's one
  batched tuner + node arbiters, Magpie's global reward). The runtime
  runs the split lifecycle over a
  :class:`~repro_torch.core.runtime.bus.TuningBus`: shards publish
  :meth:`shard_observe` output as observation messages, a coordinator
  turns a gathered batch into decision messages with
  :meth:`bus_decide`, and shards apply them with :meth:`shard_actuate`.
  A second request/reply round (:meth:`shard_collect` ->
  :meth:`bus_resolve` -> :meth:`shard_apply`) carries end-of-interval
  work that must see fleet state — CARAT's stage-2 cache drain and
  cross-shard budget trading ride on it.

The split methods receive/return ``(client_id, payload)`` pairs, never
client objects, so the same protocol backs the out-of-process
transports (``repro_torch.core.runtime.transport``). The defaults decompose the base lifecycle, so a simple
policy gets sharded execution for free.
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
    (trace replay) rather than how they are configured. ``gather``
    declares what sharded execution needs (see module docstring).
    """

    name: str = "abstract"
    phase: str = "tune"
    gather: str = "none"

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
        client. Shard-scoped calls, which legitimately see a subset, go
        through :meth:`present_clients` instead.
        """
        if self.client_ids is None:
            return list(clients)
        return resolve_bound_clients(f"policy {self.name!r}",
                                     self.client_ids, clients)

    def present_clients(self, clients: Sequence[IOClient]) -> List[IOClient]:
        """Bound ids ∩ ``clients``, in bound-id order — the shard view,
        where seeing only a subset of the bound fleet is expected."""
        if self.client_ids is None:
            return list(clients)
        by_id = {c.client_id: c for c in clients}
        return [by_id[cid] for cid in self.client_ids if cid in by_id]

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

    # --------------------------------------------- sharded/bus protocol
    def step_shard(self, clients: Sequence[IOClient], t: float,
                   dt: float) -> None:
        """One probe interval over one shard's client subset.

        The ``gather = "none"`` execution path: identical to
        :meth:`step` but scoped to the bound clients present in this
        shard. Only valid for policies whose per-client decisions are
        independent of the rest of the fleet.
        """
        rec = _telemetry()
        pending: List[Tuple[IOClient, Any]] = []
        with rec.span("policy.observe", cat="policy"):
            for client in self.present_clients(clients):
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

    def shard_observe(self, clients: Sequence[IOClient], t: float,
                      dt: float) -> List[Tuple[int, Any]]:
        """Shard side of a ``gather = "fleet"`` policy: observe the bound
        clients present in this shard and return ``(client_id, obs)``
        pairs to publish as observation messages."""
        out: List[Tuple[int, Any]] = []
        with _telemetry().span("policy.observe", cat="policy"):
            for client in self.present_clients(clients):
                obs = self.observe(client, t, dt)
                if obs is not None:
                    out.append((client.client_id, obs))
        return out

    def bus_decide(self, obs: Sequence[Tuple[int, Any]],
                   t: float) -> List[Tuple[int, Any]]:
        """Coordinator side: a gathered observation batch (arbitrary
        arrival order) -> ``(client_id, decision)`` messages.

        The default restores bound-id order before ``decide_many`` so a
        sync-mode sharded run batches observations exactly like
        :meth:`step` does in one process.
        """
        if not obs:
            return []
        if self.client_ids is not None:
            rank = {cid: i for i, cid in enumerate(self.client_ids)}
            obs = sorted(obs, key=lambda p: rank.get(p[0], len(rank)))
        with _telemetry().span("policy.decide", cat="policy"):
            decisions = self.decide_many([o for _, o in obs])
        return [(cid, d) for (cid, _), d in zip(obs, decisions)]

    def shard_actuate(self, clients: Sequence[IOClient],
                      decisions: Sequence[Tuple[int, Any]],
                      t: float) -> None:
        """Shard side: apply gathered ``(client_id, decision)`` messages
        to this shard's clients (loud on unknown ids — a decision routed
        to the wrong shard is a transport bug)."""
        if not decisions:
            return
        targets = resolve_bound_clients(
            f"policy {self.name!r} decision", [cid for cid, _ in decisions],
            clients)
        with _telemetry().span("policy.actuate", cat="policy"):
            for client, (_, decision) in zip(targets, decisions):
                self.actuate(client, decision, t)

    def shard_collect(self, clients: Sequence[IOClient],
                      t: float) -> List[Tuple[Any, Any]]:
        """Shard side, end of interval: ``(key, request)`` pairs for the
        fleet-state round, scoped to this shard's clients (CARAT
        publishes pending stage-2 node demands here). Default: nothing
        to gather."""
        return []

    def bus_resolve(self, requests: Sequence[Tuple[Any, Any]],
                    t: float) -> List[Tuple[Any, Any]]:
        """Coordinator side: resolve gathered ``(key, request)`` pairs
        into ``(key, reply)`` messages (CARAT runs the batched Algorithm
        2 + cross-shard budget trading here). Default: no replies."""
        return []

    def shard_apply(self, replies: Sequence[Tuple[Any, Any]],
                    t: float) -> None:
        """Shard side: apply ``(key, reply)`` messages routed back to
        this shard. Default: nothing to apply."""

    # ------------------------------------------- snapshot / restore hooks
    def shard_state(self, client_ids: Sequence[int]) -> Any:
        """Portable policy state for the given shard's clients, carried
        inside transport snapshot/report blobs (pickled as one graph with
        the shard's clients). Policies holding per-client mutable state
        outside the clients themselves (CARAT's controller shells)
        override this; the default — stateless, or state lives on the
        clients — returns None."""
        return None

    def merge_shard_state(self, state: Any) -> None:
        """Install state produced by :meth:`shard_state` (snapshot
        restore, worker report merge, repartition). Default: no-op."""

    # ------------------------------------------------------------ config
    def config(self) -> Dict[str, Any]:
        """Constructor kwargs + ``"policy": name`` — the round-trippable
        description consumed by ``policy_from_config``."""
        return {"policy": self.name}

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"
