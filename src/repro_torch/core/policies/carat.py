"""CARAT as a :class:`TuningPolicy` — the paper's two-stage co-tuner.

This module owns the fleet-scale decision engine. The decision
semantics are gated: per-client :class:`CaratController` shells run the
shared ``observe()`` path (snapshot, stage machine, stage-2 boundary
marking, phase re-probe) in member order, stage-1 proposals come from
one vectorized ``propose_many`` per probe, and pending stage-2 node
boundaries drain into one batched ``cache_allocation_many`` call with
the slot-ordered GBDT/write-share accumulation intact — so decisions
stay bit-identical to the per-client loop, and to the reference's
``CaratPolicy`` (``tests/test_torch_carat.py`` holds the port to it).

Construction comes in two shapes:

* ``CaratPolicy(spaces, models, cfg, ...)`` — self-wiring: at
  ``bind(sim)`` it builds one controller shell per client and one
  deferred stage-2 arbiter per node (from ``topology`` /
  ``sim.topology``, defaulting to a private node per client).
* ``CaratPolicy(models=..., controllers=[...])`` — host prebuilt shells.

Scoring runs on the policy's ``device``: the fleet tuner scores every
probe batch through :class:`~repro_torch.kernels.gbdt_infer.ops.GridGBDTScorer`
(the ``gbdt_grid_logits`` CUDA kernel on ``cuda``), and the per-client
scalar path (a bootstrap pick after a re-probe) through
:class:`~repro_torch.kernels.gbdt_infer.ops.GBDTScorer` (``gbdt_logits``).
On ``device="cpu"`` both run their plain torch versions; every path is
bit-identical to ``ObliviousGBDT.predict_proba``.

Sharded execution: CARAT is ``gather = "fleet"`` — under a
:class:`~repro_torch.core.runtime.sharded.ShardedRuntime`, shards publish
``(client_id, (op, feats, rng_state))`` observation messages — the
tuner RNG travels as *serialized state*
(:meth:`repro_torch.utils.rng.RngStream.state`), never as a live
generator, so the protocol stays object-free on the bus. The
coordinator restores member order, rebuilds the per-client streams,
runs the one batched decision engine over the gathered batch (the
GBDT kernels on ``device``), and scatters
``(client_id, (op, proposal, share, rng_state'))`` decisions back;
``shard_actuate`` installs the advanced stream state before applying —
so a decided client's RNG trajectory is exactly the single-process one,
and a *dropped* stale observation leaves the stream untouched (the draw
never happened). The stage-2 drain rides the request/reply round:
shards publish pending node demand rows keyed by arbiter rank, the
coordinator batches every gathered node into one
``cache_allocation_many`` call — with ``budget_trading`` the
:func:`trade_node_budgets` pass runs over that same gathered batch,
which is how budget moves *across shards* — and shards apply the
returned allocation rows. :meth:`CaratPolicy.shard_state` /
:meth:`CaratPolicy.merge_shard_state` carry a shard's controller shells
(stage machines, arbiters, tuner RNGs, decision logs) across a
snapshot/restore or repartition boundary.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.config import CaratConfig
from repro_torch.core.cache_tuner import (CacheDemand, CacheDemandBatch,
                                          cache_allocation,
                                          cache_allocation_many,
                                          trade_node_budgets)
from repro_torch.core.controller import CaratController, NodeCacheArbiter
from repro_torch.core.ml.gbdt import ObliviousGBDT
from repro_torch.core.policies.base import TuningPolicy, resolve_bound_clients
from repro_torch.core.policy import CaratSpaces
from repro_torch.core.rpc_tuner import _TunerBase, make_tuner
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.gbdt_infer.ops import GBDTScorer, GridGBDTScorer
from repro_torch.storage.client import IOClient
from repro_torch.telemetry import active as _telemetry
from repro_torch.telemetry import perf_s
from repro_torch.utils.rng import RngStream

NodeBudgets = Union[float, Mapping[object, float], None]


def _as_prob_fn(model, device) -> object:
    """Cross-product scorer for ``model``: an :class:`ObliviousGBDT` gets
    the kernel-backed :class:`GBDTScorer` on ``device``; anything else is
    used through its ``predict_proba`` (or called as is)."""
    if isinstance(model, ObliviousGBDT):
        return GBDTScorer(model, device=device).predict_proba
    return model.predict_proba if hasattr(model, "predict_proba") else model


def build_fleet_tuner(
    cfg: CaratConfig,
    spaces: CaratSpaces,
    models: Dict[str, object],
    device: DeviceLike = None,
    rng: Optional[RngStream] = None,
) -> _TunerBase:
    """One shared batched tuner for a whole fleet.

    ``models`` maps op -> either an :class:`ObliviousGBDT` (gets the
    factorized :class:`GridGBDTScorer` on ``device``) or any
    ``predict_proba``-style callable (scored via the generic cross-product
    fallback — still one call per op direction).
    """
    dev = resolve_device(device)
    theta = spaces.theta_features()
    grid: Dict[str, GridGBDTScorer] = {}
    probs: Dict[str, object] = {}
    for op, m in models.items():
        probs[op] = _as_prob_fn(m, dev)
        if isinstance(m, ObliviousGBDT):
            grid[op] = GridGBDTScorer(m, theta, device=dev)
    return make_tuner(cfg.tuner, spaces, probs, tau=cfg.prob_tau,
                      alpha=cfg.alpha, beta=cfg.beta, epsilon=cfg.epsilon,
                      rng=rng or RngStream(0, "fleet"), grid_models=grid)


def _node_budget(node_budgets_mb: NodeBudgets, node: object) -> Optional[float]:
    if node_budgets_mb is None:
        return None
    if isinstance(node_budgets_mb, (int, float)):
        return float(node_budgets_mb)
    try:
        return float(node_budgets_mb[node])
    except KeyError:
        raise ValueError(f"node_budgets_mb has no budget for node {node!r}")


def wire_controllers(
    sim,
    spaces: CaratSpaces,
    models: Dict[str, object],
    cfg: Optional[CaratConfig] = None,
    shared_node_arbiter: bool = False,
    node_budget_mb: Optional[float] = None,
    topology: Optional[Sequence[object]] = None,
    node_budgets_mb: NodeBudgets = None,
    client_ids: Optional[Sequence[int]] = None,
) -> List[CaratController]:
    """Build one controller shell per sim client and one deferred stage-2
    arbiter per node — the wiring behind ``CaratPolicy.bind`` (and usable
    standalone). ``client_ids`` restricts the wiring to a subset
    of clients *before* arbiters are built, so excluded clients are never
    registered as (phantom) arbiter members.

    ``topology`` maps each client (by position in ``sim.clients``) to a
    node id; omitted, it falls back to ``sim.topology``, then to the
    legacy binary choice: ``shared_node_arbiter=True`` puts every client
    on one node, ``False`` (default) gives each client a private node.
    ``node_budgets_mb`` is a single budget applied to every node or a
    mapping node id -> budget (``None`` keeps the arbiter's member-scaled
    default).
    """
    cfg = cfg or CaratConfig()
    if topology is None:
        topology = getattr(sim, "topology", None)
    if topology is not None:
        if shared_node_arbiter or node_budget_mb is not None:
            raise ValueError("topology replaces shared_node_arbiter/"
                             "node_budget_mb; pass node_budgets_mb instead")
        topology = list(topology)
        if len(topology) != len(sim.clients):
            raise ValueError(f"topology maps {len(topology)} clients but "
                             f"the simulation has {len(sim.clients)}")
    else:
        if node_budget_mb is not None and not shared_node_arbiter:
            # per-client arbiters would each get the full budget, silently
            # multiplying the intended node cap by the client count
            raise ValueError("node_budget_mb requires shared_node_arbiter="
                             "True (or pass a topology)")
        if shared_node_arbiter:
            topology = [0] * len(sim.clients)
            if node_budget_mb is not None:
                if node_budgets_mb is not None:
                    raise ValueError("pass node_budget_mb or node_budgets_mb,"
                                     " not both")
                node_budgets_mb = {0: node_budget_mb}
        else:
            topology = list(range(len(sim.clients)))
    pairs = list(zip(sim.clients, topology))
    if client_ids is not None:
        keep = {int(i) for i in client_ids}
        pairs = [(c, node) for c, node in pairs if c.client_id in keep]
    arbiters: Dict[object, NodeCacheArbiter] = {}
    for _, node in pairs:
        if node not in arbiters:
            arbiters[node] = NodeCacheArbiter(
                spaces, _node_budget(node_budgets_mb, node), deferred=True)
    return [CaratController(c.client_id, spaces, models, cfg,
                            arbiter=arbiters[node])
            for c, node in pairs]


class CaratPolicy(TuningPolicy):
    """The CARAT co-tuner behind the :class:`TuningPolicy` lifecycle.

    ``step`` keeps the proven fleet engine verbatim: member-ordered
    ``observe`` over the controller shells, one batched ``decide_many``
    (vectorized Algorithm 1), per-client ``actuate``, then
    ``finish_step`` drains every node with a pending stage-2 boundary
    into one batched Algorithm 2 call.
    """

    name = "carat"
    gather = "fleet"

    def __init__(
        self,
        spaces: Optional[CaratSpaces] = None,
        models: Optional[Dict[str, object]] = None,
        cfg: Optional[CaratConfig] = None,
        *,
        controllers: Optional[Sequence[CaratController]] = None,
        device: DeviceLike = None,
        stage2: str = "batched",
        budget_trading: bool = False,
        log_stage2: bool = False,
        topology: Optional[Sequence[object]] = None,
        node_budgets_mb: NodeBudgets = None,
    ):
        super().__init__()
        if models is None:
            raise ValueError("CaratPolicy needs op -> model scorers")
        if stage2 not in ("batched", "scalar"):
            raise ValueError(f"stage2 must be 'batched' or 'scalar', "
                             f"got {stage2!r}")
        self.models = models
        self.device = resolve_device(device)
        self.topology = topology
        self.node_budgets_mb = node_budgets_mb
        if controllers is not None:
            if not controllers:
                raise ValueError("fleet needs at least one controller")
            self.controllers = list(controllers)
            self.cfg = cfg or self.controllers[0].cfg
            self.spaces = self.controllers[0].spaces
            # One tuner serves every shell, so heterogeneous per-shell
            # settings would be silently overridden — reject them up front.
            for c in self.controllers:
                if c.cfg != self.cfg or c.spaces != self.spaces:
                    raise ValueError(
                        f"client {c.client_id}: fleet members must share one "
                        f"CaratConfig and CaratSpaces (fleet uses a single "
                        f"batched tuner); run heterogeneous clients "
                        f"per-client or in separate fleets")
        else:
            if spaces is None:
                raise ValueError("CaratPolicy needs spaces (or prebuilt "
                                 "controllers)")
            self.controllers = []               # built at bind()
            self.cfg = cfg or CaratConfig()
            self.spaces = spaces
        self.tuner = build_fleet_tuner(self.cfg, self.spaces, models,
                                       device=self.device)
        # stage-2 drain mode: "batched" = one cache_allocation_many over
        # every pending node; "scalar" = per-node cache_allocation with the
        # same drain timing (the benchmark baseline)
        self.stage2 = stage2
        self.budget_trading = budget_trading
        # when logging, each drain appends (demand_lists, budgets,
        # effective_budgets) for offline identity/timing replay
        self.stage2_events: Optional[List[tuple]] = [] if log_stage2 else None
        # fleet-level accounting
        self.batch_time_total = 0.0
        self.batch_count = 0
        self.decision_count = 0
        self.arbiter_time_total = 0.0
        self.arbiter_batch_count = 0
        self.node_retune_count = 0
        self.boundary_count = 0     # client-level stage-2 boundary events

    # --------------------------------------------------------- lifecycle
    def bind(self, sim, client_ids: Optional[Sequence[int]] = None) -> None:
        super().bind(sim, client_ids)
        if self.controllers:
            # prebuilt shells are already wired (arbiters, stage state):
            # a client_ids restriction cannot be applied after the fact,
            # so reject any subset that does not match them exactly
            if client_ids is not None:
                have = {c.client_id for c in self.controllers}
                want = {int(i) for i in client_ids}
                if want != have:
                    raise ValueError(
                        f"client_ids {sorted(want)} does not match the "
                        f"prebuilt controllers {sorted(have)}; restrict at "
                        f"construction time instead")
            return
        # the shells score their scalar path (bootstrap picks) with the
        # fleet tuner's kernel-backed cross-product scorers
        self.controllers = wire_controllers(
            sim, self.spaces, self.tuner.models, self.cfg,
            topology=self.topology, node_budgets_mb=self.node_budgets_mb,
            client_ids=client_ids)

    def observe(self, client: IOClient, t: float,
                dt: float) -> Optional[tuple]:
        """One shell's shared observe path; ``(ctrl, op, feats)`` when a
        stage-1 decision is due (the scalar protocol entry — ``step``
        walks the shells directly to keep member-order semantics)."""
        ctrl = self._shell(client.client_id)
        req = ctrl.observe(client, t, dt)
        if req is None:
            return None
        return (ctrl, req[0], req[1])

    def _shell(self, client_id: int) -> CaratController:
        # id -> controller index, rebuilt whenever the shell list is
        # replaced or grown (bind); the per-call linear scan was
        # quadratic at fleet scale
        cache = getattr(self, "_shell_cache", None)
        if (cache is None or cache[0] is not self.controllers
                or len(cache[1]) != len(self.controllers)):
            cache = (self.controllers,
                     {c.client_id: c for c in self.controllers})
            self._shell_cache = cache
        try:
            return cache[1][client_id]
        except KeyError:
            raise KeyError(
                f"no CARAT shell for client {client_id}") from None

    def decide(self, obs: tuple):
        return self.decide_many([obs])[0]

    def decide_many(self, obs_batch: Sequence[tuple]) -> List[tuple]:
        """Batched Algorithm 1 over every pending shell: one vectorized
        inference + selection call. Returns ``(proposal, tune_share_s)``
        per observation (proposal None = retain current config)."""
        ops = [op for _, op, _ in obs_batch]
        feats = np.stack([f for _, _, f in obs_batch])
        rngs = [c.tuner.rng for c, _, _ in obs_batch]
        return self._propose_batch(ops, feats, rngs)

    def _propose_batch(self, ops: List[str], feats: np.ndarray,
                       rngs: List[RngStream]) -> List[tuple]:
        """The shared decision engine: one ``propose_many`` call plus the
        fleet accounting. ``decide_many`` feeds it the shells' own RNG
        streams; ``bus_decide`` feeds it streams rebuilt from serialized
        state — same draws either way."""
        t0 = perf_s()
        proposals = self.tuner.propose_many(ops, feats, rngs=rngs)
        elapsed = perf_s() - t0
        self.batch_time_total += elapsed
        self.batch_count += 1
        self.decision_count += len(ops)
        share = elapsed / len(ops)
        return [(p, share) for p in proposals]

    def actuate(self, client: IOClient, decision: Tuple[Any, float],
                t: float, *, ctrl: Optional[CaratController] = None,
                op: str = "") -> None:
        proposal, share = decision
        if ctrl is None:
            ctrl = self._shell(client.client_id)
        ctrl.actuate(op, proposal, t, share)

    def step(self, clients: Sequence[IOClient], t: float, dt: float) -> None:
        # resolve by client id, not list position — fleets over reordered
        # or non-dense client id sets must not tune the wrong client
        # (loud, shared diagnostic shape, like every other attach path)
        targets = resolve_bound_clients(
            f"policy {self.name!r}",
            [c.client_id for c in self.controllers], clients)
        rec = _telemetry()
        pending: List[tuple] = []
        with rec.span("policy.observe", cat="policy"):
            for ctrl, client in zip(self.controllers, targets):
                req = ctrl.observe(client, t, dt)
                if req is not None:
                    pending.append((ctrl, req[0], req[1]))
        if pending:
            with rec.span("policy.decide", cat="policy"):
                decisions = self.decide_many(pending)
            with rec.span("policy.actuate", cat="policy"):
                for (ctrl, op, _), (proposal, share) in zip(pending,
                                                            decisions):
                    ctrl.actuate(op, proposal, t, share)
        self.finish_step(t)

    # ------------------------------------------------------- stage-2 drain
    def _pending_arbiters(self) -> List[NodeCacheArbiter]:
        arbs: List[NodeCacheArbiter] = []
        seen = set()
        for ctrl in self.controllers:
            a = ctrl.arbiter
            if a is not None and a.pending and id(a) not in seen:
                seen.add(id(a))
                arbs.append(a)
        return arbs

    def finish_step(self, t: float) -> None:
        """Arbitrate every node with a pending stage-2 boundary: one
        vectorized Algorithm 2 call across all of them (or the per-node
        scalar loop in ``stage2="scalar"`` mode)."""
        arbs = self._pending_arbiters()
        if not arbs:
            return
        crossings = [a.crossings for a in arbs]
        # log payload must snapshot demands BEFORE apply resets the factors
        logged = ([a.collect() for a in arbs]
                  if self.stage2_events is not None else None)
        budgets = np.array([a.budget() for a in arbs], dtype=np.float64)
        t0 = perf_s()
        if self.stage2 == "batched":
            batch = CacheDemandBatch.from_rows(
                [a.collect_rows() for a in arbs], budgets)
            effective = (trade_node_budgets(batch, self.spaces)
                         if self.budget_trading else batch.node_budgets_mb)
            rows = cache_allocation_many(batch, self.spaces,
                                         effective).tolist()
            elapsed = perf_s() - t0
            for a, row in zip(arbs, rows):
                a.apply_slots(row)
        else:
            demands = [a.collect() for a in arbs]
            if self.budget_trading:
                effective = trade_node_budgets(
                    CacheDemandBatch.pack(demands, budgets), self.spaces)
            else:
                effective = budgets
            allocs = [cache_allocation(d, self.spaces, float(b))
                      for d, b in zip(demands, effective)]
            elapsed = perf_s() - t0
            for a, alloc in zip(arbs, allocs):
                a.apply(alloc)
        self.arbiter_time_total += elapsed
        self.arbiter_batch_count += 1
        self.node_retune_count += len(arbs)
        self.boundary_count += sum(crossings)
        if self.stage2_events is not None:
            self.stage2_events.append(
                (logged, budgets, np.array(effective, dtype=np.float64),
                 crossings))

    # ------------------------------------------------------ sharded/bus path
    def _member_ranks(self) -> Dict[int, int]:
        """client_id -> position in the fleet member order (the order the
        single-process ``step`` batches observations in)."""
        return {c.client_id: i for i, c in enumerate(self.controllers)}

    def _ranked_arbiters(self) -> List[Tuple[int, NodeCacheArbiter]]:
        """(rank, arbiter) per unique arbiter; rank = index of its first
        member in the controller order — the order ``finish_step`` drains
        pending nodes in, which keeps sync-sharded batches identical."""
        out: List[Tuple[int, NodeCacheArbiter]] = []
        seen = set()
        for i, ctrl in enumerate(self.controllers):
            a = ctrl.arbiter
            if a is not None and id(a) not in seen:
                seen.add(id(a))
                out.append((i, a))
        return out

    def validate_shards(self, shard_of: Mapping[int, object]) -> None:
        """Reject shard partitions that split a stage-2 node arbiter:
        arbiters are node-local state, so all of a node's members must
        land in one shard (``ShardedRuntime`` calls this at build)."""
        for rank, arb in self._ranked_arbiters():
            shards = {shard_of.get(m.client_id) for m in arb.members}
            if len(shards) > 1:
                raise ValueError(
                    f"stage-2 arbiter over clients "
                    f"{[m.client_id for m in arb.members]} spans shards "
                    f"{sorted(map(str, shards))}; node groups must not be "
                    f"split across shards")

    def shard_observe(self, clients: Sequence[IOClient], t: float,
                      dt: float) -> List[Tuple[int, tuple]]:
        """Observe this shard's shells in member order; pending stage-1
        requests become ``(client_id, (op, feats, rng_state))`` messages.
        The tuner stream crosses the bus as serialized state — no live
        generator (or shell) reference leaves the shard."""
        by_id = {c.client_id: c for c in clients}
        out: List[Tuple[int, tuple]] = []
        with _telemetry().span("policy.observe", cat="policy"):
            for ctrl in self.controllers:
                client = by_id.get(ctrl.client_id)
                if client is None:
                    continue                # lives on another shard
                req = ctrl.observe(client, t, dt)
                if req is not None:
                    out.append((ctrl.client_id,
                                (req[0], req[1], ctrl.tuner.rng.state())))
        return out

    def bus_decide(self, obs: Sequence[Tuple[int, tuple]],
                   t: float) -> List[Tuple[int, tuple]]:
        """One batched Algorithm 1 over the gathered observations.

        Restores fleet member order first, so a sync-mode barrier gather
        feeds the decision engine the exact batch the single-process
        ``step`` builds — decisions stay bit-identical. Draws come from
        per-client streams rebuilt from the observations' serialized
        state, and each decision carries the advanced state back to the
        owning shard — the coordinator needs no shell access, so the
        same code serves in-process and cross-process transports.
        """
        if not obs:
            return []
        ranks = self._member_ranks()
        obs = sorted(obs, key=lambda p: ranks[p[0]])
        ops = [op for _, (op, _, _) in obs]
        feats = np.stack([f for _, (_, f, _) in obs])
        rngs = [RngStream.from_state(s) for _, (_, _, s) in obs]
        with _telemetry().span("policy.decide", cat="policy"):
            decisions = self._propose_batch(ops, feats, rngs)
        return [(cid, (op, proposal, share, rng.state()))
                for (cid, (op, _f, _s)), (proposal, share), rng
                in zip(obs, decisions, rngs)]

    def shard_actuate(self, clients: Sequence[IOClient],
                      decisions: Sequence[Tuple[int, tuple]],
                      t: float) -> None:
        with _telemetry().span("policy.actuate", cat="policy"):
            for cid, (op, proposal, share, rng_state) in decisions:
                ctrl = self._shell(cid)
                # install the coordinator's advanced stream before
                # applying: the shell's RNG trajectory stays exactly the
                # single-process one (and an observation dropped for
                # staleness leaves it untouched — that draw never
                # happened anywhere)
                ctrl.tuner.rng.set_state(rng_state)
                ctrl.actuate(op, proposal, t, share)

    def shard_collect(self, clients: Sequence[IOClient],
                      t: float) -> List[Tuple[int, tuple]]:
        """Pending stage-2 node boundaries owned by this shard, as
        ``(arbiter_rank, (rows, budget_mb, crossings))`` requests."""
        mine = {c.client_id for c in clients}
        out: List[Tuple[int, tuple]] = []
        for rank, arb in self._ranked_arbiters():
            if arb.pending and arb.members[0].client_id in mine:
                out.append((rank, (arb.collect_rows(), arb.budget(),
                                   arb.crossings)))
        return out

    def bus_resolve(self, requests: Sequence[Tuple[int, tuple]],
                    t: float) -> List[Tuple[int, tuple]]:
        """Batched Algorithm 2 over every gathered node: one
        ``cache_allocation_many`` call (or the scalar loop in
        ``stage2="scalar"`` mode), with ``budget_trading`` moving budget
        across all gathered nodes — including nodes from different
        shards, which is how cross-shard trading happens. Replies are
        ``(arbiter_rank, (allocation_row, effective_budget_mb))``.
        """
        if not requests:
            return []
        requests = sorted(requests, key=lambda p: p[0])
        all_rows = [rows for _, (rows, _, _) in requests]
        budgets = np.array([b for _, (_, b, _) in requests],
                           dtype=np.float64)
        crossings = [k for _, (_, _, k) in requests]
        logged = None
        if self.stage2_events is not None:
            logged = [[CacheDemand(cid, act, pc, pi, w)
                       for cid, act, pc, pi, w in zip(*rows)]
                      for rows in all_rows]
        t0 = perf_s()
        if self.stage2 == "batched":
            batch = CacheDemandBatch.from_rows(all_rows, budgets)
            effective = (trade_node_budgets(batch, self.spaces)
                         if self.budget_trading else batch.node_budgets_mb)
            rows_out = cache_allocation_many(batch, self.spaces,
                                             effective).tolist()
        else:
            demands = [[CacheDemand(cid, act, pc, pi, w)
                        for cid, act, pc, pi, w in zip(*rows)]
                       for rows in all_rows]
            if self.budget_trading:
                effective = trade_node_budgets(
                    CacheDemandBatch.from_rows(all_rows, budgets),
                    self.spaces)
            else:
                effective = budgets
            allocs = [cache_allocation(d, self.spaces, float(b))
                      for d, b in zip(demands, effective)]
            # positional rows in member order (cache_allocation covers
            # every member, so this is apply()-equivalent via apply_slots)
            rows_out = [[alloc[dd.client_id] for dd in d]
                        for d, alloc in zip(demands, allocs)]
        elapsed = perf_s() - t0
        self.arbiter_time_total += elapsed
        self.arbiter_batch_count += 1
        self.node_retune_count += len(requests)
        self.boundary_count += sum(crossings)
        if self.stage2_events is not None:
            self.stage2_events.append(
                (logged, budgets, np.array(effective, dtype=np.float64),
                 crossings))
        eff = np.asarray(effective, dtype=np.float64).tolist()
        return [(rank, (vals, e))
                for (rank, _), vals, e in zip(requests, rows_out, eff)]

    def shard_apply(self, replies: Sequence[Tuple[int, tuple]],
                    t: float) -> None:
        by_rank = dict(self._ranked_arbiters())
        for rank, (values, _effective) in replies:
            by_rank[rank].apply_slots(values)

    # ------------------------------------------------- snapshot / restore
    def shard_state(self, client_ids: Sequence[int]) -> List[CaratController]:
        """The policy state owned by one shard: its controller shells
        (stage machines, node arbiters, tuner RNGs, decision logs).
        Returned live — the transport pickles the whole shard blob in one
        graph, so ``controller.client`` identity with the shard's clients
        survives the round trip."""
        keep = {int(i) for i in client_ids}
        return [c for c in self.controllers if c.client_id in keep]

    def merge_shard_state(self, state: Sequence[CaratController]) -> None:
        """Install shells restored from :meth:`shard_state`, replacing
        this policy's by client id (member order — and so decision
        batching — is preserved)."""
        slot = {c.client_id: i for i, c in enumerate(self.controllers)}
        for ctrl in state:
            i = slot.get(ctrl.client_id)
            if i is None:
                raise KeyError(f"restored shell for unknown client "
                               f"{ctrl.client_id}")
            self.controllers[i] = ctrl
        # the in-place replacement keeps the same list object, which the
        # id->shell cache keys on — drop it or lookups serve stale shells
        self._shell_cache = None

    # ----------------------------------------------------------- accounting
    @property
    def mean_decision_s(self) -> float:
        """Mean tuner cost per client decision (the fleet-scale metric)."""
        return self.batch_time_total / max(self.decision_count, 1)

    @property
    def mean_node_retune_s(self) -> float:
        """Mean arbiter cost per node stage-2 boundary."""
        return self.arbiter_time_total / max(self.node_retune_count, 1)

    @property
    def decisions(self) -> List[List[tuple]]:
        return [c.decisions for c in self.controllers]

    def overheads(self) -> Dict[str, float]:
        snap_ms = float(np.mean([c.builder.mean_snapshot_time_s
                                 for c in self.controllers])) * 1e3
        return {
            "snapshot_ms": snap_ms,
            "inference_ms": self.tuner.mean_inference_s * 1e3,
            "decision_ms": self.mean_decision_s * 1e3,
            "batch_ms": (self.batch_time_total
                         / max(self.batch_count, 1)) * 1e3,
            "stage2_node_ms": self.mean_node_retune_s * 1e3,
        }

    # ----------------------------------------------------------- config
    def config(self) -> Dict[str, Any]:
        return {
            "policy": self.name, "spaces": self.spaces,
            "models": self.models, "cfg": self.cfg,
            "device": str(self.device), "stage2": self.stage2,
            "budget_trading": self.budget_trading,
            "log_stage2": self.stage2_events is not None,
            "topology": self.topology,
            "node_budgets_mb": self.node_budgets_mb,
        }
