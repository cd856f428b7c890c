"""Per-client callback adapter — scalar controllers on the policy path.

:class:`PerClientPolicy` hosts plain ``(client, t, dt)`` callbacks (a
:class:`~repro_torch.core.controller.CaratController`, a
probe/collector closure, anything callable with that signature) behind
the :class:`~repro_torch.core.policies.base.TuningPolicy` lifecycle::

    sim.attach_policy(PerClientPolicy({0: ctrl_a, 3: ctrl_b}))

Each callback sees exactly one client and is invoked in mapping order —
the scalar per-client semantics the fleet-batched ``CaratPolicy`` is
gated against. Decisions are per-client by construction, so the policy
is ``gather = "none"``: a sharded runtime steps each shard's callbacks
locally with no cross-shard messages.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

from repro_torch.core.policies.base import TuningPolicy, resolve_bound_clients
from repro_torch.storage.client import IOClient

ClientCallback = Callable[[IOClient, float, float], None]


class PerClientPolicy(TuningPolicy):
    name = "callbacks"
    gather = "none"

    def __init__(self, callbacks: Mapping[int, ClientCallback]):
        super().__init__()
        if not callbacks:
            raise ValueError("PerClientPolicy needs at least one "
                             "client_id -> callback entry")
        self.callbacks: Dict[int, ClientCallback] = {
            int(cid): cb for cid, cb in callbacks.items()}

    def bind(self, sim, client_ids: Optional[Sequence[int]] = None) -> None:
        # the callback keys *are* the binding; an explicit client_ids
        # restriction must agree with them
        if client_ids is not None:
            want = {int(i) for i in client_ids}
            if want != set(self.callbacks):
                raise ValueError(
                    f"client_ids {sorted(want)} does not match the callback "
                    f"keys {sorted(self.callbacks)}; key the mapping "
                    f"instead")
        super().bind(sim, list(self.callbacks))

    def step(self, clients: Sequence[IOClient], t: float, dt: float) -> None:
        targets = resolve_bound_clients(f"policy {self.name!r}",
                                        list(self.callbacks), clients)
        for client, cb in zip(targets, self.callbacks.values()):
            cb(client, t, dt)

    def step_shard(self, clients: Sequence[IOClient], t: float,
                   dt: float) -> None:
        by_id = {c.client_id: c for c in clients}
        for cid, cb in self.callbacks.items():
            client = by_id.get(cid)
            if client is not None:
                cb(client, t, dt)
