"""Static configuration policy — the paper's "default" and "static-best"
comparison points, expressed through the :class:`TuningPolicy` lifecycle.

Applies one fixed :class:`ClientConfig` to every bound client at bind
time and never touches them again: the never-adapts baseline every
adaptive tuner must beat. Pass the Lustre default (no arguments) for the
"default" scenario or any tuned config (e.g. an offline-searched
optimum) for "static-best".
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from repro_torch.core.policies.base import TuningPolicy
from repro_torch.storage.client import ClientConfig


class StaticPolicy(TuningPolicy):
    name = "static"

    def __init__(self, config: Optional[ClientConfig] = None,
                 label: str = "default"):
        super().__init__()
        self.template = config or ClientConfig()
        self.template.validate()
        self.label = label

    def bind(self, sim, client_ids: Optional[Sequence[int]] = None) -> None:
        super().bind(sim, client_ids)
        for client in self.my_clients(sim.clients):
            client.set_rpc_config(self.template.rpc_window_pages,
                                  self.template.rpcs_in_flight)
            client.set_cache_limit(self.template.dirty_cache_mb)

    # the lifecycle is trivially static: nothing to observe, decide, or
    # actuate after bind — step() falls through the base implementation
    # with no pending observations.

    def config(self) -> Dict[str, Any]:
        return {"policy": self.name, "label": self.label,
                "config": ClientConfig(self.template.rpc_window_pages,
                                       self.template.rpcs_in_flight,
                                       self.template.dirty_cache_mb)}
