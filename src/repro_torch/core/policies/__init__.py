"""Pluggable tuning policies: one interface for CARAT and its rivals.

The :class:`TuningPolicy` lifecycle (``observe -> decide -> actuate``
plus batched ``decide_many``) lets any client-side tuner drive the same
simulator through one entry point, ``Simulation.attach_policy``::

    policy = make_policy("carat", spaces=spaces, models=models)
    sim.attach_policy(policy)
    sim.run(duration)

Registered policies:

* ``carat``  — the paper's two-stage co-tuner (:class:`CaratPolicy`);
  decision-identical to the scalar per-client ``CaratController`` loop.
* ``static`` — one fixed config, never adapted (default / static-best).
* ``dial``   — DIAL-style decentralized learned clients: per-client
  online neighbourhood bandits over locally observable metrics.
* ``magpie`` — Magpie-style centralized DRL tuner: one tabular actor
  over global state emitting a fleet-wide action.

``POLICIES`` is a plain :class:`repro_torch.utils.registry.Registry`, so
out-of-tree tuners register the same way::

    @POLICIES.register("mytuner")
    class MyPolicy(TuningPolicy): ...
"""
from __future__ import annotations

from typing import Any, Mapping

from repro_torch.core.policies.base import TuningPolicy, resolve_bound_clients
from repro_torch.core.policies.carat import (CaratPolicy,
                                             build_fleet_tuner,
                                             wire_controllers)
from repro_torch.core.policies.dial import DialPolicy
from repro_torch.core.policies.local import PerClientPolicy
from repro_torch.core.policies.magpie import MagpieDrlPolicy, default_actions
from repro_torch.core.policies.static import StaticPolicy
from repro_torch.utils.registry import Registry

POLICIES: Registry = Registry("tuning policy")
POLICIES.register("carat", CaratPolicy)
POLICIES.register("static", StaticPolicy)
POLICIES.register("dial", DialPolicy)
POLICIES.register("magpie", MagpieDrlPolicy)


def make_policy(name: str, **kwargs) -> TuningPolicy:
    """Construct a registered policy by name (unknown names raise with
    the list of known policies)."""
    return POLICIES.get(name)(**kwargs)


def policy_from_config(config: Mapping[str, Any]) -> TuningPolicy:
    """Rebuild a policy from its :meth:`TuningPolicy.config` description
    (``{"policy": <name>, **constructor_kwargs}``)."""
    kwargs = dict(config)
    try:
        name = kwargs.pop("policy")
    except KeyError:
        raise ValueError(f"policy config needs a 'policy' key naming one of: "
                         f"{', '.join(POLICIES.keys())}") from None
    return make_policy(name, **kwargs)


__all__ = [
    "TuningPolicy", "CaratPolicy", "StaticPolicy", "DialPolicy",
    "MagpieDrlPolicy", "PerClientPolicy", "POLICIES", "make_policy",
    "policy_from_config", "build_fleet_tuner", "wire_controllers",
    "default_actions", "resolve_bound_clients",
]
