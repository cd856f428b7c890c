"""CARAT — the paper's contribution, as a composable module.

Pipeline (paper Fig 4): counters -> SnapshotBuilder (metrics + deltas)
-> ML model f(theta, H_t) -> RPC tuner (Alg 1) / cache tuner (Alg 2)
-> actuation, orchestrated per client by CaratController (two-stage, §III-A).

The names below are the reference's re-exports, loaded on first access
(PEP 562): the GBDT kernel wrappers import ``repro_torch.core.ml``, and an
eager import here would pull the policy stack, which imports those
wrappers, into every kernel import.
"""
import importlib

_EXPORTS = {
    "repro_torch.core.policy": ("CaratSpaces", "default_spaces"),
    "repro_torch.core.metrics": ("Metrics", "compute_metrics",
                                 "FEATURE_NAMES"),
    "repro_torch.core.snapshot": ("SnapshotBuilder", "Snapshot"),
    "repro_torch.core.rpc_tuner": ("ConditionalScoreGreedy", "GreedyTuner",
                                   "EpsilonGreedyTuner", "make_tuner"),
    "repro_torch.core.cache_tuner": ("CacheDemand", "CacheDemandBatch",
                                     "cache_allocation",
                                     "cache_allocation_many",
                                     "trade_node_budgets"),
    "repro_torch.core.controller": ("CaratController", "NodeCacheArbiter"),
    "repro_torch.core.policies": ("POLICIES", "CaratPolicy", "DialPolicy",
                                  "MagpieDrlPolicy", "PerClientPolicy",
                                  "StaticPolicy", "TuningPolicy",
                                  "build_fleet_tuner", "make_policy",
                                  "policy_from_config", "wire_controllers"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = [
    "CaratSpaces", "default_spaces", "Metrics", "compute_metrics",
    "FEATURE_NAMES", "SnapshotBuilder", "Snapshot",
    "ConditionalScoreGreedy", "GreedyTuner", "EpsilonGreedyTuner",
    "make_tuner", "cache_allocation", "cache_allocation_many",
    "CacheDemand", "CacheDemandBatch", "trade_node_budgets",
    "CaratController", "NodeCacheArbiter",
    "TuningPolicy", "CaratPolicy", "StaticPolicy", "DialPolicy",
    "MagpieDrlPolicy", "PerClientPolicy", "POLICIES", "make_policy",
    "policy_from_config", "build_fleet_tuner", "wire_controllers",
]


def __getattr__(name):
    if name in _MODULE_OF:
        return getattr(importlib.import_module(_MODULE_OF[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
