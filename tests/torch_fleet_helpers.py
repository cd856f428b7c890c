"""Objects the port's process-fleet tests put into a simulation.

A ``ProcessRuntime`` pickles the whole simulation into every spawned
worker, which imports the module of each class it unpickles. So these
live in a module of their own that imports NumPy and the standard
library only: a worker that loads them imports neither ``jax`` nor the
reference package, and :class:`ReferenceGuard` checks just that.
"""
import sys

import numpy as np


class SyntheticModel:
    """Deterministic, batch-invariant pseudo-probabilities in [0, 1] (the
    reference's ``tests/test_transport.py`` model). A module-level class,
    not a closure, because the sim — models included — is pickled into
    spawned worker processes."""

    def __init__(self, salt: float):
        self.salt = salt

    def __call__(self, X):
        z = np.sin(X.astype(np.float64).sum(axis=1) * 12.9898 + self.salt)
        return (z + 1.0) / 2.0


def synthetic_models():
    return {"read": SyntheticModel(0.0), "write": SyntheticModel(1.7)}


class Flip:
    """Workload schedule: ``before`` until ``at`` seconds, then ``after``
    (a phase change that makes a CARAT controller re-probe and take one
    bootstrap pick)."""

    def __init__(self, before, after, at: float):
        self.before, self.after, self.at = before, after, at
        self.boundaries = (at,)

    def spec_at(self, t: float):
        return self.before if t < self.at else self.after


class ReferenceGuard:
    """A workload-phase policy that changes nothing and, at every shard
    step, notes which of ``jax`` and ``repro`` the stepping process has
    imported. Its shard state travels back in the workers' reports, so
    after a ``ProcessRuntime.run`` the parent's copy holds what every
    worker saw: ``steps`` > 0 and ``leaked`` empty for a clean port."""

    name = "reference_guard"
    phase = "workload"
    gather = "none"

    def __init__(self):
        self.steps = 0
        self.leaked = set()

    def step_shard(self, clients, t, dt):
        self.steps += 1
        self.leaked |= {m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro")}

    def shard_state(self, client_ids):
        return {"steps": self.steps, "leaked": sorted(self.leaked)}

    def merge_shard_state(self, state):
        self.steps += state["steps"]
        self.leaked |= set(state["leaked"])


class LaunchCounter:
    """A workload-phase policy that changes nothing and adds one to the
    ``gbdt_logits`` launch counter of the process that steps it, as a
    launch of that kernel would. On the CPU no wrapper counts, so this
    stands in for the kernel to show that each worker's counters come
    back to the parent in its report."""

    name = "launch_counter"
    phase = "workload"
    gather = "none"

    def step_shard(self, clients, t, dt):
        from repro_torch.kernels.gbdt_infer import kernel
        kernel.launches["gbdt_logits"] += 1

    def shard_state(self, client_ids):
        return None

    def merge_shard_state(self, state):
        pass
