"""Deterministic, fork-able RNG streams.

The PFS discrete-event simulator, the workload generators, and the CARAT
training-data sweeps all need independent reproducible randomness. A single
``numpy.random.Generator`` threaded everywhere makes experiments
order-dependent; instead every subsystem forks a named child stream so
adding a new consumer never perturbs existing draws.
"""
from __future__ import annotations

import hashlib

import numpy as np


def _mix(seed: int, name: str) -> int:
    h = hashlib.sha256(f"{seed}:{name}".encode()).digest()
    return int.from_bytes(h[:8], "little")


class RngStream:
    """A named, fork-able RNG stream backed by numpy PCG64."""

    def __init__(self, seed: int, name: str = "root"):
        self.seed = int(seed)
        self.name = name
        self.gen = np.random.Generator(np.random.PCG64(_mix(seed, name)))

    def fork(self, name: str) -> "RngStream":
        return RngStream(self.seed, f"{self.name}/{name}")

    # Wire-safe state -----------------------------------------------------
    # A stream's exact position serializes to a plain nested dict of
    # ints/strs (PCG64's documented state), so bus payloads can carry
    # "resume this generator here" instead of a live object reference.
    def state(self) -> dict:
        return {"seed": self.seed, "name": self.name,
                "gen": self.gen.bit_generator.state}

    def set_state(self, state: dict) -> None:
        """Install a serialized position into this stream's generator.
        The stream keeps its own identity (seed/name); only the
        generator position moves — installing a state captured from the
        same stream resumes it bit-exactly."""
        self.gen.bit_generator.state = state["gen"]

    @classmethod
    def from_state(cls, state: dict) -> "RngStream":
        s = cls(state["seed"], state["name"])
        s.gen.bit_generator.state = state["gen"]
        return s

    # Convenience pass-throughs -------------------------------------------------
    def uniform(self, lo=0.0, hi=1.0, size=None):
        return self.gen.uniform(lo, hi, size)

    def integers(self, lo, hi=None, size=None):
        return self.gen.integers(lo, hi, size=size)

    def choice(self, seq, size=None, replace=True, p=None):
        return self.gen.choice(seq, size=size, replace=replace, p=p)

    def normal(self, loc=0.0, scale=1.0, size=None):
        return self.gen.normal(loc, scale, size)

    def exponential(self, scale=1.0, size=None):
        return self.gen.exponential(scale, size)

    def shuffle(self, x):
        self.gen.shuffle(x)
        return x
