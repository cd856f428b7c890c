"""Input pipeline over the PFS model — where CARAT meets the training loop
(the port's copy of ``repro/data/pipeline.py``).

Each host runs an I/O client reading tokenized sample files from the PFS
(small, sample-oriented, shuffled reads — exactly the DL pattern of the
paper's Fig 8). The pipeline advances the storage simulation in lockstep
with training steps: while the accelerator computes step N, the client
prefetches step N+1's bytes; if the storage side can't keep up, the step
blocks on input (``input_wait_s``). CARAT controllers attached per host
tune each client online and directly shrink that wait.

The tokens themselves are synthesized deterministically (hash-based), so
training is reproducible while the *performance* path is the PFS model.

The simulation runs on the ``"scalar"`` backend, the reference's default,
so on the same sequence of compute times the waits, bytes and decisions
equal the reference's. Every controller scores its candidates through
the kernel-backed scorer of ``CaratPolicy`` (``_as_prob_fn``): a GBDT's
stage-1 decisions launch ``gbdt_logits`` on ``device`` (``cuda`` unless
another is named), bit-identical to NumPy's ``predict_proba``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.config.types import (ArchConfig, CaratConfig, DataConfig,
                                      Family, ShapeConfig)
from repro_torch.core.controller import CaratController, NodeCacheArbiter
from repro_torch.core.policies.carat import _as_prob_fn
from repro_torch.core.policies.local import PerClientPolicy
from repro_torch.core.policy import CaratSpaces, default_spaces
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.storage.params import PFSParams
from repro_torch.storage.sim import Simulation
from repro_torch.storage.workloads import WorkloadSpec


class TokenSource:
    """Deterministic synthetic corpus: token ids from a seeded hash."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.seed = seed

    def batch(self, step: int, host: int, batch: int, seq: int) -> np.ndarray:
        key = f"{self.seed}:{step}:{host}".encode()
        root = int.from_bytes(hashlib.sha256(key).digest()[:8], "little")
        rng = np.random.Generator(np.random.PCG64(root))
        return rng.integers(0, self.vocab_size, size=(batch, seq),
                            dtype=np.int64).astype(np.int32)


def make_host_batch(cfg: ArchConfig, shape_seq: int, host_batch: int,
                    source: TokenSource, step: int, host: int = 0) -> Dict:
    """Materialize one host's training batch (smoke/examples scale)."""
    if cfg.family == Family.AUDIO:
        rng = np.random.Generator(np.random.PCG64(step * 977 + host))
        return {
            "frames": rng.normal(size=(host_batch, shape_seq, cfg.d_model))
            .astype(np.float32),
            "labels": source.batch(step, host, host_batch, shape_seq),
        }
    tokens = source.batch(step, host, host_batch, shape_seq)
    labels = np.roll(tokens, -1, axis=1)
    out = {"tokens": tokens, "labels": labels}
    if cfg.family == Family.VLM:
        rng = np.random.Generator(np.random.PCG64(step * 977 + host + 13))
        out["patches"] = rng.normal(
            size=(host_batch, cfg.frontend_tokens, cfg.d_model)
        ).astype(np.float32)
    return out


@dataclass
class PipelineStats:
    steps: int = 0
    input_wait_s: float = 0.0
    bytes_read: float = 0.0
    sim_time_s: float = 0.0

    @property
    def mean_wait_s(self) -> float:
        return self.input_wait_s / max(self.steps, 1)


class PFSDataPipeline:
    """N hosts reading training shards through CARAT-tuned PFS clients."""

    def __init__(
        self,
        cfg: ArchConfig,
        data: DataConfig,
        n_hosts: int = 4,
        carat: Optional[CaratConfig] = None,
        models: Optional[Dict] = None,
        spaces: Optional[CaratSpaces] = None,
        params: Optional[PFSParams] = None,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.data = data
        self.n_hosts = n_hosts
        self.device = resolve_device(device)
        # per-host read pattern: sample-oriented random reads (DLIO-like)
        wl = WorkloadSpec(
            name="train_input",
            op="read",
            access="random",
            req_bytes=max(data.sample_bytes, 4096),
            n_streams=data.prefetch_depth,
            file_bytes=1 << 30,
        )
        self.sim = Simulation([wl] * n_hosts, params=params, seed=seed,
                              backend="scalar")
        self.controllers: List[CaratController] = []
        if carat is not None and carat.enable and models is not None:
            spaces = spaces or default_spaces()
            # one scorer per op direction, shared by every host's tuner
            probs = {op: _as_prob_fn(m, self.device)
                     for op, m in models.items()}
            for h in range(n_hosts):
                arb = NodeCacheArbiter(spaces)
                ctrl = CaratController(h, spaces, probs, carat, arbiter=arb)
                self.controllers.append(ctrl)
            self.sim.attach_policy(PerClientPolicy(
                {c.client_id: c for c in self.controllers}))
        self.stats = PipelineStats()
        self._demand_issued = 0.0      # cumulative per-host demand (bytes)

    def demand_per_step(self, shape: ShapeConfig) -> float:
        """Bytes each host must read per training step."""
        host_batch = max(shape.global_batch // self.n_hosts, 1)
        return float(host_batch * self.data.sample_bytes)

    def _all_fetched(self) -> bool:
        return all(c.stats.read.app_bytes >= self._demand_issued
                   for c in self.sim.clients)

    def step(self, shape: ShapeConfig, compute_time_s: float,
             max_extra_s: float = 30.0) -> float:
        """Advance storage one training step; return input wait (seconds)."""
        self._demand_issued += self.demand_per_step(shape)
        t = 0.0
        interval = self.sim.interval_s
        while not (self._all_fetched() and t >= compute_time_s):
            if t >= compute_time_s + max_extra_s:
                break
            self.sim.step()
            t += interval
        wait = max(0.0, t - compute_time_s)
        self.stats.steps += 1
        self.stats.input_wait_s += wait
        self.stats.bytes_read += self.demand_per_step(shape) * self.n_hosts
        self.stats.sim_time_s += t
        return wait

    def throughput(self) -> float:
        total = sum(c.stats.read.app_bytes for c in self.sim.clients)
        return total / max(self.sim.t, 1e-9)
