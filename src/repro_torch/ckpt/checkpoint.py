"""Sharded, manifest-verified checkpointing through the PFS write path
(the twin of ``repro/ckpt/checkpoint.py``).

Real serialization (flattened tree -> per-shard .npz + JSON manifest with
content hashes) so restart actually restores bit-identical state, plus a
*storage cost model*: checkpoint bytes are pushed through a simulated PFS
write client (CARAT-tunable), which is how checkpoint stalls enter the
training-throughput accounting at scale.

The on-disk format is the reference's: leaves in JAX's flatten order
(sorted dict keys, list indices), named by their paths
(``params/layers/0/attn/wq``, ``opt/count``, ``step``; ``__`` for ``/``
inside the ``.npz``), dealt round-robin over the shards. A checkpoint the
reference writes from a ``scan_layers=False`` model restores into the
port's state unchanged, and the other way round.

``save`` copies the state to host memory synchronously (the consistent
cut: the trainer updates its tensors in place right after) and async
mode hands serialization to a background thread — the paper-faithful
overlap trick (compute the next step while the previous state drains).
``restore`` writes into the template's tensors in place, on their
devices, so a model whose parameters the state holds is restored too.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config.types import CheckpointConfig
from repro_torch.utils.logging import get_logger
from repro_torch.utils.tree import tree_flatten_with_paths, tree_map

log = get_logger("ckpt")


def _to_host(leaf) -> np.ndarray:
    """A host copy of one leaf (never a view of a tensor that the trainer
    will update in place)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise NotImplementedError(
                "bfloat16 leaves need NumPy's bfloat16 type, which the "
                "port does not carry; checkpoint float32 state")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig, directory: Optional[str] = None,
                 n_shards: int = 4, pfs_client=None):
        self.cfg = cfg
        self.dir = directory or cfg.directory
        self.n_shards = n_shards
        self.pfs_client = pfs_client      # optional IOClient for cost model
        os.makedirs(self.dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self.saved_steps: List[int] = []

    # ------------------------------------------------------------------ save
    def save(self, state, step: int, blocking: Optional[bool] = None) -> None:
        blocking = (not self.cfg.async_write) if blocking is None else blocking
        # snapshot to host memory synchronously (consistent cut)
        host_state = tree_map(_to_host, state)
        if blocking:
            self._write(host_state, step)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(host_state, step), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, host_state, step: int) -> None:
        path = os.path.join(self.dir, f"step_{step:08d}")
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        leaves = tree_flatten_with_paths(host_state)
        shards: List[Dict[str, np.ndarray]] = [dict() for _ in
                                               range(self.n_shards)]
        for i, (key, leaf) in enumerate(leaves):
            shards[i % self.n_shards][key] = leaf
        manifest = {"step": step, "n_shards": self.n_shards, "entries": {}}
        total_bytes = 0
        for s, shard in enumerate(shards):
            fn = os.path.join(tmp, f"shard_{s}.npz")
            np.savez(fn, **{k.replace("/", "__"): v
                            for k, v in shard.items()})
            with open(fn, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            manifest["entries"][f"shard_{s}.npz"] = {
                "sha256": digest,
                "keys": sorted(shard.keys()),
            }
            total_bytes += os.path.getsize(fn)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        self.saved_steps.append(step)
        self._gc()
        log.info("checkpoint step=%d (%.1f MB, %d shards)",
                 step, total_bytes / 1e6, self.n_shards)

    def _gc(self) -> None:
        while len(self.saved_steps) > self.cfg.keep:
            old = self.saved_steps.pop(0)
            p = os.path.join(self.dir, f"step_{old:08d}")
            if os.path.exists(p):
                shutil.rmtree(p)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return max(steps) if steps else None

    def restore(self, template, step: Optional[int] = None) -> Tuple[object,
                                                                   int]:
        """Restore into the tensors of ``template`` (shapes must match),
        in place; returns ``(template, step)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        loaded: Dict[str, np.ndarray] = {}
        for shard_name, meta in manifest["entries"].items():
            fn = os.path.join(path, shard_name)
            if self.cfg.verify_manifest:
                with open(fn, "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()
                if digest != meta["sha256"]:
                    raise IOError(f"checkpoint corruption in {fn}")
            with np.load(fn) as z:
                for k in z.files:
                    loaded[k.replace("__", "/")] = z[k]
        flat = tree_flatten_with_paths(template)
        for key, leaf in flat:
            if key not in loaded:
                raise KeyError(f"checkpoint missing {key}")
            if not isinstance(leaf, torch.Tensor):
                raise TypeError(f"{key}: the template's leaves must be "
                                f"tensors, got {type(leaf).__name__}")
            arr = loaded[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"{key}: checkpoint shape {arr.shape} != {leaf.shape}")
        with torch.no_grad():
            for key, leaf in flat:
                leaf.copy_(torch.from_numpy(loaded[key]))
        return template, step

    # ------------------------------------------------------ storage cost model
    def simulate_write_cost(self, n_bytes: float, sim, host_ids) -> float:
        """Push checkpoint bytes through the PFS model; returns seconds of
        storage time consumed (used by the fault-tolerance accounting)."""
        before = [sim.clients[h].stats.write.app_bytes for h in host_ids]
        t0 = sim.t
        per_host = n_bytes / max(len(host_ids), 1)
        while True:
            sim.step()
            done = all(sim.clients[h].stats.write.app_bytes - b >= per_host
                       for h, b in zip(host_ids, before))
            if done or sim.t - t0 > 120.0:
                break
        return sim.t - t0
