"""End-to-end training launcher (the twin of ``repro/launch/train.py``).

Wires together: model zoo + train_step + PFS-backed input pipeline with
CARAT co-tuning + async checkpointing + straggler/failure monitoring, on
one device (``cuda`` unless ``--device`` names another).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --steps 50 --hosts 4 [--no-carat] [--device cpu]

Two differences from the reference. A step's compute time, which the
input pipeline waits against, is the step's time on the device: the
clock is read after the device has finished the step (the reference
reads it when its ``jit`` call returns, which on an accelerator is the
dispatch). And ``main`` returns the whole :class:`TrainRun` (the model,
its state, the pipeline, and each step's loss, compute time and input
wait), where the reference returns the state.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.config import get_arch, reduced_config
from repro_torch.config.types import (CaratConfig, CheckpointConfig,
                                      DataConfig, ParallelConfig, RunConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.core.ml.train import get_default_models
from repro_torch.data.pipeline import (PFSDataPipeline, TokenSource,
                                       make_host_batch)
from repro_torch.device import resolve_device
from repro_torch.models.lm import LanguageModel, build_model
from repro_torch.runtime.fault_tolerance import StragglerDetector
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step
from repro_torch.utils.logging import get_logger

log = get_logger("launch.train")


@dataclass
class TrainRun:
    model: LanguageModel
    state: Dict[str, Any]
    pipeline: PFSDataPipeline
    losses: List[float] = field(default_factory=list)
    compute_s: List[float] = field(default_factory=list)
    waits_s: List[float] = field(default_factory=list)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--no-carat", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--sample-kb", type=int, default=512,
                    help="PFS bytes per sample (drives the I/O pressure)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and the CARAT scorers")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced_config(get_arch(args.arch))
    model = build_model(cfg, device=dev, dtype=torch.float32)
    shape = ShapeConfig("launcher", args.seq, args.batch, "train")
    run = RunConfig(arch=cfg, shape=shape,
                    parallel=ParallelConfig(remat="dots",
                                            opt_state_dtype="float32"),
                    train=TrainConfig(steps=args.steps))

    model.init(torch.Generator(device=dev).manual_seed(run.train.seed))
    state = TrainState.init(model.param_tree(), AdamWConfig())
    step_fn = make_train_step(model, run)

    # ---- input pipeline over the PFS, CARAT-tuned unless disabled ----------
    carat_cfg = CaratConfig(enable=not args.no_carat)
    models = None
    if carat_cfg.enable:
        m_r, m_w = get_default_models()
        models = {"read": m_r, "write": m_w}
    data_cfg = DataConfig(sample_bytes=args.sample_kb * 1024)
    pipe = PFSDataPipeline(cfg, data_cfg, n_hosts=args.hosts,
                           carat=carat_cfg, models=models, device=dev)
    source = TokenSource(cfg.vocab_size, seed=0)
    ckpt = CheckpointManager(CheckpointConfig(directory=args.ckpt_dir),
                             n_shards=args.hosts)
    stragglers = StragglerDetector(args.hosts)

    log.info("training %s for %d steps on %s (carat=%s)", cfg.name,
             args.steps, dev, carat_cfg.enable)
    out = TrainRun(model=model, state=state, pipeline=pipe)
    losses = []
    t_start = time.time()
    total_wait = 0.0
    for step in range(args.steps):
        batch = make_host_batch(cfg, args.seq, args.batch, source, step)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        _sync(dev)                       # the step's end on the device
        compute_s = time.perf_counter() - t0
        wait_s = pipe.step(shape, compute_s)
        total_wait += wait_s
        losses.append(metrics["loss"])
        out.compute_s.append(compute_s)
        out.waits_s.append(wait_s)
        stragglers.observe([compute_s + wait_s] * args.hosts,
                           io_waits=[wait_s] * args.hosts)
        if step % 10 == 0 or step == args.steps - 1:
            log.info("step %4d loss=%.4f gnorm=%.2f input_wait=%.2fs "
                     "pfs=%.0f MB/s", step, float(metrics["loss"]),
                     float(metrics["grad_norm"]), wait_s,
                     pipe.throughput() / 1e6)
        if step and step % args.ckpt_every == 0:
            ckpt.save(state, step)
    ckpt.wait()
    ckpt.save(state, args.steps, blocking=True)

    out.state = state
    out.losses = torch.stack(losses).tolist()
    wall = time.time() - t_start
    log.info("done: %.1fs wall, %.1fs cumulative input wait, final loss %.4f",
             wall, total_wait, out.losses[-1])
    print(f"final_loss={out.losses[-1]:.4f} "
          f"input_wait_s={total_wait:.2f} "
          f"pfs_MBps={pipe.throughput()/1e6:.1f} "
          f"decisions={sum(len(c.decisions) for c in pipe.controllers)}")
    return out


if __name__ == "__main__":
    main()
