#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port: CARAT's main path on one GPU.

Builds the GBDT CUDA kernels from ``src/repro_torch``, holds each one
against its plain torch version on the card, holds the 100k-client
``soa-torch`` fleet against the host ``soa`` core, then drives CARAT's
online co-tuning loop (``CaratPolicy`` over a ``soa-torch`` fleet of 4096
clients) and checks that every probe batch went through the kernels and
is bit-identical to the plain version. Each phase prints one JSON line
and any failed check ends the run with a non-zero exit; the line before
the last lists every kernel with its launches and times, and the last
line is ``{"ok": true, "device": {...}}``.

Usage (one CUDA device; imports nothing of JAX or of ``repro``)::

    python3 chip_smoke.py

Without a CUDA device, or without the port beside it, it exits 1 and
prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
# float32 rate outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12

KERNEL_SOURCE = "src/repro_torch/kernels/gbdt_infer/csrc/gbdt_infer.cu"
# the Pallas kernel both CUDA kernels replace (_gbdt_kernel)
PALLAS_KERNEL = "src/repro/kernels/gbdt_infer/kernel.py:35"

# workload mixes of the reference's benchmarks/bench_soa_device.py
STRIPED_CYCLE = ("f_rd_rn_8k", "f_wr_sq_1m", "f_rd_sq_1m", "f_wr_rn_8k",
                 "dlio_bert", "vpic_io", "dlio_megatron", "s_wr_rn_8k")
WL_CYCLE = ("s_rd_rn_8k", "s_wr_sq_1m", "s_rd_sq_1m", "s_wr_rn_8k")
# the op-direction flip every CARAT client sees mid-run: a phase change
# that makes each controller re-probe and take one bootstrap pick through
# the per-client scorer (gbdt_logits)
OP_FLIP = {"s_rd_rn_8k": "s_wr_rn_8k", "s_wr_rn_8k": "s_rd_rn_8k",
           "s_rd_sq_1m": "s_wr_sq_1m", "s_wr_sq_1m": "s_rd_sq_1m"}


def emit(obj: Dict) -> None:
    print(json.dumps(obj), flush=True)


def gate(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn: Callable[[], object], dev, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls after one warm-up:
    CUDA events on the card, the host clock elsewhere."""
    import torch
    fn()
    sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def bound(bytes_moved: float, ops: float) -> Dict:
    """Least time the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return {"bytes": int(bytes_moved), "ops": int(ops),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(seed))


# --------------------------------------------------------------------- phases
def phase_device(dev) -> Dict:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return {"phase": "device", "name": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def phase_build() -> Dict:
    from repro_torch.kernels.gbdt_infer.kernel import build
    t0 = time.perf_counter()
    lib, report = build()
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "library": lib.name,
            "ptxas": [ln.strip() for ln in report.splitlines()
                      if "registers" in ln or "Compiling entry" in ln]}


def phase_gbdt_logits(dev, model, n_rows: int, seed: int,
                      reps: int) -> Dict:
    """``gbdt_logits`` against its plain version on ``n_rows`` seeded rows."""
    import torch
    from repro_torch.kernels.gbdt_infer.kernel import gbdt_logits
    from repro_torch.kernels.gbdt_infer.ops import pack_gbdt
    from repro_torch.kernels.gbdt_infer.ref import gbdt_logits_ref
    packed = pack_gbdt(model, dev)
    X = rng(seed).normal(size=(n_rows, model.n_features)).astype(np.float32)
    x = torch.from_numpy(X).to(dev)
    args = (x, packed.feat, packed.thr, packed.leaf, packed.base)
    got = gbdt_logits(*args)
    plain = gbdt_logits_ref(*args)
    sync(dev)
    identical = bool(torch.equal(got, plain))
    gate(identical, f"gbdt_logits differs from its plain version "
                    f"({n_rows} rows)")
    rows_agree = int((got.cpu().numpy()
                      == model.decision_function(X)).sum())
    t, d = model.n_trees, model.depth
    b = bound(n_rows * model.n_features * 4 + t * d * 8 + (t << d) * 4
              + n_rows * 4, n_rows * t * (d + 1))
    return {"phase": "gbdt_logits", "rows": n_rows,
            "features": model.n_features, "trees": t, "depth": d,
            "bit_identical": identical,
            "max_abs_err": float((got - plain).abs().max().item()),
            "rows_agree_numpy": rows_agree,
            "ms": time_ms(lambda: gbdt_logits(*args), dev, reps),
            "plain_ms": time_ms(lambda: gbdt_logits_ref(*args), dev,
                                max(reps // 10, 1)),
            **b}


def phase_gbdt_grid_logits(dev, model, n_clients: int, seed: int,
                           reps: int) -> Dict:
    """``gbdt_grid_logits`` against its plain version: ``n_clients`` seeded
    client rows x the 63-candidate RPC grid."""
    import torch
    from repro_torch.configs.carat_defaults import SPACES
    from repro_torch.kernels.gbdt_infer.kernel import gbdt_grid_logits
    from repro_torch.kernels.gbdt_infer.ops import GridGBDTScorer
    from repro_torch.kernels.gbdt_infer.ref import gbdt_grid_logits_ref
    sc = GridGBDTScorer(model, SPACES.theta_features(), device=dev)
    H = rng(seed).normal(size=(n_clients, sc.n_h)).astype(np.float32)
    args = (torch.from_numpy(H).to(dev), sc.cfeat, sc.thr, sc.idx_theta,
            sc.leaf_flat)
    got = gbdt_grid_logits(*args)
    plain = gbdt_grid_logits_ref(*args)
    sync(dev)
    identical = bool(torch.equal(got, plain))
    gate(identical, "gbdt_grid_logits differs from its plain version")
    t, d, c = model.n_trees, model.depth, sc.n_candidates
    b = bound(n_clients * sc.n_h * 4 + t * d * 8 + c * t * 4 + (t << d) * 4
              + n_clients * c * 4, n_clients * t * d + 2 * n_clients * c * t)
    return {"phase": "gbdt_grid_logits", "clients": n_clients,
            "candidates": c, "trees": t, "depth": d,
            "bit_identical": identical,
            "max_abs_err": float((got - plain).abs().max().item()),
            "ms": time_ms(lambda: gbdt_grid_logits(*args), dev, reps),
            "plain_ms": time_ms(lambda: gbdt_grid_logits_ref(*args), dev,
                                max(reps // 10, 1)),
            **b}


def fleet_max_rel(host, fleet, rtol: float) -> float:
    """Hold the device fleet to host ``soa`` on the fields of the
    reference's ``tests/test_soa_device.py::_assert_close``; returns the
    largest relative difference seen."""
    host.core.ensure_host()
    fleet.core.ensure_host()
    pairs = []
    for op in ("read", "write"):
        for f in ("app_bytes", "rpc_count", "rpc_bytes", "lat_sum_s",
                  "blocked_s", "active_s", "inflight_time"):
            pairs.append((f"{op}.{f}", getattr(getattr(host.core, op), f),
                          getattr(getattr(fleet.core, op), f), 1e-12))
    pairs += [("dirty_bytes", host.core.dirty_bytes, fleet.core.dirty_bytes,
               1e-6),
              ("ost_wait", host.cluster.wait_s, fleet.cluster.wait_s, 1e-15),
              ("ost_served_bytes", host.cluster.served_bytes,
               fleet.cluster.served_bytes, 0.0)]
    worst = 0.0
    for name, want, got, atol in pairs:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=name)
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
        worst = max(worst, float(np.max(rel, initial=0.0)))
    return worst


def phase_fleet(dev, n: int, intervals: int, seed: int) -> Dict:
    """``soa-torch`` on ``dev`` against host ``soa``: ``n`` clients on the
    striped mix, default PFS parameters."""
    import torch
    from repro_torch.storage import Simulation, get_workload
    wls = [get_workload(STRIPED_CYCLE[i % len(STRIPED_CYCLE)])
           for i in range(n)]
    host = Simulation(wls, seed=seed, backend="soa")
    t0 = time.perf_counter()
    for _ in range(intervals):
        host.step()
    host_ms = (time.perf_counter() - t0) * 1e3 / intervals
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    fleet = Simulation(wls, seed=seed, backend="soa-torch", device=dev)
    t0 = time.perf_counter()
    fleet.step()
    sync(dev)
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(intervals - 1):
        fleet.step()
    sync(dev)
    steady_ms = (time.perf_counter() - t0) * 1e3 / max(intervals - 1, 1)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    rtol = 1e-9
    worst = fleet_max_rel(host, fleet, rtol)
    kmax = int(fleet.core._layout[0].shape[1])
    return {"phase": "fleet", "clients": n, "intervals": intervals,
            "n_osts": host.p.n_osts, "kmax": kmax, "rtol": rtol,
            "within_rtol": True, "max_rel": worst,
            "host_soa_ms_per_interval": host_ms,
            "device_first_interval_ms": first_ms,
            "device_ms_per_interval": steady_ms,
            "peak_device_bytes": peak}


class _Flip:
    """Workload schedule: ``before`` until ``at`` seconds, then ``after``."""

    def __init__(self, before, after, at: float):
        self.before, self.after, self.at = before, after, at
        self.boundaries = (at,)

    def spec_at(self, t: float):
        return self.before if t < self.at else self.after


class _Timed:
    """Callable wrapper that adds up the wall time of its calls."""

    def __init__(self, fn):
        self.fn = fn
        self.seconds = 0.0

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            self.seconds += time.perf_counter() - t0


class _Recorder(_Timed):
    """Grid-scorer wrapper that also keeps every probe batch and its
    scores."""

    def __init__(self, scorer):
        super().__init__(scorer)
        self.batches: List[tuple] = []

    def __call__(self, H):
        probs = super().__call__(H)
        self.batches.append((np.array(H, dtype=np.float32), probs))
        return probs


def _carat_sim(dev, models, n: int, seed: int, node_size: int,
               flip_at: float):
    """The CARAT scenario, with timers around the fleet step, the host
    syncs, the policy step and both scorers."""
    from repro_torch.config import CaratConfig
    from repro_torch.configs.carat_defaults import SPACES
    from repro_torch.core.policies.carat import CaratPolicy
    from repro_torch.storage import SchedulePolicy, Simulation, get_workload
    names = [WL_CYCLE[i % len(WL_CYCLE)] for i in range(n)]
    sim = Simulation([get_workload(nm) for nm in names], seed=seed,
                     backend="soa-torch", device=dev,
                     topology=[i // node_size for i in range(n)])
    sim.attach_policy(SchedulePolicy({
        c.client_id: _Flip(get_workload(nm), get_workload(OP_FLIP[nm]),
                           flip_at)
        for c, nm in zip(sim.clients, names)}))
    policy = CaratPolicy(SPACES, models, CaratConfig(), device=dev)
    timers = {}
    for op in list(policy.tuner.grid_models):
        timers[f"grid_scorer_{op}"] = policy.tuner.grid_models[op] = \
            _Recorder(policy.tuner.grid_models[op])
    # the controller shells take these at bind: the bootstrap picks
    for op in list(policy.tuner.models):
        timers[f"bootstrap_scorer_{op}"] = policy.tuner.models[op] = \
            _Timed(policy.tuner.models[op])
    sim.attach_policy(policy)
    fleet = sim.device_fleet
    timers["policy_step"] = policy.step = _Timed(policy.step)
    timers["fleet_step"] = fleet.step = _Timed(fleet.step)
    timers["host_sync"] = fleet.sync_host = _Timed(fleet.sync_host)
    return sim, policy, timers


def _device_busy_ms(sim, dev, seconds: float):
    """Device time of every kernel and copy of a profiled run (the
    profiler's CUPTI trace), or None where it records none."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.run(seconds)
        sync(dev)
    busy_us = sum(getattr(e, "self_device_time_total", 0.0)
                  for e in prof.key_averages())
    return busy_us / 1e3 if busy_us > 0 else None


def phase_carat(dev, n: int, intervals: int, seed: int, node_size: int,
                flip_at: float) -> Dict:
    """The main path: ``CaratPolicy`` with the committed production models
    over a ``soa-torch`` fleet of ``n`` clients in nodes of ``node_size``.
    Launch counters are zeroed just before the run and read just after;
    every scored probe batch is then re-scored by the plain version on a
    CPU copy of the scorer and must be bit-identical. A second, profiled
    run of the same scenario gives the device's busy time."""
    from repro_torch.configs.carat_defaults import SPACES
    from repro_torch.core.ml.gbdt import default_models
    from repro_torch.kernels.gbdt_infer import kernel
    from repro_torch.kernels.gbdt_infer.ops import GridGBDTScorer
    m_read, m_write = default_models()
    models = {"read": m_read, "write": m_write}
    sim, policy, timers = _carat_sim(dev, models, n, seed, node_size,
                                     flip_at)
    kernel.reset_launches()
    t0 = time.perf_counter()
    sim.run(intervals * sim.interval_s)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(kernel.launches)

    theta = SPACES.theta_features()
    batches = 0
    for op in models:
        cpu = GridGBDTScorer(models[op], theta, device="cpu")
        for H, probs in timers[f"grid_scorer_{op}"].batches:
            gate(np.array_equal(cpu(H), probs),
                 f"a {op} probe batch of {len(H)} clients differs from "
                 f"the plain version")
            batches += 1
    gate(batches > 0, "no probe batch was scored")
    if dev.type == "cuda":
        # (on the CPU the wrappers run their plain versions: no launches)
        gate(launches["gbdt_grid_logits"] == batches,
             "a probe batch was scored outside gbdt_grid_logits")
        gate(launches["gbdt_logits"] > 0, "gbdt_logits never ran")
    gate(policy.decision_count > 0, "no CARAT decisions were made")
    kinds: Dict[str, int] = {}
    for ctrl in policy.controllers:
        for d in ctrl.decisions:
            k = d[1] if d[1] in ("reprobe", "bootstrap") else "tuned"
            kinds[k] = kinds.get(k, 0) + 1
    scorer_s = sum(t.seconds for name, t in timers.items()
                   if name.startswith("grid_scorer"))
    out = {"phase": "carat", "clients": n, "node_size": node_size,
           "intervals": intervals, "flip_at_s": flip_at,
           "decision_count": policy.decision_count,
           "actuations": kinds, "probe_batches": batches,
           "batches_bit_identical": True, "launches": launches,
           "ms_per_interval": wall * 1e3 / intervals,
           "scorer_share": scorer_s / wall,
           "breakdown_ms_per_interval": {
               name: t.seconds * 1e3 / intervals
               for name, t in timers.items()},
           "device_busy_ms_per_interval": None,
           "device_busy_share_traced": None}
    if dev.type == "cuda":
        traced, _, _ = _carat_sim(dev, models, n, seed, node_size, flip_at)
        t0 = time.perf_counter()
        busy_ms = _device_busy_ms(traced, dev, intervals * sim.interval_s)
        traced_wall = time.perf_counter() - t0
        if busy_ms is not None:
            out["device_busy_ms_per_interval"] = busy_ms / intervals
            out["device_busy_share_traced"] = busy_ms / 1e3 / traced_wall
    return out


def kernel_line(logits_small: Dict, grid: Dict, launches: Dict) -> Dict:
    def row(name, ph):
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": PALLAS_KERNEL, "launches": launches[name],
                "max_abs_err": ph["max_abs_err"], "ms": ph["ms"],
                "plain_ms": ph["plain_ms"], "bound_ms": ph["bound_ms"],
                "bound_by": ph["bound_by"], "library_ms": None}
    return {"kernels": [row("gbdt_logits", logits_small),
                        row("gbdt_grid_logits", grid)]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    try:
        from repro_torch.core.ml.gbdt import default_models
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    device = phase_device(dev)
    emit(device)
    for line in device["nvidia_smi"]:
        print(line, flush=True)
    emit(phase_build())
    m_read, _ = default_models()
    # the main path's shape (one bootstrap pick: 63 candidate rows), then
    # the cross product of a 4096-client probe batch
    logits_small = phase_gbdt_logits(dev, m_read, 63, seed=1, reps=200)
    emit(logits_small)
    emit(phase_gbdt_logits(dev, m_read, 4096 * 63, seed=2, reps=50))
    grid = phase_gbdt_grid_logits(dev, m_read, 4096, seed=3, reps=50)
    emit(grid)
    emit(phase_fleet(dev, 100_000, 16, seed=0))
    carat = phase_carat(dev, 4096, 20, seed=0, node_size=16, flip_at=5.0)
    emit(carat)
    emit(kernel_line(logits_small, grid, carat["launches"]))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
