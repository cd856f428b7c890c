#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port: its main paths on one GPU.

Builds every CUDA kernel of ``src/repro_torch`` (one ``nvcc`` per
source, all at once; the flash-attention library must hold tensor-core
instructions) and holds each against its plain torch version on the
card, at the shapes the paths give it. Then it drives the port's two
paths:

* CARAT's online co-tuning loop: the 100k-client ``soa-torch`` fleet
  against the host ``soa`` core, then ``CaratPolicy`` over a fleet of
  4096 clients, every probe batch through the GBDT kernels and
  bit-identical to the plain version;
* the LM serving path at granite-3-2b's full width and depth: the
  forward against token-by-token decode in float32 (the attention
  kernels on every layer), then a bfloat16 prefill of 4 x 2048 tokens
  and ``ServeEngine.generate`` on 8 ragged requests.

Each phase prints one JSON line and any failed check ends the run with a
non-zero exit; the line before the last lists every kernel with its
launches and times, and the last line is ``{"ok": true, "device": {...}}``.

Usage (one CUDA device; imports nothing of JAX or of ``repro``)::

    python3 chip_smoke.py

Without a CUDA device, or without the port beside it, it exits 1 and
prints no result.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth,
# float32 rate outside the tensor cores, dense bfloat16 tensor-core rate
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
H100_BF16_OPS_PER_S = 989e12

# every CUDA kernel of the port: its source and the Pallas kernel it
# replaces (file:line of the kernel function)
_GBDT_CU = "src/repro_torch/kernels/gbdt_infer/csrc/gbdt_infer.cu"
_GBDT_PALLAS = "src/repro/kernels/gbdt_infer/kernel.py:35"
KERNELS = {
    "gbdt_logits": (_GBDT_CU, _GBDT_PALLAS),
    "gbdt_grid_logits": (_GBDT_CU, _GBDT_PALLAS),
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:36"),
    "decode_attention": (
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:31"),
}
# tolerances of the reference's own tests: kernels against their oracles
# (tests/test_kernels.py:32,96), decode against forward
# (tests/test_models.py:99)
ATOL = {"bfloat16": 2e-2, "float32": 2e-5}
DECODE_ATOL = 5e-4
# bfloat16 outputs are also held to 2e-2 of each output row's largest
# |value| in the plain version: a row that averages thousands of keys has
# values about as small as the absolute 2e-2, which alone would pass a
# wrong row; a right one differs by about one bfloat16 ulp (2**-8)
BF16_ROW_RTOL = 2e-2

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


def graph_ms(fn: Callable[[], object], dev, reps: int) -> float:
    """Mean device milliseconds of ``fn`` per call: ``reps`` calls
    captured in one CUDA graph (after a warm-up call on a side stream),
    the graph replayed and timed with CUDA events, so the host's work
    between launches is left out; the host clock elsewhere."""
    import torch
    if dev.type != "cuda":
        return time_ms(fn, dev, reps)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    sync(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def bound(bytes_moved: float, ops: float,
          ops_per_s: float = H100_F32_OPS_PER_S) -> Dict:
    """Least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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


def _libraries() -> Dict:
    from repro_torch.kernels.decode_attention import kernel as dec
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.gbdt_infer import kernel as gbdt
    return {"gbdt_infer": gbdt.LIBRARY, "flash_attention": fa.LIBRARY,
            "decode_attention": dec.LIBRARY}


def _ptxas_summary(report: str) -> Dict:
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", report)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores",
                                         report)]
    return {"entries": len(regs), "max_registers": max(regs, default=None),
            "spill_store_bytes": sum(spills)}


# tensor-core instructions in SASS: warpgroup (wgmma) and warp (mma.sync)
TENSOR_CORE_OPS = ("HGMMA", "HMMA")


def tensor_core_counts(sass: str) -> Dict[str, int]:
    """How many tensor-core instructions a ``cuobjdump -sass`` listing
    holds, by opcode."""
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in TENSOR_CORE_OPS}


def sass_tensor_core_counts(library: Path) -> Optional[Dict[str, int]]:
    """``tensor_core_counts`` of a built library's SASS, or None where
    the toolkit has no ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return tensor_core_counts(sass)


def phase_build() -> Dict:
    """Every kernel library, one ``nvcc`` each, all started together; the
    tensor-core instructions of each one's SASS. The flash-attention
    library must hold some (its bfloat16 kernel runs on wgmma)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(lib):
        t0 = time.perf_counter()
        path, report = lib.build()
        return {"seconds": time.perf_counter() - t0, "library": path.name,
                **_ptxas_summary(report),
                "tensor_core_instructions": sass_tensor_core_counts(path)}

    t0 = time.perf_counter()
    libs = _libraries()
    with ThreadPoolExecutor(len(libs)) as ex:
        done = dict(zip(libs, ex.map(one, libs.values())))
    tc = done["flash_attention"]["tensor_core_instructions"]
    gate(tc is not None and sum(tc.values()) > 0,
         f"the flash-attention library holds no tensor-core instruction "
         f"({tc})")
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "libraries": done}


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


def _device_busy_ms(fn: Callable[[], object], dev, top: int = 0):
    """Device time of every kernel, copy and memset of a profiled call of
    ``fn`` (the device-side events of the profiler's CUPTI trace; the
    CPU ops that launched them carry the same time again and are left
    out), or None where it records none; the call's wall seconds; and,
    with ``top``, the ``top`` device-side entries with the most time
    (name, device ms, count)."""
    t0 = time.perf_counter()
    with _profiler() as prof:
        fn()
        sync(dev)
    wall = time.perf_counter() - t0
    busy_ms, heaviest = _device_time(prof, top)
    return busy_ms, wall, heaviest


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _device_time(prof, top: int = 0):
    """The device-side events of a stopped profiler: their summed ms (or
    None where it recorded none) and the ``top`` entries with the most
    time (name, device ms, count)."""
    from torch.autograd import DeviceType
    on_device = [e for e in prof.key_averages()
                 if e.device_type != DeviceType.CPU]
    busy_us = sum(e.self_device_time_total for e in on_device)
    ranked = sorted(on_device, key=lambda e: -e.self_device_time_total)
    heaviest = [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                for e in ranked[:top]]
    return (busy_us / 1e3 if busy_us > 0 else None), heaviest


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
        busy_ms, traced_wall, _ = _device_busy_ms(
            lambda: traced.run(intervals * sim.interval_s), dev)
        if busy_ms is not None:
            out["device_busy_ms_per_interval"] = busy_ms / intervals
            out["device_busy_share_traced"] = busy_ms / 1e3 / traced_wall
    return out


# ------------------------------------------------------------ LM serving path
def _generator(dev, seed: int):
    import torch
    return torch.Generator(device=dev).manual_seed(seed)


def _randn(g, dev, dtype, *shapes):
    import torch
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in shapes]


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max().item())


def _check_close(what: str, got, want) -> Dict:
    """``got`` against the plain version's ``want``: gated at ATOL of
    their type and, in bfloat16, at BF16_ROW_RTOL of each output row's
    largest |value| (rows along the last dim)."""
    name = str(want.dtype).split(".")[-1]
    diff = (got.float() - want.float()).abs()
    err = float(diff.max().item())
    gate(err <= ATOL[name],
         f"{what} {name}: max_abs_err {err} > {ATOL[name]}")
    out = {"max_abs_err": err, "atol": ATOL[name]}
    if name == "bfloat16":
        scale = want.float().abs().amax(dim=-1).clamp_min(1e-30)
        rel = float((diff.amax(dim=-1) / scale).max().item())
        gate(rel <= BF16_ROW_RTOL, f"{what} {name}: an output row is off "
             f"by {rel} of its scale > {BF16_ROW_RTOL}")
        out.update(max_row_rel_err=rel, row_rtol=BF16_ROW_RTOL)
    return out


def _attn_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks keep in one (batch, head)."""
    i = np.arange(sq)
    hi = np.minimum(sk, i + 1) if causal else np.full(sq, sk)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(sq, int)
    return int(np.maximum(hi - lo, 0).sum())


def _library_ms(dev, reps: int, q, k, v, timer=time_ms, **kw):
    """One PyTorch call computing the same attention, timed only (by
    ``timer``): ``scaled_dot_product_attention`` with GQA (K/V repeated
    first where this torch lacks ``enable_gqa``)."""
    import torch.nn.functional as F
    try:
        F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
        fn, note = (lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True, **kw)), "enable_gqa"
    except TypeError:
        g = q.shape[1] // k.shape[1]
        kx, vx = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        fn, note = (lambda: F.scaled_dot_product_attention(
            q, kx, vx, **kw)), "K/V repeated first"
    return timer(fn, dev, reps), note


def phase_flash_attention(dev, b: int, s: int, hq: int, hkv: int, d: int,
                          window: int, ragged_s: int, seed: int,
                          reps: int) -> Dict:
    """``flash_attention`` against its plain version: granite's prefill
    shape in bfloat16 (causal; timed, with its bound, the plain version's
    and SDPA's time), a float32 case with a ragged tail, and a bfloat16
    sliding window (timed likewise, SDPA with a boolean window mask).
    Each case reports the launches of each of the two kernels; on the
    card the bfloat16 cases must take the tensor-core kernel and the
    float32 one the SIMT kernel."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                          flash_attention_ref)
    g = _generator(dev, seed)

    def case(dtype, sq, win):
        q, k, v = _randn(g, dev, dtype, (b, hq, sq, d), (b, hkv, sq, d),
                         (b, hkv, sq, d))
        before = dict(fa.launches)
        got = flash_attention(q, k, v, causal=True, window=win)
        sync(dev)
        tc = fa.launches["flash_attention_tc"] - before["flash_attention_tc"]
        launches = {"tensor_core": tc,
                    "simt": fa.launches["flash_attention"]
                    - before["flash_attention"] - tc}
        if dev.type == "cuda":
            want = ({"tensor_core": 1, "simt": 0}
                    if dtype == torch.bfloat16 else
                    {"tensor_core": 0, "simt": 1})
            gate(launches == want, f"flash_attention {dtype} S={sq} "
                                   f"took {launches}, not {want}")
        return (q, k, v), {**_check_close(
            f"flash_attention S={sq} window={win}", got,
            flash_attention_ref(q, k, v, causal=True, window=win)),
            "launches": launches}

    (q, k, v), close = case(torch.bfloat16, s, 0)
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True), dev, reps)
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, causal=True),
                       dev, max(reps // 10, 1))
    library_ms, library_note = _library_ms(dev, reps, q, k, v,
                                           is_causal=True)
    pairs = b * hq * _attn_pairs(s, s, True, 0)
    b_main = bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                   4 * d * pairs, H100_BF16_OPS_PER_S)
    _, close_ragged = case(torch.float32, ragged_s, 0)
    (qw, kw, vw), close_window = case(torch.bfloat16, s, window)
    window_ms = time_ms(lambda: flash_attention(qw, kw, vw, window=window),
                        dev, reps)
    window_plain_ms = time_ms(
        lambda: flash_attention_ref(qw, kw, vw, window=window), dev,
        max(reps // 10, 1))
    mask = attention_mask(s, s, causal=True, window=window, device=dev)
    window_library_ms, _ = _library_ms(dev, reps, qw, kw, vw,
                                       attn_mask=mask)
    b_window = bound(2 * (2 * qw.numel() + kw.numel() + vw.numel()),
                     4 * d * b * hq * _attn_pairs(s, s, True, window),
                     H100_BF16_OPS_PER_S)
    return {"phase": "flash_attention", "shape": [b, hq, hkv, s, d],
            "dtype": "bfloat16", "causal": True, **close,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": f"scaled_dot_product_attention ({library_note})",
            **b_main,
            "ragged_float32": {"s": ragged_s, **close_ragged},
            "window_bfloat16": {"window": window, **close_window,
                                "ms": window_ms,
                                "plain_ms": window_plain_ms,
                                "library_ms": window_library_ms,
                                "library": "scaled_dot_product_attention "
                                           "with a boolean window mask",
                                "bound_ms": b_window["bound_ms"],
                                "bound_by": b_window["bound_by"]}}


def phase_decode_attention(dev, b: int, hq: int, hkv: int, d: int,
                           path_s: int, path_len: int, s: int, step: int,
                           seed: int, reps: int) -> Dict:
    """``decode_attention`` against its plain version, bfloat16 and
    float32, at granite's decode heads in two cases, each timed in
    bfloat16 with its bound, the plain version's and SDPA's (with a
    length mask) time and its cache splits: the path's shape, a
    ``path_s``-position cache with every length ``path_len`` (the
    top-level numbers), and a long cache of ``s`` positions with ragged
    lengths ``s - step * i``."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as dec
    from repro_torch.kernels.decode_attention.kernel import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    g = _generator(dev, seed)
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 132)

    def case(cache: int, lengths: List[int]) -> Dict:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        close = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _randn(g, dev, dtype, (b, hq, d), (b, hkv, cache, d),
                             (b, hkv, cache, d))
            close[str(dtype).split(".")[-1]] = _check_close(
                f"decode_attention S={cache}",
                decode_attention(q, k, v, lens),
                decode_attention_ref(q, k, v, lens))
        # a few microseconds of device time: the kernel and SDPA are timed
        # by graph replay (the wrappers' host work per call, which an
        # event-timed loop would measure instead, is call_ms)
        ms = graph_ms(lambda: decode_attention(q, k, v, lens), dev, reps)
        call_ms = time_ms(lambda: decode_attention(q, k, v, lens), dev, reps)
        plain_ms = time_ms(lambda: decode_attention_ref(q, k, v, lens), dev,
                           max(reps // 10, 1))
        mask = (torch.arange(cache, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        library_ms, library_note = _library_ms(dev, reps, q[:, :, None], k,
                                               v, timer=graph_ms,
                                               attn_mask=mask)
        valid = sum(lengths)
        b_dec = bound(2 * hkv * d * valid * 2 + 2 * 2 * q.numel() + 4 * b,
                      4 * d * hq * valid, H100_BF16_OPS_PER_S)
        return {"cache": cache, "lengths": lengths, "dtype": "bfloat16",
                **close["bfloat16"], "float32": close["float32"],
                "splits": dec.decode_splits(b, hkv, hq // hkv, cache, sms),
                "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                "library_ms": library_ms,
                "library": f"scaled_dot_product_attention with a length "
                           f"mask ({library_note})", **b_dec}

    path = case(path_s, [path_len] * b)
    long = case(s, [s - step * i for i in range(b)])
    return {"phase": "decode_attention", "shape": [b, hq, hkv, path_s, d],
            **path, "long_cache": long}


def _attn_kernels():
    from repro_torch.kernels.decode_attention import kernel as dec
    from repro_torch.kernels.flash_attention import kernel as fa
    return fa, dec


def _reset_attn_launches() -> None:
    for k in _attn_kernels():
        k.reset_launches()


def _attn_launches() -> Dict[str, int]:
    fa, dec = _attn_kernels()
    return {**fa.launches, **dec.launches}


def phase_lm_consistency(dev, cfg, batch: int, n_tokens: int,
                         cache_len: int, seed: int) -> Dict:
    """``cfg`` with float32 weights from a seeded generator (TF32 off):
    the forward's logits at every position against token-by-token
    ``decode_step``, at the reference's ``atol=5e-4``."""
    import torch
    from repro_torch.models.lm import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gate(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.float32)
    model.init(_generator(dev, seed))
    sync(dev)
    init_s = time.perf_counter() - t0
    tokens = torch.from_numpy(rng(seed).integers(
        0, cfg.vocab_size, size=(batch, n_tokens))).to(dev)
    _reset_attn_launches()
    worst = 0.0
    with torch.inference_mode():
        fwd, _ = model.forward({"tokens": tokens})
        cache = model.init_cache(batch, cache_len, dtype=torch.float32)
        for t in range(n_tokens):
            logits, cache = model.decode_step(
                tokens[:, t], cache,
                torch.full((batch,), t, dtype=torch.int32, device=dev))
            worst = max(worst, _max_err(logits, fwd[:, t]))
        finite = bool(torch.isfinite(fwd).all().item())
        scale = float(fwd.abs().max().item())
    sync(dev)
    launches = _attn_launches()
    gate(finite, "forward logits are not finite")
    gate(worst <= DECODE_ATOL, f"decode differs from forward by {worst}")
    if dev.type == "cuda":
        # float32: the SIMT kernel of flash_attention
        gate(launches == {"flash_attention": cfg.n_layers,
                          "flash_attention_tc": 0,
                          "decode_attention": cfg.n_layers * n_tokens},
             f"attention launches {launches}")
    return {"phase": "lm_consistency", "arch": cfg.name,
            "params": cfg.param_count(), "dtype": "float32",
            "batch": batch, "tokens": n_tokens, "cache_len": cache_len,
            "init_s": init_s, "max_abs_err": worst, "atol": DECODE_ATOL,
            "max_abs_logit": scale, "launches": launches}


def phase_lm_serve(dev, cfg, prefill_batch: int, prefill_len: int,
                   n_requests: int, prompt0: int, prompt_step: int,
                   max_new: int, cache_len: int, profile_steps: int,
                   seed: int) -> Dict:
    """``cfg`` with bfloat16 weights and cache: (a) ``prefill`` over
    ``prefill_batch`` prompts of ``prefill_len`` tokens; (b)
    ``ServeEngine.generate`` on ``n_requests`` prompts of ``prompt0 +
    prompt_step * i`` tokens, ``max_new`` new tokens each. Launch counts
    are zeroed just before each and read just after. A repeat of (b),
    traced over its last ``profile_steps`` steps, gives the device's busy
    time in those steps; over their untraced time in (b) that is the
    device's idle share."""
    import torch
    from repro_torch.models.lm import build_model
    from repro_torch.serve import Request, ServeEngine
    model = build_model(cfg, device=dev, dtype=torch.bfloat16)
    model.init(_generator(dev, seed))
    r = rng(seed)
    v = cfg.vocab_size
    out: Dict = {"phase": "lm_serve", "arch": cfg.name,
                 "params": cfg.param_count(), "dtype": "bfloat16"}

    # (a) prefill
    batch = {"tokens": torch.from_numpy(
        r.integers(0, v, size=(prefill_batch, prefill_len))).to(dev)}
    with torch.inference_mode():
        model.prefill(batch, prefill_len)           # warm-up
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _reset_attn_launches()
        t0 = time.perf_counter()
        logits = model.prefill(batch, prefill_len)
        sync(dev)
        prefill_s = time.perf_counter() - t0
        launches_a = _attn_launches()
        gate(tuple(logits.shape) == (prefill_batch, v)
             and bool(torch.isfinite(logits).all().item()),
             "prefill logits are not finite (B, V)")
    del logits
    out["prefill"] = {
        "batch": prefill_batch, "tokens": prefill_len, "ms": prefill_s * 1e3,
        "tokens_per_s": prefill_batch * prefill_len / prefill_s,
        "launches": launches_a,
        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None)}

    # (b) generate, every step's logits checked finite on the device; the
    # hooks run before each step with its index
    flags: List = []
    hooks: List[Callable[[int], None]] = []
    step = model.decode_step

    def checked(tokens, cache, pos):
        for hook in hooks:
            hook(len(flags))
        logits, cache = step(tokens, cache, pos)
        flags.append(torch.isfinite(logits).all())
        return logits, cache

    model.decode_step = checked
    prompts = [[int(t) for t in
                r.integers(0, v, size=prompt0 + prompt_step * i)]
               for i in range(n_requests)]
    steps = max(len(p) for p in prompts) + max_new
    gate(0 < profile_steps <= steps, "profile_steps outside 1..steps")
    tail_from = steps - profile_steps
    engine = ServeEngine(model, cache_len=cache_len,
                         cache_dtype=torch.bfloat16)

    def generate(at_tail: Callable[[], object] = lambda: None):
        """The requests through ``engine.generate``. Before the last
        ``profile_steps`` steps it syncs and calls ``at_tail``. Returns
        the requests and the seconds of the run and of those steps."""
        reqs = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
        tail_t0: List[float] = []

        def tail(i):
            if i == tail_from:
                sync(dev)
                at_tail()
                tail_t0.append(time.perf_counter())

        flags.clear()
        hooks[:] = [tail]
        t0 = time.perf_counter()
        engine.generate(reqs)
        sync(dev)
        t1 = time.perf_counter()
        return reqs, t1 - t0, t1 - tail_t0[0]

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _reset_attn_launches()
    reqs, gen_s, tail_s = generate()
    launches_b = _attn_launches()
    gate(all(len(q.out_tokens) == max_new
             and all(0 <= t < v for t in q.out_tokens) for q in reqs),
         "a request's tokens are missing or outside the vocab")
    gate(len(flags) == steps and bool(torch.stack(flags).all().item()),
         "a decode step's logits are not finite")
    if dev.type == "cuda":
        # bfloat16: every prefill launch on the tensor-core kernel
        gate(launches_a == {"flash_attention": cfg.n_layers,
                            "flash_attention_tc": cfg.n_layers,
                            "decode_attention": 0},
             f"prefill attention launches {launches_a}")
        gate(launches_b == {"flash_attention": 0, "flash_attention_tc": 0,
                            "decode_attention": cfg.n_layers * steps},
             f"generate attention launches {launches_b}")
    gen = out["generate"] = {
        "requests": n_requests,
        "prompt_lens": [len(q.prompt) for q in reqs],
        "max_new_tokens": max_new, "cache_len": cache_len,
        "decode_steps": steps, "s": gen_s,
        "ms_per_decode_step": gen_s * 1e3 / steps,
        "generated_tokens_per_s": n_requests * max_new / gen_s,
        "tail_steps": profile_steps,
        "tail_ms_per_step": tail_s * 1e3 / profile_steps,
        "launches": launches_b,
        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
        "first_tokens": reqs[0].out_tokens[:8]}

    if dev.type == "cuda":
        # a repeat of the same requests, traced over the same last steps
        prof = _profiler()
        again, _, traced_s = generate(prof.start)
        prof.stop()
        busy_ms, heaviest = _device_time(prof, top=12)
        out["profiled"] = {
            "run": f"a repeat of (b), traced over its last {profile_steps} "
                   f"decode steps",
            "decode_steps": profile_steps,
            "same_tokens": ([q.out_tokens for q in again]
                            == [q.out_tokens for q in reqs]),
            "wall_ms_per_step": traced_s * 1e3 / profile_steps,
            "device_busy_ms_per_step": (None if busy_ms is None
                                        else busy_ms / profile_steps),
            "device_idle_share_traced": (None if busy_ms is None
                                         else 1.0 - busy_ms / 1e3 / traced_s),
            "heaviest_device_ms": heaviest}
        if busy_ms is not None:
            # the traced steps' device time over the untraced time of the
            # same steps in (b) (the profiler slows the host, not the
            # device)
            gen["device_idle_share"] = 1.0 - (
                busy_ms / profile_steps) / gen["tail_ms_per_step"]
    del model.decode_step
    return out


def kernel_line(phases: Dict[str, Dict], launches: Dict[str, int]) -> Dict:
    """One row per kernel: ``phases[name]`` holds its comparison with the
    plain version and its times, ``launches[name]`` its launches on the
    path that drives it."""
    rows = []
    for name, (source, replaces) in KERNELS.items():
        ph = phases[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": ph["max_abs_err"], "ms": ph["ms"],
                     "plain_ms": ph["plain_ms"], "bound_ms": ph["bound_ms"],
                     "bound_by": ph["bound_by"],
                     "library_ms": ph.get("library_ms")})
    return {"kernels": rows}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    try:
        from repro_torch.config import get_arch
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

    # CARAT's fleet-tuning loop
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

    # the LM serving path: granite-3-2b at full width and depth
    granite = get_arch("granite-3-2b")
    hd = granite.resolved_head_dim
    fa = phase_flash_attention(dev, 4, 2048, granite.n_heads,
                               granite.n_kv_heads, hd, window=512,
                               ragged_s=1000, seed=4, reps=10)
    emit(fa)
    # the path's decode shape (ServeEngine's static batch: every row at
    # one length over a 1024-position cache), then a long ragged cache
    dec = phase_decode_attention(dev, 8, granite.n_heads, granite.n_kv_heads,
                                 hd, path_s=1024, path_len=512, s=4096,
                                 step=37, seed=5, reps=200)
    emit(dec)
    emit(phase_lm_consistency(dev, granite, batch=2, n_tokens=16,
                              cache_len=32, seed=6))
    torch.cuda.empty_cache()
    serve = phase_lm_serve(dev, granite, prefill_batch=4, prefill_len=2048,
                           n_requests=8, prompt0=128, prompt_step=48,
                           max_new=64, cache_len=1024, profile_steps=32,
                           seed=7)
    emit(serve)

    emit(kernel_line(
        {"gbdt_logits": logits_small, "gbdt_grid_logits": grid,
         "flash_attention": fa, "decode_attention": dec},
        {**carat["launches"],
         "flash_attention": serve["prefill"]["launches"]["flash_attention"],
         "decode_attention":
             serve["generate"]["launches"]["decode_attention"]}))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
