#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port: its main paths on one GPU.

Builds every CUDA kernel of ``src/repro_torch`` (one ``nvcc`` per
source, all at once; the flash-attention library must hold tensor-core
instructions) and holds each against its plain torch version on the
card, at the shapes the paths give it. Then it drives the port's
paths:

* CARAT's online co-tuning loop: the 100k-client ``soa-torch`` fleet
  against the host ``soa`` core, then ``CaratPolicy`` over a fleet of
  4096 clients, every probe batch through the GBDT kernels and
  bit-identical to the plain version;
* CARAT's multi-client deployment: a synthesized 4096-client trace
  replayed on the card against host ``soa``; the 100k-client fleet
  under the sync ``ShardedRuntime`` (4 shards through
  ``ShardedDeviceFleet``) against the single-device fleet; and the
  4096-client CARAT loop under the sharded runtime's bus, bit-identical
  to ``Simulation.run`` on host ``soa`` with both GBDT kernels
  launched, then with the fleet on the card; and CARAT's multi-process
  deployment, 1024 clients on the ``scalar`` backend as 4 spawned
  worker processes over pipes (``ProcessRuntime``, telemetry on), the
  parent scoring each probe batch on the card and each worker its
  bootstrap picks, bit-identical to one process, then again with a
  worker killed and restored from its snapshot;
* the LM serving path at granite-3-2b's full width and depth: the
  forward against token-by-token decode in float32 (the attention
  kernels on every layer), then a bfloat16 prefill of 4 x 2048 tokens
  and ``ServeEngine.generate`` on 8 ragged requests (its last 8 steps
  replayed from their saved state under the profiler);
* the LM training path with the CARAT-tuned PFS input pipeline: the
  training launcher (reduced granite-3-2b, CARAT off and on, each
  host's stage-1 decisions scored by ``gbdt_logits`` and equal to a
  CPU-scored pipeline's), a restart from a checkpoint (bit-exact),
  granite-3-2b trained at full width and depth in float32 (AdamW,
  ``remat="dots"``, ``flash_attention`` forward on every layer with the
  plain version's gradient), and three train steps on the card against
  the CPU's at the peak learning rate (losses, grad norms, gradients,
  parameters) for reduced granite and every other family (the MoE
  archs' dispatch states equal); then flash attention with its gradient
  at each family's heads and mamba2-370m, recurrentgemma-2b,
  paligemma-3b and hubert-xlarge trained at full width and depth as
  granite;
* CARAT's models: the production GBDT pair regenerated under the
  paper's §IV-B protocol (byte-equal to the committed assets), Table IV
  (``train_all_models``) with the nets trained on the card, and each net
  past the reference's bar on its radial task;
* the LM serving path of the MoE family: flash attention's tensor-core
  kernel at moonshot-v1-16b-a3b's prefill shape (D 128) and MLA's (D
  192, v zero-padded), decode attention at moonshot's decode shape, the
  family in float32 (moonshot at full width cut to 8 layers, forward
  against decode; deepseek-v3-671b's MLA attention and MoE block at full
  width; both reduced archs on the card against the CPU, dispatch states
  equal), then a bfloat16 prefill of 4 x 2048 tokens and
  ``ServeEngine.generate`` on 8 ragged requests for moonshot at full
  width and depth and for deepseek at full width cut to one layer (its
  MTP block kept), dropped assignments counted and two prefills equal
  bit for bit;
* the SSM, hybrid, VLM and audio families: flash attention at
  recurrentgemma-2b's local attention (MQA 10/1, D 256, window 2048, at
  S 2048 and 4096), paligemma-3b's MQA (8/1, D 256), hubert-xlarge's
  bidirectional MHA (D 80) and in float32 at D 256 (the SIMT kernel),
  decode attention at D 256 with groups of 10 and 8; mamba2-370m,
  recurrentgemma-2b and paligemma-3b in float32 at full width and depth,
  forward against decode, and the four reduced archs on the card
  against the CPU; the three served in bfloat16 with granite's traffic;
  hubert's forward over 4 x 2048 frames;
* the two large dense archs: flash attention at internlm2-20b's (GQA
  48/8) and command-r-plus-104b's (96/8) prefill shapes at D 128, decode
  attention at groups 6 and 12, both in float32 at a depth that fits
  (forward against decode), then internlm2 served at full width and
  depth and command-r-plus at full width cut to the deepest that fits
  (its reason printed), each prefill's model FLOPs over its time.

Each phase prints one JSON line and any failed check ends the run with a
non-zero exit; the line before the last lists every kernel with its
launches (the GBDT kernels': the ``carat`` run's, both sharded CARAT
runs' and the first process run's, its workers' ``gbdt_logits`` calls
included, and the training pipelines'; flash attention's two kernels
as two rows: the tensor-core kernel's in the prefills (granite's, the
MoE family's, the hybrid's, the VLM's and the two large dense archs')
and hubert's encode, the SIMT kernel's in the float32 training steps,
each beside its own timing at granite's shapes; decode attention's in
granite's, moonshot's, the hybrid's, the VLM's and the two large dense
archs' generate) and times, and the last line is
``{"ok": true, "device": {...}}``.

Usage (one CUDA device; imports nothing of JAX or of ``repro``)::

    python3 chip_smoke.py

Without a CUDA device, or without the port beside it, it exits 1 and
prints no result.
"""
from __future__ import annotations

import bisect
import contextlib
import hashlib
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth,
# float32 rate outside the tensor cores, dense bfloat16 tensor-core rate
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
H100_BF16_OPS_PER_S = 989e12
# the H100 SXM's boost clock and SMs (data sheet); an SM's L1/shared
# memory serves one 128-byte wavefront per clock
H100_SM_CLOCK_HZ = 1.98e9
H100_SMS = 132

# every CUDA kernel of the port: its source and the Pallas kernel it
# replaces (file:line of the kernel function). K2's source holds two
# kernels: "flash_attention" is the bfloat16 tensor-core one (the
# serving prefill), "flash_attention_simt" the float32 one (training)
_GBDT_CU = "src/repro_torch/kernels/gbdt_infer/csrc/gbdt_infer.cu"
_GBDT_PALLAS = "src/repro/kernels/gbdt_infer/kernel.py:35"
_FA_CU = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
_FA_PALLAS = "src/repro/kernels/flash_attention/kernel.py:36"
KERNELS = {
    "gbdt_logits": (_GBDT_CU, _GBDT_PALLAS),
    "gbdt_grid_logits": (_GBDT_CU, _GBDT_PALLAS),
    "flash_attention": (_FA_CU, _FA_PALLAS),
    "flash_attention_simt": (_FA_CU, _FA_PALLAS),
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
# decode steps in the traced window of each lm_serve phase
PROFILE_STEPS = 8

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


def ptxas_entries(report: str, name: str) -> Dict[str, Dict]:
    """Registers and spill bytes of each entry function of a ptxas
    ``-v`` report whose mangled name holds ``name``, keyed by that
    mangled name."""
    out = {}
    for chunk in report.split("Compiling entry function '")[1:]:
        entry = chunk.split("'", 1)[0]
        if name not in entry:
            continue
        regs = re.search(r"Used (\d+) registers", chunk)
        stores = re.search(r"(\d+) bytes spill stores", chunk)
        loads = re.search(r"(\d+) bytes spill loads", chunk)
        out[entry] = {
            "registers": int(regs.group(1)) if regs else None,
            "spill_store_bytes": int(stores.group(1)) if stores else None,
            "spill_load_bytes": int(loads.group(1)) if loads else None}
    return out


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
                "tensor_core_instructions": sass_tensor_core_counts(path),
                # each panel count of K2's tensor-core kernel (ILi<NP>E:
                # NP 64-column panels; NP 4 is D 256)
                "flash_attention_tc_kernel": ptxas_entries(
                    report, "flash_attention_tc_kernel")}

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


def _lines_per_warp_load(stride_bytes: int) -> float:
    """128-byte lines one warp-wide 4-byte load touches when its 32 lanes
    read 32 consecutive rows ``stride_bytes`` apart, averaged over the
    word's offset in the row."""
    offsets = range(0, stride_bytes, 4)
    return sum(len({(r * stride_bytes + o) // 128 for r in range(32)})
               for o in offsets) / len(offsets)


def _issue_ms(wavefronts: float) -> float:
    """Time the card's L1/shared memory takes to serve ``wavefronts``."""
    return wavefronts / (H100_SMS * H100_SM_CLOCK_HZ) * 1e3


def gbdt_logits_onchip(rows: int, features: int, trees: int,
                       depth: int) -> Dict:
    """On-chip loads ``gbdt_logits`` needs, counted from shapes in 128-byte
    wavefronts, for the simple design (``*_simple``: a thread per row, so
    a warp of 32 rows per tree: 2D broadcast model loads from shared
    memory, D feature loads over the rows' lines, one leaf gather) and
    this one (a warp of 64 rows per tree: D broadcast 8-byte splits, 2D
    staged feature reads, 2 leaf gathers, all from shared memory); with
    the longest chain of trees a warp walks (simple: a thread, all of
    them) and the adds of a row's fold."""
    from repro_torch.kernels.gbdt_infer.kernel import (logits_geometry,
                                                       pairwise_plan)
    lines = _lines_per_warp_load(features * 4)
    simple = -(-rows // 32) * trees * (2 * depth + depth * lines + 1)
    now = -(-rows // 64) * trees * (3 * depth + 2)
    geo = logits_geometry(rows, features, trees, depth)
    plan = pairwise_plan(trees)
    warps = geo.threads // 32       # warp w walks chains w, w + warps, ..
    counts = plan.chains[:, 1]
    longest = max(int(counts[w::warps].sum()) for w in range(warps))
    lengths = plan.blocks[:, 1]
    folds = int(np.where(lengths < 8, 0, 7 + lengths % 8).sum()
                + len(lengths) - 1)
    return {"wavefronts_simple": simple, "wavefronts": now,
            "issue_ms_simple": _issue_ms(simple), "issue_ms": _issue_ms(now),
            "chain_trees_simple": trees, "chain_trees": longest,
            "folds": folds}


def gbdt_grid_onchip(clients: int, cands: int, trees: int) -> Dict:
    """On-chip loads ``gbdt_grid_logits`` needs, in wavefronts, per warp
    of 32 candidates, client and tree: the simple design's (``*_simple``:
    a block per client, a thread per candidate) strided idx_theta load
    (lanes one (C, T) row apart), the broadcast client half and a leaf
    gather in one line; this design's transposed idx_theta read shared by
    4 clients, a quarter of a 16-byte broadcast of the client halves and
    the gather from shared memory (1/4 + 1/4 + 1)."""
    warps = clients * -(-cands // 32) * trees
    simple = warps * (_lines_per_warp_load(trees * 4) + 2)
    now = warps * 1.5
    return {"wavefronts_simple": simple, "wavefronts": now,
            "issue_ms_simple": _issue_ms(simple),
            "issue_ms": _issue_ms(now)}


def phase_gbdt_logits(dev, model, n_rows: int, seed: int,
                      reps: int) -> Dict:
    """``gbdt_logits`` against its plain version on ``n_rows`` seeded rows.
    A call's device time is below the wrapper's host cost, so the kernel
    is timed by graph replay (``ms``), and an event-timed loop of wrapper
    calls gives that host cost (``call_ms``)."""
    import torch
    from repro_torch.kernels.gbdt_infer.kernel import (gbdt_logits,
                                                       logits_geometry)
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
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else H100_SMS)
    geo = logits_geometry(n_rows, model.n_features, t, d, sms)
    return {"phase": "gbdt_logits", "rows": n_rows,
            "features": model.n_features, "trees": t, "depth": d,
            "blocks": geo.blocks, "threads": geo.threads,
            "stage_model": geo.stage_model,
            "bit_identical": identical,
            "max_abs_err": float((got - plain).abs().max().item()),
            "rows_agree_numpy": rows_agree,
            "ms": graph_ms(lambda: gbdt_logits(*args), dev, reps),
            "call_ms": time_ms(lambda: gbdt_logits(*args), dev, reps),
            "plain_ms": time_ms(lambda: gbdt_logits_ref(*args), dev,
                                max(reps // 10, 1)),
            "onchip": gbdt_logits_onchip(n_rows, model.n_features, t, d),
            **b}


def phase_gbdt_grid_logits(dev, model, n_clients: int, seed: int,
                           reps: int) -> Dict:
    """``gbdt_grid_logits`` against its plain version: ``n_clients`` seeded
    client rows x the 63-candidate RPC grid; timed by graph replay
    (``ms``), with the wrapper's host cost per call (``call_ms``)."""
    import torch
    from repro_torch.configs.carat_defaults import SPACES
    from repro_torch.kernels.gbdt_infer.kernel import (gbdt_grid_logits,
                                                       grid_geometry)
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
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else H100_SMS)
    geo = grid_geometry(n_clients, c, t, d, sms)
    return {"phase": "gbdt_grid_logits", "clients": n_clients,
            "candidates": c, "trees": t, "depth": d,
            "blocks": geo.blocks, "resident": geo.resident,
            "bit_identical": identical,
            "max_abs_err": float((got - plain).abs().max().item()),
            "ms": graph_ms(lambda: gbdt_grid_logits(*args), dev, reps),
            "call_ms": time_ms(lambda: gbdt_grid_logits(*args), dev, reps),
            "plain_ms": time_ms(lambda: gbdt_grid_logits_ref(*args), dev,
                                max(reps // 10, 1)),
            "onchip": gbdt_grid_onchip(n_clients, c, t),
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


def _carat_scenario(dev, models, n: int, seed: int, node_size: int,
                    flip_at: float, backend: str = "soa-torch"):
    """The CARAT scenario: ``n`` clients of ``WL_CYCLE`` in nodes of
    ``node_size``, each flipping its op direction at ``flip_at``, the
    fleet on ``backend`` and ``CaratPolicy`` scoring on ``dev``. Returns
    the simulation and the policy, not yet attached (the policy's shells
    are wired when it is)."""
    from repro_torch.config import CaratConfig
    from repro_torch.configs.carat_defaults import SPACES
    from repro_torch.core.policies.carat import CaratPolicy
    from repro_torch.storage import SchedulePolicy, Simulation, get_workload
    names = [WL_CYCLE[i % len(WL_CYCLE)] for i in range(n)]
    sim = Simulation([get_workload(nm) for nm in names], seed=seed,
                     backend=backend, device=dev,
                     topology=[i // node_size for i in range(n)])
    sim.attach_policy(SchedulePolicy({
        c.client_id: _Flip(get_workload(nm), get_workload(OP_FLIP[nm]),
                           flip_at)
        for c, nm in zip(sim.clients, names)}))
    return sim, CaratPolicy(SPACES, models, CaratConfig(), device=dev)


def _carat_sim(dev, models, n: int, seed: int, node_size: int,
               flip_at: float, backend: str = "soa-torch"):
    """The CARAT scenario, attached, with timers around the policy step,
    both scorers and, on ``soa-torch``, the fleet step and the host
    syncs."""
    sim, policy = _carat_scenario(dev, models, n, seed, node_size, flip_at,
                                  backend)
    timers = {}
    for op in list(policy.tuner.grid_models):
        timers[f"grid_scorer_{op}"] = policy.tuner.grid_models[op] = \
            _Recorder(policy.tuner.grid_models[op])
    # the controller shells take these at bind: the bootstrap picks
    for op in list(policy.tuner.models):
        timers[f"bootstrap_scorer_{op}"] = policy.tuner.models[op] = \
            _Timed(policy.tuner.models[op])
    sim.attach_policy(policy)
    timers["policy_step"] = policy.step = _Timed(policy.step)
    fleet = sim.device_fleet
    if fleet is not None:
        timers["fleet_step"] = fleet.step = _Timed(fleet.step)
        timers["host_sync"] = fleet.sync_host = _Timed(fleet.sync_host)
    return sim, policy, timers


def _device_busy_ms(fn: Callable[[], object], dev, top: int = 0,
                    kernels=()):
    """Device time of every kernel, copy and memset of a profiled call of
    ``fn`` (the device-side events of the profiler's CUPTI trace; the
    CPU ops that launched them carry the same time again and are left
    out), or None where it records none; the call's wall seconds; with
    ``top``, the ``top`` device-side entries with the most time (name,
    device ms, count); and for each name in ``kernels`` the device ms
    and launches of the CUDA kernel ``<name>_kernel``."""
    with _traced(dev) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall = time.perf_counter() - t0
    trace = _Trace.of(prof)
    busy_ms, heaviest = trace.device(top)
    by_kernel = {name: trace.kernel_ms(rf"\b{name}_kernel\b")
                 for name in kernels}
    return busy_ms, wall, heaviest, by_kernel


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


# host seconds of quiet before and after the work of a profiled window
# on the card: traces have left out the last launches of windows that
# closed as their work ended (PERF.md §7)
TRACE_PAD_S = (0.01, 0.1)


@contextlib.contextmanager
def _traced(dev):
    """A profiled window (``_profiler``) around the block's work; on the
    card it opens ``TRACE_PAD_S[0]`` s before the work and closes
    ``TRACE_PAD_S[1]`` s after the device has finished it."""
    pad = TRACE_PAD_S if dev.type == "cuda" else (0.0, 0.0)
    with _profiler() as prof:
        time.sleep(pad[0])
        yield prof
        sync(dev)
        time.sleep(pad[1])


# the Chrome trace's categories of device work (kernels, copies,
# memsets), of named ranges on the host and on the device, and of the
# host's launches
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_CAT, DEVICE_RANGE_CAT = "user_annotation", "gpu_user_annotation"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class _Trace:
    """A stopped profiler's Chrome trace (``export_chrome_trace``, which
    the profiler writes from its C++ side), read once: building the
    profiler's Python events (``key_averages``) for a train step or 8
    decode steps of a deep model takes tens of seconds on the host.
    Its complete events (``"ph": "X"``; durations in microseconds)."""

    def __init__(self, events: List[Dict]):
        self.events = [e for e in events if e.get("ph") == "X"]

    @classmethod
    def of(cls, prof) -> "_Trace":
        build = ROOT / "build"
        build.mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="trace_", dir=build) as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                return cls(json.load(f)["traceEvents"])

    def device(self, top: int = 0):
        """The summed ms of the device's kernels, copies and memsets (None
        where there are none; a named range's device-side span covers
        kernels counted already, and is left out) and the ``top`` names
        with the most time (name, ms, count)."""
        by_name: Dict[str, List] = {}
        for e in self.events:
            if e.get("cat") in DEVICE_CATS:
                row = by_name.setdefault(e["name"], [0.0, 0])
                row[0] += e["dur"] / 1e3
                row[1] += 1
        busy = sum(ms for ms, _ in by_name.values())
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        return ((busy if busy > 0 else None),
                [[name[:60], ms, n] for name, (ms, n) in ranked[:top]])

    def kernel_ms(self, pattern: str) -> List:
        """[device ms, launches] of the kernels whose name matches the
        regular expression ``pattern``."""
        hits = [e["dur"] for e in self.events
                if e.get("cat") == "kernel" and re.search(pattern, e["name"])]
        return [sum(hits) / 1e3, len(hits)]

    def range_ms(self, name: str, cuda: bool) -> Dict:
        """A named range: its calls and, on the card, its kernels' device
        ms (``device``: the device work launched from inside the range on
        the host, matched by the launches' correlation ids) and its span
        on the device, the gaps between those kernels included (``span``);
        on the CPU both are its host ms."""
        host = [e for e in self.events
                if e.get("cat") == RANGE_CAT and e["name"] == name]
        if not cuda:
            ms = sum(e["dur"] for e in host) / 1e3
            return {"calls": len(host), "device": ms, "span": ms}
        spans: Dict[tuple, List] = {}
        for r in host:
            spans.setdefault((r["pid"], r["tid"]), []).append(
                (r["ts"], r["ts"] + r["dur"]))
        for s in spans.values():
            s.sort()

        def launched_inside(e) -> bool:
            s = spans.get((e["pid"], e["tid"]), [])
            i = bisect.bisect_right(s, (e["ts"], float("inf"))) - 1
            return i >= 0 and e["ts"] <= s[i][1]

        inside = {e["args"]["correlation"] for e in self.events
                  if e.get("cat") in LAUNCH_CATS
                  and "correlation" in e.get("args", {})
                  and launched_inside(e)}
        return {"calls": len(host),
                "device": sum(e["dur"] for e in self.events
                              if e.get("cat") in DEVICE_CATS
                              and e.get("args", {}).get("correlation")
                              in inside) / 1e3,
                "span": sum(e["dur"] for e in self.events
                            if e.get("cat") == DEVICE_RANGE_CAT
                            and e["name"] == name) / 1e3}


def _check_probe_batches(models, timers) -> int:
    """Re-score every probe batch the recorders kept with the plain
    version on a CPU copy of the scorer; all must be bit-identical."""
    from repro_torch.configs.carat_defaults import SPACES
    from repro_torch.kernels.gbdt_infer.ops import GridGBDTScorer
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
    return batches


def _actuation_kinds(policy) -> Dict[str, int]:
    kinds: Dict[str, int] = {}
    for ctrl in policy.controllers:
        for d in ctrl.decisions:
            k = d[1] if d[1] in ("reprobe", "bootstrap") else "tuned"
            kinds[k] = kinds.get(k, 0) + 1
    return kinds


def _signature(sim, policy, res) -> tuple:
    """What a CARAT run decided and moved: cache limits, decisions, the
    throughput series and the bytes."""
    return ([c.config.dirty_cache_mb for c in sim.clients],
            policy.decisions, res.client_throughput,
            res.app_read_bytes, res.app_write_bytes)


def _digest(signature: tuple) -> str:
    return hashlib.sha256(repr(signature).encode()).hexdigest()[:16]


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, float), np.asarray(want, float)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    return float(np.max(rel, initial=0.0))


def phase_carat(dev, n: int, intervals: int, seed: int, node_size: int,
                flip_at: float) -> Dict:
    """The main path: ``CaratPolicy`` with the committed production models
    over a ``soa-torch`` fleet of ``n`` clients in nodes of ``node_size``.
    Launch counters are zeroed just before the run and read just after;
    every scored probe batch is then re-scored by the plain version on a
    CPU copy of the scorer and must be bit-identical. A second, profiled
    run of the same scenario gives the device's busy time."""
    from repro_torch.core.ml.gbdt import default_models
    from repro_torch.kernels.gbdt_infer import kernel
    m_read, m_write = default_models()
    models = {"read": m_read, "write": m_write}
    sim, policy, timers = _carat_sim(dev, models, n, seed, node_size,
                                     flip_at)
    kernel.reset_launches()
    t0 = time.perf_counter()
    res = sim.run(intervals * sim.interval_s)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(kernel.launches)

    batches = _check_probe_batches(models, timers)
    if dev.type == "cuda":
        # (on the CPU the wrappers run their plain versions: no launches)
        gate(launches["gbdt_grid_logits"] == batches,
             "a probe batch was scored outside gbdt_grid_logits")
        gate(launches["gbdt_logits"] > 0, "gbdt_logits never ran")
    gate(policy.decision_count > 0, "no CARAT decisions were made")
    kinds = _actuation_kinds(policy)
    scorer_s = sum(t.seconds for name, t in timers.items()
                   if name.startswith("grid_scorer"))
    out = {"phase": "carat", "clients": n, "node_size": node_size,
           "intervals": intervals, "flip_at_s": flip_at,
           "decision_count": policy.decision_count,
           "actuations": kinds,
           "signature": _digest(_signature(sim, policy, res)),
           "probe_batches": batches,
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
        busy_ms, traced_wall, heaviest, gbdt = _device_busy_ms(
            lambda: traced.run(intervals * sim.interval_s), dev, top=10,
            kernels=("gbdt_logits", "gbdt_grid_logits"))
        if busy_ms is not None:
            out["device_busy_ms_per_interval"] = busy_ms / intervals
            out["device_busy_share_traced"] = busy_ms / 1e3 / traced_wall
        out["heaviest_device_ms"] = heaviest
        # the GBDT kernels in the traced run: device ms per interval and
        # launches (the wrappers' counts were taken on the untraced run)
        out["gbdt_device_ms_per_interval"] = {
            name: ms / intervals for name, (ms, _) in gbdt.items()}
        out["gbdt_traced_launches"] = {name: count
                                       for name, (_, count) in gbdt.items()}
    return out


def phase_replay(dev, n: int, node_size: int, intervals: int,
                 seed: int) -> Dict:
    """Trace replay on ``dev``: a synthesized ``n``-client trace in nodes
    of ``node_size`` through ``simulation_from_trace`` on ``soa-torch``,
    held against the same trace on the host ``soa`` core (cumulative
    read and write bytes within ``rtol=1e-9``)."""
    from repro_torch.storage import simulation_from_trace, synthesize_trace
    t0 = time.perf_counter()
    trace = synthesize_trace(seed, n_clients=n, duration_s=20.0)
    synth_s = time.perf_counter() - t0
    topology = [i // node_size for i in range(len(trace.records))]
    duration = intervals * 0.5
    ms, res = {}, {}
    counts = {"switches": 0, "statics_uploads": 0}
    for backend in ("soa", "soa-torch"):
        t0 = time.perf_counter()
        sim, schedules = simulation_from_trace(
            trace, backend=backend, device=dev, topology=topology)
        build_s = time.perf_counter() - t0
        if backend == "soa-torch":
            core, fleet = sim.core, sim.device_fleet
            set_workload, refresh = core.set_workload, fleet._refresh_statics

            def counted_set_workload(i, spec):
                counts["switches"] += 1
                set_workload(i, spec)

            def counted_refresh():
                seen = fleet._static_seen
                refresh()
                counts["statics_uploads"] += fleet._static_seen != seen

            core.set_workload = counted_set_workload
            fleet._refresh_statics = counted_refresh
        t0 = time.perf_counter()
        res[backend] = sim.run(duration)
        sync(dev)
        ms[backend] = (time.perf_counter() - t0) * 1e3 / intervals
    rtol = 1e-9
    for op in ("read", "write"):
        np.testing.assert_allclose(
            getattr(res["soa-torch"], f"app_{op}_bytes"),
            getattr(res["soa"], f"app_{op}_bytes"), rtol=rtol,
            err_msg=f"replayed app_{op}_bytes")
    gate(counts["switches"] > 0, "no workload switch fired")
    return {"phase": "replay", "clients": len(trace.records),
            "records": trace.n_records, "schedules": len(schedules),
            "node_size": node_size, "intervals": intervals, "rtol": rtol,
            "within_rtol": True,
            "max_rel_bytes": max(
                _max_rel(getattr(res["soa-torch"], f), getattr(res["soa"], f))
                for f in ("app_read_bytes", "app_write_bytes")),
            "synthesize_s": synth_s, "build_s_device": build_s,
            "host_soa_ms_per_interval": ms["soa"],
            "device_ms_per_interval": ms["soa-torch"],
            "workload_switches": counts["switches"],
            "statics_uploads": counts["statics_uploads"]}


def phase_sharded_fleet(dev, n: int, intervals: int, seed: int,
                        node_size: int, n_shards: int) -> Dict:
    """``ShardedRuntime(mode="sync")`` over a ``soa-torch`` fleet of ``n``
    clients in nodes of ``node_size`` (the ``fleet`` phase's striped mix)
    steps through ``ShardedDeviceFleet`` on ``dev`` and agrees with the
    single-device fleet within ``rtol=1e-9`` (shards sharing the card
    step as one block: ``max_rel`` 0). Each run takes one warm-up
    interval, then ``intervals`` timed ones through its entry point."""
    from repro_torch.core.runtime.sharded import ShardedRuntime
    from repro_torch.storage import Simulation, get_workload
    from repro_torch.storage.device import ShardedDeviceFleet
    wls = [get_workload(STRIPED_CYCLE[i % len(STRIPED_CYCLE)])
           for i in range(n)]
    topology = [i // node_size for i in range(n)]
    single = Simulation(wls, seed=seed, device=dev, topology=topology)
    sharded = Simulation(wls, seed=seed, device=dev, topology=topology)
    t0 = time.perf_counter()
    rt = ShardedRuntime(sharded, mode="sync", n_shards=n_shards)
    build_s = time.perf_counter() - t0
    fleet = rt.device_fleet
    gate(isinstance(fleet, ShardedDeviceFleet),
         "the sharded runtime did not step through ShardedDeviceFleet")
    gate(all(d.type == dev.type for d in fleet.shard_devices)
         and fleet.device.type == dev.type,
         f"shards not on {dev.type}: {fleet.shard_devices}")
    dt = single.interval_s
    ms = {}
    for name, run in (("single_device", single.run), ("sharded", rt.run)):
        run(dt)
        sync(dev)
        t0 = time.perf_counter()
        run(intervals * dt)
        sync(dev)
        ms[name] = (time.perf_counter() - t0) * 1e3 / intervals
    gate(all(st["dirty"].device.type == dev.type for st in fleet._states),
         "a shard's state left the device")
    rtol = 1e-9
    worst = fleet_max_rel(single, sharded, rtol)
    return {"phase": "sharded_fleet", "clients": n, "node_size": node_size,
            "shards": len(rt.shards), "intervals": intervals,
            "shard_devices": [str(d) for d in fleet.shard_devices],
            "primary": str(fleet.device), "blocks": len(fleet.blocks),
            "shard_clients": [len(sh.clients) for sh in rt.shards],
            "rtol": rtol, "within_rtol": True, "max_rel": worst,
            "runtime_build_s": build_s,
            "single_device_ms_per_interval": ms["single_device"],
            "sharded_ms_per_interval": ms["sharded"]}


def phase_sharded_carat(dev, n: int, intervals: int, seed: int,
                        node_size: int, flip_at: float, n_shards: int,
                        carat: Optional[Dict] = None) -> Dict:
    """The ``carat`` scenario under ``ShardedRuntime(mode="sync")``, the
    policy scoring on ``dev``. On the host ``soa`` core the sharded run
    (b) must be bit-identical to ``Simulation.run`` (a): decisions,
    cache limits, throughput series, bytes; and both GBDT kernels must
    launch during (b). Then (c) runs the same scenario with the fleet on
    ``dev`` (``soa-torch``); where its shards share one device they step
    as one block, and (c) must then make the ``carat`` phase's decisions
    bit for bit (its ``signature``). Every probe batch of (b) and (c)
    must equal the plain version; the launch counters are zeroed just
    before each sharded run and read just after."""
    from repro_torch.core.ml.gbdt import default_models
    from repro_torch.core.runtime.sharded import ShardedRuntime
    from repro_torch.kernels.gbdt_infer import kernel
    from repro_torch.storage.device import ShardedDeviceFleet
    m_read, m_write = default_models()
    models = {"read": m_read, "write": m_write}
    duration = intervals * 0.5
    out: Dict = {"phase": "sharded_carat", "clients": n,
                 "node_size": node_size, "shards": n_shards,
                 "intervals": intervals, "flip_at_s": flip_at}

    sim_a, pol_a, _ = _carat_sim(dev, models, n, seed, node_size, flip_at,
                                 backend="soa")
    t0 = time.perf_counter()
    res_a = sim_a.run(duration)
    sync(dev)
    out["soa_single_ms_per_interval"] = \
        (time.perf_counter() - t0) * 1e3 / intervals
    sigs = {"a": _signature(sim_a, pol_a, res_a)}
    for key, backend in (("b", "soa"), ("c", "soa-torch")):
        sim, policy, timers = _carat_sim(dev, models, n, seed, node_size,
                                         flip_at, backend=backend)
        rt = ShardedRuntime(sim, mode="sync", n_shards=n_shards)
        if backend == "soa-torch":
            gate(isinstance(rt.device_fleet, ShardedDeviceFleet),
                 "the soa-torch CARAT run did not step on the device")
            fleet = rt.device_fleet
            timers["fleet_step"] = fleet.step = _Timed(fleet.step)
            timers["host_sync"] = fleet.sync_host = _Timed(fleet.sync_host)
        for hook in ("shard_observe", "bus_decide", "shard_actuate",
                     "bus_resolve"):
            timers[hook] = _Timed(getattr(policy, hook))
            setattr(policy, hook, timers[hook])
        kernel.reset_launches()
        t0 = time.perf_counter()
        res = rt.run(duration)
        sync(dev)
        wall = time.perf_counter() - t0
        launches = dict(kernel.launches)
        batches = _check_probe_batches(models, timers)
        stats = rt.bus.stats()
        gate(stats["max_staleness_seen"] <= rt.max_staleness,
             f"the bus delivered staleness {stats['max_staleness_seen']} "
             f"past its bound {rt.max_staleness}")
        gate(policy.decision_count > 0, "no CARAT decisions were made")
        if dev.type == "cuda":
            gate(launches["gbdt_grid_logits"] == batches,
                 "a sharded probe batch was scored outside "
                 "gbdt_grid_logits")
            gate(launches["gbdt_logits"] > 0,
                 "gbdt_logits never ran on the bus path")
        sigs[key] = _signature(sim, policy, res)
        out[key] = {
            "backend": backend, "decision_count": policy.decision_count,
            "actuations": _actuation_kinds(policy),
            "signature": _digest(sigs[key]), "probe_batches": batches,
            "batches_bit_identical": True, "launches": launches,
            "bus": stats, "ms_per_interval": wall * 1e3 / intervals,
            "breakdown_ms_per_interval": {
                name: t.seconds * 1e3 / intervals
                for name, t in timers.items() if t.seconds > 0.0}}
    names = ("cache limits", "decisions", "throughput series",
             "read bytes", "write bytes")
    for name, a, b in zip(names, sigs["a"], sigs["b"]):
        gate(a == b, f"sharded CARAT on soa: {name} differ from "
                     f"Simulation.run")
    out["soa_sharded_identical"] = True
    blocks = len(fleet.blocks)
    out["c"]["blocks"] = blocks
    if carat is not None and blocks == 1:
        gate(out["c"]["signature"] == carat["signature"],
             "sharded CARAT on one device parted from the carat phase")
        out["c"]["identical_to_carat_phase"] = True
    if carat is not None:
        out["carat_phase"] = {
            "ms_per_interval": carat["ms_per_interval"],
            "decision_count": carat["decision_count"],
            "actuations": carat["actuations"]}
    return out


# the spans of sharded CARAT's interval the process phase reads from its
# collector: the workers' policy halves, plan and commit, the parent's
# decision, resolve and stage-2 round
PROCESS_SPANS = ("policy.observe", "policy.decide", "policy.actuate",
                 "policy.stage2", "plan", "resolve", "commit")


def _span_ms(collector, intervals: int) -> Dict[str, Dict[str, float]]:
    """Each span of ``PROCESS_SPANS`` in ms per interval, per telemetry
    source (``coord`` and the workers ``w0``, ``w1``, ...)."""
    out: Dict[str, Dict[str, float]] = {name: {} for name in PROCESS_SPANS}
    for batch in collector.batches:
        for s in batch.spans:
            if s.name in out:
                row = out[s.name]
                row[batch.source] = row.get(batch.source, 0.0) + s.dur
    return {name: {src: sec * 1e3 / intervals
                   for src, sec in sorted(row.items())}
            for name, row in out.items()}


def _worker_rpcs(collector, intervals: int) -> Dict[str, List[float]]:
    """Per worker: its bus round trips per interval and their ms per
    interval, from the ``bus.rpc_ms`` histogram (0.1 ms buckets) of its
    last metrics snapshot; parked ``wait`` calls are not in it."""
    out = {}
    for src, m in sorted(collector.metrics().items()):
        hist = m.get("hists", {}).get("bus.rpc_ms", {})
        if src.startswith("w"):
            out[src] = [sum(hist.values()) / intervals,
                        sum(k * v for k, v in hist.items()) / intervals]
    return out


def _first_plan_s(collector, t0: float) -> Dict[str, float]:
    """Per worker: when its first ``plan`` span started, in seconds after
    ``t0`` on the parent's clock (the worker's offset applied)."""
    first: Dict[str, float] = {}
    for b in collector.batches:
        for s in b.spans:
            if s.name == "plan" and b.source.startswith("w"):
                at = s.t0 + b.clock_offset_s - t0
                first[b.source] = min(first.get(b.source, at), at)
    return dict(sorted(first.items()))


def _recover_s(collector, kill_at: int) -> float:
    """How much longer the interval of a kill took than the median
    interval, from the gaps between the parent's ``resolve`` spans (one
    per interval): the kill, the respawn, the restore and the replay."""
    t0s = sorted(s.t0 for b in collector.batches if b.source == "coord"
                 for s in b.spans if s.name == "resolve")
    gaps = np.diff(t0s)
    return float(gaps[kill_at - 1] - np.median(np.delete(gaps, kill_at - 1)))


def _worker_counter(collector, name: str) -> float:
    """A counter summed over the workers' last metrics snapshots."""
    return sum(m["counters"].get(name, 0.0)
               for src, m in collector.metrics().items()
               if src.startswith("w"))


def phase_process_carat(dev, n: int, intervals: int, seed: int,
                        node_size: int, flip_at: float, n_shards: int,
                        kill_at: int, flight_dir: str) -> Dict:
    """The ``carat`` scenario on the ``scalar`` backend as a fleet of
    spawned worker processes (``ProcessRuntime``, sync mode, pipes,
    telemetry on), the policy scoring on ``dev`` in every process: (a)
    ``Simulation.run`` in one process, (b) ``n_shards`` workers, (c) the
    same with shard 1 killed at ``kill_at`` and restored from its
    snapshot (every 2 intervals), a flight dump under ``flight_dir``.
    (b) and (c) must equal (a) bit for bit; the parent's
    ``gbdt_grid_logits`` must launch during (b) (its counters are zeroed
    just before and read just after); on the card, the workers'
    ``gbdt_logits`` launches in (b) (their own counters, fresh in each
    spawned process, sent back in their reports) must equal (a)'s
    bootstrap picks, and so must their ``carat.bootstrap`` telemetry
    counters; (c) must spawn exactly one worker more than (b), restored
    from a snapshot, and leave a flight dump of the killed one."""
    from repro_torch.core.ml.gbdt import default_models
    from repro_torch.core.runtime.telemetry import read_dump
    from repro_torch.core.runtime.transport import KillShard, ProcessRuntime
    from repro_torch.kernels.gbdt_infer import kernel
    m_read, m_write = default_models()
    models = {"read": m_read, "write": m_write}
    duration = intervals * 0.5
    out: Dict = {"phase": "process_carat", "clients": n,
                 "node_size": node_size, "shards": n_shards,
                 "intervals": intervals, "flip_at_s": flip_at,
                 "backend": "scalar", "transport": "pipe"}

    def scenario():
        sim, policy = _carat_scenario(dev, models, n, seed, node_size,
                                      flip_at, backend="scalar")
        sim.attach_policy(policy)
        return sim, policy

    sim_a, pol_a = scenario()
    # the size of what each worker unpickles at start-up
    out["sim_pickle_bytes"] = len(pickle.dumps(sim_a))
    t0 = time.perf_counter()
    res_a = sim_a.run(duration)
    sync(dev)
    out["a_ms_per_interval"] = (time.perf_counter() - t0) * 1e3 / intervals
    sig_a = _signature(sim_a, pol_a, res_a)
    boots_a = _actuation_kinds(pol_a).get("bootstrap", 0)
    out["a"] = {"signature": _digest(sig_a),
                "decision_count": pol_a.decision_count,
                "actuations": _actuation_kinds(pol_a)}
    gate(boots_a > 0, "the scenario took no bootstrap pick")

    for key, events in (("b", ()), ("c", (KillShard(kill_at, 1),))):
        sim, policy = scenario()
        prt = ProcessRuntime(sim, mode="sync", transport="pipe",
                             n_shards=n_shards, events=events,
                             snapshot_every=2 if events else 1,
                             telemetry=True,
                             flight_dir=flight_dir if events else None)
        kernel.reset_launches()
        t0 = time.perf_counter()
        res = prt.run(duration)
        sync(dev)
        wall = time.perf_counter() - t0
        launches = dict(kernel.launches)
        sig = _signature(sim, policy, res)
        names = ("cache limits", "decisions", "throughput series",
                 "read bytes", "write bytes")
        for name, a, b in zip(names, sig_a, sig):
            gate(a == b, f"process CARAT ({key}): {name} differ from "
                         f"Simulation.run")
        col = prt.telemetry
        stats = prt.stats()
        # the parent's first resolve waits for every worker's first plan:
        # before it, the workers start (spawn, imports, the sim's unpickle
        # and each CUDA context); after it, the fleet steps
        first = min(s.t0 for b in col.batches if b.source == "coord"
                    for s in b.spans if s.name == "resolve")
        run = {"signature": _digest(sig), "identical_to_a": True,
               "decision_count": policy.decision_count,
               "ms_per_interval": wall * 1e3 / intervals,
               "startup_s": first - t0,
               "steady_ms_per_interval":
                   (t0 + wall - first) * 1e3 / intervals,
               "spawns": len(prt.spawns), "parent_launches": launches,
               "worker_launches": dict(prt.worker_launches),
               "worker_first_plan_s": _first_plan_s(col, t0),
               "worker_rpcs_and_ms_per_interval": _worker_rpcs(
                   col, intervals),
               "worker_bootstrap_picks": _worker_counter(
                   col, "carat.bootstrap"),
               "bus": {k: stats[k] for k in ("published", "consumed",
                                             "dropped_stale",
                                             "max_staleness_seen")},
               "telemetry_sources": col.sources(),
               "telemetry_dropped": col.dropped(),
               "span_ms_per_interval": _span_ms(col, intervals)}
        if events:
            run["recover_s"] = _recover_s(col, kill_at)
            run["restored_from_interval"] = [
                at for _, at in prt.spawns if at is not None]
        out[key] = run
    b, c = out["b"], out["c"]
    if dev.type == "cuda":
        # (on the CPU the wrappers run their plain versions: no launches)
        gate(b["parent_launches"]["gbdt_grid_logits"] > 0,
             "the parent's bus_decide never launched gbdt_grid_logits")
        gate(b["worker_launches"].get("gbdt_logits", 0) == boots_a,
             f"the workers launched gbdt_logits "
             f"{b['worker_launches'].get('gbdt_logits', 0)} times, the "
             f"single process took {boots_a} bootstrap picks")
    gate(b["spawns"] == n_shards, f"(b) spawned {b['spawns']} workers")
    gate(b["worker_bootstrap_picks"] == boots_a,
         f"the workers counted {b['worker_bootstrap_picks']} bootstrap "
         f"picks in their telemetry, the single process took {boots_a}")
    gate(c["spawns"] == n_shards + 1,
         f"(c) spawned {c['spawns']} workers, not one respawn")
    gate(len(c["restored_from_interval"]) == 1,
         "(c)'s respawned worker did not restore from a snapshot")
    dumps = [p for p in os.listdir(flight_dir) if "KillShard" in p]
    gate(len(dumps) == 1, f"(c) left flight dumps {dumps}")
    dump = read_dump(os.path.join(flight_dir, dumps[0]))
    gate(dump["source"] == "w1" and len(dump["spans"]) > 0,
         "the flight dump of the killed worker is empty")
    c["flight_dump"] = {"file": dumps[0], "spans": len(dump["spans"]),
                        "counters": len(dump["counters"])}
    out["bootstrap_picks"] = boots_a
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
    float32, at one decode shape in two cases, each timed in bfloat16
    with its bound, the plain version's and SDPA's (with a length mask)
    time, its splits, the blocks of its split kernel with keys to read,
    the split kernel each call took (``variants``: on the card bfloat16
    takes the tensor-core one, float32 the SIMT one) and, on the card,
    each of the call's two kernels timed alone by graph replay
    (``kernel_ms``; the split then the combine alone give the call's
    output bit for bit): the path's shape, a ``path_s``-position cache
    with every length ``path_len`` (the top-level numbers), and a long
    cache of ``s`` positions with ragged lengths ``s - step * i``."""
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
        before = dict(dec.variants)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _randn(g, dev, dtype, (b, hq, d), (b, hkv, cache, d),
                             (b, hkv, cache, d))
            close[str(dtype).split(".")[-1]] = _check_close(
                f"decode_attention S={cache}",
                decode_attention(q, k, v, lens),
                decode_attention_ref(q, k, v, lens))
        variants = {n: dec.variants[n] - before[n] for n in dec.variants}
        if dev.type == "cuda":
            gate(variants == {"tensor_core": 1, "simt": 1},
                 f"decode_attention S={cache}: bfloat16 and float32 took "
                 f"{variants}, not one call each of the tensor-core and "
                 f"the SIMT kernel")
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
        tc = dec.takes_tensor_cores(q, k, v)
        kernel_ms = {}
        if dev.type == "cuda":
            # each kernel alone, by graph replay: the split over the
            # workspace, the combine over the partials the split left
            _, ws = dec.launch_parts(q, k, v, lens, dec.SPLIT)
            parts_out = dec.launch_parts(q, k, v, lens, dec.COMBINE, ws)[0]
            gate(torch.equal(parts_out, decode_attention(q, k, v, lens)),
                 f"decode_attention S={cache}: the split and the combine "
                 f"launched apart gave another output than the call")
            split = "decode_split_tc" if tc else "decode_split_simt"
            kernel_ms = {
                split: graph_ms(lambda: dec.launch_parts(
                    q, k, v, lens, dec.SPLIT, ws), dev, reps),
                "decode_combine": graph_ms(lambda: dec.launch_parts(
                    q, k, v, lens, dec.COMBINE, ws), dev, reps)}
        splits = dec.decode_splits(b, hkv, hq // hkv, cache, d, sms, tc)
        valid = sum(lengths)
        b_dec = bound(2 * hkv * d * valid * 2 + 2 * 2 * q.numel() + 4 * b,
                      4 * d * hq * valid, H100_BF16_OPS_PER_S)
        return {"cache": cache, "lengths": lengths, "dtype": "bfloat16",
                **close["bfloat16"], "float32": close["float32"],
                "variants": variants, "splits": splits,
                "blocks_with_work": dec.blocks_with_work(
                    lengths, hkv, hq // hkv, splits, tc),
                "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                "kernel_ms": kernel_ms,
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


def _n_attn(model) -> int:
    """The attention blocks of a model: one K2 launch each per forward,
    one K3 launch each per decode step (the SSM and RG-LRU blocks launch
    neither)."""
    return sum(kind in ("attn", "attn_local") for kind in model.kinds)


def _reset_attn_launches() -> None:
    for k in _attn_kernels():
        k.reset_launches()


def _attn_launches() -> Dict[str, int]:
    fa, dec = _attn_kernels()
    return {**fa.launches, **dec.launches}


class _Dispatches:
    """While active, records every MoE layer's dispatch: it wraps
    ``repro_torch.models.moe.dispatch`` (which ``moe_apply`` looks up at
    each call) and keeps each call's assignment and dropped counts as
    device scalars (read once, at the end) and, with ``keep_states``,
    its integer state, its experts (``top_i``) and its router's
    probabilities (``moe.route``, wrapped likewise) on the host."""

    def __init__(self, keep_states: bool = False):
        self.keep_states = keep_states
        self.counts: List = []
        self.states: List = []
        self.experts: List = []
        self.probs: List = []
        self.capacities: List[int] = []

    def __enter__(self) -> "_Dispatches":
        from repro_torch.models import moe
        self._moe, self._dispatch, self._route = moe, moe.dispatch, moe.route

        def recorded(x, top_i, cap, e):
            buf, state = self._dispatch(x, top_i, cap, e)
            self.counts.append((state.keep.numel(), (~state.keep).sum()))
            if cap not in self.capacities:
                self.capacities.append(cap)
            if self.keep_states:
                self.states.append([t.cpu() for t in state])
                self.experts.append(top_i.cpu())
            return buf, state

        def routed(params, cfg, x):
            probs, top_p, top_i = self._route(params, cfg, x)
            self.probs.append(probs.detach().cpu())
            return probs, top_p, top_i

        moe.dispatch = recorded
        if self.keep_states:
            moe.route = routed
        return self

    def __exit__(self, *exc) -> None:
        self._moe.dispatch, self._moe.route = self._dispatch, self._route

    def assignments(self) -> int:
        return sum(n for n, _ in self.counts)

    def dropped(self) -> int:
        return int(sum(int(d.item()) for _, d in self.counts))

    def difference(self, other: "_Dispatches") -> Optional[Dict]:
        """Where ``other``'s dispatches first part from these (both kept
        with ``keep_states``): the call, the group (batch row), the token,
        its experts in each run and its router margin here (its k-th
        largest probability less the next); None where every state is
        equal."""
        import torch
        if len(self.states) != len(other.states):
            return {"calls": [len(self.states), len(other.states)]}
        for c, (x, y) in enumerate(zip(self.states, other.states)):
            if all(torch.equal(a, b) for a, b in zip(x, y)):
                continue
            mine, theirs = self.experts[c], other.experts[c]
            rows = (mine != theirs).any(-1).nonzero()
            if len(rows):
                g, t = (int(i) for i in rows[0])
            else:
                # the same experts, another order or capacity: the first
                # assignment that differs, and its token
                a, b = next((a, b) for a, b in zip(x, y)
                            if not torch.equal(a, b))
                g, j = (int(i) for i in (a != b).nonzero()[0])
                t = int(x[1][g, j])                      # tok_of
            k = mine.shape[-1]
            p = self.probs[c][g, t].sort(descending=True).values
            return {"call": c, "group": g, "token": t,
                    "experts": [mine[g, t].tolist(), theirs[g, t].tolist()],
                    "router_margin": float(p[k - 1] - p[k])}
        return None


def phase_lm_consistency(dev, cfg, batch: int, n_tokens: int,
                         cache_len: int, seed: int,
                         published=None) -> Dict:
    """``cfg`` with float32 weights from a seeded generator (TF32 off):
    the forward's logits at every position against token-by-token
    ``decode_step``, at the reference's ``atol=5e-4`` (a VLM's forward
    with zero patches: its decode embeds text only). Each attention
    block launches K2's SIMT kernel once and K3 once a token; SSM and
    RG-LRU blocks launch neither. For an MoE arch
    the forward must drop no assignment (a dropped one would part it
    from decode, whose one token per row always fits). With
    ``published`` (``cfg`` at another capacity factor), a first forward
    of the same weights under its capacity counts the assignments that
    capacity drops."""
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
    inputs = {"tokens": tokens}
    if cfg.family.value == "vlm":
        inputs["patches"] = torch.zeros((batch, 0, cfg.d_model), device=dev)
    n_attn = _n_attn(model)
    out: Dict = {}
    if published is not None:
        # the blocks read their config at each call: the same weights
        # under the published capacity, then back
        with torch.inference_mode(), _Dispatches() as pub:
            for blk in model.layers:
                blk.cfg = published
            model.forward({"tokens": tokens})
            for blk in model.layers:
                blk.cfg = cfg
        out["published_capacity"] = {
            "capacity_factor": published.moe.capacity_factor,
            "capacity": pub.capacities, "assignments": pub.assignments(),
            "dropped": pub.dropped()}
    _reset_attn_launches()
    worst = 0.0
    with torch.inference_mode():
        with _Dispatches() as disp:
            fwd, _ = model.forward(inputs)
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
    gate(disp.dropped() == 0, f"the forward dropped {disp.dropped()} "
                              f"MoE assignments")
    gate(worst <= DECODE_ATOL, f"decode differs from forward by {worst}")
    if dev.type == "cuda":
        # float32: the SIMT kernel of flash_attention
        gate(launches == {"flash_attention": n_attn,
                          "flash_attention_tc": 0,
                          "decode_attention": n_attn * n_tokens},
             f"attention launches {launches}")
    out = {"phase": "lm_consistency", "arch": cfg.name,
           "params": cfg.param_count(), "layers": cfg.n_layers,
           "attention_layers": n_attn, "dtype": "float32",
           "batch": batch, "tokens": n_tokens, "cache_len": cache_len,
           "init_s": init_s, "max_abs_err": worst, "atol": DECODE_ATOL,
           "max_abs_logit": scale, "launches": launches, **out}
    if cfg.moe is not None:
        out["moe"] = {"capacity_factor": cfg.moe.capacity_factor,
                      "assignments": disp.assignments(),
                      "dropped": disp.dropped(),
                      "capacity": disp.capacities}
    return out


def phase_lm_serve(dev, cfg, prefill_batch: int, prefill_len: int,
                   n_requests: int, prompt0: int, prompt_step: int,
                   max_new: int, cache_len: int, profile_steps: int,
                   seed: int) -> Dict:
    """``cfg`` with bfloat16 weights and cache: (a) ``prefill`` over
    ``prefill_batch`` prompts of ``prefill_len`` tokens; (b)
    ``ServeEngine.generate`` on ``n_requests`` prompts of ``prompt0 +
    prompt_step * i`` tokens, ``max_new`` new tokens each. Launch counts
    are zeroed just before each and read just after. (b) sets aside the
    state of its last ``profile_steps`` steps (a copy of every cache
    tensor, the step's tokens and positions); after (b) those steps run
    again from that state, copied back into the same buffers, under the
    profiler: their tokens must equal (b)'s, and their device busy time
    over their untraced time in (b) is the device's idle share. The
    warm-up prefill counts the MoE layers' dropped assignments; for an
    MoE arch its logits must equal the timed prefill's bit for bit (the
    combine has no atomics). MLA decodes by the absorbed einsums: no
    ``decode_attention`` launch. Every cache buffer keeps its address
    through (b) and through the replay (a gate: the writes are in
    place)."""
    import torch
    from repro_torch.models.lm import build_model
    from repro_torch.serve import Request, ServeEngine
    t_phase = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.bfloat16)
    model.init(_generator(dev, seed))
    r = rng(seed)
    v = cfg.vocab_size
    n_attn = _n_attn(model)
    out: Dict = {"phase": "lm_serve", "arch": cfg.name,
                 "params": cfg.param_count(), "layers": cfg.n_layers,
                 "attention_layers": n_attn, "dtype": "bfloat16"}

    # (a) prefill; a VLM's prompt is its image's patches, then text, in
    # prefill_len positions
    n_text = prefill_len - (cfg.frontend_tokens
                            if cfg.family.value == "vlm" else 0)
    batch = {"tokens": torch.from_numpy(
        r.integers(0, v, size=(prefill_batch, n_text))).to(dev)}
    if cfg.family.value == "vlm":
        batch["patches"] = torch.randn(
            (prefill_batch, cfg.frontend_tokens, cfg.d_model),
            generator=_generator(dev, seed + 1), device=dev).to(
                torch.bfloat16)
    with torch.inference_mode():
        with _Dispatches() as disp:                 # warm-up
            first = model.prefill(batch, prefill_len).clone()
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
        bit_equal = bool(torch.equal(first, logits))
    del logits, first
    if cfg.moe is not None:
        gate(bit_equal, "two bf16 prefills gave different logits")
    out["prefill"] = {
        "batch": prefill_batch, "tokens": prefill_len, "ms": prefill_s * 1e3,
        "tokens_per_s": prefill_batch * prefill_len / prefill_s,
        "launches": launches_a, "bit_equal_to_warm_up": bit_equal,
        "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None)}
    if cfg.moe is not None:
        out["prefill"]["moe"] = {"assignments": disp.assignments(),
                                 "dropped": disp.dropped(),
                                 "capacity": disp.capacities}

    # (b) generate, every step's logits checked finite on the device.
    # Each step's cache buffers (KV, latent, state: all but the (B,)
    # lengths, new each step) are held to the addresses of the first
    # step's (host reads). Before the last ``profile_steps`` steps the
    # step's inputs and a copy of every cache tensor are set aside, and
    # those steps' logits are kept: the copy's seconds leave the run's
    # time, its bytes the run's peak
    cuda = dev.type == "cuda"
    flags: List = []
    addresses: List = []
    tail: Dict = {"logits": []}
    step = model.decode_step

    def buffers(cache):
        return [t.data_ptr() for layer in cache
                for k, t in sorted(layer.items()) if k != "length"]

    def save_tail(logits, cache):
        sync(dev)
        t0 = time.perf_counter()
        held = torch.cuda.memory_allocated(dev) if cuda else 0
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        tail.update(cache=cache, before=logits,
                    outs=[list(q.out_tokens) for q in reqs],
                    copies=[{k: t.clone() for k, t in layer.items()}
                            for layer in cache])
        sync(dev)
        if cuda:
            tail["bytes"] = torch.cuda.memory_allocated(dev) - held
            tail["peak_before"] = peak
            torch.cuda.reset_peak_memory_stats(dev)
        tail["t0"] = time.perf_counter()
        tail["save_s"] = tail["t0"] - t0

    def checked(tokens, cache, pos):
        i = len(flags)
        if i == 0:
            addresses[:] = [buffers(cache), True]
            if tail_from == 0:
                save_tail(None, cache)
        logits, cache = step(tokens, cache, pos)
        addresses[1] = addresses[1] and buffers(cache) == addresses[0]
        flags.append(torch.isfinite(logits).all())
        if i >= tail_from:
            tail["logits"].append(logits)
        if i + 1 == tail_from:
            # the engine's state between two steps: the cache, the last
            # logits and the outputs so far
            save_tail(logits, cache)
        return logits, cache

    model.decode_step = checked
    prompts = [[int(t) for t in
                r.integers(0, v, size=prompt0 + prompt_step * i)]
               for i in range(n_requests)]
    max_prompt = max(len(p) for p in prompts)
    steps = max_prompt + max_new
    gate(0 < profile_steps <= steps, "profile_steps outside 1..steps")
    tail_from = steps - profile_steps
    engine = ServeEngine(model, cache_len=cache_len,
                         cache_dtype=torch.bfloat16)
    reqs = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    _reset_attn_launches()
    t0 = time.perf_counter()
    engine.generate(reqs)
    sync(dev)
    t1 = time.perf_counter()
    gen_s, tail_s = t1 - t0 - tail["save_s"], t1 - tail["t0"]
    launches_b = _attn_launches()
    variants_b = dict(_attn_kernels()[1].variants)
    cache_kept = addresses[1]
    gate(cache_kept, "a decode step moved a cache buffer to a new address")
    gate(all(len(q.out_tokens) == max_new
             and all(0 <= t < v for t in q.out_tokens) for q in reqs),
         "a request's tokens are missing or outside the vocab")
    gate(len(flags) == steps and bool(torch.stack(flags).all().item()),
         "a decode step's logits are not finite")
    if cuda:
        # bfloat16: every prefill launch on the tensor-core kernel, one
        # per attention block; MLA's absorbed decode launches no
        # decode_attention, nor do SSM and RG-LRU blocks
        per_step = 0 if cfg.mla is not None else n_attn
        gate(launches_a == {"flash_attention": n_attn,
                            "flash_attention_tc": n_attn,
                            "decode_attention": 0},
             f"prefill attention launches {launches_a}")
        gate(launches_b == {"flash_attention": 0, "flash_attention_tc": 0,
                            "decode_attention": per_step * steps},
             f"generate attention launches {launches_b}")
        # a bfloat16 model over a bfloat16 cache: every decode_attention
        # call on the tensor-core split kernel
        gate(variants_b == {"tensor_core": per_step * steps, "simt": 0},
             f"generate decode_attention split kernels {variants_b}")
    gen = out["generate"] = {
        "requests": n_requests,
        "prompt_lens": [len(q.prompt) for q in reqs],
        "max_new_tokens": max_new, "cache_len": cache_len,
        "decode_steps": steps, "s": gen_s,
        "ms_per_decode_step": gen_s * 1e3 / steps,
        "generated_tokens_per_s": n_requests * max_new / gen_s,
        "tail_steps": profile_steps,
        "tail_ms_per_step": tail_s * 1e3 / profile_steps,
        "launches": launches_b, "decode_variants": variants_b,
        "cache_buffers": len(addresses[0]),
        "cache_addresses_kept": cache_kept,
        "peak_device_bytes": (max(tail["peak_before"],
                                  torch.cuda.max_memory_allocated(dev)
                                  - tail["bytes"]) if cuda else None),
        "first_tokens": reqs[0].out_tokens[:8]}

    # the last profile_steps steps of (b) again, traced: the saved cache
    # copied back into the same buffers, the requests' outputs as they
    # stood, and the engine's own step loop run from the saved logits to
    # the end
    rows = engine.prompt_rows(reqs)
    outs = [Request(prompt=q.prompt, max_new_tokens=max_new,
                    out_tokens=list(o)) for q, o in zip(reqs, tail["outs"])]
    again: List = []

    def recorded(tokens, cache, pos):
        logits, cache = step(tokens, cache, pos)
        again.append(logits)
        return logits, cache

    def replay():
        for layer, copies in zip(tail["cache"], tail["copies"]):
            for k, t in layer.items():
                t.copy_(copies[k])
        kept = buffers(tail["cache"]) == addresses[0]
        _, cache = engine.run_steps(outs, rows, tail["cache"], tail_from,
                                    steps, logits=tail["before"])
        return kept and buffers(cache) == addresses[0]

    model.decode_step = recorded
    with torch.inference_mode():
        with (_traced(dev) if cuda else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            replay_kept = replay()
            sync(dev)
            t1 = time.perf_counter()
        same_tokens = (len(again) == profile_steps
                       and all(torch.equal(a.argmax(-1), b.argmax(-1))
                               for a, b in zip(again, tail["logits"]))
                       and [q.out_tokens for q in outs]
                       == [q.out_tokens for q in reqs])
        same_logits = all(torch.equal(a, b)
                          for a, b in zip(again, tail["logits"]))
    gate(replay_kept, "the tail's replay moved a cache buffer")
    gate(same_tokens, "the tail's replay gave other tokens than (b)")
    prof_out = out["profiled"] = {
        "run": f"the last {profile_steps} decode steps of (b), replayed "
               f"from their saved state in the same buffers, traced",
        "s": t1 - t0, "decode_steps": profile_steps,
        "same_tokens": same_tokens, "same_logits": same_logits,
        "cache_addresses_kept": replay_kept,
        "saved_bytes": tail.get("bytes"),
        "save_s": tail["save_s"],
        "wall_ms_per_step": (t1 - t0) * 1e3 / profile_steps}
    del tail, again
    if cuda:
        trace = _Trace.of(prof)
        busy_ms, heaviest = trace.device(top=12)
        # the trace holds every launch of K3's two kernels in the replayed
        # steps, or its device time would leave some out
        made = per_step * profile_steps
        held = {name: trace.kernel_ms(rf"\b{name}_kernel\b")[1]
                for name in ("decode_split_tc", "decode_combine")}
        gate(held == {name: made for name in held},
             f"the traced steps hold {held} launches of decode_attention's "
             f"kernels, not {made} each")
        prof_out.update({
            "decode_attention_traced": {name: [n, made]
                                        for name, n in held.items()},
            "trace_processing_s": time.perf_counter() - t1,
            "device_busy_ms_per_step": (None if busy_ms is None
                                        else busy_ms / profile_steps),
            "device_idle_share_traced": (None if busy_ms is None
                                         else 1.0 - busy_ms / 1e3
                                         / (t1 - t0)),
            "heaviest_device_ms": heaviest})
        if busy_ms is not None:
            # the traced steps' device time over the untraced time of the
            # same steps in (b) (the profiler slows the host, not the
            # device)
            gen["device_idle_share"] = 1.0 - (
                busy_ms / profile_steps) / gen["tail_ms_per_step"]
    del model.decode_step
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ------------------------------------------- LM serving: the MoE family
def phase_prefill_attention(dev, arch: str, b: int, h: int, s: int, d: int,
                            v_dim: int, seed: int, reps: int,
                            hkv: Optional[int] = None, causal: bool = True,
                            window: int = 0, dtype: str = "bfloat16"
                            ) -> Dict:
    """``flash_attention`` at an arch's prefill shape: ``h`` query heads
    over ``hkv`` kv heads (``h`` by default), head dim ``d``, causal or
    bidirectional, a sliding ``window`` or none, the scale ``d ** -0.5``
    passed explicitly as the MLA model passes it (the kernel's default).
    Where ``v_dim < d`` (MLA) v has ``v_dim`` columns zero-padded to
    ``d``, as ``mla_operands`` builds it, and the output's padded columns
    must be exactly 0. In bfloat16 the tensor-core kernel must take it
    (``takes_tensor_cores`` and its launch counter), in float32 the SIMT
    kernel. Timed by graph replay, with the wrapper's host time per call
    (``call_ms``), the plain version's and SDPA's time (a boolean mask
    for a window) and the bound from the shapes (each (query, key) pair
    the masks keep: 4·d operations at the type's peak rate)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                          flash_attention_ref)
    hkv = h if hkv is None else hkv
    dt = getattr(torch, dtype)
    g = _generator(dev, seed)
    q, k, v = _randn(g, dev, dt, (b, h, s, d), (b, hkv, s, d),
                     (b, hkv, s, v_dim))
    v = F.pad(v, (0, d - v_dim))
    scale = float(d) ** -0.5
    kw = dict(causal=causal, window=window, scale=scale)
    tc_rule = fa.takes_tensor_cores(q, k, v)
    before = dict(fa.launches)
    got = flash_attention(q, k, v, **kw)
    sync(dev)
    tc = fa.launches["flash_attention_tc"] - before["flash_attention_tc"]
    launches = {"tensor_core": tc, "simt": fa.launches["flash_attention"]
                - before["flash_attention"] - tc}
    what = f"flash_attention {arch} {dtype} D={d} S={s}"
    if dev.type == "cuda":
        want = ({"tensor_core": 1, "simt": 0} if dtype == "bfloat16" else
                {"tensor_core": 0, "simt": 1})
        gate(tc_rule == (dtype == "bfloat16") and launches == want,
             f"{what}: takes_tensor_cores {tc_rule}, launches {launches}")
    padded_zero = bool((got[..., v_dim:] == 0).all().item())
    gate(padded_zero, f"{what}: padded v columns gave non-zero output")
    close = _check_close(what, got, flash_attention_ref(q, k, v, **kw))
    del got
    run = lambda: flash_attention(q, k, v, **kw)  # noqa: E731
    ms = graph_ms(run, dev, reps)
    call_ms = time_ms(run, dev, reps)
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, **kw), dev, 1)
    if window > 0:
        lib_kw = {"attn_mask": attention_mask(s, s, causal=causal,
                                              window=window, device=dev)}
        lib_note = "a boolean window mask"
    else:
        lib_kw, lib_note = {"is_causal": causal}, None
    library_ms, gqa_note = _library_ms(dev, reps, q, k, v, timer=graph_ms,
                                       scale=scale, **lib_kw)
    pairs = b * h * _attn_pairs(s, s, causal, window)
    size = q.element_size()
    return {"phase": "flash_attention", "arch": arch,
            "shape": [b, h, hkv, s, d], "v_dim": v_dim, "dtype": dtype,
            "causal": causal, "window": window, "scale": scale,
            "takes_tensor_cores": tc_rule, "launches": launches,
            "padded_columns_zero": padded_zero, **close, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention ("
                       + ", ".join(n for n in (gqa_note, lib_note) if n)
                       + ")",
            **bound(size * (2 * q.numel() + k.numel() + v.numel()),
                    4 * d * pairs,
                    H100_BF16_OPS_PER_S if dtype == "bfloat16"
                    else H100_F32_OPS_PER_S)}


def _mla_consistency(dev, cfg, batch: int, n_tokens: int, cache_len: int,
                     seed: int) -> Dict:
    """MLA attention of ``cfg`` alone, float32 weights: the full pass
    (the flash-attention op at D = qk_head_dim, v padded; the SIMT kernel
    in float32) at every position against the absorbed decode, one token
    at a time against the compressed cache (no kernel)."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models.param import count_tree_params, materialize
    spec = attn.attn_spec(cfg)
    g = _generator(dev, seed)
    params = materialize(spec, g, dtype=torch.float32, device=dev)
    x = torch.randn((batch, n_tokens, cfg.d_model), generator=g, device=dev)
    worst = 0.0
    with torch.inference_mode():
        _reset_attn_launches()
        full = attn.attn_apply(params, cfg, x)
        sync(dev)
        launches_full = _attn_launches()
        (cache,) = attn.alloc_cache(
            [attn.attn_cache_spec(cfg, batch, cache_len,
                                  dtype=torch.float32)], dev)
        _reset_attn_launches()
        for t in range(n_tokens):
            y, cache = attn.attn_decode(
                params, cfg, x[:, t:t + 1], cache,
                torch.full((batch,), t, dtype=torch.int32, device=dev))
            worst = max(worst, _max_err(y[:, 0], full[:, t]))
        launches_decode = _attn_launches()
        scale = float(full.abs().max().item())
    gate(worst <= DECODE_ATOL, f"MLA decode differs from the full pass by "
                               f"{worst}")
    if dev.type == "cuda":
        gate(launches_full == {"flash_attention": 1, "flash_attention_tc": 0,
                               "decode_attention": 0},
             f"MLA full-pass launches {launches_full}")
        gate(sum(launches_decode.values()) == 0,
             f"MLA decode launched {launches_decode}")
    return {"params": count_tree_params(spec),
            "head_dim": cfg.mla.qk_head_dim, "v_head_dim": cfg.mla.v_head_dim,
            "max_abs_err": worst, "atol": DECODE_ATOL,
            "max_abs_value": scale, "launches_full": launches_full,
            "launches_decode": launches_decode}


def _moe_block_consistency(dev, cfg, batch: int, n_tokens: int,
                           seed: int) -> Dict:
    """``cfg``'s MoE block alone, float32 weights (drawn one stack at a
    time): its forward over ``n_tokens`` tokens a row (no assignment may
    be dropped) against one token at a time. Under the reference's init
    (a stack's fan-in is its expert count) y reaches ~1e2, so the error
    is held to DECODE_ATOL of max(1, the largest |y|)."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.param import count_tree_params, materialize
    spec = moe.moe_spec(cfg)
    g = _generator(dev, seed)
    t0 = time.perf_counter()
    params = materialize(spec, g, dtype=torch.float32, device=dev)
    sync(dev)
    init_s = time.perf_counter() - t0
    x = torch.randn((batch, n_tokens, cfg.d_model), generator=g, device=dev)
    with torch.inference_mode():
        with _Dispatches() as disp:
            y, aux = moe.moe_apply(params, cfg, x)
        worst = 0.0
        for t in range(n_tokens):
            y1, _ = moe.moe_apply(params, cfg, x[:, t:t + 1])
            worst = max(worst, _max_err(y1[:, 0], y[:, t]))
        scale = float(y.abs().max().item())
        aux = float(aux.item())
    gate(disp.dropped() == 0, f"the MoE block dropped {disp.dropped()} "
                              f"assignments")
    bar = DECODE_ATOL * max(1.0, scale)
    gate(worst <= bar, f"the MoE block one token at a time differs by "
                       f"{worst} > {bar}")
    return {"params": count_tree_params(spec), "init_s": init_s,
            "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
            "capacity": disp.capacities, "assignments": disp.assignments(),
            "dropped": disp.dropped(), "aux": aux, "max_abs_err": worst,
            "max_abs_value": scale, "atol": bar}


def _reduced_card_vs_cpu(dev, cfg, batch: int, n_tokens: int,
                         cache_len: int, seed: int) -> Dict:
    """The reduced ``cfg`` on the card against the same float32 weights
    on the CPU: forward and (for a decoder) decode logits at
    DECODE_ATOL, the aux loss at ``rel=1e-6``, every MoE layer's integer
    dispatch state ``==``. The inputs are the family's: frames (audio),
    random patches before the tokens (VLM), tokens."""
    import torch
    from repro_torch.models.lm import build_model
    cpu_dev = torch.device("cpu")
    cpu = build_model(cfg, device=cpu_dev, dtype=torch.float32)
    cpu.init(torch.Generator().manual_seed(seed))
    card = build_model(cfg, device=dev, dtype=torch.float32)
    card.load_state_dict(cpu.state_dict())
    r = rng(seed)
    tokens = r.integers(0, cfg.vocab_size, size=(batch, n_tokens))
    inputs = {"tokens": tokens}
    if cfg.family.value == "audio":
        inputs = {"frames": r.standard_normal(
            (batch, n_tokens, cfg.d_model)).astype(np.float32)}
    elif cfg.family.value == "vlm":
        inputs["patches"] = r.standard_normal(
            (batch, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    runs = []
    for model, where in ((cpu, cpu_dev), (card, dev)):
        on = {k: torch.from_numpy(v).to(where) for k, v in inputs.items()}
        steps = []
        with torch.inference_mode(), _Dispatches(keep_states=True) as disp:
            fwd, aux = model.forward(on)
            if cfg.decoder:
                cache = model.init_cache(batch, cache_len,
                                         dtype=torch.float32)
                for t in range(n_tokens):
                    logits, cache = model.decode_step(
                        on["tokens"][:, t], cache,
                        torch.full((batch,), t, dtype=torch.int32,
                                   device=where))
                    steps.append(logits.cpu())
        runs.append((fwd.cpu(), float(aux),
                     torch.stack(steps, 1) if steps else None, disp))
    (fwd_c, aux_c, dec_c, st_c), (fwd_g, aux_g, dec_g, st_g) = runs
    fwd_err = _max_err(fwd_g, fwd_c)
    dec_err = _max_err(dec_g, dec_c) if cfg.decoder else None
    same = st_c.difference(st_g) is None
    gate(fwd_err <= DECODE_ATOL and (dec_err or 0.0) <= DECODE_ATOL,
         f"{cfg.name}: card vs CPU forward {fwd_err}, decode {dec_err}")
    gate(abs(aux_g - aux_c) <= 1e-6 * abs(aux_c),
         f"{cfg.name}: aux {aux_g} on the card, {aux_c} on the CPU")
    gate(same, f"{cfg.name}: a dispatch state differs from the CPU's")
    return {"arch": cfg.name, "forward_max_abs_err": fwd_err,
            "decode_max_abs_err": dec_err, "atol": DECODE_ATOL,
            "aux": [aux_c, aux_g], "dispatches": len(st_g.states),
            "dispatch_states_equal": same}


def phase_moe_consistency(dev, moonshot, deepseek, depth: int, batch: int,
                          n_tokens: int, cache_len: int, seed: int) -> Dict:
    """The MoE family in float32 (TF32 off): (a) ``moonshot`` at full
    width with its depth cut to ``depth``, forward against token-by-token
    decode (``phase_lm_consistency``: K2's SIMT kernel once per layer, K3
    once per layer per token), at a capacity factor under which no
    assignment can be dropped (random weights route most tokens of a
    row alike, past the published capacity of 8: the drops of the
    published factor are reported); (b) ``deepseek``'s
    MLA attention at full width, the full pass against the absorbed
    decode; (c) ``deepseek``'s MoE block at full width, its forward
    against one token at a time; (d) the reduced configs of both on the
    card against the CPU."""
    import dataclasses

    import torch
    from repro_torch.config import reduced_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out: Dict = {"phase": "moe_consistency", "dtype": "float32"}
    cut = dataclasses.replace(moonshot, n_layers=min(depth,
                                                     moonshot.n_layers))
    # a capacity of top_k * n_tokens a row: no expert can overflow, as
    # the reduced configs' capacity factor 4.0 makes forward and decode
    # comparable; the published factor's drops are counted beside it
    wide = dataclasses.replace(cut, moe=dataclasses.replace(
        cut.moe, capacity_factor=float(cut.moe.n_experts)))
    a = phase_lm_consistency(dev, wide, batch=batch, n_tokens=n_tokens,
                             cache_len=cache_len, seed=seed,
                             published=cut)
    a["depth_cut"] = {"from": moonshot.n_layers, "to": cut.n_layers,
                      "reason": "float32 weights of all 48 layers (112 GB) "
                                "do not fit one 80 GB card"}
    out["a"] = a
    _free(dev)
    out["b_mla"] = _mla_consistency(dev, deepseek, batch, n_tokens,
                                    cache_len, seed + 1)
    _free(dev)
    out["c_moe_block"] = _moe_block_consistency(dev, deepseek, batch,
                                                n_tokens, seed + 2)
    _free(dev)
    out["d_reduced"] = [
        _reduced_card_vs_cpu(dev, reduced_config(c), batch, n_tokens,
                             cache_len, seed + 3)
        for c in (moonshot, deepseek)]
    return out


def _free(dev) -> None:
    import gc

    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _phase_runner(dev, out: Dict[str, Dict]) -> Callable[..., Dict]:
    """``run(name, fn, *args, **kw)``: calls the phase ``fn``, gives its
    result its seconds (``phase_s``) where it has none, emits it, keeps
    it in ``out`` under ``name``, frees the card and returns it."""

    def run(name: str, fn: Callable[..., Dict], *args, **kw) -> Dict:
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        res.setdefault("phase_s", time.perf_counter() - t0)
        emit(res)
        out[name] = res
        _free(dev)
        return res

    return run


def moe_serve_configs(moonshot, deepseek):
    """The serving configs of the MoE family: moonshot at full width and
    depth; deepseek at full width, its depth cut to 1 (with its MTP
    block), each cut with its reason."""
    import dataclasses
    return [(moonshot, None),
            (dataclasses.replace(deepseek, n_layers=1),
             {"from": deepseek.n_layers, "to": 1,
              "reason": "one MoE layer is 11.5 B parameters: depth 1 with "
                        "the MTP block holds 24.97 B (49.9 GB in bf16); "
                        "depth 2 needs 73 GB of weights, no room for the "
                        "prefill's activations on one 80 GB card"})]


# ------------------------- LM serving: the SSM, hybrid, VLM, audio families
def phase_encode(dev, cfg, batch: int, frames: int, seed: int,
                 reps: int) -> Dict:
    """An encoder (``decoder=False``: hubert) with bfloat16 weights:
    ``forward`` over ``batch`` x ``frames`` seeded random frames, one
    warm-up and ``reps`` timed runs (host clock to the device's end),
    each attention block one launch of K2's tensor-core kernel; the
    logits finite and (B, frames, V); peak device bytes."""
    import torch
    from repro_torch.models.lm import build_model
    t_phase = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.bfloat16)
    model.init(_generator(dev, seed))
    x = {"frames": torch.randn((batch, frames, cfg.d_model),
                               generator=_generator(dev, seed + 1),
                               device=dev).to(torch.bfloat16)}
    with torch.inference_mode():
        first, _ = model.forward(x)
        gate(tuple(first.shape) == (batch, frames, cfg.vocab_size)
             and bool(torch.isfinite(first).all().item()),
             "encoder logits are not finite (B, S, V)")
        del first
        sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _reset_attn_launches()
        t0 = time.perf_counter()
        for _ in range(reps):
            model.forward(x)
        sync(dev)
        s = (time.perf_counter() - t0) / reps
        launches = _attn_launches()
    n_attn = _n_attn(model)
    if dev.type == "cuda":
        gate(launches == {"flash_attention": n_attn * reps,
                          "flash_attention_tc": n_attn * reps,
                          "decode_attention": 0},
             f"encoder attention launches {launches}")
    return {"phase": "lm_encode", "arch": cfg.name,
            "params": cfg.param_count(), "layers": cfg.n_layers,
            "dtype": "bfloat16", "batch": batch, "frames": frames,
            "reps": reps, "ms": s * 1e3, "frames_per_s": batch * frames / s,
            "launches": launches,
            "launches_per_forward": {k: n // reps for k, n in
                                     launches.items()},
            "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None),
            "phase_s": time.perf_counter() - t_phase}


def phase_family_consistency(dev, archs, reduced, batch: int,
                             n_tokens: int, cache_len: int,
                             seed: int) -> Dict:
    """The SSM, hybrid and VLM families in float32 (TF32 off) at full
    width and depth: each of ``archs`` forward against token-by-token
    decode (``phase_lm_consistency``: each attention block one launch of
    K2's SIMT kernel, at D 256 for the hybrid and the VLM, and K3 once a
    token), then each of ``reduced`` on the card against the CPU."""
    import torch
    from repro_torch.config import reduced_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out: Dict = {"phase": "family_consistency", "dtype": "float32"}
    for i, cfg in enumerate(archs):
        out[cfg.name] = phase_lm_consistency(
            dev, cfg, batch=batch, n_tokens=n_tokens, cache_len=cache_len,
            seed=seed + i)
        _free(dev)
    out["reduced"] = [
        _reduced_card_vs_cpu(dev, reduced_config(c), batch, n_tokens,
                             cache_len, seed + 10 + i)
        for i, c in enumerate(reduced)]
    out["phase_s"] = time.perf_counter() - t0
    return out


def family_phases(dev, get_arch, profile_steps: int) -> Dict[str, Dict]:
    """The phases of the SSM, hybrid, VLM and audio families, each
    emitted as it ends, with its seconds (``phase_s``): K2 and K3 at
    their shapes, the float32 consistency, bfloat16 serving of mamba2,
    recurrentgemma and paligemma with granite's traffic, and hubert's
    encode. Returns them by name for the kernel line."""
    mamba = get_arch("mamba2-370m")
    rg = get_arch("recurrentgemma-2b")
    pali = get_arch("paligemma-3b")
    hubert = get_arch("hubert-xlarge")
    win = rg.rglru.attn_window
    out: Dict[str, Dict] = {}
    run = _phase_runner(dev, out)

    # K2: the hybrid's local attention (MQA 10/1, D 256, window 2048; at
    # S 4096 the window bites), the VLM's MQA (8/1, D 256; 256 patches +
    # 1792 tokens), hubert's bidirectional MHA (16/16, D 80: two panels,
    # 48 zero columns), and the SIMT kernel in float32 at D 256
    hd = rg.resolved_head_dim
    run("fa_rg", phase_prefill_attention, dev, rg.name, 4, rg.n_heads,
        2048, hd, hd, seed=21, reps=10, hkv=rg.n_kv_heads, window=win)
    run("fa_rg_4k", phase_prefill_attention, dev, rg.name, 4, rg.n_heads,
        4096, hd, hd, seed=22, reps=5, hkv=rg.n_kv_heads, window=win)
    run("fa_pali", phase_prefill_attention, dev, pali.name, 4,
        pali.n_heads, 2048, pali.resolved_head_dim,
        pali.resolved_head_dim, seed=23, reps=10, hkv=pali.n_kv_heads)
    run("fa_hubert", phase_prefill_attention, dev, hubert.name, 4,
        hubert.n_heads, 2048, hubert.resolved_head_dim,
        hubert.resolved_head_dim, seed=24, reps=10, causal=False)
    run("fa_simt_d256", phase_prefill_attention, dev, rg.name, 2,
        rg.n_heads, 512, hd, hd, seed=25, reps=5, hkv=rg.n_kv_heads,
        window=win, dtype="float32")
    # K3: group 10 (two group tiles, 8 + 2) and group 8, D 256, the
    # path's ring buffer of 1024 (the window is 2048) with lengths 512,
    # then a ragged 4096 cache
    run("dec_rg", phase_decode_attention, dev, 8, rg.n_heads,
        rg.n_kv_heads, hd, path_s=1024, path_len=512, s=4096, step=37,
        seed=26, reps=200)
    run("dec_pali", phase_decode_attention, dev, 8, pali.n_heads,
        pali.n_kv_heads, pali.resolved_head_dim, path_s=1024, path_len=512,
        s=4096, step=37, seed=27, reps=200)
    run("consistency", phase_family_consistency, dev, [mamba, rg, pali],
        [mamba, rg, pali, hubert], batch=2, n_tokens=16, cache_len=32,
        seed=28)
    for cfg in (mamba, rg, pali):
        # granite's traffic
        run(f"serve_{cfg.name}", phase_lm_serve, dev, cfg,
            prefill_batch=4, prefill_len=2048, n_requests=8, prompt0=128,
            prompt_step=48, max_new=64, cache_len=1024,
            profile_steps=profile_steps, seed=29)
    run("encode", phase_encode, dev, hubert, batch=4, frames=2048, seed=30,
        reps=5)
    return out


# ------------------------------- LM serving: the two large dense archs
# the share of one 80 GB card the weights of a depth-cut serving model may
# take together with its initialization's largest transient: init_tensor
# draws each weight in float32 and casts it, so the tied embedding of
# command-r-plus briefly holds 4 + 2 bytes a parameter beside the model
SERVE_WEIGHT_BUDGET = 72e9


def _param_bytes(cfg, dtype_bytes: int) -> Dict[str, float]:
    """Bytes of ``cfg``'s weights outside the layers (embedding, final
    norm, head) and of one layer, at ``dtype_bytes`` a parameter."""
    import dataclasses
    zero = dataclasses.replace(cfg, n_layers=0).param_count()
    one = dataclasses.replace(cfg, n_layers=1).param_count() - zero
    return {"outside_layers": zero * dtype_bytes, "layer": one * dtype_bytes,
            "largest": cfg.vocab_size * cfg.d_model * dtype_bytes}


def depth_that_fits(cfg, dtype_bytes: int, budget: float) -> Dict:
    """The deepest cut of ``cfg`` whose weights, with the init's largest
    transient (the largest weight drawn in float32, then cast to the
    model's dtype), fit ``budget`` bytes; with its reason."""
    pb = _param_bytes(cfg, dtype_bytes)
    transient = pb["largest"] // dtype_bytes * 4 + (
        pb["largest"] if dtype_bytes != 4 else 0)
    depth = int((budget - transient - pb["outside_layers"]) // pb["layer"])
    depth = max(1, min(depth, cfg.n_layers))
    return {"from": cfg.n_layers, "to": depth,
            "reason": f"{pb['layer'] / 1e9:.3f} GB a layer and "
                      f"{pb['outside_layers'] / 1e9:.2f} GB outside the "
                      f"layers at {dtype_bytes} bytes a parameter, with "
                      f"the init's {transient / 1e9:.2f} GB transient "
                      f"(the largest weight drawn in float32 and cast): "
                      f"{depth} layers fit "
                      f"{budget / 1e9:.0f} GB of the 80 GB card, the rest "
                      f"left to the activations"}


def dense_phases(dev, get_arch, profile_steps: int) -> Dict[str, Dict]:
    """The two large dense archs, each phase emitted as it ends with its
    seconds: K2 at internlm2-20b's (GQA 48/8, group 6) and
    command-r-plus-104b's (96/8, group 12) prefill shapes at D 128; K3 at
    groups 6 and 12, D 128 (group 12 takes two group tiles, 8 + 4); both
    in float32 at a depth that fits, forward against decode; then serving
    with granite's traffic, internlm2 at full width and depth and
    command-r-plus at full width cut to the deepest that fits (printed
    with its reason), each with its prefill's model FLOPs
    (``roofline/model_flops.py``) over its time as a share of the bf16
    peak. Returns the phases by name for the kernel line."""
    import dataclasses

    from repro_torch.config.types import ShapeConfig
    from repro_torch.roofline.model_flops import model_flops
    intern = get_arch("internlm2-20b")
    cr = get_arch("command-r-plus-104b")
    out: Dict[str, Dict] = {}
    run = _phase_runner(dev, out)

    for i, cfg in enumerate((intern, cr)):
        run(f"fa_{cfg.name}", phase_prefill_attention, dev, cfg.name, 4,
            cfg.n_heads, 2048, cfg.resolved_head_dim,
            cfg.resolved_head_dim, seed=40 + i, reps=10,
            hkv=cfg.n_kv_heads)
    for i, cfg in enumerate((intern, cr)):
        run(f"dec_{cfg.name}", phase_decode_attention, dev, 8, cfg.n_heads,
            cfg.n_kv_heads, cfg.resolved_head_dim, path_s=1024,
            path_len=512, s=4096, step=37, seed=42 + i, reps=200)
    def consistency(cfg, cut: Dict, seed: int) -> Dict:
        res = phase_lm_consistency(
            dev, dataclasses.replace(cfg, n_layers=cut["to"]), batch=2,
            n_tokens=16, cache_len=32, seed=seed)
        res["depth_cut"] = cut
        return res

    def serve(cfg, cut: Optional[Dict], seed: int) -> Dict:
        served = cfg if cut is None else dataclasses.replace(
            cfg, n_layers=cut["to"])
        res = phase_lm_serve(dev, served, prefill_batch=4, prefill_len=2048,
                             n_requests=8, prompt0=128, prompt_step=48,
                             max_new=64, cache_len=1024,
                             profile_steps=profile_steps, seed=seed)
        if cut is not None:
            res["depth_cut"] = cut
        flops = model_flops(served, ShapeConfig("prefill", 2048, 4,
                                                "prefill"))
        res["prefill"]["model_flops"] = flops
        res["prefill"]["bf16_peak_share"] = (
            flops / (res["prefill"]["ms"] / 1e3) / H100_BF16_OPS_PER_S)
        return res

    # float32: internlm2 cut to 12 layers (18.6 GB with its untied head),
    # command-r-plus to the deepest cut that fits 50 GB
    run("consistency_intern", consistency, intern,
        {"from": intern.n_layers, "to": 12,
         "reason": "float32 weights of all 48 layers (79.4 GB) do not fit "
                   "one 80 GB card; 12 keep the check short"}, 44)
    run("consistency_cr", consistency, cr, depth_that_fits(cr, 4, 50e9), 45)
    # granite's traffic
    run(f"serve_{intern.name}", serve, intern, None, 46)
    run(f"serve_{cr.name}", serve, cr,
        depth_that_fits(cr, 2, SERVE_WEIGHT_BUDGET), 47)
    return out


# ------------------------------------------------------- LM training path
def _kernel_launches() -> Dict[str, int]:
    """The launches of every kernel counter of the training path."""
    from repro_torch.kernels.gbdt_infer import kernel as gbdt
    return {**gbdt.launches, **_attn_launches()}


def _scorer_calls(pipe) -> int:
    """Scorer calls of a pipeline's controllers: one per stage-1 proposal
    and one per bootstrap pick (each one ``gbdt_logits`` launch on a
    CUDA device)."""
    return sum(c.tuner.tune_count
               + sum(d[1] == "bootstrap" for d in c.decisions)
               for c in pipe.controllers)


def _reset_kernel_launches() -> None:
    from repro_torch.kernels.gbdt_infer import kernel as gbdt
    gbdt.reset_launches()
    _reset_attn_launches()


def _train_launcher(dev, steps: int, ckpt_every: int, ckpt_root: str,
                    models) -> Dict:
    """(a) ``repro_torch.launch.train.main`` at the reference's defaults
    (granite-3-2b reduced, batch 8 x seq 64, 4 hosts, 2 MiB samples as
    the example), CARAT off then on. Gates: finite losses; the loss of
    step 0's batch lower after the run than at step 0; K2 launched once
    per attention block per step (``remat="dots"`` keeps its output: no
    relaunch); K1 once per scorer call of the hosts' controllers; and the
    controllers' decisions and waits equal a CPU-scored pipeline's fed
    the compute times the run measured."""
    import io

    import torch
    from repro_torch.config import (CaratConfig, DataConfig, ShapeConfig,
                                    get_arch, reduced_config)
    from repro_torch.data import PFSDataPipeline, TokenSource, make_host_batch
    from repro_torch.launch import train as launch
    cfg = reduced_config(get_arch("granite-3-2b"))
    shape = ShapeConfig("launcher", 64, 8, "train")
    out: Dict = {"arch": cfg.name, "steps": steps, "batch": 8, "seq": 64,
                 "hosts": 4, "sample_kb": 2048, "ckpt_every": ckpt_every,
                 "remat": "dots"}
    for carat in (False, True):
        argv = ["--arch", "granite-3-2b", "--steps", str(steps), "--hosts",
                "4", "--batch", "8", "--seq", "64", "--sample-kb", "2048",
                "--ckpt-every", str(ckpt_every), "--device", str(dev),
                "--ckpt-dir", os.path.join(ckpt_root,
                                           "on" if carat else "off")]
        printed = io.StringIO()
        _reset_kernel_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            run = launch.main(argv + ([] if carat else ["--no-carat"]))
        sync(dev)
        wall = time.perf_counter() - t0
        launches = _kernel_launches()
        pipe = run.pipeline
        b0 = make_host_batch(cfg, 64, 8, TokenSource(cfg.vocab_size, 0), 0)
        with torch.no_grad():
            held = float(run.model.loss(b0))
        gate(bool(np.isfinite(run.losses).all()), "a launcher loss is not "
                                                  "finite")
        gate(held < run.losses[0], f"step 0's batch: loss {held} after the "
             f"run, {run.losses[0]} at step 0")
        row = {"last_line": printed.getvalue().strip().splitlines()[-1],
               "s": wall, "losses_first_last": [run.losses[0],
                                                run.losses[-1]],
               "step0_batch_loss_after": held,
               "ms_per_step": 1e3 * float(np.mean(run.compute_s)),
               "input_wait_s": float(sum(run.waits_s)),
               "input_wait_s_per_step": float(np.mean(run.waits_s)),
               "pfs_MBps": pipe.throughput() / 1e6,
               "decisions": sum(len(c.decisions) for c in pipe.controllers),
               "scorer_calls": _scorer_calls(pipe), "launches": launches}
        if dev.type == "cuda":
            want = {"flash_attention": _attn_blocks(run.model) * steps,
                    "flash_attention_tc": 0, "decode_attention": 0,
                    "gbdt_logits": _scorer_calls(pipe),
                    "gbdt_grid_logits": 0}
            gate(launches == want, f"launcher (carat={carat}) launches "
                                   f"{launches}, expected {want}")
        if carat:
            gate(_scorer_calls(pipe) > 0, "the controllers scored nothing")
            cpu = PFSDataPipeline(cfg, DataConfig(sample_bytes=2048 * 1024),
                                  n_hosts=4, carat=CaratConfig(),
                                  models=models, device="cpu")
            waits = [cpu.step(shape, c) for c in run.compute_s]
            same = (waits == run.waits_s
                    and [c.decisions for c in cpu.controllers]
                    == [c.decisions for c in pipe.controllers])
            gate(same, "the card-scored pipeline's decisions differ from "
                       "the CPU-scored pipeline's")
            row["decisions_equal_cpu_scorers"] = same
        out["carat_on" if carat else "carat_off"] = row
        del run
    return out


def _train_restart(dev) -> Dict:
    """(b) The twin of ``tests/test_elastic_integration.py:43-71`` on
    ``dev``: reduced h2o-danube-1.8b, 6 steps with a checkpoint at 4;
    fresh weights and optimizer state restored from it replay steps 4
    and 5 with the same losses (``atol=0``)."""
    import torch
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.config import (CheckpointConfig, ParallelConfig,
                                    RunConfig, ShapeConfig, get_arch,
                                    reduced_config)
    from repro_torch.data import TokenSource, make_host_batch
    from repro_torch.models.lm import build_model
    from repro_torch.train import AdamWConfig, TrainState, make_train_step
    cfg = reduced_config(get_arch("h2o-danube-1.8b"))
    model = build_model(cfg, device=dev, dtype=torch.float32)
    run = RunConfig(arch=cfg, shape=ShapeConfig("t", 16, 4, "train"),
                    parallel=ParallelConfig(remat="none",
                                            opt_state_dtype="float32"))
    step_fn = make_train_step(model, run)
    source = TokenSource(cfg.vocab_size, seed=3)
    batches = [make_host_batch(cfg, 16, 4, source, i) for i in range(6)]
    model.init(_generator(dev, 0))
    state = TrainState.init(model.param_tree(), AdamWConfig())
    with tempfile.TemporaryDirectory(prefix="ckpt_", dir=ROOT / "build") as d:
        mgr = CheckpointManager(CheckpointConfig(directory=d), n_shards=3)
        losses = []
        for i in range(6):
            if i == 4:
                mgr.save(state, step=4, blocking=True)
            state, m = step_fn(state, batches[i])
            losses.append(float(m["loss"]))
        model.init(_generator(dev, 99))
        fresh = TrainState.init(model.param_tree(), AdamWConfig())
        restored, step = mgr.restore(fresh)
    gate(step == 4 and int(restored["step"]) == 4, "restored the wrong step")
    replay = []
    for i in (4, 5):
        restored, m = step_fn(restored, batches[i])
        replay.append(float(m["loss"]))
    gate(replay == losses[4:6], f"restart on {dev} is not bit-exact: "
                                f"{replay} vs {losses[4:6]}")
    return {"arch": cfg.name, "losses": losses, "replayed": replay,
            "bit_exact": True}


def _train_full(dev, cfg, batch: int, seq: int, steps: int, models) -> Dict:
    """(c) ``cfg`` at its published width and depth, seeded random float32
    weights and AdamW state, ``remat="dots"``, ``batch`` x ``seq`` tokens
    from ``TokenSource`` through ``make_train_step``, ``steps`` steps
    after one warm-up, the CARAT-on pipeline fed each measured step time.
    Per step: ms (to a synchronized end) and input wait. Then one more
    step under the profiler: the AdamW update's range (``UPDATE_RANGE``
    of ``make_train_step``) splits a step into forward+backward and the
    update; on the card also device busy ms (idle share against the
    timed steps' mean), the heaviest device ops, K2's device ms and the
    device ms of its backward (the plain version's gradient).
    Gates: loss and grad norm finite at every step, K2 and its backward
    op (``flash_attention_backward``) once per attention block per step
    (none for an SSM), K1 once per scorer call, one update range in the
    trace."""
    import torch
    from repro_torch.config import (CaratConfig, DataConfig, ParallelConfig,
                                    RunConfig, ShapeConfig, TrainConfig)
    from repro_torch.data import PFSDataPipeline, TokenSource, make_host_batch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models.lm import build_model
    from repro_torch.train import AdamWConfig, TrainState, make_train_step
    from repro_torch.train.step import UPDATE_RANGE
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.float32)
    model.init(_generator(dev, 8))
    shape = ShapeConfig("full", seq, batch, "train")
    run = RunConfig(arch=cfg, shape=shape,
                    parallel=ParallelConfig(remat="dots",
                                            opt_state_dtype="float32"),
                    train=TrainConfig(steps=steps + 2))
    state = TrainState.init(model.param_tree(), AdamWConfig())
    step_fn = make_train_step(model, run)
    sync(dev)
    init_s = time.perf_counter() - t0
    pipe = PFSDataPipeline(cfg, DataConfig(sample_bytes=2048 * 1024),
                           n_hosts=4, carat=CaratConfig(), models=models,
                           device=dev)
    source = TokenSource(cfg.vocab_size, seed=0)
    batches = [make_host_batch(cfg, seq, batch, source, i)
               for i in range(steps + 2)]
    cuda = dev.type == "cuda"
    state, _ = step_fn(state, batches[0])           # warm-up
    sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    _reset_kernel_launches()
    rows, metrics = [], []
    for i in range(1, steps + 1):
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[i])
        sync(dev)
        step_s = time.perf_counter() - t0
        rows.append({"ms": step_s * 1e3,
                     "input_wait_s": pipe.step(shape, step_s)})
        metrics.append(torch.stack([m["loss"], m["grad_norm"]]))
    launches = _kernel_launches()
    backward_calls = fa_kernel.backward_calls["flash_attention_backward"]
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    metrics = torch.stack(metrics).cpu().numpy()
    gate(bool(np.isfinite(metrics).all()), "a full-width loss or grad "
                                           "norm is not finite")
    blocks = _attn_blocks(model)
    if cuda:
        want = {"flash_attention": blocks * steps,
                "flash_attention_tc": 0, "decode_attention": 0,
                "gbdt_logits": _scorer_calls(pipe), "gbdt_grid_logits": 0}
        gate(launches == want, f"{cfg.name} full-width launches "
                               f"{launches}, expected {want}")
        # K2's backward op: once per attention block per step
        gate(backward_calls == blocks * steps,
             f"{cfg.name}: {backward_calls} calls of the backward op, "
             f"expected {blocks * steps}")
    mean_ms = float(np.mean([r["ms"] for r in rows]))
    # one more step under the profiler: the AdamW update's range gives
    # the split of a step (on the card, the range's span on the device:
    # its kernels and the gaps between them; on the CPU, its host time)
    with _traced(dev) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, batches[steps + 1])
        sync(dev)
        traced_s = time.perf_counter() - t0
    trace = _Trace.of(prof)
    adamw_ms = trace.range_ms(UPDATE_RANGE, cuda)
    gate(adamw_ms["calls"] == 1 and adamw_ms["span"] > 0.0,
         f"the traced step's update range: {adamw_ms}")
    out = {"arch": cfg.name, "params": cfg.param_count(), "layers":
           cfg.n_layers, "attention_blocks": blocks,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "dtype": "float32", "remat": "dots", "batch": batch, "seq": seq,
           "tokens_per_step": batch * seq, "steps": steps, "init_s": init_s,
           "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "float32_matmul_precision": torch.get_float32_matmul_precision(),
           "ms_per_step": mean_ms,
           "adamw_ms": adamw_ms["span"], "fwd_bwd_ms": mean_ms
           - adamw_ms["span"],
           "input_wait_s_per_step": float(np.mean([r["input_wait_s"]
                                                   for r in rows])),
           "tokens_per_s": batch * seq / (mean_ms / 1e3),
           "model_tflops_per_s": 6 * cfg.param_count() * batch * seq
           / (mean_ms / 1e3) / 1e12,
           "peak_device_bytes": peak, "losses": metrics[:, 0].tolist(),
           "grad_norms": metrics[:, 1].tolist(), "per_step": rows,
           "decisions": sum(len(c.decisions) for c in pipe.controllers),
           "scorer_calls": _scorer_calls(pipe), "launches": launches,
           "flash_attention_backward_op_calls": backward_calls}
    out["profiled"] = {"run": "one more step, traced",
                       "wall_ms": traced_s * 1e3,
                       "adamw_calls": adamw_ms["calls"]}
    if cuda:
        busy_ms, heaviest = trace.device(top=12)
        fa_ms, fa_launches = trace.kernel_ms(
            r"\bflash_attention(_tc)?_kernel\b")
        bwd = trace.range_ms(fa_kernel.BACKWARD_RANGE, cuda)
        out["profiled"].update({
            "device_busy_ms": busy_ms,
            "device_idle_share": (None if busy_ms is None
                                  else 1.0 - busy_ms / mean_ms),
            "adamw_device_ms": adamw_ms["device"],
            "flash_attention_device_ms": fa_ms,
            "flash_attention_launches": fa_launches,
            # the op's backward (the plain version's gradient): its
            # kernels' device ms, its span on the device, its calls
            "flash_attention_backward_device_ms": bwd["device"],
            "flash_attention_backward_span_ms": bwd["span"],
            "flash_attention_backward_calls": bwd["calls"],
            "heaviest_device_ms": heaviest})
    return out


class _Updates:
    """While active, records what every AdamW update of the train step
    receives (it wraps ``repro_torch.train.step.adamw_update``, which the
    step looks up at each call): the gradients on the host, the learning
    rate, the optimizer's config and the clip. :meth:`replay` runs those
    updates with the CPU's AdamW; :meth:`slack` bounds what the
    gradients' bars can move them."""

    def __init__(self):
        self.calls: List = []

    def __enter__(self) -> "_Updates":
        import torch
        from repro_torch.train import step as step_mod
        self._mod, self._update = step_mod, step_mod.adamw_update

        def recorded(params, grads, state, lr, cfg, grad_clip=0.0):
            self.calls.append(([g.detach().cpu() for g in grads],
                               torch.as_tensor(lr).cpu(), cfg, grad_clip))
            return self._update(params, grads, state, lr, cfg,
                                grad_clip=grad_clip)

        step_mod.adamw_update = recorded
        return self

    def __exit__(self, *exc) -> None:
        self._mod.adamw_update = self._update

    def replay(self, params: List) -> List:
        """Copies of the CPU tensors ``params`` after the recorded updates
        (the recorded gradients, learning rates, config and clip) by the
        CPU's AdamW from a fresh state."""
        from repro_torch.train import AdamWConfig, TrainState
        from repro_torch.train.optimizer import adamw_update
        state = TrainState.init([p.clone() for p in params], AdamWConfig())
        for grads, lr, cfg, clip in self.calls:
            state["params"], state["opt"] = adamw_update(
                state["params"], grads, state["opt"], lr, cfg,
                grad_clip=clip)
        return state["params"]

    def slack(self, atol: float, grad_rel: float) -> List[np.ndarray]:
        """Per element of every leaf, in float64: how far the recorded
        updates can move it when each step's gradient ``g`` may lie
        anywhere within its bar ``atol + grad_rel * max|g|`` (after the
        clip), where ``g`` lies within that bar of 0 at some step, and 0
        elsewhere. AdamW moves an element by ``lr * (m/c1) / (sqrt(v/c2)
        + eps)``; with the moments' ranges over the bars each step's
        move has a range, inside ``lr`` times the most ``|m/c1| /
        sqrt(v/c2)`` can be for any gradients (1 at the first step), and
        the bound is the sum over the steps of the move's largest
        distance from its value at the recorded gradients (weight
        decay's share, ``lr * wd`` of a parameter's difference, is left
        out). Where a true gradient is ~0 (a key
        bias's is exactly 0: softmax ignores a shift shared by every
        key), float32 rounding, ~1e-8 there on either device, decides
        the sign of a move of up to ``lr`` (``tests/test_torch_lm.py``'s
        ``test_train_step_matches_reference`` holds one step the same
        way)."""
        out, near, moments = [], [], []
        for t, (grads, lr, cfg, clip) in enumerate(self.calls, start=1):
            b1, b2 = cfg.b1, cfg.b2
            g64 = [g.double().numpy() for g in grads]
            scale = 1.0
            if clip > 0:
                norm = np.sqrt(sum(float((g * g).sum()) for g in g64))
                scale = min(1.0, clip / max(norm, 1e-12))
            if not out:
                out = [np.zeros_like(g) for g in g64]
                near = [np.zeros(g.shape, bool) for g in g64]
                # m, its range's half-width, v, v's lowest and highest
                moments = [[np.zeros_like(g) for _ in range(5)]
                           for g in g64]
            c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            # the largest |m/c1| / sqrt(v/c2) of any gradients (Cauchy-
            # Schwarz over the steps' weights)
            most = np.sqrt(sum(((1 - b1) * b1 ** k / c1) ** 2
                               / ((1 - b2) * b2 ** k / c2)
                               for k in range(t)))
            for i, g in enumerate(g64):
                bar = scale * (atol + grad_rel * float(np.abs(g).max()))
                g = scale * g
                m, dm, v, v_lo, v_hi = moments[i]
                m[:] = b1 * m + (1 - b1) * g
                dm[:] = b1 * dm + (1 - b1) * bar
                v[:] = b2 * v + (1 - b2) * g * g
                v_lo[:] = b2 * v_lo + (1 - b2) * np.maximum(
                    np.abs(g) - bar, 0.0) ** 2
                v_hi[:] = b2 * v_hi + (1 - b2) * (np.abs(g) + bar) ** 2
                move = m / c1 / (np.sqrt(v / c2) + cfg.eps)
                den_lo = np.sqrt(v_lo / c2) + cfg.eps
                den_hi = np.sqrt(v_hi / c2) + cfg.eps
                hi, lo = (m + dm) / c1, (m - dm) / c1
                hi = np.where(hi > 0, hi / den_lo, hi / den_hi)
                lo = np.where(lo < 0, lo / den_lo, lo / den_hi)
                hi, lo = np.minimum(hi, most), np.maximum(lo, -most)
                out[i] += float(lr) * np.maximum(hi - move, move - lo)
                near[i] |= np.abs(g) <= bar
        return [np.where(n, b, 0.0) for n, b in zip(near, out)]


def _attn_blocks(model) -> int:
    """K2 launches of one training forward: every attention block of the
    stack and, where there is one, the MTP head's block (it runs in the
    loss only)."""
    return _n_attn(model) + (model.mtp is not None)


# the archs of lm_train (e): every family beside granite's dense one at
# its reduced config; recurrentgemma at 3 layers, whose third block is
# its local attention (the reduced 2 are both RG-LRU blocks); danube's
# sliding window of 8 bites in its 64-token rows
PARITY_ARCHS = (("moonshot-v1-16b-a3b", None), ("deepseek-v3-671b", None),
                ("mamba2-370m", None), ("recurrentgemma-2b", 3),
                ("paligemma-3b", None), ("hubert-xlarge", None),
                ("h2o-danube-1.8b", None))


def parity_configs() -> List:
    import dataclasses

    from repro_torch.config import get_arch, reduced_config
    out = []
    for name, depth in PARITY_ARCHS:
        cfg = reduced_config(get_arch(name))
        out.append(cfg if depth is None
                   else dataclasses.replace(cfg, n_layers=depth))
    return out


def _train_parity(dev, cfg, steps: int = 3, slack: bool = True,
                  seq: int = 64, batch: int = 8,
                  seeds: Tuple[int, int] = (9, 5),
                  keep: Optional[Dict] = None) -> Dict:
    """``steps`` train steps of reduced ``cfg`` on ``dev`` (K2 forward)
    and of the port on the CPU (the plain version), from the same weights
    (``seeds``: the init's, the token source's), with no warm-up
    (``warmup_steps=0``): the first step already takes the peak learning
    rate, so every step moves the weights. The batches are the family's
    (``make_host_batch``: tokens, patches before them, frames), ``batch``
    x ``seq``. Gates: every step's loss at ``rel=1e-5`` and every
    parameter after the last step at ``atol=1e-5`` of the CPU's, the
    reference's bars (``tests/test_train.py:67-70``); every step's grad
    norm at ``rel=1e-4`` and each gradient of the first step within
    ``1e-5`` plus ``1e-4`` of its largest element, the CPU tests' bar
    (``tests/test_torch_train.py``: float32 cancels digits in the
    embedding's input rows), and so every step's gradients as the step
    hands them to AdamW; the weights moved by more than ten times
    ``atol``. With ``slack``, an element whose CPU gradient lies within
    its bar of 0 at some step may lie further from the CPU's by what the
    gradient bars can move AdamW's steps there (:meth:`_Updates.slack`);
    reduced granite, lm_train (d), is held without it. Besides, the
    parameters at ``atol`` of the CPU's AdamW fed the gradients the
    card's steps computed (:meth:`_Updates.replay`: the card's optimizer
    step). Every MoE dispatch of both runs (the first step's gradient and
    the steps, recomputes included) with equal integer states (where one
    differs: its token, experts and router margin); on the card, K2 (the
    SIMT kernel) and its backward op once per attention block (the MTP
    head's included) per step, and K2 never on the CPU. ``keep``, where
    given, receives the runs before any gate is read (the initial
    weights, the batches, the run's config, the paths, each side's first
    gradients, parameters and slack; ``chip_train_float64.py``)."""
    import torch
    from repro_torch.config import (ParallelConfig, RunConfig, ShapeConfig,
                                    TrainConfig)
    from repro_torch.data import TokenSource, make_host_batch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models.lm import build_model
    from repro_torch.train import (AdamWConfig, TrainState, make_loss_fn,
                                   make_train_step)
    from repro_torch.utils.tree import tree_flatten_with_paths, tree_leaves
    t_run = time.perf_counter()
    cpu = torch.device("cpu")
    loss_rel, grad_rel, atol = 1e-5, 1e-4, 1e-5
    run = RunConfig(arch=cfg, shape=ShapeConfig("t", seq, batch, "train"),
                    parallel=ParallelConfig(remat="dots"),
                    train=TrainConfig(warmup_steps=0))
    source = TokenSource(cfg.vocab_size, seeds[1])
    batches = [make_host_batch(cfg, seq, batch, source, i)
               for i in range(steps)]
    host = build_model(cfg, device=cpu, dtype=torch.float32)
    host.init(torch.Generator().manual_seed(seeds[0]))
    card = build_model(cfg, device=dev, dtype=torch.float32)
    card.load_state_dict(host.state_dict())
    blocks = _attn_blocks(host)
    init = [p.detach().clone() for p in tree_leaves(host.param_tree())]
    paths = [p for p, _ in tree_flatten_with_paths(host.param_tree())]
    out = {}
    for name, model in (("cpu", host), ("card", card)):
        step_fn = make_train_step(model, run)     # the parameters trainable
        state = TrainState.init(model.param_tree(), AdamWConfig())
        with _Dispatches(keep_states=True) as disp:
            # the first step's gradients: the step's own loss function (a
            # parameter the loss does not read gets zeros, as in the step)
            loss = make_loss_fn(model, run)(batches[0])
            grads = [g.cpu() for g in torch.autograd.grad(
                loss, tree_leaves(state["params"]), materialize_grads=True)]
            _reset_attn_launches()
            metrics = []
            with _Updates() as updates:
                for b in batches:
                    state, m = step_fn(state, b)
                    metrics.append(torch.stack([m["loss"], m["grad_norm"],
                                                m["lr"]]))
            k2 = _attn_launches()
            bwd = fa_kernel.backward_calls["flash_attention_backward"]
        out[name] = {"metrics": torch.stack(metrics).cpu().numpy(),
                     "grads": grads,
                     "params": [p.detach().cpu()
                                for p in tree_leaves(state["params"])],
                     "k2": k2["flash_attention"],
                     "k2_tc": k2["flash_attention_tc"], "bwd": bwd,
                     "dispatches": disp, "updates": updates}
    got, want = out["card"], out["cpu"]
    rel = np.abs(got["metrics"] - want["metrics"]) / np.abs(want["metrics"])
    # each gradient's error over its bound: at most 1 passes
    grad_ratio = {path: _max_err(a, b) / (atol + grad_rel
                                          * float(b.abs().max()))
                  for path, a, b in zip(paths, got["grads"], want["grads"])}
    worst = max(grad_ratio, key=grad_ratio.get)
    # every step's gradients as AdamW received them, at the same bar
    step_ratio = {(k, path): _max_err(a, b) / (atol + grad_rel
                                               * float(b.abs().max()))
                  for k, (mine, theirs) in enumerate(zip(
                      got["updates"].calls, want["updates"].calls), start=1)
                  for path, a, b in zip(paths, mine[0], theirs[0])}
    step_worst = max(step_ratio, key=step_ratio.get)
    # the card's parameters against the CPU's run: each element's error
    # over its bound, atol plus (with ``slack``) what the gradient bars
    # can move AdamW where the CPU's gradient is within its bar of 0
    slacks = (want["updates"].slack(atol, grad_rel) if slack
              else [np.zeros(p.shape) for p in init])
    if keep is not None:
        keep.update(init=init, batches=batches, run=run, paths=paths,
                    card=got, cpu=want, slacks=slacks)
    param_ratio, param_err, used = {}, {}, []
    for path, a, b, extra in zip(paths, got["params"], want["params"],
                                 slacks):
        err = np.abs(a.double().numpy() - b.double().numpy())
        param_ratio[path] = float((err / (atol + extra)).max())
        param_err[path] = float(err.max())
        used.extend(extra[err > atol].tolist())
    with_slack = sum(int((x > 0).sum()) for x in slacks) / sum(
        x.size for x in slacks)
    param_worst = max(param_ratio, key=param_ratio.get)
    replay_err = max(_max_err(a, b) for a, b in zip(
        got["params"], got["updates"].replay(init)))
    moved = max(_max_err(a, b) for a, b in zip(want["params"], init))
    what = f"{cfg.name} on {dev}"
    gate(float(rel[:, 0].max()) <= loss_rel, f"{what}: train step losses "
         f"off the CPU's by {rel[:, 0].tolist()} (relative)")
    gate(float(rel[:, 1].max()) <= grad_rel, f"{what}: train step grad "
         f"norms off the CPU's by {rel[:, 1].tolist()} (relative)")
    gate(grad_ratio[worst] <= 1.0, f"{what}: the gradient of {worst} off "
         f"the CPU's by {grad_ratio[worst]} times its bound")
    gate(step_ratio[step_worst] <= 1.0, f"{what}: step {step_worst[0]}'s "
         f"gradient of {step_worst[1]} off the CPU's by "
         f"{step_ratio[step_worst]} times its bound")
    gate(param_ratio[param_worst] <= 1.0, f"{what}: {param_worst} after "
         f"{steps} steps off the CPU's by {param_err[param_worst]}, "
         f"{param_ratio[param_worst]} times its bound")
    gate(replay_err <= atol, f"{what}: parameters after {steps} steps off "
                             f"the CPU's AdamW on the same gradients by "
                             f"{replay_err}")
    gate(moved > 10 * atol, f"{what}: the steps moved the weights by "
                            f"{moved} only")
    res = {"arch": cfg.name, "layers": cfg.n_layers, "steps": steps,
           "batch": batch, "seq": seq, "seeds": list(seeds),
           "warmup_steps": 0, "lr": want["metrics"][:, 2].tolist(),
           "losses_card": got["metrics"][:, 0].tolist(),
           "losses_cpu": want["metrics"][:, 0].tolist(),
           "loss_rel_err": float(rel[:, 0].max()),
           "grad_norm_rel_err": float(rel[:, 1].max()),
           "grad_worst": {"path": worst, "err_over_bound":
                          grad_ratio[worst]},
           "step_grad_worst": {"step": step_worst[0], "path":
                               step_worst[1], "err_over_bound":
                               step_ratio[step_worst]},
           "param_max_abs_err": max(param_err.values()),
           "param_worst": {"path": param_worst, "max_abs_err":
                           param_err[param_worst], "err_over_bound":
                           param_ratio[param_worst]},
           # the elements past atol, inside their slack: how many, and
           # the largest slack among them
           "param_slack": {"on": slack, "share_of_elements": with_slack,
                           "elements_past_atol": len(used),
                           "largest": max(used, default=0.0)},
           "param_vs_card_grads_replay": replay_err,
           "param_max_move": moved,
           "rel": loss_rel, "grad_rel": grad_rel, "atol": atol,
           "attention_blocks": blocks, "k2_launches_card": got["k2"],
           "k2_launches_cpu": want["k2"],
           "flash_attention_backward_op_calls": got["bwd"]}
    if cfg.moe is not None:
        diff = want["dispatches"].difference(got["dispatches"])
        res["moe"] = {"dispatches": len(got["dispatches"].states),
                      "dispatch_states_equal": diff is None,
                      "first_difference": diff}
        gate(diff is None, f"{what}: a dispatch state differs from the "
                           f"CPU's: {diff}")
    if dev.type == "cuda":
        gate(got["k2"] == blocks * steps and got["k2_tc"] == 0
             and want["k2"] == 0,
             f"{what}: K2 launches {got['k2']} ({got['k2_tc']} on tensor "
             f"cores) on the card, {want['k2']} on the CPU, expected "
             f"{blocks * steps} (0) and 0")
        gate(got["bwd"] == blocks * steps, f"{what}: {got['bwd']} calls of "
             f"K2's backward op, expected {blocks * steps}")
    res["s"] = time.perf_counter() - t_run
    return res


def phase_flash_attention_train(dev, b: int, hq: int, hkv: int, d: int,
                                s: int, reps: int, causal: bool = True,
                                window: int = 0,
                                v_dim: Optional[int] = None,
                                arch: Optional[str] = None) -> Dict:
    """K2 on the training path: float32 (the SIMT kernel), with a
    gradient, causal, sliding or bidirectional; where ``v_dim < d``
    (MLA) v has ``v_dim`` columns zero-padded to ``d``, as the model
    pads it, the output's padded columns must be exactly 0 and the
    incoming gradient is 0 there (the model slices them off). q, k and
    v's gradients through K2's op against the plain version's autograd
    on ``dev``: the backward is the plain version's, so they must be
    equal; the forward within float32's tolerance, and timed (``reps``
    calls) beside its bound, the plain version's and SDPA's (a boolean
    mask for a window). At granite's shape: the kernel line's
    ``flash_attention_simt`` row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                          flash_attention_ref)
    t_phase = time.perf_counter()
    v_dim = d if v_dim is None else v_dim
    kw = dict(causal=causal, window=window)
    g = _generator(dev, 10)
    q, k, v, grad = _randn(g, dev, torch.float32, (b, hq, s, d),
                           (b, hkv, s, d), (b, hkv, s, v_dim),
                           (b, hq, s, v_dim))
    v, grad = F.pad(v, (0, d - v_dim)), F.pad(grad, (0, d - v_dim))
    grads = {}
    before = dict(fa.launches)
    for name, fn in (("kernel", flash_attention),
                     ("plain", flash_attention_ref)):
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*qkv, **kw)
        grads[name] = (o.detach(), torch.autograd.grad(o, qkv, grad))
    sync(dev)
    tc = fa.launches["flash_attention_tc"] - before["flash_attention_tc"]
    launches = {"tensor_core": tc, "simt": fa.launches["flash_attention"]
                - before["flash_attention"] - tc}
    what = f"K2 training {arch or ''} D={d} window={window}"
    if dev.type == "cuda":
        gate(launches == {"tensor_core": 0, "simt": 1},
             f"{what}: launches {launches}")
    fwd_err = _max_err(grads["kernel"][0], grads["plain"][0])
    grad_err = max(_max_err(x, y) for x, y in zip(grads["kernel"][1],
                                                  grads["plain"][1]))
    padded_zero = bool((grads["kernel"][0][..., v_dim:] == 0).all().item())
    gate(fwd_err <= ATOL["float32"], f"{what}: forward off by {fwd_err}")
    gate(grad_err == 0.0, f"{what}: q/k/v gradients off the plain "
                          f"version's by {grad_err}")
    gate(padded_zero, f"{what}: padded v columns gave non-zero output")
    del grads
    if window > 0:
        lib_kw = {"attn_mask": attention_mask(s, s, causal=causal,
                                              window=window, device=dev)}
        lib_note = "a boolean window mask"
    else:
        lib_kw, lib_note = {"is_causal": causal}, None
    with torch.no_grad():
        ms = time_ms(lambda: flash_attention(q, k, v, **kw), dev, reps)
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, **kw), dev,
                           reps)
        library_ms, gqa_note = _library_ms(dev, reps, q, k, v, **lib_kw)
    return {"phase": "flash_attention_train", "arch": arch,
            "shape": [b, hq, hkv, s, d], "v_dim": v_dim, "dtype": "float32",
            "causal": causal, "window": window, "launches": launches,
            "max_abs_err": fwd_err, "grad_max_abs_err": grad_err,
            "padded_columns_zero": padded_zero,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "scaled_dot_product_attention ("
                       + ", ".join(n for n in (gqa_note, lib_note) if n)
                       + ")",
            **bound(4 * (2 * q.numel() + k.numel() + v.numel()),
                    4 * d * b * hq * _attn_pairs(s, s, causal, window)),
            "phase_s": time.perf_counter() - t_phase}


def phase_lm_train(dev, full_cfg, launch_steps: int, ckpt_every: int,
                   full_batch: int, full_seq: int, full_steps: int) -> Dict:
    """The LM training path with the CARAT-tuned PFS input pipeline:
    (a) the launcher, CARAT off and on; (b) a restart from a checkpoint,
    bit-exact; (c) ``full_cfg`` trained at its full width and depth;
    (d) the card's train step against the CPU's, reduced granite, and K2
    with its gradient at ``full_cfg``'s heads, batch 8 x ``full_seq``;
    (e) the same for every other family (``PARITY_ARCHS``). TF32 stays
    off (torch's default for matrix products)."""
    import torch
    from repro_torch.config import get_arch, reduced_config
    from repro_torch.core.ml.train import get_default_models
    torch.backends.cuda.matmul.allow_tf32 = False
    m_r, m_w = get_default_models()
    models = {"read": m_r, "write": m_w}
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    out: Dict = {"phase": "lm_train", "dtype": "float32"}
    with tempfile.TemporaryDirectory(prefix="ckpt_", dir=build) as d:
        out["a"] = _train_launcher(dev, launch_steps, ckpt_every, d, models)
    out["b"] = _train_restart(dev)
    _free(dev)
    out["c"] = _train_full(dev, full_cfg, full_batch, full_seq, full_steps,
                           models)
    _free(dev)
    out["d"] = _train_parity(dev, reduced_config(get_arch("granite-3-2b")),
                             slack=False)
    out["d"]["qkv_grad"] = phase_flash_attention_train(
        dev, 8, full_cfg.n_heads, full_cfg.n_kv_heads,
        full_cfg.resolved_head_dim, full_seq, reps=20,
        arch=full_cfg.name)
    out["e"] = [_train_parity(dev, cfg) for cfg in parity_configs()]
    return out


# lm_train (c) beside granite: the families whose float32 weights,
# gradients and AdamW moments (16 B a parameter, 0.37-2.9 B parameters)
# and activations fit one 80 GB card at full width and depth; the MoE
# archs (16 B and 671 B parameters) do not
FULL_TRAIN_ARCHS = ("mamba2-370m", "recurrentgemma-2b", "paligemma-3b",
                    "hubert-xlarge")


def family_train_phases(dev, get_arch, models, batch: int, seq: int,
                        steps: int) -> Dict[str, Dict]:
    """The training path of every family on the card, each phase emitted
    as it ends with its seconds: K2 with its gradient (float32, SIMT) at
    each family's full heads, ``batch`` x ``seq``: hubert's (16/16, D 80,
    bidirectional), moonshot's (16/16, D 128), MLA's (128/128, D 192
    with v padded from 128), recurrentgemma's local attention (10/1, D
    256, window 2048) and danube's heads (32/8, D 80) with a window of
    128 (its published 4096 does not bite at ``seq`` 256); then lm_train
    (c) for each of ``FULL_TRAIN_ARCHS`` at full width and depth
    (``_train_full``: ``steps`` steps, the CARAT-on pipeline scored by
    ``models``). Returns them by name for the kernel line and the
    summary."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    out: Dict[str, Dict] = {}
    run = _phase_runner(dev, out)
    hubert = get_arch("hubert-xlarge")
    moon = get_arch("moonshot-v1-16b-a3b")
    ds = get_arch("deepseek-v3-671b")
    rg = get_arch("recurrentgemma-2b")
    danube = get_arch("h2o-danube-1.8b")
    for name, cfg, kw in (
            ("hubert", hubert, {"causal": False}),
            ("moonshot", moon, {}),
            ("mla", ds, {"v_dim": ds.mla.v_head_dim}),
            ("rg", rg, {"window": rg.rglru.attn_window}),
            ("danube", danube, {"window": 128})):
        d = ds.mla.qk_head_dim if name == "mla" else cfg.resolved_head_dim
        run(f"fa_train_{name}", phase_flash_attention_train, dev, batch,
            cfg.n_heads, cfg.n_kv_heads, d, seq, reps=20, arch=cfg.name,
            **kw)

    def full(cfg) -> Dict:
        return {"phase": "lm_train_full",
                **_train_full(dev, cfg, batch, seq, steps, models)}

    for name in FULL_TRAIN_ARCHS:
        run(f"train_{name}", full, get_arch(name))
    return out


def _radial_data(n: int = 3000, seed: int = 0, dim: int = 22):
    """``tests/test_ml.py``'s radial task: label 1 outside the median
    radius of the first two features."""
    X = rng(seed).normal(size=(n, dim)).astype(np.float32)
    r = X[:, 0] ** 2 + X[:, 1] ** 2
    return X, (r > np.median(r)).astype(np.int32)


class _TrainerLog:
    """Times every call of the trainers ``train_all_models`` calls (read
    model, then write model, per architecture) by patching them into
    ``repro_torch.core.ml.train`` for the ``with`` block: host seconds
    to a synchronized end, device bytes allocated above the call's
    start, and a net's Adam steps and parameter device."""

    NAMES = ("train_svm", "train_net", "train_gbdt")

    def __init__(self, dev):
        self.dev = dev
        self.calls: List[Dict] = []

    def _wrap(self, name: str, fn: Callable) -> Callable:
        import torch

        def run(*args, **kw):
            cuda = self.dev.type == "cuda"
            if cuda:
                torch.cuda.reset_peak_memory_stats(self.dev)
                base = torch.cuda.memory_allocated(self.dev)
            sync(self.dev)
            t0 = time.perf_counter()
            model = fn(*args, **kw)
            sync(self.dev)
            call = {"model": (args[0].name if name == "train_net"
                              else name[len("train_"):]),
                    "s": time.perf_counter() - t0,
                    "peak_device_bytes": (
                        torch.cuda.max_memory_allocated(self.dev) - base
                        if cuda else 0)}
            if name == "train_net":
                call["adam_steps"] = model.steps
                call["param_devices"] = sorted(
                    {str(p.device) for p in model.module.parameters()})
            self.calls.append(call)
            return model
        return run

    def __enter__(self):
        from repro_torch.core.ml import train
        self._saved = {n: getattr(train, n) for n in self.NAMES}
        for n, fn in self._saved.items():
            setattr(train, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.core.ml import train
        for n, fn in self._saved.items():
            setattr(train, n, fn)

    def by_model(self) -> Dict[str, Dict]:
        out: Dict[str, Dict] = {}
        for c in self.calls:
            row = out.setdefault(c["model"], {"train_s": 0.0,
                                              "peak_device_bytes": 0})
            row["train_s"] += c["s"]
            row["peak_device_bytes"] = max(row["peak_device_bytes"],
                                           c["peak_device_bytes"])
            if "adam_steps" in c:
                row["adam_steps"] = row.get("adam_steps", 0) + c["adam_steps"]
                row["param_devices"] = sorted(set(row.get(
                    "param_devices", [])) | set(c["param_devices"]))
        for row in out.values():
            if "adam_steps" in row:
                row["ms_per_step"] = 1e3 * row["train_s"] / row["adam_steps"]
        return out


def phase_ml(dev, cache_dir: str, reps: int, duration_s: float,
             seed: int) -> Dict:
    """CARAT's models (paper §IV-B, Table IV):

    1. ``get_default_models`` under the full production protocol (reps
       32, 60 s workloads, seed 0) into ``cache_dir``: both files must
       equal the committed ``assets/gbdt_{read,write}_s0.npz`` byte for
       byte (collection and GBDT training are host work);
    2. ``train_all_models(reps, duration_s, seed)`` with the nets on
       ``dev``: Table IV's read/write error of every model (all finite,
       every net's parameters on ``dev``), with each model's training
       time and the nets' Adam steps;
    3. each net trained on ``dev`` on ``tests/test_ml.py``'s radial task
       for its 80 epochs must pass its bar (validation
       accuracy > 0.75) and predict what the same weights predict on the
       CPU in float64 (``atol=1e-5``; on the card float32 with torch's
       default TF32 settings).
    """
    import torch
    from repro_torch.core.ml import gbdt, nets, train
    prev_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    # torch's defaults (an earlier phase turns both off)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        t0 = time.perf_counter()
        train.get_default_models(cache_dir=cache_dir, seed=0, force=True)
        assets_s = time.perf_counter() - t0
        same = {op: (Path(cache_dir) / f"gbdt_{op}_s0.npz").read_bytes()
                == (gbdt.ASSETS / f"gbdt_{op}_s0.npz").read_bytes()
                for op in ("read", "write")}
        gate(all(same.values()),
             f"regenerated GBDT pair differs from the assets: {same}")

        log = _TrainerLog(dev)
        t0 = time.perf_counter()
        with log:
            reports = train.train_all_models(reps=reps,
                                             duration_s=duration_s,
                                             seed=seed, device=dev)
        table_s = time.perf_counter() - t0
        per_model = log.by_model()
        table = {name: {"read_error": r.read_error,
                        "write_error": r.write_error, **per_model[name]}
                 for name, r in reports.items()}
        gate(all(np.isfinite([r.read_error, r.write_error]).all()
                 for r in reports.values()), "a Table IV error is not finite")
        for name in ("fcnn", "rnn", "tcn"):
            gate(table[name]["param_devices"] == [str(dev)],
                 f"{name} trained on {table[name]['param_devices']}")

        X, y = _radial_data()
        radial = {}
        for arch_cls in (nets.FCNN, nets.VanillaRNN, nets.TCN):
            t0 = time.perf_counter()
            m = nets.train_net(arch_cls(X.shape[1]), X[:2400], y[:2400],
                               X[2400:], y[2400:], epochs=80,
                               device=dev)
            sync(dev)
            s = time.perf_counter() - t0
            acc = float((m.predict(X[2400:]) == y[2400:]).mean())
            # the same weights' forward on the CPU in float64 (torch's
            # float32 one there can drift past 1e-5 on a first call)
            on_cpu = arch_cls(X.shape[1])
            on_cpu.load_state_dict({k: v.cpu() for k, v in
                                    m.module.state_dict().items()})
            Z = (X.astype(np.float64) - m.mu) / m.sigma
            with torch.no_grad():
                want = torch.sigmoid(on_cpu.double()(torch.from_numpy(Z)))
            err = float(np.abs(m.predict_proba(X) - want.numpy()).max())
            devices = sorted({str(p.device) for p in m.module.parameters()})
            gate(acc > 0.75, f"{arch_cls.name} radial accuracy {acc}")
            gate(err <= 1e-5, f"{arch_cls.name} differs from its CPU "
                              f"forward by {err}")
            gate(devices == [str(dev)], f"{arch_cls.name} on {devices}")
            radial[arch_cls.name] = {"accuracy": acc, "max_abs_err_cpu": err,
                                     "adam_steps": m.steps, "s": s,
                                     "ms_per_step": 1e3 * s / m.steps}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev_tf32
    return {"phase": "ml", "device": str(dev),
            "default_models": {"reps": 32, "duration_s": 60.0, "seed": 0,
                               "s": assets_s, "byte_equal_assets": same},
            "table_iv": {"reps": reps, "duration_s": duration_s,
                         "seed": seed, "s": table_s, "models": table},
            "radial": {"epochs": 80, "bar": 0.75, "nets": radial}}


def summary_line(nvidia_smi: List[str], serves: List[Dict],
                 parity_runs: List[Dict], full_runs: List[Dict]) -> Dict:
    """What the end of the output, all that is kept of a whole run, must
    show: the card; each served arch's cache buffers at their addresses
    through generate and through its tail's replay; each arch trained on
    the card against the CPU, its worst loss and gradient errors over
    their bars and the calls of K2's backward op; each arch trained at
    full width, its ms per step, idle share and backward op calls."""
    return {"phase": "summary", "nvidia_smi": nvidia_smi,
            "cache_addresses_kept": {
                r["arch"]: [r["generate"]["cache_addresses_kept"],
                            r["profiled"]["cache_addresses_kept"]]
                for r in serves},
            "lm_train_parity": {
                r["arch"]: {"loss_over_bar": r["loss_rel_err"] / r["rel"],
                            "grad_over_bar":
                                r["grad_worst"]["err_over_bound"],
                            "param_over_bar":
                                r["param_worst"]["err_over_bound"],
                            "backward_op_calls":
                                r["flash_attention_backward_op_calls"]}
                for r in parity_runs},
            "lm_train_full": {
                r["arch"]: {"ms_per_step": r["ms_per_step"],
                            "device_idle_share":
                                r["profiled"].get("device_idle_share"),
                            "backward_op_calls":
                                r["flash_attention_backward_op_calls"]}
                for r in full_runs}}


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
    m_read, m_write = default_models()
    # the main path's shape (one bootstrap pick: 63 candidate rows) for
    # both models, then the cross product of a 4096-client probe batch
    logits_small = phase_gbdt_logits(dev, m_read, 63, seed=1, reps=200)
    emit(logits_small)
    emit(phase_gbdt_logits(dev, m_write, 63, seed=1, reps=200))
    emit(phase_gbdt_logits(dev, m_read, 4096 * 63, seed=2, reps=50))
    grid = phase_gbdt_grid_logits(dev, m_read, 4096, seed=3, reps=50)
    emit(grid)
    emit(phase_fleet(dev, 100_000, 16, seed=0))
    carat = phase_carat(dev, 4096, 20, seed=0, node_size=16, flip_at=5.0)
    emit(carat)
    # CARAT's multi-client deployment: trace replay, the sharded device
    # fleet, and the CARAT loop under the sharded runtime's bus
    emit(phase_replay(dev, 4096, node_size=16, intervals=40, seed=8))
    emit(phase_sharded_fleet(dev, 100_000, 16, seed=0, node_size=16,
                             n_shards=4))
    sharded = phase_sharded_carat(dev, 4096, 20, seed=0, node_size=16,
                                  flip_at=5.0, n_shards=4, carat=carat)
    emit(sharded)
    # CARAT's multi-process deployment: spawned workers on the scalar
    # backend, each scoring its bootstrap picks on the card
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="flight_", dir=build) as flight:
        process = phase_process_carat(dev, 1024, 20, seed=0, node_size=16,
                                      flip_at=5.0, n_shards=4, kill_at=10,
                                      flight_dir=flight)
    emit(process)
    # the GBDT kernels' launches: the carat path's, both sharded runs' and
    # the process run (b)'s: the parent's, and the workers' (their own
    # counters, sent back in their reports)
    gbdt_launches = {name: carat["launches"][name]
                     + sharded["b"]["launches"][name]
                     + sharded["c"]["launches"][name]
                     + process["b"]["parent_launches"][name]
                     + process["b"]["worker_launches"].get(name, 0)
                     for name in carat["launches"]}

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
    # the traced replay covers 8 decode steps: reading back a trace takes
    # ~2 s per granite step (~4 s per moonshot step) on the host, and the
    # whole script has to end within 1200 s
    serve = phase_lm_serve(dev, granite, prefill_batch=4, prefill_len=2048,
                           n_requests=8, prompt0=128, prompt_step=48,
                           max_new=64, cache_len=1024,
                           profile_steps=PROFILE_STEPS, seed=7)
    emit(serve)
    # the serving model and its caches went with the phase's frame
    torch.cuda.empty_cache()

    # the LM training path with the CARAT-tuned PFS input pipeline: the
    # launcher (reduced), a restart, granite-3-2b at full width and depth,
    # the card's step against the CPU's
    train = phase_lm_train(dev, granite, launch_steps=30, ckpt_every=10,
                           full_batch=8, full_seq=256, full_steps=6)
    emit(train)
    _free(dev)
    # every other family's training path: K2 with its gradient at each
    # family's heads, then the four that fit trained at full width and
    # depth
    fam_train = family_train_phases(dev, get_arch, {"read": m_read,
                                                    "write": m_write},
                                    batch=8, seq=256, steps=6)
    full_runs = [train["c"]] + [fam_train[f"train_{name}"]
                                for name in FULL_TRAIN_ARCHS]
    parity_runs = [train["d"]] + train["e"]
    train_runs = [train["a"]["carat_off"]["launches"],
                  train["a"]["carat_on"]["launches"]] + [
        r["launches"] for r in full_runs]

    # CARAT's models: the production pair regenerated, Table IV with the
    # nets on the card, the reference's bar for the nets
    with tempfile.TemporaryDirectory(prefix="ml_cache_", dir=build) as cache:
        emit(phase_ml(dev, cache, reps=16, duration_s=60.0, seed=0))
    _free(dev)

    # the MoE family: K2 at its two prefill shapes (moonshot D 128, MLA D
    # 192 with v padded) and K3 at moonshot's decode shape, the float32
    # consistency of both archs, then serving moonshot-v1-16b-a3b at full
    # width and depth and deepseek-v3-671b at full width, depth 1
    moonshot = get_arch("moonshot-v1-16b-a3b")
    deepseek = get_arch("deepseek-v3-671b")
    mla = deepseek.mla
    emit(phase_prefill_attention(dev, moonshot.name, 4, moonshot.n_heads,
                                 2048, moonshot.resolved_head_dim,
                                 moonshot.resolved_head_dim, seed=9,
                                 reps=10))
    emit(phase_prefill_attention(dev, deepseek.name, 4, deepseek.n_heads,
                                 2048, mla.qk_head_dim, mla.v_head_dim,
                                 seed=10, reps=5))
    _free(dev)
    emit(phase_decode_attention(dev, 8, moonshot.n_heads,
                                moonshot.n_kv_heads,
                                moonshot.resolved_head_dim, path_s=1024,
                                path_len=512, s=4096, step=37, seed=11,
                                reps=200))
    emit(phase_moe_consistency(dev, moonshot, deepseek, depth=8, batch=2,
                               n_tokens=16, cache_len=32, seed=12))
    _free(dev)
    moe_serves = []
    for cfg, cut in moe_serve_configs(moonshot, deepseek):
        # granite's traffic and traced window
        out = phase_lm_serve(dev, cfg, prefill_batch=4, prefill_len=2048,
                             n_requests=8, prompt0=128, prompt_step=48,
                             max_new=64, cache_len=1024,
                             profile_steps=PROFILE_STEPS, seed=13)
        if cut is not None:
            out["depth_cut"] = cut
        emit(out)
        moe_serves.append(out)
        _free(dev)

    # the SSM, hybrid, VLM and audio families: K2 and K3 at their shapes,
    # the float32 consistency, serving mamba2-370m, recurrentgemma-2b and
    # paligemma-3b at full width and depth, hubert-xlarge's encode
    family = family_phases(dev, get_arch, PROFILE_STEPS)

    # the two large dense archs: K2 and K3 at GQA groups 6 and 12 (D
    # 128), the float32 consistency, serving internlm2-20b at full width
    # and depth and command-r-plus-104b at full width, depth cut
    dense = dense_phases(dev, get_arch, PROFILE_STEPS)

    # each kernel's launches summed over the paths that drive it: K1 and
    # K1b on the CARAT runs and the training pipelines; K2's tensor-core
    # kernel in the bf16 prefills (granite's, the MoE family's, the
    # hybrid's, the VLM's, internlm2's and command-r-plus's) and hubert's
    # encode, its SIMT kernel in every float32 train step on the card
    # ((a), (c) of granite and of the four families, the card's side of
    # (d) and (e); the tensor-core kernel is gated at 0 there), each row
    # beside its own kernel's timing (granite's shapes); K3 in generate
    # (granite's, moonshot's, the hybrid's, the VLM's and the dense
    # archs'; MLA's decode and mamba2's launch none)
    serves = [serve] + moe_serves + [family[f"serve_{name}"] for name in (
        "mamba2-370m", "recurrentgemma-2b", "paligemma-3b")] + [
        dense[f"serve_{name}"] for name in (
            "internlm2-20b", "command-r-plus-104b")]
    emit(summary_line(device["nvidia_smi"], serves, parity_runs,
                      full_runs))
    emit(kernel_line(
        {"gbdt_logits": logits_small, "gbdt_grid_logits": grid,
         "flash_attention": fa,
         "flash_attention_simt": train["d"]["qkv_grad"],
         "decode_attention": dec},
        {name: gbdt_launches[name] + sum(r[name] for r in train_runs)
         for name in gbdt_launches} | {
         "flash_attention": sum(
             r["prefill"]["launches"]["flash_attention_tc"] for r in serves)
         + family["encode"]["launches"]["flash_attention_tc"],
         "flash_attention_simt": sum(r["flash_attention"]
                                     - r["flash_attention_tc"]
                                     for r in train_runs)
         + sum(r["k2_launches_card"] for r in parity_runs),
         "decode_attention": sum(
             r["generate"]["launches"]["decode_attention"]
             for r in serves)}))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
