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
  bidirectional MHA (D 80) and in float32 at D 256 (split TF32),
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
  (its reason printed), each prefill's model FLOPs over its time;
* the reference's own workload shapes (``config/types.py`` ``SHAPES``),
  cut in batch only: granite-3-2b's ``prefill_32k`` (1 x 32,768 tokens),
  ``decode_32k`` (16 rows over a 32,768-position bfloat16 cache) and
  ``train_4k`` (the launcher's step in the reference's training
  configuration: bfloat16 weights, ``parallel_for``'s remat, microbatches
  and moment dtype, at the largest batch of 4,096-token rows one step
  fits), and ``long_500k`` decode of mamba2-370m, recurrentgemma-2b and
  h2o-danube-1.8b to position 524,287 from full rings; each cell's K2
  or K3 against its plain version on the path's operands and timed
  there, and the decode cells in float32 against the CPU;
* the reference's training configuration beyond that cell:
  moonshot-v1-16b-a3b at full width, cut in depth only, 1 x 4,096
  tokens (the MoE family's first full-width training), and one bfloat16
  step of every reduced family (and command-r-plus-104b at its XXL
  settings) on the card against the CPU, held to a float64 gradient.

Each phase prints one JSON line and any failed check ends the run with a
non-zero exit; the line before the last lists every kernel with its
launches (the GBDT kernels': the ``carat`` run's, both sharded CARAT
runs' and the first process run's, its workers' ``gbdt_logits`` calls
included, and the training pipelines'; flash attention's two
tensor-core kernels as two rows: the bfloat16 one's in the prefills
(granite's, the MoE family's, the hybrid's, the VLM's and the two large
dense archs'), hubert's encode and the bfloat16 training steps, the
split-TF32 one's in the float32 training steps, each beside its own
timing at granite's shapes; decode attention's in granite's,
moonshot's, the hybrid's, the VLM's and the
two large dense archs' generate; each sum with the reference shapes'
launches, whose cells add rows of their own) and times, and the last
line is
``{"ok": true, "device": {...}}``.

Usage (one CUDA device; imports nothing of JAX or of ``repro``)::

    python3 chip_smoke.py

Without a CUDA device, or without the port beside it, it exits 1 and
prints no result.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
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
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth,
# float32 rate outside the tensor cores, dense bfloat16 tensor-core rate
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
H100_BF16_OPS_PER_S = 989e12
# dense TF32 tensor-core rate: float32-accurate products take three
# (split TF32, flash_attention_f32tc_kernel)
H100_TF32_OPS_PER_S = 495e12
# the H100 SXM's boost clock and SMs (data sheet); an SM's L1/shared
# memory serves one 128-byte wavefront per clock
H100_SM_CLOCK_HZ = 1.98e9
H100_SMS = 132

# every CUDA kernel of the port's paths: its source and the Pallas kernel
# it replaces (file:line of the kernel function). K2's source holds three
# kernels: "flash_attention" is the bfloat16 wgmma one (the serving
# prefill), "flash_attention_f32tc" the float32 split-TF32 one (every
# training step); its SIMT kernel takes only operands no path gives it
# (other head dims, misaligned views) and is held to its plain version
# in lm_train (d) (``qkv_grad_simt``)
_GBDT_CU = "src/repro_torch/kernels/gbdt_infer/csrc/gbdt_infer.cu"
_GBDT_PALLAS = "src/repro/kernels/gbdt_infer/kernel.py:35"
_FA_CU = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
_FA_PALLAS = "src/repro/kernels/flash_attention/kernel.py:36"
KERNELS = {
    "gbdt_logits": (_GBDT_CU, _GBDT_PALLAS),
    "gbdt_grid_logits": (_GBDT_CU, _GBDT_PALLAS),
    "flash_attention": (_FA_CU, _FA_PALLAS),
    "flash_attention_f32tc": (_FA_CU, _FA_PALLAS),
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
    tensor-core instructions of each one's SASS and the registers and
    spills of each instance of K2's two tensor-core kernels. The
    flash-attention library must hold ``HGMMA`` (its bfloat16 kernel runs
    on wgmma), and no instance of that kernel may spill."""
    from concurrent.futures import ThreadPoolExecutor

    def one(lib):
        t0 = time.perf_counter()
        path, report = lib.build()
        return {"seconds": time.perf_counter() - t0, "library": path.name,
                **_ptxas_summary(report),
                "tensor_core_instructions": sass_tensor_core_counts(path),
                # each instance of K2's bfloat16 kernel (ILi<NP>ELi<T>E:
                # NP 64-column panels and T 16-column tails; 1, 1 is D 80,
                # 4, 0 is D 256) and each head-dim instance of its
                # split-TF32 kernel (ILi<NT>E: D = 8 NT)
                "flash_attention_tc_kernel": ptxas_entries(
                    report, "flash_attention_tc_kernel"),
                "flash_attention_f32tc_kernel": ptxas_entries(
                    report, "flash_attention_f32tc_kernel")}

    t0 = time.perf_counter()
    libs = _libraries()
    with ThreadPoolExecutor(len(libs)) as ex:
        done = dict(zip(libs, ex.map(one, libs.values())))
    tc = done["flash_attention"]["tensor_core_instructions"]
    gate(tc is not None and tc["HGMMA"] > 0,
         f"the flash-attention library holds no wgmma instruction ({tc})")
    wgmma = done["flash_attention"]["flash_attention_tc_kernel"]
    gate(len(wgmma) > 0 and all(e["spill_store_bytes"] == 0
                                for e in wgmma.values()),
         f"K2's bfloat16 kernel spills or was not reported: {wgmma}")
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


def _k2_launches(before: Dict[str, int]) -> Dict[str, int]:
    """K2's launches since ``before`` (a copy of its counters) by kernel:
    the bfloat16 ``wgmma`` one (``tensor_core``), the float32 split-TF32
    one (``f32tc``) and the SIMT one."""
    from repro_torch.kernels.flash_attention import kernel as fa
    n = {k: fa.launches[k] - before[k] for k in fa.launches}
    return {"tensor_core": n["flash_attention_tc"],
            "f32tc": n["flash_attention_f32tc"],
            "simt": n["flash_attention"] - n["flash_attention_tc"]
            - n["flash_attention_f32tc"]}


def _k2_one(kernel: str) -> Dict[str, int]:
    """``_k2_launches`` of one launch of ``kernel`` (``which_kernel``'s
    name: ``tc``, ``f32tc`` or ``simt``)."""
    return {"tensor_core": int(kernel == "tc"),
            "f32tc": int(kernel == "f32tc"), "simt": int(kernel == "simt")}


def _library_ms(dev, reps: int, q, k, v, timer=time_ms, **kw):
    """One PyTorch call computing the same attention, timed only (by
    ``timer``): ``_sdpa_gqa``, and which of its forms this torch took."""
    import torch.nn.functional as F
    try:
        F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
        note = "enable_gqa"
    except TypeError:
        note = "K/V repeated first"
    return timer(lambda: _sdpa_gqa(q, k, v, **kw), dev, reps), note


def _sdpa_gqa(q, k, v, **kw):
    """``scaled_dot_product_attention`` over GQA heads (K/V repeated
    first where this torch lacks ``enable_gqa``)."""
    import torch.nn.functional as F
    try:
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                              **kw)
    except TypeError:
        g = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), **kw)


def phase_flash_attention(dev, b: int, s: int, hq: int, hkv: int, d: int,
                          window: int, ragged_s: int, seed: int,
                          reps: int) -> Dict:
    """``flash_attention`` against its plain version: granite's prefill
    shape in bfloat16 (causal; timed, with its bound, the plain version's
    and SDPA's time), a float32 case with a ragged tail, and a bfloat16
    sliding window (timed likewise, SDPA with a boolean window mask).
    Each case reports the launches of each of K2's three kernels; on the
    card the bfloat16 cases must take the ``wgmma`` kernel and the
    float32 one the split-TF32 kernel."""
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
        launches = _k2_launches(before)
        if dev.type == "cuda":
            want = _k2_one("tc" if dtype == torch.bfloat16 else "f32tc")
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
        call_ms = time_ms(lambda: decode_attention(q, k, v, lens), dev, reps)
        kernel_ms = {}
        if dev.type == "cuda":
            # each kernel alone, by graph replay: the split over the
            # workspace, the combine over the partials the split left
            _, ws = dec.launch_parts(q, k, v, lens, dec.SPLIT)
            parts_out = dec.launch_parts(q, k, v, lens, dec.COMBINE, ws)[0]
            gate(torch.equal(parts_out, decode_attention(q, k, v, lens)),
                 f"decode_attention S={cache}: the split and the combine "
                 f"launched apart gave another output than the call")
            split = ("decode_split_tc" if dec.takes_tensor_cores(q, k, v)
                     else "decode_split_simt")
            kernel_ms = {
                split: graph_ms(lambda: dec.launch_parts(
                    q, k, v, lens, dec.SPLIT, ws), dev, reps),
                "decode_combine": graph_ms(lambda: dec.launch_parts(
                    q, k, v, lens, dec.COMBINE, ws), dev, reps)}
        return {"cache": cache, "lengths": lengths, "dtype": "bfloat16",
                **close["bfloat16"], "float32": close["float32"],
                "variants": variants, "call_ms": call_ms,
                "kernel_ms": kernel_ms,
                **k3_yardstick(dev, q, k, v, lens, reps)}

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
    probabilities (``moe.route``, wrapped likewise) on the host. With
    ``loads``, also per call on the device: each group's assignments
    to each expert, and of the router (``routes``) the spread of its
    logits over the experts and how alike the tokens it routes are
    (:meth:`load_stats`)."""

    def __init__(self, keep_states: bool = False, loads: bool = False):
        self.keep_states, self.keep_loads = keep_states, loads
        self.counts: List = []
        self.states: List = []
        self.experts: List = []
        self.probs: List = []
        self.capacities: List[int] = []
        self.caps: List[int] = []
        self.loads: List = []
        self.routes: List = []

    def __enter__(self) -> "_Dispatches":
        import torch
        from repro_torch.models import moe
        self._moe, self._dispatch, self._route = moe, moe.dispatch, moe.route

        def recorded(x, top_i, cap, e):
            buf, state = self._dispatch(x, top_i, cap, e)
            self.counts.append((state.keep.numel(), (~state.keep).sum()))
            if cap not in self.capacities:
                self.capacities.append(cap)
            if self.keep_loads:
                flat = top_i.reshape(top_i.shape[0], -1)
                self.caps.append(cap)
                self.loads.append(torch.zeros(
                    flat.shape[0], e, dtype=torch.int64,
                    device=flat.device).scatter_add_(
                        1, flat.long(), torch.ones_like(flat.long())))
            if self.keep_states:
                self.states.append([t.cpu() for t in state])
                self.experts.append(top_i.cpu())
            return buf, state

        def routed(params, cfg, x):
            probs, top_p, top_i = self._route(params, cfg, x)
            if self.keep_states:
                self.probs.append(probs.detach().cpu())
            if self.keep_loads:
                with torch.no_grad():
                    # the logits less their token's log-sum-exp: the same
                    # spread over the experts
                    spread = probs.log().std(-1).mean()
                    # the mean cosine of every pair of a row's tokens
                    # (each with itself included)
                    unit = torch.nn.functional.normalize(x.float(), dim=-1)
                    alike = unit.mean(1).pow(2).sum(-1).mean()
                self.routes.append(torch.stack([spread, alike]))
            return probs, top_p, top_i

        moe.dispatch = recorded
        if self.keep_states or self.keep_loads:
            moe.route = routed
        return self

    def __exit__(self, *exc) -> None:
        self._moe.dispatch, self._moe.route = self._dispatch, self._route

    def assignments(self) -> int:
        return sum(n for n, _ in self.counts)

    def dropped(self) -> int:
        return int(sum(int(d.item()) for _, d in self.counts))

    def load_stats(self, layers: int) -> Dict:
        """What ``loads`` recorded: per call, the dropped assignments
        counted plainly from the loads (each group's assignments to an
        expert past its capacity), the largest load over the capacity,
        the router's logit spread and its tokens' mean pairwise cosine;
        per layer, those of the first ``layers`` calls (the first
        forward, layer by layer); gated: the plain count equals the
        dispatch's own, call by call."""
        dropped = [int(d.item()) for _, d in self.counts]
        plain = [int((ld - cap).clamp(min=0).sum().item())
                 for ld, cap in zip(self.loads, self.caps)]
        gate(plain == dropped, f"dispatch drops {dropped} against the "
                               f"plain count from the loads {plain}")
        routes = [r.tolist() for r in self.routes]
        rows = [{"dropped_share": d / n, "largest_load_over_capacity":
                 int(ld.max().item()) / cap, "logit_spread": r[0],
                 "tokens_mean_cosine": r[1]}
                for (n, _), d, ld, cap, r in zip(
                    self.counts, dropped, self.loads, self.caps, routes)]
        return {"calls": len(rows), "plain_dropped": sum(plain),
                "first_forward_by_layer": rows[:layers],
                "histogram_first_call": sorted(
                    self.loads[0].sum(0).tolist(), reverse=True)
                if self.loads else []}

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
    block launches K2's split-TF32 kernel once and K3 once a token; SSM and
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
        # float32: the split-TF32 kernel of flash_attention
        gate(launches == {"flash_attention": n_attn,
                          "flash_attention_tc": 0,
                          "flash_attention_f32tc": n_attn,
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
                            "flash_attention_f32tc": 0,
                            "decode_attention": 0},
             f"prefill attention launches {launches_a}")
        gate(launches_b == {"flash_attention": 0, "flash_attention_tc": 0,
                            "flash_attention_f32tc": 0,
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
    must be exactly 0. In bfloat16 the ``wgmma`` kernel must take it, in
    float32 the split-TF32 kernel (``which_kernel`` and the launch
    counters). Timed by graph replay, with the wrapper's host time per call
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
    kernel = fa.which_kernel(q, k, v)
    before = dict(fa.launches)
    got = flash_attention(q, k, v, **kw)
    sync(dev)
    launches = _k2_launches(before)
    what = f"flash_attention {arch} {dtype} D={d} S={s}"
    if dev.type == "cuda":
        want = "tc" if dtype == "bfloat16" else "f32tc"
        gate(kernel == want and launches == _k2_one(want),
             f"{what}: which_kernel {kernel}, launches {launches}")
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
            "kernel": kernel, "launches": launches,
            "padded_columns_zero": padded_zero, **close, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention ("
                       + ", ".join(n for n in (gqa_note, lib_note) if n)
                       + ")",
            # float32-accurate work: three TF32 products a multiply-add
            **bound(size * (2 * q.numel() + k.numel() + v.numel()),
                    4 * d * pairs * (1 if dtype == "bfloat16" else 3),
                    H100_BF16_OPS_PER_S if dtype == "bfloat16"
                    else H100_TF32_OPS_PER_S)}


def _mla_consistency(dev, cfg, batch: int, n_tokens: int, cache_len: int,
                     seed: int) -> Dict:
    """MLA attention of ``cfg`` alone, float32 weights: the full pass
    (the flash-attention op at D = qk_head_dim, v padded; the split-TF32
    kernel in float32) at every position against the absorbed decode, one token
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
                               "flash_attention_f32tc": 1,
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
    decode (``phase_lm_consistency``: K2's split-TF32 kernel once per
    layer, K3
    once per layer per token), at a capacity factor under which no
    assignment can be dropped (random weights route most tokens of a
    row alike, past the published capacity of 8: the drops of the
    published factor are reported); (b) ``deepseek``'s
    MLA attention at full width, the full pass against the absorbed
    decode; (c) ``deepseek``'s MoE block at full width, its forward
    against one token at a time; (d) the reduced configs of both on the
    card against the CPU."""
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


# moonshot-v1-16b-a3b's layers in lm_serve (of 48): every MoE layer has
# the same shapes, so half the depth runs every kernel and gate of the
# path in half the host time
MOONSHOT_SERVE_LAYERS = 24


def moe_serve_configs(moonshot, deepseek):
    """The serving configs of the MoE family: moonshot at full width, its
    depth cut to ``MOONSHOT_SERVE_LAYERS``; deepseek at full width, its
    depth cut to 1 (with its MTP block), each cut with its reason."""
    layers = min(MOONSHOT_SERVE_LAYERS, moonshot.n_layers)
    cut = None if layers == moonshot.n_layers else {
        "from": moonshot.n_layers, "to": layers,
        "reason": "the whole smoke's time limit: at 48 layers its 528 "
                  "decode steps took 125 s on the host, the script's "
                  "largest phase"}
    return [(dataclasses.replace(moonshot, n_layers=layers), cut),
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
                          "flash_attention_f32tc": 0,
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
    K2's split-TF32 kernel, at D 256 for the hybrid and the VLM, and K3
    once a token), then each of ``reduced`` on the card against the
    CPU."""
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
    # 48 zero columns), and the split-TF32 kernel in float32 at D 256
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
    zero = dataclasses.replace(cfg, n_layers=0).param_count()
    one = dataclasses.replace(cfg, n_layers=1).param_count() - zero
    return {"outside_layers": zero * dtype_bytes, "layer": one * dtype_bytes,
            "largest": cfg.vocab_size * cfg.d_model * dtype_bytes}


def depth_that_fits(cfg, dtype_bytes: int, budget: float,
                    init_bytes: Optional[int] = None) -> Dict:
    """The deepest cut of ``cfg`` whose weights (``dtype_bytes`` a
    parameter: the weights alone, or the weights with their training
    state), with the init's largest transient (the largest weight drawn
    in float32, then cast to the weights' ``init_bytes``, by default
    ``dtype_bytes``), fit ``budget`` bytes; with its reason."""
    pb = _param_bytes(cfg, dtype_bytes)
    init_bytes = dtype_bytes if init_bytes is None else init_bytes
    elements = pb["largest"] // dtype_bytes
    transient = elements * 4 + (elements * init_bytes
                                if init_bytes != 4 else 0)
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
                    "flash_attention_tc": 0,
                    "flash_attention_f32tc": _attn_blocks(run.model) * steps,
                    "decode_attention": 0,
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


class Training(NamedTuple):
    """What a train run takes besides its arch and shape: the weights'
    dtype, the ``ParallelConfig`` (remat, microbatches, moment dtype) and
    the ``TrainConfig`` (its ``steps`` is the run's own)."""
    dtype: Any
    parallel: Any
    train: Any


def float32_training() -> Training:
    """``lm_train``'s full-width run: float32 weights and moments,
    ``remat="dots"``, the default warm-up."""
    import torch
    from repro_torch.config import ParallelConfig, TrainConfig
    return Training(torch.float32, ParallelConfig(remat="dots",
                                                  opt_state_dtype="float32"),
                    TrainConfig())


def reference_training(parallel) -> Training:
    """The reference's training configuration with ``parallel``
    (``parallel_for``'s remat, microbatches and moment dtype): bfloat16
    weights (the float32 specs in float32) and no warm-up of the learning
    rate (``warmup_steps=0``: three bfloat16 steps under the default 20
    warm-up steps raise the loss, ``tests/test_torch_train_bf16.py``)."""
    import torch
    from repro_torch.config import TrainConfig
    return Training(torch.bfloat16, parallel, TrainConfig(warmup_steps=0))


def _train_full(dev, cfg, batch: int, seq: int, steps: int, models,
                training: Training, same_batch: bool = False) -> Dict:
    """(c) ``cfg`` at its published width and depth, seeded random weights
    and AdamW state as ``training`` gives them (``float32_training``,
    ``reference_training``), ``batch`` x ``seq`` tokens
    from ``TokenSource`` through ``make_train_step``, ``steps`` steps
    after one warm-up, the CARAT-on pipeline fed each measured step time
    (with ``same_batch`` every step takes the first batch, as the
    reference's rule that the loss falls trains on one batch).
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
    from repro_torch.config import (CaratConfig, DataConfig, RunConfig,
                                    ShapeConfig)
    from repro_torch.data import PFSDataPipeline, TokenSource, make_host_batch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models.lm import build_model
    from repro_torch.train import AdamWConfig, TrainState, make_train_step
    from repro_torch.train.step import _STATE_DTYPES, UPDATE_RANGE
    t0 = time.perf_counter()
    dtype, parallel = training.dtype, training.parallel
    model = build_model(cfg, device=dev, dtype=dtype)
    model.init(_generator(dev, 8))
    shape = ShapeConfig("full", seq, batch, "train")
    run = RunConfig(arch=cfg, shape=shape, parallel=parallel,
                    train=dataclasses.replace(training.train,
                                              steps=steps + 2))
    state = TrainState.init(model.param_tree(), AdamWConfig(
        state_dtype=_STATE_DTYPES[parallel.opt_state_dtype]))
    step_fn = make_train_step(model, run)
    sync(dev)
    init_s = time.perf_counter() - t0
    pipe = PFSDataPipeline(cfg, DataConfig(sample_bytes=2048 * 1024),
                           n_hosts=4, carat=CaratConfig(), models=models,
                           device=dev)
    source = TokenSource(cfg.vocab_size, seed=0)
    batches = [make_host_batch(cfg, seq, batch, source,
                               0 if same_batch else i)
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
    blocks = _attn_blocks(model) * parallel.microbatches
    forwards = k2_forward_runs(model, parallel.remat) * parallel.microbatches
    if cuda:
        # bfloat16 at a head dim of 16s: every forward launch on the
        # wgmma kernel (once more per block in backward under "full");
        # float32 on the split-TF32 kernel
        bf16 = dtype == torch.bfloat16
        tc = bf16 and k2_head_dim(cfg) % 16 == 0
        want = {"flash_attention": forwards * steps,
                "flash_attention_tc": forwards * steps if tc else 0,
                "flash_attention_f32tc": 0 if bf16 else forwards * steps,
                "decode_attention": 0,
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
           "k2_forward_runs_per_step": forwards,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "dtype": str(dtype).split(".")[-1], "remat": parallel.remat,
           "microbatches": parallel.microbatches,
           "opt_state_dtype": parallel.opt_state_dtype,
           "warmup_steps": run.train.warmup_steps,
           "batch": batch, "seq": seq,
           "tokens_per_step": batch * seq, "steps": steps,
           "same_batch": same_batch, "init_s": init_s,
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
            r"\bflash_attention(_tc|_f32tc)?_kernel\b")
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


@contextlib.contextmanager
def float64_path():
    """The model's float32 casts on the training path widened to
    float64 while active (the norms and rope, the router, the SSM and
    RG-LRU scans, attention's plain version with a float32-rounded
    ``d ** -0.5``, the cross-entropy): a float64 model then computes its
    loss and gradients in float64 throughout."""
    import torch
    from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                          attention_mask,
                                                          default_scale)
    from repro_torch.models import attention, layers, lm, moe, rglru, ssm

    def attention64(q, k, v, causal=True, window=0, scale=None):
        group = q.shape[1] // k.shape[1]
        scale = (scale if scale is not None
                 else default_scale(q.shape[-1], torch.float32))
        kx = k.repeat_interleave(group, dim=1)
        vx = v.repeat_interleave(group, dim=1)
        logits = torch.einsum("bhqd,bhkd->bhqk", q, kx) * scale
        mask = attention_mask(q.shape[2], k.shape[2], causal=causal,
                              window=window, device=q.device)
        logits = torch.where(mask[None, None], logits,
                             torch.tensor(NEG_INF, dtype=q.dtype))
        return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1),
                            vx)

    def xent64(logits, labels):
        lp = torch.log_softmax(logits, dim=-1)
        return -torch.take_along_dim(lp, labels.long()[..., None],
                                     dim=-1).mean()

    saved = [(mod, "F32", mod.F32) for mod in (layers, moe, rglru, ssm)]
    saved += [(lm, "_xent", lm._xent),
              (attention, "flash_attention", attention.flash_attention)]
    for mod, name, _ in saved[:4]:
        setattr(mod, name, torch.float64)
    lm._xent, attention.flash_attention = xent64, attention64
    try:
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


class _Updates:
    """While active, records what every AdamW update of the train step
    receives (it wraps ``repro_torch.train.step.adamw_update``, which the
    step looks up at each call): the gradients on the host, the learning
    rate, the optimizer's config and the clip, and (``before``) the
    parameters it starts from. :meth:`replay` runs those updates with
    the CPU's AdamW; :meth:`slack` bounds what the gradients' bars can
    move them."""

    def __init__(self):
        self.calls: List = []
        self.before: List = []

    def __enter__(self) -> "_Updates":
        import torch
        from repro_torch.train import step as step_mod
        from repro_torch.utils.tree import tree_leaves
        self._mod, self._update = step_mod, step_mod.adamw_update

        def recorded(params, grads, state, lr, cfg, grad_clip=0.0):
            self.calls.append(([g.detach().cpu() for g in grads],
                               torch.as_tensor(lr).cpu(), cfg, grad_clip))
            self.before.append([p.detach().cpu().clone()
                                for p in tree_leaves(params)])
            return self._update(params, grads, state, lr, cfg,
                                grad_clip=grad_clip)

        step_mod.adamw_update = recorded
        return self

    def __exit__(self, *exc) -> None:
        self._mod.adamw_update = self._update

    def replay(self, params: List) -> List:
        """Copies of the CPU tensors ``params`` after the recorded updates
        (the recorded gradients, learning rates, config and clip) by the
        CPU's AdamW from a fresh state of the recorded moment dtype."""
        from repro_torch.train import TrainState
        from repro_torch.train.optimizer import adamw_update
        state = TrainState.init([p.clone() for p in params],
                                self.calls[0][2])
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


def k2_head_dim(cfg) -> int:
    """The head dim K2 sees: MLA's query/key dim, else the arch's; 0
    for an arch without attention heads (the SSM)."""
    if cfg.mla is not None:
        return cfg.mla.qk_head_dim
    return cfg.resolved_head_dim if cfg.n_heads else 0


def k2_forward_runs(model, remat: str) -> int:
    """K2's forward launches in one train step of ``model``: each
    attention block's once, and each block of the stack once more under
    ``remat="full"`` (``torch.utils.checkpoint`` runs a block's forward
    again in backward; ``"dots"`` keeps K2's output); the MTP head's
    block is not rematerialized."""
    return _attn_blocks(model) + (_n_attn(model) if remat == "full" else 0)


# the archs of lm_train (e): every family beside granite's dense one at
# its reduced config; recurrentgemma at 3 layers, whose third block is
# its local attention (the reduced 2 are both RG-LRU blocks); danube's
# sliding window of 8 bites in its 64-token rows
PARITY_ARCHS = (("moonshot-v1-16b-a3b", None), ("deepseek-v3-671b", None),
                ("mamba2-370m", None), ("recurrentgemma-2b", 3),
                ("paligemma-3b", None), ("hubert-xlarge", None),
                ("h2o-danube-1.8b", None))


def parity_configs() -> List:
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
                  keep: Optional[Dict] = None, dtype: str = "float32",
                  parallel=None) -> Dict:
    """``steps`` train steps of reduced ``cfg`` on ``dev`` (K2 forward)
    and of the port on the CPU (the plain version), from the same
    ``dtype`` weights (``seeds``: the init's, the token source's), under
    ``parallel`` (a ``ParallelConfig``; ``remat="dots"`` where None),
    with no warm-up (``warmup_steps=0``): the first step already takes
    the peak learning rate, so every step moves the weights. The batches
    are the family's (``make_host_batch``: tokens, patches before them,
    frames), ``batch`` x ``seq``. The bars are the dtype's.

    float32: every step's loss at ``rel=1e-5`` and every parameter
    after the last step at ``atol=1e-5`` of the CPU's, the reference's
    bars (``tests/test_train.py:67-70``); every step's grad norm at
    ``rel=1e-4`` and each gradient of the first step (through the step's
    own loss function) within ``1e-5`` plus ``1e-4`` of its largest
    element, the CPU tests' bar (``tests/test_torch_train.py``: float32
    cancels digits in the embedding's input rows), and so every step's
    gradients as the step hands them to AdamW; the weights moved by more
    than ten times ``atol``. With ``slack``, an element whose CPU
    gradient lies within its bar of 0 at some step may lie further from
    the CPU's by what the gradient bars can move AdamW's steps there
    (:meth:`_Updates.slack`); reduced granite, lm_train (d), is held
    without it. Besides, the parameters at ``atol`` of the CPU's AdamW
    fed the gradients the card's steps computed (:meth:`_Updates.replay`:
    the card's optimizer step). Every MoE dispatch of both runs (the
    first step's gradient and the steps, recomputes included) with equal
    integer states (where one differs: its token, experts and router
    margin).

    bfloat16 (the reference's training configuration, with
    ``parallel_for``'s remat, microbatches and moment dtype;
    ``tests/test_torch_train_bf16.py``'s rule): each gradient every step
    hands AdamW, tensor by tensor, no farther from the float64 gradient
    of the weights it was taken at (``float64_grads``) than 3x the CPU's
    bfloat16 gradient is from its own float64 one, and the step's grad
    norm no farther from the float64 norm than 3x the CPU's gradient is
    in norm; every step's loss at ``rel=2e-2`` of the CPU's, parameters
    and moments after the last step at ``atol=2e-2`` (the bfloat16 bar of
    ``tests/test_kernels.py:32``); the card's parameters and moments
    against the CPU's AdamW fed the card's gradients, each element
    within one ulp of its dtype a step and at most 2 % of them apart (the
    two devices' float32 arithmetic may round an element's last bit
    apart, and the bfloat16 rounding then lands one value over); at
    least a tenth of the bfloat16 weights moved on the CPU. MoE:
    ``dispatch_flips`` of the two runs' dispatches, gated ``ok``; the
    loss beside a float32 forward of the same weights on the card.

    On the card, K2's forward launches (``k2_forward_runs`` a microbatch
    and step) all on its split-TF32 kernel in float32 and on its
    ``wgmma`` kernel in bfloat16 where the head dim is a multiple of 16
    (else SIMT), its backward op once per attention block (the MTP
    head's included) a microbatch and step, and K2 never on the CPU.
    ``keep``, where given, receives the runs before any gate is read
    (the initial weights, the batches, the run's config, the paths, each
    side's first gradients, parameters and, in float32, slack;
    ``chip_train_float64.py``)."""
    import torch
    from repro_torch.config import (ParallelConfig, RunConfig, ShapeConfig,
                                    TrainConfig)
    from repro_torch.data import TokenSource, make_host_batch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models.lm import build_model
    from repro_torch.train import (AdamWConfig, TrainState, make_loss_fn,
                                   make_train_step)
    from repro_torch.train.step import _STATE_DTYPES
    from repro_torch.utils.tree import tree_flatten_with_paths, tree_leaves
    t_run = time.perf_counter()
    cpu = torch.device("cpu")
    bf16 = dtype == "bfloat16"
    parallel = parallel or ParallelConfig(remat="dots")
    run = RunConfig(arch=cfg, shape=ShapeConfig("t", seq, batch, "train"),
                    parallel=parallel, train=TrainConfig(warmup_steps=0))
    source = TokenSource(cfg.vocab_size, seeds[1])
    batches = [make_host_batch(cfg, seq, batch, source, i)
               for i in range(steps)]
    host = build_model(cfg, device=cpu, dtype=getattr(torch, dtype))
    host.init(torch.Generator().manual_seed(seeds[0]))
    card = build_model(cfg, device=dev, dtype=getattr(torch, dtype))
    card.load_state_dict(host.state_dict())
    n_micro = parallel.microbatches
    init = [p.detach().clone() for p in tree_leaves(host.param_tree())]
    paths = [p for p, _ in tree_flatten_with_paths(host.param_tree())]
    out = {}
    for name, model in (("cpu", host), ("card", card)):
        step_fn = make_train_step(model, run)     # the parameters trainable
        state = TrainState.init(model.param_tree(), AdamWConfig(
            state_dtype=_STATE_DTYPES[parallel.opt_state_dtype]))
        with _Dispatches(keep_states=True) as disp:
            grads = None
            if not bf16:
                # the first step's gradients: the step's own loss function
                # (a parameter the loss does not read gets zeros, as in
                # the step)
                loss = make_loss_fn(model, run)(batches[0])
                grads = [g.cpu() for g in torch.autograd.grad(
                    loss, tree_leaves(state["params"]),
                    materialize_grads=True)]
            _reset_attn_launches()
            metrics = []
            with _Updates() as updates:
                for b in batches:
                    state, m = step_fn(state, b)
                    metrics.append(torch.stack([m["loss"], m["grad_norm"],
                                                m["lr"]]).float())
            k2 = _attn_launches()
            bwd = fa_kernel.backward_calls["flash_attention_backward"]
        out[name] = {"metrics": torch.stack(metrics).cpu().numpy(),
                     "grads": grads if grads is not None
                     else updates.calls[0][0],
                     "params": [p.detach().cpu()
                                for p in tree_leaves(state["params"])],
                     "moments": [[t.detach().cpu() for t in
                                  tree_leaves(state["opt"][mo])]
                                 for mo in ("m", "v")],
                     "k2": k2, "bwd": bwd, "dispatches": disp,
                     "updates": updates}
    got, want = out["card"], out["cpu"]
    what = f"{cfg.name} {dtype} on {dev}"
    rel = np.abs(got["metrics"] - want["metrics"]) / np.abs(want["metrics"])
    res = {"arch": cfg.name, "layers": cfg.n_layers, "steps": steps,
           "batch": batch, "seq": seq, "seeds": list(seeds),
           "dtype": dtype, "remat": parallel.remat,
           "microbatches": n_micro,
           "opt_state_dtype": parallel.opt_state_dtype,
           "warmup_steps": 0, "lr": want["metrics"][:, 2].tolist(),
           "losses_card": got["metrics"][:, 0].tolist(),
           "losses_cpu": want["metrics"][:, 0].tolist(),
           "loss_rel_err": float(rel[:, 0].max())}
    if bf16:
        res.update(_bf16_parity_gates(dev, cfg, what, got, want, init,
                                      paths, batches, n_micro))
    else:
        res.update(_f32_parity_gates(cfg, what, got, want, init, paths,
                                     batches, run, slack, keep))
    forwards = k2_forward_runs(host, parallel.remat) * n_micro * steps
    blocks = _attn_blocks(host) * n_micro * steps
    tc = bf16 and k2_head_dim(cfg) % 16 == 0
    res.update({"attention_blocks": _attn_blocks(host),
                "k2_forward_runs": forwards,
                "k2_kernel": ("none" if not forwards else "tc" if tc
                              else "simt" if bf16 else "f32tc"),
                "k2_launches_card": got["k2"]["flash_attention"],
                "k2_tc_launches_card": got["k2"]["flash_attention_tc"],
                "k2_launches_cpu": want["k2"]["flash_attention"],
                "flash_attention_backward_op_calls": got["bwd"]})
    if dev.type == "cuda":
        f32tc = 0 if bf16 else forwards
        gate(got["k2"]["flash_attention"] == forwards
             and got["k2"]["flash_attention_tc"] == (forwards if tc else 0)
             and got["k2"]["flash_attention_f32tc"] == f32tc
             and want["k2"]["flash_attention"] == 0,
             f"{what}: K2 launches {got['k2']} on the card, {want['k2']} "
             f"on the CPU, expected {forwards} ({res['k2_kernel']}) and 0")
        gate(got["bwd"] == blocks, f"{what}: {got['bwd']} calls of K2's "
             f"backward op, expected {blocks}")
    res["s"] = time.perf_counter() - t_run
    return res


def _f32_parity_gates(cfg, what: str, got: Dict, want: Dict, init: List,
                      paths: List, batches: List, run, slack: bool,
                      keep: Optional[Dict]) -> Dict:
    """``_train_parity``'s float32 bars (its docstring), gated; returns
    their readings."""
    loss_rel, grad_rel, atol = 1e-5, 1e-4, 1e-5
    steps = len(batches)
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
    res = {"grad_norm_rel_err": float(rel[:, 1].max()),
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
           "rel": loss_rel, "grad_rel": grad_rel, "atol": atol}
    if cfg.moe is not None:
        diff = want["dispatches"].difference(got["dispatches"])
        res["moe"] = {"dispatches": len(got["dispatches"].states),
                      "dispatch_states_equal": diff is None,
                      "first_difference": diff}
        gate(diff is None, f"{what}: a dispatch state differs from the "
                           f"CPU's: {diff}")
    return res


# the bfloat16 bars of the reference's training configuration
# (tests/test_torch_train_bf16.py): losses, parameters and moments at the
# bfloat16 bar of tests/test_kernels.py:32; gradients within 3x the
# yardstick's distance from float64; the card's AdamW against the CPU's on
# the card's gradients: one ulp a step, at most REPLAY_APART of the
# elements apart; at least MOVED_SHARE of the bfloat16 weights moved,
# five times REPLAY_APART, so that an update left undone fails the replay
# (at lr 3e-4 a weight moves only below ~0.1, where that is more than
# half its ulp: 20-30 % of the reduced archs' weights)
BF16_TRAIN_REL, BF16_TRAIN_ATOL, TIMES_YARDSTICK = 2e-2, 2e-2, 3.0
REPLAY_APART, MOVED_SHARE = 0.02, 0.1


def ulps_apart(a, b) -> np.ndarray:
    """Per element, how many values of ``a``'s dtype (bfloat16 or
    float32) lie between ``a`` and ``b`` (``b`` rounded to that dtype):
    the distance of their bit patterns taken as signed magnitudes."""
    import torch
    itype = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[
        a.dtype]
    bits = 8 * a.element_size() - 1

    def ordered(t):
        i = t.contiguous().view(itype).long()
        return torch.where(i < 0, -(i & ((1 << bits) - 1)), i)

    return (ordered(a) - ordered(b.to(a.dtype))).abs().numpy()


def _bf16_parity_gates(dev, cfg, what: str, got: Dict, want: Dict,
                       init: List, paths: List, batches: List,
                       n_micro: int) -> Dict:
    """``_train_parity``'s bfloat16 bars (its docstring), gated; returns
    their readings."""
    import torch
    from repro_torch.models.lm import build_model
    from repro_torch.utils.tree import tree_leaves
    steps = len(batches)
    rel = np.abs(got["metrics"] - want["metrics"]) / np.abs(want["metrics"])
    # every step's handed gradients against float64 at the weights each
    # side took them at, over 3x the CPU's distance
    ratio, norm_ratio, norms, losses64 = {}, [], [], []
    for k, (mine, theirs) in enumerate(zip(got["updates"].calls,
                                           want["updates"].calls)):
        b_card, b_cpu = got["updates"].before[k], want["updates"].before[k]
        loss64, t_card = float64_grads(cfg, b_card, batches[k], n_micro)
        losses64.append(loss64)
        t_cpu = (t_card if all(torch.equal(a, b)
                               for a, b in zip(b_card, b_cpu))
                 else float64_grads(cfg, b_cpu, batches[k], n_micro)[1])
        for path, a, b, tc, tp in zip(paths, mine[0], theirs[0], t_card,
                                      t_cpu):
            card_err = float(np.abs(a.double().numpy() - tc).max())
            cpu_err = float(np.abs(b.double().numpy() - tp).max())
            ratio[(k + 1, path)] = card_err / (TIMES_YARDSTICK * cpu_err
                                               + 1e-7)
        norm64 = float(np.sqrt(sum(float((t * t).sum()) for t in t_card)))
        cpu_dist = float(np.sqrt(sum(
            float(((b.double().numpy() - t) ** 2).sum())
            for b, t in zip(theirs[0], t_cpu))))
        norm_ratio.append(abs(float(got["metrics"][k, 1]) - norm64)
                          / (TIMES_YARDSTICK * cpu_dist))
        norms.append(norm64)
    worst = max(ratio, key=ratio.get)
    state_err = {name: max(_max_err(a, b) for a, b in zip(x, y))
                 for name, x, y in (("params", got["params"],
                                     want["params"]),
                                    ("m", got["moments"][0],
                                     want["moments"][0]),
                                    ("v", got["moments"][1],
                                     want["moments"][1]))}
    # the card's AdamW: the CPU's fed the card's gradients from the
    # initial weights and a fresh state
    replayed = got["updates"].replay(init)
    apart = [ulps_apart(a, b) for a, b in zip(got["params"], replayed)]
    most = max(int(u.max()) for u in apart)
    n = sum(u.size for u in apart)
    apart = sum(int((u > 0).sum()) for u in apart)
    moved = sum(int((a != b).sum()) for a, b in zip(want["params"], init)
                if a.dtype == torch.bfloat16)
    n_bf16 = sum(a.numel() for a in init if a.dtype == torch.bfloat16)
    dtypes = [sorted({str(t.dtype) for t in side["params"]})
              for side in (got, want)]
    gate(ratio[worst] <= 1.0, f"{what}: step {worst[0]}'s gradient of "
         f"{worst[1]} off float64 by {ratio[worst]} times 3x the CPU's "
         f"bfloat16 distance")
    gate(max(norm_ratio) <= 1.0, f"{what}: grad norms off the float64 "
         f"norms {norms} by {norm_ratio} times 3x the CPU's gradient's "
         f"distance")
    gate(float(rel[:, 0].max()) <= BF16_TRAIN_REL, f"{what}: losses off "
         f"the CPU's by {rel[:, 0].tolist()} (relative)")
    gate(max(state_err.values()) <= BF16_TRAIN_ATOL, f"{what}: parameters "
         f"or moments after {steps} steps off the CPU's by {state_err}")
    gate(dtypes[0] == dtypes[1], f"{what}: parameter dtypes {dtypes[0]} "
                                 f"on the card, {dtypes[1]} on the CPU")
    gate(most <= steps and apart <= REPLAY_APART * n, f"{what}: parameters "
         f"after {steps} steps off the CPU's AdamW on the card's gradients "
         f"by up to {most} ulps, {apart} of {n} elements apart")
    gate(moved >= MOVED_SHARE * n_bf16, f"{what}: the steps moved {moved} "
                                        f"of {n_bf16} bfloat16 weights only")
    with torch.no_grad():
        f32 = build_model(cfg, device=dev, dtype=torch.float32)
        for p, q in zip(tree_leaves(f32.param_tree()), init):
            p.copy_(q.float())
        loss32 = float(f32.loss(batches[0]))
    del f32
    res = {"param_dtypes": dtypes[0],
           "loss_float32_card": loss32, "losses_float64_cpu": losses64,
           "grad_norms_card": got["metrics"][:, 1].tolist(),
           "grad_norms_cpu": want["metrics"][:, 1].tolist(),
           "grad_norms_float64": norms,
           "grad_norm_err_over_bound": max(norm_ratio),
           "grad_worst": {"step": worst[0], "path": worst[1],
                          "err_over_bound": ratio[worst]},
           "state_max_abs_err": state_err,
           "replay": {"most_ulps": most, "elements_apart": apart,
                      "elements": n},
           "bf16_weights_moved_share": moved / max(n_bf16, 1),
           "rel": BF16_TRAIN_REL, "atol": BF16_TRAIN_ATOL,
           "times_yardstick": TIMES_YARDSTICK}
    if cfg.moe is not None:
        flips = dispatch_flips(want["dispatches"], got["dispatches"])
        res["moe"] = {"dispatches": len(got["dispatches"].states),
                      "dropped_card": got["dispatches"].dropped(),
                      "dropped_cpu": want["dispatches"].dropped(),
                      "flips": flips}
        gate(flips["ok"], f"{what}: a dispatch state differs from the "
                          f"CPU's where no router crossed: {flips}")
    return res


def float64_grads(cfg, leaves: List, batch: Dict, n_micro: int = 1
                  ) -> Tuple[float, List[np.ndarray]]:
    """The loss and gradients (NumPy, in tree order) of the weights
    ``leaves`` (tensors in ``LanguageModel.param_tree()``'s order) on
    ``batch``, in float64 on the CPU (``float64_path``), as the mean of
    ``n_micro`` microbatches as a train step takes them."""
    import torch
    from repro_torch.models.lm import build_model
    from repro_torch.utils.tree import tree_leaves
    model = build_model(cfg, device=torch.device("cpu"),
                        dtype=torch.float64)
    params = tree_leaves(model.param_tree())
    with torch.no_grad():
        for p, q in zip(params, leaves):
            p.copy_(q.detach().cpu().double())
    model.requires_grad_(True)
    rows = next(iter(batch.values())).shape[0] // n_micro
    loss, grads = 0.0, [0.0] * len(params)
    with float64_path():
        for i in range(n_micro):
            mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            lm = model.loss(mb)
            gs = torch.autograd.grad(lm, params, materialize_grads=True)
            loss += float(lm.detach()) / n_micro
            grads = [a + g.numpy() / n_micro for a, g in zip(grads, gs)]
    return loss, grads


def dispatch_flips(cpu: "_Dispatches", card: "_Dispatches") -> Dict:
    """Every MoE dispatch (both kept with ``keep_states``) whose integer
    state differs between the runs: per call, each token whose experts
    differ, with its router margin on the CPU (its k-th largest
    probability less the next) and the largest gap between the two
    runs' probabilities of that token. A state may differ only where a
    token's experts do and the two routers' probabilities cross there
    (the margin at most twice the gap); ``ok`` says whether every
    differing call is so."""
    import torch
    if len(cpu.states) != len(card.states):
        return {"ok": False, "calls": [len(cpu.states), len(card.states)]}
    calls, ok = [], True
    for c, (x, y) in enumerate(zip(cpu.states, card.states)):
        if all(torch.equal(a, b) for a, b in zip(x, y)):
            continue
        mine, theirs = cpu.experts[c], card.experts[c]
        k = mine.shape[-1]
        tokens = []
        for g, t in (mine.sort(-1).values
                     != theirs.sort(-1).values).any(-1).nonzero().tolist():
            p = cpu.probs[c][g, t].sort(descending=True).values
            margin = float(p[k - 1] - p[k])
            gap = float((cpu.probs[c][g, t]
                         - card.probs[c][g, t]).abs().max())
            tokens.append({"group": g, "token": t,
                           "experts": [mine[g, t].tolist(),
                                       theirs[g, t].tolist()],
                           "router_margin": margin, "prob_gap": gap})
        call_ok = bool(tokens) and all(
            tk["router_margin"] <= 2 * tk["prob_gap"] for tk in tokens)
        ok = ok and call_ok
        calls.append({"call": c, "ok": call_ok, "tokens": tokens[:8],
                      "n_tokens": len(tokens)})
    return {"ok": ok, "calls_differing": len(calls), "calls": calls[:8],
            "margins": sorted(tk["router_margin"] for cl in calls
                              for tk in cl["tokens"])[:16]}


def phase_flash_attention_train(dev, b: int, hq: int, hkv: int, d: int,
                                s: int, reps: int, causal: bool = True,
                                window: int = 0,
                                v_dim: Optional[int] = None,
                                arch: Optional[str] = None,
                                misaligned: bool = False,
                                dtype=None) -> Dict:
    """K2 on the training path: float32 (the split-TF32 kernel), with a
    gradient, causal, sliding or bidirectional; where ``v_dim < d``
    (MLA) v has ``v_dim`` columns zero-padded to ``d``, as the model
    pads it, the output's padded columns must be exactly 0 and the
    incoming gradient is 0 there (the model slices them off). q, k and
    v's gradients through K2's op against the plain version's autograd
    on ``dev``: the backward is the plain version's, so they must be
    equal; the forward within float32's tolerance, and timed (``reps``
    calls; the kernel and SDPA by graph replay, the wrapper's host time
    per call as ``call_ms``) beside its bound, the plain version's and
    SDPA's (a boolean mask for a window). The bound is the least time of float32-accurate
    work: three TF32 products a multiply-add at the TF32 rate, or the
    bytes (``bound_f32_ms``: the float32 rate outside the tensor cores).
    With ``misaligned``, q, k, v and the gradient are views one element
    into rows of ``d + 1``, which the rule sends to the SIMT kernel. At
    granite's shape: the kernel line's ``flash_attention_f32tc`` row
    (and, ``misaligned``, the SIMT kernel held to its plain version).
    With ``dtype=torch.bfloat16``, the reference's training type: the
    ``wgmma`` kernel's forward against the plain version at the
    bfloat16 bar and the row rule (``_check_close``), the gradients
    through K2's op (its backward op, the plain version's gradient at
    the forward's exact ``d ** -0.5``) equal to autograd through the
    plain version at that scale; the bound at the bfloat16 rate; the
    backward op and SDPA's forward and backward timed with CUDA events
    beside (``backward_ms``, ``library_backward_ms``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                          flash_attention_ref)
    t_phase = time.perf_counter()
    dtype = torch.float32 if dtype is None else dtype
    bf16 = dtype == torch.bfloat16
    v_dim = d if v_dim is None else v_dim
    kw = dict(causal=causal, window=window)
    if bf16:
        # the scale the op's forward and backward use on the card
        kw["scale"] = d ** -0.5
    g = _generator(dev, 10)
    q, k, v, grad = _randn(g, dev, dtype, (b, hq, s, d),
                           (b, hkv, s, d), (b, hkv, s, v_dim),
                           (b, hq, s, v_dim))
    v, grad = F.pad(v, (0, d - v_dim)), F.pad(grad, (0, d - v_dim))
    if misaligned:
        q, k, v, grad = (F.pad(t, (1, 0))[..., 1:] for t in (q, k, v, grad))
    kernel = fa.which_kernel(q, k, v)
    grads = {}
    before = dict(fa.launches)
    for name, fn in (("kernel", flash_attention),
                     ("plain", flash_attention_ref)):
        # leaves of their own; misaligned, the rows' first element
        # before each view (a clone of a view would be aligned)
        leaves = [(t._base if misaligned else t).clone().requires_grad_(True)
                  for t in (q, k, v)]
        qkv = [t[..., 1:] if misaligned else t for t in leaves]
        o = fn(*qkv, **kw)
        grads[name] = (o.detach(), torch.autograd.grad(o, leaves, grad))
    sync(dev)
    launches = _k2_launches(before)
    what = f"K2 training {arch or ''} D={d} window={window}"
    if dev.type == "cuda":
        want = "simt" if misaligned else ("tc" if bf16 else "f32tc")
        gate(kernel == want and launches == _k2_one(want),
             f"{what}: which_kernel {kernel}, launches {launches}")
    if bf16:
        close = _check_close(what, grads["kernel"][0], grads["plain"][0])
        fwd_err = close["max_abs_err"]
    else:
        close = {}
        fwd_err = _max_err(grads["kernel"][0], grads["plain"][0])
        gate(fwd_err <= ATOL["float32"], f"{what}: forward off by "
                                         f"{fwd_err}")
    grad_err = max(_max_err(x, y) for x, y in zip(grads["kernel"][1],
                                                  grads["plain"][1]))
    padded_zero = bool((grads["kernel"][0][..., v_dim:] == 0).all().item())
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
    extra = {}
    if bf16:
        # the backward op alone (the plain version's gradient), and
        # SDPA's forward and backward, with CUDA events
        saved = [t.detach().clone() for t in (q, k, v)]
        extra["backward_ms"] = time_ms(
            lambda: torch.ops.repro_torch.flash_attention_backward(
                grad, *saved, causal, window, kw["scale"]), dev,
            max(reps // 10, 1))
        leaves = [t.detach().clone().requires_grad_(True) for t in saved]

        def sdpa_fwd_bwd():
            o = _sdpa_gqa(*leaves, scale=kw["scale"], **lib_kw)
            torch.autograd.grad(o, leaves, grad)

        extra["library_backward_ms"] = time_ms(sdpa_fwd_bwd, dev,
                                               max(reps // 10, 1))
        extra["library_backward"] = ("scaled_dot_product_attention's "
                                     "forward and backward")
        del leaves, saved
    with torch.no_grad():
        # the kernel and SDPA by graph replay, as every kernel row; the
        # wrapper's host work per call beside it (call_ms)
        ms = graph_ms(lambda: flash_attention(q, k, v, **kw), dev, reps)
        call_ms = time_ms(lambda: flash_attention(q, k, v, **kw), dev, reps)
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, **kw), dev,
                           reps)
        library_ms, gqa_note = _library_ms(dev, reps, q, k, v,
                                           timer=graph_ms, **lib_kw)
    pairs = b * hq * _attn_pairs(s, s, causal, window)
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    if bf16:
        bounds = bound(nbytes, 4 * d * pairs, H100_BF16_OPS_PER_S)
    else:
        bounds = {**bound(nbytes, 3 * 4 * d * pairs, H100_TF32_OPS_PER_S),
                  "bound_f32_ms": bound(nbytes, 4 * d * pairs)["bound_ms"]}
    return {"phase": "flash_attention_train", "arch": arch,
            "shape": [b, hq, hkv, s, d], "v_dim": v_dim,
            "dtype": str(dtype).split(".")[-1], **close, **extra,
            "causal": causal, "window": window, "misaligned": misaligned,
            "kernel": kernel, "launches": launches,
            "max_abs_err": fwd_err, "grad_max_abs_err": grad_err,
            "padded_columns_zero": padded_zero,
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention ("
                       + ", ".join(n for n in (gqa_note, lib_note) if n)
                       + ")",
            **bounds, "phase_s": time.perf_counter() - t_phase}


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
                           models, float32_training())
    _free(dev)
    out["d"] = _train_parity(dev, reduced_config(get_arch("granite-3-2b")),
                             slack=False)
    out["d"]["qkv_grad"] = phase_flash_attention_train(
        dev, 8, full_cfg.n_heads, full_cfg.n_kv_heads,
        full_cfg.resolved_head_dim, full_seq, reps=20,
        arch=full_cfg.name)
    # the same on views one element off 16-byte alignment: the SIMT kernel
    out["d"]["qkv_grad_simt"] = phase_flash_attention_train(
        dev, 8, full_cfg.n_heads, full_cfg.n_kv_heads,
        full_cfg.resolved_head_dim, full_seq, reps=20,
        arch=full_cfg.name, misaligned=True)
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
    as it ends with its seconds: K2 with its gradient (float32, split
    TF32) at
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
                **_train_full(dev, cfg, batch, seq, steps, models,
                              float32_training())}

    for name in FULL_TRAIN_ARCHS:
        run(f"train_{name}", full, get_arch(name))
    return out


# lm_train's reference configuration for the MoE family: moonshot's
# depth such that its weights, gradients and AdamW moments (2 + 2 + 4 + 4
# bytes a parameter) fit this much of the 80 GB card, with the init's
# transient; the rest, ~20 GB, takes the activations of 1 x 4,096
# tokens under remat "full" (the logits over its 163,840-token vocab in
# bfloat16 and float32, one layer's plain attention backward) and
# AdamW's float32 copies of the 0.34 B-element embedding
MOE_TRAIN_BUDGET = 60e9
TRAIN_STATE_BYTES = 12


def reference_train_configs(get_arch) -> Dict:
    """What ``phase_reference_train`` runs: moonshot-v1-16b-a3b at its
    published width, cut in depth to ``MOE_TRAIN_BUDGET`` (``moe``), and
    the reduced archs of ``parity_configs`` and reduced
    command-r-plus-104b (``parity``), each with ``parallel_for`` of its
    published arch at ``train_4k``: the XXL settings (4 microbatches,
    bfloat16 moments) for deepseek-v3-671b and command-r-plus-104b."""
    from repro_torch.config import reduced_config
    from repro_torch.config.types import get_shape
    from repro_torch.launch.dryrun import parallel_for
    shape = get_shape("train_4k")
    moon = get_arch("moonshot-v1-16b-a3b")
    cut = depth_that_fits(moon, TRAIN_STATE_BYTES, MOE_TRAIN_BUDGET,
                          init_bytes=2)
    parity = [(cfg, parallel_for(get_arch(name), shape))
              for (name, _), cfg in zip(PARITY_ARCHS, parity_configs())]
    # deepseek-v3-671b's published 671 B parameters already give it the
    # XXL settings (4 microbatches, bfloat16 moments); command-r-plus's
    # 104 B do too
    xxl = [(reduced_config(get_arch("command-r-plus-104b")),
            parallel_for(get_arch("command-r-plus-104b"), shape))]
    return {"moe": {"published": moon,
                    "cfg": dataclasses.replace(moon, n_layers=cut["to"]),
                    "depth_cut": cut, "shape": shape, "batch": 1,
                    "steps": SHAPE_STEPS["train_4k"],
                    "parallel": parallel_for(moon, shape)},
            "parity": parity + xxl}


def phase_reference_train(dev, moe: Dict, parity: List, models) -> Dict:
    """The reference's training configuration beyond granite's train_4k
    cell (``reference_train_configs``): (b) the MoE family at full width
    for the first time: ``moe``'s arch cut in depth only, ``batch`` x
    ``seq_len`` tokens, ``steps`` steps on one batch (``_train_full``
    with its ``parallel``: bfloat16, remat "full", float32 moments, no
    warm-up), the loss finite and falling, K2 on its ``wgmma`` kernel,
    the assignments dropped at the published capacity factor in every
    dispatch of the run (forwards and recomputes), each call's drops
    also counted plainly from its expert loads and gated equal, and per
    layer of the first forward the drop share, the largest load over the
    capacity, the router's logit spread and how alike its tokens are
    (``_Dispatches.load_stats``); (c) one bfloat16 step
    of each ``parity`` arch on the card against the CPU
    (``_train_parity`` in bfloat16)."""
    t_phase = time.perf_counter()
    out: Dict = {"phase": "reference_train"}
    cfg = moe["cfg"]
    with _Dispatches(loads=True) as disp:
        full = _train_full(dev, cfg, moe["batch"], moe["shape"].seq_len,
                           moe["steps"], models,
                           reference_training(moe["parallel"]),
                           same_batch=True)
    losses = full["losses"]
    name = cell_name(moe["published"].name, moe["shape"].name)
    gate(losses[-1] < losses[0], f"{name}: the loss did not fall over "
                                 f"{moe['steps']} steps: {losses}")
    full.update({"cell": name, "depth_cut": moe["depth_cut"],
                 "reduced": shape_cuts(moe["published"], cfg, moe["shape"],
                                       moe["batch"]),
                 "moe": {"dispatches": len(disp.counts),
                         "assignments": disp.assignments(),
                         "dropped": disp.dropped(),
                         "dropped_share": disp.dropped()
                         / max(disp.assignments(), 1),
                         "capacity_factor": cfg.moe.capacity_factor,
                         "capacities": disp.capacities,
                         "loads": disp.load_stats(cfg.n_layers)}})
    out["moe_train"] = full
    _free(dev)
    out["parity"] = []
    for pcfg, parallel in parity:
        out["parity"].append(_train_parity(dev, pcfg, steps=1,
                                           dtype="bfloat16",
                                           parallel=parallel))
        _free(dev)
    out["phase_s"] = time.perf_counter() - t_phase
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


# ------------------------------------ the reference's own workload shapes
# the cells of the reference's SHAPES (config/types.py) run on one card,
# each named as the dry run names it, arch x shape, with the batch it is
# cut to: only the batch is cut, never the sequence or the widths
REFERENCE_CELLS = (("granite-3-2b", "prefill_32k", 1),
                   ("granite-3-2b", "decode_32k", 16),
                   ("granite-3-2b", "train_4k", 1),
                   ("mamba2-370m", "long_500k", 1),
                   ("recurrentgemma-2b", "long_500k", 1),
                   ("h2o-danube-1.8b", "long_500k", 1))
# the batch train_4k's probe tries first and the largest it tries (its
# step in the reference's configuration: bfloat16 weights, remat
# "full"); B 3 is the largest that fits an H100 80GB HBM3
TRAIN_PROBE_FROM, TRAIN_PROBE_MOST = 3, 8
# decode steps of the serving shapes (the last at position seq_len - 1)
# and train steps of train_4k
SHAPE_STEPS = {"decode_32k": 8, "long_500k": 16, "train_4k": 3}
# the rows of a decode batch start this many positions apart
RAGGED_STEP = 37
# the float32 card-against-CPU run of each decode shape: its layers (the
# hybrid takes its block pattern's 3, so that a local-attention block is
# in it), rows and steps
SHAPE_PARITY = {"decode_32k": {"layers": 2, "batch": 2, "steps": 1},
                "long_500k": {"layers": 2, "batch": 1, "steps": 4}}
# decode steps of a cell run again under the profiler for the device's
# busy time (reading a trace back costs host seconds a step)
SHAPE_TRACE_STEPS = 2
# query rows at each end of the prefill's K2 slice
PREFILL_SLICE_ROWS = 128
# the config fields a cut is read from
_CUT_FIELDS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
               "vocab_size", "sliding_window")


def cell_name(arch: str, shape: str) -> str:
    return f"{arch} x {shape}"


def shape_cuts(published, cfg, shape, batch: int) -> List[Dict]:
    """Every cut of a run from the reference's own cell, as ``{"what",
    "reference", "run"}``: the batch and sequence against the shape of
    that name in ``SHAPES``, then each width and depth field of ``cfg``
    (and the head dim) against ``published``'s."""
    from repro_torch.config.types import get_shape
    ref = get_shape(shape.name)
    pairs = [("batch", ref.global_batch, batch),
             ("seq_len", ref.seq_len, shape.seq_len)]
    pairs += [(f, getattr(published, f), getattr(cfg, f))
              for f in _CUT_FIELDS]
    if published.n_heads and cfg.n_heads:
        pairs.append(("head_dim", published.resolved_head_dim,
                      cfg.resolved_head_dim))
    return [{"what": what, "reference": want, "run": got}
            for what, want, got in pairs if want != got]


def fill_cache_(cache: List[Dict], generator, lengths) -> List[Dict]:
    """Seeded contents for a decode cache, in place: every floating
    tensor (keys, values, SSM, RG-LRU and conv states) drawn from N(0, 1)
    by ``generator``, layer by layer and each layer's names in sorted
    order; every ``length`` set to ``lengths``. Returns the cache."""
    import torch
    for layer in cache:
        for name in sorted(layer):
            t = layer[name]
            if name == "length":
                t.copy_(torch.as_tensor(lengths, dtype=torch.int32))
            else:
                t.normal_(generator=generator)
    return cache


def cache_keeper(cache: List[Dict], steps: int) -> List[Dict]:
    """Copies of what a run of ``steps`` decode steps changes and reads
    again: every state tensor and length, and a layer's keys and values
    only where some row's ring buffer fills within the steps. In a ring
    that does not fill, each step writes the slot past its row's length,
    which no earlier step of the run reads: a second run from the same
    lengths writes the same values there before reading them."""
    keep = []
    for layer in cache:
        lens = layer.get("length")
        fills = (lens is not None and "k" in layer
                 and int(lens.max()) + steps > layer["k"].shape[2])
        keep.append({name: t.clone() for name, t in layer.items()
                     if name not in ("k", "v") or fills})
    return keep


def restore_cache_(cache: List[Dict], keep: List[Dict]) -> None:
    for layer, kept in zip(cache, keep):
        for name, t in kept.items():
            layer[name].copy_(t)


def _plain_causal(q, k, v, chunk: int):
    """The plain version of causal attention over all of q's rows, in
    chunks of ``chunk`` rows, each against the keys it can see (the
    whole (S, S) logits of a 32k prefill would not fit the card)."""
    import torch
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    return torch.cat([flash_attention_ref(
        q[:, :, lo:lo + chunk], k[:, :, :lo + chunk], v[:, :, :lo + chunk],
        causal=True, q_offset=lo) for lo in range(0, q.shape[2], chunk)],
        dim=2)


class _Captured:
    """While active, wraps one attention op of ``repro_torch.models
    .attention`` (``flash_attention`` or ``decode_attention``, which the
    blocks look up at each call) and keeps the first call's operands and
    output: copies where the path writes them in place later (a decode
    cache), else the tensors themselves."""

    def __init__(self, name: str, copy: bool):
        self.name, self.copy = name, copy
        self.args: Optional[Dict] = None

    def __enter__(self) -> "_Captured":
        from repro_torch.models import attention
        self._mod, self._fn = attention, getattr(attention, self.name)

        def wrapped(q, k, v, *args, **kw):
            out = self._fn(q, k, v, *args, **kw)
            if self.args is None:
                keep = (lambda t: t.clone()) if self.copy else (lambda t: t)
                self.args = {"q": keep(q), "k": keep(k), "v": keep(v),
                             "out": keep(out),
                             "lengths": (keep(kw["lengths"])
                                         if "lengths" in kw else None)}
            return out

        setattr(attention, self.name, wrapped)
        return self

    def __exit__(self, *exc) -> None:
        setattr(self._mod, self.name, self._fn)


def k3_yardstick(dev, q, k, v, lengths, reps: int) -> Dict:
    """What K3's rows measure beside their kernel, at one call's operands:
    its ms by graph replay (a few microseconds of device time, so the
    wrapper's host work, ``call_ms`` where a row wants it, stays out),
    SDPA's with a length mask likewise, the plain version's by CUDA
    events, its splits, the blocks of its split kernel with keys to read,
    and the bound of the bytes the valid keys and the queries take."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as dec
    from repro_torch.kernels.decode_attention.kernel import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 132)
    tc = dec.takes_tensor_cores(q, k, v)
    ms = graph_ms(lambda: decode_attention(q, k, v, lengths), dev, reps)
    plain_ms = time_ms(lambda: decode_attention_ref(q, k, v, lengths), dev,
                       max(reps // 10, 1))
    mask = (torch.arange(s, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    library_ms, library_note = _library_ms(dev, reps, q[:, :, None], k, v,
                                           timer=graph_ms, attn_mask=mask)
    lens = [int(x) for x in lengths.tolist()]
    valid = sum(lens)
    splits = dec.decode_splits(b, hkv, hq // hkv, s, d, sms, tc)
    return {"splits": splits, "tensor_cores": tc,
            "blocks_with_work": dec.blocks_with_work(lens, hkv, hq // hkv,
                                                     splits, tc),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": f"scaled_dot_product_attention with a length mask "
                       f"({library_note})",
            **bound(k.element_size() * 2 * hkv * d * valid
                    + 2 * q.element_size() * q.numel() + 4 * b,
                    4 * d * hq * valid, H100_BF16_OPS_PER_S)}


def _cell_head(cell: Dict) -> Dict:
    published, cfg, shape = cell["published"], cell["cfg"], cell["shape"]
    return {"cell": cell_name(published.name, shape.name),
            "arch": published.name, "shape": shape.name,
            "seq_len": shape.seq_len, "batch": cell["batch"],
            "reference_batch": shape.global_batch,
            "params": cfg.param_count(), "layers": cfg.n_layers,
            "reduced": shape_cuts(published, cfg, shape, cell["batch"])}


def _peak(dev) -> Optional[int]:
    import torch
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None


def _prefill_cell(dev, cell: Dict, seed: int, reps: int) -> Dict:
    """``LanguageModel.prefill`` of ``batch`` x ``seq_len`` seeded tokens
    with seeded bfloat16 weights: a warm-up, the timed prefill (every
    attention block one launch of K2's ``wgmma`` kernel; last-token
    logits finite; peak bytes), one more traced for the device's busy
    time (its idle share against that prefill's wall time) whose first
    attention call, layer 0's K2, is kept; layer 0's K2 output against the
    plain version on the first and the last ``PREFILL_SLICE_ROWS`` query
    rows of the first and the last kv group's heads against every key
    (bfloat16 ``ATOL`` and the row rule); K2 at those operands by graph
    replay beside its bound, SDPA's time and the plain version's over
    every row in chunks."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models.lm import build_model
    cfg, shape, batch = cell["cfg"], cell["shape"], cell["batch"]
    out = _cell_head(cell)
    model = build_model(cfg, device=dev, dtype=torch.bfloat16)
    model.init(_generator(dev, seed))
    n_attn = _n_attn(model)
    s, v = shape.seq_len, cfg.vocab_size
    tokens = {"tokens": torch.from_numpy(
        rng(seed).integers(0, v, size=(batch, s))).to(dev)}
    cuda = dev.type == "cuda"
    with torch.inference_mode():
        model.prefill(tokens, s)                # warm-up
        sync(dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        _reset_attn_launches()
        t0 = time.perf_counter()
        logits = model.prefill(tokens, s)
        sync(dev)
        prefill_s = time.perf_counter() - t0
        launches = _attn_launches()
        peak = _peak(dev)
        finite = (tuple(logits.shape) == (batch, v)
                  and bool(torch.isfinite(logits).all().item()))
        del logits
        busy_ms = traced_s = None
        with _Captured("flash_attention", copy=False) as cap:
            if cuda:
                busy_ms, traced_s, _, _ = _device_busy_ms(
                    lambda: model.prefill(tokens, s), dev)
            else:
                model.prefill(tokens, s)
    gate(finite, f"{out['cell']}: last-token logits not finite (B, V)")
    if cuda:
        gate(launches == {"flash_attention": n_attn,
                          "flash_attention_tc": n_attn,
                          "flash_attention_f32tc": 0,
                          "decode_attention": 0},
             f"{out['cell']}: attention launches {launches}")
    a = cap.args
    q, k, vv, o = a["q"], a["k"], a["v"], a["out"]
    hkv, group = k.shape[1], q.shape[1] // k.shape[1]
    rows = min(PREFILL_SLICE_ROWS, s)
    kv_groups = sorted({0, hkv - 1})
    errs = []
    with torch.inference_mode():
        for g in kv_groups:
            heads = slice(g * group, (g + 1) * group)
            for lo in sorted({0, s - rows}):
                want = flash_attention_ref(
                    q[:, heads, lo:lo + rows], k[:, g:g + 1],
                    vv[:, g:g + 1], causal=True, q_offset=lo)
                errs.append(_check_close(
                    f"{out['cell']}: layer 0's K2, kv group {g}, rows "
                    f"{lo}..{lo + rows - 1}", o[:, heads, lo:lo + rows],
                    want))
        # K2 and SDPA by graph replay at layer 0's operands; the bound of
        # the bytes and of the pairs the causal mask keeps
        row = {"kernel": "flash_attention",
               "shape": [batch, q.shape[1], hkv, s, q.shape[-1]],
               "ms": graph_ms(lambda: flash_attention(q, k, vv), dev, reps),
               "library_ms": _library_ms(dev, reps, q, k, vv,
                                         timer=graph_ms, is_causal=True)[0],
               "plain_ms": time_ms(
                   lambda: _plain_causal(q, k, vv, chunk=1024), dev, 1),
               **bound(2 * (2 * q.numel() + k.numel() + vv.numel()),
                       4 * q.shape[-1] * batch * q.shape[1]
                       * _attn_pairs(s, s, True, 0), H100_BF16_OPS_PER_S)}
    row.update(max_abs_err=max(e["max_abs_err"] for e in errs),
               max_row_rel_err=max(e.get("max_row_rel_err", 0.0)
                                   for e in errs),
               launches=launches["flash_attention_tc"],
               plain="the plain version over every row, 1024 rows a chunk "
                     "against the keys they see",
               checked={"kv_groups": kv_groups, "rows": rows,
                        "row_starts": sorted({0, s - rows})})
    out.update({
        "prefill": {"ms": prefill_s * 1e3,
                    "tokens_per_s": batch * s / prefill_s,
                    "launches": launches, "peak_device_bytes": peak,
                    "device_busy_ms": busy_ms,
                    # against the traced prefill's own wall time
                    "device_idle_share": (None if busy_ms is None else
                                          1.0 - busy_ms / (traced_s * 1e3))},
        "kernels": [row],
        "path_launches": {"flash_attention": launches["flash_attention_tc"]}})
    return out


def _decode_parity(dev, cell: Dict, seed: int) -> Dict:
    """``cell``'s arch at its width cut to ``layers`` layers, float32 (TF32
    off), the same seeded weights and cache on the card and on the CPU:
    ``steps`` decode steps from lengths ``seq_len - steps - RAGGED_STEP *
    i`` at positions ``seq_len - steps`` on, both fed the CPU's greedy
    tokens; every step's logits at ``DECODE_ATOL``. On the card each
    attention block launches K3's SIMT split kernel (float32) once a
    step."""
    import torch
    from repro_torch.models.lm import build_model
    p = cell["parity"]
    shape, published = cell["shape"], cell["published"]
    cfg = dataclasses.replace(cell["cfg"], n_layers=p["layers"])
    batch, steps = p["batch"], p["steps"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    host = build_model(cfg, device=cpu, dtype=torch.float32)
    host.init(torch.Generator().manual_seed(seed))
    card = build_model(cfg, device=dev, dtype=torch.float32)
    card.load_state_dict(host.state_dict())
    start = shape.seq_len - steps
    lengths = [start - RAGGED_STEP * i for i in range(batch)]
    h_cache = fill_cache_(host.init_cache(batch, shape.seq_len,
                                          dtype=torch.float32),
                          torch.Generator().manual_seed(seed + 1), lengths)
    c_cache = [{k: t.to(dev, copy=True) for k, t in layer.items()}
               for layer in h_cache]
    n_attn = _n_attn(host)
    tokens = torch.from_numpy(rng(seed).integers(0, cfg.vocab_size,
                                                 size=batch))
    errs = []
    _reset_attn_launches()
    before = dict(_attn_kernels()[1].variants)
    with torch.inference_mode():
        for j in range(steps):
            pos = torch.full((batch,), start + j, dtype=torch.int32)
            want, h_cache = host.decode_step(tokens, h_cache, pos)
            got, c_cache = card.decode_step(tokens.to(dev), c_cache,
                                            pos.to(dev))
            errs.append(_max_err(got.cpu(), want))
            tokens = torch.argmax(want, dim=-1)
    launches = _attn_launches()
    variants = {n: c - before[n]
                for n, c in _attn_kernels()[1].variants.items()}
    what = f"{cell_name(published.name, shape.name)} float32 card vs CPU"
    gate(max(errs) <= DECODE_ATOL, f"{what}: logits off by {max(errs)}")
    if dev.type == "cuda":
        gate(launches["decode_attention"] == n_attn * steps
             and variants == {"tensor_core": 0, "simt": n_attn * steps},
             f"{what}: K3 launches {launches}, split kernels {variants}")
    return {"layers": cfg.n_layers, "attention_layers": n_attn,
            "batch": batch, "steps": steps, "lengths": lengths,
            "positions": [start, start + steps - 1], "dtype": "float32",
            "reduced": shape_cuts(published, cfg, shape, batch),
            "max_abs_err": max(errs), "per_step_max_abs_err": errs,
            "atol": DECODE_ATOL, "decode_attention_launches":
            launches["decode_attention"], "variants": variants,
            "s": time.perf_counter() - t0}


def _decode_cell(dev, cell: Dict, seed: int, reps: int) -> Dict:
    """``decode_step`` through ``ServeEngine.run_steps`` with seeded
    bfloat16 weights over a seeded bfloat16 cache of ``seq_len``
    positions (ring buffers of the window where there is one), every
    state drawn from the generator: ``steps`` steps at positions
    ``seq_len - steps`` on (the last at ``seq_len - 1``), row ``i``'s
    cache holding ``seq_len - steps - RAGGED_STEP * i`` positions (a
    sliding window's ring full), each step's tokens the greedy pick of
    the step before (the first step's from seeded logits). Three runs
    from the same state (``cache_keeper``): a warm-up that keeps the
    first K3 call's operands and output, the timed run (launches and
    peak bytes counted from just before it), and its first
    ``SHAPE_TRACE_STEPS`` steps traced for the device's busy time; every
    run's tokens equal the timed run's. Gates: every step's logits
    finite, each attention block one K3 launch a step on the tensor-core
    split kernel, the kept K3 output against the plain version
    (bfloat16 ``ATOL`` and the row rule), and the float32 card-vs-CPU run
    (``_decode_parity``)."""
    import torch
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.models.lm import build_model
    from repro_torch.serve import Request, ServeEngine
    cfg, shape, batch = cell["cfg"], cell["shape"], cell["batch"]
    steps = cell["steps"]
    out = _cell_head(cell)
    cuda = dev.type == "cuda"
    model = build_model(cfg, device=dev, dtype=torch.bfloat16)
    model.init(_generator(dev, seed))
    n_attn = _n_attn(model)
    start = shape.seq_len - steps
    lengths = [start - RAGGED_STEP * i for i in range(batch)]
    cache = fill_cache_(model.init_cache(batch, shape.seq_len,
                                         dtype=torch.bfloat16),
                        _generator(dev, seed + 1), lengths)
    sync(dev)
    keep = cache_keeper(cache, steps)
    cache_bytes = sum(t.numel() * t.element_size() for layer in cache
                      for t in layer.values())
    engine = ServeEngine(model, cache_len=shape.seq_len,
                         cache_dtype=torch.bfloat16)
    first = torch.randn((batch, cfg.vocab_size),
                        generator=_generator(dev, seed + 2), device=dev)
    step = model.decode_step

    def run(stop: int) -> Tuple[List, List, float]:
        """The steps from ``start`` to ``stop`` from the kept state: the
        requests' tokens, each step's logits, seconds."""
        restore_cache_(cache, keep)
        reqs = [Request(prompt=[0], max_new_tokens=steps)
                for _ in range(batch)]
        seen: List = []

        def checked(tokens, c, pos):
            logits, c = step(tokens, c, pos)
            seen.append(logits)
            return logits, c

        model.decode_step = checked
        sync(dev)
        t0 = time.perf_counter()
        engine.run_steps(reqs, engine.prompt_rows(reqs), cache, start,
                         stop, logits=first)
        tokens = torch.argmax(seen[-1], dim=-1)
        sync(dev)
        secs = time.perf_counter() - t0
        del model.decode_step
        return [r.out_tokens + [int(t)] for r, t in zip(
            reqs, tokens.tolist())], seen, secs

    with torch.inference_mode():
        with _Captured("decode_attention", copy=True) as cap:
            warm_tokens, _, _ = run(shape.seq_len)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        _reset_attn_launches()
        variants_before = dict(_attn_kernels()[1].variants)
        tokens, seen, secs = run(shape.seq_len)
        launches = _attn_launches()
        variants = {n: c - variants_before[n]
                    for n, c in _attn_kernels()[1].variants.items()}
        peak = _peak(dev)
        finite = bool(torch.stack([torch.isfinite(x).all()
                                   for x in seen]).all().item())
        del seen
        busy_ms, traced_tokens = None, None
        n_trace = min(SHAPE_TRACE_STEPS, steps)
        with (_traced(dev) if cuda else contextlib.nullcontext()) as prof:
            traced_tokens, _, _ = run(start + n_trace)
        if cuda:
            busy_ms, heaviest = _Trace.of(prof).device(top=8)
    what = out["cell"]
    gate(finite, f"{what}: a decode step's logits are not finite")
    gate(warm_tokens == tokens, f"{what}: the warm-up run's tokens differ "
                                f"from the timed run's")
    gate([t[:n_trace] for t in traced_tokens]
         == [t[:n_trace] for t in tokens],
         f"{what}: the traced steps' tokens differ from the timed run's")
    if cuda:
        gate(launches == {"flash_attention": 0, "flash_attention_tc": 0,
                          "flash_attention_f32tc": 0,
                          "decode_attention": n_attn * steps}
             and variants == {"tensor_core": n_attn * steps, "simt": 0},
             f"{what}: attention launches {launches}, split kernels "
             f"{variants}")
    ms = secs * 1e3 / steps
    out["decode"] = {
        "steps": steps, "positions": [start, shape.seq_len - 1],
        "lengths": lengths, "cache_bytes": cache_bytes,
        "ms_per_step": ms, "tokens_per_s": batch / (ms / 1e3),
        "launches": launches, "variants": variants,
        "peak_device_bytes": peak, "traced_steps": n_trace,
        "device_busy_ms_per_step": (None if busy_ms is None
                                    else busy_ms / n_trace),
        "device_idle_share": (None if busy_ms is None
                              else 1.0 - busy_ms / n_trace / ms),
        "heaviest_device_ms": heaviest if busy_ms is not None else None,
        "first_tokens": tokens[0][:4]}
    out["kernels"] = []
    if cap.args is not None:
        a = cap.args
        with torch.inference_mode():
            close = _check_close(f"{what}: the first K3 call",
                                 a["out"], decode_attention_ref(
                                     a["q"], a["k"], a["v"], a["lengths"]))
            q, k = a["q"], a["k"]
            row = {"kernel": "decode_attention",
                   "shape": [*q.shape[:2], *k.shape[1:]],
                   "dtype": str(k.dtype).split(".")[-1],
                   "lengths": a["lengths"].tolist(),
                   **k3_yardstick(dev, q, k, a["v"], a["lengths"], reps),
                   **close, "launches": launches["decode_attention"]}
        out["kernels"].append(row)
        del cap.args
    out["path_launches"] = {"decode_attention": launches["decode_attention"]}
    del cache, keep, model
    _free(dev)
    out["parity"] = _decode_parity(dev, cell, seed + 3)
    return out


def _train_batch_probe(dev, cfg, batch: int, seq: int,
                       training: Training) -> Dict:
    """One step of ``_train_full``'s model, state and train step at
    ``batch`` x ``seq`` under ``training`` (no pipeline, no warm-up):
    whether it fits the card, and the peak bytes it reached, at its end
    or where it ran out of memory."""
    import torch
    from repro_torch.config import RunConfig, ShapeConfig
    from repro_torch.data import TokenSource, make_host_batch
    from repro_torch.models.lm import build_model
    from repro_torch.train import AdamWConfig, TrainState, make_train_step
    from repro_torch.train.step import _STATE_DTYPES
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    dtype, parallel = training.dtype, training.parallel
    error = None
    model = state = step_fn = None
    try:
        model = build_model(cfg, device=dev, dtype=dtype)
        model.init(_generator(dev, 8))
        run = RunConfig(arch=cfg, shape=ShapeConfig("full", seq, batch,
                                                    "train"),
                        parallel=parallel,
                        train=dataclasses.replace(training.train, steps=1))
        state = TrainState.init(model.param_tree(), AdamWConfig(
            state_dtype=_STATE_DTYPES[parallel.opt_state_dtype]))
        step_fn = make_train_step(model, run)
        tokens = make_host_batch(cfg, seq, batch,
                                 TokenSource(cfg.vocab_size, seed=0), 0)
        state, _ = step_fn(state, tokens)
        sync(dev)
    except (torch.cuda.OutOfMemoryError, RuntimeError) as e:
        # cuBLAS reports a refused workspace as a RuntimeError
        first = str(e).splitlines()[0]
        if not isinstance(e, torch.cuda.OutOfMemoryError) and not any(
                word in first for word in ("out of memory", "ALLOC_FAILED")):
            raise
        error = first
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    del model, state, step_fn
    _free(dev)
    return {"batch": batch, "seq": seq, "fits": error is None,
            "peak_device_bytes": peak, "error": error}


def _largest_batch(dev, cfg, seq: int, training: Training, first: int,
                   most: int) -> Tuple[int, List[Dict]]:
    """The largest batch up to ``most`` whose one step under ``training``
    fits the card (``_train_batch_probe``): probed at ``first``, then a
    batch at a time up while it fits or down until it does (a batch of 1
    is taken to fit). Returns that batch and every probe, in order."""
    probes = [_train_batch_probe(dev, cfg, first, seq, training)]
    if probes[0]["fits"]:
        batch = first
        while batch < most:
            probes.append(_train_batch_probe(dev, cfg, batch + 1, seq,
                                             training))
            if not probes[-1]["fits"]:
                break
            batch += 1
        return batch, probes
    batch = first - 1
    while batch > 1:
        probes.append(_train_batch_probe(dev, cfg, batch, seq, training))
        if probes[-1]["fits"]:
            break
        batch -= 1
    return max(batch, 1), probes


def _train_cell(dev, cell: Dict, seed: int, reps: int, models) -> Dict:
    """The launcher's train step in the reference's training
    configuration (``_train_full`` with ``parallel_for`` of the
    published arch and shape: bfloat16 weights, ``remat="full"``, its
    microbatches and moment dtype, no warm-up of the learning rate) at
    the largest batch one step fits (``_largest_batch``, from
    ``cell["probe_from"]`` up to ``cell["most"]``; the probe past it is
    ``next_batch``)
    x ``seq_len``, ``steps`` steps on one batch: losses finite and
    falling, the reference's rule (``tests/test_train.py:73-87``), K2's
    forward launches all on its ``wgmma`` kernel (twice a block a step
    under ``"full"``) and its backward op once a block a step; K2's
    ``wgmma`` kernel and its backward op at the cell's operands
    (``phase_flash_attention_train`` in bfloat16, the row); and one
    bfloat16 step of ``parity_cfg`` at the same length on the card
    against the CPU (``_train_parity``'s bfloat16 bars)."""
    import torch
    from repro_torch.launch.dryrun import parallel_for
    cfg, shape = cell["cfg"], cell["shape"]
    parallel = parallel_for(cell["published"], shape)
    training = reference_training(parallel)
    batch, probes = _largest_batch(dev, cfg, shape.seq_len, training,
                                   cell["probe_from"], cell["most"])
    cell = dict(cell, batch=batch)
    out = _cell_head(cell)
    out["parallel"] = {"remat": parallel.remat,
                       "microbatches": parallel.microbatches,
                       "opt_state_dtype": parallel.opt_state_dtype}
    out["batch_probes"] = probes
    past = [p for p in probes if p["batch"] == batch + 1]
    if past:
        out["next_batch"] = past[0]
    full = _train_full(dev, cfg, batch, shape.seq_len, cell["steps"], models,
                       training, same_batch=True)
    losses = full["losses"]
    gate(losses[-1] < losses[0], f"{out['cell']}: the loss did not fall "
                                 f"over {cell['steps']} steps: {losses}")
    out["train"] = full
    _free(dev)
    k2 = phase_flash_attention_train(
        dev, batch, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
        shape.seq_len, reps=reps, arch=cfg.name, dtype=torch.bfloat16)
    k2.update(kernel="flash_attention", compared_launches=k2.pop("launches"),
              launches=full["launches"]["flash_attention_tc"])
    out["kernels"] = [k2]
    _free(dev)
    pcfg = cell["parity_cfg"]
    # one row: the CPU's float64 side holds (4, 4096, 4096) float64
    # logits and their gradients a row
    par = _train_parity(dev, pcfg, steps=1, seq=shape.seq_len, batch=1,
                        dtype="bfloat16", parallel=parallel)
    par["reduced"] = shape_cuts(cell["published"], pcfg, shape, 1)
    out["parity"] = par
    out["path_launches"] = {"flash_attention":
                            full["launches"]["flash_attention_tc"]
                            + par["k2_launches_card"]}
    return out


def reference_cells(get_arch) -> List[Dict]:
    """``REFERENCE_CELLS`` as the phase runs them: each arch at its
    published width and depth, the shape of ``SHAPES``, the batch cut
    (train_4k's: its probe's first batch and largest, ``probe_from``
    and ``most``), the steps, and the card-vs-CPU run (a decode shape's
    ``SHAPE_PARITY``; train_4k's at ``reduced_config`` widths: at full
    width and 2 layers the CPU's side takes ~56 s a forward and
    backward on 8 cores, four of them a run)."""
    from repro_torch.config import reduced_config
    from repro_torch.config.types import get_shape
    cells = []
    for arch, shape, batch in REFERENCE_CELLS:
        cfg = get_arch(arch)
        cell = {"published": cfg, "cfg": cfg, "shape": get_shape(shape),
                "batch": batch, "steps": SHAPE_STEPS.get(shape)}
        if shape == "train_4k":
            cell["parity_cfg"] = reduced_config(cfg)
            cell["probe_from"] = TRAIN_PROBE_FROM
            cell["most"] = TRAIN_PROBE_MOST
        elif shape in SHAPE_PARITY:
            cell["parity"] = dict(SHAPE_PARITY[shape])
            if cfg.rglru is not None:
                cell["parity"]["layers"] = len(cfg.rglru.block_pattern)
        cells.append(cell)
    return cells


def phase_reference_shapes(dev, cells: List[Dict], models, seed: int = 40,
                           reps: int = 3) -> Dict:
    """The reference's own workload shapes through the port's entry
    points on ``dev``, one cell after another (``reference_cells``):
    ``prefill`` cells by ``_prefill_cell``, ``decode`` and
    ``long_decode`` ones by ``_decode_cell``, ``train`` ones by
    ``_train_cell``. Each cell reports its cuts (``reduced``), times,
    peak bytes and idle share, its kernels at the path's operands
    (``kernels``) and its launches on the path (``path_launches``, for
    the kernel line's sums)."""
    t_phase = time.perf_counter()
    out: Dict = {"phase": "reference_shapes", "cells": {}}
    for i, cell in enumerate(cells):
        t0 = time.perf_counter()
        kind = cell["shape"].kind
        if kind == "prefill":
            res = _prefill_cell(dev, cell, seed + 10 * i, reps)
        elif kind in ("decode", "long_decode"):
            res = _decode_cell(dev, cell, seed + 10 * i, reps)
        else:
            res = _train_cell(dev, cell, seed + 10 * i, reps, models)
        res["s"] = time.perf_counter() - t0
        out["cells"][res["cell"]] = res
        _free(dev)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def shape_summary(shapes: Dict) -> Dict:
    """Each cell's cuts, ms, tokens/s, peak bytes and idle share, its
    kernels' ms, bound and SDPA's time, and a train cell's probe of the
    next batch, for the end of the output."""
    rows = {}
    for name, c in shapes["cells"].items():
        run = c.get("prefill") or c.get("decode") or c.get("train")
        ms = run.get("ms", run.get("ms_per_step"))
        idle = run.get("device_idle_share")
        if idle is None and "profiled" in run:
            idle = run["profiled"].get("device_idle_share")
        rows[name] = {"reduced": c["reduced"], "ms": ms,
                      "peak_device_bytes": run.get("peak_device_bytes"),
                      "device_idle_share": idle,
                      "kernels": [[k["kernel"], k["ms"], k["bound_ms"],
                                   k["library_ms"], k["launches"]]
                                  for k in c["kernels"]]}
        if "next_batch" in c:
            rows[name]["next_batch"] = c["next_batch"]
    return rows


def ref_train_launches(ref_train: Dict) -> int:
    """K2's ``wgmma`` launches on ``phase_reference_train``'s paths: the
    MoE arch's full-width steps and the card's side of every bfloat16
    step against the CPU."""
    return (ref_train["moe_train"]["launches"]["flash_attention_tc"]
            + sum(r["k2_tc_launches_card"] for r in ref_train["parity"]))


def summary_line(nvidia_smi: List[str], serves: List[Dict],
                 parity_runs: List[Dict], full_runs: List[Dict],
                 shapes: Optional[Dict] = None,
                 ref_train: Optional[Dict] = None) -> Dict:
    """What the end of the output, all that is kept of a whole run, must
    show: the card; each served arch's cache buffers at their addresses
    through generate and through its tail's replay; each arch trained on
    the card against the CPU, its worst loss and gradient errors over
    their bars and the calls of K2's backward op; each arch trained at
    full width, its ms per step, idle share and backward op calls; each
    cell of the reference's shapes (``shape_summary``)."""
    return {"phase": "summary", "nvidia_smi": nvidia_smi,
            "reference_shapes": shape_summary(shapes) if shapes else None,
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
                for r in full_runs},
            "reference_train": None if ref_train is None else {
                "moe_train": {k: ref_train["moe_train"].get(k) for k in (
                    "cell", "layers", "ms_per_step", "tokens_per_s",
                    "adamw_ms", "peak_device_bytes", "losses")} | {
                    "device_idle_share": ref_train["moe_train"][
                        "profiled"].get("device_idle_share"),
                    "dropped_share": ref_train["moe_train"]["moe"][
                        "dropped_share"],
                    "by_layer": [
                        [r["dropped_share"], r["tokens_mean_cosine"]]
                        for r in ref_train["moe_train"]["moe"]["loads"][
                            "first_forward_by_layer"]]},
                "bf16_parity": {
                    r["arch"] + (" xxl" if r["microbatches"] > 1 else ""): {
                        "grad_over_bar": r["grad_worst"]["err_over_bound"],
                        "norm_over_bar": r["grad_norm_err_over_bound"],
                        "loss_rel_err": r["loss_rel_err"],
                        "losses_bf16_f32_f64": [r["losses_card"][0],
                                                r["loss_float32_card"],
                                                r["losses_float64_cpu"][0]],
                        "replay_ulps": r["replay"]["most_ulps"],
                        "moved_share": r["bf16_weights_moved_share"],
                        "flips": (r["moe"]["flips"]["calls_differing"]
                                  if "moe" in r else None)}
                    for r in ref_train["parity"]}}}


def kernel_line(phases: Dict[str, Dict], launches: Dict[str, int],
                shapes: Optional[Dict] = None) -> Dict:
    """One row per kernel: ``phases[name]`` holds its comparison with the
    plain version and its times, ``launches[name]`` its launches on the
    paths that drive it. Then, from the ``reference_shapes`` phase
    (``shapes``), one row per kernel of each cell, named ``kernel
    [arch x shape]``, with its launches on that cell's path."""
    rows = []

    def row(name: str, kernel: str, ph: Dict, n: int) -> Dict:
        source, replaces = KERNELS[kernel]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": ph["max_abs_err"], "ms": ph["ms"],
                "plain_ms": ph["plain_ms"], "bound_ms": ph["bound_ms"],
                "bound_by": ph["bound_by"],
                "library_ms": ph.get("library_ms")}

    for name in KERNELS:
        rows.append(row(name, name, phases[name], launches[name]))
    for cell, res in (shapes or {"cells": {}})["cells"].items():
        for k in res["kernels"]:
            rows.append(row(f"{k['kernel']} [{cell}]", k["kernel"], k,
                            k["launches"]))
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
    # width, depth 24 of 48, and deepseek-v3-671b at full width, depth 1
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

    # the reference's own workload shapes (config/types.py SHAPES), batch
    # cut only: granite-3-2b's prefill_32k, decode_32k and train_4k, and
    # long_500k decode of the three sub-quadratic archs
    shapes = phase_reference_shapes(dev, reference_cells(get_arch),
                                    {"read": m_read, "write": m_write})
    emit(shapes)
    _free(dev)

    # the reference's training configuration beyond train_4k: the MoE
    # family at full width (moonshot, depth cut), and one bfloat16 step
    # of every reduced family on the card against the CPU
    rt = reference_train_configs(get_arch)
    ref_train = phase_reference_train(dev, rt["moe"], rt["parity"],
                                      {"read": m_read, "write": m_write})
    emit(ref_train)
    _free(dev)

    # each kernel's launches summed over the paths that drive it: K1 and
    # K1b on the CARAT runs and the training pipelines; K2's wgmma
    # kernel in the bf16 prefills (granite's, the MoE family's, the
    # hybrid's, the VLM's, internlm2's and command-r-plus's), hubert's
    # encode and the bf16 train steps (train_4k's cell, moonshot's
    # full-width steps, the card's side of the bf16 steps against the
    # CPU), its split-TF32 kernel in every float32 train step on the
    # card ((a), (c) of granite and of the four families, the card's side
    # of (d) and (e); the wgmma kernel is gated at 0 there), each row
    # beside its own kernel's timing (granite's shapes); K3 in generate
    # (granite's, moonshot's, the hybrid's, the VLM's and the dense
    # archs'; MLA's decode and mamba2's launch none)
    serves = [serve] + moe_serves + [family[f"serve_{name}"] for name in (
        "mamba2-370m", "recurrentgemma-2b", "paligemma-3b")] + [
        dense[f"serve_{name}"] for name in (
            "internlm2-20b", "command-r-plus-104b")]
    emit(summary_line(device["nvidia_smi"], serves, parity_runs,
                      full_runs, shapes, ref_train))
    # the reference shapes' launches, in each kernel's sum
    by_shapes = {name: sum(c["path_launches"].get(name, 0)
                           for c in shapes["cells"].values())
                 for name in KERNELS}
    line = kernel_line(
        {"gbdt_logits": logits_small, "gbdt_grid_logits": grid,
         "flash_attention": fa,
         "flash_attention_f32tc": train["d"]["qkv_grad"],
         "decode_attention": dec},
        {name: gbdt_launches[name] + sum(r[name] for r in train_runs)
         for name in gbdt_launches} | {
         "flash_attention": sum(
             r["prefill"]["launches"]["flash_attention_tc"] for r in serves)
         + family["encode"]["launches"]["flash_attention_tc"]
         + by_shapes["flash_attention"] + ref_train_launches(ref_train),
         "flash_attention_f32tc": sum(r["flash_attention_f32tc"]
                                      for r in train_runs)
         + sum(r["k2_launches_card"] for r in parity_runs)
         + by_shapes["flash_attention_f32tc"],
         "decode_attention": sum(
             r["generate"]["launches"]["decode_attention"]
             for r in serves) + by_shapes["decode_attention"]}, shapes)
    for row in line["kernels"]:
        gate(row["launches"] > 0, f"{row['name']}: no launch on its path")
    emit(line)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
