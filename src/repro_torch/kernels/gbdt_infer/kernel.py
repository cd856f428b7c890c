"""Build, binding and launch of the GBDT CUDA kernels (``csrc/gbdt_infer.cu``).

``gbdt_logits`` replaces the Pallas TPU kernel
``repro/kernels/gbdt_infer/kernel.py::_gbdt_kernel`` (launched by
``gbdt_logits_pallas``); ``gbdt_grid_logits`` is the factorized fleet
path that the reference runs as ``GridGBDTScorer._predict_numpy``. The
source's header says what bounds each kernel on the card and what its
design does about it.

The library is built and bound by :mod:`repro_torch.kernels._build`
(``nvcc`` for ``sm_90a`` at the first CUDA launch, ``ctypes``).

Both kernels sum a row's trees in NumPy's pairwise float32 order, which
:func:`pairwise_plan` spells out from the tree count alone as leaf
blocks, independent chains and the order that combines them; the
kernels follow that table. Their grids are functions of the shapes
alone (:func:`logits_geometry`, :func:`grid_geometry`): a call reads no
device value on the host and can be captured in a CUDA graph (after a
first call with the same tree count has put its plan on the device).

Each wrapper takes its plain torch version (``ref.py``) only for tensors
on the CPU. For a CUDA tensor it launches the kernel on the current
stream or raises: there is no fallback. ``launches`` counts the kernel
launches of each wrapper.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels._build import (MAX_SMEM_BYTES, CudaLibrary, F, I, P,
                                        check, check_tensor, launch)
from repro_torch.kernels.gbdt_infer.ref import (PW_BLOCKSIZE,
                                                gbdt_grid_logits_ref,
                                                gbdt_logits_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "gbdt_infer.cu"

# how a gbdt_logits chain starts (kFromFirst, kTerms and any other mode
# in the source): from its first term, from 0.0 (a leaf block of < 8
# trees), or storing each term in its own slot (a block's tail)
CHAIN_FROM_FIRST, CHAIN_FROM_ZERO, CHAIN_TERMS = 0, 1, 2
# gbdt_logits: rows per tile (32 lanes x 2 rows; kTileRows in the
# source) and the most warps of a block, one chain each at a time
TILE_ROWS = 64
LOGITS_MAX_WARPS = 32
# gbdt_grid_logits: threads per block (kGridThreads; also the widest
# candidate chunk), clients per thread (kGridClients), persistent blocks
# per SM where they fit
GRID_THREADS = 256
GRID_CLIENTS = 4
GRID_BLOCKS_PER_SM = 2
# shared memory and threads of one SM, and the shared memory the runtime
# reserves per block
SM_SMEM_BYTES = 233472
SM_THREADS = 2048
SMEM_RESERVED_PER_BLOCK = 1024

launches: Dict[str, int] = {"gbdt_logits": 0, "gbdt_grid_logits": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.gbdt_logits_launch.argtypes = ([P, I, I, P, P, P, I, I, F, P, I, P]
                                       + [I] * 7 + [P, P])
    lib.gbdt_logits_launch.restype = I
    lib.gbdt_grid_logits_launch.argtypes = ([P, I, I, P, P, P, I, P, I, I,
                                             P] + [I] * 8 + [P, P])
    lib.gbdt_grid_logits_launch.restype = I
    for name, want in (("gbdt_tile_rows", TILE_ROWS),
                       ("gbdt_grid_threads", GRID_THREADS),
                       ("gbdt_grid_clients", GRID_CLIENTS)):
        getattr(lib, name).restype = I
        if getattr(lib, name)() != want:
            raise RuntimeError(f"{name}() in gbdt_infer.cu differs from "
                               f"{want}")


LIBRARY = CudaLibrary(SOURCE, _bind)
build = LIBRARY.build


# ------------------------------------------------------------------- the plan
@dataclass(frozen=True)
class PairwisePlan:
    """NumPy's pairwise float32 sum of ``n`` terms, reordered in time only.

    ``blocks`` (B, 4): the leaf blocks left to right as (lo, len, slot,
    merges): each at most PW_BLOCKSIZE terms, lo a multiple of 8; slot is
    the block's first partial in ``gbdt_logits``; merges counts the sums
    NumPy's recursion closes right after this block. Summing the blocks
    left to right onto a stack and, after block k, adding the top sum
    into the one below it ``merges`` times is NumPy's recursion (never
    more than ``stack_depth`` sums deep); the total ends at the bottom.

    A block of >= 8 terms is NumPy's 8 accumulators over strided terms,
    combined as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)), then its tail in
    sequence; a block of < 8 terms is a fold from 0.0. ``chains`` (K, 5):
    (first, count, stride, mode, slot), the independent chains that
    ``gbdt_logits`` spreads over warps: per block of >= 8 terms its 8
    accumulators (mode CHAIN_FROM_FIRST, slots slot..slot+7) and its tail
    (CHAIN_TERMS, a slot per term after them); a block of < 8 terms is
    one chain (CHAIN_FROM_ZERO). ``gbdt_grid_logits`` sums each block
    itself, with the same accumulators.

    NumPy starts its reduction from the identity, so its sum is ``0.0 +``
    this total (the two differ only where the total is -0.0); the kernels
    add that 0.0 when they write the result.
    """
    n: int
    blocks: np.ndarray
    chains: np.ndarray
    n_slots: int
    stack_depth: int

    def table(self) -> Tuple[np.ndarray, Dict[str, Tuple[int, int]]]:
        """Both tables as one int32 array, and each one's (offset, rows)
        in it."""
        return (np.concatenate([self.blocks.reshape(-1),
                                self.chains.reshape(-1)]).astype(np.int32),
                {"blocks": (0, self.blocks.shape[0]),
                 "chains": (self.blocks.size, self.chains.shape[0])})


def _rows(pairs, width: int) -> np.ndarray:
    return np.asarray(pairs, dtype=np.int32).reshape(-1, width)


@functools.lru_cache(maxsize=None)
def pairwise_plan(n: int) -> PairwisePlan:
    """The plan of NumPy's pairwise sum of ``n >= 1`` float32 terms
    (``pairwise_sum`` in ``ref.py``, ``PW_BLOCKSIZE`` 128)."""
    check(n >= 1, f"need at least one term, got {n}")
    blocks = []

    def split(lo: int, m: int) -> None:
        if m <= PW_BLOCKSIZE:
            blocks.append([lo, m, 0, 0])
            return
        m2 = m // 2
        m2 -= m2 % 8
        split(lo, m2)
        split(lo + m2, m - m2)
        blocks[-1][3] += 1                  # closes after the last block

    split(0, n)
    chains = []
    s = depth = stack_depth = 0
    for block in blocks:
        lo, m = block[0], block[1]
        block[2] = s
        stack_depth = max(stack_depth, depth + 1)
        depth += 1 - block[3]
        if m < 8:
            chains.append((lo, m, 1, CHAIN_FROM_ZERO, s))
            s += 1
            continue
        full = m - m % 8
        chains += [(lo + j, full // 8, 8, CHAIN_FROM_FIRST, s + j)
                   for j in range(8)]
        if m > full:
            chains.append((lo + full, m - full, 1, CHAIN_TERMS, s + 8))
        s += 8 + m - full
    return PairwisePlan(n=n, blocks=_rows(blocks, 4),
                        chains=_rows(chains, 5), n_slots=s,
                        stack_depth=stack_depth)


@functools.lru_cache(maxsize=None)
def _device_plan(n_trees: int, dev: torch.device):
    """``pairwise_plan(n_trees).table()`` on ``dev``, made once per tree
    count and device and kept (a graph that captured a call reads it)."""
    flat, off = pairwise_plan(n_trees).table()
    table = torch.from_numpy(flat).to(dev)
    torch.cuda.synchronize(dev)
    return table, off


def _ptr(table: torch.Tensor, off: Dict, name: str) -> Tuple[int, int]:
    at, rows = off[name]
    return table.data_ptr() + 4 * at, rows


# ---------------------------------------------------------------- geometries
def _pad4(words: int) -> int:
    """A shared-memory section's words, rounded up so that the next one
    starts 16-byte aligned (pad4 in the source)."""
    return (words + 3) & ~3


def _blocks_per_sm(smem: int, threads: int) -> int:
    return max(1, min(SM_SMEM_BYTES // (smem + SMEM_RESERVED_PER_BLOCK),
                      SM_THREADS // threads))


@dataclass(frozen=True)
class LogitsGeometry:
    blocks: int        # persistent: at most the blocks that fit on the SMs
    threads: int       # 32 per warp, one chain per warp at a time
    stage_model: bool  # splits and leaves staged once per block
    stage_x: bool      # each tile's rows staged transposed
    smem: int          # dynamic shared memory bytes


def logits_geometry(n_rows: int, n_features: int, n_trees: int, depth: int,
                    sms: int = 132) -> LogitsGeometry:
    """``gbdt_logits``'s launch, from the shapes alone: a persistent grid
    over tiles of TILE_ROWS rows, a warp per chain of the plan (at most
    LOGITS_MAX_WARPS), as many blocks as the shared memory and threads of
    ``sms`` SMs hold at once and no more than tiles (the launch lowers
    that where the build's registers allow fewer blocks per SM). Shared
    memory holds the chains' partials, then, where each still fits, the
    row tile (else rows are read through L1) and the model, each split as
    an 8-byte word (else read through L1)."""
    plan = pairwise_plan(n_trees)
    slots = plan.n_slots * TILE_ROWS * 4
    check(slots <= MAX_SMEM_BYTES,
          f"{n_trees} trees need {slots} bytes of shared memory for their "
          f"partial sums, above {MAX_SMEM_BYTES}")
    # the fold's stack reuses leaf block 0's slots (8, or 1 below 8 trees)
    check(plan.stack_depth <= min(plan.n_slots, 8),
          f"{n_trees} trees fold deeper than the kernel's stack")
    x_bytes = 4 * _pad4(n_features * (TILE_ROWS + 1))
    stage_x = slots + x_bytes <= MAX_SMEM_BYTES
    smem = slots + (x_bytes if stage_x else 0)
    model_bytes = 4 * (_pad4(2 * n_trees * depth) + (n_trees << depth))
    stage_model = smem + model_bytes <= MAX_SMEM_BYTES
    smem += model_bytes if stage_model else 0
    threads = 32 * min(plan.chains.shape[0], LOGITS_MAX_WARPS)
    tiles = -(-n_rows // TILE_ROWS)
    return LogitsGeometry(
        blocks=min(tiles, _blocks_per_sm(smem, threads) * sms),
        threads=threads, stage_model=stage_model, stage_x=stage_x, smem=smem)


@dataclass(frozen=True)
class GridGeometry:
    blocks: int          # persistent: at most blocks_per_sm x SMs
    cand_width: int      # candidates of one pass (a power of two <= 256)
    clients_per_pass: int
    units: int           # (client group, candidate chunk) pairs
    resident: bool       # the whole model staged once per block
    stage_leaves: bool   # leaves in shared memory (else gathered via L1)
    window: int          # trees staged at once, rounded up to 8
    smem: int            # dynamic shared memory bytes


def _grid_smem(window: int, cand_width: int, per_pass: int, depth: int,
               stack_depth: int, stage_leaves: bool) -> int:
    return 4 * (_pad4(window * (cand_width + 1)) + per_pass * window
                + 2 * _pad4(window * depth)
                + stack_depth * GRID_CLIENTS * GRID_THREADS
                + ((window << depth) if stage_leaves else 0))


def grid_geometry(n_clients: int, n_cand: int, n_trees: int, depth: int,
                  sms: int = 132) -> GridGeometry:
    """``gbdt_grid_logits``'s persistent launch, from the shapes alone.

    A pass scores ``GRID_THREADS // cand_width * GRID_CLIENTS`` clients
    against a chunk of ``cand_width`` candidates (the candidate count
    rounded up to a power of two, at most GRID_THREADS): a thread per
    candidate for GRID_CLIENTS clients. The whole model stays resident
    in a block's shared memory where it fits (one chunk, leaves staged);
    else the block stages one leaf block of trees at a time, with its
    leaves where they fit. GRID_BLOCKS_PER_SM blocks per SM where their
    shared memory allows, else fewer, and no more blocks than units (the
    launch lowers that where the build's registers allow fewer)."""
    cand_width = min(max(32, 1 << max(n_cand - 1, 0).bit_length()),
                     GRID_THREADS)
    per_pass = GRID_THREADS // cand_width * GRID_CLIENTS
    chunks = -(-n_cand // cand_width)
    units = -(-n_clients // per_pass) * chunks
    stack_depth = pairwise_plan(n_trees).stack_depth

    def smem(window, stage_leaves):
        return _grid_smem(window, cand_width, per_pass, depth, stack_depth,
                          stage_leaves)

    whole = -(-n_trees // 8) * 8
    if chunks == 1 and smem(whole, True) <= MAX_SMEM_BYTES:
        resident, stage_leaves, window = True, True, whole
    else:
        resident, window = False, PW_BLOCKSIZE
        stage_leaves = smem(window, True) <= MAX_SMEM_BYTES
    need = smem(window, stage_leaves)
    check(need <= MAX_SMEM_BYTES,
          f"{n_trees} trees need {need} bytes of shared memory in "
          f"gbdt_grid_logits, above {MAX_SMEM_BYTES}")
    per_sm = min(GRID_BLOCKS_PER_SM, _blocks_per_sm(need, GRID_THREADS))
    return GridGeometry(blocks=min(units, per_sm * sms),
                        cand_width=cand_width, clients_per_pass=per_pass,
                        units=units, resident=resident,
                        stage_leaves=stage_leaves, window=window, smem=need)


def _check_depth(depth: int) -> None:
    check(1 <= depth <= 16, f"need depth in 1..16, got {depth}")


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


# ------------------------------------------------------------------ wrappers
def gbdt_logits(x: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                leaf: torch.Tensor, base: float) -> torch.Tensor:
    """(N,) float32 logits ``f32(base) + Σ_t leaf[t, idx_t]`` of the
    (N, F) float32 rows ``x``; ``feat`` (T, D) int32 (every entry < F),
    ``thr`` (T, D) float32, ``leaf`` (T, 2**D) float32, all contiguous on
    ``x``'s device."""
    dev = x.device
    check_tensor("x", x, torch.float32, 2, dev)
    check_tensor("feat", feat, torch.int32, 2, dev)
    check_tensor("thr", thr, torch.float32, 2, dev)
    check_tensor("leaf", leaf, torch.float32, 2, dev)
    n_trees, depth = feat.shape
    check(thr.shape == feat.shape, "thr must match feat's (T, D) shape")
    check(tuple(leaf.shape) == (n_trees, 1 << depth),
          f"leaf must be ({n_trees}, {1 << depth}), got {tuple(leaf.shape)}")
    if dev.type == "cpu":
        return gbdt_logits_ref(x, feat, thr, leaf, base)
    check(dev.type == "cuda", f"unsupported device {dev}")
    check(n_trees >= 1, "need at least one tree")
    _check_depth(depth)
    n, f = x.shape
    geo = logits_geometry(n, f, n_trees, depth, _sms(dev))
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    table, off = _device_plan(n_trees, dev)
    blocks, n_blocks = _ptr(table, off, "blocks")
    chains, n_chains = _ptr(table, off, "chains")
    launch(launches, "gbdt_logits", dev, LIBRARY.get().gbdt_logits_launch,
           x.data_ptr(), n, f, feat.data_ptr(), thr.data_ptr(),
           leaf.data_ptr(), n_trees, depth, ctypes.c_float(base), blocks,
           n_blocks, chains, n_chains, pairwise_plan(n_trees).n_slots,
           geo.blocks, geo.threads, int(geo.stage_model), int(geo.stage_x),
           geo.smem, out.data_ptr())
    return out


def gbdt_grid_logits(h: torch.Tensor, cfeat: torch.Tensor, thr: torch.Tensor,
                     idx_theta: torch.Tensor,
                     leaf_flat: torch.Tensor) -> torch.Tensor:
    """(n, C) float32 logits, without the base, of every (n, F_h) client
    row of ``h`` against the C candidates of a static grid (see
    ``ref.gbdt_grid_logits_ref`` for the operands)."""
    dev = h.device
    check_tensor("h", h, torch.float32, 2, dev)
    check_tensor("cfeat", cfeat, torch.int32, 2, dev)
    check_tensor("thr", thr, torch.float32, 2, dev)
    check_tensor("idx_theta", idx_theta, torch.int32, 2, dev)
    check_tensor("leaf_flat", leaf_flat, torch.float32, 1, dev)
    n_trees, depth = cfeat.shape
    check(thr.shape == cfeat.shape, "thr must match cfeat's (T, D) shape")
    check(idx_theta.shape[1] == n_trees, "idx_theta must be (C, T)")
    check(leaf_flat.shape[0] == n_trees << depth,
          "leaf_flat must hold T * 2**D leaves")
    if dev.type == "cpu":
        return gbdt_grid_logits_ref(h, cfeat, thr, idx_theta, leaf_flat)
    check(dev.type == "cuda", f"unsupported device {dev}")
    check(n_trees >= 1, "need at least one tree")
    _check_depth(depth)
    n, f_h = h.shape
    n_cand = idx_theta.shape[0]
    out = torch.empty((n, n_cand), dtype=torch.float32, device=dev)
    if n == 0 or n_cand == 0:
        return out
    geo = grid_geometry(n, n_cand, n_trees, depth, _sms(dev))
    table, off = _device_plan(n_trees, dev)
    blocks, n_blocks = _ptr(table, off, "blocks")
    launch(launches, "gbdt_grid_logits", dev,
           LIBRARY.get().gbdt_grid_logits_launch,
           h.data_ptr(), n, f_h, cfeat.data_ptr(), thr.data_ptr(),
           idx_theta.data_ptr(), n_cand, leaf_flat.data_ptr(), n_trees,
           depth, blocks, n_blocks, pairwise_plan(n_trees).stack_depth,
           geo.cand_width, geo.window, int(geo.resident),
           int(geo.stage_leaves), geo.blocks, geo.smem, out.data_ptr())
    return out
