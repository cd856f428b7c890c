"""Build, binding and launch of the GBDT CUDA kernels (``csrc/gbdt_infer.cu``).

``gbdt_logits`` replaces the Pallas TPU kernel
``repro/kernels/gbdt_infer/kernel.py::_gbdt_kernel`` (launched by
``gbdt_logits_pallas``); ``gbdt_grid_logits`` is the factorized fleet
path that the reference runs as ``GridGBDTScorer._predict_numpy``. The
source's header says what bounds each kernel on the card and what its
design does about it.

The library is built and bound by :mod:`repro_torch.kernels._build`
(``nvcc`` for ``sm_90a`` at the first CUDA launch, ``ctypes``).

Each wrapper takes its plain torch version (``ref.py``) only for tensors
on the CPU. For a CUDA tensor it launches the kernel on the current
stream or raises: there is no fallback. ``launches`` counts the kernel
launches of each wrapper.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels._build import (MAX_SMEM_BYTES, CudaLibrary, F, I, P,
                                        check, check_tensor, launch)
from repro_torch.kernels.gbdt_infer.ref import (PW_BLOCKSIZE,
                                                gbdt_grid_logits_ref,
                                                gbdt_logits_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "gbdt_infer.cu"
# splits above PW_BLOCKSIZE that the kernels' pairwise_sum unrolls
# (kMaxLevels in the source)
MAX_PAIRWISE_LEVELS = 5

launches: Dict[str, int] = {"gbdt_logits": 0, "gbdt_grid_logits": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.gbdt_logits_launch.argtypes = [P, I, I, P, P, P, I, I, F, P, P]
    lib.gbdt_logits_launch.restype = I
    lib.gbdt_grid_logits_launch.argtypes = [P, I, I, P, P, P, I, P, I, I, P,
                                            P]
    lib.gbdt_grid_logits_launch.restype = I
    lib.gbdt_max_levels.restype = I
    if lib.gbdt_max_levels() != MAX_PAIRWISE_LEVELS:
        raise RuntimeError("kMaxLevels in gbdt_infer.cu differs "
                           "from MAX_PAIRWISE_LEVELS")


LIBRARY = CudaLibrary(SOURCE, _bind)
build = LIBRARY.build
def pairwise_levels(n: int) -> int:
    """Splits above PW_BLOCKSIZE that NumPy's pairwise sum of ``n``
    elements makes on its deepest path."""
    if n <= PW_BLOCKSIZE:
        return 0
    n2 = n // 2
    n2 -= n2 % 8
    return 1 + max(pairwise_levels(n2), pairwise_levels(n - n2))


def _check_trees(n_trees: int, depth: int) -> None:
    check(n_trees >= 1 and 1 <= depth <= 16,
          f"need >= 1 tree and depth in 1..16, got {n_trees}, {depth}")
    check(pairwise_levels(n_trees) <= MAX_PAIRWISE_LEVELS,
          f"{n_trees} trees exceed the kernels' pairwise-sum depth")


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
    _check_trees(n_trees, depth)
    smem = n_trees * depth * 8 + (n_trees << depth) * 4
    check(smem <= MAX_SMEM_BYTES,
          f"model needs {smem} bytes of shared memory, above "
          f"{MAX_SMEM_BYTES}")
    n, f = x.shape
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    launch(launches, "gbdt_logits", dev, LIBRARY.get().gbdt_logits_launch,
           x.data_ptr(), n, f, feat.data_ptr(), thr.data_ptr(),
           leaf.data_ptr(), n_trees, depth, ctypes.c_float(base),
           out.data_ptr())
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
    _check_trees(n_trees, depth)
    n, f_h = h.shape
    n_cand = idx_theta.shape[0]
    out = torch.empty((n, n_cand), dtype=torch.float32, device=dev)
    if n == 0 or n_cand == 0:
        return out
    launch(launches, "gbdt_grid_logits", dev,
           LIBRARY.get().gbdt_grid_logits_launch,
           h.data_ptr(), n, f_h, cfeat.data_ptr(), thr.data_ptr(),
           idx_theta.data_ptr(), n_cand, leaf_flat.data_ptr(), n_trees,
           depth, out.data_ptr())
    return out
