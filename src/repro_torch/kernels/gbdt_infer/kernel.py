"""Build, binding and launch of the GBDT CUDA kernels (``csrc/gbdt_infer.cu``).

``gbdt_logits`` replaces the Pallas TPU kernel
``repro/kernels/gbdt_infer/kernel.py::_gbdt_kernel`` (launched by
``gbdt_logits_pallas``); ``gbdt_grid_logits`` is the factorized fleet
path that the reference runs as ``GridGBDTScorer._predict_numpy``. The
source's header says what bounds each kernel on the card and what its
design does about it.

The library is built with ``nvcc`` for ``sm_90a`` into ``build/`` beside
this file on the first CUDA launch of the process (never at import: a
machine without ``nvcc`` imports this module and runs the plain
versions), named by a hash of the source so a stale build is never
loaded, and bound with ``ctypes``.

Each wrapper takes its plain torch version (``ref.py``) only for tensors
on the CPU. For a CUDA tensor it launches the kernel on the current
stream or raises: there is no fallback. ``launches`` counts the kernel
launches of each wrapper.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.gbdt_infer.ref import (PW_BLOCKSIZE,
                                                gbdt_grid_logits_ref,
                                                gbdt_logits_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "gbdt_infer.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# splits above PW_BLOCKSIZE that the kernels' pairwise_sum unrolls
# (kMaxLevels in the source)
MAX_PAIRWISE_LEVELS = 5
# dynamic shared memory one block may use on Hopper
MAX_SMEM_BYTES = 232448

launches: Dict[str, int] = {"gbdt_logits": 0, "gbdt_grid_logits": 0}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the GBDT CUDA kernels are built "
                       "from csrc/gbdt_infer.cu on first CUDA use")


def build() -> Tuple[Path, str]:
    """Compile the kernels (if this source has no build yet); returns the
    library path and the compiler's register/shared-memory report."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libgbdt_infer-{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            lib.gbdt_logits_launch.argtypes = [
                _P, _I, _I, _P, _P, _P, _I, _I, ctypes.c_float, _P, _P]
            lib.gbdt_logits_launch.restype = _I
            lib.gbdt_grid_logits_launch.argtypes = [
                _P, _I, _I, _P, _P, _P, _I, _P, _I, _I, _P, _P]
            lib.gbdt_grid_logits_launch.restype = _I
            lib.gbdt_max_levels.restype = _I
            if lib.gbdt_max_levels() != MAX_PAIRWISE_LEVELS:
                raise RuntimeError("kMaxLevels in gbdt_infer.cu differs "
                                   "from MAX_PAIRWISE_LEVELS")
            _lib = lib
        return _lib


def pairwise_levels(n: int) -> int:
    """Splits above PW_BLOCKSIZE that NumPy's pairwise sum of ``n``
    elements makes on its deepest path."""
    if n <= PW_BLOCKSIZE:
        return 0
    n2 = n // 2
    n2 -= n2 % 8
    return 1 + max(pairwise_levels(n2), pairwise_levels(n - n2))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                  ndim: int, device: torch.device) -> None:
    _check(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    _check(t.dim() == ndim, f"{name} must have {ndim} dims, got {t.dim()}")
    _check(t.device == device, f"{name} is on {t.device}, expected {device}")
    _check(t.is_contiguous(), f"{name} must be contiguous")


def _check_trees(n_trees: int, depth: int) -> None:
    _check(n_trees >= 1 and 1 <= depth <= 16,
           f"need >= 1 tree and depth in 1..16, got {n_trees}, {depth}")
    _check(pairwise_levels(n_trees) <= MAX_PAIRWISE_LEVELS,
           f"{n_trees} trees exceed the kernels' pairwise-sum depth")


def _launch(name: str, device: torch.device, fn, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches[name] += 1


def gbdt_logits(x: torch.Tensor, feat: torch.Tensor, thr: torch.Tensor,
                leaf: torch.Tensor, base: float) -> torch.Tensor:
    """(N,) float32 logits ``f32(base) + Σ_t leaf[t, idx_t]`` of the
    (N, F) float32 rows ``x``; ``feat`` (T, D) int32 (every entry < F),
    ``thr`` (T, D) float32, ``leaf`` (T, 2**D) float32, all contiguous on
    ``x``'s device."""
    dev = x.device
    _check_tensor("x", x, torch.float32, 2, dev)
    _check_tensor("feat", feat, torch.int32, 2, dev)
    _check_tensor("thr", thr, torch.float32, 2, dev)
    _check_tensor("leaf", leaf, torch.float32, 2, dev)
    n_trees, depth = feat.shape
    _check(thr.shape == feat.shape, "thr must match feat's (T, D) shape")
    _check(tuple(leaf.shape) == (n_trees, 1 << depth),
           f"leaf must be ({n_trees}, {1 << depth}), got {tuple(leaf.shape)}")
    if dev.type == "cpu":
        return gbdt_logits_ref(x, feat, thr, leaf, base)
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check_trees(n_trees, depth)
    smem = n_trees * depth * 8 + (n_trees << depth) * 4
    _check(smem <= MAX_SMEM_BYTES,
           f"model needs {smem} bytes of shared memory, above "
           f"{MAX_SMEM_BYTES}")
    n, f = x.shape
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    _launch("gbdt_logits", dev, _library().gbdt_logits_launch,
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
    _check_tensor("h", h, torch.float32, 2, dev)
    _check_tensor("cfeat", cfeat, torch.int32, 2, dev)
    _check_tensor("thr", thr, torch.float32, 2, dev)
    _check_tensor("idx_theta", idx_theta, torch.int32, 2, dev)
    _check_tensor("leaf_flat", leaf_flat, torch.float32, 1, dev)
    n_trees, depth = cfeat.shape
    _check(thr.shape == cfeat.shape, "thr must match cfeat's (T, D) shape")
    _check(idx_theta.shape[1] == n_trees, "idx_theta must be (C, T)")
    _check(leaf_flat.shape[0] == n_trees << depth,
           "leaf_flat must hold T * 2**D leaves")
    if dev.type == "cpu":
        return gbdt_grid_logits_ref(h, cfeat, thr, idx_theta, leaf_flat)
    _check(dev.type == "cuda", f"unsupported device {dev}")
    _check_trees(n_trees, depth)
    n, f_h = h.shape
    n_cand = idx_theta.shape[0]
    out = torch.empty((n, n_cand), dtype=torch.float32, device=dev)
    if n == 0 or n_cand == 0:
        return out
    _launch("gbdt_grid_logits", dev, _library().gbdt_grid_logits_launch,
            h.data_ptr(), n, f_h, cfeat.data_ptr(), thr.data_ptr(),
            idx_theta.data_ptr(), n_cand, leaf_flat.data_ptr(), n_trees,
            depth, out.data_ptr())
    return out
