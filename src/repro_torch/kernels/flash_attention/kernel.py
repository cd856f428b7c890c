"""Build, binding and launch of the flash-attention CUDA kernel
(``csrc/flash_attention.cu``).

``flash_attention`` replaces the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py::_fa_kernel`` (launched by
``flash_attention_pallas``). The source's header says what bounds it on
the card and what its design does about it. The library is built and
bound by :mod:`repro_torch.kernels._build`.

The wrapper takes its plain torch version (``ref.py``) only for tensors
on the CPU. For CUDA tensors it launches the kernel on the current
stream or raises: there is no fallback. The kernel reads q, k and v
through their (batch, head, position) strides, so the transposed views
of ``_split_heads`` need no copy; only the last dim must be dense.
``launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels._build import (CudaLibrary, F, I, L, P, check,
                                        check_tensor, launch)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches: Dict[str, int] = {"flash_attention": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attention_launch.argtypes = (
        [P, P, P, P, I, I, I, I, I, I, I] + [L] * 12 + [F, I, I, P])
    lib.flash_attention_launch.restype = I
    lib.flash_attention_max_head_dim.restype = I
    if lib.flash_attention_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("flash_attention.cu's head-dim limit differs "
                           "from MAX_HEAD_DIM")


LIBRARY = CudaLibrary(SOURCE, _bind)
build = LIBRARY.build


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q (B, Hq, Sq, D) over k, v (B, Hkv, Sk, D): GQA, the
    causal / sliding-window / bidirectional masks, any Sq and Sk, float32
    or bfloat16, D <= 256 on the card. Returns (B, Hq, Sq, D) in q's
    dtype."""
    dev = q.device
    check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
          "q, k, v must be (B, H, S, D)")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    check(tuple(v.shape) == tuple(k.shape), "k and v must have one shape")
    check(k.shape[0] == b and k.shape[3] == d,
          "k, v must match q's batch and head dim")
    check(hkv >= 1 and hq % hkv == 0, "GQA requires Hq % Hkv == 0")
    check(window >= 0, f"window must be >= 0, got {window}")
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    check(dev.type == "cuda", f"unsupported device {dev}")
    check(q.dtype in DTYPES, f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_tensor(name, t, q.dtype, 4, dev, contiguous=False)
    check(1 <= d <= MAX_HEAD_DIM, f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    # the exact d ** -0.5 of the Pallas kernel (ref.default_scale rounds
    # it to bfloat16 for bfloat16 inputs, as the reference's oracle does)
    scale_val = float(scale) if scale is not None else float(d) ** -0.5
    # (B, Sq, Hq, D) storage: the caller's _merge_heads is then a view
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=dev).transpose(1, 2)
    if out.numel() == 0:
        return out
    launch(launches, "flash_attention", dev,
           LIBRARY.get().flash_attention_launch,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           DTYPES[q.dtype], b, hq, hkv, sq, sk, d,
           *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
           *out.stride()[:3], ctypes.c_float(scale_val), int(causal),
           int(window))
    return out
