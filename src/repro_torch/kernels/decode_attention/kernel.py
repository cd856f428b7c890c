"""Build, binding and launch of the decode-attention CUDA kernel
(``csrc/decode_attention.cu``).

``decode_attention`` replaces the Pallas TPU kernel
``repro/kernels/decode_attention/kernel.py::_dec_kernel`` (launched by
``decode_attention_pallas``). The source's header says what bounds it on
the card and what its design does about it. The library is built and
bound by :mod:`repro_torch.kernels._build`.

The wrapper takes its plain torch version (``ref.py``) only for tensors
on the CPU. For CUDA tensors it launches the kernel on the current
stream or raises: there is no fallback. q, k and v are read through
their strides (the last dim dense); ``lengths`` must be a contiguous
int32 tensor on the same device. ``launches`` counts the calls: each
launches the split and the combine kernel from one C entry point.

The number of cache splits is :func:`decode_splits`, a function of the
shapes alone: the wrapper never reads ``lengths`` (or any device value)
on the host, so the call can be captured in a CUDA graph and replayed
after ``lengths`` changes in place.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels._build import (CudaLibrary, F, I, L, P, check,
                                        check_tensor, launch)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the split kernel's grid: blocks enough for SM_WAVES waves on the card,
# no split shorter than MIN_SPLIT cache positions
SM_WAVES = 4
MIN_SPLIT = 128
# most query heads per block of the split kernel
MAX_GROUP_TILE = 8

launches: Dict[str, int] = {"decode_attention": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    lib.decode_attention_launch.argtypes = (
        [P] * 6 + [I] * 8 + [L] * 8 + [F, P])
    lib.decode_attention_launch.restype = I
    lib.decode_attention_max_head_dim.restype = I
    lib.decode_attention_max_group_tile.restype = I
    if lib.decode_attention_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("decode_attention.cu's head-dim limit differs "
                           "from MAX_HEAD_DIM")
    if lib.decode_attention_max_group_tile() != MAX_GROUP_TILE:
        raise RuntimeError("decode_attention.cu's group tile differs "
                           "from MAX_GROUP_TILE")


def decode_splits(b: int, hkv: int, group: int, s: int,
                  sms: int = 132) -> int:
    """Splits of an S-position cache: enough blocks of the split kernel
    (B x Hkv x group tiles of up to MAX_GROUP_TILE heads x splits) for
    SM_WAVES waves on ``sms`` SMs, but no split shorter than MIN_SPLIT
    positions (one split below that). A function of the shapes only,
    never of ``lengths``."""
    blocks = b * hkv * -(-group // MAX_GROUP_TILE)
    want = -(-SM_WAVES * sms // max(blocks, 1))
    return max(1, min(want, s // MIN_SPLIT))


LIBRARY = CudaLibrary(SOURCE, _bind)
build = LIBRARY.build


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Attention of one query token per sequence, q (B, Hq, D), over the
    first ``lengths[b]`` positions of the cache k, v (B, Hkv, S, D) (all
    S without ``lengths``). q and the cache are each float32 or
    bfloat16, their types independent (computed in float32 on either
    device, as the reference's oracle and Pallas kernel do); D <= 256 on
    the card. Returns (B, Hq, D) in q's dtype."""
    dev = q.device
    check(q.dim() == 3 and k.dim() == 4 and v.dim() == 4,
          "q must be (B, Hq, D) and k, v (B, Hkv, S, D)")
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    check(tuple(v.shape) == tuple(k.shape), "k and v must have one shape")
    check(k.shape[0] == b and k.shape[3] == d,
          "k, v must match q's batch and head dim")
    check(hkv >= 1 and hq % hkv == 0, "GQA requires Hq % Hkv == 0")
    if dev.type in ("cpu", "meta"):
        # meta: the dry run's stand-ins, whose shardings DTensor carries
        # through the plain version's ops (as the reference's dry run
        # partitions its XLA oracle)
        return decode_attention_ref(q, k, v, lengths=lengths, scale=scale)
    check(dev.type == "cuda", f"unsupported device {dev}")
    check(q.dtype in DTYPES, f"q must be float32 or bfloat16, got {q.dtype}")
    check(k.dtype in DTYPES, f"k must be float32 or bfloat16, got {k.dtype}")
    check_tensor("q", q, q.dtype, 3, dev, contiguous=False)
    check_tensor("k", k, k.dtype, 4, dev, contiguous=False)
    check_tensor("v", v, k.dtype, 4, dev, contiguous=False)
    check(1 <= d <= MAX_HEAD_DIM, f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    check_tensor("lengths", lengths, torch.int32, 1, dev)
    check(lengths.shape[0] == b, "lengths must be (B,)")
    scale_val = float(scale) if scale is not None else float(d) ** -0.5
    out = torch.empty((b, hq, d), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    n_split = decode_splits(
        b, hkv, hq // hkv, s,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    # the splits' float32 partials: (m, l) pairs, then acc rows
    ws = torch.empty(b * hq * n_split * (d + 2), dtype=torch.float32,
                     device=dev)
    launch(launches, "decode_attention", dev,
           LIBRARY.get().decode_attention_launch,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
           out.data_ptr(), ws.data_ptr(), DTYPES[q.dtype], DTYPES[k.dtype],
           b, hq, hkv, s, d, n_split,
           *q.stride()[:2], *k.stride()[:3], *v.stride()[:3],
           ctypes.c_float(scale_val))
    return out
