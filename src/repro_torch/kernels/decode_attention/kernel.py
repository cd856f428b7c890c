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
launches a split kernel and the combine kernel from one C entry point.
``variants`` counts which split kernel each call took:
``"tensor_core"`` (bfloat16 q and cache with 16-byte aligned rows,
:func:`takes_tensor_cores`) or ``"simt"`` (the rest). :func:`launch_parts`
launches one of a call's two kernels alone, for measurement and tests,
counted in ``part_launches`` only.

The number of splits is :func:`decode_splits`, a function of the
shapes alone: the kernels cut each row's valid length into that many
runs of 16-key chunks from ``lengths`` on the device, and the wrapper
never reads ``lengths`` (or any device value) on the host, so the call
can be captured in a CUDA graph and replayed after ``lengths`` changes
in place.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels._build import (CudaLibrary, F, I, L, P, check,
                                        check_tensor, launch)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# keys a chunk: the splits cut a valid length into runs of whole chunks
CHUNK = 16
# each split kernel's grid. Tensor cores: blocks enough to give every SM
# as many blocks as it holds at once, at most 2 (fewer splits write
# fewer partials; a block past the SMs' room waits for a second wave):
# a D 256 block takes ~140 KB of shared memory (two stages of 64-key K
# and V tiles), one an SM. ``_bind`` holds these counts to the
# library's occupancy of every instance on the card. SIMT: ``waves`` x
# SMs blocks. Neither cuts an S-position cache into splits shorter than
# ``min_split``; ``head_tile`` query heads a block.
SPLIT_RULES = {"tensor_core": {"head_tile": 16, "blocks_per_sm": 2,
                               "blocks_per_sm_d256": 1, "min_split": 32},
               "simt": {"head_tile": 8, "waves": 2, "min_split": 128}}
# most query heads per block of the SIMT split kernel
MAX_GROUP_TILE = SPLIT_RULES["simt"]["head_tile"]

# the C entry point's parts: the split kernel, the combine kernel
SPLIT, COMBINE = 1, 2
# a head dim and a group of each tensor-core instance (D <= 64, <= 128,
# <= 256; one or two 8-head column tiles)
TC_INSTANCES = tuple((d, group) for d in (64, 128, 256) for group in (8, 16))

launches: Dict[str, int] = {"decode_attention": 0}
variants: Dict[str, int] = {"tensor_core": 0, "simt": 0}
part_launches: Dict[str, int] = {"split": 0, "combine": 0}


def reset_launches() -> None:
    for counter in (launches, variants, part_launches):
        for k in counter:
            counter[k] = 0


def tc_blocks_per_sm(d: int) -> int:
    """Blocks of the tensor-core split kernel a call at head dim ``d``
    gives each SM: ``SPLIT_RULES``' ``blocks_per_sm_d256`` above D 128,
    else ``blocks_per_sm``."""
    rule = SPLIT_RULES["tensor_core"]
    return rule["blocks_per_sm_d256" if d > 128 else "blocks_per_sm"]


def _bind(lib: ctypes.CDLL) -> None:
    lib.decode_attention_launch.argtypes = (
        [P] * 6 + [I] * 10 + [L] * 8 + [F, P])
    lib.decode_attention_launch.restype = I
    for name in ("max_head_dim", "max_group_tile", "tc_head_tile",
                 "tc_blocks_per_sm"):
        getattr(lib, f"decode_attention_{name}").restype = I
    lib.decode_attention_tc_blocks_per_sm.argtypes = [I, I]
    if lib.decode_attention_max_head_dim() != MAX_HEAD_DIM:
        raise RuntimeError("decode_attention.cu's head-dim limit differs "
                           "from MAX_HEAD_DIM")
    if (lib.decode_attention_max_group_tile() != MAX_GROUP_TILE
            or lib.decode_attention_tc_head_tile()
            != SPLIT_RULES["tensor_core"]["head_tile"]):
        raise RuntimeError("decode_attention.cu's head tiles differ "
                           "from SPLIT_RULES")
    # the split rule's blocks an SM: what each instance's shared memory
    # lets the card hold at once, capped at blocks_per_sm
    cap = SPLIT_RULES["tensor_core"]["blocks_per_sm"]
    for d, group in TC_INSTANCES:
        held = lib.decode_attention_tc_blocks_per_sm(d, group)
        if held < 1 or min(held, cap) != tc_blocks_per_sm(d):
            raise RuntimeError(
                f"decode_attention.cu's tensor-core instance for D {d}, "
                f"group {group} holds {held} blocks an SM; SPLIT_RULES "
                f"gives it {tc_blocks_per_sm(d)}")


def takes_tensor_cores(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> bool:
    """Whether a call takes the tensor-core split kernel: q, k and v all
    bfloat16, D a multiple of 8, and every row of each starting 16-byte
    aligned (its address and its strides but the last). A function of
    dtypes, shapes, strides and addresses, never of values."""
    if not all(t.dtype == torch.bfloat16 for t in (q, k, v)):
        return False
    if q.shape[-1] % 8:
        return False
    return all(t.data_ptr() % 16 == 0
               and all(st * 2 % 16 == 0 for st in t.stride()[:-1])
               for t in (q, k, v))


def decode_splits(b: int, hkv: int, group: int, s: int, d: int,
                  sms: int = 132, tensor_cores: bool = True) -> int:
    """Splits of each row's valid length. Tensor cores: the largest count
    whose blocks (B x Hkv x tiles of ``head_tile`` heads x splits) fit
    ``sms`` SMs at ``blocks_per_sm`` each (``blocks_per_sm_d256`` above
    D 128). SIMT: enough blocks (tiles of 8 heads) for ``waves`` waves.
    Either way no more than an S-position cache cut into splits of
    ``min_split`` positions (one below that): ``SPLIT_RULES``. A function
    of the shapes only, never of ``lengths``."""
    if tensor_cores:
        rule = SPLIT_RULES["tensor_core"]
        blocks = b * hkv * -(-group // rule["head_tile"])
        want = tc_blocks_per_sm(d) * sms // max(blocks, 1)
    else:
        rule = SPLIT_RULES["simt"]
        blocks = b * hkv * -(-group // rule["head_tile"])
        want = -(-rule["waves"] * sms // max(blocks, 1))
    return max(1, min(want, s // rule["min_split"]))


def split_ranges(length: int, n_split: int) -> List[Tuple[int, int]]:
    """The keys [lo, hi) of each split of a row of ``length`` valid
    positions, as the kernels cut it (``split_range`` in the source):
    runs of ceil(ceil(length / CHUNK) / n_split) whole chunks. The card's
    tests hold it to the partials the split kernels write."""
    chunks = -(-max(length, 0) // CHUNK)
    per = -(-chunks // n_split) * CHUNK
    return [(min(i * per, length), min(i * per + per, length))
            for i in range(n_split)]


def blocks_with_work(lengths: Sequence[int], hkv: int, group: int,
                     n_split: int, tensor_cores: bool = True) -> int:
    """Blocks of the split kernel's grid that have keys to read, for the
    given lengths (a host mirror of the kernels' rule, for reports)."""
    tiles = -(-group // SPLIT_RULES["tensor_core" if tensor_cores
                                    else "simt"]["head_tile"])
    return hkv * tiles * sum(hi > lo for length in lengths
                             for lo, hi in split_ranges(length, n_split))


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
    return _decode_attention(q, k, v, lengths, scale, SPLIT | COMBINE)[0]


def launch_parts(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, parts: int,
                 ws: Optional[torch.Tensor] = None,
                 scale: Optional[float] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One of a call's kernels alone on CUDA tensors, for measurement and
    tests: ``SPLIT`` writes the splits' float32 partials to ``ws`` (the
    (m, l) pairs as (B, Hq, n_split, 2), then the acc rows; a split with
    no keys writes m = -1e30, l = 0), ``COMBINE`` merges the partials in
    ``ws`` into the output. Returns (output, ws); the output is written
    only by ``COMBINE``. Counted in ``part_launches``, not in
    ``launches``."""
    check(q.device.type == "cuda", "the parts run on the card only")
    check(parts in (SPLIT, COMBINE), f"parts must be SPLIT or COMBINE, "
                                     f"got {parts}")
    return _decode_attention(q, k, v, lengths, scale, parts, ws)


def _decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: Optional[torch.Tensor],
                      scale: Optional[float], parts: int,
                      ws: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
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
        return decode_attention_ref(q, k, v, lengths=lengths,
                                    scale=scale), None
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
        return out, ws
    tc = takes_tensor_cores(q, k, v)
    n_split = decode_splits(
        b, hkv, hq // hkv, s, d,
        torch.cuda.get_device_properties(dev).multi_processor_count, tc)
    # the splits' float32 partials: (m, l) pairs, then acc rows
    size = b * hq * n_split * (d + 2)
    if ws is None:
        ws = torch.empty(size, dtype=torch.float32, device=dev)
    check_tensor("ws", ws, torch.float32, 1, dev)
    check(ws.numel() == size, f"ws must hold {size} floats")
    whole = parts == SPLIT | COMBINE
    launch(launches if whole else part_launches,
           "decode_attention" if whole
           else ("split" if parts == SPLIT else "combine"), dev,
           LIBRARY.get().decode_attention_launch,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
           out.data_ptr(), ws.data_ptr(), DTYPES[q.dtype], DTYPES[k.dtype],
           b, hq, hkv, s, d, n_split, int(tc), parts,
           *q.stride()[:2], *k.stride()[:3], *v.stride()[:3],
           ctypes.c_float(scale_val))
    if whole:
        variants["tensor_core" if tc else "simt"] += 1
    return out, ws
