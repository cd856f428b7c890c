"""Roofline terms of a dry-run step (no real hardware; the twin of
``repro/roofline/analysis.py``).

  compute term    = FLOPs per device / peak FLOP/s
  memory term     = bytes per device / HBM bandwidth
  collective term = collective bytes per device / link bandwidth

The reference reads them off XLA's compiled per-device program. PyTorch
compiles none: :class:`ProgramCost` counts them while one step runs on
meta DTensors over a ``fake``-backend world (``launch/dryrun.py``), and
:func:`analyze_program` turns the counts into a :class:`RooflineReport`.

* *FLOPs and bytes per device* are counted from the **local** shard
  shapes of each op. ``torch.utils.flop_counter.FlopCounterMode`` alone
  sees a DTensor op at its global shapes; :class:`ProgramCost` lets
  DTensor lower each op to its local ops first and applies the flop
  counter's formulas to those (the port's attention ops by the formulas
  beside them). To find an op's global output shape DTensor runs it
  once on fake tensors: that run is no device's work and is not
  counted. Bytes follow XLA's "bytes accessed" convention: every
  operand and output of every op that is not a view; an in-place
  indexed write (the decode step's cache write) counts the indices and
  values it reads and the values it writes, not the whole tensor, as
  XLA counts its in-place update of a donated buffer.
* *Collective bytes by kind* are the output bytes of each collective
  DTensor emits. Over a CPU mesh DTensor lowers an all-to-all to an
  all-gather, which is then counted as one.
* *Peak memory per device* is the most local bytes live at once: the
  step's arguments, then every op's output from its creation until the
  tensor is freed.

Hardware constants: one NVIDIA H100 SXM (the port's card). The
reference's are a TPU v5e's.
"""
from __future__ import annotations

import re
import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry, sdpa_backward_flop_count

from repro_torch.utils.tree import tree_leaves

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}


@dataclass(frozen=True)
class HW:
    # NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate (no
    # sparsity) and float32 outside the tensor cores
    peak_flops: float = 989e12       # bf16 per device
    f32_flops: float = 67e12
    # same data sheet: HBM3 bandwidth and capacity
    hbm_bw: float = 3.35e12          # bytes/s per device
    # same data sheet: NVLink 900 GB/s per GPU counts both directions;
    # a device's collective payload leaves it in one, 450 GB/s
    ici_bw: float = 450e9            # bytes/s per device, one direction
    hbm_bytes: float = 80e9


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, float]
    peak_memory_per_device: Optional[float]
    model_flops: float               # 6*N*D (analytic, global)
    hw: HW = field(default_factory=HW)

    # --- the three terms (seconds) -------------------------------------------
    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / self.hw.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (global counted flops) — remat/redundancy waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / dominant-term time (the score)."""
        t_useful = (self.model_flops / self.chips) / self.hw.peak_flops
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / t_bound if t_bound else 0.0

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_breakdown": self.collective_breakdown,
            "peak_memory_per_device": self.peak_memory_per_device,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                     "all-to-all", "collective-permute")


def _shape_bytes(type_str: str) -> float:
    """'bf16[16,512]' -> bytes. Tuple types handled by the caller."""
    m = _SHAPE_RE.match(type_str.strip())
    if not m:
        return 0.0
    dt, dims = m.groups()
    if dt not in _DTYPE_BYTES:
        return 0.0
    n = 1
    if dims:
        for d in dims.split(","):
            if d:
                n *= int(d)
    return float(n * _DTYPE_BYTES[dt])


def collective_bytes_from_hlo(hlo_text: str) -> Dict[str, float]:
    """Sum output-shape bytes of every collective op, by kind."""
    out: Dict[str, float] = {k: 0.0 for k in _COLLECTIVE_KINDS}
    for line in hlo_text.splitlines():
        stripped = line.strip()
        # HLO line form:  %name = TYPE op-name(...), or fusion-wrapped
        m = re.search(r"=\s*((?:\([^)]*\))|(?:[\w\[\],]+))\s+([\w-]+)",
                      stripped)
        if not m:
            continue
        type_str, op = m.groups()
        kind = None
        for k in _COLLECTIVE_KINDS:
            if op == k or op.startswith(k + "-") or op.startswith(k + "."):
                kind = k
                break
        if kind is None:
            continue
        if type_str.startswith("("):
            total = sum(_shape_bytes(t)
                        for t in type_str.strip("()").split(" ") if t)
        else:
            total = _shape_bytes(type_str)
        out[kind] += total
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


# ------------------------------------------------- counting a step as it runs
# the functional collectives DTensor emits, by the reference's kind names
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_FUNCOL = ("_c10d_functional", "c10d_functional")
# ops that move no bytes of their own
_NO_BYTES = {"detach", "alias", "lift_fresh", "wait_tensor"}
# in-place indexed writes: they touch the rows they write, not the whole
# tensor (XLA's in-place dynamic-update-slice of a donated buffer)
_INDEXED_WRITES = {"index_put_", "index_copy_", "index_add_", "scatter_",
                   "scatter_add_"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _attention_flops(q, k, v, *_args, **_kw) -> int:
    """The port's attention op: q·kᵀ and p·v over every (query, key)
    pair, 4·B·Hq·Sq·Sk·D, as the flop counter counts
    ``scaled_dot_product_attention``."""
    b, hq, sq, d = q.shape
    return 4 * b * hq * sq * k.shape[2] * d


def _attention_backward_flops(grad, q, k, v, *_args, **_kw) -> int:
    """Its backward op, as the flop counter counts SDPA's backward: the
    scores recomputed, then the gradients of p·v and of q·kᵀ, five
    products, 2·B·Hq·Sq·Sk·(3·D + 2·Dv) = 10·B·Hq·Sq·Sk·D."""
    return sdpa_backward_flop_count(tuple(grad.shape), tuple(q.shape),
                                    tuple(k.shape), tuple(v.shape))


_OP_FLOPS = {"flash_attention": _attention_flops,
             "flash_attention_backward": _attention_backward_flops}


class ProgramCost(TorchDispatchMode):
    """A dispatch mode that counts what one device does while a step
    runs on DTensors: FLOPs, bytes accessed, collective bytes by kind
    and the peak of live bytes, all at the local shards' shapes.

    ``arguments`` is the step's inputs and the weights it reads (a tree
    of tensors or DTensors, each counted once however often it appears);
    their local bytes are live from the start."""

    def __init__(self, arguments=None):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {k: 0.0
                                              for k in _COLLECTIVE_KINDS}
        leaves = {id(t): t for t in (tree_leaves(arguments)
                                     if arguments is not None else [])
                  if isinstance(t, torch.Tensor)}
        self.argument_bytes = float(sum(
            _nbytes(t.to_local() if isinstance(t, DTensor) else t)
            for t in leaves.values()))
        self.live_bytes = self.argument_bytes
        self.peak_bytes = self.argument_bytes

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())

    @property
    def temp_bytes(self) -> float:
        """The peak above the arguments (XLA's ``temp_size_in_bytes``)."""
        return self.peak_bytes - self.argument_bytes

    def _release(self, n: int) -> None:
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # a DTensor op returns NotImplemented here: DTensor lowers it to
        # collectives and local ops, which come back through this mode
        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return out
        flat = tree_flatten((args, kwargs))[0]
        if any(isinstance(a, FakeTensor)
               for a in flat + tree_flatten(out)[0]):
            return out      # DTensor's run for the global output shape
        name = func._opname
        packet = func._overloadpacket
        if func.namespace == "repro_torch" and name in _OP_FLOPS:
            self.flops += _OP_FLOPS[name](*args, **kwargs)
        elif packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        ins = [a for a in flat if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        if func.namespace in _FUNCOL and name in _COLLECTIVE_OPS:
            self.collectives[_COLLECTIVE_OPS[name]] += sum(map(_nbytes, outs))
        if func.is_view or name in _NO_BYTES:
            return out
        if name in _INDEXED_WRITES:
            # in place: the indices and values read, the values written
            self.bytes += sum(map(_nbytes, ins[1:])) + _nbytes(ins[-1])
        else:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for o in outs:
            if any(o is a for a in ins):     # written in place
                continue
            n = _nbytes(o)
            self.live_bytes += n
            weakref.finalize(o, self._release, n)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out


def analyze_program(cost: ProgramCost, arch: str, shape: str, mesh: str,
                    chips: int, model_flops: float,
                    hw: HW = HW()) -> RooflineReport:
    """The report of a step that ran under ``cost`` (the counterpart of
    the reference's ``analyze_compiled``)."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        flops_per_device=cost.flops, bytes_per_device=cost.bytes,
        collective_bytes_per_device=cost.collective_bytes,
        collective_breakdown=dict(cost.collectives),
        peak_memory_per_device=cost.peak_bytes,
        model_flops=model_flops, hw=hw)
