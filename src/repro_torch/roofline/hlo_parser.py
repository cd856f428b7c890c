"""Trip-count-aware HLO cost model (a copy of
``repro/roofline/hlo_parser.py``).

PyTorch emits no HLO: the port keeps the parser for the text the JAX
package's compiled programs give (``compiled.as_text()``), so both
packages read one program's costs alike. The port's own dry run counts
its costs as it runs (``roofline/analysis.py``).

XLA's ``compiled.cost_analysis()`` counts while-loop bodies ONCE (scan(2)
and scan(8) report identical flops), which
under-counts scan-over-layers programs by ~n_layers. This parser walks the
post-partitioning HLO text instead and propagates multipliers through the
call graph:

  while ops  -> body (and cond) weighted by backend_config known_trip_count
  fusion ops -> flops recurse into the fused computation; bytes counted at
                the call site (fusion internals live in registers/VMEM)
  call ops   -> recurse x1
  conditional-> max across branches

Costs:
  flops            2 * prod(out_shape) * prod(contracted dims) per dot,
                   conv counted via output x kernel volume
  bytes            sum of operand + output bytes per surface op
                   (XLA's own "bytes accessed" convention, trip-aware)
  collectives      output bytes per op kind, trip-aware
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
    "f64": 8, "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "token": 0,
}

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

_TYPE_RE = re.compile(r"(\w+)\[([\d,]*)\](?:\{[^}]*\})?")
_LINE_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(\([^()]*\)|[\w\[\],{} ]+?)\s+"
    r"([\w\-]+)\((.*)$")
_PARAM_RE = re.compile(r"%([\w.\-]+)\s*=\s*([^ ]+)\s+parameter\((\d+)\)")
_CALLS_RE = re.compile(r"calls=%([\w.\-]+)")
_TO_APPLY_RE = re.compile(r"to_apply=%([\w.\-]+)")
_BODY_RE = re.compile(r"body=%([\w.\-]+)")
_COND_RE = re.compile(r"condition=%([\w.\-]+)")
_TRIP_RE = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_BRANCHES_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_OPERAND_RE = re.compile(r"%([\w.\-]+)")


def _parse_type(ts: str) -> List[Tuple[str, Tuple[int, ...]]]:
    """'bf16[2,3]{1,0}' or '(f32[2], s32[])' -> [(dtype, shape), ...]."""
    out = []
    for m in _TYPE_RE.finditer(ts):
        dt, dims = m.groups()
        if dt not in _DTYPE_BYTES:
            continue
        shape = tuple(int(d) for d in dims.split(",") if d) if dims else ()
        out.append((dt, shape))
    return out


def _type_bytes(ts: str) -> float:
    total = 0.0
    for dt, shape in _parse_type(ts):
        n = 1
        for d in shape:
            n *= d
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclass
class _Op:
    name: str
    type_str: str
    opcode: str
    rest: str           # everything after the '(' of the operand list


@dataclass
class _Computation:
    name: str
    ops: List[_Op] = field(default_factory=list)
    shapes: Dict[str, str] = field(default_factory=dict)   # var -> type str


@dataclass
class HloCost:
    flops: float = 0.0
    bytes: float = 0.0
    collectives: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})

    def add(self, other: "HloCost", mult: float = 1.0,
            bytes_too: bool = True) -> None:
        self.flops += other.flops * mult
        if bytes_too:
            self.bytes += other.bytes * mult
            for k in COLLECTIVE_KINDS:
                self.collectives[k] += other.collectives[k] * mult

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())


_SKIP_BYTES_OPS = {
    "parameter", "constant", "tuple", "get-tuple-element", "bitcast",
    "after-all", "partition-id", "replica-id", "iota",
}


def parse_hlo_module(text: str) -> Dict[str, _Computation]:
    comps: Dict[str, _Computation] = {}
    cur: Optional[_Computation] = None
    for raw in text.splitlines():
        line = raw.rstrip()
        header = re.match(r"^(?:ENTRY\s+)?%([\w.\-]+)\s*\((.*)\)\s*->.*\{",
                          line)
        if header and not line.lstrip().startswith("%param"):
            cur = _Computation(header.group(1))
            comps[cur.name] = cur
            continue
        if cur is None:
            continue
        if line.strip() == "}":
            cur = None
            continue
        m = _LINE_RE.match(line)
        if not m:
            continue
        name, type_str, opcode, rest = m.groups()
        cur.shapes[name] = type_str
        cur.ops.append(_Op(name, type_str, opcode, rest))
    return comps


def _dot_flops(op: _Op, comp: _Computation) -> float:
    out = _parse_type(op.type_str)
    if not out:
        return 0.0
    out_elems = 1
    for d in out[0][1]:
        out_elems *= d
    # contracted dims from the lhs operand's shape
    mm = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", op.rest)
    operands = _OPERAND_RE.findall(op.rest.split(")")[0])
    k = 1
    if mm and operands:
        lhs_type = comp.shapes.get(operands[0])
        if lhs_type:
            parsed = _parse_type(lhs_type)
            if parsed:
                lhs_shape = parsed[0][1]
                for idx in (int(i) for i in mm.group(1).split(",") if i):
                    if idx < len(lhs_shape):
                        k *= lhs_shape[idx]
    return 2.0 * out_elems * k


def _conv_flops(op: _Op, comp: _Computation) -> float:
    out = _parse_type(op.type_str)
    operands = _OPERAND_RE.findall(op.rest.split(")")[0])
    if not out or len(operands) < 2:
        return 0.0
    out_elems = 1
    for d in out[0][1]:
        out_elems *= d
    rhs_type = comp.shapes.get(operands[1])
    k = 1
    if rhs_type:
        parsed = _parse_type(rhs_type)
        if parsed:
            kernel = parsed[0][1]
            for d in kernel[:-1]:      # all but output-feature dim
                k *= d
    return 2.0 * out_elems * k


def analyze_hlo(text: str) -> HloCost:
    comps = parse_hlo_module(text)
    entry = None
    for raw in text.splitlines():
        m = re.match(r"^ENTRY\s+%([\w.\-]+)", raw)
        if m:
            entry = m.group(1)
            break
    if entry is None:       # fall back: last computation
        entry = list(comps)[-1] if comps else None
    memo: Dict[str, HloCost] = {}

    def cost_of(name: str) -> HloCost:
        if name in memo:
            return memo[name]
        memo[name] = HloCost()          # break cycles defensively
        comp = comps.get(name)
        if comp is None:
            return memo[name]
        total = HloCost()
        for op in comp.ops:
            oc = op.opcode
            # --- flops ------------------------------------------------------
            if oc == "dot":
                total.flops += _dot_flops(op, comp)
            elif oc == "convolution":
                total.flops += _conv_flops(op, comp)
            # --- bytes (call-site view) --------------------------------------
            if oc not in _SKIP_BYTES_OPS and oc != "while":
                b = _type_bytes(op.type_str)
                operand_part = op.rest.split("), ")[0]
                for var in _OPERAND_RE.findall(operand_part):
                    ts = comp.shapes.get(var)
                    if ts:
                        b += _type_bytes(ts)
                total.bytes += b
            # --- collectives --------------------------------------------------
            for k in COLLECTIVE_KINDS:
                if oc == k or oc.startswith(k + "-") or oc.startswith(k + "."):
                    total.collectives[k] += _type_bytes(op.type_str)
            # --- recursion -----------------------------------------------------
            if oc == "while":
                trip = 1
                tm = _TRIP_RE.search(op.rest)
                if tm:
                    trip = int(tm.group(1))
                bm = _BODY_RE.search(op.rest)
                if bm:
                    total.add(cost_of(bm.group(1)), mult=trip)
                cm = _COND_RE.search(op.rest)
                if cm:
                    total.add(cost_of(cm.group(1)), mult=trip)
            elif oc == "fusion":
                fm = _CALLS_RE.search(op.rest)
                if fm:
                    # flops recurse into fused bodies; bytes already counted
                    # at the call site (fusion internals don't touch HBM)
                    total.add(cost_of(fm.group(1)), mult=1.0, bytes_too=False)
            elif oc == "call":
                fm = _TO_APPLY_RE.search(op.rest)
                if fm:
                    total.add(cost_of(fm.group(1)))
            elif oc == "conditional":
                bm = _BRANCHES_RE.search(op.rest)
                if bm:
                    branches = _OPERAND_RE.findall(bm.group(1))
                    costs = [cost_of(b) for b in branches]
                    if costs:
                        best = max(costs, key=lambda c: c.flops + c.bytes)
                        total.add(best)
        memo[name] = total
        return total

    return cost_of(entry) if entry else HloCost()
