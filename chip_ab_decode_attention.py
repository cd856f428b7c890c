#!/usr/bin/env python3
"""A/B of the port's decode-attention kernel (K3) against another tree's,
on one GPU.

Times ``decode_attention`` in bfloat16 by CUDA-graph replay at the six
decode shapes of the LM serving paths (batch 8; granite-3-2b 32/8 D 64,
moonshot-v1-16b-a3b 16/16 D 128, internlm2-20b 48/8 D 128,
command-r-plus-104b 96/8 D 128, recurrentgemma-2b 10/1 D 256,
paligemma-3b 8/1 D 256), each at the path's cache (1,024 positions,
every length 512) and at a long ragged cache (4,096 positions, lengths
4096 - 37 i), beside ``scaled_dot_product_attention`` with a length
mask on the same inputs. Besides: the cost model's probes (paligemma's
heads at lengths 128 and 1,024 in a 1,024 cache, and at D 128 with
twice the positions, the same bytes as D 256) and the float32 path
at the six shapes. Once with this tree's
``repro_torch`` and once with the baseline tree's, in the turns of
``chip_ab.py`` (baseline, this, this, baseline, each in its own
process, on the same card within one run).

Every case is held to the plain version (bfloat16 ``2e-2`` and the row
rule, float32 ``2e-5``). Each turn also reports every kernel's device
time per call from a ``torch.profiler`` trace of 50 calls, by kernel
name, with the grid, block, registers and shared memory the trace
records (a trace must hold every launch of each: one that does not is
taken again, up to ``TRACE_TRIES`` times, and the tries are reported);
where the tree has ``launch_parts``, the split and the combine kernel
each timed alone by graph replay;
the blocks of the split kernel that have keys to read; the registers
and spills of each template instance from ``ptxas -v``; and the card's
name and power limit.

Usage (one CUDA device), with a baseline checkout at DIR, e.g.
``git archive <commit> | tar -x -C DIR``::

    python3 chip_ab_decode_attention.py DIR

``python3 chip_ab_decode_attention.py --measure DIR`` runs one turn on
DIR's tree alone. Either needs a CUDA device. Each turn prints one JSON line; the last line gathers
them with the card's name and power limit and each case's mean ms by
tree.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List

import chip_ab

# (case, B, Hq, Hkv, D, cache, lengths, dtype); lengths "path" is every
# row at 512, "long" is 4096 - 37 i, an int is every row at that length
PATH_SHAPES = (
    ("granite", 32, 8, 64),
    ("moonshot", 16, 16, 128),
    ("internlm2", 48, 8, 128),
    ("command_r_plus", 96, 8, 128),
    ("recurrentgemma", 10, 1, 256),
    ("paligemma", 8, 1, 256),
)
B = 8
CASES = tuple(
    (f"{name}{suffix}", B, hq, hkv, d, cache, lengths, "bfloat16")
    for name, hq, hkv, d in PATH_SHAPES
    for suffix, cache, lengths in (("", 1024, "path"),
                                   ("_long", 4096, "long"))) + (
    # the cost model's probes: paligemma's heads at other lengths, and at
    # D 128 with twice the positions (the bytes of D 256 at 512)
    ("paligemma_len128", B, 8, 1, 256, 1024, 128, "bfloat16"),
    ("paligemma_len1024", B, 8, 1, 256, 1024, 1024, "bfloat16"),
    ("paligemma_d128_len1024", B, 8, 1, 128, 2048, 1024, "bfloat16"),
) + tuple(
    # the float32 path (the SIMT split kernel)
    (f"{name}_f32", B, hq, hkv, d, 1024, "path", "float32")
    for name, hq, hkv, d in PATH_SHAPES)
REPS = 200
PROFILED_CALLS = 50
TRACE_TRIES = 3


def _lengths(spec, cache: int) -> List[int]:
    if spec == "path":
        return [512] * B
    if spec == "long":
        return [cache - 37 * i for i in range(B)]
    return [int(spec)] * B


def _ptxas(tree: Path) -> Dict[str, Dict]:
    """Registers and spills of every kernel of ``tree``'s decode-attention
    source, from a fresh ``nvcc`` with its own flags (a library built
    in an earlier turn prints no report)."""
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as dec
    with tempfile.TemporaryDirectory() as d:
        proc = subprocess.run(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o",
             os.path.join(d, "lib.so"), str(dec.SOURCE)],
            capture_output=True, text=True, timeout=600, check=True)
    report = proc.stdout + proc.stderr
    return {re.search(r"decode_[a-z_]*kernel\w*", k).group(0): v
            for k, v in chip_smoke.ptxas_entries(report, "kernel").items()}


def _kernels_of_trace(trace, calls: int) -> Dict[str, Dict]:
    """Each kernel's device us per call and the launch geometry the
    trace records for it."""
    out: Dict[str, Dict] = {}
    for e in trace.events:
        if e.get("cat") != "kernel":
            continue
        bare = e["name"].replace("(anonymous namespace)::", "")
        found = re.search(r"([A-Za-z_]\w*)\s*[<(]", bare)
        name = found.group(1) if found else bare[:60]
        row = out.setdefault(name, {"us_per_call": 0.0, "launches": 0})
        row["us_per_call"] += e["dur"] / calls
        row["launches"] += 1
        args = e.get("args", {})
        for key in ("grid", "block", "registers per thread",
                    "shared memory", "blocks per SM",
                    "est. achieved occupancy %"):
            if key in args:
                row[key] = args[key]
    return out


def measure(tree: Path) -> Dict:
    """One turn: ``tree``'s ``repro_torch`` on the card."""
    import chip_smoke
    sys.path.insert(0, str(tree / "src"))    # ahead of chip_smoke's own
    import torch
    import repro_torch
    from repro_torch.kernels.decode_attention import kernel as dec
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    chip_smoke.gate(Path(repro_torch.__file__).resolve().is_relative_to(
        tree.resolve()), f"repro_torch did not come from {tree}")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    out: Dict = {"tree": str(tree), "card": smi}
    dec.LIBRARY.get()
    out["ptxas"] = _ptxas(tree)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for i, (name, b, hq, hkv, d, cache, spec, dtype) in enumerate(CASES):
        dt = getattr(torch, dtype)
        lengths = _lengths(spec, cache)
        g = chip_smoke._generator(dev, 60 + i)
        q, k, v = chip_smoke._randn(g, dev, dt, (b, hq, d),
                                    (b, hkv, cache, d), (b, hkv, cache, d))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        before = dec.launches["decode_attention"]
        got = dec.decode_attention(q, k, v, lens)
        chip_smoke.sync(dev)
        chip_smoke.gate(dec.launches["decode_attention"] == before + 1,
                        f"{name}: decode_attention did not launch")
        res = chip_smoke._check_close(f"decode_attention {name}", got,
                                      decode_attention_ref(q, k, v, lens))
        res["ms"] = chip_smoke.graph_ms(
            lambda: dec.decode_attention(q, k, v, lens), dev, REPS)
        mask = (torch.arange(cache, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        res["library_ms"], _ = chip_smoke._library_ms(
            dev, REPS, q[:, :, None], k, v, timer=chip_smoke.graph_ms,
            attn_mask=mask)
        elt = q.element_size()
        res.update(chip_smoke.bound(
            2 * hkv * d * sum(lengths) * elt + 2 * elt * q.numel() + 4 * b,
            4 * d * hq * sum(lengths), chip_smoke.H100_BF16_OPS_PER_S))
        if hasattr(dec, "takes_tensor_cores"):
            tc = dec.takes_tensor_cores(q, k, v)
            res["splits"] = dec.decode_splits(b, hkv, hq // hkv, cache, d,
                                              sms, tc)
            res["blocks_with_work"] = dec.blocks_with_work(
                lengths, hkv, hq // hkv, res["splits"], tc)
        else:   # a tree from before the tensor-core kernel
            res["splits"] = dec.decode_splits(b, hkv, hq // hkv, cache, sms)
        for tries in range(1, TRACE_TRIES + 1):
            with chip_smoke._traced(dev) as prof:
                for _ in range(PROFILED_CALLS):
                    dec.decode_attention(q, k, v, lens)
            kernels = _kernels_of_trace(chip_smoke._Trace.of(prof),
                                        PROFILED_CALLS)
            held = {n: row["launches"] for n, row in kernels.items()}
            if held and set(held.values()) == {PROFILED_CALLS}:
                break
        chip_smoke.gate(set(held.values()) == {PROFILED_CALLS},
                        f"{name}: {TRACE_TRIES} traces of "
                        f"{PROFILED_CALLS} calls each, the last holding "
                        f"{held} launches")
        res["kernels"], res["trace_tries"] = kernels, tries
        if hasattr(dec, "launch_parts"):
            # the split and the combine alone, by graph replay
            _, ws = dec.launch_parts(q, k, v, lens, dec.SPLIT)
            res["parts_ms"] = {
                part: chip_smoke.graph_ms(lambda: dec.launch_parts(
                    q, k, v, lens, code, ws), dev, REPS)
                for part, code in (("split", dec.SPLIT),
                                   ("combine", dec.COMBINE))}
        out[name] = {"shape": [b, hq, hkv, cache, d], "dtype": dtype,
                     "lengths": spec, **res}
        del q, k, v, got
        torch.cuda.empty_cache()
    return out


def check(turns: List[Dict]) -> Dict:
    """Each case's ms by tree (the mean of its two turns), the ratio of
    this tree's to the baseline's, and whether this tree was faster in
    each of its turns than in each of the baseline's."""
    out = {}
    for name, *_ in CASES:
        by = {label: [t[name]["ms"] for t in turns if t["label"] == label]
              for label in ("baseline", "this")}
        mean = {label: sum(ms) / len(ms) for label, ms in by.items()}
        out[name] = {"baseline_ms": mean["baseline"],
                     "this_ms": mean["this"],
                     "this_over_baseline": mean["this"] / mean["baseline"],
                     "faster_in_every_turn":
                         max(by["this"]) < min(by["baseline"]),
                     "library_ms": turns[1][name]["library_ms"]}
    return {"cases": out}


if __name__ == "__main__":
    sys.exit(chip_ab.main(__file__, __doc__, measure, check))
