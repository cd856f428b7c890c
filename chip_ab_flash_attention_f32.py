#!/usr/bin/env python3
"""A/B of the port's float32 flash attention (K2's training path)
against another tree's, on one GPU.

Times ``flash_attention`` in float32 by CUDA-graph replay at the seven
training shapes of ``chip_smoke.py`` and two reduced ones (batch 8, S
256: granite-3-2b
32/8 D 64 causal, hubert-xlarge 16/16 D 80 bidirectional,
moonshot-v1-16b-a3b 16/16 D 128 causal, MLA 128/128 D 192 with v padded
from 128, recurrentgemma-2b 10/1 D 256 window 2048, h2o-danube-1.8b's
heads 32/8 D 80 with a window of 128; and the ``fa_simt_d256`` shape, B
2, 10/1, S 512, D 256, window 2048; the reduced archs' heads at S 64,
granite's 4/1 D 16 and deepseek's MLA 4/4 D 24), beside
``scaled_dot_product_attention`` on the same inputs (a boolean mask for
a window) and a float32 ``torch.matmul`` of the same Q Kᵀ with TF32 off
(a rate check of the card's float32 products). Once with this tree's
``repro_torch`` and once with the baseline tree's, in the turns of
``chip_ab.py`` (baseline, this, this, baseline, each in its own
process, on the same card within one run).

Every case is held to the plain version at float32's ``2e-5``, and
reports which of K2's kernels took it (the launch counters), the two
bounds (float32 operations over the 67 TFLOP/s outside the tensor
cores, and three TF32 products over 495 TFLOP/s; each the larger of
that and the bytes over 3.35 TB/s), the kernels SDPA ran (by name,
from a ``torch.profiler`` trace of its calls) and the registers and
spills of every kernel of the tree's flash-attention source from
``ptxas -v``, with the card's name and power limit.

Usage (one CUDA device), with a baseline checkout at DIR, e.g.
``git archive <commit> | tar -x -C DIR``::

    python3 chip_ab_flash_attention_f32.py DIR

``python3 chip_ab_flash_attention_f32.py --measure DIR`` runs one turn
on DIR's tree alone. Either needs a CUDA device. Each turn prints one
JSON line; the last line gathers them with the card's name and power
limit and each case's mean ms by tree.
"""
from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import chip_ab

# (case, B, Hq, Hkv, S, D, v_dim, causal, window)
CASES = (
    ("granite", 8, 32, 8, 256, 64, 64, True, 0),
    ("hubert", 8, 16, 16, 256, 80, 80, False, 0),
    ("moonshot", 8, 16, 16, 256, 128, 128, True, 0),
    ("mla", 8, 128, 128, 256, 192, 128, True, 0),
    ("recurrentgemma", 8, 10, 1, 256, 256, 256, True, 2048),
    ("danube_window128", 8, 32, 8, 256, 80, 80, True, 128),
    ("fa_simt_d256", 2, 10, 1, 512, 256, 256, True, 2048),
    # the reduced archs' heads at lm_train (a)'s batch: granite's D 16
    # (GQA 4/1) and deepseek's MLA D 24 (v padded from 16)
    ("reduced_d16", 8, 4, 1, 64, 16, 16, True, 0),
    ("reduced_mla_d24", 8, 4, 4, 64, 24, 16, True, 0),
)
REPS = 20
PROFILED_CALLS = 5


def _ptxas(tree: Path) -> Dict[str, Dict]:
    """Registers and spills of every kernel of ``tree``'s flash-attention
    source, from a fresh ``nvcc`` with its own flags (a library built
    earlier prints no report)."""
    import chip_smoke
    from repro_torch.kernels.flash_attention import kernel as fa
    report = chip_ab.nvcc_report(fa.SOURCE)
    return {re.sub(r"^_ZN\d*_GLOBAL__N__\w+?\d+", "", k): v
            for k, v in chip_smoke.ptxas_entries(report, "kernel").items()}


def _kernel_names(trace) -> Dict[str, int]:
    """Each device kernel of a trace by (shortened) name, with its
    launches."""
    out: Dict[str, int] = {}
    for e in trace.events:
        if e.get("cat") == "kernel":
            name = e["name"].replace("(anonymous namespace)::", "")[:90]
            out[name] = out.get(name, 0) + 1
    return out


def measure(tree: Path) -> Dict:
    """One turn: ``tree``'s ``repro_torch`` on the card."""
    import chip_smoke
    sys.path.insert(0, str(tree / "src"))    # ahead of chip_smoke's own
    import torch
    import torch.nn.functional as F
    import repro_torch
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                          flash_attention_ref)
    chip_smoke.gate(Path(repro_torch.__file__).resolve().is_relative_to(
        tree.resolve()), f"repro_torch did not come from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    out: Dict = {"tree": str(tree), "card": smi}
    fa.LIBRARY.get()
    out["ptxas"] = _ptxas(tree)
    for i, (name, b, hq, hkv, s, d, v_dim, causal, window) in enumerate(
            CASES):
        g = chip_smoke._generator(dev, 70 + i)
        q, k, v = chip_smoke._randn(g, dev, torch.float32, (b, hq, s, d),
                                    (b, hkv, s, d), (b, hkv, s, v_dim))
        v = F.pad(v, (0, d - v_dim))
        kw = dict(causal=causal, window=window)
        before = dict(fa.launches)
        got = fa.flash_attention(q, k, v, **kw)
        chip_smoke.sync(dev)
        launches = {key: n - before[key] for key, n in fa.launches.items()}
        chip_smoke.gate(launches["flash_attention"] == 1,
                        f"{name}: flash_attention launched {launches}")
        res = chip_smoke._check_close(f"flash_attention {name}", got,
                                      flash_attention_ref(q, k, v, **kw))
        res["padded_columns_zero"] = bool(
            (got[..., v_dim:] == 0).all().item())
        chip_smoke.gate(res["padded_columns_zero"],
                        f"{name}: padded v columns gave non-zero output")
        res["launches"] = launches
        with torch.no_grad():
            res["ms"] = chip_smoke.graph_ms(
                lambda: fa.flash_attention(q, k, v, **kw), dev, REPS)
            if window > 0:
                lib_kw = {"attn_mask": attention_mask(
                    s, s, causal=causal, window=window, device=dev)}
            else:
                lib_kw = {"is_causal": causal}
            res["library_ms"], res["library_gqa"] = chip_smoke._library_ms(
                dev, REPS, q, k, v, timer=chip_smoke.graph_ms, **lib_kw)
            with chip_smoke._traced(dev) as prof:
                for _ in range(PROFILED_CALLS):
                    chip_smoke._library_ms(dev, 1, q, k, v,
                                           timer=lambda f, *_: f(), **lib_kw)
            res["library_kernels"] = _kernel_names(
                chip_smoke._Trace.of(prof))
            # the same Q Kᵀ as one float32 matmul (TF32 off): the card's
            # float32 product rate outside the tensor cores
            qm = q.reshape(b * hkv, (hq // hkv) * s, d)
            km = k.reshape(b * hkv, s, d).transpose(1, 2)
            res["matmul_qk_ms"] = chip_smoke.graph_ms(
                lambda: torch.matmul(qm, km), dev, REPS)
            res["matmul_qk_tflops"] = (2 * qm.numel() * s
                                       / res["matmul_qk_ms"] / 1e9)
        pairs = b * hq * chip_smoke._attn_pairs(s, s, causal, window)
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
        res["bound_f32"] = chip_smoke.bound(nbytes, 4 * d * pairs)
        res["bound_3xtf32"] = chip_smoke.bound(
            nbytes, 3 * 4 * d * pairs, chip_smoke.H100_TF32_OPS_PER_S)
        out[name] = {"shape": [b, hq, hkv, s, d], "v_dim": v_dim,
                     "causal": causal, "window": window, **res}
        del q, k, v, got
        torch.cuda.empty_cache()
    return out


def check(turns: List[Dict]) -> Dict:
    """Each case's ms by tree (the mean of its two turns), the ratio of
    this tree's to the baseline's, whether this tree was faster in each
    of its turns than in each of the baseline's, and SDPA's ms."""
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
                     "library_ms": turns[1][name]["library_ms"],
                     "this_launches": turns[1][name]["launches"]}
    return {"cases": out}


if __name__ == "__main__":
    sys.exit(chip_ab.main(__file__, __doc__, measure, check))
