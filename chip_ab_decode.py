#!/usr/bin/env python3
"""A/B of the port's decode step against another tree's, on one GPU.

Times ``LanguageModel.decode_step`` (bfloat16 weights and cache, batch 8,
a 1,024-slot cache) at full width and depth for granite-3-2b (40 layers,
Hq 32/Hkv 8) and internlm2-20b (48 layers, Hq 48/Hkv 8): 16 warm-up
steps, then three runs of 96 steps, each run's wall milliseconds per step
(the step is host-bound: the card idles most of it). Once with this
tree's ``repro_torch`` and once with the baseline tree's, in the turns
of ``chip_ab.py`` (baseline, this, this, baseline, each in its own
process, on the same card within one run). The weights, tokens and
positions come from fixed seeds, so every turn must give the same last
logits bit for bit (a gate), and every cache tensor must keep its
``data_ptr()`` through the steps (reported).

Usage (one CUDA device), with a baseline checkout at DIR, e.g.
``git archive <commit> | tar -x -C DIR``::

    python3 chip_ab_decode.py DIR

Each turn prints one JSON line; the last line gathers them with the
card's name and power limit, and each arch's mean ms per step by tree.
"""
from __future__ import annotations

import hashlib
import sys
import time
from pathlib import Path
from typing import Dict, List

import chip_ab

ARCHS = ("granite-3-2b", "internlm2-20b")
BATCH, CACHE_LEN, WARM, RUNS, STEPS = 8, 1024, 16, 3, 96


def _decode(dev, cfg, seed: int) -> Dict:
    import torch
    from chip_smoke import sync
    from repro_torch.models.lm import build_model
    model = build_model(cfg, device=dev, dtype=torch.bfloat16)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    cache = model.init_cache(BATCH, CACHE_LEN, dtype=torch.bfloat16)
    ptrs = [t.data_ptr() for layer in cache
            for k, t in sorted(layer.items()) if k != "length"]
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (WARM + RUNS * STEPS, BATCH),
                           generator=g, device=dev)
    pos = torch.zeros(BATCH, dtype=torch.int32, device=dev)
    ms: List[float] = []
    with torch.inference_mode():
        step = 0
        for n in [WARM] + [STEPS] * RUNS:
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(n):
                logits, cache = model.decode_step(tokens[step], cache, pos)
                pos = pos + 1
                step += 1
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3 / n)
        kept = ptrs == [t.data_ptr() for layer in cache
                        for k, t in sorted(layer.items()) if k != "length"]
        last = logits.float().cpu()
    del model, cache
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"ms_per_step": ms[1:], "cache_addresses_kept": kept,
            "logits_sha256": hashlib.sha256(
                last.numpy().tobytes()).hexdigest(),
            "logits_finite": bool(torch.isfinite(last).all())}


def measure(tree: Path) -> Dict:
    """One turn: ``tree``'s ``repro_torch`` on the card."""
    import chip_smoke
    sys.path.insert(0, str(tree / "src"))    # ahead of chip_smoke's own
    import torch
    import repro_torch
    from repro_torch.config import get_arch
    chip_smoke.gate(Path(repro_torch.__file__).resolve().is_relative_to(
        tree.resolve()), f"repro_torch did not come from {tree}")
    dev = torch.device("cuda", 0)
    return {"tree": str(tree),
            **{name: _decode(dev, get_arch(name), seed=23)
               for name in ARCHS}}


def check(turns: List[Dict]) -> Dict:
    """Every turn's logits equal and finite; each arch's mean ms per step
    for each tree."""
    out = {}
    for name in ARCHS:
        runs = [t[name] for t in turns]
        if len({r["logits_sha256"] for r in runs}) != 1 or not all(
                r["logits_finite"] for r in runs):
            raise RuntimeError(f"{name}: the turns' logits differ")
        out[name] = {label: sum(sum(t[name]["ms_per_step"]) / RUNS
                                for t in turns if t["label"] == label) / 2
                     for label in ("baseline", "this")}
    return out


if __name__ == "__main__":
    sys.exit(chip_ab.main(__file__, __doc__, measure, check))
