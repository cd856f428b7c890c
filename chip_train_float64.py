#!/usr/bin/env python3
"""Where a reduced arch's train steps on the card part from the CPU's,
held to a float64 gradient.

Runs ``chip_smoke.py``'s ``_train_parity`` for each ``--arch`` at the
given depth, steps, batch, sequence and seeds (the card against the CPU,
every bar as there; a failed gate is reported, not raised), then, at the
``--top`` elements whose parameters after the steps lie furthest apart,
reports the first step's gradient there on the card, on the CPU in
float32 and on the CPU in float64: the same weights and batch through
the same model with every float32 cast on its training path widened
(the norms and rope, the router, the SSM and RG-LRU scans, attention's
plain version, the cross-entropy). Beside them: the element's slack
(``_Updates.slack``), the leaf's largest distance of each float32
gradient from the float64 one, and the leaf's gradient bar. With one
step the first step's gradient is the one AdamW took.

Usage (one CUDA device; ``--device cpu`` runs both sides on the CPU)::

    python3 chip_train_float64.py --arch moonshot-v1-16b-a3b --steps 1 \
        --seq 32 --batch 4 --seeds 2 3

One JSON line per arch, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def grads64(cfg, kept: Dict) -> List:
    """The first step's gradients of ``kept``'s initial weights and
    batch, in float64 on the CPU, as numpy arrays."""
    return chip_smoke.float64_grads(cfg, kept["init"],
                                    kept["batches"][0])[1]


def diagnose(dev, cfg, steps: int, seq: int, batch: int, seeds, top: int
             ) -> Dict:
    kept: Dict = {}
    try:
        res = chip_smoke._train_parity(dev, cfg, steps=steps, seq=seq,
                                       batch=batch, seeds=tuple(seeds),
                                       keep=kept)
        failed = None
    except RuntimeError as e:
        res, failed = None, str(e)
    g64 = grads64(cfg, kept)
    card, cpu = kept["card"], kept["cpu"]
    errs = [np.abs(a.double().numpy() - b.double().numpy())
            for a, b in zip(card["params"], cpu["params"])]
    flat = [(float(e.flat[j]), i, int(j)) for i, e in enumerate(errs)
            for j in np.argsort(e, axis=None)[-top:]]
    rows = []
    for err, i, j in sorted(flat, reverse=True)[:top]:
        g_card = card["grads"][i].double().numpy()
        g_cpu = cpu["grads"][i].double().numpy()
        rows.append({
            "path": kept["paths"][i],
            "index": [int(x) for x in np.unravel_index(j, errs[i].shape)],
            "param_abs_err": err, "slack": float(kept["slacks"][i].flat[j]),
            "grad_float64": float(g64[i].flat[j]),
            "grad_card": float(g_card.flat[j]),
            "grad_cpu": float(g_cpu.flat[j]),
            "leaf_card_vs_float64": float(np.abs(g_card - g64[i]).max()),
            "leaf_cpu_vs_float64": float(np.abs(g_cpu - g64[i]).max()),
            "leaf_grad_bar": 1e-5 + 1e-4 * float(np.abs(g_cpu).max())})
    return {"arch": cfg.name, "layers": cfg.n_layers, "device": str(dev),
            "steps": steps, "seq": seq, "batch": batch,
            "seeds": list(seeds), "gates_passed": failed is None,
            "failed": failed,
            "step_grad_worst": None if res is None
            else res["step_grad_worst"],
            "param_worst": None if res is None else res["param_worst"],
            "param_slack": None if res is None else res["param_slack"],
            "worst_elements": rows}


def main() -> int:
    import torch
    from repro_torch.config import get_arch, reduced_config
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append", required=True)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seeds", type=int, nargs=2, default=(2, 3))
    ap.add_argument("--top", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in args.arch:
        cfg = reduced_config(get_arch(name))
        if args.layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        print(json.dumps(diagnose(dev, cfg, args.steps, args.seq,
                                  args.batch, args.seeds, args.top)),
              flush=True)
    if dev.type == "cuda":
        print(json.dumps(chip_smoke.phase_device(dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
