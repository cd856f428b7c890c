#!/usr/bin/env python3
"""A/B of the port's GBDT kernels against another tree's, on one GPU.

Times ``gbdt_logits`` and ``gbdt_grid_logits`` at the shapes of CARAT's
path and runs the ``carat`` phase of ``chip_smoke.py`` once with this
tree's ``repro_torch`` and once with the baseline tree's, in the turns
of ``chip_ab.py`` (baseline, this, this, baseline, each in its own
process, on the same card within one run). Every turn holds its
kernels bit-identical to ``ObliviousGBDT.decision_function`` and to the
CPU grid scorer, and must make the same CARAT decisions.

The kernels are timed by CUDA-graph replay (``ms``), beside the
wrappers' host time per call (``call_ms``, an event-timed loop of
calls). Usage (one CUDA device), with a baseline checkout at DIR, e.g.
``git archive <commit> | tar -x -C DIR``::

    python3 chip_ab_gbdt.py DIR

Each turn prints one JSON line; the last line gathers them with the
card's name and power limit.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict

import numpy as np

import chip_ab


def measure(tree: Path) -> Dict:
    """One turn: ``tree``'s ``repro_torch`` on the card."""
    import chip_smoke
    sys.path.insert(0, str(tree / "src"))    # ahead of chip_smoke's own
    import torch
    from repro_torch.configs.carat_defaults import SPACES
    from repro_torch.core.ml.gbdt import default_models
    from repro_torch.kernels.gbdt_infer.kernel import (gbdt_grid_logits,
                                                       gbdt_logits)
    from repro_torch.kernels.gbdt_infer.ops import GridGBDTScorer, pack_gbdt
    import repro_torch
    chip_smoke.gate(Path(repro_torch.__file__).resolve().is_relative_to(
        tree.resolve()), f"repro_torch did not come from {tree}")
    dev = torch.device("cuda", 0)
    m_read, m_write = default_models()
    out = {"tree": str(tree)}
    for name, model, rows, reps in (("logits_read_63", m_read, 63, 200),
                                    ("logits_write_63", m_write, 63, 200),
                                    ("logits_read_258048", m_read, 258_048,
                                     50)):
        X = chip_smoke.rng(1).normal(
            size=(rows, model.n_features)).astype(np.float32)
        packed = pack_gbdt(model, dev)
        args = (torch.from_numpy(X).to(dev), packed.feat, packed.thr,
                packed.leaf, packed.base)
        chip_smoke.gate(np.array_equal(gbdt_logits(*args).cpu().numpy(),
                                       model.decision_function(X)),
                        f"{name}: gbdt_logits differs from numpy")
        out[name] = {
            "ms": chip_smoke.graph_ms(lambda: gbdt_logits(*args), dev, reps),
            "call_ms": chip_smoke.time_ms(lambda: gbdt_logits(*args), dev,
                                          reps)}
    theta = SPACES.theta_features()
    sc = GridGBDTScorer(m_read, theta, device=dev)
    H = chip_smoke.rng(3).normal(size=(4096, sc.n_h)).astype(np.float32)
    chip_smoke.gate(np.array_equal(
        sc(H), GridGBDTScorer(m_read, theta, device="cpu")(H)),
        "gbdt_grid_logits differs from the CPU scorer")
    args = (torch.from_numpy(H).to(dev), sc.cfeat, sc.thr, sc.idx_theta,
            sc.leaf_flat)
    out["grid_read_4096"] = {
        "ms": chip_smoke.graph_ms(lambda: gbdt_grid_logits(*args), dev, 50),
        "call_ms": chip_smoke.time_ms(lambda: gbdt_grid_logits(*args), dev,
                                      50)}
    carat = chip_smoke.phase_carat(dev, 4096, 20, seed=0, node_size=16,
                                   flip_at=5.0)
    keep = ("decision_count", "actuations", "launches", "ms_per_interval",
            "breakdown_ms_per_interval", "device_busy_ms_per_interval",
            "device_busy_share_traced", "gbdt_device_ms_per_interval",
            "gbdt_traced_launches", "heaviest_device_ms")
    out["carat"] = {k: carat[k] for k in keep}
    return out


def same_decisions(turns) -> Dict:
    """The trees must make the same CARAT decisions in every turn."""
    decisions = {json.dumps([t["carat"][k] for k in
                             ("decision_count", "actuations", "launches")],
                            sort_keys=True) for t in turns}
    if len(decisions) != 1:
        raise RuntimeError(f"the trees made different decisions: "
                           f"{decisions}")
    return {"same_decisions": True}


if __name__ == "__main__":
    sys.exit(chip_ab.main(__file__, __doc__, measure, same_decisions))
