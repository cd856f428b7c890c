#!/usr/bin/env python3
"""A/B of the port's flash-attention tensor-core kernel against another
tree's, on one GPU.

Times ``flash_attention`` (bfloat16, the ``wgmma`` kernel) at every
prefill shape of the LM paths, with ``chip_smoke.py``'s
``phase_prefill_attention``: granite-3-2b (D 64, causal and window 512),
moonshot-v1-16b-a3b (D 128), MLA (D 192, v padded), recurrentgemma-2b
(MQA 10/1, D 256, window 2048, at S 2048 and 4096), paligemma-3b (MQA
8/1, D 256) and hubert-xlarge (D 80, bidirectional); once with this
tree's ``repro_torch`` and once with the baseline tree's, in the turns
of ``chip_ab.py`` (baseline, this, this, baseline, each in its own
process, on the same card within one run). Every turn holds the
kernel to its plain version (bfloat16 ``2e-2`` and the row rule) and
reports each panel count's registers and spills from ``ptxas``.

Usage (one CUDA device), with a baseline checkout at DIR, e.g.
``git archive <commit> | tar -x -C DIR``::

    python3 chip_ab_flash_attention.py DIR

Each turn prints one JSON line; the last line gathers them with the
card's name and power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict

import chip_ab

# (name, B, Hq, Hkv, S, D, v_dim, causal, window)
SHAPES = (
    ("granite", 4, 32, 8, 2048, 64, 64, True, 0),
    ("granite_window512", 4, 32, 8, 2048, 64, 64, True, 512),
    ("moonshot", 4, 16, 16, 2048, 128, 128, True, 0),
    ("mla", 4, 128, 128, 2048, 192, 128, True, 0),
    ("recurrentgemma", 4, 10, 1, 2048, 256, 256, True, 2048),
    ("recurrentgemma_4096", 4, 10, 1, 4096, 256, 256, True, 2048),
    ("paligemma", 4, 8, 1, 2048, 256, 256, True, 0),
    ("hubert", 4, 16, 16, 2048, 80, 80, False, 0),
)
KEEP = ("ms", "call_ms", "max_abs_err", "max_row_rel_err", "library_ms",
        "bound_ms")


def measure(tree: Path) -> Dict:
    """One turn: ``tree``'s ``repro_torch`` on the card."""
    import chip_smoke
    sys.path.insert(0, str(tree / "src"))    # ahead of chip_smoke's own
    import torch
    import repro_torch
    from repro_torch.kernels.flash_attention import kernel as fa
    chip_smoke.gate(Path(repro_torch.__file__).resolve().is_relative_to(
        tree.resolve()), f"repro_torch did not come from {tree}")
    dev = torch.device("cuda", 0)
    _, report = fa.LIBRARY.build()
    out = {"tree": str(tree),
           "ptxas": {name.split("flash_attention_tc_kernel")[1][:6]: v
                     for name, v in chip_smoke.ptxas_entries(
                         report, "flash_attention_tc_kernel").items()}}
    for name, b, hq, hkv, s, d, v_dim, causal, window in SHAPES:
        res = chip_smoke.phase_prefill_attention(
            dev, name, b, hq, s, d, v_dim, seed=40, reps=10, hkv=hkv,
            causal=causal, window=window)
        out[name] = {k: res[k] for k in KEEP}
        chip_smoke._free(dev)
    return out


if __name__ == "__main__":
    sys.exit(chip_ab.main(__file__, __doc__, measure))
