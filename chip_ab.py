"""The turn loop shared by the A/B scripts (``chip_ab_*.py``).

An A/B script defines ``measure(tree) -> dict``, which runs ``tree``'s
``repro_torch`` on the card, and hands it to :func:`main`. ``main`` runs
it in turns (baseline, this, this, baseline), each turn in its own
process (the script itself with ``--measure TREE``), so that both trees
are measured on the same card within one run. Each turn prints one JSON
line; the last line gathers them with the card's name and power limit
as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
gives them.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent


def main(script: str, doc: str, measure: Callable[[Path], Dict],
         check: Optional[Callable[[List[Dict]], Dict]] = None) -> int:
    """Run the A/B of ``script`` (its ``__file__``) from ``sys.argv``:
    ``DIR`` (the baseline tree) drives the turns, ``--measure TREE`` is
    one turn; either fails without a CUDA device. ``check`` sees every turn; it returns the fields it adds to
    the last line, or raises ``RuntimeError`` to fail the run."""
    name = Path(script).stem
    measuring = len(sys.argv) == 3 and sys.argv[1] == "--measure"
    if not measuring and len(sys.argv) != 2:
        print(doc, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print(f"{name}: no CUDA device", file=sys.stderr)
        return 1
    if measuring:
        print(json.dumps(measure(Path(sys.argv[2]))), flush=True)
        return 0
    base = Path(sys.argv[1]).resolve()
    turns = []
    for label, tree in (("baseline", base), ("this", ROOT), ("this", ROOT),
                        ("baseline", base)):
        proc = subprocess.run(
            [sys.executable, str(Path(script).resolve()), "--measure",
             str(tree)], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        turn = {"turn": len(turns), "label": label,
                **json.loads(proc.stdout.strip().splitlines()[-1])}
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    try:
        extra = check(turns) if check is not None else {}
    except RuntimeError as err:
        print(f"{name}: {err}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, **extra,
                      "turns": [t["label"] for t in turns]}), flush=True)
    return 0
