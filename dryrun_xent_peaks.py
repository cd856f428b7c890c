#!/usr/bin/env python3
"""Peak live bytes a device of a training cell: the reference's dry run
against the port's, on the CPU.

Does the port's cross entropy gather the vocab where the reference's
does not? Both packages split the logits over the model axis before the
loss; the port's ``_xent`` runs ``torch.log_softmax`` on that DTensor.
A gather of the vocab would show as a peak well above the reference's
for a cell whose logits are large. This script counts the ``train_4k``
cell of each arch named on the command line (default: paligemma-3b and
recurrentgemma-2b, vocabularies of 257,152 and 256,000) on the 16 x 16
production mesh with both dry runs, each in a process of its own:

* the reference's ``repro.launch.dryrun.run_cell`` with the mesh's axes
  made ``Auto`` (its sharding rules need them; jax's default Explicit
  axes break its dry run), peak = XLA's temp + argument + output bytes;
* the port's ``repro_torch.launch.dryrun.run_cell``, peak as its
  counter gives it (arguments plus the most temporaries live at once).

It prints one JSON line a cell and the ratio of the port's peak to the
reference's. Usage (CPU; ~5-15 min a cell for the reference's
compile)::

    python3 dryrun_xent_peaks.py [ARCH ...]
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPE = "train_4k"

REFERENCE = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax
from jax.sharding import AxisType
from repro.launch import dryrun
dryrun.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    (16, 16), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
rec = dryrun.run_cell(sys.argv[1], sys.argv[2], False, out_dir=sys.argv[3],
                      verbose=False)
print(json.dumps(rec))
"""

PORT = """
import sys, json
from repro_torch.launch.dryrun import run_cell
rec = run_cell(sys.argv[1], sys.argv[2], False, out_dir=sys.argv[3],
               verbose=False)
print(json.dumps(rec))
"""


def _run(script: str, arch: str, out_dir: str) -> dict:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", script, arch, SHAPE,
                           out_dir], env=env, capture_output=True,
                          text=True, timeout=3600)
    if proc.returncode != 0:
        raise RuntimeError(f"{arch}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(archs) -> int:
    for arch in archs:
        with tempfile.TemporaryDirectory() as d:
            ref = _run(REFERENCE, arch, d)
            port = _run(PORT, arch, d)
        ref_peak = ref.get("peak_memory_per_device")
        port_peak = port.get("peak_memory_per_device")
        print(json.dumps({
            "arch": arch, "shape": SHAPE, "mesh": "pod16x16",
            "reference": {"status": ref["status"],
                          "peak_bytes": ref_peak,
                          "compile_s": ref.get("compile_s")},
            "port": {"status": port["status"], "peak_bytes": port_peak},
            "port_over_reference": (port_peak / ref_peak
                                    if ref_peak and port_peak else None)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["paligemma-3b", "recurrentgemma-2b"]))
