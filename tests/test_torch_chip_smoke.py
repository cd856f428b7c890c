"""A CPU rehearsal of ``chip_smoke.py``: every phase at a tiny size, with
the wrappers running their plain versions. It checks the script's paths,
shapes and checks; only a run on the card can show that the kernels
build and agree with the plain versions there."""
import torch

import chip_smoke
from repro_torch.core.ml.gbdt import default_models

CPU = torch.device("cpu")
KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


def test_kernel_phases_on_cpu():
    model, _ = default_models()
    small = chip_smoke.phase_gbdt_logits(CPU, model, 63, seed=1, reps=1)
    assert small["bit_identical"] and small["rows_agree_numpy"] == 63
    assert small["max_abs_err"] == 0.0
    grid = chip_smoke.phase_gbdt_grid_logits(CPU, model, 32, seed=3, reps=1)
    assert grid["bit_identical"] and grid["candidates"] == 63
    line = chip_smoke.kernel_line(small, grid, {"gbdt_logits": 2,
                                                "gbdt_grid_logits": 5})
    assert [k["name"] for k in line["kernels"]] == ["gbdt_logits",
                                                    "gbdt_grid_logits"]
    for k in line["kernels"]:
        assert set(k) == KEYS and k["bound_ms"] > 0.0
        assert k["bound_by"] in ("bytes", "operations")


def test_fleet_and_carat_phases_on_cpu():
    fleet = chip_smoke.phase_fleet(CPU, 96, 4, seed=0)
    assert fleet["within_rtol"] and fleet["max_rel"] < 1e-9
    carat = chip_smoke.phase_carat(CPU, 32, 20, seed=0, node_size=16,
                                   flip_at=5.0)
    assert carat["decision_count"] > 0 and carat["probe_batches"] > 0
    assert carat["actuations"].get("bootstrap", 0) > 0
