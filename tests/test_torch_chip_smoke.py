"""A CPU rehearsal of ``chip_smoke.py``: every phase at a tiny size, with
the wrappers running their plain versions. It checks the script's paths,
shapes and checks; only a run on the card can show that the kernels
build and agree with the plain versions there."""
import os
import shutil

import torch

import chip_smoke
from repro_torch.config import get_arch, reduced_config
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
    fa = chip_smoke.phase_flash_attention(CPU, 1, 96, 4, 2, 16, window=8,
                                          ragged_s=50, seed=4, reps=1)
    assert fa["max_abs_err"] == 0.0 and fa["library_ms"] > 0.0
    assert fa["bound_by"] == "bytes"
    # on the CPU the wrapper runs the plain version: neither kernel
    for case in (fa, fa["ragged_float32"], fa["window_bfloat16"]):
        assert case["launches"] == {"tensor_core": 0, "simt": 0}
    win = fa["window_bfloat16"]
    assert win["plain_ms"] > 0.0 and win["library_ms"] > 0.0
    assert win["max_abs_err"] == 0.0 and win["bound_ms"] > 0.0
    dec = chip_smoke.phase_decode_attention(CPU, 3, 8, 2, 16, path_s=64,
                                            path_len=40, s=128, step=37,
                                            seed=5, reps=1)
    # the path's shape at the top level, the long ragged cache beside it
    assert dec["shape"] == [3, 8, 2, 64, 16] and dec["cache"] == 64
    assert dec["lengths"] == [40, 40, 40] and dec["max_abs_err"] == 0.0
    assert dec["splits"] == 1 and dec["library_ms"] > 0.0
    assert dec["call_ms"] > 0.0 and dec["plain_ms"] > 0.0
    long = dec["long_cache"]
    assert long["lengths"] == [128, 91, 54] and long["max_abs_err"] == 0.0
    assert long["float32"]["max_abs_err"] == 0.0 and long["splits"] == 1
    assert long["bound_ms"] > dec["bound_ms"] > 0.0
    launches = {"gbdt_logits": 2, "gbdt_grid_logits": 5,
                "flash_attention": 40, "decode_attention": 640}
    line = chip_smoke.kernel_line(
        {"gbdt_logits": small, "gbdt_grid_logits": grid,
         "flash_attention": fa, "decode_attention": dec}, launches)
    assert [k["name"] for k in line["kernels"]] == list(launches)
    for k in line["kernels"]:
        assert set(k) == KEYS and k["bound_ms"] > 0.0
        assert k["bound_by"] in ("bytes", "operations")
        assert k["launches"] == launches[k["name"]]
        assert (k["library_ms"] is None) == k["name"].startswith("gbdt")


def test_fleet_and_carat_phases_on_cpu():
    fleet = chip_smoke.phase_fleet(CPU, 96, 4, seed=0)
    assert fleet["within_rtol"] and fleet["max_rel"] < 1e-9
    carat = chip_smoke.phase_carat(CPU, 32, 20, seed=0, node_size=16,
                                   flip_at=5.0)
    assert carat["decision_count"] > 0 and carat["probe_batches"] > 0
    assert carat["actuations"].get("bootstrap", 0) > 0


def test_lm_phases_on_cpu():
    cfg = reduced_config(get_arch("granite-3-2b"))
    cons = chip_smoke.phase_lm_consistency(CPU, cfg, batch=2, n_tokens=6,
                                           cache_len=8, seed=6)
    assert cons["max_abs_err"] <= chip_smoke.DECODE_ATOL
    serve = chip_smoke.phase_lm_serve(
        CPU, cfg, prefill_batch=2, prefill_len=16, n_requests=3, prompt0=4,
        prompt_step=2, max_new=3, cache_len=32, profile_steps=8, seed=7)
    assert serve["generate"]["prompt_lens"] == [4, 6, 8]
    assert serve["generate"]["decode_steps"] == 11
    assert serve["generate"]["tail_steps"] == 8
    assert serve["generate"]["tail_ms_per_step"] > 0.0
    # on the CPU the wrappers run their plain versions: no launches
    none = {"flash_attention": 0, "flash_attention_tc": 0,
            "decode_attention": 0}
    assert serve["prefill"]["launches"] == none
    assert serve["generate"]["launches"] == none
    assert cons["launches"] == none


def test_tensor_core_instruction_counts():
    """``phase_build``'s count of tensor-core instructions in a SASS
    listing, by opcode; None where the toolkit has no ``cuobjdump``."""
    sass = ("        /*0a50*/   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], "
            "RZ, !UPT ;\n"
            "        /*0a60*/   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;\n"
            "        /*0a70*/   HGMMA.64x64x16.F32.BF16 R24, R88, "
            "gdesc[UR8], R24 ;\n"
            "        /*0a80*/   FFMA R1, R2, R3, R1 ;\n")
    assert chip_smoke.tensor_core_counts(sass) == {"HGMMA": 2, "HMMA": 1}
    assert chip_smoke.tensor_core_counts("FFMA R1, R2, R3, R1 ;") == \
        {"HGMMA": 0, "HMMA": 0}
    if shutil.which("cuobjdump") is None and not os.path.exists(
            "/usr/local/cuda/bin/cuobjdump"):
        assert chip_smoke.sass_tensor_core_counts(
            chip_smoke.ROOT / "chip_smoke.py") is None
