"""A CPU rehearsal of ``chip_smoke.py``: every phase at a tiny size, with
the wrappers running their plain versions. It checks the script's paths,
shapes and checks; only a run on the card can show that the kernels
build and agree with the plain versions there."""
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
    dec = chip_smoke.phase_decode_attention(CPU, 3, 8, 2, 16, 128, step=37,
                                            seed=5, reps=1)
    assert dec["lengths"] == [128, 91, 54] and dec["max_abs_err"] == 0.0
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
    assert serve["generate"]["launches"] == {"flash_attention": 0,
                                             "decode_attention": 0}
