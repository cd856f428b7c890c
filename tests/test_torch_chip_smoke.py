"""A CPU rehearsal of ``chip_smoke.py``: every phase at a tiny size, with
the wrappers running their plain versions. It checks the script's paths,
shapes and checks; only a run on the card can show that the kernels
build and agree with the plain versions there."""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
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
    assert small["call_ms"] > 0.0 and small["plain_ms"] > 0.0
    assert (small["blocks"], small["threads"]) == (1, 512)
    grid = chip_smoke.phase_gbdt_grid_logits(CPU, model, 32, seed=3, reps=1)
    assert grid["bit_identical"] and grid["candidates"] == 63
    assert grid["call_ms"] > 0.0 and grid["resident"]
    fa = chip_smoke.phase_flash_attention(CPU, 1, 96, 4, 2, 16, window=8,
                                          ragged_s=50, seed=4, reps=1)
    assert fa["max_abs_err"] == 0.0 and fa["library_ms"] > 0.0
    assert fa["bound_by"] == "bytes"
    # on the CPU the wrapper runs the plain version: neither kernel
    for case in (fa, fa["ragged_float32"], fa["window_bfloat16"]):
        assert case["launches"] == {"tensor_core": 0, "f32tc": 0,
                                    "simt": 0}
    win = fa["window_bfloat16"]
    assert win["plain_ms"] > 0.0 and win["library_ms"] > 0.0
    assert win["max_abs_err"] == 0.0 and win["bound_ms"] > 0.0
    dec = chip_smoke.phase_decode_attention(CPU, 3, 8, 2, 16, path_s=64,
                                            path_len=40, s=128, step=37,
                                            seed=5, reps=1)
    # the path's shape at the top level, the long ragged cache beside it
    assert dec["shape"] == [3, 8, 2, 64, 16] and dec["cache"] == 64
    assert dec["lengths"] == [40, 40, 40] and dec["max_abs_err"] == 0.0
    # the tensor-core kernel's splits (bfloat16 is timed): a 64-position
    # cache in splits of at least 32, every one with keys at lengths 40
    assert dec["splits"] == 2 and dec["library_ms"] > 0.0
    assert dec["blocks_with_work"] == 3 * 2 * 2
    assert dec["call_ms"] > 0.0 and dec["plain_ms"] > 0.0
    # on the CPU neither split kernel runs, and neither is timed alone
    assert dec["variants"] == {"tensor_core": 0, "simt": 0}
    assert dec["kernel_ms"] == {} and "kernel_traced" not in dec
    long = dec["long_cache"]
    assert long["lengths"] == [128, 91, 54] and long["max_abs_err"] == 0.0
    assert long["float32"]["max_abs_err"] == 0.0 and long["splits"] == 4
    # splits with keys: 4 of 128 (runs of 32), 3 of 91 (32, 32, 27), 4 of
    # 54 (runs of 16): 11 a kv head
    assert long["blocks_with_work"] == 2 * 11
    assert long["bound_ms"] > dec["bound_ms"] > 0.0
    train = chip_smoke.phase_flash_attention_train(CPU, 2, 4, 2, 16, 32,
                                                   reps=1)
    assert train["max_abs_err"] == 0.0 and train["grad_max_abs_err"] == 0.0
    launches = {"gbdt_logits": 2, "gbdt_grid_logits": 5,
                "flash_attention": 40, "flash_attention_f32tc": 80,
                "decode_attention": 640}
    line = chip_smoke.kernel_line(
        {"gbdt_logits": small, "gbdt_grid_logits": grid,
         "flash_attention": fa, "flash_attention_f32tc": train,
         "decode_attention": dec}, launches)
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


def test_deployment_phases_on_cpu():
    """The replay, sharded-fleet and sharded-CARAT phases at a small size:
    their gates (``rtol=1e-9``, bit-identical sharded CARAT on ``soa``,
    the one-block sharded CARAT on ``soa-torch`` equal to the ``carat``
    phase, plain-identical probe batches) hold with the plain
    versions."""
    replay = chip_smoke.phase_replay(CPU, 48, node_size=16, intervals=12,
                                     seed=8)
    assert replay["within_rtol"] and replay["max_rel_bytes"] < 1e-9
    assert replay["clients"] == replay["schedules"] == 48
    assert replay["workload_switches"] > 0
    assert replay["statics_uploads"] > 1
    fleet = chip_smoke.phase_sharded_fleet(CPU, 96, 4, seed=0, node_size=16,
                                           n_shards=4)
    assert fleet["within_rtol"] and fleet["max_rel"] < 1e-9
    assert fleet["shard_devices"] == ["cpu"] * 4
    assert fleet["blocks"] == 1 and fleet["max_rel"] == 0.0
    assert fleet["shard_clients"] == [32, 32, 16, 16]
    single = chip_smoke.phase_carat(CPU, 64, 20, seed=0, node_size=16,
                                    flip_at=5.0)
    carat = chip_smoke.phase_sharded_carat(CPU, 64, 20, seed=0,
                                           node_size=16, flip_at=5.0,
                                           n_shards=4, carat=single)
    assert carat["soa_sharded_identical"]
    assert carat["c"]["blocks"] == 1
    assert carat["c"]["identical_to_carat_phase"]
    assert carat["c"]["signature"] == single["signature"]
    for run in (carat["b"], carat["c"]):
        assert run["decision_count"] > 0 and run["probe_batches"] > 0
        assert run["actuations"].get("bootstrap", 0) > 0
        assert run["bus"]["max_staleness_seen"] == 0
        # on the CPU the wrappers run their plain versions: no launches
        assert run["launches"] == {"gbdt_logits": 0, "gbdt_grid_logits": 0}
    assert carat["b"]["backend"] == "soa"
    assert carat["c"]["backend"] == "soa-torch"
    assert carat["c"]["breakdown_ms_per_interval"]["fleet_step"] > 0.0



def test_process_phase_on_cpu(tmp_path):
    """The multi-process phase at a small size: 2 spawned workers on the
    scalar backend, the policy on the CPU. Its gates hold with the plain
    versions: (b) and (c) equal (a), the workers' bootstrap counters
    equal (a)'s picks, (c) respawns one worker and leaves one flight
    dump; and its lines carry every span, the bus counts and the
    spawn counts."""
    out = chip_smoke.phase_process_carat(
        CPU, 32, 20, seed=0, node_size=16, flip_at=5.0, n_shards=2,
        kill_at=10, flight_dir=str(tmp_path))
    assert out["phase"] == "process_carat" and out["backend"] == "scalar"
    assert out["bootstrap_picks"] == out["a"]["actuations"]["bootstrap"]
    assert out["bootstrap_picks"] > 0 and out["a_ms_per_interval"] > 0.0
    for key, spawns in (("b", 2), ("c", 3)):
        run = out[key]
        assert run["identical_to_a"]
        assert run["signature"] == out["a"]["signature"]
        assert run["spawns"] == spawns
        assert run["worker_bootstrap_picks"] == out["bootstrap_picks"]
        # on the CPU the wrappers run their plain versions: no launches
        assert run["parent_launches"] == {"gbdt_logits": 0,
                                          "gbdt_grid_logits": 0}
        assert run["worker_launches"] == {"gbdt_logits": 0,
                                          "gbdt_grid_logits": 0}
        assert run["bus"]["published"] > 0 and run["bus"]["consumed"] > 0
        assert run["bus"]["max_staleness_seen"] == 0
        assert run["telemetry_sources"] == ["coord", "w0", "w1"]
        spans = run["span_ms_per_interval"]
        assert set(spans) == set(chip_smoke.PROCESS_SPANS)
        for name in ("policy.observe", "policy.actuate", "plan", "commit"):
            assert set(spans[name]) == {"w0", "w1"}, name
        for name in ("policy.decide", "resolve"):
            assert set(spans[name]) == {"coord"}, name
        assert set(run["worker_first_plan_s"]) == {"w0", "w1"}
        assert 0.0 < run["startup_s"] and run["steady_ms_per_interval"] > 0
        for rpcs, ms in run["worker_rpcs_and_ms_per_interval"].values():
            assert rpcs > 0 and ms > 0.0
    assert out["sim_pickle_bytes"] > 0
    assert "recover_s" not in out["b"] and out["c"]["recover_s"] > 0.0
    # snapshots every 2 intervals: the kill at 10 restores from 8 or 10
    assert out["c"]["restored_from_interval"] in ([8], [10])
    assert out["b"]["bus"]["dropped_stale"] == 0
    dump = out["c"]["flight_dump"]
    assert dump["file"].startswith("flight-w1-KillShard")
    assert dump["spans"] > 0

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
            "flash_attention_f32tc": 0, "decode_attention": 0}
    assert serve["prefill"]["launches"] == none
    assert serve["generate"]["launches"] == none
    assert cons["launches"] == none


def test_moe_phases_on_cpu():
    """The MoE family's phases at the reduced configs: K2 at an MLA
    shape (v padded: its output columns exactly 0), the float32
    consistency (forward against decode with nothing dropped, MLA's
    full pass against its absorbed decode, the MoE block against one
    token at a time, the card's stand-in against the CPU with equal
    dispatch states), and serving both archs (deepseek cut to depth 1):
    the prefill's drops counted, its logits equal to the warm-up's bit
    for bit. On the CPU nothing launches."""
    moonshot = reduced_config(get_arch("moonshot-v1-16b-a3b"))
    deepseek = reduced_config(get_arch("deepseek-v3-671b"))
    fa = chip_smoke.phase_prefill_attention(CPU, deepseek.name, 1, 2, 40,
                                            24, 16, seed=10, reps=1)
    assert fa["shape"] == [1, 2, 2, 40, 24] and fa["v_dim"] == 16
    assert fa["padded_columns_zero"] and fa["max_abs_err"] == 0.0
    assert fa["launches"] == {"tensor_core": 0, "f32tc": 0, "simt": 0}
    assert fa["scale"] == 24 ** -0.5 and fa["library_ms"] > 0.0
    assert fa["bound_ms"] > 0.0 and fa["call_ms"] > 0.0
    none = {"flash_attention": 0, "flash_attention_tc": 0,
            "flash_attention_f32tc": 0, "decode_attention": 0}
    cons = chip_smoke.phase_moe_consistency(
        CPU, moonshot, deepseek, depth=1, batch=2, n_tokens=6, cache_len=8,
        seed=12)
    a = cons["a"]
    assert a["depth_cut"]["to"] == 1 and a["launches"] == none
    assert a["moe"]["dropped"] == 0 and a["moe"]["assignments"] == 24
    assert a["moe"]["capacity_factor"] == moonshot.moe.n_experts
    assert a["published_capacity"]["capacity_factor"] == 4.0
    assert a["published_capacity"]["assignments"] == 24
    assert a["max_abs_err"] <= chip_smoke.DECODE_ATOL
    mla = cons["b_mla"]
    assert mla["head_dim"] == 24 and mla["max_abs_err"] <= 1e-5
    assert mla["launches_full"] == mla["launches_decode"] == none
    block = cons["c_moe_block"]
    assert block["dropped"] == 0 and block["aux"] > 0.0
    assert block["max_abs_err"] <= block["atol"]
    for row in cons["d_reduced"]:
        assert row["dispatch_states_equal"] and row["dispatches"] > 0
        assert row["forward_max_abs_err"] == 0.0
    serves = []
    for cfg, cut in chip_smoke.moe_serve_configs(moonshot, deepseek):
        serves.append(chip_smoke.phase_lm_serve(
            CPU, cfg, prefill_batch=2, prefill_len=16, n_requests=3,
            prompt0=4, prompt_step=2, max_new=3, cache_len=32,
            profile_steps=8, seed=13))
        assert (cut is None) == (cfg.n_layers == moonshot.n_layers)
    assert [s["arch"] for s in serves] == [moonshot.name, deepseek.name]
    for out in serves:
        pre = out["prefill"]
        assert pre["bit_equal_to_warm_up"] and pre["launches"] == none
        assert pre["moe"]["assignments"] > 0 and pre["moe"]["dropped"] >= 0
        assert out["generate"]["decode_steps"] == 11
        assert out["generate"]["launches"] == none


def test_family_phases_on_cpu(monkeypatch):
    """The SSM, hybrid, VLM and audio families' phases (``family_phases``)
    at the reduced configs, their sequence lengths, requests and repeats
    cut to a CPU's size: K2 at every shape kind (the hybrid's window, the
    VLM's MQA, hubert's bidirectional MHA, float32), K3 at both group
    shapes, the float32 consistency (no attention launch for mamba2's
    blocks), serving the three decoders (the VLM's prefill with its
    patches) and hubert's encode; each phase carries its seconds and the
    kernel line takes their rows. On the CPU nothing launches."""
    fa = chip_smoke.phase_prefill_attention
    dec = chip_smoke.phase_decode_attention
    serve, enc = chip_smoke.phase_lm_serve, chip_smoke.phase_encode

    def small_fa(dev, arch, b, h, s, d, v_dim, seed, reps, **kw):
        if kw.get("window"):
            kw["window"] = 8
        return fa(dev, arch, b, h, s // 64, d, v_dim, seed, 1, **kw)

    monkeypatch.setattr(chip_smoke, "phase_prefill_attention", small_fa)
    monkeypatch.setattr(
        chip_smoke, "phase_decode_attention",
        lambda dev, b, hq, hkv, d, seed, reps, **kw: dec(
            dev, b, hq, hkv, d, path_s=64, path_len=32, s=128, step=3,
            seed=seed, reps=2))
    monkeypatch.setattr(
        chip_smoke, "phase_lm_serve",
        lambda dev, cfg, **kw: serve(dev, cfg, **{
            **kw, "prefill_len": 48, "n_requests": 3, "prompt0": 4,
            "prompt_step": 3, "max_new": 3, "cache_len": 32}))
    monkeypatch.setattr(
        chip_smoke, "phase_encode",
        lambda dev, cfg, batch, frames, seed, reps: enc(dev, cfg, 2, 24,
                                                        seed, 2))
    fam = chip_smoke.family_phases(
        CPU, lambda name: reduced_config(get_arch(name)), 2)
    none = {"flash_attention": 0, "flash_attention_tc": 0,
            "flash_attention_f32tc": 0, "decode_attention": 0}
    assert all(r["phase_s"] > 0.0 for r in fam.values())
    assert fam["fa_hubert"]["causal"] is False
    assert fam["fa_rg"]["window"] == 8 and fam["fa_pali"]["window"] == 0
    assert fam["fa_simt_d256"]["dtype"] == "float32"
    assert fam["fa_simt_d256"]["kernel"] == "f32tc"
    assert fam["dec_rg"]["shape"][1:3] == [4, 1]
    for r in fam.values():
        if r["phase"] == "flash_attention":
            assert r["launches"] == {"tensor_core": 0, "f32tc": 0,
                                     "simt": 0}
            assert r["max_abs_err"] == 0.0 and r["bound_ms"] > 0.0
    cons = fam["consistency"]
    mamba = cons["mamba2-370m-smoke"]
    assert mamba["attention_layers"] == 0 and mamba["launches"] == none
    for name in ("mamba2-370m-smoke", "recurrentgemma-2b-smoke",
                 "paligemma-3b-smoke"):
        assert cons[name]["max_abs_err"] <= chip_smoke.DECODE_ATOL
    # the phase reduces the configs it is given (here reduced already)
    assert [r["arch"] for r in cons["reduced"]] == [
        f"{name}-smoke-smoke" for name in ("mamba2-370m",
                                           "recurrentgemma-2b",
                                           "paligemma-3b", "hubert-xlarge")]
    assert cons["reduced"][-1]["decode_max_abs_err"] is None
    for name in ("mamba2-370m", "recurrentgemma-2b", "paligemma-3b"):
        out = fam[f"serve_{name}-smoke"]
        assert out["prefill"]["launches"] == none
        assert out["generate"]["launches"] == none
        assert out["generate"]["decode_variants"] == {"tensor_core": 0,
                                                      "simt": 0}
        assert out["generate"]["decode_steps"] == 10 + 3
    assert fam["serve_paligemma-3b-smoke"]["attention_layers"] == 2
    assert fam["encode"]["launches"] == none
    assert fam["encode"]["frames"] == 24
    line = chip_smoke.kernel_line(
        {"gbdt_logits": fam["fa_rg"], "gbdt_grid_logits": fam["fa_pali"],
         "flash_attention": fam["fa_hubert"],
         "flash_attention_f32tc": fam["fa_simt_d256"],
         "decode_attention": fam["dec_rg"]},
        {name: 0 for name in chip_smoke.KERNELS})
    assert all(set(row) == KEYS for row in line["kernels"])


def test_dense_phases_on_cpu(monkeypatch):
    """The two large dense archs' phases (``dense_phases``) at the
    reduced configs, cut to a CPU's size: K2 at both GQA groups, K3 at
    both, the float32 consistency at its depth cuts, serving both with
    command-r-plus's depth cut and each prefill's model FLOPs; on the
    CPU nothing launches."""
    fa = chip_smoke.phase_prefill_attention
    dec = chip_smoke.phase_decode_attention
    serve = chip_smoke.phase_lm_serve
    monkeypatch.setattr(
        chip_smoke, "phase_prefill_attention",
        lambda dev, arch, b, h, s, d, v_dim, seed, reps, **kw: fa(
            dev, arch, b, h, s // 64, d, v_dim, seed, 1, **kw))
    monkeypatch.setattr(
        chip_smoke, "phase_decode_attention",
        lambda dev, b, hq, hkv, d, seed, reps, **kw: dec(
            dev, b, hq, hkv, d, path_s=64, path_len=32, s=128, step=3,
            seed=seed, reps=2))
    monkeypatch.setattr(
        chip_smoke, "phase_lm_serve",
        lambda dev, cfg, **kw: serve(dev, cfg, **{
            **kw, "prefill_len": 48, "n_requests": 3, "prompt0": 4,
            "prompt_step": 3, "max_new": 3, "cache_len": 32}))
    out = chip_smoke.dense_phases(
        CPU, lambda name: reduced_config(get_arch(name)), 2)
    none = {"flash_attention": 0, "flash_attention_tc": 0,
            "flash_attention_f32tc": 0, "decode_attention": 0}
    assert all(r["phase_s"] > 0.0 for r in out.values())
    names = ("internlm2-20b-smoke", "command-r-plus-104b-smoke")
    for name in names:
        assert out[f"fa_{name}"]["launches"] == {"tensor_core": 0,
                                                 "f32tc": 0, "simt": 0}
        assert out[f"fa_{name}"]["max_abs_err"] == 0.0
        assert out[f"dec_{name}"]["max_abs_err"] == 0.0
        srv = out[f"serve_{name}"]
        assert srv["prefill"]["launches"] == none
        assert srv["generate"]["launches"] == none
        assert srv["prefill"]["model_flops"] > 0.0
        assert srv["prefill"]["bf16_peak_share"] > 0.0
    for key in ("consistency_intern", "consistency_cr"):
        assert out[key]["max_abs_err"] <= chip_smoke.DECODE_ATOL
        assert out[key]["launches"] == none
    assert out["consistency_intern"]["layers"] == 12
    assert "depth_cut" not in out["serve_internlm2-20b-smoke"]
    assert out["serve_command-r-plus-104b-smoke"]["depth_cut"]["to"] == 2


def test_depth_cuts_of_the_dense_archs():
    """command-r-plus-104b at full width: 14 layers fit the serving
    budget in bfloat16 (3.146 GB a layer, 6.29 GB of tied embedding, its
    18.87 GB init transient), 3 fit 50 GB in float32."""
    cr = get_arch("command-r-plus-104b")
    cut = chip_smoke.depth_that_fits(cr, 2, chip_smoke.SERVE_WEIGHT_BUDGET)
    assert (cut["from"], cut["to"]) == (64, 14)
    assert "3.146 GB a layer" in cut["reason"]
    assert chip_smoke.depth_that_fits(cr, 4, 50e9)["to"] == 3
    pb = chip_smoke._param_bytes(get_arch("internlm2-20b"), 2)
    assert pb["outside_layers"] + 48 * pb["layer"] == 2 * get_arch(
        "internlm2-20b").param_count()


def test_ptxas_entries():
    """``phase_build``'s registers and spills of each entry of a ptxas
    ``-v`` report whose mangled name holds a kernel's name."""
    report = (
        "ptxas info    : Compiling entry function '_Z3fooILi4EEv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooILi4EEv\n"
        "    0 bytes stack frame, 8 bytes spill stores, 16 bytes spill "
        "loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'\n"
        "ptxas info    : Used 40 registers\n")
    assert chip_smoke.ptxas_entries(report, "foo") == {
        "_Z3fooILi4EEv": {"registers": 255, "spill_store_bytes": 8,
                          "spill_load_bytes": 16}}
    assert chip_smoke.ptxas_entries(report, "bar") == {
        "_Z3barv": {"registers": 40, "spill_store_bytes": None,
                    "spill_load_bytes": None}}


def test_build_keeps_the_ptxas_report_of_a_built_library(tmp_path,
                                                         monkeypatch):
    """``phase_build`` gates on the report ``CudaLibrary.build`` returns:
    a library built earlier in the checkout (by the card tests, say)
    returns the report its build printed, without a second nvcc."""
    from repro_torch.kernels import _build
    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\necho call >> " + str(calls) + "\n"
        "while [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
        "echo lib > \"$out\"\n"
        "echo \"ptxas info    : Compiling entry function '_Z3fooILi4EEv'\" "
        ">&2\necho \"ptxas info    : Used 168 registers\" >&2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    source = tmp_path / "csrc" / "foo.cu"
    source.parent.mkdir()
    source.write_text("// a kernel\n")
    lib = _build.CudaLibrary(source, lambda cdll: None)
    first_path, first = lib.build()
    again_path, again = lib.build()
    assert again_path == first_path and first_path.exists()
    assert again == first
    assert chip_smoke.ptxas_entries(again, "foo") == {
        "_Z3fooILi4EEv": {"registers": 168, "spill_store_bytes": None,
                          "spill_load_bytes": None}}
    assert calls.read_text().count("call") == 1


def test_trace_reads_device_time_and_ranges():
    """The Chrome trace's reading: the device's kernels, copies and
    memsets by name (host ops, device-side range annotations and flow
    events left out); a named range's calls, the device work launched
    from inside it on its own thread (by correlation id) and its
    device-side span; on the CPU its host ms. A CPU profiler's real
    trace has no device time and finds its named range."""
    def x(cat, name, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "pid": 7, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    trace = chip_smoke._Trace([
        x("user_annotation", "step", 0.0, 100.0),
        x("cuda_runtime", "cudaLaunchKernel", 10.0, 2.0, corr=1),
        x("cuda_runtime", "cudaLaunchKernel", 120.0, 2.0, corr=2),
        x("cuda_runtime", "cudaLaunchKernel", 50.0, 2.0, tid=2, corr=3),
        x("kernel", "gemm", 200.0, 1500.0, tid=9, corr=1),
        x("kernel", "gemm", 1800.0, 500.0, tid=9, corr=2),
        x("kernel", "softmax_kernel", 2400.0, 250.0, tid=9, corr=3),
        x("gpu_memcpy", "Memcpy HtoD", 2700.0, 100.0, tid=9),
        x("gpu_memset", "Memset", 2800.0, 50.0, tid=9),
        x("gpu_user_annotation", "step", 200.0, 1600.0, tid=9),
        x("cpu_op", "aten::mm", 5.0, 70.0),
        {"ph": "f", "cat": "ac2g", "name": "ac2g"}])
    busy, top = trace.device(top=2)
    assert busy == pytest.approx(2.4)
    assert top == [["gemm", 2.0, 2], ["softmax_kernel", 0.25, 1]]
    assert trace.kernel_ms(r"\bsoftmax_kernel\b") == [0.25, 1]
    assert trace.range_ms("step", cuda=True) == {
        "calls": 1, "device": 1.5, "span": 1.6}
    assert trace.range_ms("step", cuda=False) == {
        "calls": 1, "device": 0.1, "span": 0.1}
    assert chip_smoke._Trace([]).device(top=3) == (None, [])
    with chip_smoke._profiler() as prof:
        with torch.profiler.record_function("a range"):
            torch.ones(8) @ torch.ones(8)
    real = chip_smoke._Trace.of(prof)
    assert real.device(top=3) == (None, [])
    assert real.range_ms("a range", cuda=False)["calls"] == 1


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


def test_gbdt_onchip_load_counts():
    """The on-chip loads each GBDT design needs, counted from shapes: at
    the path's 63 rows of 184 trees the simple design (a thread per row)
    walks one chain of 184 trees, the kernel 16 chains of at most 12 on
    16 warps; at fleet size the kernel needs several times fewer
    wavefronts."""
    # rows 88 bytes apart: a warp's 32 rows span 22 lines; 4 bytes
    # apart, one line
    assert chip_smoke._lines_per_warp_load(88) == 22.0
    assert chip_smoke._lines_per_warp_load(4) == 1.0
    small = chip_smoke.gbdt_logits_onchip(63, 22, 184, 5)
    assert (small["chain_trees_simple"], small["chain_trees"]) == (184, 12)
    assert small["folds"] == 15
    assert small["wavefronts"] == 184 * 17
    fleet = chip_smoke.gbdt_logits_onchip(258_048, 22, 184, 5)
    assert fleet["wavefronts"] == 4032 * 184 * 17
    assert fleet["wavefronts_simple"] > 5 * fleet["wavefronts"]
    assert fleet["issue_ms"] == chip_smoke._issue_ms(fleet["wavefronts"])
    grid = chip_smoke.gbdt_grid_onchip(4096, 63, 184)
    assert grid["wavefronts"] == 4096 * 2 * 184 * 1.5
    assert grid["wavefronts_simple"] == 4096 * 2 * 184 * 34
    write = chip_smoke.gbdt_logits_onchip(63, 22, 223, 5)
    assert write["chain_trees"] == 14


def test_ml_phase_on_cpu(tmp_path):
    """The ``ml`` phase with the nets on the CPU: the full production
    protocol regenerates the committed GBDT pair byte for byte, a small
    Table IV comes back with every model's time, and each net passes the
    radial bar (on one torch thread, as ``tests/test_torch_ml.py`` trains
    the nets)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ml = chip_smoke.phase_ml(CPU, str(tmp_path), reps=2,
                                 duration_s=20.0, seed=0)
    finally:
        torch.set_num_threads(before)
    assert ml["default_models"]["byte_equal_assets"] == {"read": True,
                                                         "write": True}
    table = ml["table_iv"]["models"]
    assert list(table) == ["svm", "fcnn", "rnn", "tcn", "gbdt"]
    for name, row in table.items():
        assert 0.0 <= row["read_error"] <= 1.0 and row["train_s"] > 0.0
        assert ("adam_steps" in row) == (name in ("fcnn", "rnn", "tcn"))
    for name in ("fcnn", "rnn", "tcn"):
        assert table[name]["param_devices"] == ["cpu"]
        assert table[name]["ms_per_step"] > 0.0
    radial = ml["radial"]["nets"]
    assert set(radial) == {"fcnn", "rnn", "tcn"}
    for row in radial.values():
        assert row["accuracy"] > 0.75 and row["max_abs_err_cpu"] < 1e-6
    # the trainers are restored after the phase
    from repro_torch.core.ml import nets, train
    assert train.train_net is nets.train_net


def test_lm_train_phase_on_cpu(tmp_path):
    """The training phase at a small size on the CPU, the full-width part
    at granite-3-2b's reduced config: (a) the launcher off and on, its
    decisions equal a CPU-scored pipeline's; (b) the restart bit-exact;
    (c) every step split into forward+backward and AdamW; (d) the step
    against itself. On the CPU nothing launches."""
    cfg = reduced_config(get_arch("granite-3-2b"))
    out = chip_smoke.phase_lm_train(CPU, cfg, launch_steps=4,
                                    ckpt_every=2, full_batch=2, full_seq=16,
                                    full_steps=2)
    assert out["phase"] == "lm_train"
    a = out["a"]
    for key in ("carat_off", "carat_on"):
        row = a[key]
        assert row["last_line"].startswith("final_loss=")
        assert row["step0_batch_loss_after"] < row["losses_first_last"][0]
        assert row["ms_per_step"] > 0.0 and row["pfs_MBps"] > 0.0
        assert set(row["launches"].values()) == {0}
    assert a["carat_off"]["decisions"] == 0
    assert a["carat_on"]["scorer_calls"] > 0
    assert a["carat_on"]["decisions_equal_cpu_scorers"]
    assert out["b"]["bit_exact"] and out["b"]["replayed"] == \
        out["b"]["losses"][4:6]
    c = out["c"]
    assert c["steps"] == len(c["per_step"]) == len(c["losses"]) == 2
    for row in c["per_step"]:
        assert row["ms"] > 0.0 and row["input_wait_s"] >= 0.0
    # the traced step's update range splits a step
    assert c["profiled"]["adamw_calls"] == 1
    assert 0.0 < c["adamw_ms"] < c["ms_per_step"] and c["fwd_bwd_ms"] > 0.0
    assert c["tokens_per_step"] == 32 and set(c["launches"].values()) == {0}
    d = out["d"]
    assert d["steps"] == len(d["losses_card"]) == 3
    assert d["lr"][0] == pytest.approx(3e-4)       # no warm-up
    # both sides on the CPU: two models round the embedding's gradient
    # apart in its last bits, inside the phase's bars; the weights moved
    assert d["loss_rel_err"] <= d["rel"]
    assert d["grad_norm_rel_err"] <= d["grad_rel"]
    assert d["grad_worst"]["err_over_bound"] <= 1.0
    assert d["param_max_abs_err"] <= d["atol"] < d["param_max_move"] / 10
    f32tc = d["qkv_grad"]
    assert f32tc["shape"] == [8, cfg.n_heads, cfg.n_kv_heads, 16,
                              cfg.resolved_head_dim]
    assert f32tc["grad_max_abs_err"] == 0.0 and f32tc["library_ms"] > 0.0
    assert f32tc["kernel"] == "f32tc" and not f32tc["misaligned"]
    # the same shape on misaligned views: the rule's SIMT kernel
    simt = d["qkv_grad_simt"]
    assert simt["kernel"] == "simt" and simt["misaligned"]
    assert simt["shape"] == f32tc["shape"]
    assert simt["max_abs_err"] == 0.0 and simt["grad_max_abs_err"] == 0.0
    # the kernel line lists all four kernels, K2 with a row for each of
    # its two tensor-core kernels (bfloat16 for serving, split TF32 for
    # training)
    line = chip_smoke.kernel_line(
        {name: {"max_abs_err": 0.0, "ms": 1.0, "plain_ms": 2.0,
                "bound_ms": 0.5, "bound_by": "bytes"}
         for name in chip_smoke.KERNELS} | {"flash_attention_f32tc": f32tc},
        {name: 1 for name in chip_smoke.KERNELS})
    assert [k["name"] for k in line["kernels"]] == [
        "gbdt_logits", "gbdt_grid_logits", "flash_attention",
        "flash_attention_f32tc", "decode_attention"]
    for k in line["kernels"]:
        assert set(k) == KEYS


# attention blocks of a training forward per arch of lm_train (e): the
# stack's and deepseek's MTP block; none in mamba2, one (the third block)
# in the 3-layer hybrid
PARITY_BLOCKS = {"moonshot-v1-16b-a3b": 2, "deepseek-v3-671b": 3,
                 "mamba2-370m": 0, "recurrentgemma-2b": 1,
                 "paligemma-3b": 2, "hubert-xlarge": 2,
                 "h2o-danube-1.8b": 2}


@pytest.mark.parametrize("cfg", chip_smoke.parity_configs(),
                         ids=lambda c: c.name)
def test_train_parity_of_every_family_on_cpu(cfg):
    """lm_train (e) with the CPU on both sides: the family's batch
    through three steps from the same weights, inside every bar; the
    weights moved; K2 counted per attention block (never launched on the
    CPU); an MoE arch's dispatches recorded on both sides and equal."""
    out = chip_smoke._train_parity(CPU, cfg)
    arch = cfg.name.removesuffix("-smoke")
    assert out["arch"] == cfg.name and out["steps"] == 3
    assert out["attention_blocks"] == PARITY_BLOCKS[arch]
    assert out["k2_launches_card"] == out["k2_launches_cpu"] == 0
    assert out["flash_attention_backward_op_calls"] == 0
    assert out["lr"][0] == pytest.approx(3e-4)       # no warm-up
    assert out["loss_rel_err"] <= out["rel"]
    assert out["grad_norm_rel_err"] <= out["grad_rel"]
    assert out["grad_worst"]["err_over_bound"] <= 1.0
    assert out["param_max_abs_err"] <= out["atol"] < \
        out["param_max_move"] / 10
    assert out["param_worst"]["err_over_bound"] <= 1.0
    assert out["step_grad_worst"]["err_over_bound"] <= 1.0
    assert out["step_grad_worst"]["step"] in (1, 2, 3)
    assert out["param_slack"]["on"]
    assert 0.0 <= out["param_slack"]["share_of_elements"] < 1.0
    # on one device the CPU's AdamW fed the steps' gradients is the
    # steps' own update, bit for bit
    assert out["param_vs_card_grads_replay"] == 0.0
    if cfg.moe is not None:
        # (1 first-step gradient + 3 steps) x (the forward and its
        # recompute of each MoE layer, and the MTP head's block, which
        # the remat policy does not wrap)
        assert out["moe"] == {"dispatches": 4 * (2 * cfg.n_layers
                                                 + cfg.mtp_depth),
                              "dispatch_states_equal": True,
                              "first_difference": None}
    else:
        assert "moe" not in out


def test_train_parity_holds_the_optimizer_step(monkeypatch):
    """lm_train's parity also replays the card's gradients through the
    CPU's AdamW: an optimizer step that moves the weights wrongly on
    both sides alike (half again the learning rate) fails it, though
    the two runs agree with each other."""
    from repro_torch.train import optimizer
    from repro_torch.train import step as step_mod

    def too_far(params, grads, state, lr, cfg, grad_clip=0.0):
        return optimizer.adamw_update(params, grads, state, lr * 1.5, cfg,
                                      grad_clip=grad_clip)

    monkeypatch.setattr(step_mod, "adamw_update", too_far)
    cfg = reduced_config(get_arch("granite-3-2b"))
    with pytest.raises(RuntimeError, match="AdamW on the same gradients"):
        chip_smoke._train_parity(CPU, cfg)


def test_adamw_decides_zero_gradients_by_rounding():
    """Why lm_train (e) gives an element whose CPU gradient lies within
    its bar of 0 the slack of ``_Updates.slack``: a key bias moves every
    score of a query alike, which softmax ignores, so its true gradient
    is 0 and float32 leaves rounding noise (reduced hubert: below 1e-8,
    where its key weights' gradients pass 1e-3). AdamW's first step
    moves an element by ``lr * g / (|g| + eps)``: noise of 1e-9, far
    inside the gradient bar, moves the bias by more than the parameter
    bar of 1e-5, and by no more than the slack."""
    from repro_torch.config import (ParallelConfig, RunConfig, ShapeConfig,
                                    TrainConfig)
    from repro_torch.data import TokenSource, make_host_batch
    from repro_torch.models.lm import build_model
    from repro_torch.train import AdamWConfig, TrainState, make_loss_fn
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.utils.tree import tree_flatten_with_paths, tree_leaves
    cfg = reduced_config(get_arch("hubert-xlarge"))
    run = RunConfig(arch=cfg, shape=ShapeConfig("t", 64, 8, "train"),
                    train=TrainConfig(warmup_steps=0))
    model = build_model(cfg, device=CPU, dtype=torch.float32)
    model.init(torch.Generator().manual_seed(9))
    model.requires_grad_(True)
    batch = make_host_batch(cfg, 64, 8, TokenSource(cfg.vocab_size, 5), 0)
    leaves = tree_leaves(model.param_tree())
    grads = dict(zip(
        [p for p, _ in tree_flatten_with_paths(model.param_tree())],
        torch.autograd.grad(make_loss_fn(model, run)(batch), leaves,
                            materialize_grads=True)))
    bk, wk = grads["layers/0/attn/bk"], grads["layers/0/attn/wk"]
    assert float(bk.abs().max()) < 1e-8 < 1e-3 < float(wk.abs().max())

    def first_step(g):
        p = torch.zeros_like(g)
        state = TrainState.init([p], AdamWConfig())
        adamw_update(state["params"], [g], state["opt"], 3e-4,
                     AdamWConfig())
        return p

    noisy = bk + 1e-9
    assert float((noisy - bk).abs().max()) < 1e-5 + 1e-4 * 1e-8
    moved = (first_step(noisy) - first_step(bk)).abs()
    assert float(moved.max()) > 1e-5
    updates = chip_smoke._Updates()
    updates.calls.append(([bk], torch.tensor(3e-4), AdamWConfig(), 0.0))
    slack, = updates.slack(1e-5, 1e-4)
    assert np.all(moved.double().numpy() <= 1e-5 + slack)


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_adamw_slack_bounds_every_gradient_inside_the_bars(clip):
    """``_Updates.slack`` over three AdamW steps: gradients moved
    anywhere inside their bars (``1e-5 + 1e-4 * max|g|``, both ends and
    between) move no element whose gradient lies within its bar of 0 by
    more than its slack; an element further from 0 gets none."""
    from repro_torch.train import AdamWConfig, TrainState
    from repro_torch.train.optimizer import adamw_update
    gen = np.random.default_rng(4)
    shape = (4, 256)
    # each row a scale of gradients: ~0, about the bar, well above it
    scales = np.array([1e-9, 1e-6, 1e-5, 1e-1])[:, None]
    grads = [torch.from_numpy((gen.standard_normal(shape) * scales)
                              .astype(np.float32)) for _ in range(3)]
    lrs = [3e-4, 2.9e-4, 2.8e-4]
    cfg = AdamWConfig()

    def run(gs):
        state = TrainState.init([torch.zeros(shape)], cfg)
        for g, lr in zip(gs, lrs):
            state["params"], state["opt"] = adamw_update(
                state["params"], [g], state["opt"], torch.tensor(lr), cfg,
                grad_clip=clip)
        return state["params"][0].double().numpy()

    updates = chip_smoke._Updates()
    updates.calls = [([g], torch.tensor(lr), cfg, clip)
                     for g, lr in zip(grads, lrs)]
    slack, = updates.slack(1e-5, 1e-4)
    near = np.zeros(shape, bool)
    for g in grads:
        near |= g.abs().numpy() <= 1e-5 + 1e-4 * float(g.abs().max())
    assert near[:2].all() and near[3].mean() < 0.01
    # ~0 gradients: their moves' signs are the bar's to decide, up to
    # 2 lr a step
    assert (slack[~near] == 0).all() and slack[:2].min() > 1e-4
    assert slack.max() <= 2 * 1.5 * sum(lrs)
    base = run(grads)
    for trial in range(8):
        moved = []
        for g in grads:
            bar = 1e-5 + 1e-4 * float(g.abs().max())
            # every step at one end of the bar, each at a random end, or
            # anywhere between
            u = (np.full(shape, 1.0 - 2 * trial) if trial < 2
                 else np.sign(gen.standard_normal(shape)) if trial < 4
                 else gen.uniform(-1, 1, shape))
            moved.append(g + torch.from_numpy((0.99 * bar * u)
                                              .astype(np.float32)))
        err = np.abs(run(moved) - base)
        assert np.all(err[near] <= slack[near] * (1 + 1e-4) + 1e-9), trial


def test_train_parity_catches_a_wrong_late_gradient(monkeypatch):
    """A gradient that goes wrong on a small leaf in the last step only
    (the final norm's, sign flipped on the second run's side) leaves
    every loss, grad norm and first-step gradient inside its bar: the
    parameters, held to the CPU's own run, fail."""
    from repro_torch.train import step as step_mod
    real = step_mod.adamw_update
    calls = []

    def flipped(params, grads, state, lr, cfg, grad_clip=0.0):
        calls.append(None)
        if len(calls) == 6:                 # the second run's third step
            grads = list(grads)
            grads[1] = -grads[1]            # final_norm/scale
        return real(params, grads, state, lr, cfg, grad_clip=grad_clip)

    monkeypatch.setattr(step_mod, "adamw_update", flipped)
    cfg = reduced_config(get_arch("granite-3-2b"))
    with pytest.raises(RuntimeError, match=r"final_norm/scale after 3 "
                                           r"steps off the CPU's"):
        chip_smoke._train_parity(CPU, cfg)


def test_dispatch_difference_names_token_experts_and_margin():
    """Two recorded runs whose routers part on one token: the report
    names the call, the batch row, the token, both runs' experts and the
    router's margin there."""
    cfg = reduced_config(get_arch("moonshot-v1-16b-a3b"))
    from repro_torch.models.lm import build_model
    model = build_model(cfg, device=CPU, dtype=torch.float32)
    model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(chip_smoke.rng(0).integers(
        0, cfg.vocab_size, size=(2, 8)))
    runs = []
    for nudge in (0.0, 1.0):
        with torch.no_grad():
            model.layers[1].moe["router"][:, 0] += nudge
        with torch.inference_mode(), \
                chip_smoke._Dispatches(keep_states=True) as disp:
            model.forward({"tokens": tokens})
        runs.append(disp)
    assert runs[0].difference(runs[0]) is None
    diff = runs[0].difference(runs[1])
    assert diff["call"] == 1 and 0 <= diff["group"] < 2
    assert 0 <= diff["token"] < 8
    mine, theirs = diff["experts"]
    assert mine != theirs and len(mine) == cfg.moe.top_k
    assert diff["router_margin"] >= 0.0


def test_family_train_phases_on_cpu():
    """The families' training phases at the reduced configs: K2 with its
    gradient at each family's head shape (hubert bidirectional, MLA's v
    padded, the hybrid's and danube's windows), then the four families
    trained through ``_train_full`` (per-step ms, the update's split,
    attention blocks: none for mamba2); the summary and the kernel line
    take their rows. On the CPU nothing launches."""
    models = dict(zip(("read", "write"), default_models()))
    fam = chip_smoke.family_train_phases(
        CPU, lambda name: reduced_config(get_arch(name)), models, batch=2,
        seq=16, steps=2)
    assert list(fam) == ["fa_train_hubert", "fa_train_moonshot",
                         "fa_train_mla", "fa_train_rg", "fa_train_danube"] \
        + [f"train_{n}" for n in chip_smoke.FULL_TRAIN_ARCHS]
    assert fam["fa_train_hubert"]["causal"] is False
    assert fam["fa_train_mla"]["shape"][-1] == 24
    assert fam["fa_train_mla"]["v_dim"] == 16
    assert fam["fa_train_rg"]["window"] == 8
    assert fam["fa_train_danube"]["window"] == 128
    for name in ("hubert", "moonshot", "mla", "rg", "danube"):
        r = fam[f"fa_train_{name}"]
        assert r["phase"] == "flash_attention_train"
        assert r["max_abs_err"] == 0.0 and r["grad_max_abs_err"] == 0.0
        assert r["padded_columns_zero"] and r["bound_ms"] > 0.0
        assert r["launches"] == {"tensor_core": 0, "f32tc": 0, "simt": 0}
        assert r["library_ms"] > 0.0 and r["phase_s"] > 0.0
    blocks = {"mamba2-370m": 0, "recurrentgemma-2b": 0, "paligemma-3b": 2,
              "hubert-xlarge": 2}
    full = []
    for name in chip_smoke.FULL_TRAIN_ARCHS:
        r = fam[f"train_{name}"]
        assert r["phase"] == "lm_train_full"
        assert r["attention_blocks"] == blocks[name]
        assert r["steps"] == len(r["losses"]) == 2
        assert 0.0 < r["adamw_ms"] < r["ms_per_step"]
        assert set(r["launches"].values()) == {0}
        assert r["flash_attention_backward_op_calls"] == 0
        full.append(r)
    parity = [chip_smoke._train_parity(CPU, c)
              for c in chip_smoke.parity_configs()[2:4]]
    summary = chip_smoke.summary_line(["card, 700 W"], [], parity, full)
    assert list(summary["lm_train_parity"]) == [r["arch"] for r in parity]
    for row in summary["lm_train_parity"].values():
        assert row["loss_over_bar"] <= 1.0 and row["grad_over_bar"] <= 1.0
        assert row["backward_op_calls"] == 0
    assert set(summary["lm_train_full"]) == {r["arch"] for r in full}
    line = chip_smoke.kernel_line(
        {name: fam["fa_train_mla"] for name in chip_smoke.KERNELS},
        {name: 0 for name in chip_smoke.KERNELS})
    assert all(set(row) == KEYS for row in line["kernels"])


@pytest.mark.parametrize("name,depth", [("granite-3-2b", None),
                                        ("recurrentgemma-2b", 3)])
def test_lm_serve_tail_replay_on_cpu(name, depth):
    """``phase_lm_serve``'s traced tail: its last 8 steps (two prompt
    steps, then six fed back from their argmax) run again from the state
    set aside in (b), copied back into the same buffers: the same tokens
    and logits as (b), every cache address kept; for the hybrid its
    RG-LRU states and its local attention's 8-slot ring buffer, wrapped
    past 8 positions."""
    import dataclasses
    cfg = reduced_config(get_arch(name))
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    out = chip_smoke.phase_lm_serve(
        CPU, cfg, prefill_batch=2, prefill_len=16, n_requests=3, prompt0=4,
        prompt_step=3, max_new=6, cache_len=32, profile_steps=8, seed=7)
    gen, prof = out["generate"], out["profiled"]
    assert gen["decode_steps"] == 16 and gen["tail_steps"] == 8
    assert gen["cache_addresses_kept"] and gen["cache_buffers"] > 0
    assert prof["decode_steps"] == 8
    assert prof["same_tokens"] and prof["same_logits"]
    assert prof["cache_addresses_kept"]
    assert prof["s"] > 0.0 and prof["save_s"] >= 0.0


def test_train_float64_dump_on_cpu():
    """``chip_train_float64.py`` with the CPU on both sides, reduced
    moonshot at one step: the gates pass, the worst elements are named,
    and each leaf's float32 gradient lies within a hundredth of its bar
    of the float64 gradient of the widened path."""
    import chip_train_float64
    cfg = reduced_config(get_arch("moonshot-v1-16b-a3b"))
    out = chip_train_float64.diagnose(CPU, cfg, 1, 32, 4, (2, 3), 3)
    assert json.loads(json.dumps(out)) == out
    assert out["gates_passed"] and out["failed"] is None
    assert out["param_worst"]["err_over_bound"] <= 1.0
    assert len(out["worst_elements"]) == 3
    for row in out["worst_elements"]:
        assert row["param_abs_err"] <= 1e-5
        assert row["leaf_cpu_vs_float64"] <= row["leaf_grad_bar"] / 100
        assert row["grad_card"] == pytest.approx(row["grad_float64"],
                                                 abs=row["leaf_grad_bar"])


def test_train_parity_gates_every_steps_gradients(monkeypatch):
    """A gradient that goes wrong in the last step only (a query weight's,
    sign flipped on the second model's side: the grad norm, every loss
    and the first step's gradients stay as they were) fails the gate on
    the gradients each step hands AdamW."""
    from repro_torch.models import lm
    from repro_torch.utils.tree import tree_flatten_with_paths
    real = lm.build_model
    built = []

    def build(*args, **kwargs):
        model = real(*args, **kwargs)
        built.append(model)
        if len(built) == 2:
            wq = dict(tree_flatten_with_paths(
                model.param_tree()))["layers/0/attn/wq"]
            seen = []

            def flip(g):                # the first step's gradient, then
                seen.append(None)       # steps 1-3: the third step's
                return -g if len(seen) == 4 else g

            wq.requires_grad_(True)
            wq.register_hook(flip)
        return model

    monkeypatch.setattr(lm, "build_model", build)
    cfg = reduced_config(get_arch("granite-3-2b"))
    with pytest.raises(RuntimeError, match=r"step 3's gradient of "
                                           r"layers/0/attn/wq off"):
        chip_smoke._train_parity(CPU, cfg)


def test_lm_serve_tail_replay_of_every_step_on_cpu():
    """A tail as long as the run: the state is saved before the first
    step (an empty cache, no logits, no outputs) and the replay of all
    16 steps gives (b)'s tokens and logits in the same buffers."""
    cfg = reduced_config(get_arch("granite-3-2b"))
    out = chip_smoke.phase_lm_serve(
        CPU, cfg, prefill_batch=2, prefill_len=16, n_requests=3, prompt0=4,
        prompt_step=3, max_new=6, cache_len=32, profile_steps=16, seed=7)
    gen, prof = out["generate"], out["profiled"]
    assert gen["decode_steps"] == gen["tail_steps"] == 16
    assert prof["decode_steps"] == 16
    assert prof["same_tokens"] and prof["same_logits"]
    assert gen["cache_addresses_kept"] and prof["cache_addresses_kept"]


def test_moe_serve_configs_cut_only_moonshots_depth():
    """lm_serve's MoE configs: moonshot at full width and 24 of its 48
    layers, deepseek at full width and depth 1, each cut recorded; a
    config already that shallow is served uncut."""
    moonshot = get_arch("moonshot-v1-16b-a3b")
    deepseek = get_arch("deepseek-v3-671b")
    (m, m_cut), (d, d_cut) = chip_smoke.moe_serve_configs(moonshot,
                                                          deepseek)
    assert m.n_layers == chip_smoke.MOONSHOT_SERVE_LAYERS == 24
    assert m == dataclasses.replace(moonshot, n_layers=24)
    assert (m_cut["from"], m_cut["to"]) == (48, 24) and m_cut["reason"]
    assert d == dataclasses.replace(deepseek, n_layers=1)
    assert (d_cut["from"], d_cut["to"]) == (deepseek.n_layers, 1)
    small = reduced_config(moonshot)
    ((s, s_cut), _) = chip_smoke.moe_serve_configs(small, deepseek)
    assert s == small and s_cut is None


# ------------------------------------- the reference's training configuration
def test_reference_train_configs_take_parallel_for():
    """phase_reference_train's runs take ``parallel_for``'s settings of
    each published arch at train_4k: moonshot at its full width cut in
    depth only, to what 12 bytes a parameter (bfloat16 weights and
    gradients, float32 moments) leave of ``MOE_TRAIN_BUDGET``; every
    reduced family and reduced command-r-plus-104b, where the two XXL
    archs (deepseek-v3-671b among the families) take 4 microbatches and
    bfloat16 moments."""
    rt = chip_smoke.reference_train_configs(get_arch)
    moe = rt["moe"]
    moon = get_arch("moonshot-v1-16b-a3b")
    assert moe["cfg"] == dataclasses.replace(moon,
                                             n_layers=moe["cfg"].n_layers)
    assert 5 <= moe["cfg"].n_layers <= 8
    assert moe["depth_cut"]["from"] == 48 and moe["batch"] == 1
    assert moe["shape"].seq_len == 4096 and moe["steps"] == 3
    state = moe["cfg"].param_count() * chip_smoke.TRAIN_STATE_BYTES
    assert state <= chip_smoke.MOE_TRAIN_BUDGET
    par = moe["parallel"]
    assert (par.remat, par.microbatches, par.opt_state_dtype) == (
        "full", 1, "float32")
    names = [(cfg.name, p.microbatches, p.opt_state_dtype)
             for cfg, p in rt["parity"]]
    xxl = ("deepseek-v3-671b", "command-r-plus-104b")
    assert names == [
        (f"{name}-smoke", 4 if name in xxl else 1,
         "bfloat16" if name in xxl else "float32")
        for name in [n for n, _ in chip_smoke.PARITY_ARCHS] + [xxl[1]]]
    assert all(p.remat == "full" for _, p in rt["parity"])


def test_depth_that_fits_counts_the_init_in_its_own_bytes():
    """With the training state counted per parameter, the init's
    transient is the largest weight in float32 and in the weights' own
    bytes, not in the state's."""
    moon = get_arch("moonshot-v1-16b-a3b")
    cut = chip_smoke.depth_that_fits(moon, 12, 60e9, init_bytes=2)
    elements = moon.vocab_size * moon.d_model
    assert f"{elements * 6 / 1e9:.2f} GB transient" in cut["reason"]
    assert cut == chip_smoke.depth_that_fits(moon, 12, 60e9, init_bytes=2)
    # serving's call is unchanged: the transient in float32 and the
    # weights' bytes
    assert chip_smoke.depth_that_fits(moon, 2, 72e9) == \
        chip_smoke.depth_that_fits(moon, 2, 72e9, init_bytes=2)


def test_reference_train_phase_on_cpu():
    """The phase end to end with the plain versions at reduced widths:
    moonshot's full-width run as a 2-layer reduced MoE over 64 tokens (the
    loss falls, drops counted at the published capacity factor), and the
    bfloat16 card-vs-CPU step of a dense, the MoE, the SSM (no
    attention) and an XXL case, both
    sides on the CPU: equal, so every bar holds with room."""
    from repro_torch.config.types import get_shape
    from repro_torch.launch.dryrun import parallel_for
    m_read, m_write = default_models()
    shape = dataclasses.replace(get_shape("train_4k"), seq_len=64)
    moon = reduced_config(get_arch("moonshot-v1-16b-a3b"))
    moe = {"published": get_arch("moonshot-v1-16b-a3b"), "cfg": moon,
           "depth_cut": {"from": 48, "to": 2, "reason": "rehearsal"},
           "shape": shape, "batch": 1, "steps": 3,
           "parallel": parallel_for(get_arch("moonshot-v1-16b-a3b"),
                                    shape)}
    xxl = parallel_for(get_arch("deepseek-v3-671b"), shape)
    parity = [(reduced_config(get_arch("granite-3-2b")),
               parallel_for(get_arch("granite-3-2b"), shape)),
              (moon, moe["parallel"]),
              (reduced_config(get_arch("mamba2-370m")),
               parallel_for(get_arch("mamba2-370m"), shape)),
              (reduced_config(get_arch("deepseek-v3-671b")), xxl)]
    res = chip_smoke.phase_reference_train(CPU, moe, parity,
                                           {"read": m_read,
                                            "write": m_write})
    json.dumps(res)
    full = res["moe_train"]
    assert full["cell"] == "moonshot-v1-16b-a3b x train_4k"
    assert full["dtype"] == "bfloat16" and full["remat"] == "full"
    assert full["losses"][-1] < full["losses"][0]
    assert full["moe"]["assignments"] > 0
    loads = full["moe"]["loads"]
    assert loads["calls"] == full["moe"]["dispatches"]
    assert loads["plain_dropped"] == full["moe"]["dropped"]
    assert len(loads["first_forward_by_layer"]) == moon.n_layers
    for row in loads["first_forward_by_layer"]:
        assert 0.0 <= row["dropped_share"] < 1.0
        assert 0.0 < row["tokens_mean_cosine"] <= 1.0 + 1e-6
        assert row["logit_spread"] > 0.0
    assert sum(loads["histogram_first_call"]) == \
        moon.moe.top_k * shape.seq_len
    assert full["moe"]["capacity_factor"] == moon.moe.capacity_factor
    assert {c["what"] for c in full["reduced"]} >= {"batch", "n_layers",
                                                    "d_model"}
    assert [r["arch"] for r in res["parity"]] == [
        "granite-3-2b-smoke", "moonshot-v1-16b-a3b-smoke",
        "mamba2-370m-smoke", "deepseek-v3-671b-smoke"]
    assert [r["k2_kernel"] for r in res["parity"]] == [
        "tc", "tc", "none", "simt"]
    for r in res["parity"]:
        # the same gradients on both sides: a third of the 3x bar
        assert r["grad_worst"]["err_over_bound"] <= 1 / 3
        assert r["loss_rel_err"] == 0.0
        assert max(r["state_max_abs_err"].values()) == 0.0
        # one device: the replay is the step's own update, bit for bit
        assert r["replay"]["most_ulps"] == 0
        assert r["bf16_weights_moved_share"] >= chip_smoke.MOVED_SHARE
        assert "torch.bfloat16" in r["param_dtypes"]
        assert r["k2_launches_cpu"] == r["k2_launches_card"] == 0
    assert res["parity"][1]["param_dtypes"] == ["torch.bfloat16",
                                                "torch.float32"]
    assert res["parity"][1]["moe"]["flips"] == {
        "ok": True, "calls_differing": 0, "calls": [], "margins": []}
    assert res["parity"][3]["microbatches"] == 4
    assert res["parity"][3]["opt_state_dtype"] == "bfloat16"
    assert chip_smoke.ref_train_launches(res) == 0
    line = chip_smoke.summary_line([], [], [], [], None, res)
    assert set(line["reference_train"]["bf16_parity"]) == {
        "granite-3-2b-smoke", "moonshot-v1-16b-a3b-smoke",
        "mamba2-370m-smoke", "deepseek-v3-671b-smoke xxl"}


def test_dispatch_flips_hold_only_crossed_routers():
    """A dispatch whose experts differ where the two routers'
    probabilities cross passes and is reported with its margin; a state
    that differs with the same experts everywhere does not pass."""
    def disp(experts, probs, slots):
        d = chip_smoke._Dispatches(keep_states=True)
        d.states = [[torch.tensor(slots), torch.zeros(1, 2),
                     torch.ones(1, 2, dtype=torch.bool), torch.zeros(1, 2)]]
        d.experts = [torch.tensor(experts)]
        d.probs = [torch.tensor(probs)]
        return d

    cpu = disp([[[0], [1]]], [[[0.51, 0.49], [0.2, 0.8]]], [[0, 9]])
    same = disp([[[0], [1]]], [[[0.51, 0.49], [0.2, 0.8]]], [[0, 9]])
    assert chip_smoke.dispatch_flips(cpu, same) == {
        "ok": True, "calls_differing": 0, "calls": [], "margins": []}
    flipped = disp([[[1], [1]]], [[[0.49, 0.51], [0.2, 0.8]]], [[8, 9]])
    got = chip_smoke.dispatch_flips(cpu, flipped)
    assert got["ok"] and got["calls_differing"] == 1
    (tok,) = got["calls"][0]["tokens"]
    assert tok["token"] == 0 and tok["experts"] == [[0], [1]]
    assert tok["router_margin"] == pytest.approx(0.02)
    assert tok["prob_gap"] == pytest.approx(0.02)
    reordered = disp([[[0], [1]]], [[[0.51, 0.49], [0.2, 0.8]]], [[1, 9]])
    assert not chip_smoke.dispatch_flips(cpu, reordered)["ok"]


@pytest.mark.parametrize("fits_up_to,first,most,want,probed", [
    (3, 3, 8, 3, [3, 4]),          # fits at the first, not the next
    (5, 3, 8, 5, [3, 4, 5, 6]),    # up a batch at a time
    (8, 3, 8, 8, [3, 4, 5, 6, 7, 8]),  # to the cap: no next batch
    (2, 3, 8, 2, [3, 2]),          # down until one fits
    (1, 3, 8, 1, [3, 2]),          # a batch of 1 is taken to fit
])
def test_largest_batch_probes_up_and_down(monkeypatch, fits_up_to, first,
                                          most, want, probed):
    """train_4k's batch probe: from its first batch up while each fits,
    or down until one does; every probe kept in order."""
    def probe(dev, cfg, batch, seq, parallel=None):
        return {"batch": batch, "seq": seq, "fits": batch <= fits_up_to,
                "peak_device_bytes": None, "error": None}

    monkeypatch.setattr(chip_smoke, "_train_batch_probe", probe)
    batch, probes = chip_smoke._largest_batch(CPU, None, 64, None, first,
                                              most)
    assert batch == want
    assert [p["batch"] for p in probes] == probed
