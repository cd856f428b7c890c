"""A CPU rehearsal of ``chip_smoke.py``: every phase at a tiny size, with
the wrappers running their plain versions. It checks the script's paths,
shapes and checks; only a run on the card can show that the kernels
build and agree with the plain versions there."""
import os
import shutil

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
    simt = chip_smoke.phase_flash_attention_train(CPU, 2, 4, 2, 16, 32,
                                                  reps=1)
    assert simt["max_abs_err"] == 0.0 and simt["grad_max_abs_err"] == 0.0
    launches = {"gbdt_logits": 2, "gbdt_grid_logits": 5,
                "flash_attention": 40, "flash_attention_simt": 80,
                "decode_attention": 640}
    line = chip_smoke.kernel_line(
        {"gbdt_logits": small, "gbdt_grid_logits": grid,
         "flash_attention": fa, "flash_attention_simt": simt,
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
    simt = d["qkv_grad"]
    assert simt["shape"] == [8, cfg.n_heads, cfg.n_kv_heads, 16,
                             cfg.resolved_head_dim]
    assert simt["grad_max_abs_err"] == 0.0 and simt["library_ms"] > 0.0
    # the kernel line lists all four kernels, K2 with a row for each of
    # its two kernels (tensor cores for serving, SIMT for training)
    line = chip_smoke.kernel_line(
        {name: {"max_abs_err": 0.0, "ms": 1.0, "plain_ms": 2.0,
                "bound_ms": 0.5, "bound_by": "bytes"}
         for name in chip_smoke.KERNELS} | {"flash_attention_simt": simt},
        {name: 1 for name in chip_smoke.KERNELS})
    assert [k["name"] for k in line["kernels"]] == [
        "gbdt_logits", "gbdt_grid_logits", "flash_attention",
        "flash_attention_simt", "decode_attention"]
    for k in line["kernels"]:
        assert set(k) == KEYS
