"""CPU parity of the port's distribution layer, launch helpers and roofline
with the reference's.

Twins of ``tests/test_parallel.py`` (all but the scan-trip test, whose
twin feeds the reference's compiled HLO text to the port's parser), then:
the partition specs of every arch's parameters (``fsdp`` on and off),
batches and decode caches equal to the reference's as tuples, on the
16x16 and 2x16x16 production meshes (the rules read a mesh's
``axis_names`` and ``shape`` only, so a stand-in serves for both); the
int8 compression bit for bit, ``psum_compressed`` over a two-process
gloo group against the reference's under ``jax.vmap`` over the same two
shards; ``constrain`` on a ``fake``-backend world's DTensors; the
production meshes; ``TrainState.pspecs``, ``model_flops``,
``skip_reason`` and the dry run's stand-ins against the reference's for
every arch x shape; and the dry run on a 2x4 mesh in a subprocess (its
process group never touches this one): held to the fields the
reference's ``test_dryrun_small_mesh`` checks, a reduced cell for each
fault the production sweep had, and its FLOPs per device against the
reference's own small-mesh script's (within 1.5x).

The port's models keep per-layer parameters, so the reference to hold
them to is ``build_model(cfg, scan_layers=False)``.
"""
import ast
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.config import SHAPES as REF_SHAPES
from repro.config import get_arch as ref_get_arch
from repro.config.types import ParallelConfig as RefParallelConfig
from repro.launch import input_specs as ref_specs
from repro.models.lm import build_model as ref_build_model
from repro.parallel import compression as ref_comp
from repro.parallel.sharding import batch_pspec as ref_batch_pspec
from repro.parallel.sharding import cache_pspec as ref_cache_pspec
from repro.parallel.sharding import param_pspecs as ref_param_pspecs
from repro.roofline.hlo_parser import analyze_hlo as ref_analyze_hlo
from repro.roofline.model_flops import model_flops as ref_model_flops
from repro.train.state import TrainState as RefTrainState
from repro_torch.config import SHAPES, get_arch, list_archs
from repro_torch.config.types import ParallelConfig
from repro_torch.launch import input_specs as specs
from repro_torch.models.lm import build_model
from repro_torch.models.param import ParamSpec, logical_to_pspec
from repro_torch.parallel.compression import (compress_tree, dequantize_int8,
                                              error_feedback_update,
                                              quantize_int8)
from repro_torch.parallel.constraints import (constrain, constrain_heads,
                                              default_rules,
                                              get_activation_rules,
                                              set_activation_rules)
from repro_torch.parallel.sharding import (MeshAxes, P, batch_pspec,
                                           cache_pspec, make_shardings,
                                           param_pspecs, param_rules,
                                           placements, sanitize_pspec)
from repro_torch.roofline.analysis import HW
from repro_torch.roofline.hlo_parser import analyze_hlo
from repro_torch.roofline.model_flops import model_flops
from repro_torch.train.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(list_archs())
# stand-ins of the production meshes: what the rules read of a mesh
MESHES = {
    "pod16x16": types.SimpleNamespace(axis_names=("data", "model"),
                                      shape={"data": 16, "model": 16}),
    "pod2x16x16": types.SimpleNamespace(
        axis_names=("pod", "data", "model"),
        shape={"pod": 2, "data": 16, "model": 16}),
}


def _flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts and lists; partition specs (the
    port's ``P``, JAX's ``PartitionSpec``) as plain tuples."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tuple(tree)}


def _pspec_leaves(tree):
    return list(_flat(tree).values())


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).split(".")[-1]
    return np.dtype(dt).name


@pytest.fixture
def world():
    """Stands this process as rank 0 of a ``fake``-backend world of the
    size asked (``world(8)``); the group goes at teardown."""
    from repro_torch.launch.dryrun import fake_world
    yield fake_world
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------ twins of test_parallel.py
@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v3-671b",
                                  "mamba2-370m", "recurrentgemma-2b",
                                  "hubert-xlarge"])
@pytest.mark.parametrize("fsdp", [True, False])
def test_no_duplicate_mesh_axes(arch, fsdp):
    """A partition spec may not use the same mesh axis on two dims."""
    model = build_model(get_arch(arch), device="meta")
    for spec in _pspec_leaves(param_pspecs(model, ParallelConfig(fsdp=fsdp))):
        flat = []
        for part in spec:
            if part is None:
                continue
            flat.extend(part if isinstance(part, tuple) else (part,))
        assert len(flat) == len(set(flat)), f"{arch}: duplicate axes {spec}"


def test_fsdp_shards_embed_dim():
    model = build_model(get_arch("granite-3-2b"), device="meta")
    with_fsdp = param_pspecs(model, ParallelConfig(fsdp=True))
    without = param_pspecs(model, ParallelConfig(fsdp=False))
    n_data = sum("data" in str(s) for s in _pspec_leaves(with_fsdp))
    n_data_off = sum("data" in str(s) for s in _pspec_leaves(without))
    assert n_data > 0 and n_data_off == 0


def test_constraints_are_noop_without_rules():
    set_activation_rules(None)
    x = torch.ones((4, 4))
    assert constrain(x, ("act_batch", None)) is x
    assert constrain_heads(x, 2, ("act_batch", "act_model")) is x


def test_int8_quantization_error_bound():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    q, s = quantize_int8(x)
    back = dequantize_int8(q, s)
    err = float((back - x).abs().max())
    assert err <= float(s) * 0.5 + 1e-7


def test_error_feedback_carries_residual():
    g = {"w": torch.tensor([0.30001, -0.29999, 1.0])}
    r = {"w": torch.zeros(3)}
    sent, res = error_feedback_update(g, r)
    # residual + sent reconstructs the input exactly
    np.testing.assert_allclose((sent["w"] + res["w"]).numpy(),
                               g["w"].numpy(), rtol=1e-6)


def test_hlo_parser_counts_the_references_scan_trips():
    """Twin of ``test_hlo_parser_counts_scan_trips``: the port's parser
    reads the reference's compiled HLO text and counts each scan trip,
    as the reference's parser does."""
    def make(n):
        def f(x, w):
            def body(c, _):
                return jnp.tanh(c @ w), None
            out, _ = jax.lax.scan(body, x, None, length=n)
            return out
        return f

    shapes = (jax.ShapeDtypeStruct((128, 128), jnp.float32),) * 2
    for n in (3, 12):
        text = jax.jit(make(n)).lower(*shapes).compile().as_text()
        got, want = analyze_hlo(text), ref_analyze_hlo(text)
        assert got.flops == pytest.approx(n * 2 * 128**3, rel=1e-6)
        assert (got.flops, got.bytes, got.collectives) == (
            want.flops, want.bytes, want.collectives)


def test_hlo_parser_collectives_synthetic():
    hlo = """
ENTRY %main (p: f32[16,16]) -> f32[16,16] {
  %p = f32[16,16]{1,0} parameter(0)
  %ag = f32[32,16]{1,0} all-gather(%p), replica_groups={}, dimensions={0}
  %ar = f32[16,16]{1,0} all-reduce(%p), to_apply=%add
  ROOT %r = f32[16,16]{1,0} copy(%ar)
}
"""
    c = analyze_hlo(hlo)
    assert c.collectives["all-gather"] == 32 * 16 * 4
    assert c.collectives["all-reduce"] == 16 * 16 * 4


def test_logical_to_pspec_unknown_axis_replicates():
    spec = {"w": ParamSpec((4, 4), ("nonexistent", None))}
    out = logical_to_pspec(spec, param_rules(ParallelConfig()))
    assert out["w"] == P(None, None)
    assert isinstance(out["w"], P) and out["w"] == (None, None)


# --------------------------------------------- the rules against the reference
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference(arch, fsdp):
    """Every parameter's spec, from the port's full-size model on the meta
    device, equals the reference's unstacked model's."""
    got = param_pspecs(build_model(get_arch(arch), device="meta"),
                       ParallelConfig(fsdp=fsdp))
    want = ref_param_pspecs(ref_build_model(ref_get_arch(arch),
                                            scan_layers=False),
                            RefParallelConfig(fsdp=fsdp))
    assert _flat(got) == _flat(want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_pspecs_match_reference(arch, mesh):
    m = MESHES[mesh]
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    model = build_model(cfg, device="meta")
    ref = ref_build_model(ref_cfg, scan_layers=False)
    for shape, ref_shape in zip(SHAPES, REF_SHAPES, strict=True):
        assert _flat(batch_pspec(cfg, shape, m)) == _flat(
            ref_batch_pspec(ref_cfg, ref_shape, m)), shape.name
        if cfg.decoder:
            assert _flat(cache_pspec(model, shape, m)) == _flat(
                ref_cache_pspec(ref, ref_shape, m)), shape.name


def test_sanitize_pspec_drops_axes_that_do_not_divide():
    m = MESHES["pod2x16x16"]
    assert sanitize_pspec(P(("pod", "data"), "model"), (32, 8), m) == P(
        ("pod", "data"), None)
    assert sanitize_pspec(P("data"), (48, 7), m) == P("data", None)


def test_train_state_pspecs_match_reference():
    p = {"w": P("data", "model"), "b": [P(None)]}
    ref_p = jax.tree_util.tree_map(
        lambda s: jax.sharding.PartitionSpec(*s), p,
        is_leaf=lambda x: isinstance(x, P))
    got = TrainState.pspecs(p)
    assert _flat(got) == _flat(RefTrainState.pspecs(ref_p))
    assert got["step"] == P() and got["opt"]["m"] is p


# ------------------------------------------------------------- compression
def _seeded(seed, shapes):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * rng.uniform(0.1, 10.0)).astype(np.float32)
            for s in shapes]


def test_quantization_matches_reference():
    """``quantize_int8``, ``dequantize_int8``, ``compress_tree`` and
    ``error_feedback_update`` bit for bit against the reference's."""
    g0, g1, r0, r1 = _seeded(3, [(64, 33), (7,), (64, 33), (7,)])
    r0, r1 = 1e-3 * r0, 1e-3 * r1
    q, s = quantize_int8(torch.from_numpy(g0))
    rq, rs = ref_comp.quantize_int8(jnp.asarray(g0))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    np.testing.assert_array_equal(
        dequantize_int8(q, s).numpy(),
        np.asarray(ref_comp.dequantize_int8(rq, rs)))
    tree = {"w": torch.from_numpy(g0), "b": [torch.from_numpy(g1)]}
    ref_tree = {"w": jnp.asarray(g0), "b": [jnp.asarray(g1)]}
    got = compress_tree(tree)
    want = ref_comp.compress_tree(ref_tree)
    np.testing.assert_array_equal(got["b"][0][0].numpy(),
                                  np.asarray(want["b"][0][0]))
    res = {"w": torch.from_numpy(r0), "b": [torch.from_numpy(r1)]}
    ref_res = {"w": jnp.asarray(r0), "b": [jnp.asarray(r1)]}
    sent, new_res = error_feedback_update(tree, res)
    want_sent, want_res = ref_comp.error_feedback_update(ref_tree, ref_res)
    for a, b in ((sent, want_sent), (new_res, want_res)):
        np.testing.assert_array_equal(a["w"].numpy(), np.asarray(b["w"]))
        np.testing.assert_array_equal(a["b"][0].numpy(),
                                      np.asarray(b["b"][0]))


_PSUM_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.parallel.compression import psum_compressed
    rank, init, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2)
    data = np.load(path)
    grads = {"w": torch.from_numpy(data[f"w{rank}"]),
             "b": [torch.from_numpy(data[f"b{rank}"])]}
    out = psum_compressed(grads)
    np.savez(path[:-4] + f"_out{rank}.npz", w=out["w"].numpy(),
             b=out["b"][0].numpy())
    dist.destroy_process_group()
""")


def test_psum_compressed_matches_reference_over_two_processes(tmp_path):
    """Two gloo ranks each reduce their shard; each gets what the
    reference's ``psum_compressed`` gives under ``jax.vmap`` with a named
    axis over the same two shards (MAX of the scales, SUM of the int32
    values, over n), bit for bit."""
    w0, w1, b0, b1 = _seeded(5, [(32, 17), (32, 17), (9,), (9,)])
    path = str(tmp_path / "grads.npz")
    np.savez(path, w0=w0, w1=w1, b0=b0, b1=b1)
    init = f"file://{tmp_path / 'store'}"
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    procs = [subprocess.Popen([sys.executable, "-c", _PSUM_WORKER, str(r),
                               init, path], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in (0, 1)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    want = jax.vmap(lambda g: ref_comp.psum_compressed(g, "i"),
                    axis_name="i")({"w": jnp.stack([w0, w1]),
                                    "b": [jnp.stack([b0, b1])]})
    for r in (0, 1):
        got = np.load(path[:-4] + f"_out{r}.npz")
        np.testing.assert_array_equal(got["w"], np.asarray(want["w"][r]))
        np.testing.assert_array_equal(got["b"], np.asarray(want["b"][0][r]))
    # the shared scale makes both ranks' results one
    np.testing.assert_array_equal(np.load(path[:-4] + "_out0.npz")["w"],
                                  np.load(path[:-4] + "_out1.npz")["w"])


# ---------------------------------------------- meshes, DTensors, constrain
def test_production_meshes(world):
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    world(256)
    mesh = make_production_mesh(device_type="cpu")
    axes = MeshAxes(mesh)
    assert axes.axis_names == ("data", "model")
    assert axes.shape == {"data": 16, "model": 16} and axes.size == 256
    world(512)
    axes = MeshAxes(make_production_mesh(multi_pod=True, device_type="cpu"))
    assert axes.axis_names == ("pod", "data", "model")
    assert axes.shape == {"pod": 2, "data": 16, "model": 16}
    world(1)
    assert MeshAxes(make_host_mesh(device_type="cpu")).shape == {
        "data": 1, "model": 1}


def test_mesh_module_touches_no_process_group():
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
            "print(dist.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240,
                         env={**os.environ,
                              "PYTHONPATH": os.path.join(REPO, "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"


def test_make_shardings_places_specs(world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    sh = make_shardings(mesh, {"w": P("data", "model"),
                               "b": [P(None, ("data", "model"))], "r": P()})
    assert sh["w"].placements == (Shard(0), Shard(1))
    assert sh["b"][0].placements == (Shard(1), Shard(1))
    assert sh["r"].placements == (Replicate(), Replicate())
    with pytest.raises(ValueError):           # not in the mesh's order
        placements(P(("model", "data")), mesh)
    with pytest.raises(ValueError):           # one axis on two dims
        placements(P("model", "model"), mesh)


def test_constrain_redistributes_dtensors(world):
    """With rules, a DTensor takes the rules' placements (an axis that
    does not divide its dim dropped) and a plain tensor passes through;
    ``constrain_heads`` gathers a fused projection whose heads do not
    divide the model axis."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    rules = default_rules(MeshAxes(mesh))
    assert rules["act_batch"] == ("data",)
    x = distribute_tensor(torch.empty((8, 16, 32), device="meta"), mesh,
                          [Replicate(), Replicate()])
    plain = torch.zeros(8, 16, 32)
    set_activation_rules(rules)
    try:
        assert get_activation_rules() is rules
        y = constrain(x, ("act_batch", None, "act_model"))
        assert y.placements == (Shard(0), Shard(2))
        assert tuple(y.to_local().shape) == (4, 16, 8)
        assert constrain(plain, ("act_batch", None, "act_model")) is plain
        odd = distribute_tensor(torch.empty((8, 6, 32), device="meta"), mesh,
                                [Replicate(), Replicate()])
        assert constrain(odd, (None, "act_model", None)).placements == (
            Replicate(), Replicate())
        fused = constrain_heads(y, 2, ("act_batch", None, "act_model"))
        assert fused.placements == (Shard(0), Replicate())
        assert constrain_heads(x, 8, ("act_batch", None,
                                      "act_model")).placements == (
            Shard(0), Shard(2))
    finally:
        set_activation_rules(None)


# ------------------------------------------------ model FLOPs and stand-ins
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch):
    for shape, ref_shape in zip(SHAPES, REF_SHAPES, strict=True):
        assert model_flops(get_arch(arch), shape) == ref_model_flops(
            ref_get_arch(arch), ref_shape), shape.name


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    """``skip_reason`` and every stand-in's shape and dtype (the cache's
    per layer) equal the reference's for every shape; the stand-ins are
    on the meta device."""
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    model = build_model(cfg, device="meta")
    ref = ref_build_model(ref_cfg, scan_layers=False)
    for shape, ref_shape in zip(SHAPES, REF_SHAPES, strict=True):
        reason = specs.skip_reason(cfg, shape)
        assert reason == ref_specs.skip_reason(ref_cfg, ref_shape)
        if reason is not None:
            continue
        got = specs.input_specs(model, shape)
        want = ref_specs.input_specs(ref, ref_shape)
        got_flat = {k: (tuple(t.shape), _dtype_name(t.dtype))
                    for k, t in _tensors(got).items()}
        want_flat = {k: (tuple(t.shape), _dtype_name(t.dtype))
                     for k, t in _tensors(want).items()}
        assert got_flat == want_flat, shape.name
        assert all(t.device.type == "meta" for t in _tensors(got).values())


def _tensors(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items()
                for p, t in _tensors(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {p: t for i, v in enumerate(tree)
                for p, t in _tensors(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch):
    got = build_model(get_arch(arch), device="meta").abstract_params()
    want = ref_build_model(ref_get_arch(arch),
                           scan_layers=False).abstract_params()
    assert {k: (tuple(t.shape), _dtype_name(t.dtype))
            for k, t in _tensors(got).items()} == {
        k: (tuple(t.shape), _dtype_name(t.dtype))
        for k, t in _tensors(want).items()}
    assert all(t.device.type == "meta" for t in _tensors(got).values())


def test_hw_is_the_h100():
    hw = HW()
    assert (hw.peak_flops, hw.f32_flops, hw.hbm_bw, hw.hbm_bytes) == (
        989e12, 67e12, 3.35e12, 80e9)
    assert hw.ici_bw == 900e9 / 2


def test_program_cost_counts_local_ops():
    """``ProgramCost`` on plain tensors: an argument counted once however
    often it appears, the flop counter's formula, XLA's bytes-accessed
    convention, and the peak of live bytes (an output counts until it
    is freed)."""
    from repro_torch.roofline.analysis import ProgramCost
    a = torch.empty(64, 32, device="meta")
    b = torch.empty(32, 16, device="meta")
    with ProgramCost([a, b, {"again": a}]) as cost:
        c = a @ b
        d = c * 2
        del c
        live = cost.live_bytes
    out = 64 * 16 * 4
    assert cost.argument_bytes == (64 * 32 + 32 * 16) * 4
    assert cost.flops == 2 * 64 * 32 * 16
    assert cost.bytes == (64 * 32 + 32 * 16) * 4 + out + 2 * out
    assert cost.peak_bytes == cost.argument_bytes + 2 * out
    assert live == cost.argument_bytes + out and cost.temp_bytes == 2 * out
    assert cost.collective_bytes == 0 and d.shape == (64, 16)


# ------------------------------------------------------------------ dry run
_DRYRUN = textwrap.dedent("""
    import json, logging
    logging.disable(logging.WARNING)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.config import get_arch, reduced_config
    from repro_torch.config.types import ParallelConfig, ShapeConfig
    from repro_torch.launch.dryrun import dry_step, failure, fake_world
    from repro_torch.parallel.constraints import default_rules
    from repro_torch.parallel.sharding import MeshAxes
    from repro_torch.roofline.analysis import analyze_program

    fake_world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    rules = default_rules(MeshAxes(mesh))
    shape = ShapeConfig("tiny", 64, 8, "train")
    par = ParallelConfig(fsdp=True, remat="dots")
    cfg = reduced_config(get_arch("granite-3-2b"))
    cost, _, _ = dry_step(cfg, shape, par, mesh, rules)
    report = analyze_program(cost, cfg.name, shape.name, "mesh2x4", 8,
                             model_flops=1.0)
    try:
        moe_cost, _, _ = dry_step(
            reduced_config(get_arch("moonshot-v1-16b-a3b")), shape, par,
            mesh, rules)
        moe = {"flops": moe_cost.flops,
               "collectives": moe_cost.collectives}
    except Exception as e:
        moe = failure(e)
    print(json.dumps({
        "temp_bytes": cost.temp_bytes,
        "flops": report.flops_per_device,
        "collective_bytes": report.collective_bytes_per_device,
        "breakdown": report.collective_breakdown,
        "bottleneck": report.bottleneck,
        "record": report.to_dict(),
        "moe": moe,
    }))
""")


def test_dryrun_small_mesh():
    """Twin of ``test_dryrun_small_mesh``: reduced granite's train step on
    a 2x4 mesh, meta DTensors over a ``fake`` world, in its own process;
    then the reduced MoE's train step on the same mesh, which runs (the
    router's aux loss and the grouped dispatch shard on the batch)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    out = subprocess.run([sys.executable, "-c", _DRYRUN], env=env,
                         capture_output=True, text=True, timeout=420)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["flops"] > 0
    assert rec["temp_bytes"] > 0
    assert rec["collective_bytes"] > 0     # sharded program must communicate
    assert rec["breakdown"]["all-gather"] > 0          # the FSDP gather
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["record"]["t_compute_s"] > 0
    assert isinstance(rec["moe"], dict), rec["moe"]
    assert rec["moe"]["flops"] > 0
    assert rec["moe"]["collectives"]["all-reduce"] > 0   # the aux's sum


# one case per fault the dry run had on the production meshes: the
# in-place cache write (GQA and MLA decode, the sequence-sharded
# long-context cache), the MoE's aux loss and dispatch, the microbatch
# split, and heads that do not divide the model axis (recurrentgemma at
# 3 layers, so that one block is attention, and 6 heads over 4 as its
# 10 over 16, its residual stream sequence-sharded as the dry run
# shards it): (arch, kind, batch, microbatches, sequence-sharded
# stream, config overrides)
_CELLS = {
    "granite_decode": ("granite-3-2b", "decode", 8, 1, False, {}),
    "deepseek_mla_decode": ("deepseek-v3-671b", "decode", 8, 1, False, {}),
    "danube_long_decode": ("h2o-danube-1.8b", "long_decode", 1, 1, False,
                           {}),
    "moonshot_prefill": ("moonshot-v1-16b-a3b", "prefill", 8, 1, False, {}),
    "moonshot_train": ("moonshot-v1-16b-a3b", "train", 8, 1, False, {}),
    "granite_microbatches": ("granite-3-2b", "train", 8, 2, False, {}),
    "recurrentgemma_train": ("recurrentgemma-2b", "train", 8, 1, True,
                             {"n_layers": 3, "n_heads": 6}),
}

_CELL = textwrap.dedent("""
    import dataclasses, json, logging, sys
    logging.disable(logging.WARNING)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.config import get_arch, reduced_config
    from repro_torch.config.types import ParallelConfig, ShapeConfig
    from repro_torch.launch.dryrun import _rules, dry_step, fake_world
    from repro_torch.parallel.sharding import MeshAxes

    arch, kind, batch, micro, seq_shard, over = json.loads(sys.argv[1])
    fake_world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    shape = ShapeConfig("tiny", 64, batch, kind)
    par = ParallelConfig(fsdp=True, microbatches=micro,
                         remat="dots" if kind == "train" else "none",
                         seq_shard_attn=seq_shard)
    cfg = dataclasses.replace(reduced_config(get_arch(arch)), **over)
    cost, _, _ = dry_step(cfg, shape, par, mesh,
                          _rules(cfg, shape, MeshAxes(mesh), par))
    print(json.dumps({"flops": cost.flops, "bytes": cost.bytes,
                      "temp_bytes": cost.temp_bytes,
                      "collectives": cost.collectives}))
""")


@pytest.mark.parametrize("cell", sorted(_CELLS))
def test_dryrun_small_mesh_repaired_cells(cell):
    """Each cell runs on the 2x4 mesh with the dry run's rules for its
    shape, and its device communicates."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    out = subprocess.run([sys.executable, "-c", _CELL,
                          json.dumps(_CELLS[cell])], env=env,
                         capture_output=True, text=True, timeout=420)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["flops"] > 0 and rec["bytes"] > 0 and rec["temp_bytes"] > 0
    assert sum(rec["collectives"].values()) > 0


def _reference_script() -> str:
    """``SCRIPT`` of ``tests/test_dryrun_mechanism.py``, read from its
    source (a ``textwrap.dedent`` of one string literal)."""
    path = os.path.join(REPO, "tests", "test_dryrun_mechanism.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and n.targets[0].id == "SCRIPT")
    return textwrap.dedent(ast.literal_eval(node.value.args[0]))


def test_dryrun_counts_near_the_reference():
    """The reference's own small-mesh script (``tests/
    test_dryrun_mechanism.py``), its mesh's axes made ``Auto`` as its
    sharding rules need, against the port's count of the same cell:
    reduced granite's train step on 2x4. XLA counts elementwise and
    transcendental work besides the products, the port only what the
    flop counter counts, so a port count above the reference's is work
    done more than once; it stays within 1.5x. The products are most of
    the step's work, so a count below half the reference's is work the
    counter missed."""
    SCRIPT = _reference_script()
    mesh_line = 'mesh = jax.make_mesh((2, 4), ("data", "model"))'
    assert mesh_line in SCRIPT
    ref_script = SCRIPT.replace(mesh_line, (
        "from jax.sharding import AxisType\n"
        'mesh = jax.make_mesh((2, 4), ("data", "model"), '
        "axis_types=(AxisType.Auto,) * 2)"))
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    runs = {}
    for name, script in (("reference", ref_script), ("port", _DRYRUN)):
        out = subprocess.run([sys.executable, "-c", script], env=env,
                             capture_output=True, text=True, timeout=420)
        assert out.returncode == 0, out.stderr[-3000:]
        runs[name] = json.loads(out.stdout.strip().splitlines()[-1])
    ref, port = runs["reference"], runs["port"]
    report = ", ".join(
        f"{k}: port {port[k]:.4g} reference {ref[k]:.4g}"
        for k in ("flops", "temp_bytes", "collective_bytes"))
    assert 0.5 * ref["flops"] <= port["flops"] <= 1.5 * ref["flops"], report


_XENT = textwrap.dedent("""
    import json, sys, logging
    logging.disable(logging.WARNING)
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.models.lm import _xent
    from repro_torch.roofline.analysis import ProgramCost

    fake_world(8)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    b, s, v = (int(a) for a in sys.argv[1:4])
    logits = distribute_tensor(
        torch.empty((b, s, v), device="meta"), mesh,
        [Shard(0), Shard(2)]).requires_grad_(True)
    labels = distribute_tensor(
        torch.zeros((b, s), dtype=torch.long, device="meta"), mesh,
        [Shard(0), Replicate()])
    with ProgramCost((logits, labels)) as cost:
        (grad,) = torch.autograd.grad(_xent(logits, labels), [logits])
    print(json.dumps({"collectives": cost.collectives,
                      "temp_bytes": cost.temp_bytes,
                      "shard_bytes": 4 * logits.to_local().numel(),
                      "grad_layout_kept":
                          grad.placements == logits.placements}))
""")


def test_cross_entropy_keeps_the_vocab_split():
    """The loss and its gradient on logits split over the batch (data)
    and the vocab (model), counted on a fake 2x4 world: only the rows'
    reductions cross the model axis (all-reduces of (B, S) values), no
    logit shard moves (no all-gather, no all-to-all, whose CPU fallback
    gathers the vocab whole), the gradient keeps the logits' layout and
    the temporaries stay within a few shards. ``log_softmax`` on the
    DTensor moved the shards to gather the vocab: the train_4k cell of
    paligemma-3b on 16x16 peaked at 2.0e11 B a device against the
    reference's 2.7e10 (``dryrun_xent_peaks.py``)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    b, s, v = 8, 16, 4096
    out = subprocess.run([sys.executable, "-c", _XENT, str(b), str(s),
                          str(v)], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    moved = {k: rec["collectives"][k] for k in ("all-gather", "all-to-all",
                                                "reduce-scatter")}
    assert moved == {k: 0.0 for k in moved}, moved
    # each reduction over the vocab: (B / 2, S) float32 values a device
    assert 0 < rec["collectives"]["all-reduce"] <= 8 * 4 * (b // 2) * s
    assert rec["grad_layout_kept"]
    assert rec["temp_bytes"] <= 4 * rec["shard_bytes"]


def test_dryrun_records_a_skipped_cell(tmp_path):
    from repro_torch.launch.dryrun import run_cell
    rec = run_cell("hubert-xlarge", "decode_32k", False,
                   out_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "skipped"
    with open(tmp_path / "hubert-xlarge__decode_32k__pod16x16.json") as f:
        assert json.load(f) == rec
