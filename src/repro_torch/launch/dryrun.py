"""Multi-pod dry run (the twin of ``repro/launch/dryrun.py``).

For every runnable (architecture x input shape) cell and each production
mesh (single-pod 16x16, multi-pod 2x16x16), in one process that stands
as rank 0 of a ``fake``-backend world of the mesh's size:

    params, batch  = meta DTensors, sharded by parallel/sharding.py
    with ProgramCost(...) as cost:       # roofline/analysis.py
        step(...)                        # train/step.py's, on meta
    report = analyze_program(cost, ...)  # FLOPs/bytes for the roofline

and records the roofline terms to JSON. Nothing is allocated and no
device is touched: every tensor lives on the meta device, DTensor
propagates the shardings op by op, and the fake process group answers
every collective. Failures here are sharding bugs, or an op DTensor has
no sharding rule for (the cell fails and says which).

The reference lowers and compiles one SPMD program with XLA; the port
runs the eager step once. So a record's ``lower_s`` is the seconds to
build and shard the stand-ins and ``compile_s`` those of the step's run.

Usage:
    python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--single-pod]

A sweep runs each cell in a process of its own, as many at once as the
host has cores. It ends with each mesh's count of ok, failed and skipped
cells and its seconds.

Records go to ``dryrun_results_torch/`` at the repo root (``--out``).
"""
import argparse
import json
import os
import time
import traceback
from typing import Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

# caratlint: disable-file=CL007 — CLI entry point: prints reports to the
# terminal and times wall-clock runs outside any fleet

from repro_torch.config import SHAPES, get_arch, list_archs
from repro_torch.config.types import (ArchConfig, ParallelConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.launch.input_specs import input_specs, skip_reason
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.lm import _pairs, build_model
from repro_torch.parallel.constraints import (default_rules,
                                              set_activation_rules)
from repro_torch.parallel.sharding import (MeshAxes, P, batch_pspec,
                                           cache_pspec, map_specs,
                                           param_pspecs,
                                           register_op_shardings,
                                           sanitized_sharding)
from repro_torch.roofline.analysis import ProgramCost, analyze_program
from repro_torch.roofline.model_flops import model_flops
from repro_torch.train.step import (_STATE_DTYPES, make_decode_step,
                                    make_prefill_step, make_train_step)
from repro_torch.utils.tree import tree_map

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "dryrun_results_torch")


def parallel_for(cfg: ArchConfig, shape: ShapeConfig) -> ParallelConfig:
    """Per-arch distribution knobs (the reference's).

    Env overrides for §Perf iterations:
      REPRO_SEQ_SHARD=1      sequence-shard the residual stream over "model"
      REPRO_MICROBATCHES=N   gradient-accumulate over N microbatches
      REPRO_REMAT=none|dots|full
    """
    n = cfg.param_count()
    big = n > 60e9
    # optimized defaults from the §Perf iterations: sequence-parallel
    # residual streams for >=2.7B (16x smaller layer-carry remat stack;
    # measured wins down to recurrentgemma-2b), 4-way microbatching for
    # the XXL archs (live activations /4)
    seq_shard_default = "1" if n > 2.7e9 else "0"
    micro_default = "4" if big else "1"
    return ParallelConfig(
        fsdp=True,
        remat=os.environ.get(
            "REPRO_REMAT", "full" if shape.kind == "train" else "none"),
        scan_layers=True,
        microbatches=int(os.environ.get("REPRO_MICROBATCHES",
                                        micro_default if shape.kind == "train"
                                        else "1")),
        opt_state_dtype="bfloat16" if big else "float32",
        seq_shard_attn=os.environ.get("REPRO_SEQ_SHARD",
                                      seq_shard_default) == "1",
    )


def fake_world(size: int) -> None:
    """Stand this process as rank 0 of a ``fake``-backend world of
    ``size`` ranks (its collectives move nothing), replacing a world of
    another size."""
    import torch.distributed as dist
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def distribute(tree, pspecs, mesh):
    """DTensors of ``tree``'s (meta) tensors, placed on ``mesh`` by a tree
    of partition specs of one layout, divisibility-sanitized."""
    def one(p, t):
        return distribute_tensor(
            t, mesh, sanitized_sharding(p, t.shape, mesh).placements)

    return map_specs(one, pspecs, tree)


def shard_model(model: nn.Module, params) -> None:
    """Put the DTensors of ``params`` (a tree of the layout of
    ``model.param_specs()``) in the place of the model's parameters."""
    owners = {id(p): (mod, name) for mod in model.modules()
              for name, p in mod._parameters.items() if p is not None}
    for new, old in list(_pairs(params, model.param_tree())):
        mod, name = owners[id(old)]
        mod._parameters[name] = nn.Parameter(new, requires_grad=False)


def _rules(cfg: ArchConfig, shape: ShapeConfig, axes: MeshAxes,
           parallel: ParallelConfig):
    """The activation rules the reference installs for this mesh (batch
    axis only when the global batch divides it — long_500k runs
    batch-replicated)."""
    batch_axes = tuple(a for a in ("pod", "data") if a in axes.axis_names)
    divisible = all(shape.global_batch % axes.shape[a] == 0
                    for a in batch_axes) and shape.global_batch >= _prod(
                        [axes.shape[a] for a in batch_axes])
    rules = default_rules(axes, batch_divisible=divisible)
    if shape.is_serve and cfg.n_heads:
        # match the cache layout chosen by parallel.sharding.cache_pspec
        model_size = axes.shape["model"]
        if cfg.n_kv_heads % model_size == 0:
            rules["act_kv_heads"] = "model"
        elif cfg.resolved_head_dim % model_size == 0 and not divisible:
            pass        # long-context: cache seq-sharded, leave q replicated
        elif cfg.resolved_head_dim % model_size == 0:
            rules["act_head_dim"] = "model"
    if parallel.seq_shard_attn and shape.kind == "train":
        # Megatron-style sequence parallelism: the residual stream between
        # blocks is sharded over "model"; attention/MLP projections
        # all-gather it locally
        rules["act_seq"] = "model"
    return rules


def dry_step(cfg: ArchConfig, shape: ShapeConfig, parallel: ParallelConfig,
             mesh, rules) -> Tuple[ProgramCost, float, float]:
    """One train, prefill or decode step (by ``shape.kind``) of ``cfg``
    on meta DTensors over ``mesh`` (a ``DeviceMesh`` whose world
    stands), the activation ``rules`` installed. Returns the step's
    counted cost and the seconds to shard the stand-ins and to run."""
    t0 = time.time()
    axes = MeshAxes(mesh)
    run = RunConfig(arch=cfg, shape=shape, parallel=parallel)
    model = build_model(cfg, device="meta")
    register_op_shardings()

    shard_model(model, distribute(model.abstract_params(),
                                  param_pspecs(model, parallel), mesh))
    specs = input_specs(model, shape)
    if shape.kind == "train":
        step = make_train_step(model, run)
        opt_dtype = _STATE_DTYPES[parallel.opt_state_dtype]

        def moment(p):
            return distribute_tensor(
                torch.empty(p.shape, dtype=opt_dtype, device="meta"),
                p.device_mesh, p.placements)

        count = torch.zeros((), dtype=torch.int32, device="meta")
        tree = model.param_tree()
        state = {"params": tree,
                 "opt": {"m": tree_map(moment, tree),
                         "v": tree_map(moment, tree), "count": count},
                 "step": count.clone()}
        batch = distribute(specs["batch"], batch_pspec(cfg, shape, axes),
                           mesh)
        args = (state, batch)
    elif shape.kind == "prefill":
        step = make_prefill_step(model, run)
        b_pspecs = {k: v for k, v in batch_pspec(cfg, shape, axes).items()
                    if k in specs["batch"]}
        args = (distribute(specs["batch"], b_pspecs, mesh),)
    else:  # decode / long_decode
        step = make_decode_step(model, run)
        cache = distribute(specs["cache"], cache_pspec(model, shape, axes),
                           mesh)
        batch_axes = tuple(a for a in ("pod", "data")
                           if a in axes.axis_names)
        bsz = shape.global_batch
        tok_axes = batch_axes if all(
            bsz % axes.shape[a] == 0 for a in batch_axes) and _prod(
            [axes.shape[a] for a in batch_axes]) <= bsz else ()
        tok = P(tok_axes or None)
        args = (distribute(specs["tokens"], tok, mesh), cache,
                distribute(specs["pos"], tok, mesh))
    t_lower = time.time() - t0

    set_activation_rules(rules)
    try:
        # plain tensors the step makes (positions, masks, constants) join
        # the DTensors as replicated
        with ProgramCost((model.param_tree(), args)) as cost, \
                implicit_replication():
            step(*args)
    finally:
        set_activation_rules(None)
    return cost, t_lower, time.time() - t0 - t_lower


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = RESULTS_DIR, verbose: bool = True):
    cfg = get_arch(arch_name)
    shape = next(s for s in SHAPES if s.name == shape_name)
    reason = skip_reason(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    record = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name}
    if reason is not None:
        record["status"] = "skipped"
        record["reason"] = reason
        _write(record, out_dir)
        if verbose:
            print(f"[skip] {arch_name} x {shape_name}: {reason}")
        return record

    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    axes = MeshAxes(mesh)
    chips = axes.size
    parallel = parallel_for(cfg, shape)
    cost, t_lower, t_compile = dry_step(
        cfg, shape, parallel, mesh, _rules(cfg, shape, axes, parallel))

    if verbose:
        print(f"=== {arch_name} x {shape_name} x {mesh_name} ===")
        print(f"shard {t_lower:.1f}s run {t_compile:.1f}s")
        print("memory: arguments=%.3e temp=%.3e peak=%.3e" % (
            cost.argument_bytes, cost.temp_bytes, cost.peak_bytes))
        print("cost: flops=%.3e bytes=%.3e" % (cost.flops, cost.bytes))

    report = analyze_program(cost, arch_name, shape_name, mesh_name, chips,
                             model_flops(cfg, shape))
    record.update(report.to_dict())
    record["status"] = "ok"
    record["lower_s"] = t_lower
    record["compile_s"] = t_compile
    record["argument_bytes"] = cost.argument_bytes
    record["temp_bytes"] = cost.temp_bytes
    _write(record, out_dir)
    if verbose:
        print(f"terms: compute={report.t_compute:.4f}s "
              f"memory={report.t_memory:.4f}s "
              f"collective={report.t_collective:.4f}s "
              f"-> bottleneck={report.bottleneck} "
              f"roofline_frac={report.roofline_fraction:.3f}")
    return record


def failure(e: BaseException) -> str:
    """The exception's type and first line, and the innermost line of the
    port's model or step code that raised it (the op DTensor has no rule
    for is on it)."""
    where = [f for f in traceback.extract_tb(e.__traceback__)
             if f"{os.sep}repro_torch{os.sep}" in f.filename
             and not any(f"{os.sep}{d}{os.sep}" in f.filename
                         for d in ("launch", "roofline"))]
    head = f"{type(e).__name__}: {str(e).splitlines()[0] if str(e) else ''}"
    if not where:
        return head
    f = where[-1]
    name = os.path.relpath(f.filename, os.path.dirname(os.path.dirname(
        os.path.dirname(__file__))))
    return f"{head} at {name}:{f.lineno}: {f.line}"


def _prod(xs):
    n = 1
    for x in xs:
        n *= x
    return n


def _write(record, out_dir):
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(record, f, indent=2)


def _run(cell) -> dict:
    """One (arch, shape, multi_pod, out_dir) cell's record; a cell that
    raises gets a failed record with its ``failure()``."""
    a, s, mp, out = cell
    try:
        return run_cell(a, s, mp, out_dir=out)
    except Exception as e:
        traceback.print_exc()
        record = {"arch": a, "shape": s,
                  "mesh": "pod2x16x16" if mp else "pod16x16",
                  "status": "failed", "error": failure(e)}
        _write(record, out)
        return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    if args.single_pod and not args.multi_pod:
        meshes = [False]
    elif args.multi_pod and not args.single_pod:
        meshes = [True]
    else:
        meshes = [False, True]

    cells = []
    if args.all:
        for a in list_archs():
            for s in SHAPES:
                cells.append((a, s.name))
    else:
        cells.append((args.arch, args.shape))

    t0 = time.time()
    tasks = [(a, s, mp, args.out) for a, s in cells for mp in meshes]
    if len(tasks) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        # a module function (``__main__``'s would not unpickle in the
        # spawned workers)
        from repro_torch.launch import dryrun

        # each cell in a process of its own: a world torn down for one of
        # another size leaves DTensor's caches holding meshes whose
        # process groups are gone
        with ProcessPoolExecutor(
                min(len(tasks), os.cpu_count() or 1),
                mp_context=multiprocessing.get_context("spawn"),
                max_tasks_per_child=1) as pool:
            records = list(pool.map(dryrun._run, tasks))
    else:
        records = [_run(t) for t in tasks]
    for mesh in sorted({r["mesh"] for r in records}):
        counts = {k: sum(r["mesh"] == mesh and r["status"] == k
                         for r in records)
                  for k in ("ok", "failed", "skipped")}
        print(f"{mesh}: {counts['ok']} ok, {counts['failed']} failed, "
              f"{counts['skipped']} skipped")
    print(f"{time.time() - t0:.0f} s")
    failures = [r for r in records if r["status"] == "failed"]
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for r in failures:
            print("  ", (r["arch"], r["shape"], r["mesh"], r["error"]))
        raise SystemExit(1)
    print("\nall cells OK")


if __name__ == "__main__":
    main()
