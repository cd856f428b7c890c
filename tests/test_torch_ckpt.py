"""CPU parity of the port's checkpointing (``repro_torch.ckpt``) with the
reference's.

Twins of the checkpoint half of ``tests/test_ckpt_runtime.py`` and of
``tests/test_elastic_integration.py`` (a bit-exact restart, and the
monitor -> plan -> restart flow), then the port held to ``repro``:
the same state writes the same files (leaf names, shards, arrays); a
checkpoint the reference writes from a ``scan_layers=False`` model
restores into the port's state, whose next two steps reproduce the
reference's losses at the train step's ``rel=1e-5``
(``tests/test_train.py:67``); and the storage cost model charges the
same simulated seconds.
"""
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as RefManager
from repro.config import get_arch as ref_get_arch
from repro.config import reduced_config as ref_reduced_config
from repro.config.types import CheckpointConfig as RefCheckpointConfig
from repro.config.types import ParallelConfig as RefParallelConfig
from repro.config.types import RunConfig as RefRunConfig
from repro.config.types import ShapeConfig as RefShapeConfig
from repro.data.pipeline import TokenSource as RefTokenSource
from repro.data.pipeline import make_host_batch as ref_make_host_batch
from repro.models.lm import build_model as ref_build_model
from repro.storage import Simulation as RefSimulation
from repro.storage.workloads import get_workload as ref_get_workload
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.state import TrainState as RefTrainState
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.ckpt import CheckpointManager
from repro_torch.config import (CheckpointConfig, ParallelConfig, RunConfig,
                                ShapeConfig, get_arch, reduced_config)
from repro_torch.data import TokenSource, make_host_batch
from repro_torch.models.lm import build_model
from repro_torch.runtime.fault_tolerance import ClusterMonitor
from repro_torch.storage import Simulation
from repro_torch.storage.workloads import get_workload
from repro_torch.train import AdamWConfig, TrainState, make_train_step
from repro_torch.utils.tree import tree_flatten_with_paths, tree_leaves


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 4), generator=g),
                   "b": torch.zeros((4,))},
        "opt": {"m": {"w": torch.ones((8, 4)), "b": torch.zeros((4,))},
                "count": torch.tensor(7, dtype=torch.int32)},
        "step": torch.tensor(42, dtype=torch.int32),
    }


# ------------------------------------------ twins of test_ckpt_runtime.py
def test_save_restore_roundtrip():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(CheckpointConfig(directory=d), n_shards=3)
        state = _state()
        mgr.save(state, step=42, blocking=True)
        restored, step = mgr.restore(_state(1))
        assert step == 42
        for a, b in zip(tree_leaves(state), tree_leaves(restored)):
            assert torch.equal(a, b)


def test_async_save_then_restore():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(CheckpointConfig(directory=d,
                                                 async_write=True))
        state = _state(1)
        mgr.save(state, step=1)
        mgr.wait()
        restored, step = mgr.restore(_state(2))
        assert step == 1


def test_corruption_detected():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(CheckpointConfig(directory=d), n_shards=1)
        mgr.save(_state(), step=5, blocking=True)
        shard = os.path.join(d, "step_00000005", "shard_0.npz")
        with open(shard, "r+b") as f:
            f.seek(100)
            f.write(b"\x00\x01\x02")
        with pytest.raises(IOError):
            mgr.restore(_state())


def test_gc_keeps_latest():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(CheckpointConfig(directory=d, keep=2))
        for s in (1, 2, 3, 4):
            mgr.save(_state(), step=s, blocking=True)
        assert mgr.latest_step() == 4
        names = sorted(os.listdir(d))
        assert "step_00000001" not in names
        assert len([n for n in names if n.startswith("step_")]) == 2


# ------------------------------------------------------------ port-specific
def test_async_save_is_a_consistent_cut():
    """The trainer updates its tensors in place right after ``save``: the
    checkpoint holds the values at the call."""
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(CheckpointConfig(directory=d,
                                                 async_write=True))
        state = _state(3)
        before = [t.clone() for t in tree_leaves(state)]
        mgr.save(state, step=9)
        for t in tree_leaves(state):
            t.add_(1)
        mgr.wait()
        restored, _ = mgr.restore(_state(4))
        for a, b in zip(before, tree_leaves(restored)):
            assert torch.equal(a, b)


def test_restore_checks_keys_and_shapes():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(CheckpointConfig(directory=d))
        mgr.save(_state(), step=1, blocking=True)
        wrong = _state()
        wrong["params"]["w"] = torch.zeros((4, 8))
        with pytest.raises(ValueError, match="params/w"):
            mgr.restore(wrong)
        extra = _state()
        extra["params"]["c"] = torch.zeros(2)
        with pytest.raises(KeyError, match="params/c"):
            mgr.restore(extra)


def test_same_state_writes_the_references_files():
    """One state written by both managers: the same manifest (step,
    shards, each shard's keys) and the same arrays under the same
    names."""
    state = _state(5)
    np_state = jax.tree_util.tree_map(np.asarray, {
        "params": {k: v.numpy() for k, v in state["params"].items()},
        "opt": {"m": {k: v.numpy() for k, v in state["opt"]["m"].items()},
                "count": state["opt"]["count"].numpy()},
        "step": state["step"].numpy()})
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(CheckpointConfig(directory=f"{d}/port"),
                          n_shards=3).save(state, 42, blocking=True)
        RefManager(RefCheckpointConfig(directory=f"{d}/ref"),
                   n_shards=3).save(np_state, 42, blocking=True)
        man = {}
        for who in ("port", "ref"):
            with open(f"{d}/{who}/step_00000042/manifest.json") as f:
                man[who] = json.load(f)
        assert man["port"]["step"] == man["ref"]["step"] == 42
        for name, entry in man["ref"]["entries"].items():
            assert man["port"]["entries"][name]["keys"] == entry["keys"]
            with np.load(f"{d}/port/step_00000042/{name}") as a, \
                    np.load(f"{d}/ref/step_00000042/{name}") as b:
                assert sorted(a.files) == sorted(b.files)
                for k in b.files:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])


def test_simulate_write_cost_matches_reference():
    wl = "s_wr_sq_1m"
    sim = Simulation([get_workload(wl)] * 3, seed=2, backend="scalar")
    ref_sim = RefSimulation([ref_get_workload(wl)] * 3, seed=2)
    with tempfile.TemporaryDirectory() as d:
        got = CheckpointManager(CheckpointConfig(directory=d)) \
            .simulate_write_cost(96e6, sim, [0, 2])
        want = RefManager(RefCheckpointConfig(directory=d)) \
            .simulate_write_cost(96e6, ref_sim, [0, 2])
    assert got == want and got > 0.0


# ----------------------------------------- twins of test_elastic_integration
def _setup(seed_source=3):
    cfg = reduced_config(get_arch("h2o-danube-1.8b"))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    run = RunConfig(arch=cfg, shape=ShapeConfig("t", 16, 4, "train"),
                    parallel=ParallelConfig(remat="none",
                                            opt_state_dtype="float32"))
    step_fn = make_train_step(model, run)
    source = TokenSource(cfg.vocab_size, seed=seed_source)

    def batch(i):
        return make_host_batch(cfg, 16, 4, source, i)

    return cfg, model, step_fn, batch


def test_checkpoint_restart_is_bit_exact():
    cfg, model, step_fn, batch = _setup()
    model.init(torch.Generator().manual_seed(0))
    state = TrainState.init(model.param_tree(), AdamWConfig())

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(CheckpointConfig(directory=d), n_shards=3)
        # run 6 steps, checkpoint at 4
        losses = []
        for i in range(6):
            if i == 4:
                mgr.save(state, step=4, blocking=True)
            state, m = step_fn(state, batch(i))
            losses.append(float(m["loss"]))

        # "failure": fresh weights and optimizer state, then restore
        model.init(torch.Generator().manual_seed(99))
        fresh = TrainState.init(model.param_tree(), AdamWConfig())
        restored, step = mgr.restore(fresh)
        assert step == 4
        assert int(restored["step"]) == 4

        # continue: steps 4 and 5 must reproduce the original losses exactly
        replay = []
        st = restored
        for i in (4, 5):
            st, m = step_fn(st, batch(i))
            replay.append(float(m["loss"]))
        np.testing.assert_allclose(replay, losses[4:6], rtol=0, atol=0)


def test_failure_to_plan_to_restart_flow():
    """Monitor -> plan -> restart-step selection, end to end."""
    cfg, model, step_fn, batch = _setup()
    model.init(torch.Generator().manual_seed(1))
    state = TrainState.init(model.param_tree(), AdamWConfig())

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(CheckpointConfig(directory=d, keep=3))
        # 16 hosts, TP groups of 4 => data axis 4
        mon = ClusterMonitor(16, {h: h // 4 for h in range(16)},
                             data_size=4, miss_limit=2)
        plan = None
        for i in range(8):
            state, _ = step_fn(state, batch(i))
            if i and i % 3 == 0:
                mgr.save(state, step=i, blocking=True)
            alive = set(range(16)) - ({9} if i >= 5 else set())
            p = mon.tick(alive)
            if p is not None:
                plan = p
                plan.restart_step = mgr.latest_step()
                break
        assert plan is not None
        assert 9 in plan.dead_hosts
        # group 2 (hosts 8-11) lost => 3 replicas -> pow2 shrink to 2
        assert plan.new_data_size == 2
        assert plan.restart_step == 6
        restored, step = mgr.restore(state, step=plan.restart_step)
        assert int(restored["step"]) == 7  # state AFTER step index 6 ran


# ------------------------------------- a reference checkpoint, continued
@pytest.mark.parametrize("arch", ["granite-3-2b", "h2o-danube-1.8b"])
def test_reference_checkpoint_restores_and_continues(arch):
    """The reference trains 4 steps of a ``scan_layers=False`` model and
    checkpoints; the port restores that checkpoint into a freshly made
    state and its steps 4 and 5 give the reference's losses
    (``rel=1e-5``)."""
    ref_cfg = ref_reduced_config(ref_get_arch(arch))
    ref_model = ref_build_model(ref_cfg, scan_layers=False)
    ref_run = RefRunConfig(arch=ref_cfg,
                           shape=RefShapeConfig("t", 16, 4, "train"),
                           parallel=RefParallelConfig(remat="none"))
    ref_step = jax.jit(ref_make_train_step(ref_model, ref_run))
    source = RefTokenSource(ref_cfg.vocab_size, seed=3)
    batches = [ref_make_host_batch(ref_cfg, 16, 4, source, i)
               for i in range(6)]
    ref_state = RefTrainState.init(
        ref_model.init(jax.random.PRNGKey(0), dtype=jnp.float32),
        RefAdamWConfig())

    cfg = reduced_config(get_arch(arch))
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    model.init(torch.Generator().manual_seed(7))
    run = RunConfig(arch=cfg, shape=ShapeConfig("t", 16, 4, "train"),
                    parallel=ParallelConfig(remat="none"))
    step_fn = make_train_step(model, run)
    state = TrainState.init(model.param_tree(), AdamWConfig())

    with tempfile.TemporaryDirectory() as d:
        want = []
        for i in range(6):
            if i == 4:
                RefManager(RefCheckpointConfig(directory=d),
                           n_shards=3).save(ref_state, 4, blocking=True)
            ref_state, m = ref_step(
                ref_state, jax.tree_util.tree_map(jnp.asarray, batches[i]))
            want.append(float(m["loss"]))
        mgr = CheckpointManager(CheckpointConfig(directory=d), n_shards=3)
        state, step = mgr.restore(state)
    assert step == 4 and int(state["step"]) == 4
    assert int(state["opt"]["count"]) == 4
    keys = [k for k, _ in tree_flatten_with_paths(state)]
    assert "params/layers/0/attn/wq" in keys and "opt/count" in keys
    # the same batches, made by the port's own token source
    port_source = TokenSource(cfg.vocab_size, seed=3)
    got = []
    for i in (4, 5):
        b = make_host_batch(cfg, 16, 4, port_source, i)
        np.testing.assert_array_equal(b["tokens"], batches[i]["tokens"])
        state, m = step_fn(state, b)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want[4:6], rtol=1e-5)
